"""The LK tracker's plain XLA path (ops/klt.py), which every backend runs:
clamped patch reads, dead slots, odd widths and the NCC gate. The GPU
against the CPU at full width is chip_smoke.py's kernels phase."""
import numpy as np
import jax.numpy as jnp
import pytest

from vins_tpu.config import FrontendConfig
from vins_tpu.ops import image as image_mod
from vins_tpu.ops import klt as klt_mod

CFG = FrontendConfig(klt_window=11, klt_iters=6, pyramid_levels=2)


def _smooth(img, n=3):
    for _ in range(n):
        img = image_mod.gaussian_blur(img, 1.5)
    return img


def _scene(rng, H, W, shift=(2, 0), n=16, levels=2):
    """Smooth texture, an integer-shifted copy, their pyramids, and n
    interior points."""
    base = rng.uniform(0, 1, (H + 8, W + 8)).astype(np.float32)
    base = np.asarray(_smooth(jnp.asarray(base)))
    base = (base - base.min()) / (base.max() - base.min())
    dx, dy = shift
    img0 = jnp.asarray(base[4:H + 4, 4:W + 4])
    img1 = jnp.asarray(base[4 - dy:H + 4 - dy, 4 - dx:W + 4 - dx])
    pyr0 = list(image_mod.build_pyramid(img0, levels))
    pyr1 = list(image_mod.build_pyramid(img1, levels))
    pts = jnp.asarray(rng.uniform(16, min(H, W) - 16, (n, 2)), jnp.float32)
    return pyr0, pyr1, pts


def _numpy_patch(img, cx, cy, win):
    """Independent numpy bilinear patch with top-left at (cx, cy), clamped
    inside the image like the device code."""
    H, W = img.shape
    cx = min(max(cx, 0.0), W - win - 1.001)
    cy = min(max(cy, 0.0), H - win - 1.001)
    ix, iy = int(np.floor(cx)), int(np.floor(cy))
    fx, fy = cx - ix, cy - iy
    raw = img[iy:iy + win + 1, ix:ix + win + 1].astype(np.float64)
    return ((1 - fy) * ((1 - fx) * raw[:-1, :-1] + fx * raw[:-1, 1:])
            + fy * ((1 - fx) * raw[1:, :-1] + fx * raw[1:, 1:]))


@pytest.mark.parametrize("corner", [(-5.0, -3.0), (0.0, 0.0), (40.6, 2.2),
                                    (90.9, 60.7), (200.0, 10.5)])
def test_patch_reads_clamp_inside_the_image(rng, corner):
    """A window that would leave the image is clamped inside it, so border
    tracks read real pixels (the reference's replicate-style clamp)."""
    H, W, win = 64, 96, 11
    img = rng.random((H, W)).astype(np.float32)
    got = np.asarray(klt_mod._extract_patch(jnp.asarray(img),
                                            jnp.asarray(corner, jnp.float32),
                                            win))
    np.testing.assert_allclose(got, _numpy_patch(img, *corner, win),
                               atol=1e-5)


def test_dead_slots_are_never_tracked(rng):
    pyr0, pyr1, pts = _scene(rng, 96, 128)
    valid = jnp.asarray(np.arange(pts.shape[0]) % 3 != 0)
    res = klt_mod.track_pyramid(pyr0, pyr1, pts, valid, CFG)
    status = np.asarray(res.status)
    assert not status[~np.asarray(valid)].any()
    live = klt_mod.track_pyramid(pyr0, pyr1, pts, jnp.ones_like(valid), CFG)
    # The live slots track exactly as they would with every slot valid.
    keep = np.asarray(valid)
    np.testing.assert_array_equal(status[keep], np.asarray(live.status)[keep])
    np.testing.assert_array_equal(np.asarray(res.pts)[keep],
                                  np.asarray(live.pts)[keep])


def test_width_not_a_power_of_two(rng):
    """752 px (the EuRoC width) at quarter scale: 188x120 over 3 levels
    down to 47x30; the forward-backward tracker recovers the known shift."""
    pyr0, pyr1, pts = _scene(rng, 120, 188, shift=(1, 2), levels=3)
    assert pyr0[2].shape == (30, 47)
    cfg = FrontendConfig(klt_window=11, klt_iters=8, pyramid_levels=3)
    res = klt_mod.track_pyramid_fb(pyr0, pyr1, pts,
                                   jnp.ones(pts.shape[0], bool), cfg)
    ok = np.asarray(res.status)
    assert ok.sum() >= pts.shape[0] // 2
    np.testing.assert_allclose(np.asarray(res.pts - pts)[ok],
                               np.broadcast_to([1.0, 2.0], (ok.sum(), 2)),
                               atol=0.05)


def test_patch_ncc_matches_numpy(rng):
    H, W, win = 64, 96, 11
    a = np.asarray(_smooth(jnp.asarray(rng.random((H, W)), jnp.float32)))
    b = np.roll(a, 2, axis=1) * 1.7 + 0.2      # NCC ignores gain/offset
    pts_a = rng.uniform(8, [W - 8, H - 8], (12, 2)).astype(np.float32)
    pts_b = pts_a + np.float32([2.0, 0.0])
    pts_b[-3:] = pts_a[-3:] + np.float32([9.3, -4.1])   # wrong matches
    got = np.asarray(klt_mod.patch_ncc(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(pts_a),
                                       jnp.asarray(pts_b), win))
    r = (win - 1) / 2.0
    want = []
    for pa, pb in zip(pts_a, pts_b):
        ta = _numpy_patch(a, pa[0] - r, pa[1] - r, win)
        tb = _numpy_patch(b, pb[0] - r, pb[1] - r, win)
        ta, tb = ta - ta.mean(), tb - tb.mean()
        want.append((ta * tb).sum() / np.sqrt((ta * ta).sum()
                                              * (tb * tb).sum() + 1e-12))
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.all(got[:-3] > 0.99) and np.all(got[-3:] < 0.9)
