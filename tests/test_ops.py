"""Vision-kernel unit tests (SURVEY.md §7.2 stage 5): KLT vs known flow,
corner selection, CLAHE behavior, RANSAC robustness, pose recovery, PnP."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vins_tpu.config import VinsConfig, FrontendConfig
from vins_tpu.ops import corners, image, klt, ransac
from vins_tpu.utils import lie

CFG = VinsConfig()


def smooth_texture(rng, h=240, w=320, sigma=3.0):
    img = rng.random((h, w)).astype(np.float32)
    img = np.asarray(image.gaussian_blur(jnp.asarray(img), 2.0, 4))
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return jnp.asarray(img)


def shift_image(img, dx, dy):
    """Subpixel shift via bilinear sampling: out(x,y) = img(x-dx, y-dy)."""
    H, W = img.shape
    yy, xx = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    coords = jnp.stack([xx - dx, yy - dy], axis=-1)
    return image.bilinear_sample(img, coords)


def test_bilinear_sample_exact_and_interp():
    img = jnp.arange(12.0).reshape(3, 4)
    # Integer coords exact.
    assert float(image.bilinear_sample(img, jnp.array([2.0, 1.0]))) == 6.0
    # Midpoint interpolation.
    v = float(image.bilinear_sample(img, jnp.array([1.5, 0.5])))
    assert abs(v - (1.5 + 5.5) / 2) < 1e-6


def test_pyramid_shapes_and_mean():
    rng = np.random.default_rng(0)
    img = smooth_texture(rng)
    pyr = image.build_pyramid(img, 3)
    assert pyr[1].shape == (120, 160) and pyr[2].shape == (60, 80)
    assert abs(float(jnp.mean(pyr[2])) - float(jnp.mean(img))) < 0.03


def test_clahe_boosts_contrast():
    rng = np.random.default_rng(1)
    img = smooth_texture(rng) * 0.2 + 0.4  # low contrast
    out = image.clahe(img, 3.0, 8)
    assert float(jnp.std(out)) > float(jnp.std(img)) * 1.5
    assert 0.0 <= float(jnp.min(out)) and float(jnp.max(out)) <= 1.0


def test_klt_tracks_known_shift():
    rng = np.random.default_rng(2)
    img0 = smooth_texture(rng)
    dx, dy = 3.3, -2.6
    img1 = shift_image(img0, dx, dy)
    pyr0 = image.build_pyramid(img0, 3)
    pyr1 = image.build_pyramid(img1, 3)
    pts = jnp.asarray(rng.uniform([40, 40], [280, 200],
                                  size=(32, 2)).astype(np.float32))
    res = klt.track_pyramid_fb(pyr0, pyr1, pts, jnp.ones(32, bool), CFG.frontend)
    ok = np.asarray(res.status)
    assert ok.sum() >= 28
    flow = np.asarray(res.pts - pts)[ok]
    np.testing.assert_allclose(flow[:, 0], dx, atol=0.1)
    np.testing.assert_allclose(flow[:, 1], dy, atol=0.1)


def test_klt_large_motion_uses_pyramid():
    rng = np.random.default_rng(3)
    img0 = smooth_texture(rng)
    dx, dy = 14.0, 9.0   # > window/2 at level 0, needs coarse levels
    img1 = shift_image(img0, dx, dy)
    pyr0 = image.build_pyramid(img0, 3)
    pyr1 = image.build_pyramid(img1, 3)
    pts = jnp.asarray(rng.uniform([60, 60], [260, 180],
                                  size=(24, 2)).astype(np.float32))
    res = klt.track_pyramid_fb(pyr0, pyr1, pts, jnp.ones(24, bool), CFG.frontend)
    ok = np.asarray(res.status)
    assert ok.sum() >= 10
    flow = np.asarray(res.pts - pts)[ok]
    np.testing.assert_allclose(flow[:, 0], dx, atol=0.3)
    np.testing.assert_allclose(flow[:, 1], dy, atol=0.3)


def test_shi_tomasi_and_grid_select():
    img = jnp.zeros((240, 320))
    # Plant bright squares: corners respond.
    planted = [(60, 80), (60, 240), (180, 80), (180, 240), (120, 160)]
    for (y, x) in planted:
        img = img.at[y:y + 20, x:x + 20].set(1.0)
    resp = corners.shi_tomasi_response(img)
    occ = jnp.zeros_like(img, dtype=bool)
    pick = corners.select_corners_grid(resp, occ, 40, 30)
    pts = np.asarray(pick.pts)[np.asarray(pick.valid)]
    # Each planted square contributes >=1 selected corner nearby.
    for (y, x) in planted:
        sq_corners = np.array([[x, y], [x + 19, y], [x, y + 19], [x + 19, y + 19]])
        d = np.min(np.linalg.norm(pts[:, None, :] - sq_corners[None], axis=-1))
        assert d < 6.0, (y, x, d)


def test_select_respects_occupancy():
    img = jnp.zeros((240, 320))
    img = img.at[100:120, 100:120].set(1.0)
    resp = corners.shi_tomasi_response(img)
    occ = corners.occupancy_mask((240, 320), jnp.array([[110.0, 110.0]]),
                                 jnp.array([True]), 40)
    pick = corners.select_corners_grid(resp, occ, 10, 30)
    pts = np.asarray(pick.pts)[np.asarray(pick.valid)]
    if len(pts):
        d = np.linalg.norm(pts - np.array([110.0, 110.0]), axis=-1)
        assert np.all(d >= 25.0)


def test_ransac_fundamental_rejects_outliers():
    rng = np.random.default_rng(4)
    # Planar-free 3D scene, two views.
    X = rng.uniform([-2, -2, 4], [2, 2, 8], size=(64, 3))
    R = np.asarray(lie.quat_to_rotmat(lie.so3_exp_quat(
        jnp.array([0.02, -0.03, 0.05]))))
    t = np.array([0.3, 0.05, 0.02])
    p1 = (X[:, :2] / X[:, 2:3]).astype(np.float32)
    X2 = X @ R.T + t
    p2 = (X2[:, :2] / X2[:, 2:3]).astype(np.float32)
    # Corrupt 15 of them.
    p2_bad = p2.copy()
    p2_bad[:15] += rng.uniform(0.05, 0.2, size=(15, 2)) * np.sign(
        rng.standard_normal((15, 2)))
    res = ransac.ransac_fundamental(
        jnp.asarray(p1), jnp.asarray(p2_bad), jnp.ones(64, bool),
        jax.random.PRNGKey(0), 256, (1.5 / 460) ** 2)
    inl = np.asarray(res.inliers)
    assert inl[15:].sum() >= 45     # keeps the good ones
    assert inl[:15].sum() <= 2      # rejects the corrupted ones


def test_recover_pose_from_essential():
    rng = np.random.default_rng(5)
    X = rng.uniform([-2, -2, 4], [2, 2, 8], size=(48, 3))
    R_true = np.asarray(lie.quat_to_rotmat(lie.so3_exp_quat(
        jnp.array([0.03, 0.08, -0.04]))))
    t_true = np.array([0.4, -0.1, 0.05])
    # x2 = R x1 + t convention.
    p1 = (X[:, :2] / X[:, 2:3]).astype(np.float32)
    X2 = X @ R_true.T + t_true
    p2 = (X2[:, :2] / X2[:, 2:3]).astype(np.float32)
    res = ransac.ransac_essential(jnp.asarray(p1), jnp.asarray(p2),
                                  jnp.ones(48, bool), jax.random.PRNGKey(1),
                                  256, (1.0 / 460) ** 2)
    R, t, n = ransac.recover_pose(res.model, jnp.asarray(p1), jnp.asarray(p2),
                                  res.inliers)
    assert int(n) >= 40
    R_err = np.asarray(R) @ R_true.T
    ang = np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1))
    assert ang < 0.01, ang
    t_dir = np.asarray(t) / np.linalg.norm(np.asarray(t))
    t_dir_true = t_true / np.linalg.norm(t_true)
    assert abs(float(np.dot(t_dir, t_dir_true))) > 0.999


def test_pnp_gn_refines_pose():
    rng = np.random.default_rng(6)
    X = jnp.asarray(rng.uniform([-3, -3, 3], [3, 3, 9], size=(40, 3)),
                    jnp.float32)
    q_true = lie.so3_exp_quat(jnp.array([0.1, -0.2, 0.3]))
    p_true = jnp.array([0.5, -0.3, 0.2])
    pc = lie.quat_rotate(lie.quat_conj(q_true), X - p_true)
    obs = pc[:, :2] / pc[:, 2:3]
    # Perturbed init.
    q0 = lie.quat_mul(q_true, lie.so3_exp_quat(jnp.array([0.05, 0.02, -0.04])))
    p0 = p_true + jnp.array([0.2, -0.1, 0.15])
    p, q, msr = ransac.pnp_gn(X, obs, jnp.ones(40, bool), p0, q0)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p_true), atol=1e-3)
    assert float(msr) < 1e-8


def test_fast_detects_corners():
    img = jnp.zeros((120, 160))
    img = img.at[40:80, 50:110].set(1.0)
    score = corners.fast_score(img, 0.2)
    s = np.asarray(score)
    # Strong responses near the 4 rectangle corners, none in flat regions.
    assert s[38:44, 48:54].max() > 0 or s[38:44, 106:112].max() > 0
    assert s[55:65, 70:90].max() == 0.0


def test_brief_bits_match_numpy_sampling_of_pattern():
    """Every BRIEF bit equals an independent numpy evaluation of the
    make_pattern test pairs on the smoothed image: keypoints on integer
    pixels make each tap an exact pixel read, so the bits must agree
    exactly (the shipped vocabularies were trained on these bits)."""
    from vins_tpu.ops import brief

    rng = np.random.default_rng(3)
    H, W = 96, 128
    img = jnp.asarray(rng.random((H, W)), jnp.float32)
    pts = np.stack([rng.integers(25, W - 25, 20),
                    rng.integers(25, H - 25, 20)], -1).astype(np.float32)
    valid = np.ones(20, bool)
    valid[[4, 11]] = False
    desc = np.asarray(brief.extract_brief(img, jnp.asarray(pts),
                                          jnp.asarray(valid)))
    smoothed = np.asarray(image.gaussian_blur(img, 2.0))
    pat = brief.make_pattern().astype(np.int64)
    for n, (x, y) in enumerate(pts.astype(np.int64)):
        if not valid[n]:
            assert not desc[n].any()
            continue
        a = smoothed[y + pat[:, 1], x + pat[:, 0]]
        b = smoothed[y + pat[:, 3], x + pat[:, 2]]
        bits = (a < b).astype(np.uint64).reshape(8, 32)
        words = (bits << np.arange(32, dtype=np.uint64)).sum(1)
        np.testing.assert_array_equal(desc[n], words.astype(np.uint32))
