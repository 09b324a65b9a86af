"""Pyramidal Lucas–Kanade feature tracking, batched over features.

Replacement for cv::calcOpticalFlowPyrLK (21×21 window, 3 levels —
reference feature_tracker.cpp:181). Inverse-compositional formulation:
template gradients and the 2×2 normal matrix are computed once per level
from the previous frame; the per-iteration work is one bilinear patch
read of the current frame plus two reductions.

Everything is vmapped over the fixed M feature slots with a fixed
iteration count — one XLA program, no per-feature dispatch, on every
backend.

Status semantics follow OpenCV: a track fails if its normal matrix is
degenerate (min eigenvalue below threshold) or it leaves the border.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import FrontendConfig
from .image import sobel_gradients


class KltResult(NamedTuple):
    pts: jax.Array      # [M, 2] tracked positions (level-0 pixels)
    status: jax.Array   # [M] bool
    err: jax.Array      # [M] mean abs residual of final patch


def _patch_offsets(win: int, dtype=jnp.float32):
    r = (win - 1) / 2.0
    o = jnp.arange(win, dtype=dtype) - r
    ox, oy = jnp.meshgrid(o, o)
    return ox.reshape(-1), oy.reshape(-1)  # [win²]


def _extract_patch(img: jax.Array, corner: jax.Array, win: int) -> jax.Array:
    """Bilinear [win,win] patch whose top-left lands at float `corner`
    (x, y). One contiguous dynamic_slice + a 4-tap blend. The corner is
    clamped so the (win+1)² read stays inside the image."""
    H, W = img.shape
    cx = jnp.clip(corner[0], 0.0, W - win - 1.001)
    cy = jnp.clip(corner[1], 0.0, H - win - 1.001)
    ix = jnp.floor(cx).astype(jnp.int32)
    iy = jnp.floor(cy).astype(jnp.int32)
    fx = cx - ix
    fy = cy - iy
    raw = jax.lax.dynamic_slice(img, (iy, ix), (win + 1, win + 1))
    top = (1 - fy) * ((1 - fx) * raw[:-1, :-1] + fx * raw[:-1, 1:])
    bot = fy * ((1 - fx) * raw[1:, :-1] + fx * raw[1:, 1:])
    return top + bot


def _track_level(img_prev: jax.Array, gx: jax.Array, gy: jax.Array,
                 img_next: jax.Array, pts_prev: jax.Array,
                 guess: jax.Array, valid: jax.Array,
                 cfg: FrontendConfig) -> Tuple[jax.Array, jax.Array]:
    """One pyramid level of inverse-compositional LK for all features.

    pts_prev: [M,2] template centers in this level's pixels.
    guess:    [M,2] current flow estimate (this level's pixels).
    Returns (flow, ok, err).
    """
    win = cfg.klt_window
    r = (win - 1) / 2.0

    def one(pt, g0, ok_in):
        corner_t = pt - r
        t = _extract_patch(img_prev, corner_t, win)
        tx = _extract_patch(gx, corner_t, win)
        ty = _extract_patch(gy, corner_t, win)
        # Normal matrix (structure tensor of the template patch).
        a = jnp.sum(tx * tx)
        b = jnp.sum(tx * ty)
        c = jnp.sum(ty * ty)
        det = a * c - b * b
        tr = a + c
        min_eig = 0.5 * (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0)))
        ok = ok_in & (min_eig / (win * win) > 1e-4)
        inv = jnp.array([[c, -b], [-b, a]]) / jnp.where(det > 1e-12, det, 1.0)

        def body(i, carry):
            flow, _ = carry
            cur = _extract_patch(img_next, pt + flow - r, win)
            diff = cur - t
            rhs = jnp.stack([jnp.sum(diff * tx), jnp.sum(diff * ty)])
            delta = -inv @ rhs
            return flow + delta, jnp.mean(jnp.abs(diff))

        flow, err = jax.lax.fori_loop(
            0, cfg.klt_iters, body, (g0, jnp.zeros((), img_prev.dtype)))
        return flow, ok, err

    flow, ok, err = jax.vmap(one)(pts_prev, guess, valid)
    return flow, ok, err


def track_pyramid(pyr_prev: List[jax.Array], pyr_next: List[jax.Array],
                  pts_prev: jax.Array, valid: jax.Array,
                  cfg: FrontendConfig,
                  init_flow: jax.Array | None = None,
                  grads_prev=None) -> KltResult:
    """Track [M,2] level-0 points from prev to next across the pyramid.

    init_flow: optional [M,2] level-0 flow prior (e.g. IMU-predicted or the
    negated forward flow for a backward consistency pass).
    grads_prev: optional precomputed [(gx, gy)] per level of pyr_prev —
    the tracker caches each frame's gradients so consecutive steps (and
    the fwd/bwd passes) never recompute them."""
    L = len(pyr_prev)
    dtype = pts_prev.dtype
    grads = (grads_prev if grads_prev is not None
             else [sobel_gradients(p) for p in pyr_prev])
    flow = (jnp.zeros_like(pts_prev) if init_flow is None
            else init_flow / (2.0 ** (L - 1)))
    ok = valid
    err = jnp.zeros(pts_prev.shape[0], dtype)
    for lvl in range(L - 1, -1, -1):
        scale = jnp.asarray(2.0 ** lvl, dtype)
        flow, ok, err = _track_level(
            pyr_prev[lvl], grads[lvl][0], grads[lvl][1], pyr_next[lvl],
            pts_prev / scale, flow, ok, cfg)
        if lvl > 0:
            flow = flow * 2.0
    pts_next = pts_prev + flow
    H, W = pyr_next[0].shape
    border = 1.0
    inb = ((pts_next[:, 0] >= border) & (pts_next[:, 0] < W - border)
           & (pts_next[:, 1] >= border) & (pts_next[:, 1] < H - border))
    # Residual sanity: reject divergent tracks (OpenCV uses err implicitly
    # via maxLevel/criteria; we gate on mean abs patch residual).
    ok = ok & inb & (err < 0.35) & jnp.all(jnp.isfinite(pts_next), axis=-1)
    return KltResult(pts=pts_next, status=ok & valid, err=err)


def patch_ncc(img_a: jax.Array, img_b: jax.Array, pts_a: jax.Array,
              pts_b: jax.Array, win: int) -> jax.Array:
    """[M] zero-mean NCC of the (win,win) patches centered at pts_a in
    img_a and pts_b in img_b."""
    r = (win - 1) / 2.0

    def one(pa, pb):
        ta = _extract_patch(img_a, pa - r, win)
        tb = _extract_patch(img_b, pb - r, win)
        ta = ta - jnp.mean(ta)
        tb = tb - jnp.mean(tb)
        return jnp.sum(ta * tb) * jax.lax.rsqrt(
            jnp.sum(ta * ta) * jnp.sum(tb * tb) + 1e-12)

    return jax.vmap(one)(pts_a, pts_b)


def track_pyramid_fb(pyr_prev: List[jax.Array], pyr_next: List[jax.Array],
                     pts_prev: jax.Array, valid: jax.Array,
                     cfg: FrontendConfig,
                     fb_thresh: float = 0.3,
                     grads_prev=None, grads_next=None) -> KltResult:
    """Forward–backward consistency-checked tracking.

    Tracks prev→next, then next→prev, and keeps only tracks whose
    round trip lands within `fb_thresh` px of the start. This replaces a
    brittle absolute-residual gate with a photometric-invariant test and
    is the robustness backbone the reference delegates to RANSAC
    (feature_tracker.cpp:183-205); RANSAC still runs downstream for
    epipolar outliers.
    """
    fwd = track_pyramid(pyr_prev, pyr_next, pts_prev, valid, cfg,
                        grads_prev=grads_prev)
    # Backward pass seeded with the negated forward flow: the test is
    # whether the *local* refinement holds up in reverse, not whether the
    # coarse pyramid re-finds the basin (self-similar scenes would alias).
    # NOTE: a level-0-only backward pass was tried for speed (halves KLT
    # cost) but shifts the fb accept set just enough to destabilize
    # initialization on low-excitation sequences — keep full-pyramid
    # symmetry.
    bwd = track_pyramid(pyr_next, pyr_prev, fwd.pts, fwd.status, cfg,
                        init_flow=pts_prev - fwd.pts,
                        grads_prev=grads_next)
    rt = jnp.linalg.norm(bwd.pts - pts_prev, axis=-1)
    # Zero-mean NCC of template vs matched patch: contrast-invariant
    # mismatch detector (catches symmetric false locks FB can miss).
    ncc = patch_ncc(pyr_prev[0], pyr_next[0], pts_prev, fwd.pts,
                    cfg.klt_window)
    ok = fwd.status & bwd.status & (rt < fb_thresh) & (ncc > 0.5)
    return KltResult(pts=fwd.pts, status=ok, err=rt)
