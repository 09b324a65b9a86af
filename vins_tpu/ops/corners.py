"""Corner detection: Shi–Tomasi response + spacing-aware selection, FAST.

Replaces cv::goodFeaturesToTrack + the track-priority occupancy mask
(reference feature_tracker.cpp:50-87 setMask, :263 goodFeaturesToTrack
with MAX_CNT=70, MIN_DIST=30) and cv::FAST for loop-closure keyframes
(keyframe.cpp:61). Static-shape formulation: the min-distance constraint is
enforced with a grid-cell reduction (cell size = min_distance) — one
max-reduce per cell plus a top-k over cells — instead of OpenCV's
sequential greedy suppression. Neighboring-cell winners can be as close
as one cell apart, matching the reference's spacing to within 2×; in
return selection is O(HW) fully parallel.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .image import sobel_gradients, _sep_filter


def shi_tomasi_response(img: jax.Array, block: int = 3) -> jax.Array:
    """Min-eigenvalue of the structure tensor (cv::goodFeaturesToTrack's
    quality measure)."""
    gx, gy = sobel_gradients(img)
    k = (1.0 / block,) * block
    gxx = _sep_filter(gx * gx, k)
    gyy = _sep_filter(gy * gy, k)
    gxy = _sep_filter(gx * gy, k)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    return 0.5 * (tr - jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0)))


class CornerPick(NamedTuple):
    pts: jax.Array    # [K, 2] (x, y) float
    score: jax.Array  # [K]
    valid: jax.Array  # [K] bool


def select_corners_grid(response: jax.Array, occupied_mask: jax.Array,
                        k: int, cell: int,
                        quality_frac: float = 0.01) -> CornerPick:
    """Pick up to k corners with ~cell spacing, skipping occupied areas.

    occupied_mask: either a [H, W] bool pixel mask (reference setMask
    parity, feature_tracker.cpp:50-87) or a [H//cell, W//cell] bool
    CELL mask (occupancy_cells — the cheap path used per frame).
    """
    H, W = response.shape
    gh, gw = H // cell, W // cell
    cell_mask = occupied_mask.shape == (gh, gw)
    resp = response if cell_mask else \
        jnp.where(occupied_mask, -jnp.inf, response)
    # Border suppression (reference uses 1px border + mask edges).
    resp = resp.at[:8, :].set(-jnp.inf).at[-8:, :].set(-jnp.inf)
    resp = resp.at[:, :8].set(-jnp.inf).at[:, -8:].set(-jnp.inf)

    tiles = resp[: gh * cell, : gw * cell].reshape(gh, cell, gw, cell)
    tiles = tiles.transpose(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    best = jnp.max(tiles, axis=1)                       # [cells]
    arg = jnp.argmax(tiles, axis=1)                     # [cells]
    if cell_mask:
        best = jnp.where(occupied_mask.reshape(-1), -jnp.inf, best)

    thresh = quality_frac * jnp.max(response)
    ok_cell = best > thresh

    score, idx = jax.lax.top_k(jnp.where(ok_cell, best, -jnp.inf),
                               min(k, gh * gw))
    cy = idx // gw
    cx = idx % gw
    ay = arg[idx] // cell
    ax = arg[idx] % cell
    pts = jnp.stack([(cx * cell + ax).astype(response.dtype),
                     (cy * cell + ay).astype(response.dtype)], axis=-1)
    valid = jnp.isfinite(score)
    return CornerPick(pts=pts, score=jnp.where(valid, score, 0.0), valid=valid)


def occupancy_mask(shape: Tuple[int, int], pts: jax.Array, valid: jax.Array,
                   radius: int) -> jax.Array:
    """Disc mask around existing features (reference setMask). Computed as
    a distance test against each point on a coarse grid then upsampled —
    here directly dense: [H,W] vs [M] points."""
    H, W = shape
    yy = jnp.arange(H, dtype=pts.dtype)[:, None, None]
    xx = jnp.arange(W, dtype=pts.dtype)[None, :, None]
    d2 = (xx - pts[None, None, :, 0]) ** 2 + (yy - pts[None, None, :, 1]) ** 2
    near = (d2 < radius * radius) & valid[None, None, :]
    return jnp.any(near, axis=-1)


def occupancy_cells(shape: Tuple[int, int], pts: jax.Array,
                    valid: jax.Array, cell: int) -> jax.Array:
    """Cell-level occupancy: [H//cell, W//cell] bool, True where a new
    corner is forbidden. The selection granularity IS the cell grid
    (select_corners_grid keeps one winner per cell), so testing cell
    CENTERS against the features gives the same ~min_distance spacing as
    the per-pixel disc mask at 1/cell² of the cost (the dense [H,W,M]
    test was ~40 M lanes per frame — the single most expensive part of
    the corner top-up)."""
    H, W = shape
    gh, gw = H // cell, W // cell
    cy = (jnp.arange(gh, dtype=pts.dtype) + 0.5) * cell   # [gh]
    cx = (jnp.arange(gw, dtype=pts.dtype) + 0.5) * cell   # [gw]
    d2 = ((cx[None, :, None] - pts[None, None, :, 0]) ** 2
          + (cy[:, None, None] - pts[None, None, :, 1]) ** 2)
    r = cell  # blocking radius ~ min spacing (cell == min_distance)
    return jnp.any((d2 < r * r) & valid[None, None, :], axis=-1)


def fast_score(img: jax.Array, threshold: float = 0.04) -> jax.Array:
    """FAST-9 corner response (used for loop-closure BRIEF keypoints,
    reference keyframe.cpp:61 via cv::FAST).

    Vectorized: the 16 Bresenham-circle neighbors are materialized as 16
    shifted copies; a pixel is a corner if ≥9 contiguous neighbors are all
    brighter (or all darker) than center±t. Score = sum |diff| over the
    contiguous arc (SAD score, matching OpenCV's nonmax score shape)."""
    # Static Bresenham-16 circle offsets (plain Python so the slices are
    # compile-time constants — jit-safe).
    offs = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
            (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
            (-2, -2), (-1, -3)]
    H, W = img.shape
    pad = 3
    imp = jnp.pad(img, pad, mode="edge")
    ring = jnp.stack([
        jax.lax.dynamic_slice(imp, (pad + dy, pad + dx), (H, W))
        for dx, dy in offs], axis=0)
    bright = ring > img[None] + threshold
    dark = ring < img[None] - threshold

    def arc9(flags):
        # contiguous run of >=9 around the 16-ring: OR over the 16 rotations
        # of AND over 9 consecutive.
        doubled = jnp.concatenate([flags, flags[:9]], axis=0)
        runs = jnp.stack([jnp.all(jax.lax.dynamic_slice_in_dim(doubled, s, 9, 0),
                                  axis=0) for s in range(16)])
        return jnp.any(runs, axis=0)

    is_corner = arc9(bright) | arc9(dark)
    score = jnp.sum(jnp.abs(ring - img[None]), axis=0)
    return jnp.where(is_corner, score, 0.0)
