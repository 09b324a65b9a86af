"""Feature-track lifecycle over the sliding window, on dense masked arrays.

Dense fixed-shape re-design of the reference FeatureManager
(VINS_ios/feature_manager.cpp): the `list<FeaturePerId>` with per-feature
`vector<FeaturePerFrame>` becomes the fixed-shape [F, M] observation grid
of `FeatureTable` (core/state.py), and every operation — slot-allocating
ingestion, the compensated-parallax keyframe test
(feature_manager.cpp:65-160), batched SVD triangulation
(feature_manager.cpp:190-256), and the two window shifts
(removeBackShiftDepth :259-287 / removeFront :379-404) — is a pure jitted
array transformation.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import VinsConfig
from ..utils import lie
from .factors import Extrinsics
from .state import FeatureTable, WindowState


def ingest_frame(feats: FeatureTable, frame_idx: jax.Array,
                 ids: jax.Array, obs: jax.Array,
                 incoming_valid: jax.Array) -> FeatureTable:
    """Write one frame's tracked features into the table.

    ids: [Mi] int32 global track ids (-1 / invalid entries ignored)
    obs: [Mi, 2] normalized coordinates
    incoming_valid: [Mi] bool

    Existing tracks (matching track_id) get their (frame, slot) cell set;
    new tracks are allocated into free slots (track_id == -1) in order.
    Replaces FeatureManager::addFeature bookkeeping with an argsort-based
    slot allocator (SURVEY.md §7.3 'slot-allocator with masks').
    """
    M = feats.track_id.shape[0]
    Mi = ids.shape[0]
    incoming_valid = incoming_valid & (ids >= 0)

    # Match incoming ids against existing slots.
    eq = (ids[:, None] == feats.track_id[None, :]) & (feats.track_id[None, :] >= 0)
    has_match = jnp.any(eq, axis=1)                       # [Mi]
    match_slot = jnp.argmax(eq, axis=1).astype(jnp.int32)  # [Mi]

    # Allocate free slots for unmatched: free slots ranked by index.
    is_free = feats.track_id < 0                           # [M]
    free_rank = jnp.cumsum(is_free.astype(jnp.int32)) - 1  # [M] rank per slot
    # slot index of the k-th free slot:
    order = jnp.argsort(~is_free, stable=True).astype(jnp.int32)  # frees first
    needs_new = incoming_valid & ~has_match
    new_rank = jnp.cumsum(needs_new.astype(jnp.int32)) - 1  # [Mi]
    n_free = jnp.sum(is_free.astype(jnp.int32))
    can_alloc = needs_new & (new_rank < n_free)
    alloc_slot = order[jnp.clip(new_rank, 0, M - 1)]       # [Mi]

    slot = jnp.where(has_match, match_slot, alloc_slot)
    write = incoming_valid & (has_match | can_alloc)
    slot_c = jnp.where(write, slot, M)                     # OOB drop

    obs_new = feats.obs.at[frame_idx, slot_c].set(obs, mode="drop")
    mask_new = feats.mask.at[frame_idx, slot_c].set(True, mode="drop")
    # New allocations: set anchor/track_id/reset depth bookkeeping.
    is_new_write = write & ~has_match
    slot_n = jnp.where(is_new_write, slot, M)
    anchor_new = feats.anchor.at[slot_n].set(
        jnp.full((Mi,), frame_idx, jnp.int32), mode="drop")
    track_new = feats.track_id.at[slot_n].set(ids, mode="drop")

    n_obs = jnp.sum(mask_new, axis=0)
    valid_new = (track_new >= 0) & (n_obs >= 2)
    return FeatureTable(obs=obs_new, mask=mask_new, anchor=anchor_new,
                        valid=valid_new, track_id=track_new)


def keyframe_parallax(feats: FeatureTable, cfg: VinsConfig,
                      focal: float) -> Tuple[jax.Array, jax.Array]:
    """Compensated-parallax keyframe decision at a full window.

    Mirrors FeatureManager::addFeatureCheckParallax
    (feature_tracker.cpp... feature_manager.cpp:103-160): parallax between
    the second- and third-newest frames, averaged over tracks observed in
    both; keyframe iff mean parallax * focal >= MIN_PARALLAX px, or too
    few long tracks, or no co-observed tracks.
    Returns (is_keyframe, mean_parallax_px).
    """
    F = feats.mask.shape[0]
    i, j = F - 3, F - 2
    both = feats.mask[i] & feats.mask[j] & (feats.track_id >= 0)
    d = feats.obs[j] - feats.obs[i]
    par = jnp.sqrt(jnp.sum(d * d, axis=-1))
    n = jnp.sum(both)
    mean_par = jnp.where(n > 0, jnp.sum(par * both) / jnp.maximum(n, 1), 0.0)
    mean_par_px = mean_par * focal
    # Long-track count (observed >= 2 frames and tracked into frame j).
    long_tracks = jnp.sum(both & (jnp.sum(feats.mask, axis=0) >= 4))
    is_kf = (n == 0) | (long_tracks < 20) | (mean_par_px >= cfg.window.min_parallax_px)
    return is_kf, mean_par_px


def _cam_poses(state: WindowState, ext: Extrinsics):
    """Per-frame world-from-camera pose (R_wc [F,3,3], t_wc [F,3])."""
    R_wb = lie.quat_to_rotmat(state.q)                    # [F,3,3]
    R_ic = lie.quat_to_rotmat(ext.qic)
    R_wc = R_wb @ R_ic
    t_wc = state.p + jnp.einsum("fij,j->fi", R_wb, ext.tic)
    return R_wc, t_wc


def triangulate(state: WindowState, feats: FeatureTable, ext: Extrinsics,
                cfg: VinsConfig) -> WindowState:
    """Batched DLT/SVD triangulation of not-yet-initialized features
    (inverse depth <= 0), in the anchor camera frame.

    Reference: FeatureManager::triangulate (feature_manager.cpp:190-256):
    per feature builds rows [x·P₂−P₀ ; y·P₂−P₁] over its observations and
    takes the smallest-singular-vector; depth < 0.1 falls back to
    INIT_DEPTH. Here: one svd over a [M, 2F, 4] stack.
    """
    F, M = feats.mask.shape
    R_wc, t_wc = _cam_poses(state, ext)

    # Relative pose anchor-cam -> frame-cam for every (f, m).
    Ra = R_wc[feats.anchor]                               # [M,3,3]
    ta = t_wc[feats.anchor]                               # [M,3]
    # P = [R | t] with R = R_f^T R_a, t = R_f^T (t_a - t_f)  (maps anchor-cam
    # point X to frame-f cam: x_f = R X + t).
    R_rel = jnp.einsum("fij,mik->fmjk", R_wc, Ra)         # R_f^T R_a [F,M,3,3]
    t_rel = jnp.einsum("fij,fmi->fmj", R_wc, ta[None, :, :] - t_wc[:, None, :])
    P = jnp.concatenate([R_rel, t_rel[..., None]], axis=-1)  # [F,M,3,4]

    x = feats.obs[..., 0]
    y = feats.obs[..., 1]
    w = feats.mask.astype(P.dtype)
    row0 = (x[..., None] * P[..., 2, :] - P[..., 0, :]) * w[..., None]
    row1 = (y[..., None] * P[..., 2, :] - P[..., 1, :]) * w[..., None]
    A = jnp.concatenate([row0, row1], axis=0)             # [2F, M, 4]
    A = jnp.moveaxis(A, 1, 0)                             # [M, 2F, 4]

    # Inhomogeneous DLT: fix the homogeneous scale (X4 = 1; points at
    # infinity are excluded by the depth bounds anyway) and solve the
    # 3x3 normal equations in closed form via cofactors — fully
    # elementwise, no batched LAPACK kernel (a batched 4x4 eigh per
    # landmark is a long serial solver call; this is a few fused ops).
    B = A[..., :3]                                        # [M, 2F, 3]
    c = -A[..., 3]                                        # [M, 2F]
    N = jnp.einsum("mra,mrb->mab", B, B)                  # [M, 3, 3]
    b = jnp.einsum("mra,mr->ma", B, c)                    # [M, 3]
    n00, n01, n02 = N[:, 0, 0], N[:, 0, 1], N[:, 0, 2]
    n11, n12, n22 = N[:, 1, 1], N[:, 1, 2], N[:, 2, 2]
    c00 = n11 * n22 - n12 * n12
    c01 = n02 * n12 - n01 * n22
    c02 = n01 * n12 - n02 * n11
    c11 = n00 * n22 - n02 * n02
    c12 = n01 * n02 - n00 * n12
    c22 = n00 * n11 - n01 * n01
    det = n00 * c00 + n01 * c01 + n02 * c02
    det_safe = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    z = (c02 * b[:, 0] + c12 * b[:, 1] + c22 * b[:, 2]) / det_safe
    depth = jnp.where(jnp.abs(det) > 1e-12, z, cfg.window.init_depth)
    depth = jnp.where(depth < 0.1, cfg.window.init_depth, depth)

    need = feats.valid & (state.inv_depth <= 0) & (jnp.sum(feats.mask, 0) >= 2)
    inv_new = jnp.where(need, 1.0 / depth, state.inv_depth)
    return state._replace(inv_depth=inv_new)


def remove_failures(state: WindowState, feats: FeatureTable) -> FeatureTable:
    """Drop tracks whose solved depth went negative
    (reference FeatureManager::removeFailures, feature_manager.cpp:289-298;
    solve_flag==2 ⇔ depth < 0 after new2old)."""
    bad = feats.valid & (state.inv_depth < 0)
    return feats._replace(valid=feats.valid & ~bad,
                          track_id=jnp.where(bad, -1, feats.track_id),
                          mask=feats.mask & ~bad[None, :])


def slide_old(state: WindowState, feats: FeatureTable, ext: Extrinsics,
              cfg: VinsConfig) -> Tuple[FeatureTable, jax.Array]:
    """Shift observations down one frame; re-anchor depth of features
    anchored at frame 0 to (old) frame 1 (reference removeBackShiftDepth,
    feature_manager.cpp:259-287). Returns (new_feats, new_inv_depth).
    Call BEFORE slide_state_old (uses un-shifted state for geometry).
    """
    F, M = feats.mask.shape
    R_wc, t_wc = _cam_poses(state, ext)

    anchored0 = feats.anchor == 0
    seen1 = feats.mask[1]
    # Transform anchor-cam point to frame-1 camera.
    pt_anchor = jnp.concatenate(
        [feats.obs[0], jnp.ones((M, 1), feats.obs.dtype)], axis=-1
    ) / jnp.maximum(state.inv_depth[:, None], 1e-6)
    pt_w = jnp.einsum("ij,mj->mi", R_wc[0], pt_anchor) + t_wc[0]
    pt_c1 = jnp.einsum("ji,mj->mi", R_wc[1], pt_w - t_wc[1])
    new_depth = pt_c1[:, 2]
    inv1 = jnp.where(new_depth > 0.1, 1.0 / jnp.maximum(new_depth, 0.1),
                     1.0 / cfg.window.init_depth)

    # Shift grid up.
    obs = jnp.concatenate([feats.obs[1:], jnp.zeros_like(feats.obs[:1])], 0)
    mask = jnp.concatenate([feats.mask[1:], jnp.zeros_like(feats.mask[:1])], 0)
    anchor = jnp.maximum(feats.anchor - 1, 0)

    # Features anchored at 0: survive iff also seen at old frame 1; their
    # depth re-anchors. Others keep depth.
    keep0 = anchored0 & seen1 & feats.valid
    drop = feats.valid & anchored0 & ~seen1
    inv_depth = jnp.where(keep0, inv1, state.inv_depth)

    n_obs = jnp.sum(mask, axis=0)
    valid = feats.valid & ~drop & (n_obs >= 2)
    track_id = jnp.where(drop | (n_obs < 1), -1, feats.track_id)
    valid = valid & (track_id >= 0)
    mask = mask & (track_id >= 0)[None, :]

    return FeatureTable(obs=obs, mask=mask, anchor=anchor, valid=valid,
                        track_id=track_id), inv_depth


def slide_new(feats: FeatureTable) -> FeatureTable:
    """Drop the second-newest frame's observations, moving the newest down
    (reference removeFront, feature_manager.cpp:379-404)."""
    F, M = feats.mask.shape
    obs = feats.obs.at[F - 2].set(feats.obs[F - 1])
    obs = obs.at[F - 1].set(0.0)
    mask = feats.mask.at[F - 2].set(feats.mask[F - 1])
    mask = mask.at[F - 1].set(False)
    anchor = jnp.where(feats.anchor == F - 1, F - 2, feats.anchor)
    n_obs = jnp.sum(mask, axis=0)
    track_id = jnp.where(n_obs < 1, -1, feats.track_id)
    valid = feats.valid & (n_obs >= 2) & (track_id >= 0)
    mask = mask & (track_id >= 0)[None, :]
    return FeatureTable(obs=obs, mask=mask, anchor=anchor, valid=valid,
                        track_id=track_id)
