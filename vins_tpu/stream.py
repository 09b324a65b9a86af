"""Whole-pipeline streaming scan: N camera frames through ONE device
program.

The reference hides latency with five threads sharing mutable state
(ViewController.mm:276-294); this design's equivalent of that latency
architecture is to remove the host from the per-frame path entirely:
stage a block of frames in HBM and `lax.scan` the full per-frame pipeline
— CLAHE → pyramid → LK → F-RANSAC → top-up (frontend), the
30 Hz motion-only solve, and (every `freq`-th frame, under `lax.cond`) the
complete sliding-window backend with marginalization + slide + pnp resync.
Host dispatch, which dominates per-frame latency at these shapes, is
paid once per block instead of ~10 times per frame; loop-closure work
(infrequent, ~1 Hz) stays on the host and overlaps the NEXT block's scan
(see pipeline.VinsSystem.process_block).

This is both the throughput path (bench.py "system_frames_per_s") and the
offline/dataset-rate processing mode.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .config import VinsConfig
from .core import feature_manager as fm
from .core import marginalization as marg
from .core import pnp as pnp_mod
from .core import preintegration as pre_mod
from .core.estimator import (BackendState, FrameInput, LoopInput,
                             backend_step, landmark_world_points)
from .core.factors import Extrinsics
from .frontend import tracker as tr_mod
from .ops import image as image_mod


def precompute_block(imgs: jax.Array, cfg: VinsConfig):
    """Batched per-block image prep: CLAHE, pyramid, Scharr gradients for
    every frame in ONE vmapped program.

    These stages are frame-independent (only LK is sequential), so
    running them inside the scan serializes work the chip could batch:
    the banded-matmul filters (ops/image.py) become [N·H, W]-scale
    matmuls here instead of 48 small sequential ones — measured ~2x
    cheaper per frame — and each frame's prep is computed exactly once
    (the scan previously recomputed gradients for the fwd/bwd passes).

    Returns (pyrs, grads): tuples over levels of [N, h, w] stacks /
    ([N,h,w],[N,h,w]) pairs, fed to the scan as xs.
    """
    fe = cfg.frontend
    eq = jax.vmap(lambda im: image_mod.clahe(im, fe.clahe_clip,
                                             fe.clahe_grid,
                                             fe.clahe_bins))(imgs)
    pyrs = [eq]
    for _ in range(fe.pyramid_levels - 1):
        pyrs.append(jax.vmap(image_mod.pyr_down)(pyrs[-1]))
    grads = tuple(jax.vmap(image_mod.sobel_gradients)(p) for p in pyrs)
    return tuple(pyrs), grads


class LoopAnchor(NamedTuple):
    """A verified loop hit staged for RIDE-TIME attachment.

    The host's detection pipeline (scores → gate → geometric verify)
    runs blocks behind the scan, so by injection time the hit's matched
    track ids are dead — the median track lifetime is far shorter than
    the in-flight pipeline depth (measured: ZERO id survival at 2-block
    latency). Instead of a stale host-side id join, the anchor carries
    the OLD keyframe's descriptors + normalized observations, and the
    SCAN matches them against the live frame's features at the moment
    the constraint starts riding (vio_scan_step _attach_loop): the join
    is always fresh, whatever the detection latency. The reference has
    no equivalent because its loop thread feeds retrive_pose_data within
    ~1 keyframe of capture (VINS.cpp:571-637) — a latency budget a
    deep-pipelined device stream cannot meet.
    """

    desc_old: jax.Array   # [Nf, 8] uint32 packed BRIEF of the old kf
    ok_old: jax.Array     # [Nf] bool keypoint-valid rows
    obs_old: jax.Array    # [Nf, 2] normalized obs in the old kf
    p_init: jax.Array     # [3] PnP-refined old pose (raw odometry frame)
    q_init: jax.Array     # [4]
    ttl: jax.Array        # [] int32 backend frames left to try attaching
    pending: jax.Array    # [] bool — attach not yet done

    @staticmethod
    def inactive(Nf: int, dtype=jnp.float32) -> "LoopAnchor":
        from .utils import lie
        return LoopAnchor(
            desc_old=jnp.zeros((Nf, 8), jnp.uint32),
            ok_old=jnp.zeros((Nf,), bool),
            obs_old=jnp.zeros((Nf, 2), dtype),
            p_init=jnp.zeros((3,), dtype),
            q_init=lie.quat_identity(dtype),
            ttl=jnp.zeros((), jnp.int32),
            pending=jnp.asarray(False))


class ScanState(NamedTuple):
    """Everything carried frame-to-frame by the fused pipeline scan."""

    tracker: tr_mod.TrackerState
    pnp: pnp_mod.PnpWindow
    est: BackendState
    pending: pre_mod.ImuChunk    # IMU accumulated since last backend frame
    has_pending: jax.Array       # [] bool
    phase: jax.Array             # [] int32; 0 = backend frame
    # Active loop-closure constraint block (weight 0 = inactive): either
    # carried over from interactive mode (host-joined) or produced by a
    # ride-time anchor attach (see LoopAnchor). The scan owns the
    # TTL/track-support lifecycle.
    loop: LoopInput
    # Staged loop hit awaiting ride-time attachment (pending=False when
    # none). The host stages it from a verified detection; the scan
    # attaches it to the live frame's features at the next backend frame.
    anchor: LoopAnchor
    # Runtime LM iteration budget for the window solves (backpressure:
    # the host lowers it when blocks fall behind the camera rate,
    # mirroring the reference's 60→40→30 ms cap, VINS.cpp:646-653).
    solver_budget: jax.Array     # [] int32


class ScanOutput(NamedTuple):
    """Per-frame outputs (stacked [N, ...] by the scan)."""

    p: jax.Array             # [3] published pose (backend or 30 Hz pnp)
    q: jax.Array             # [4]
    is_backend: jax.Array    # [] bool
    is_keyframe: jax.Array   # [] bool (meaningful on backend frames)
    failure: jax.Array       # [] bool
    solver_cost: jax.Array   # []
    n_tracked: jax.Array     # [] int32
    # Keyframe harvest (tracker-slot order) for host-side loop closure:
    # pixel positions, world points, track ids and masks of the tracked
    # features at this frame — what LoopCloser.add_keyframe consumes.
    kf_pts_px: jax.Array     # [Mw, 2]
    kf_valid: jax.Array      # [Mw]
    kf_pts_w: jax.Array      # [Mw, 3]
    kf_w_ok: jax.Array       # [Mw]
    kf_ids: jax.Array        # [Mw] int32
    # Sparse map at backend frames (zeros otherwise): the reference
    # publishes the drift-corrected cloud too (update_loop_correction,
    # VINS.cpp:307-331); drift is applied host-side at publish time.
    point_cloud: jax.Array   # [M, 3]
    point_valid: jax.Array   # [M]
    # Loop-edge lifecycle (meaningful while a loop block is active):
    # refined relative pose read off the solved window (VINS.cpp:663-680)
    # and the retirement event that triggers the 4-DoF pose graph
    # (ViewController.mm:850-875).
    loop_good: jax.Array     # [] bool
    loop_rel_t: jax.Array    # [3]
    loop_rel_yaw: jax.Array  # []
    loop_retired: jax.Array  # [] bool
    # All small per-frame leaves packed into ONE row (see PACK_* column
    # constants): the streaming sync fetches this single [N, 18] buffer
    # instead of eleven separate ones — each fetched buffer has its own
    # transfer overhead.
    packed: jax.Array        # [18] float32


# Column layout of ScanOutput.packed.
PACK_P = slice(0, 3)
PACK_Q = slice(3, 7)
PACK_COST = 7
PACK_IS_BE = 8
PACK_IS_KF = 9
PACK_FAIL = 10
PACK_NTRACK = 11
PACK_LGOOD = 12
PACK_LYAW = 13
PACK_LRET = 14
PACK_LREL_T = slice(15, 18)


def _gather_by_id(dst_ids, src_ids, src_vals, src_valid):
    """For each dst id, pull the matching src slot's value."""
    eq = ((dst_ids[:, None] == src_ids[None, :])
          & (src_ids[None, :] >= 0) & src_valid[None, :]
          & (dst_ids[:, None] >= 0))
    has = jnp.any(eq, axis=1)
    j = jnp.argmax(eq, axis=1)
    return jax.tree.map(lambda v: v[j], src_vals), has


def _sync_pnp(pnp: pnp_mod.PnpWindow, est: BackendState, cfg: VinsConfig,
              ext: Extrinsics) -> pnp_mod.PnpWindow:
    """Anchor the pnp window at the newest backend solution and refresh
    its fixed landmark map (ViewController.mm:731-758)."""
    F = cfg.window.num_frames
    S = cfg.window.pnp_size + 1
    win = est.window
    pnp = pnp_mod.anchor_from_backend(
        pnp, jnp.asarray(S - 1), win.p[F - 1], win.q[F - 1],
        win.v[F - 1], win.ba[F - 1], win.bg[F - 1])
    pts_w = landmark_world_points(win, est.feats, ext)
    valid = est.feats.valid & (win.inv_depth > 1e-3)
    track_len = jnp.sum(est.feats.mask, axis=0)
    return pnp_mod.update_features(pnp, pts_w, valid, track_len)


def vio_scan_step(state: ScanState, pyr, grads, img,
                  chunk: pre_mod.ImuChunk, cfg: VinsConfig,
                  ext: Extrinsics, gravity: jax.Array,
                  use_pnp: bool = True) -> Tuple[ScanState, ScanOutput]:
    """One camera frame of the fused pipeline (pure, scan-able).

    pyr/grads: this frame's block-precomputed image prep
    (precompute_block) — per-level pyramid images and gradients;
    img: the RAW frame (loop-anchor attachment extracts BRIEF from it —
    DB descriptors are raw-image-based)."""
    F = cfg.window.num_frames
    Mw = cfg.frontend.max_features
    dtype = gravity.dtype

    is_backend = state.phase == 0
    # Top-up on backend frames only when configured (the reference's
    # cadence, feature_tracker.cpp:231-307 img_cnt==0).
    do_topup = (True if cfg.frontend.topup_every_frame else is_backend)
    tracker, front = tr_mod.track_step_pre(state.tracker, pyr, grads, cfg,
                                           do_topup=do_topup)

    merged = jax.lax.cond(
        state.has_pending,
        lambda: marg.merge_chunks(state.pending, chunk),
        lambda: chunk)

    # 30 Hz motion-only pose on every frame (reference USE_PNP path).
    # On backend frames the published pose is the backend's and the pnp
    # window is immediately re-anchored to it (_sync_pnp below), so the
    # motion-only SOLVE is skipped there — the window still slides,
    # ingests, and dead-reckons for continuity.
    if use_pnp:
        mode = cfg.solver.pnp_stream_solve
        do_solve = (True if mode == "all"
                    else False if mode == "deadreckon"
                    else ~is_backend)
        obs_l, has_l = _gather_by_id(
            state.est.feats.track_id, front.ids, front.obs, front.obs_valid)
        pnp, (p30, q30, _v30) = pnp_mod.pnp_step(
            state.pnp, chunk, obs_l, has_l, cfg, ext, gravity,
            do_solve=do_solve,
            update_preints=(mode != "deadreckon"))
    else:
        pnp = state.pnp
        p30 = state.est.window.p[F - 1]
        q30 = state.est.window.q[F - 1]
    M = cfg.window.max_landmarks

    def _attach_loop(est, anchor, loop_prev):
        """Ride-time loop attachment: match the staged OLD keyframe's
        descriptors against the LIVE frame's features and build a fresh
        slot-aligned LoopInput. Runs under lax.cond on backend frames
        while an anchor is pending — the streaming replacement for the
        host-side track-id join, which cannot survive the pipeline's
        multi-block detection latency (see LoopAnchor).

        Attaches from the RAW image (not the CLAHE'd pyramid level): the
        DB's stored descriptors were extracted from raw frames, and the
        local contrast remap flips enough BRIEF test pairs to break the
        neigh-ratio gate. The attach keeps trying every backend frame
        until attach_ttl runs out — on a revisiting trajectory the
        vehicle re-enters the old keyframe's view within a lap, and the
        reprojection gate below keeps far-away frames from attaching in
        the meantime."""
        from .ops import brief as brief_mod
        from .utils import lie

        lp = cfg.loop
        desc_cur = brief_mod.extract_brief(img, tracker.pts,
                                           tracker.valid)
        m = brief_mod.match_descriptors(
            desc_cur, anchor.desc_old, tracker.valid, anchor.ok_old,
            max_dist=lp.match_max_dist, ratio=lp.match_ratio)
        # Drift-tolerant geometric gate: the current landmarks' world
        # points, projected through the (PnP-refined, raw-frame) old
        # pose, must land near the matched old observations. Gates out
        # descriptor aliases without a RANSAC pass; the window solve's
        # Cauchy loss handles the remainder.
        ptw = landmark_world_points(est.window, est.feats, ext)
        ptw_t, has_w = _gather_by_id(
            tracker.ids, est.feats.track_id, ptw,
            est.feats.valid & (est.window.inv_depth > 1e-3))
        R_old = lie.quat_to_rotmat(anchor.q_init)
        R_ic = lie.quat_to_rotmat(ext.qic)
        Xc = ((ptw_t - anchor.p_init) @ R_old - ext.tic) @ R_ic
        z = Xc[:, 2]
        proj = Xc[:, :2] / jnp.maximum(z, 1e-3)[:, None]
        err = jnp.linalg.norm(proj - anchor.obs_old[m.idx], axis=-1)
        # MEDIAN-RELATIVE gate: raw drift accrued since the anchor's
        # pose epoch shifts every true match's reprojection coherently
        # (measured ~0.2 rad on a 6-lap run — an absolute gate either
        # rejects true revisits or admits junk), while false matches
        # scatter by radians. Accept matches near the consensus offset,
        # under a loose absolute cap.
        sel = m.ok & has_w & (z > 0.1)
        med = jnp.nanmedian(jnp.where(sel, err, jnp.nan))
        med = jnp.where(jnp.isfinite(med), med, 1e6)
        row_ok = (sel & (jnp.abs(err - med) < lp.attach_gate)
                  & (err < lp.attach_max))
        # Slot-align (LoopInput rows pair elementwise with the landmark
        # table, estimator.py loop_ok re-check).
        obs_slot, ok_slot = _gather_by_id(
            est.feats.track_id, tracker.ids, anchor.obs_old[m.idx],
            row_ok)
        ok_slot = ok_slot & (est.feats.track_id >= 0)
        good = jnp.sum(ok_slot) >= 10
        import os as _os
        if _os.environ.get("VINS_ATTACH_DEBUG"):
            jax.debug.print(
                "attach: n_desc={} n_w={} n_geo={} n_slot={} errmed={}",
                jnp.sum(m.ok), jnp.sum(sel), jnp.sum(row_ok),
                jnp.sum(ok_slot), med)
        loop_new = LoopInput(
            obs_old=obs_slot, ok=ok_slot, ids=est.feats.track_id,
            p_init=anchor.p_init, q_init=anchor.q_init,
            ttl=jnp.asarray(F, jnp.int32),
            weight=jnp.where(good, 1.0, 0.0).astype(dtype))
        loop_out = jax.tree.map(
            lambda new, old: jnp.where(good, new, old), loop_new,
            loop_prev)
        return loop_out, good

    def do_backend(operand):
        est, pnp_in, loop_prev, anchor = operand
        # Ride-time anchor attachment (only while no constraint is
        # already active; one attach per staged hit).
        att_try = (anchor.pending & (anchor.ttl > 0)
                   & (loop_prev.weight <= 0))
        loop_in, attached = jax.lax.cond(
            att_try,
            lambda: _attach_loop(est, anchor, loop_prev),
            lambda: (loop_prev, jnp.asarray(False)))
        ttl_a = jnp.where(anchor.pending, anchor.ttl - 1, anchor.ttl)
        anchor_expired = anchor.pending & ~attached & (ttl_a <= 0)
        anchor2 = anchor._replace(
            ttl=ttl_a,
            pending=anchor.pending & ~attached & (ttl_a > 0))
        inp = FrameInput(chunk=merged, ids=front.ids, obs=front.obs,
                         obs_valid=front.obs_valid, loop=loop_in,
                         iter_budget=state.solver_budget)
        est2, out = backend_step(est, inp, cfg, ext, gravity)
        # Freeze on failure (host decides recovery between blocks).
        est2 = jax.tree.map(
            lambda a, b: jnp.where(out.failure, a, b), est, est2)
        pnp2 = _sync_pnp(pnp_in, est2, cfg, ext)
        # Keyframe harvest in tracker-slot order (pipeline._kf_prep_impl).
        win = est2.window
        pts_w = landmark_world_points(win, est2.feats, ext)
        pts_w_t, has_t = _gather_by_id(
            tracker.ids, est2.feats.track_id, pts_w,
            est2.feats.valid & (win.inv_depth > 1e-3))
        # Loop-constraint lifecycle (track-anchored, see LoopInput): the
        # constraint persists while enough matched tracks survive in the
        # landmark table and its TTL (≈ a window's worth of solves, the
        # reference's in-window residence) hasn't run out; retirement
        # triggers the host-side 4-DoF pose graph between blocks.
        active = loop_in.weight > 0
        ttl2 = jnp.where(active, loop_in.ttl - 1, loop_in.ttl)
        retired = active & ((ttl2 <= 0) | (out.loop_support < 10))
        loop2 = loop_in._replace(
            ttl=ttl2,
            weight=jnp.where(retired | out.failure, 0.0, loop_in.weight))
        # An anchor that expired unattached also reads as retirement so
        # the host closes out its pending-loop bookkeeping (the edge
        # stays tentative; the pose graph still runs at the boundary).
        retired = retired | anchor_expired
        # Published cloud in fp16: halves the per-block [N,M,3] host
        # fetch, and mm-level precision is ample for the viz/AR
        # consumers.
        return (est2, pnp2, loop2, anchor2, out.pose_p, out.pose_q,
                out.is_keyframe, out.failure, out.stats.final_cost,
                pts_w_t, has_t & tracker.valid,
                out.point_cloud.astype(jnp.float16),
                out.point_valid, out.loop_good & active, out.loop_rel_t,
                out.loop_rel_yaw, retired)

    def skip_backend(operand):
        est, pnp_in, loop_in, anchor = operand
        return (est, pnp_in, loop_in, anchor, p30, q30,
                jnp.asarray(False),
                jnp.asarray(False), jnp.zeros((), dtype),
                jnp.zeros((Mw, 3), dtype), jnp.zeros((Mw,), bool),
                jnp.zeros((M, 3), jnp.float16), jnp.zeros((M,), bool),
                jnp.asarray(False), jnp.zeros((3,), dtype),
                jnp.zeros((), dtype), jnp.asarray(False))

    (est, pnp, loop, anchor_out, p_out, q_out, is_kf, failure, cost,
     kf_pts_w, kf_w_ok, pcl, pcl_ok, loop_good, loop_rel_t, loop_rel_yaw,
     loop_retired) = jax.lax.cond(is_backend, do_backend, skip_backend,
                                  (state.est, pnp, state.loop,
                                   state.anchor))

    new_state = ScanState(
        tracker=tracker, pnp=pnp, est=est,
        pending=jax.tree.map(
            lambda m, z: jnp.where(is_backend, z, m), merged,
            jax.tree.map(jnp.zeros_like, merged)),
        has_pending=~is_backend,
        phase=(state.phase + 1) % cfg.freq,
        loop=loop,
        anchor=anchor_out,
        solver_budget=state.solver_budget)

    f32 = jnp.float32
    packed = jnp.concatenate([
        p_out.astype(f32), q_out.astype(f32),
        jnp.stack([cost.astype(f32), is_backend.astype(f32),
                   is_kf.astype(f32), failure.astype(f32),
                   front.n_tracked.astype(f32), loop_good.astype(f32),
                   loop_rel_yaw.astype(f32), loop_retired.astype(f32)]),
        loop_rel_t.astype(f32)])
    out = ScanOutput(
        p=p_out, q=q_out, is_backend=is_backend, is_keyframe=is_kf,
        failure=failure, solver_cost=cost, n_tracked=front.n_tracked,
        kf_pts_px=tracker.pts, kf_valid=tracker.valid,
        kf_pts_w=kf_pts_w, kf_w_ok=kf_w_ok, kf_ids=tracker.ids,
        point_cloud=pcl, point_valid=pcl_ok,
        loop_good=loop_good, loop_rel_t=loop_rel_t,
        loop_rel_yaw=loop_rel_yaw, loop_retired=loop_retired,
        packed=packed)
    return new_state, out


def run_vio_scan(state: ScanState, imgs: jax.Array,
                 chunks: pre_mod.ImuChunk, cfg: VinsConfig,
                 ext: Extrinsics, gravity: jax.Array,
                 use_pnp: bool = True,
                 unroll: int = 1) -> Tuple[ScanState, ScanOutput]:
    """Scan a whole staged block of frames: imgs [N,H,W], chunks [N,...].
    ONE compiled program; jit and reuse across blocks. Frame-independent
    image prep runs batched up front (precompute_block); only the truly
    sequential per-frame pipeline runs in the scan.

    unroll: lax.scan body unroll factor (freq unrolls one full backend
    period per scan iteration, trading compile time for per-step
    overhead)."""
    pyrs, grads = precompute_block(imgs, cfg)

    def f(s, xs):
        pyr, grad, img, chunk = xs
        return vio_scan_step(s, pyr, grad, img, chunk, cfg, ext, gravity,
                             use_pnp)

    return jax.lax.scan(f, state, (pyrs, grads, imgs, chunks),
                        unroll=unroll)
