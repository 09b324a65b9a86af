"""Sliding-window VIO backend: one pure jitted step per camera frame.

This is the functional re-design of VINS::processImage + solve_ceres +
slideWindow (VINS_ios/VINS.cpp:377-830, 1149-1293): instead of a mutable
estimator object crossed by five threads, the entire backend is

    backend_step : (BackendState, FrameInput) → (BackendState, BackendOutput)

compiled once. Data-dependent control flow — keyframe vs non-keyframe
marginalization (MARGIN_OLD / MARGIN_SECOND_NEW), failure detection — is
`lax.cond`/masked updates with static shapes (SURVEY.md §7.3).

Per step:
  1. stash the incoming IMU chunk on the newest edge and propagate ONLY
     that edge's preintegration (like the reference,
     integration_base.h:39-45, bias drift is handled to first order by
     the propagated Jacobian inside the residual; repropagating all edges
     every frame costs a 31-step sequential scan × 10 edges for no
     measurable accuracy gain — exact repropagation still
     happens where it matters: at initialization);
  2. ingest the newest frame's tracked features (slot F-1);
  3. keyframe decision by compensated parallax (feature_manager.cpp:103);
  4. dead-reckon an initial guess for the newest state (VINS.cpp:359-370);
  5. SVD-triangulate new landmarks (feature_manager.cpp:190);
  6. LM/Schur window solve (solver.py);
  7. failure detection (VINS.cpp:214-265);
  8. marginalize (old / second-new) and slide every buffer.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import VinsConfig
from ..utils import lie
from . import feature_manager as fm
from . import marginalization as marg
from . import preintegration as pre_mod
from .factors import Extrinsics
from .solver import (LoopProblem, SolveStats, WindowProblem, solve_window,
                     solve_window_with_loop)
from .state import FeatureTable, PriorFactor, WindowState


class BackendState(NamedTuple):
    window: WindowState
    feats: FeatureTable
    chunks: pre_mod.ImuChunk      # stacked [W, N] raw IMU per edge
    preints: pre_mod.Preintegration  # stacked [W] — propagated once per edge
    prior: PriorFactor
    last_is_kf: jax.Array         # [] bool — last frame's keyframe flag
    failure: jax.Array            # [] bool

    @staticmethod
    def fresh(cfg: VinsConfig) -> "BackendState":
        F = cfg.window.num_frames
        M = cfg.window.max_landmarks
        N = cfg.window.max_imu_per_edge
        W = F - 1
        chunks = jax.tree.map(
            lambda x: jnp.tile(x[None], (W,) + (1,) * x.ndim),
            pre_mod.ImuChunk.empty(N))
        preints = jax.vmap(lambda c: pre_mod.propagate(
            c, jnp.zeros(3), jnp.zeros(3), cfg.imu))(chunks)
        return BackendState(
            window=WindowState.identity(F, M),
            feats=FeatureTable.empty(F, M),
            chunks=chunks,
            preints=preints,
            prior=PriorFactor.empty(F),
            last_is_kf=jnp.asarray(True),
            failure=jnp.asarray(False),
        )

    @staticmethod
    def bootstrap(cfg: VinsConfig, window: WindowState, feats: FeatureTable,
                  chunks: pre_mod.ImuChunk, ext, gravity) -> "BackendState":
        """Build a ready state from a solved (e.g. freshly initialized)
        window: marginalize the oldest frame and slide once, exactly as a
        normal step's tail does.

        The slide is essential, not cosmetic: backend_step ingests the
        next frame into slot F-1 and connects it with an IMU edge from
        slot F-2 — handing over an UNslid window would discard the init
        window's newest frame while edge W-1's chunk still spans from it,
        misaligning the IMU factor by one frame interval (measured as a
        1.45x arc overshoot right after init). Marginalizing here also
        hands the first real solve a proper prior (the reference runs
        solve_ceres incl. marginalization on the init window itself,
        VINS.cpp:455,480), so no solve ever sees a free gauge.
        """
        F = cfg.window.num_frames
        W = F - 1
        preints = jax.vmap(
            lambda c, ba, bg: pre_mod.propagate(c, ba, bg, cfg.imu)
        )(chunks, window.ba[:W], window.bg[:W])
        prob = WindowProblem(
            feats=feats, preints=preints, prior=PriorFactor.empty(F),
            ext=ext, gravity=gravity,
            sqrt_info_proj=jnp.asarray(cfg.camera.focal / 1.5),
            frame_free=jnp.ones(F, window.p.dtype))
        prior_new = marg.marginalize_old(window, prob, cfg)
        feats_new, inv_new = fm.slide_old(window, feats, ext, cfg)
        win_new = marg.slide_state_old(window)._replace(inv_depth=inv_new)
        chunks_new = jax.tree.map(
            lambda c: jnp.concatenate([c[1:], jnp.zeros_like(c[:1])], 0),
            chunks)
        preints_new = jax.tree.map(
            lambda p: jnp.concatenate([p[1:], p[-1:]], 0), preints)
        fresh = BackendState.fresh(cfg)
        return fresh._replace(window=win_new, feats=feats_new,
                              chunks=chunks_new, preints=preints_new,
                              prior=prior_new)


class LoopInput(NamedTuple):
    """Loop-closure constraint data carried into a backend step (the
    reference's retrive_pose_data consumed by solve_ceres,
    VINS.cpp:571-637). Slot-aligned to the backend landmark table; ids
    re-verified on device so stale slots (track churn between detection
    and injection) drop out.

    TRACK-anchored, not window-slot-anchored: the constraint stays
    injectable for as long as enough of the matched TRACKS are alive in
    the landmark table (track lifetime far exceeds a frame's window
    residence), so block-mode staging latency doesn't kill it. The free
    loop pose initializes at the detection-time PnP-refined old pose
    (the reference initializes retrive_pose from the old keyframe too,
    VINS.cpp:588-590), and the refined pose-graph edge is read against
    the current keyframe's STORED raw pose (same raw odometry frame as
    the solved loop pose, so the readout needs no window residence —
    drift accrued between the keyframe's capture and the refining solve
    enters the edge, bounded by seconds of odometry)."""

    obs_old: jax.Array   # [M, 2] normalized obs in the retrieved keyframe
    ok: jax.Array        # [M] bool
    ids: jax.Array       # [M] int32 track ids the matches were made for
    p_init: jax.Array    # [3] loop-pose initial value (refined old pose)
    q_init: jax.Array    # [4]
    ttl: jax.Array       # [] int32 backend solves left before retirement
    weight: jax.Array    # [] float 1.0 active / 0.0 inert

    @staticmethod
    def inactive(M: int, dtype=jnp.float32) -> "LoopInput":
        return LoopInput(
            obs_old=jnp.zeros((M, 2), dtype),
            ok=jnp.zeros((M,), bool),
            ids=jnp.full((M,), -1, jnp.int32),
            p_init=jnp.zeros((3,), dtype),
            q_init=lie.quat_identity(dtype),
            ttl=jnp.zeros((), jnp.int32),
            weight=jnp.zeros((), dtype))


class FrameInput(NamedTuple):
    """One camera frame's worth of backend input."""

    chunk: pre_mod.ImuChunk       # IMU samples since the previous frame
    ids: jax.Array                # [Mi] int32 track ids (-1 = invalid)
    obs: jax.Array                # [Mi, 2] normalized observations
    obs_valid: jax.Array          # [Mi] bool
    # Optional loop-constraint block; None compiles the loop-free step.
    loop: Optional[LoopInput] = None
    # Optional runtime LM iteration budget (backpressure analog of the
    # reference's queue-depth-scaled solver cap, VINS.cpp:646-653);
    # None = the compiled max.
    iter_budget: Optional[jax.Array] = None


class BackendOutput(NamedTuple):
    pose_p: jax.Array             # [3] newest pose
    pose_q: jax.Array             # [4]
    vel: jax.Array                # [3]
    is_keyframe: jax.Array        # []
    parallax_px: jax.Array        # []
    failure: jax.Array            # []
    stats: SolveStats
    # Drift-corrected sparse map of the newest frame (for viz/loop/AR).
    point_cloud: jax.Array        # [M, 3] world points
    point_valid: jax.Array        # [M]
    # Refined loop constraint read off the solved window (VINS.cpp:663-680):
    # relative t (in the solved loop-pose frame) and yaw between the loop-
    # carrying window frame and the solved loop pose. Zeros when no loop
    # block was active this step.
    loop_rel_t: jax.Array         # [3]
    loop_rel_yaw: jax.Array       # []
    loop_good: jax.Array          # [] bool — loop block active + solve ok
    loop_support: jax.Array       # [] int32 — live matched-track count


def _failure_detection(prev: WindowState, cur: WindowState,
                       feats: FeatureTable, cfg: VinsConfig) -> jax.Array:
    """Reference VINS::failureDetection (VINS.cpp:214-265)."""
    F = cur.p.shape[0]
    # `prev` slots F-2 hold the previous frame's (post-slide) pose; the
    # reference compares last_P/last_R against the newly solved newest pose.
    n_tracked = jnp.sum(feats.mask[F - 1] & feats.valid)
    bg_norm = jnp.linalg.norm(cur.bg[F - 1])
    ba_norm = jnp.linalg.norm(cur.ba[F - 1])
    dp = jnp.linalg.norm(cur.p[F - 1] - prev.p[F - 2])
    dz = jnp.abs(cur.p[F - 1, 2] - prev.p[F - 2, 2])
    dq = lie.quat_mul(lie.quat_conj(prev.q[F - 2]), cur.q[F - 1])
    ang = jnp.linalg.norm(lie.so3_log(dq))
    return (
        (n_tracked < cfg.fail_min_features)
        | (bg_norm > cfg.fail_max_gyr_bias)
        | (ba_norm > cfg.fail_max_acc_bias)
        | (dp > cfg.fail_max_trans_jump)
        | (dz > cfg.fail_max_z_jump)
        | (ang > jnp.deg2rad(cfg.fail_max_rot_jump_deg))
        | ~jnp.all(jnp.isfinite(cur.p))
    )


def landmark_world_points(window: WindowState, feats: FeatureTable,
                          ext: Extrinsics):
    """[M,3] world positions of current landmarks (update_loop_correction /
    point-cloud publishing, VINS.cpp:307-331).

    Slots without a usable depth (invalid or inv_depth <= 1e-3) are
    zeroed: the raw division would place them ~1e6 units out, which
    overflows the fp16 publication cast to inf and poisons any consumer
    that forgets the validity mask (the reference only ever publishes
    triangulated points, VINS.cpp:313-324)."""
    M = feats.track_id.shape[0]
    ok = feats.valid & (window.inv_depth > 1e-3)
    pt_anchor = jnp.concatenate(
        [jnp.take_along_axis(feats.obs, feats.anchor[None, :, None], axis=0)[0],
         jnp.ones((M, 1), feats.obs.dtype)], axis=-1)
    pt_anchor = pt_anchor / jnp.maximum(window.inv_depth[:, None], 1e-3)
    q_a = window.q[feats.anchor]
    p_a = window.p[feats.anchor]
    pt_imu = lie.quat_rotate(ext.qic, pt_anchor) + ext.tic
    pts = lie.quat_rotate(q_a, pt_imu) + p_a
    return jnp.where(ok[:, None], pts, 0.0)


def backend_step(est: BackendState, inp: FrameInput, cfg: VinsConfig,
                 ext: Extrinsics, gravity: jax.Array
                 ) -> Tuple[BackendState, BackendOutput]:
    F = cfg.window.num_frames
    W = F - 1
    focal = cfg.camera.focal

    # 1. Newest edge gets the incoming chunk; propagate ONLY that edge
    #    (the reference likewise preintegrates each edge once —
    #    integration_base.h:39-45 — and handles bias drift to first order
    #    through the propagated Jacobian in the residual; re-propagating
    #    all 10 edges every frame costs 5 ms of sequential scan for no
    #    measurable accuracy gain).
    chunks = jax.tree.map(
        lambda all_, new: all_.at[W - 1].set(new), est.chunks, inp.chunk)
    pre_new = pre_mod.propagate(inp.chunk, est.window.ba[F - 2],
                                est.window.bg[F - 2], cfg.imu)
    preints = jax.tree.map(
        lambda all_, new: all_.at[W - 1].set(new), est.preints, pre_new)

    # Repropagate ALL edges only when some edge's bias estimate has
    # drifted far from its preintegration linearization point (the
    # reference's repropagate trigger, integration_base.h:47): the
    # first-order Jacobian correction in the residual is accurate for
    # small deviations, but right after initialization the bias estimates
    # move a lot and keeping stale linearizations was measured to leak
    # into the metric scale. Steady state skips the 31-step x W scan.
    dev_a = jnp.max(jnp.linalg.norm(
        est.window.ba[:W] - preints.linearized_ba, axis=-1))
    dev_g = jnp.max(jnp.linalg.norm(
        est.window.bg[:W] - preints.linearized_bg, axis=-1))
    preints = jax.lax.cond(
        (dev_a > 0.05) | (dev_g > 0.01),
        lambda: jax.vmap(
            lambda c, ba, bg: pre_mod.propagate(c, ba, bg, cfg.imu)
        )(chunks, est.window.ba[:W], est.window.bg[:W]),
        lambda: preints)

    # 2. Ingest features into slot F-1.
    feats = fm.ingest_frame(est.feats, jnp.asarray(F - 1), inp.ids, inp.obs,
                            inp.obs_valid)

    # 3. Keyframe decision (decides the fate of the second-newest frame).
    is_kf, par_px = fm.keyframe_parallax(feats, cfg, focal)

    # 4. Initial guess for the newest state by dead reckoning from F-2.
    win = est.window
    p_n, q_n, v_n = pre_mod.propagate_state(
        win.p[F - 2], win.q[F - 2], win.v[F - 2],
        win.ba[F - 2], win.bg[F - 2], inp.chunk, gravity)
    win = win._replace(
        p=win.p.at[F - 1].set(p_n), q=win.q.at[F - 1].set(q_n),
        v=win.v.at[F - 1].set(v_n),
        ba=win.ba.at[F - 1].set(win.ba[F - 2]),
        bg=win.bg.at[F - 1].set(win.bg[F - 2]))

    # 5. Triangulate new landmarks.
    win = fm.triangulate(win, feats, ext, cfg)

    # 6. Solve (preintegrations carry first-order bias correction).
    #    With an active LoopInput, loop-reprojection factors against a
    #    free loop pose join the problem (VINS.cpp:571-637); the loop
    #    pose initializes at the loop-carrying window frame's pose
    #    (VINS.cpp:588-590).
    prob = WindowProblem(
        feats=feats, preints=preints, prior=est.prior, ext=ext,
        gravity=gravity, sqrt_info_proj=jnp.asarray(focal / 1.5),
        frame_free=jnp.ones(F, win.p.dtype))
    if inp.loop is not None:
        # Slot identity re-check: a slot only contributes if it still
        # holds the track the old-keyframe match was made for.
        loop_ok = (inp.loop.ok & (feats.track_id == inp.loop.ids)
                   & (inp.loop.ids >= 0))
        prob = prob._replace(loop=LoopProblem(
            obs_old=inp.loop.obs_old, ok=loop_ok,
            frame=jnp.zeros((), jnp.int32), weight=inp.loop.weight))
        solved, (loop_p, loop_q), stats = solve_window_with_loop(
            win, inp.loop.p_init, inp.loop.q_init, prob, cfg,
            iter_budget=inp.iter_budget)
    else:
        solved, stats = solve_window(win, prob, cfg,
                                     iter_budget=inp.iter_budget)
        loop_p = jnp.zeros(3, win.p.dtype)
        loop_q = lie.quat_identity(win.p.dtype)

    # NOTE: the reference re-anchors frame 0's yaw/position after every
    # solve (new2old, VINS.cpp:131-212) because Ceres' gauge can wander.
    # Once a marginalization prior exists it pins the gauge natively and
    # A/B on noisy synthetic shows per-solve re-anchoring *doubles* drift
    # (it discards prior-informed corrections to frame 0), so it is
    # omitted in steady state. But the FIRST post-init solves run with an
    # empty prior (weight 0): the 4-DoF gauge is then free, the solution
    # can translate/yaw arbitrarily (observed tripping failure detection
    # from sub-mm input perturbations), so frame 0's yaw+position are
    # re-anchored to their pre-solve values exactly while the prior is
    # inactive.
    def reanchor(s: WindowState) -> WindowState:
        ypr_before = lie.rotmat_to_ypr(lie.quat_to_rotmat(win.q[0]))
        ypr_after = lie.rotmat_to_ypr(lie.quat_to_rotmat(s.q[0]))
        dyaw = ypr_before[0] - ypr_after[0]
        R_fix = lie.ypr_to_rotmat(jnp.stack(
            [dyaw, jnp.zeros_like(dyaw), jnp.zeros_like(dyaw)]))
        q_fix = lie.rotmat_to_quat(R_fix)
        p_fix = win.p[0] - R_fix @ s.p[0]
        return s._replace(
            p=s.p @ R_fix.T + p_fix,
            q=jax.vmap(lambda q: lie.quat_mul(q_fix, q))(s.q),
            v=s.v @ R_fix.T)

    solved = jax.lax.cond(est.prior.weight > 0,
                          lambda s: s, reanchor, solved)

    # 7. Failure detection; on failure keep the predicted (unsolved) state.
    fail = _failure_detection(win, solved, feats, cfg)
    solved = jax.tree.map(lambda a, b: jnp.where(fail, a, b), win, solved)

    feats = fm.remove_failures(solved, feats)
    pts_w = landmark_world_points(solved, feats, ext)

    # Refined loop constraint off the SOLVED loop pose (VINS.cpp:663-680):
    # relative t/yaw between the solved loop pose (= the old keyframe in
    # the current raw-odometry frame) and the solved NEWEST window frame.
    # Both live in the current raw frame, so the edge is gauge-safe AND
    # drift-free: an earlier readout against the detection-time
    # keyframe's STORED pose silently folded every meter of raw drift
    # accrued between that keyframe's capture and the refining solve
    # into the edge — harmless at interactive (sub-second) latency,
    # ruinous when a streamed constraint attaches a lap later. The host
    # records the edge against the keyframe nearest the readout frame
    # (pipeline sync/insert).
    if inp.loop is not None:
        R_loop = lie.quat_to_rotmat(loop_q)
        loop_rel_t = R_loop.T @ (solved.p[F - 1] - loop_p)
        yaw_l = lie.rotmat_to_ypr(R_loop)[0]
        yaw_w = lie.rotmat_to_ypr(lie.quat_to_rotmat(solved.q[F - 1]))[0]
        dyaw = yaw_w - yaw_l
        loop_rel_yaw = jnp.arctan2(jnp.sin(dyaw), jnp.cos(dyaw))
        n_loop = jnp.sum(prob.loop.ok & feats.valid)
        loop_good = (inp.loop.weight > 0) & (n_loop >= 10) & ~fail
    else:
        n_loop = jnp.zeros((), jnp.int32)
        loop_rel_t = jnp.zeros(3, win.p.dtype)
        loop_rel_yaw = jnp.zeros((), win.p.dtype)
        loop_good = jnp.asarray(False)

    out = BackendOutput(
        pose_p=solved.p[F - 1], pose_q=solved.q[F - 1], vel=solved.v[F - 1],
        is_keyframe=is_kf, parallax_px=par_px, failure=fail, stats=stats,
        point_cloud=pts_w,
        point_valid=(feats.valid & feats.mask[F - 1]
                     & (solved.inv_depth > 1e-3)),
        loop_rel_t=loop_rel_t, loop_rel_yaw=loop_rel_yaw,
        loop_good=loop_good,
        loop_support=jnp.asarray(n_loop, jnp.int32))

    # 8. Marginalize + slide (MARGIN_OLD if the 2nd-newest was a keyframe).
    prob_solved = prob._replace(feats=feats)

    def do_old(_):
        prior_new = marg.marginalize_old(solved, prob_solved, cfg)
        feats_new, inv_new = fm.slide_old(solved, feats, ext, cfg)
        win_new = marg.slide_state_old(solved)._replace(inv_depth=inv_new)
        chunks_new = jax.tree.map(
            lambda c: jnp.concatenate([c[1:], jnp.zeros_like(c[:1])], 0),
            chunks)
        preints_new = jax.tree.map(
            lambda p: jnp.concatenate([p[1:], p[-1:]], 0), preints)
        return win_new, feats_new, chunks_new, preints_new, prior_new

    def do_new(_):
        prior_new = marg.marginalize_second_new(solved, est.prior, cfg)
        feats_new = fm.slide_new(feats)
        win_new = marg.slide_state_new(solved)
        merged = marg.merge_chunks(
            jax.tree.map(lambda c: c[W - 2], chunks),
            jax.tree.map(lambda c: c[W - 1], chunks))
        chunks_new = jax.tree.map(
            lambda c, m: c.at[W - 2].set(m).at[W - 1].set(jnp.zeros_like(c[W - 1])),
            chunks, merged)
        # The merged edge spans what was W-2's interval plus the new one:
        # propagate it once at W-2's linearization bias.
        pre_merged = pre_mod.propagate(
            merged, preints.linearized_ba[W - 2],
            preints.linearized_bg[W - 2], cfg.imu)
        preints_new = jax.tree.map(
            lambda p, m: p.at[W - 2].set(m), preints, pre_merged)
        return win_new, feats_new, chunks_new, preints_new, prior_new

    win2, feats2, chunks2, preints2, prior2 = jax.lax.cond(
        is_kf, do_old, do_new, operand=None)

    new_est = BackendState(
        window=win2, feats=feats2, chunks=chunks2, preints=preints2,
        prior=prior2, last_is_kf=is_kf, failure=fail)
    return new_est, out


class VinsEstimator:
    """Host-side orchestration shell (the reference's ViewController role,
    minus iOS): owns the compiled backend step and the bootstrap path.

    Until automatic initialization lands (SURVEY.md §7.2 stage 6), call
    `bootstrap(window_state, feats, chunks)` with a known-good window
    (tests/synthetic) and then feed frames with `process_frame`.
    """

    def __init__(self, cfg: VinsConfig, ext: Extrinsics, dtype=jnp.float32):
        self.cfg = cfg
        self.ext = ext
        self.gravity = jnp.array([0.0, 0.0, cfg.imu.gravity], dtype)
        self.state = BackendState.fresh(cfg)
        self.initialized = False
        self._step = jax.jit(
            lambda est, inp: backend_step(est, inp, cfg, ext, self.gravity))

    def bootstrap(self, window: WindowState, feats: FeatureTable,
                  chunks: pre_mod.ImuChunk):
        self.state = BackendState.bootstrap(self.cfg, window, feats,
                                            chunks, self.ext, self.gravity)
        self.initialized = True

    def process_frame(self, inp: FrameInput) -> BackendOutput:
        assert self.initialized, "estimator not initialized"
        self.state, out = self._step(self.state, inp)
        if bool(out.failure):
            # Reference behavior: clearState + re-init (VINS.cpp:463-467).
            self.initialized = False
        return out


def run_sequence_scan(est: BackendState, inputs: FrameInput, cfg: VinsConfig,
                      ext: Extrinsics, gravity: jax.Array):
    """Replay a whole stacked input sequence through the backend in ONE
    device program (`lax.scan` over frames).

    This is the throughput path: per-frame host dispatch is amortized
    across the
    sequence; the interactive `VinsEstimator.process_frame` path stays for
    streaming use. Failure handling inside the scan freezes the state
    (holds the last good window) while flagging the frame, mirroring the
    reference's clearState-and-reinit at the host level.
    """

    def f(e, inp):
        e2, out = backend_step(e, inp, cfg, ext, gravity)
        e2 = jax.tree.map(
            lambda a, b: jnp.where(out.failure, a, b), e, e2)
        return e2, out

    return jax.lax.scan(f, est, inputs)
