"""Full-system orchestration: camera/IMU in → poses, map, loops out.

The functional equivalent of the reference's ViewController
(ViewController.mm, SURVEY.md §2.1 "Orchestrator"): where the reference
wires five threads with queues and mutexes, this pipeline is an explicit
per-frame host loop over jitted device programs:

  per camera frame (30 Hz):
    FeatureTracker.track_step  (frontend)           feature_tracker.cpp:162
    vinsPnP pnp_step           (30 Hz pose)         vins_pnp.cpp:264
  every `freq`-th frame (10 Hz):
    backend_step               (window solve)       VINS.cpp:377-830
    feedback: solved pose/biases anchor the pnp window; solved landmark
    world points refresh its fixed map               ViewController.mm:731-758
  every LOOP_FREQ-th keyframe (~1 Hz):
    LoopCloser.add_keyframe + detect                ViewController.mm:786-983
    on hit: optimize 4-DoF pose graph → drift       keyfame_database.cpp:140

State machine: INITIAL (accumulate frames, attempt visual-inertial
bootstrap) → NON_LINEAR (sliding-window VIO) → on failure: clearState,
new trajectory segment, re-enter INITIAL (VINS.cpp:463-467).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import VinsConfig
from .core import feature_manager as fm
from .core import initialization as init_mod
from .core import pnp as pnp_mod
from .core import preintegration as pre_mod
from .core.estimator import BackendState, FrameInput, LoopInput, \
    backend_step, landmark_world_points
from .core.factors import Extrinsics
from .core.state import FeatureTable
from .frontend.tracker import FeatureTracker
from .loop.keyframe_db import LoopCloser
from .utils import lie


def _np_quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Host-side quaternion (w,x,y,z) → rotation matrix (numpy only: the
    drift-correct path runs per frame and must not dispatch device ops)."""
    w, x, y, z = [float(v) for v in q]
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _np_yaw(q: np.ndarray) -> float:
    """Yaw (Z-Y-X convention, reference Utility::R2ypr) of a wxyz quat."""
    R = _np_quat_to_rotmat(q)
    return float(np.arctan2(R[1, 0], R[0, 0]))


def _np_rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Host-side rotation matrix → quaternion (w,x,y,z), Shepperd's
    branch-free-enough variant."""
    t = float(np.trace(R))
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        v = np.zeros(3)
        v[i] = 0.25 * s
        v[j] = (R[j, i] + R[i, j]) / s
        v[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = v
    q = np.array([w, x, y, z], np.float32)
    return q / np.linalg.norm(q)


@jax.jit
def _reanchor_window_jit(window, p_anchor, yaw_anchor):
    """Rigidly move a window so frame 0 sits at p_anchor with yaw_anchor
    (yaw-only gauge alignment; roll/pitch are gravity-observable and must
    not be touched). Anchored inverse depths are frame-relative and
    invariant under the rigid transform."""
    dyaw = yaw_anchor - lie.rotmat_to_ypr(lie.quat_to_rotmat(window.q[0]))[0]
    R_fix = lie.ypr_to_rotmat(jnp.stack(
        [dyaw, jnp.zeros_like(dyaw), jnp.zeros_like(dyaw)]))
    q_fix = lie.rotmat_to_quat(R_fix)
    p0 = window.p[0]
    return window._replace(
        p=(window.p - p0) @ R_fix.T + p_anchor,
        q=jax.vmap(lambda q: lie.quat_mul(q_fix, q))(window.q),
        v=window.v @ R_fix.T)


class PipelineOutput(NamedTuple):
    """Per-frame result published to the consumer (viz/AR/eval)."""

    t: float
    p: np.ndarray            # [3] drift-corrected position
    q: np.ndarray            # [4]
    p_raw: np.ndarray        # [3] raw VIO position (pre loop correction)
    is_keyframe: bool
    initialized: bool
    n_tracked: int
    solver_cost: float
    loop_hit: Optional[int]  # matched old keyframe index, if any
    # Drift-corrected sparse map at backend frames (None otherwise):
    # the reference corrects the published cloud too, not just the pose
    # (update_loop_correction, VINS.cpp:307-331), so AR overlays stay
    # registered after a loop closure.
    point_cloud: Optional[np.ndarray] = None   # [M, 3]
    point_valid: Optional[np.ndarray] = None   # [M]
    # Init-failure taxonomy / "FAILURE" on failure detection (the
    # reference surfaces this in its UI, VINS.hpp:134-145).
    status: str = ""


@dataclasses.dataclass
class _BootFrame:
    ids: jnp.ndarray
    obs: jnp.ndarray
    valid: jnp.ndarray
    chunk: pre_mod.ImuChunk


class VinsSystem:
    """End-to-end VIO/SLAM system on one device."""

    def __init__(self, cfg: VinsConfig, seed: int = 0,
                 use_pnp: bool = True, use_loop: bool = True,
                 ext: Optional[Extrinsics] = None,
                 global_ba_every_kf: int = 0):
        self.cfg = cfg
        cam = cfg.camera
        self.ext = ext if ext is not None else Extrinsics(
            tic=jnp.asarray(cam.tic, jnp.float32),
            qic=lie.rotmat_to_quat(jnp.asarray(cam.ric_matrix())))
        self.gravity = jnp.array([0.0, 0.0, cfg.imu.gravity], jnp.float32)

        self.tracker = FeatureTracker(cfg, seed)
        self.use_pnp = use_pnp
        self.use_loop = use_loop and cfg.loop.enabled
        self.loop = LoopCloser(cfg, seed, ext=(self.ext.tic, self.ext.qic)) \
            if self.use_loop else None

        self._backend_step = jax.jit(
            lambda est, inp: backend_step(est, inp, cfg, self.ext,
                                          self.gravity))
        # Constant inactive loop block (kept on device: one upload, reused
        # every non-loop backend frame — no per-frame transfer).
        self._loop_inactive = jax.device_put(
            LoopInput.inactive(cfg.window.max_landmarks))
        from .stream import LoopAnchor
        self._anchor_inactive = jax.device_put(
            LoopAnchor.inactive(cfg.loop.max_kf_features))
        # Device-carried loop lifecycle state between block dispatches
        # (the scan attaches anchors and retires constraints on its own;
        # the host only mirrors the bookkeeping from the packed flags).
        self._loop_dev = None
        self._anchor_dev = None
        self._scan_jit = None  # compiled lazily by process_block
        self._pnp_step = jax.jit(
            lambda w, c, o, m: pnp_mod.pnp_step(w, c, o, m, cfg, self.ext,
                                                self.gravity))
        self._ingest = jax.jit(fm.ingest_frame)
        self._refine_init = None  # compiled lazily on first init attempt

        from .core import marginalization as marg
        self._merge_jit = jax.jit(marg.merge_chunks)

        F = cfg.window.num_frames
        S = cfg.window.pnp_size + 1

        def _sync_pnp_impl(pnp, est):
            win = est.window
            pnp = pnp_mod.anchor_from_backend(
                pnp, jnp.asarray(S - 1), win.p[F - 1], win.q[F - 1],
                win.v[F - 1], win.ba[F - 1], win.bg[F - 1])
            pts_w = landmark_world_points(win, est.feats, self.ext)
            valid = est.feats.valid & (win.inv_depth > 1e-3)
            track_len = jnp.sum(est.feats.mask, axis=0)
            return pnp_mod.update_features(pnp, pts_w, valid, track_len)

        self._sync_pnp_jit = jax.jit(_sync_pnp_impl)

        def _kf_prep_impl(est, tracker_state):
            """World points in tracker-slot order + newest pose, one
            device program (feeds LoopCloser.add_keyframe)."""
            win = est.window
            pts_w = landmark_world_points(win, est.feats, self.ext)
            pts_w_t, has_t = VinsSystem._gather_by_id(
                tracker_state.ids, est.feats.track_id, pts_w,
                est.feats.valid & (win.inv_depth > 1e-3))
            return (pts_w_t, has_t & tracker_state.valid,
                    win.p[F - 1], win.q[F - 1])

        self._kf_prep_jit = jax.jit(_kf_prep_impl)

        # One traced-index gather program for "row k of a stacked block
        # pytree": eager `x[k]` on device arrays compiles a separate
        # program PER DISTINCT INDEX (keyframes land at different k every
        # block, so each block would compile new programs).
        self._take_frame = jax.jit(lambda tree, k: jax.tree.map(
            lambda x: jax.lax.dynamic_index_in_dim(x, k, 0,
                                                   keepdims=False), tree))
        # Traced-start block slicer (instance-level so the jit cache
        # survives across process_stream calls; a per-call wrapper was
        # re-loading its programs every stream, ~140 ms/block).
        self._slice_block = jax.jit(
            lambda x, s, m: jax.lax.dynamic_slice_in_dim(x, s, m, axis=0),
            static_argnums=2)
        self._track_ids_host = None  # host mirror (block mode staging)
        # Block-mode deadreckon policy leaves the pnp window's carried
        # preintegrations stale (pnp_step update_preints=False); rebuild
        # them before the next INTERACTIVE solve.
        self._pnp_preints_stale = False
        self._rebuild_preints = jax.jit(
            lambda w: w._replace(preints=pnp_mod.window_preints(w, cfg)))
        self._dispatch_seq = 0       # monotone block-dispatch counter
        self._stage_queue = []       # verified hits awaiting refinement
        self._pending_detect = []    # inserted keyframes awaiting scoring
        self._pending_gate = None    # (idxs, scores, floor) to gate in
                                     # the overlap window
        self._pending_scores = None  # (scores_dev, floor) pre-dispatched
        # Gated loop candidates whose geometric-verify programs are
        # dispatched but not fetched (they queue behind the in-flight
        # scan; their results ride the NEXT sync's combined fetch).
        self._pending_verify = None
        self._needs_optimize = False  # pose-graph run deferred to overlap
        self._pending_refine = None   # edge refinement awaiting kf rows
        # Backpressure: runtime LM iteration budget for streaming solves
        # (the reference scales its solver wall-clock cap 60→40→30 ms
        # with queue depth, VINS.cpp:646-653). process_stream lowers it
        # when a block's wall time exceeds the block's real-time span
        # and restores it when there is headroom.
        self.solver_budget = cfg.solver.max_iters
        self._budget_floor = cfg.solver.min_iters
        # Periodic in-stream global BA (keyfame_database.cpp:140-356's
        # global-optimization role, run DURING the stream): every N new
        # keyframes, a (mesh-sharded when >1 device) BA over the
        # harvested map is dispatched in the overlap window. Off by
        # default — harvest fetches DB columns to the host on the
        # streaming path; the end-of-run --global-ba pass covers the
        # offline role.
        self._ba_every = int(global_ba_every_kf)
        self._last_ba_count = 0
        self._ba_mesh = None
        if self._ba_every and len(jax.devices()) > 1:
            from .parallel.mesh import make_mesh
            self._ba_mesh = make_mesh(block=len(jax.devices()))

        # Wall-clock stage budget for the streaming path (seconds,
        # cumulative): dispatch = async enqueue cost, prepare = device
        # sync + host loop-closure work, publish = host output assembly.
        self.timings = {"dispatch": 0.0, "prepare": 0.0, "publish": 0.0,
                        "scan_wait": 0.0, "fetch_wire": 0.0,
                        "prepare_loop": 0.0, "stream_slice": 0.0,
                        "blocks": 0}

        self.reset()

    # -- lifecycle ----------------------------------------------------------

    def reset(self, keep_trajectory: bool = False):
        cfg = self.cfg
        F = cfg.window.num_frames
        S = cfg.window.pnp_size + 1
        # The motion-only tracker's fixed map lives in BACKEND landmark
        # slot order (update_features copies the backend table wholesale).
        L = cfg.window.max_landmarks
        self.initialized = False
        self.est = BackendState.fresh(cfg)
        self.boot: List[_BootFrame] = []
        self.pnp = pnp_mod.PnpWindow(
            state=pnp_mod.PnpState.identity(S),
            feats=pnp_mod.PnpFeatures.empty(S, L),
            chunks=jax.tree.map(
                lambda x: jnp.tile(x[None], (S - 1,) + (1,) * x.ndim),
                pre_mod.ImuChunk.empty(cfg.window.max_imu_per_edge)),
            anchored=jnp.zeros((S,), bool))
        # Fill the carried preintegrations eagerly: the scan carry's
        # pytree structure must be fixed (None → filled would retrace).
        self.pnp = self.pnp._replace(
            preints=pnp_mod.window_preints(self.pnp, cfg))
        self.frame_idx = 0
        self.kf_count = 0
        self._pending_chunk: Optional[pre_mod.ImuChunk] = None
        self._pending_chunk_dev = None
        if not keep_trajectory:
            self.trajectory: List[np.ndarray] = []
            # Re-anchor target after a failure: (p_raw, yaw) of the last
            # good pose (reference last_P_old/last_R_old, VINS.cpp:137-142).
            self._recover_anchor: Optional[tuple] = None
            self._last_good: Optional[tuple] = None
        self._pending_loop = None  # loop factors awaiting injection
        # Device-carried loop lifecycle state (block mode): dropped with
        # the rest of the estimator state.
        if hasattr(self, "_loop_dev"):
            self._loop_dev = None
            self._anchor_dev = None

    def _fail_reset(self):
        """Failure recovery (VINS.cpp:463-467): re-enter INITIAL, keep the
        recorded trajectory, remember the last good pose so the re-
        initialized window is re-anchored there (trajectory continuity,
        VINS.cpp:131-212 new2old failure branch), and bump the loop DB's
        trajectory segment (ViewController.mm:771-781)."""
        if self.loop is not None:
            self.loop.new_segment()
        anchor = self._last_good
        self.reset(keep_trajectory=True)
        self._recover_anchor = anchor

    # -- helpers ------------------------------------------------------------

    def _merge_pending(self, chunk: pre_mod.ImuChunk) -> pre_mod.ImuChunk:
        if self._pending_chunk_dev is not None:
            # Returning to interactive mode after block mode: resolve the
            # device-held pending chunk (one scalar sync).
            pending, has = self._pending_chunk_dev
            self._pending_chunk = pending if bool(has) else None
            self._pending_chunk_dev = None
        if self._pending_chunk is None:
            return chunk
        return self._merge_jit(self._pending_chunk, chunk)

    @staticmethod
    @jax.jit
    def _gather_by_id(dst_ids, src_ids, src_vals, src_valid):
        """For each dst id, pull the matching src slot's value.
        Returns (vals_in_dst_order, found_mask)."""
        eq = ((dst_ids[:, None] == src_ids[None, :])
              & (src_ids[None, :] >= 0) & src_valid[None, :]
              & (dst_ids[:, None] >= 0))
        has = jnp.any(eq, axis=1)
        j = jnp.argmax(eq, axis=1)
        return jax.tree.map(lambda v: v[j], src_vals), has

    def _drift_correct(self, p: np.ndarray, q: np.ndarray):
        """Apply the pose-graph drift on HOST arrays (numpy only — this
        runs every frame; device ops here would cost a dispatch round
        trip each)."""
        if self.loop is None:
            return p, q
        R = self.loop.r_drift
        t = self.loop.t_drift
        p2 = (R @ p + t).astype(np.float32)
        q2 = _np_rotmat_to_quat(R @ _np_quat_to_rotmat(q))
        return p2, q2

    def _drift_correct_points(self, pts: np.ndarray) -> np.ndarray:
        """Drift-correct the published sparse map (VINS.cpp:307-331:
        update_loop_correction corrects the point cloud, not just poses —
        AR overlays use these points to fit the ground plane)."""
        if self.loop is None:
            return pts
        return (pts @ self.loop.r_drift.T
                + self.loop.t_drift[None, :]).astype(np.float32)

    # -- main entry ---------------------------------------------------------

    def process_frame(self, img: jnp.ndarray, chunk: pre_mod.ImuChunk,
                      t: float = 0.0) -> PipelineOutput:
        """One camera frame + the IMU chunk since the previous frame."""
        cfg = self.cfg
        F = cfg.window.num_frames

        is_backend_frame = (self.frame_idx % cfg.freq) == 0
        # Top-up runs every frame: the reference detects only every
        # FREQ-th frame (feature_tracker.cpp:231-307), but this tracker's
        # per-frame attrition (fb-check + F-RANSAC on re-rendered noise)
        # is high enough that gating was measured to cost 2x ATE for only
        # ~0.6 ms/frame — revisit if KLT survival improves.
        front = self.tracker.process(img, do_topup=True)
        self.frame_idx += 1

        if not self.initialized:
            out = self._process_boot(img, front, chunk, t, is_backend_frame)
        else:
            out = self._process_nonlinear(img, front, chunk, t,
                                          is_backend_frame)
        self.trajectory.append(out.p)
        return out

    # -- INITIAL ------------------------------------------------------------

    def _process_boot(self, img, front, chunk, t, is_backend_frame
                      ) -> PipelineOutput:
        cfg = self.cfg
        F = cfg.window.num_frames
        merged = self._merge_pending(chunk)
        if not is_backend_frame:
            self._pending_chunk = merged
            return self._null_output(t, front)
        self._pending_chunk = None

        self.boot.append(_BootFrame(ids=front.ids, obs=front.obs,
                                    valid=front.obs_valid, chunk=merged))
        if len(self.boot) > F:
            self.boot.pop(0)
        if len(self.boot) < F:
            return self._null_output(t, front)

        # Assemble the boot window and attempt initialization. The slot
        # table has no eviction during this build (slides do that in
        # steady state), so track churn across 11 boot frames can exceed
        # the landmark budget and starve the NEWEST frames of slots
        # (observed on the EuRoC fixture: 0 correspondences to frame
        # F-1). Pre-filter to ids seen in >=2 boot frames — the only
        # tracks initialization can use — keeping the most-observed ids
        # when even those overflow.
        L = cfg.window.max_landmarks
        ids_all = np.stack([np.asarray(bf.ids) for bf in self.boot])
        ok_all = np.stack([np.asarray(bf.valid) for bf in self.boot])
        ok_all &= ids_all >= 0
        uniq, cnt = np.unique(ids_all[ok_all], return_counts=True)
        multi = cnt >= 2
        keep = uniq[multi]
        if len(keep) > L:
            keep = keep[np.argsort(-cnt[multi], kind="stable")[:L]]
        feats = FeatureTable.empty(F, L)
        for f, bf in enumerate(self.boot):
            sel = ok_all[f] & np.isin(ids_all[f], keep)
            feats = self._ingest(feats, jnp.asarray(f), bf.ids, bf.obs,
                                 jnp.asarray(sel))
        chunks = jax.tree.map(
            lambda *xs: jnp.stack(xs), *[bf.chunk for bf in self.boot[1:]])
        res = init_mod.initialize(feats, chunks, self.ext, cfg)
        if res.status is not init_mod.InitStatus.SUCCESS:
            self.boot.pop(0)  # slide and retry next backend frame
            return self._null_output(t, front, status=res.status.name)

        # Accepting solve (VINS.cpp:415-443): joint refinement rounds pull
        # the alignment's approximate scale into IMU consistency; gate on
        # the final cost.
        if self._refine_init is None:
            self._refine_init = jax.jit(
                lambda w, fe, ch: init_mod.refine_init_window(
                    w, fe, ch, self.ext, cfg))
        window, cost = self._refine_init(res.window, feats, chunks)
        if not np.isfinite(float(cost)) or float(cost) > cfg.init_max_cost:
            self.boot.pop(0)
            return self._null_output(t, front, status="FAIL_CHECK")

        # Failure-recovery continuity: the fresh init places frame 0 at the
        # origin with zero yaw; re-anchor it at the last good pose so the
        # trajectory does not teleport (VINS.cpp:137-142).
        if self._recover_anchor is not None:
            p_anchor, yaw_anchor = self._recover_anchor
            window = _reanchor_window_jit(
                window, jnp.asarray(p_anchor, jnp.float32),
                jnp.asarray(yaw_anchor, jnp.float32))
            self._recover_anchor = None

        self.est = BackendState.bootstrap(cfg, window, feats, chunks,
                                          self.ext, self.gravity)
        self.initialized = True
        self.boot.clear()
        self._sync_pnp_from_backend()
        p_raw, q_raw, ntr = jax.device_get(
            (window.p[F - 1], window.q[F - 1], front.n_tracked))
        self._last_good = (p_raw, _np_yaw(q_raw))
        p, q = self._drift_correct(p_raw, q_raw)
        return PipelineOutput(
            t=t, p=p, q=q, p_raw=p_raw,
            is_keyframe=True, initialized=True, n_tracked=int(ntr),
            solver_cost=float(cost), loop_hit=None)

    # -- NON_LINEAR ---------------------------------------------------------

    def _process_nonlinear(self, img, front, chunk, t, is_backend_frame
                           ) -> PipelineOutput:
        cfg = self.cfg
        F = cfg.window.num_frames
        merged = self._merge_pending(chunk)

        # 30 Hz motion-only pose on every frame (reference USE_PNP path).
        if self.use_pnp:
            if self._pnp_preints_stale:
                self.pnp = self._rebuild_preints(self.pnp)
                self._pnp_preints_stale = False
            # Re-order the frontend's observations into backend landmark
            # slots (the pnp map lives in that order).
            obs_l, has_l = self._gather_by_id(
                self.est.feats.track_id, front.ids, front.obs,
                front.obs_valid)
            self.pnp, (p30, q30, v30) = self._pnp_step(
                self.pnp, chunk, obs_l, has_l)

        if not is_backend_frame:
            self._pending_chunk = merged
            if self.use_pnp:
                # ONE host↔device round trip for everything this frame
                # needs on the host.
                p30_h, q30_h, ntr = jax.device_get(
                    (p30, q30, front.n_tracked))
                p, q = self._drift_correct(p30_h, q30_h)
                return PipelineOutput(
                    t=t, p=p, q=q, p_raw=p30_h, is_keyframe=False,
                    initialized=True, n_tracked=int(ntr),
                    solver_cost=0.0, loop_hit=None)
            return self._null_output(t, front, initialized=True)

        self._pending_chunk = None
        if self._pending_loop is not None and \
                "dev" not in self._pending_loop:
            # Block-staged anchor awaiting its ride-time attach (see
            # stream.LoopAnchor): the scan owns it; after a mode switch
            # close it out — the edge stays tentative, the pose graph
            # still runs at the boundary.
            self.loop.optimize()
            self._pending_loop = None
        # Inject pending loop factors into this solve (VINS.cpp:571-637):
        # the constraint persists while enough matched tracks survive
        # (TTL-bounded), each solve refining the pose-graph edge.
        if self._pending_loop is not None:
            loop_inp = self._pending_loop["dev"]._replace(
                ttl=jnp.asarray(self._pending_loop["ttl"], jnp.int32))
        else:
            loop_inp = self._loop_inactive
        inp = FrameInput(chunk=merged, ids=front.ids, obs=front.obs,
                         obs_valid=front.obs_valid, loop=loop_inp)
        self.est, out = self._backend_step(self.est, inp)

        # Single combined fetch of every scalar/pose the host logic reads.
        (failure, is_kf, pose_p, pose_q, cost, ntr, pts_w, pts_ok,
         loop_rel_t, loop_rel_yaw, loop_good, loop_support) = jax.device_get(
            (out.failure, out.is_keyframe, out.pose_p, out.pose_q,
             out.stats.final_cost, front.n_tracked, out.point_cloud,
             out.point_valid, out.loop_rel_t, out.loop_rel_yaw,
             out.loop_good, out.loop_support))

        if bool(failure):
            self._fail_reset()
            return self._null_output(t, front, status="FAILURE")

        self._last_good = (pose_p, _np_yaw(pose_q))
        self._sync_pnp_from_backend()

        # Loop bookkeeping: refine the pose-graph edge with the solved
        # relative pose (VINS.cpp:663-680); the constraint retires when
        # its TTL runs out or too few matched tracks survive, triggering
        # the 4-DoF pose graph (ViewController.mm:850-875).
        if self._pending_loop is not None:
            pl = self._pending_loop
            if bool(loop_good):
                e = self.loop.edge_index(pl["edge_abs"])
                if e >= 0 and self.loop.count >= 1:
                    # Readout is against the CURRENT solved frame; re-
                    # point the edge at the newest keyframe (a few
                    # frames back at most), composing the odometry gap.
                    self._refine_edge_to_kf(
                        e, loop_rel_t, float(loop_rel_yaw), pose_p,
                        _np_yaw(pose_q), self.loop.count - 1)
            pl["ttl"] -= 1
            if pl["ttl"] <= 0 or int(loop_support) < 10:
                self.loop.optimize()
                self._pending_loop = None

        loop_hit = None
        if self.use_loop and bool(is_kf):
            self.kf_count += 1
            if self.kf_count % cfg.loop.loop_freq == 0:
                loop_hit = self._handle_keyframe(
                    img, out, t, p_host=pose_p,
                    yaw_host=_np_yaw(pose_q))

        p, q = self._drift_correct(pose_p, pose_q)
        pts_corr = self._drift_correct_points(pts_w)
        return PipelineOutput(
            t=t, p=p, q=q, p_raw=pose_p,
            is_keyframe=bool(is_kf), initialized=True,
            n_tracked=int(ntr), solver_cost=float(cost),
            loop_hit=loop_hit, point_cloud=pts_corr, point_valid=pts_ok)

    def _sync_pnp_from_backend(self):
        """Anchor the pnp window with the newest backend solution and
        refresh its fixed landmark map (ViewController.mm:731-758)."""
        if not self.use_pnp:
            return
        self.pnp = self._sync_pnp_jit(self.pnp, self.est)

    def _handle_keyframe(self, img, out, t=0.0, p_host=None,
                         yaw_host=None) -> Optional[int]:
        """Insert keyframe + loop detect; on a hit, stage loop factors for
        the following window solves (the pose graph runs when the
        constraint retires — see _process_nonlinear)."""
        pts_w_t, ok_t, kf_p, kf_q = self._kf_prep_jit(
            self.est, self.tracker.state)
        idx = self.loop.add_keyframe(
            img, kf_p, kf_q, self.tracker.state.pts,
            self.tracker.state.valid, pts_w_t, ok_t,
            window_ids=self.tracker.state.ids, t=t, p_host=p_host,
            yaw_host=yaw_host)
        hit = self.loop.detect(idx)
        if hit is None:
            return None
        if not self._stage_loop_from_hit(hit):
            # Too few slot-resolvable matches: run the pose graph with
            # the tentative detection-time edge.
            self.loop.optimize()
        return hit.old_idx

    def _stage_loop_from_hit(self, hit, slot_ids=None,
                             defer_optimize: bool = False) -> bool:
        """Stage a verified loop hit as a LoopInput for the following
        window solves (interactive AND block mode — the constraint is
        track-anchored, so staging latency only costs track attrition).
        Joins the matched old-keyframe observations to the backend
        landmark slots by track id (slot_ids: host copy of
        est.feats.track_id; block callers pass the last prepared
        block's mirror so staging never syncs on an in-flight scan);
        returns False when fewer than 10 matches resolve to live
        slots."""
        if slot_ids is None:   # interactive path: est is already synced
            slot_ids = np.asarray(jax.device_get(self.est.feats.track_id))
        # Vectorized slot join (was a per-slot Python dict loop on the
        # critical path): match every live landmark slot to a verified
        # old-keyframe observation row by track id.
        tids = np.asarray(hit.tids)
        ok_rows = np.asarray(hit.match_ok) & (tids >= 0)
        eq = ((slot_ids[:, None] == tids[None, :])
              & ok_rows[None, :] & (slot_ids[:, None] >= 0))
        ok_by_slot = eq.any(axis=1)
        row = eq.argmax(axis=1)
        obs_by_slot = np.where(ok_by_slot[:, None],
                               np.asarray(hit.obs_old)[row],
                               0.0).astype(np.float32)
        if ok_by_slot.sum() < 10:
            return False

        # A new hit supersedes any still-pending loop (reference
        # front_pose replacement, VINS.cpp:575-578): finalize first.
        # Block mode defers the pose-graph run to the overlap window —
        # an immediate optimize() fetches drift and would block on the
        # in-flight scan (measured ~56 ms/block when hits cluster).
        if self._pending_loop is not None:
            if defer_optimize:
                self._needs_optimize = True
            else:
                self.loop.optimize()
        F = self.cfg.window.num_frames
        # ONE host->device transfer for the whole constraint block
        # instead of eight separate jnp.asarray uploads.
        self._pending_loop = {
            # ABSOLUTE edge id: the edge-table row can shift under
            # eviction while the constraint rides solves (and hits
            # staged from the queue are not necessarily the newest
            # edge); resolve via loop.edge_index at update time.
            "edge_abs": getattr(hit, "edge_abs", -1),
            "old_idx": hit.old_idx,
            "ttl": F,            # ≈ the reference's in-window residence
            "dev": jax.device_put(LoopInput(
                obs_old=np.asarray(obs_by_slot, np.float32),
                ok=np.asarray(ok_by_slot),
                ids=np.asarray(slot_ids, np.int32),
                p_init=np.asarray(hit.p_old, np.float32),
                q_init=np.asarray(hit.q_old, np.float32),
                ttl=np.asarray(F, np.int32),
                weight=np.asarray(1.0, np.float32))),
        }
        return True

    def _apply_pending_refine(self, pairs) -> None:
        """Apply a deferred edge refinement (sync_block) now that this
        block's keyframes have DB rows. The measurement was read against
        the window's newest frame at block offset g; the edge is
        re-pointed at the keyframe nearest g and the raw-odometry gap
        between that keyframe and frame g is composed into the
        measurement (yaw-frame composition — consistent with the 4-DoF
        graph's error model, keyfame_database.h:271-360).

        pairs: [(frame-offset-in-block, db-row)] of this block's inserts.
        """
        pr, self._pending_refine = self._pending_refine, None
        if pr is None or self.loop is None:
            return
        e = self.loop.edge_index(pr["edge_abs"])
        if e < 0:
            return
        if pairs:
            k_j, j = min(pairs, key=lambda kr: abs(kr[0] - pr["g"]))
        elif self.loop.count >= 1:
            j = self.loop.count - 1
        else:
            return
        self._refine_edge_to_kf(e, pr["t"], pr["ryaw"], pr["p_g"],
                                pr["yaw_g"], j)
        # Fresh refined measurement -> run the 4-DoF graph next overlap
        # window (the reference re-optimizes on every retiring keyframe
        # with a loop, ViewController.mm:850-875; waiting for retirement
        # alone left the published drift a full ride stale).
        self._needs_optimize = True

    def _refine_edge_to_kf(self, e, t_g, ryaw_g, p_g, yaw_g, j) -> None:
        """Re-point refined edge e at keyframe row j: compose the raw-
        odometry gap between the readout frame (raw pose p_g/yaw_g) and
        keyframe j into the (t, yaw) measurement, in the solved old
        pose's yaw frame."""
        p_j = self.loop._kf_p_np[j]
        yaw_j = float(self.loop._kf_yaw_np[j])
        # Solved old-pose yaw in the raw frame: yaw_g − rel_yaw.
        yaw_old = yaw_g - ryaw_g
        c, s = np.cos(yaw_old), np.sin(yaw_old)
        Rz_T = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]],
                        np.float32)
        t_j = np.asarray(t_g, np.float32) + Rz_T @ (
            np.asarray(p_j, np.float32) - np.asarray(p_g, np.float32))
        dyaw = ryaw_g + (yaw_j - yaw_g)
        dyaw = float(np.arctan2(np.sin(dyaw), np.cos(dyaw)))
        self.loop.update_loop_edge(e, t_j, dyaw, j=j)

    def _stage_anchor_from_hit(self, hit) -> None:
        """Stage a verified hit for RIDE-TIME attachment in the scan
        (stream.LoopAnchor): gather the old keyframe's descriptor/obs
        rows on device (no fetch) and upload the pose/scalar block in
        one transfer. The scan attaches the constraint to the live
        frame's features at its next backend frame; retirement flows
        back through the packed LRET flag like any riding constraint."""
        from .stream import LoopAnchor

        lp = self.cfg.loop
        F = self.cfg.window.num_frames
        desc_o, ok_o, obs_o = self.loop.anchor_rows(hit.old_idx)
        p_init, q_init, ttl, pend = jax.device_put(
            (np.asarray(hit.p_old, np.float32),
             np.asarray(hit.q_old, np.float32),
             np.asarray(lp.attach_ttl, np.int32),
             np.asarray(True)))
        self._anchor_dev = LoopAnchor(
            desc_old=desc_o, ok_old=ok_o, obs_old=obs_o,
            p_init=p_init, q_init=q_init,
            ttl=ttl, pending=pend)
        self._pending_loop = {
            "edge_abs": getattr(hit, "edge_abs", -1),
            "old_idx": hit.old_idx,
            # Host TTL mirror: attach window + in-window residence.
            "ttl": lp.attach_ttl + F,
        }

    # -- streaming block mode ------------------------------------------------

    def _scan_state(self):
        from .stream import ScanState

        N = self.cfg.window.max_imu_per_edge
        if self._pending_chunk_dev is not None:
            pending, has = self._pending_chunk_dev
        elif self._pending_chunk is not None:
            pending, has = self._pending_chunk, jnp.asarray(True)
        else:
            pending, has = pre_mod.ImuChunk.empty(N), jnp.asarray(False)
        # Loop block for the scan: an interactive-staged pending loop
        # (host-joined, carries a "dev" LoopInput) re-injects with the
        # mirrored TTL; otherwise the device-carried lifecycle state
        # flows through (block-staged anchors attach INSIDE the scan —
        # stream.LoopAnchor — and the resulting LoopInput lives only in
        # the carried device state).
        if self._pending_loop is not None and "dev" in self._pending_loop:
            loop = self._pending_loop["dev"]._replace(
                ttl=jnp.asarray(self._pending_loop["ttl"], jnp.int32))
        elif self._loop_dev is not None:
            loop = self._loop_dev
        else:
            loop = self._loop_inactive
        anchor = (self._anchor_dev if self._anchor_dev is not None
                  else self._anchor_inactive)
        return ScanState(
            tracker=self.tracker.state, pnp=self.pnp, est=self.est,
            pending=pending, has_pending=has,
            phase=jnp.asarray(self.frame_idx % self.cfg.freq, jnp.int32),
            loop=loop, anchor=anchor,
            solver_budget=jnp.asarray(self.solver_budget, jnp.int32))

    def dispatch_block(self, imgs, chunks, ts=None):
        """Phase 1 of block processing: launch the fused device scan
        (stream.run_vio_scan) for a staged block and commit the resulting
        device state handles WITHOUT synchronizing. The caller overlaps
        host-side publication of the PREVIOUS block with this block's
        device execution — this design's version of the reference's
        thread-pipeline latency hiding (ViewController.mm:276-294).

        Returns an opaque handle for prepare_block/finalize_block.

        HBM residency (measured, 48-frame 640x480 blocks): each
        in-flight block holds its image stack (~59 MB) plus the
        precomputed pyramid/gradient xs (~230 MB); with two scans in
        flight and the previous block's prep alive for deferred
        insertion, peak block-buffer residency is ~0.6 GB. Re-examine
        before raising block size or depth by an order of magnitude."""
        assert self.initialized, "block mode requires an initialized system"
        import time as _time

        from .stream import run_vio_scan

        _t0 = _time.perf_counter()
        if self._scan_jit is None:
            cfg = self.cfg
            self._scan_jit = jax.jit(
                lambda s, im, ch: run_vio_scan(
                    s, im, ch, cfg, self.ext, self.gravity,
                    use_pnp=self.use_pnp))
        n = int(imgs.shape[0])
        state2, outs = self._scan_jit(self._scan_state(),
                                      jnp.asarray(imgs, jnp.float32), chunks)
        # Commit device state (handles only; no host sync). Loop-closure
        # drift never feeds the scan state, so dispatching ahead is safe.
        self.tracker.state = state2.tracker
        self.pnp = state2.pnp
        self.est = state2.est
        self._loop_dev = state2.loop
        self._anchor_dev = state2.anchor
        if self.use_pnp and self.cfg.solver.pnp_stream_solve == "deadreckon":
            self._pnp_preints_stale = True
        self._pending_chunk_dev = (state2.pending, state2.has_pending)
        self._pending_chunk = None
        self.frame_idx += n
        self.timings["dispatch"] = self.timings.get("dispatch", 0) + _time.perf_counter() - _t0
        self.timings["blocks"] = self.timings.get("blocks", 0) + 1
        # Stamp the constraint with this dispatch: with depth-2
        # streaming a constraint staged at sync k first rides scan k+2,
        # but sync k+1 (a block that did NOT carry it) would otherwise
        # decrement the host TTL mirror (ADVICE r4 #4).
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        if self._pending_loop is not None:
            self._pending_loop.setdefault("rode", set()).add(seq)
        # The handle carries this block's own end-of-block track-id
        # buffer: with two blocks in flight, self.est already points at
        # the NEXT block's state by the time this block is synced.
        return (outs, imgs, n, ts, state2.est.feats.track_id, seq)

    def sync_block(self, handle):
        """Phase 2a (synchronizes on the block's device scan): fetch the
        per-frame leaves, run the loop-edge lifecycle (refined-edge
        update + retirement-time pose graph, mirroring the interactive
        path), detect the PREVIOUS block's keyframes from their
        (pre-dispatched) scores, and stage any new loop constraint for
        the NEXT dispatch. Keyframe INSERTION for this block is NOT done
        here — call insert_block_keyframes (process_stream does so after
        the next dispatch, so the insert programs and host work overlap
        the next scan instead of idling the device). Returns an opaque
        prep object for insert_block_keyframes/publish_block."""
        import time as _time

        _t0 = _time.perf_counter()
        outs, imgs, n, ts, _tid_dev, disp_seq = handle
        # Detection scores for the PREVIOUS block's keyframes ride the
        # combined fetch below: steady-state loop detection then costs
        # no extra round trip (each blocking fetch waits for the device
        # queue). process_stream
        # pre-dispatches the score programs right after inserting those
        # keyframes (inside the previous overlap window); the sync API
        # (prepare_block) lands here with no pre-dispatch and pays the
        # dispatch now.
        pending_detect, self._pending_detect = self._pending_detect, []
        pending_scores, self._pending_scores = self._pending_scores, None
        if pending_detect and self.use_loop:
            if pending_scores is None:
                pending_scores = self.loop.dispatch_scores(pending_detect)
            scores_dev, floor = pending_scores
        else:
            scores_dev, floor = None, 0.0
        drift_dev = ((self.loop._r_drift_dev, self.loop._t_drift_dev)
                     if self.use_loop else (0, 0))
        # Geometric-verify results for candidates gated at the PREVIOUS
        # sync: their programs queued behind the scan we're syncing now,
        # so they're materialized — fetch them in the combined get.
        pend_verify, self._pending_verify = self._pending_verify, None
        vhandles = (self.loop.pending_verify_handles(pend_verify)
                    if pend_verify is not None else [])
        # Zero-payload sync first: block until the scan's outputs are
        # materialized WITHOUT transferring (scan_wait), then do the
        # combined wire fetch (fetch_wire) — the split decides whether
        # optimization effort goes to compute or transfer.
        jax.block_until_ready(outs.p)
        _t_wait = _time.perf_counter()
        self.timings["scan_wait"] = self.timings.get("scan_wait", 0) + _t_wait - _t0
        # Small per-frame leaves only (~25 KB + the [N,M,3] sparse map);
        # the keyframe-harvest leaves stay on device and feed the fused
        # insert program directly. Everything scalar rides ONE packed
        # [N, 18] buffer (stream.PACK_*): each fetched buffer has its
        # own transfer overhead.
        (packed_h, tid_h, scores_h, drift_h,
         pcl_h, pok_h, vfetched) = jax.device_get(
            (outs.packed, _tid_dev, scores_dev,
             drift_dev, outs.point_cloud, outs.point_valid, vhandles))
        from . import stream as _st
        p_h = packed_h[:, _st.PACK_P]
        q_h = packed_h[:, _st.PACK_Q]
        cost_h = packed_h[:, _st.PACK_COST]
        is_be_h = packed_h[:, _st.PACK_IS_BE] > 0.5
        is_kf_h = packed_h[:, _st.PACK_IS_KF] > 0.5
        fail_h = packed_h[:, _st.PACK_FAIL] > 0.5
        ntr_h = packed_h[:, _st.PACK_NTRACK].astype(np.int32)
        lgood_h = packed_h[:, _st.PACK_LGOOD] > 0.5
        lry_h = packed_h[:, _st.PACK_LYAW]
        lret_h = packed_h[:, _st.PACK_LRET] > 0.5
        lrt_h = packed_h[:, _st.PACK_LREL_T]
        if self.use_loop:
            self.loop.sync_drift(drift_h[0], drift_h[1])
        # Host copy of the landmark-slot track ids at this block's end:
        # loop staging joins matches against it WITHOUT a device fetch
        # (the handle carries the track-id buffer captured at dispatch
        # time — fetching self.est here would block on any LATER
        # dispatched scan when two blocks are in flight).
        self._track_ids_host = tid_h
        self.timings["fetch_wire"] = self.timings.get("fetch_wire", 0) + _time.perf_counter() - _t_wait
        _t1 = _time.perf_counter()

        # Failure inside the block: the scan freezes the estimator; the
        # host re-enters INITIAL from the failure point (process_stream
        # reprocesses the tail — VINS.cpp:463-467 keeps consuming frames).
        fail_idx = np.flatnonzero(fail_h)
        fail_at = int(fail_idx[0]) if len(fail_idx) else None
        n_ok = fail_at if fail_at is not None else n

        # Loop-edge lifecycle for the constraint that rode this block's
        # scan: refine the pose-graph edge with the last solved relative
        # pose, mirror the frame slide, and run the 4-DoF pose graph at
        # retirement (ViewController.mm:850-875).
        if self._pending_loop is not None and \
                disp_seq in self._pending_loop.get("rode", ()):
            pl = self._pending_loop
            ret_idx = np.flatnonzero(lret_h[:n_ok])
            stop = int(ret_idx[0]) + 1 if len(ret_idx) else n_ok
            good_idx = np.flatnonzero(lgood_h[:stop])
            if len(good_idx):
                # The refined measurement is read against the solving
                # window's NEWEST frame (estimator.py); DEFER the edge
                # write to the insert phase, where this block's
                # keyframes have rows — the edge is re-pointed at the
                # keyframe nearest the readout frame, with the small
                # raw-odometry gap composed in (insert_block_keyframes).
                g = int(good_idx[-1])
                self._pending_refine = {
                    "edge_abs": pl["edge_abs"], "g": g,
                    "t": lrt_h[g], "ryaw": float(lry_h[g]),
                    "p_g": p_h[g], "yaw_g": _np_yaw(q_h[g])}
            if len(ret_idx) or fail_at is not None:
                # The pose-graph run itself is DEFERRED to the next
                # overlap window (insert_block_keyframes): its program
                # dispatch + device time would otherwise sit in the
                # device-idle gap between scans. Drift visibility is
                # unchanged — the host drift mirror already syncs one
                # combined fetch later either way.
                self._needs_optimize = True
                self._pending_loop = None
            else:
                # Host mirror of the device-side TTL (keeps interactive
                # mode consistent after a mode switch).
                pl["ttl"] -= int(np.sum(is_be_h[:n_ok]))

        self.timings["loop_edge"] = self.timings.get("loop_edge", 0) \
            + _time.perf_counter() - _t1
        _t2 = _time.perf_counter()
        loop_hits = {}
        if pend_verify is not None:
            # Finish verification for candidates gated LAST sync (their
            # fetched results rode this sync's combined get — two blocks
            # of detection latency total; the track-anchored constraint
            # tolerates it). loop_hits keys are DB indices (the source
            # frames left the pipeline blocks ago).
            hits = self.loop.finish_detect(pend_verify, vfetched)
            for idx, hit in zip(pend_verify[0], hits):
                if hit is not None:
                    loop_hits[-1 - idx] = hit.old_idx
                    self._stage_queue.append(hit)
            self._stage_queue = self._stage_queue[-4:]
        self.timings["loop_finish"] = self.timings.get("loop_finish", 0) \
            + _time.perf_counter() - _t2
        _t4 = _time.perf_counter()
        if pending_detect and self.use_loop and scores_h is not None:
            # Gating + geometric-verification DISPATCH are deferred to
            # the overlap window (insert_block_keyframes): the dispatch
            # overhead itself (argument uploads + program launch) sat on
            # the sync critical path, and the verify programs queue
            # behind the in-flight
            # next scan either way; their results ride the NEXT sync's
            # combined fetch.
            self._pending_gate = (pending_detect, scores_h, floor)
        # One constraint in flight at a time (reference retrive_pose
        # behavior): when none is pending, stage the NEWEST queued hit
        # as a ride-time anchor (stream.LoopAnchor) — the scan matches
        # the old keyframe's descriptors against the LIVE frame when the
        # constraint starts riding, so detection latency cannot starve
        # the join (the host-side track-id join measured ZERO surviving
        # ids at 2-block latency). Older queued hits stay as tentative
        # pose-graph edges.
        if self._pending_loop is None and self._stage_queue:
            hit = self._stage_queue.pop()
            self._stage_queue.clear()
            self._stage_anchor_from_hit(hit)

        self.timings["loop_stage"] = self.timings.get("loop_stage", 0) \
            + _time.perf_counter() - _t4
        if fail_at is not None:
            # Re-anchor at the last PRE-failure published pose; if the
            # failure hit the first frame of the block, keep the previous
            # block's anchor (self._last_good) untouched.
            if fail_at >= 1:
                self._last_good = (p_h[fail_at - 1], _np_yaw(q_h[fail_at - 1]))
            self._fail_reset()
        elif n_ok >= 1:
            self._last_good = (p_h[n_ok - 1], _np_yaw(q_h[n_ok - 1]))

        self.timings["prepare_loop"] = self.timings.get("prepare_loop", 0) + _time.perf_counter() - _t1
        self.timings["prepare"] = self.timings.get("prepare", 0) + _time.perf_counter() - _t0
        return dict(outs=outs, imgs=imgs, n=n, n_ok=n_ok, fail_at=fail_at,
                    p=p_h, q=q_h, is_kf=is_kf_h, is_be=is_be_h,
                    cost=cost_h, ntr=ntr_h, loop_hits=loop_hits, ts=ts,
                    pcl=pcl_h, pok=pok_h)

    def insert_block_keyframes(self, prep):
        """Phase 2b (async device dispatches; process_stream runs this
        AFTER dispatching the next block so the insert + scoring
        programs and their host dispatch overhead overlap the next scan
        instead of idling the device): insert this block's keyframes
        into the loop database and pre-dispatch their detection scores.
        The scores ride the NEXT sync_block's combined fetch — one block
        of detection latency, exactly the reference's async loop thread
        feeding retrive_pose_data (VINS.cpp:571-637)."""
        import time as _time

        if not self.use_loop:
            return
        _t0 = _time.perf_counter()
        pending_gate, self._pending_gate = self._pending_gate, None
        if pending_gate is not None:
            # slim=True: streaming stages hits as device-side anchors,
            # so the verify fetch carries one packed scalar row per
            # candidate instead of the big gather leaves.
            self._pending_verify = self.loop.gate_and_dispatch(
                *pending_gate, slim=True)
        self.timings["ins_gate"] = self.timings.get("ins_gate", 0) \
            + _time.perf_counter() - _t0
        _ti = _time.perf_counter()
        if self._needs_optimize:
            self.loop.optimize(defer_fetch=True)
            self._needs_optimize = False
        self.timings["ins_opt"] = self.timings.get("ins_opt", 0) \
            + _time.perf_counter() - _ti
        _ti = _time.perf_counter()
        outs, imgs, ts = prep["outs"], prep["imgs"], prep["ts"]
        is_kf_h = prep["is_kf"]
        # Collect UIDs, not rows: an add_keyframe at the 512-cap calls
        # resample(), which compacts the rows of keyframes inserted
        # EARLIER in this same loop (ADVICE r4 #1). Rows are re-resolved
        # once, after the loop.
        ins_uids = []
        gen0 = self.loop.generation
        for k in range(prep["n_ok"]):
            if not bool(is_kf_h[k]):
                continue
            self.kf_count += 1
            if self.kf_count % self.cfg.loop.loop_freq != 0:
                continue
            (img_k, p_k, q_k, px_k, v_k, w_k, wok_k, ids_k) = \
                self._take_frame(
                    (imgs, outs.p, outs.q, outs.kf_pts_px, outs.kf_valid,
                     outs.kf_pts_w, outs.kf_w_ok, outs.kf_ids),
                    jnp.asarray(k, jnp.int32))
            idx = self.loop.add_keyframe(
                img_k, p_k, q_k, px_k, v_k, w_k, wok_k,
                window_ids=ids_k,
                t=float(ts[k]) if ts is not None else 0.0,
                p_host=prep["p"][k], yaw_host=_np_yaw(prep["q"][k]))
            ins_uids.append((k, self.loop.uid_of(idx)))
        # Re-resolve rows through UIDs if a resample compacted the DB
        # mid-loop (ADVICE r4 #1); (frame-offset, row) pairs stay
        # aligned and resampled-away keyframes drop out.
        pairs = [(k, self.loop.row_of(u)) for k, u in ins_uids]
        pairs = [(k, r) for k, r in pairs if r >= 0]
        inserted = [r for _, r in pairs]
        self._apply_pending_refine(pairs)
        self.timings["ins_add"] = self.timings.get("ins_add", 0) \
            + _time.perf_counter() - _ti
        _ti = _time.perf_counter()
        # This block's keyframes queue for the NEXT sync's scoring.
        self._pending_detect = inserted
        if inserted:
            self._pending_scores = self.loop.dispatch_scores(inserted)
        self.timings["ins_scores"] = self.timings.get("ins_scores", 0) \
            + _time.perf_counter() - _ti
        # Periodic in-stream global BA over the harvested keyframe map
        # (opt-in; see __init__). Runs here — the overlap window — so
        # its device programs queue behind the in-flight scan; the cost
        # fetch is deferred like the pose graph's drift.
        if self._ba_every and \
                self.loop.count - self._last_ba_count >= self._ba_every:
            self._last_ba_count = self.loop.count
            self.loop.global_ba(mesh=self._ba_mesh, defer_fetch=True)
            self.ba_runs = getattr(self, "ba_runs", 0) + 1
        self.timings["insert"] = self.timings.get("insert", 0) + _time.perf_counter() - _t0

    def publish_block(self, prep, ts=None):
        """Phase 2b (pure host work, overlappable with the next block's
        device scan): drift-correct and assemble the per-frame outputs,
        including the drift-corrected sparse map at backend frames
        (update_loop_correction, VINS.cpp:307-331)."""
        import time as _time

        if ts is None:
            ts = prep.get("ts")
        _t0 = _time.perf_counter()
        outs = prep["outs"]
        n_ok, fail_at = prep["n_ok"], prep["fail_at"]
        p_h, q_h = prep["p"], prep["q"]
        # The sparse-map leaves ride sync_block's combined fetch (a
        # separate fetch here sat on the stream's critical path for a
        # full scan-length).
        pcl_h, pok_h = prep["pcl"], prep["pok"]

        results = []
        for k in range(n_ok):
            p, q = self._drift_correct(p_h[k], q_h[k])
            t = float(ts[k]) if ts is not None else 0.0
            pcl = pval = None
            if bool(prep["is_be"][k]):
                pcl = self._drift_correct_points(
                    pcl_h[k].astype(np.float32))
                pval = pok_h[k]
            results.append(PipelineOutput(
                t=t, p=p, q=q, p_raw=p_h[k],
                is_keyframe=bool(prep["is_kf"][k]), initialized=True,
                n_tracked=int(prep["ntr"][k]),
                solver_cost=float(prep["cost"][k]),
                loop_hit=prep["loop_hits"].get(k),
                point_cloud=pcl, point_valid=pval))
            self.trajectory.append(p)
        if fail_at is not None:
            t = float(ts[fail_at]) if ts is not None else 0.0
            results.append(PipelineOutput(
                t=t, p=np.zeros(3, np.float32),
                q=np.array([1, 0, 0, 0], np.float32),
                p_raw=np.zeros(3, np.float32), is_keyframe=False,
                initialized=False, n_tracked=0, solver_cost=0.0,
                loop_hit=None, status="FAILURE"))
        self.timings["publish"] = self.timings.get("publish", 0) + _time.perf_counter() - _t0
        return results

    def prepare_block(self, handle):
        """Synchronous phase 2a: sync + keyframe insertion in one call
        (the streaming loop calls sync_block and insert_block_keyframes
        separately to overlap the inserts with the next scan)."""
        prep = self.sync_block(handle)
        self.insert_block_keyframes(prep)
        return prep

    def finalize_block(self, handle, ts=None):
        """Phase 2: prepare (sync + loop closure) and publish in one
        call. Loop detection for this block's keyframes is deferred to
        the NEXT block's combined fetch (or drain_loop_work at end of
        stream) — one round trip per block in total."""
        return self.publish_block(self.prepare_block(handle), ts)

    def drain_loop_work(self):
        """Complete deferred loop-closure work (end of a stream/run):
        detect any still-pending keyframes, fold their edges with one
        pose-graph run, finalize a pending constraint, sync drift."""
        if not self.use_loop:
            return
        pending, self._pending_detect = self._pending_detect, []
        pending_scores, self._pending_scores = self._pending_scores, None
        n_hits = 0
        # Gate any scores fetched but not yet gated (the overlap window
        # that would have run gate_and_dispatch never came).
        pending_gate, self._pending_gate = self._pending_gate, None
        if pending_gate is not None and self._pending_verify is None:
            self._pending_verify = self.loop.gate_and_dispatch(
                *pending_gate)
        # Finish any gated-but-unfetched geometric verifications.
        pend_verify, self._pending_verify = self._pending_verify, None
        if pend_verify is not None:
            vfetched = jax.device_get(
                self.loop.pending_verify_handles(pend_verify))
            vh = [h for h in self.loop.finish_detect(pend_verify, vfetched)
                  if h is not None]
            n_hits += len(vh)
            self._stage_queue.extend(vh)
        if pending:
            if pending_scores is not None:
                # Reuse the already-dispatched scoring result instead of
                # re-running the program (one redundant device program +
                # fetch at end of stream otherwise).
                scores_h, floor = (jax.device_get(pending_scores[0]),
                                   pending_scores[1])
                hits_all = self.loop.detect_from_scores(pending, scores_h,
                                                        floor)
            else:
                hits_all = self.loop.detect_many(pending)
            hits = [h for h in hits_all if h is not None]
            # += : finished pending verifications above already counted
            # toward n_hits; overwriting dropped their end-of-run
            # pose-graph fold when this branch found nothing new.
            n_hits += len(hits)
            self._stage_queue.extend(hits)
            self._stage_queue = self._stage_queue[-4:]
        if self._pending_loop is not None:
            self.loop.optimize()
            self._pending_loop = None
        elif n_hits or self._needs_optimize:
            self.loop.optimize()
        self._needs_optimize = False
        self.loop.sync_drift()


    def process_block(self, imgs, chunks, ts=None):
        """Synchronous block processing: dispatch + finalize in one call.
        imgs: [N, H, W]; chunks: stacked ImuChunk [N, ...]."""
        return self.finalize_block(self.dispatch_block(imgs, chunks, ts))

    def process_stream(self, imgs, chunks, block: int = 48, ts=None,
                       realtime: bool = False, depth: int = 2):
        """Streamed block processing of a long staged sequence with
        host/device overlap (the role the reference's five threads play,
        SURVEY.md §2.3 row 1).

        Double-buffered: up to `depth` block scans are in flight on the
        (in-order) device queue at once. Steady state for block k:

          [scan k done, scan k+1 executing]
          sync block k         (fetch overlaps scan k+1's compute)
          loop lifecycle + staging (host; hit stages into scan k+2)
          insert block k's keyframes (device programs queue BEHIND the
              in-flight scan k+1, so their scores materialize right
              after it and ride sync k+1's combined fetch)
          publish block k      (pure host)
          dispatch scan k+2

        The device therefore runs scan k+1 back-to-back after scan k
        with only the tiny insert programs between scans — every host
        cost (fetch wire time, loop bookkeeping, publication) hides
        under device compute. Loop detections stage constraints two
        blocks out (the track-anchored LoopInput tolerates the extra
        block of attrition by design, estimator.py LoopInput).

        Bootstrap runs inside the stream (interactive frames until
        initialized, blocks after), and an in-block failure re-enters
        INITIAL, DISCARDS any speculative in-flight block, and
        REPROCESSES the tail instead of truncating (VINS.cpp:463-467).
        Returns one output per input frame."""
        import time as _time

        n = int(imgs.shape[0])
        results = []
        i = 0
        inflight = []  # FIFO of (handle, start, end)
        last_sync_t = None

        # Block slicing via ONE jitted dynamic-slice program (traced
        # start index): eager `x[i:e]` on a staged device array compiles
        # a NEW program per distinct offset.
        def block_of(x, s, e):
            if isinstance(x, np.ndarray):
                return x[s:e]
            return self._slice_block(x, jnp.asarray(s, jnp.int32), e - s)

        def dispatch_next():
            nonlocal i
            e = min(i + block, n)
            _ts0 = _time.perf_counter()
            im_b = block_of(imgs, i, e)
            ch_b = jax.tree.map(lambda x: block_of(x, i, e), chunks)
            self.timings["stream_slice"] = self.timings.get(
                "stream_slice", 0) + _time.perf_counter() - _ts0
            handle = self.dispatch_block(
                im_b, ch_b, ts=ts[i:e] if ts is not None else None)
            inflight.append((handle, i, e))
            i = e

        while i < n or inflight:
            # INITIAL (bootstrap or failure recovery): interactive
            # frames. A failure drains `inflight` first, so this branch
            # never races an in-flight speculative block.
            if not self.initialized and not inflight:
                out = self.process_frame(
                    block_of(imgs, i, i + 1)[0],
                    jax.tree.map(lambda x: block_of(x, i, i + 1)[0],
                                 chunks),
                    t=float(ts[i]) if ts is not None else 0.0)
                results.append(out)
                i += 1
                continue
            # Keep `depth` scans in flight.
            while i < n and self.initialized and len(inflight) < depth:
                dispatch_next()
            handle, s0, e0 = inflight.pop(0)
            prep = self.sync_block(handle)
            if prep["fail_at"] is not None:
                # Publish the good prefix + the failure marker, discard
                # any speculative in-flight block (its input state was
                # frozen-garbage from the failure frame on; _fail_reset
                # already replaced the committed state handles), and
                # reprocess from the failure point.
                self.insert_block_keyframes(prep)
                results.extend(self.publish_block(prep))
                inflight.clear()
                last_sync_t = None
                i = s0 + prep["fail_at"] + 1
                continue
            self.insert_block_keyframes(prep)
            results.extend(self.publish_block(prep))
            # Backpressure (VINS.cpp:646-653 analog), REAL-TIME mode
            # only (offline replay has no arrival deadline): in steady
            # state consecutive sync completions are exactly one block
            # apart; compare that cadence to the block's real-time span
            # and scale the solver's iteration budget for future blocks.
            _t_now = _time.perf_counter()
            if realtime and ts is not None and e0 - s0 >= 2 \
                    and last_sync_t is not None:
                span = float(ts[e0 - 1] - ts[s0]) \
                    * (e0 - s0) / (e0 - s0 - 1)
                wall = _t_now - last_sync_t
                if span > 0:
                    if wall > span and \
                            self.solver_budget > self._budget_floor:
                        self.solver_budget -= 1
                    elif wall < 0.7 * span and \
                            self.solver_budget < self.cfg.solver.max_iters:
                        self.solver_budget += 1
            last_sync_t = _t_now
        if self.use_loop:
            _td = _time.perf_counter()
            self.drain_loop_work()
            self.timings["drain"] = self.timings.get("drain", 0) \
                + _time.perf_counter() - _td
        return results

    def _null_output(self, t, front, status: str = "",
                     initialized: bool = False) -> PipelineOutput:
        return PipelineOutput(
            t=t, p=np.zeros(3, np.float32), q=np.array([1, 0, 0, 0],
                                                       np.float32),
            p_raw=np.zeros(3, np.float32), is_keyframe=False,
            initialized=initialized, n_tracked=int(front.n_tracked),
            solver_cost=0.0, loop_hit=None, status=status)
