"""Keyframe database + loop detection.

Functional re-design of the reference's loop stack:
  * KeyFrame (loop/keyframe.{h,cpp}): FAST+BRIEF keyframe with window
    features and their world points → one row of fixed-capacity device
    arrays;
  * KeyFrameDatabase (loop/keyfame_database.{h,cpp}): bounded global list
    (max 500) with drift-composed pose updates;
  * TemplatedLoopDetector (loop/TemplatedLoopDetector.h:668-877): BoW
    query → similarity gating → temporal consistency → geometric check.

Dense detection pipeline (design note): the DBoW2 vocabulary +
inverted file is replaced by a spatially-pooled binary-statistics global
descriptor (ops/brief.global_descriptor); a query against the whole
database is ONE [K, 1024] @ [1024] matvec, normalized-
similarity-gated exactly like demoDetector (alpha, dislocal exclusion,
temporal k). Geometric verification = batched Hamming matching with
ratio test + fundamental RANSAC (≥ MIN_LOOP_NUM inliers,
keyframe.cpp:161-273) + PnP refinement of the old pose
(solveOldPoseByPnP, keyframe.cpp:195-260) producing the relative-pose
loop constraint for the pose graph.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import VinsConfig
from ..ops import brief as brief_mod
from ..ops import corners as corners_mod
from ..ops import ransac as ransac_mod
from ..utils import camera as cam_mod
from ..utils import lie
from .pose_graph import PoseGraph, drift_from_solution, optimize_pose_graph
from . import vocabulary as vocab_mod


class KeyframeDB(NamedTuple):
    """Fixed-capacity keyframe store (device arrays). Nf = features/kf."""

    count: jax.Array      # [] int32 — number of live keyframes
    p: jax.Array          # [K, 3] drift-corrected global positions
    q: jax.Array          # [K, 4] drift-corrected attitudes
    p_origin: jax.Array   # [K, 3] raw VIO poses (pose-graph edges)
    q_origin: jax.Array   # [K, 4]
    gdesc: jax.Array      # [K, 1024] global descriptors
    desc: jax.Array       # [K, Nf, 8] packed BRIEF
    kp_norm: jax.Array    # [K, Nf, 2] normalized image coords
    kp_px: jax.Array      # [K, Nf, 2] pixel coords
    pts_w: jax.Array      # [K, Nf, 3] world points (VIO world, uncorrected)
    pts_ok: jax.Array     # [K, Nf] bool — world point valid
    kp_ok: jax.Array      # [K, Nf] bool — keypoint valid
    segment: jax.Array    # [K] int32 — trajectory segment (failure resets)
    tid: jax.Array        # [K, Nf] int32 — global track id of window rows
                          # (-1 for topped-up FAST corners); associates
                          # landmarks ACROSS keyframes for global BA.

    @staticmethod
    def empty(K: int, Nf: int, dtype=jnp.float32) -> "KeyframeDB":
        return KeyframeDB(
            count=jnp.zeros((), jnp.int32),
            p=jnp.zeros((K, 3), dtype),
            q=jnp.tile(lie.quat_identity(dtype), (K, 1)),
            p_origin=jnp.zeros((K, 3), dtype),
            q_origin=jnp.tile(lie.quat_identity(dtype), (K, 1)),
            gdesc=jnp.zeros((K, 1024), dtype),
            desc=jnp.zeros((K, Nf, 8), jnp.uint32),
            kp_norm=jnp.zeros((K, Nf, 2), dtype),
            kp_px=jnp.zeros((K, Nf, 2), dtype),
            pts_w=jnp.zeros((K, Nf, 3), dtype),
            pts_ok=jnp.zeros((K, Nf), bool),
            kp_ok=jnp.zeros((K, Nf), bool),
            segment=jnp.zeros((K,), jnp.int32),
            tid=jnp.full((K, Nf), -1, jnp.int32))


@jax.jit
def _set_loop_edge(graph, e, i, j, t, yaw, w):
    """Traced-index loop-edge write (one compiled program for every e)."""
    return graph._replace(
        loop_i=graph.loop_i.at[e].set(i),
        loop_j=graph.loop_j.at[e].set(j),
        loop_t=graph.loop_t.at[e].set(t),
        loop_yaw=graph.loop_yaw.at[e].set(yaw),
        loop_w=graph.loop_w.at[e].set(w))


@jax.jit
def _ypr_to_quat_rows(yaw, pitch, roll):
    """[K] yaw/pitch/roll columns → [K,4] quaternions (pose-graph
    write-back)."""
    return jax.vmap(lambda y, pi, r: lie.rotmat_to_quat(
        lie.ypr_to_rotmat(jnp.stack([y, pi, r]))))(yaw, pitch, roll)


@jax.jit
def _evict_edge(graph, v):
    """Remove loop-edge row v (traced index — one compiled program),
    shifting later rows down and zeroing the freed last row."""
    E = graph.loop_w.shape[0]
    idx = jnp.arange(E)
    src = jnp.where(idx < v, idx, jnp.minimum(idx + 1, E - 1))

    def take(a):
        out = a[src]
        return out.at[E - 1].set(jnp.zeros_like(out[E - 1]))

    return graph._replace(
        loop_i=take(graph.loop_i), loop_j=take(graph.loop_j),
        loop_t=take(graph.loop_t), loop_yaw=take(graph.loop_yaw),
        loop_w=take(graph.loop_w))


@jax.jit
def _gather_anchor_rows(db: "KeyframeDB", old):
    """Traced-index gather of one keyframe's descriptor/observation rows
    (feeds stream.LoopAnchor — ride-time attachment; no host fetch)."""
    return db.desc[old], db.kp_ok[old], db.kp_norm[old]


@jax.jit
def _refine_loop_edge(graph, e, t, yaw, w):
    """Traced-index loop-edge refinement write."""
    return graph._replace(
        loop_t=graph.loop_t.at[e].set(t),
        loop_yaw=graph.loop_yaw.at[e].set(yaw),
        loop_w=graph.loop_w.at[e].set(w))


# Fixed width for batched detection queries (detect_many pads to a
# multiple of this so the scoring program has a bounded shape set).
_DETECT_PAD = 8


class LoopHit(NamedTuple):
    old_idx: int            # matched keyframe slot
    cur_idx: int            # query keyframe slot
    n_inliers: int
    # Relative 4-DoF constraint: t_rel in old frame, relative yaw.
    t_rel: np.ndarray       # [3]
    yaw_rel: float
    # Matched correspondences (for injecting loop factors into the
    # window — interactive path only; the streaming path stages via
    # device-side anchors and fetches a SLIM result without these).
    pts_w: np.ndarray = None       # [Nm, 3] current-kf world points
    obs_old: np.ndarray = None     # [Nm, 2] normalized obs in old kf
    match_ok: np.ndarray = None    # [Nm] bool
    # PnP-refined old-keyframe BODY pose in the current raw-odometry
    # frame (initializes the free loop pose of the window solve).
    p_old: np.ndarray = None   # [3]
    q_old: np.ndarray = None   # [4]
    # Current keyframe's raw pose (edge readout anchor).
    p_cur: np.ndarray = None   # [3]
    q_cur: np.ndarray = None   # [4]
    # Track ids of the current keyframe's feature rows (staging joins
    # the matches to the live landmark table by these).
    tids: np.ndarray = None    # [Nm] int32
    # ABSOLUTE id of the pose-graph edge this hit created (stable across
    # edge-table evictions; resolve to a live row via
    # LoopCloser.edge_index). -1 = no edge recorded.
    edge_abs: int = -1


def extract_keyframe_features(img: jax.Array, cfg: VinsConfig,
                              n_feat: int, window_pts_px: jax.Array,
                              window_pts_ok: jax.Array):
    """FAST corners + BRIEF for a keyframe (extractBrief, keyframe.cpp:61):
    the window's tracked features are kept (they carry world points) and
    topped up with fresh FAST corners for matching robustness.

    Returns (pts_px [Nf,2], ok [Nf], desc [Nf,8]).
    """
    Mw = window_pts_px.shape[0]
    n_new = n_feat - Mw
    assert n_new >= 0, "keyframe feature budget below window feature count"
    resp = corners_mod.fast_score(img)
    occ = corners_mod.occupancy_cells(img.shape, window_pts_px,
                                      window_pts_ok,
                                      cfg.frontend.min_distance)
    pick = corners_mod.select_corners_grid(resp, occ, n_new,
                                           cfg.frontend.min_distance)
    # The grid selector yields at most (H/cell)·(W/cell) candidates; pad
    # to the fixed keyframe budget so DB rows have static shape.
    n_pick = min(n_new, pick.pts.shape[0])
    pad = n_new - n_pick
    new_pts = jnp.concatenate(
        [pick.pts[:n_pick], jnp.zeros((pad, 2), pick.pts.dtype)], axis=0)
    new_ok = jnp.concatenate(
        [pick.valid[:n_pick], jnp.zeros((pad,), bool)], axis=0)
    pts = jnp.concatenate([window_pts_px, new_pts], axis=0)
    ok = jnp.concatenate([window_pts_ok, new_ok], axis=0)
    border = brief_mod.PATCH_HALF + 4
    H, W = img.shape
    inb = ((pts[:, 0] >= border) & (pts[:, 0] < W - border)
           & (pts[:, 1] >= border) & (pts[:, 1] < H - border))
    ok = ok & inb
    desc = brief_mod.extract_brief(img, pts, ok)
    return pts, ok, desc


@jax.jit
def _add_row(db: KeyframeDB, idx, p, q, gdesc, desc, kp_norm, kp_px,
             pts_w, pts_ok, kp_ok, segment, tid):
    return db._replace(
        count=jnp.maximum(db.count, idx + 1),
        p=db.p.at[idx].set(p), q=db.q.at[idx].set(q),
        p_origin=db.p_origin.at[idx].set(p),
        q_origin=db.q_origin.at[idx].set(q),
        gdesc=db.gdesc.at[idx].set(gdesc),
        desc=db.desc.at[idx].set(desc),
        kp_norm=db.kp_norm.at[idx].set(kp_norm),
        kp_px=db.kp_px.at[idx].set(kp_px),
        pts_w=db.pts_w.at[idx].set(pts_w),
        pts_ok=db.pts_ok.at[idx].set(pts_ok),
        kp_ok=db.kp_ok.at[idx].set(kp_ok),
        segment=db.segment.at[idx].set(segment),
        tid=db.tid.at[idx].set(tid))


def _insert_impl(db: KeyframeDB, graph: PoseGraph, bow: jax.Array,
                 img, p, q, w_px, w_ok, w_w, w_wok, w_ids, idx,
                 r_drift, t_drift, segment, cfg: VinsConfig, Nf: int,
                 vocab):
    """Whole keyframe insertion as ONE traced program: feature
    extraction, descriptors, drift compose, DB row write, pose-graph
    node mirror, and (when a vocabulary exists) the BoW row.

    Host-side insertion used to run these as ~70 eager ops, each a
    separate dispatch (and some a blocking round trip) on the streaming
    critical path. Fused, insertion is one async dispatch."""
    pts_px, kp_ok, desc = extract_keyframe_features(img, cfg, Nf, w_px,
                                                    w_ok)
    kp_norm = cam_mod.pixel_to_normalized(cfg.camera, pts_px)
    gdesc = brief_mod.global_descriptor(desc, kp_ok, pts_px, img.shape)
    Mw = w_px.shape[0]
    pts_w = jnp.zeros((Nf, 3), jnp.float32).at[:Mw].set(w_w)
    pts_ok = jnp.zeros((Nf,), bool).at[:Mw].set(w_wok & w_ok)
    tid = jnp.full((Nf,), -1, jnp.int32).at[:Mw].set(
        jnp.where(w_ok, w_ids, -1))

    # Drift-compose the pose on insertion (keyfame_database.cpp:21-42).
    p_corr = r_drift @ p + t_drift
    q_corr = lie.rotmat_to_quat(r_drift @ lie.quat_to_rotmat(q))

    db = _add_row(db, idx, p_corr, q_corr, gdesc, desc, kp_norm, pts_px,
                  pts_w, pts_ok, kp_ok, segment, tid)
    # Node gets the CORRECTED pose as its optimization starting value;
    # the ORIGIN columns keep the raw odometry for sequential-edge
    # measurements (pitch/roll are invariant under the yaw-only drift).
    ypr = lie.rotmat_to_ypr(lie.quat_to_rotmat(q_corr))
    ypr_raw = lie.rotmat_to_ypr(lie.quat_to_rotmat(q))
    graph = graph._replace(
        t=graph.t.at[idx].set(p_corr),
        yaw=graph.yaw.at[idx].set(ypr[0]),
        pitch=graph.pitch.at[idx].set(ypr[1]),
        roll=graph.roll.at[idx].set(ypr[2]),
        t_origin=graph.t_origin.at[idx].set(p),
        yaw_origin=graph.yaw_origin.at[idx].set(ypr_raw[0]),
        node_ok=graph.node_ok.at[idx].set(True))
    if vocab is not None:
        _, row = vocab_mod.transform(vocab, desc, kp_ok)
        bow = bow.at[idx].set(row)
    return db, graph, bow


@functools.partial(jax.jit, static_argnames=("max_dist", "ratio", "hyps"))
def _geometric_verify(db: KeyframeDB, cur, old, key, *, max_dist, ratio,
                      hyps, thresh_sq):
    """Match cur→old descriptors, F-RANSAC on normalized coords.
    Gates come from LoopConfig (match_max_dist/match_ratio/geo_ransac_px
    scaled by the active camera's focal — no baked-in EuRoC focal).
    Returns (match_idx [Nf], ok [Nf], n_inliers)."""
    m = brief_mod.match_descriptors(
        db.desc[cur], db.desc[old], db.kp_ok[cur], db.kp_ok[old],
        max_dist=max_dist, ratio=ratio)
    obs_cur = db.kp_norm[cur]
    obs_old = db.kp_norm[old, m.idx]
    rr = ransac_mod.ransac_fundamental(
        obs_cur, obs_old, m.ok, key, hyps, thresh_sq)
    ok = m.ok & rr.inliers
    return m.idx, ok, jnp.sum(ok)


@functools.partial(jax.jit, static_argnames=("max_dist", "ratio", "hyps"))
def _verify_hit(db: KeyframeDB, cur, old, key, tic, qic, *, max_dist,
                ratio, hyps, thresh_sq, max_msr):
    """Fused geometric verification + relative-pose PnP + hit-data
    gather: ONE device program and one host fetch per candidate (the
    split version cost two dispatch+fetch round trips per hit, plus
    per-index eager gathers that compiled a new program per keyframe
    slot)."""
    midx, mok, n_in = _geometric_verify(
        db, cur, old, key, max_dist=max_dist, ratio=ratio, hyps=hyps,
        thresh_sq=thresh_sq)
    t_rel, yaw_rel, good, msr, p_old, q_old = _loop_relative_pose(
        db, cur, old, midx, mok, tic, qic, max_msr)
    return (n_in, t_rel, yaw_rel, good, msr, p_old, q_old,
            db.pts_w[cur], db.kp_norm[old, midx],
            mok & db.pts_ok[cur], db.p_origin[cur], db.q_origin[cur],
            db.tid[cur])


# Fixed batch width for the fused multi-candidate verification program
# (gate_and_dispatch pads to this; one batched program replaces C
# per-candidate dispatches, each with its own argument marshaling,
# VERDICT r4 item 7).
_VERIFY_PAD = 4


@functools.partial(jax.jit, static_argnames=("max_dist", "ratio", "hyps"))
def _verify_hits_batch_slim(db: KeyframeDB, curs, olds, keys, tic, qic,
                            *, max_dist, ratio, hyps, thresh_sq,
                            max_msr):
    """Like _verify_hits_batch but returns ONE packed [C, 21] float32
    buffer of the scalar results only (n_in, t_rel, yaw, good, msr,
    p_old, q_old, p_cur, q_cur). The streaming path stages hits as
    device-side anchors (stream.LoopAnchor), so the big per-candidate
    gather leaves (obs/match/tids/points) are dead there — XLA DCE
    drops their gathers, and the combined sync fetch carries one small
    buffer instead of thirteen (each fetched buffer has its own
    transfer overhead)."""

    def one(c, o, k):
        (n_in, t_rel, yaw_rel, good, msr, p_old, q_old, _pts, _obs,
         _mok, p_cur, q_cur, _tid) = _verify_hit(
            db, c, o, k, tic, qic, max_dist=max_dist, ratio=ratio,
            hyps=hyps, thresh_sq=thresh_sq, max_msr=max_msr)
        f32 = jnp.float32
        return jnp.concatenate([
            jnp.stack([n_in.astype(f32), yaw_rel.astype(f32),
                       good.astype(f32), msr.astype(f32)]),
            t_rel.astype(f32), p_old.astype(f32), q_old.astype(f32),
            p_cur.astype(f32), q_cur.astype(f32)])

    return jax.vmap(one)(curs, olds, keys)


# Column layout of the slim verify row.
_SLIM_NIN, _SLIM_YAW, _SLIM_GOOD, _SLIM_MSR = 0, 1, 2, 3
_SLIM_T = slice(4, 7)
_SLIM_P_OLD = slice(7, 10)
_SLIM_Q_OLD = slice(10, 14)
_SLIM_P_CUR = slice(14, 17)
_SLIM_Q_CUR = slice(17, 21)


@functools.partial(jax.jit, static_argnames=("max_dist", "ratio", "hyps"))
def _verify_hits_batch(db: KeyframeDB, curs, olds, keys, tic, qic, *,
                       max_dist, ratio, hyps, thresh_sq, max_msr):
    """vmapped _verify_hit over a padded candidate batch: curs/olds
    [C] int32, keys [C] PRNG keys. ONE dispatch + one fetch for every
    candidate gated in a block."""
    return jax.vmap(
        lambda c, o, k: _verify_hit(
            db, c, o, k, tic, qic, max_dist=max_dist, ratio=ratio,
            hyps=hyps, thresh_sq=thresh_sq, max_msr=max_msr)
    )(curs, olds, keys)


@jax.jit
def _loop_relative_pose(db: KeyframeDB, cur, old, match_idx, match_ok,
                        tic, qic, max_msr):
    """PnP the old keyframe against the current keyframe's world points
    (solveOldPoseByPnP): returns (t_rel in old frame, yaw_rel, ok).

    Observations live in the CAMERA frame, database poses are BODY poses:
    PnP runs on the camera pose (T_wc = T_wb·T_bc) and converts back.
    The constraint convention matches the pose graph: t_rel = R_oldᵀ
    (p_cur − p_old), yaw_rel = yaw_cur − yaw_old, between BODY poses.
    """
    pts = db.pts_w[cur]                        # current kf world points
    ok = match_ok & db.pts_ok[cur]
    obs_old = db.kp_norm[old, match_idx]
    # Initial guess: old CAMERA pose in VIO world.
    p0_b, q0_b = db.p_origin[old], db.q_origin[old]
    q0_c = lie.quat_mul(q0_b, qic)
    p0_c = p0_b + lie.quat_rotate(q0_b, tic)
    p_c, q_c, msr = ransac_mod.pnp_gn(pts, obs_old, ok, p0_c, q0_c,
                                      iters=10)
    good = (jnp.sum(ok) >= 10) & jnp.isfinite(msr) & (msr < max_msr)
    # Back to the body pose: T_wb = T_wc · T_cb.
    q_old_new = lie.quat_mul(q_c, lie.quat_conj(qic))
    p_old_new = p_c - lie.quat_rotate(q_old_new, tic)
    # Current body pose relative to the REFINED old body pose.
    p_cur, q_cur = db.p_origin[cur], db.q_origin[cur]
    R_old = lie.quat_to_rotmat(q_old_new)
    t_rel = R_old.T @ (p_cur - p_old_new)
    yaw_rel = (lie.rotmat_to_ypr(lie.quat_to_rotmat(q_cur))[0]
               - lie.rotmat_to_ypr(R_old)[0])
    return t_rel, yaw_rel, good, msr, p_old_new, q_old_new


class LoopCloser:
    """Host orchestration of keyframe insertion, loop detection, and the
    4-DoF pose graph (the reference's loop_thread + globalLoopThread roles,
    ViewController.mm:888-1005, minus threads: explicit calls).
    """

    def __init__(self, cfg: VinsConfig, seed: int = 0,
                 ext: Optional[Tuple[jax.Array, jax.Array]] = None,
                 vocab: Optional[vocab_mod.Vocabulary] = None):
        """ext: (tic, qic) camera-IMU extrinsics; identity if None.
        vocab: pre-trained BoW vocabulary. When None and
        cfg.loop.place_recognition == "bow", the SHIPPED pre-trained
        asset is loaded (vocabulary.default_vocabulary — the role of the
        reference's brief_k10L6.bin, ViewController.mm:892-900); only if
        the asset is absent does the legacy fallback train one at runtime
        from the first `vocab_train_after` keyframes' descriptors."""
        self.cfg = cfg
        if vocab is None and cfg.loop.place_recognition == "bow":
            vocab = vocab_mod.default_vocabulary()
        if ext is None:
            self.tic = jnp.zeros(3, jnp.float32)
            self.qic = lie.quat_identity()
        else:
            self.tic, self.qic = ext
        lp = cfg.loop
        K = lp.max_keyframes
        self.Nf = lp.max_kf_features
        self.db = KeyframeDB.empty(K, self.Nf)
        self.graph = PoseGraph.empty(K, E=64)
        self.n_loops = 0
        self.n_optimizes = 0  # pose-graph runs (observability)
        self._loop_i_host = []  # host mirror of loop_i (min w/o a fetch)
        self._loop_w_host = []  # host mirror of edge weights (eviction
                                # picks the lowest-value edge, not FIFO)
        self._edge_abs_host = []  # live rows' absolute edge ids
        self._next_edge_abs = 0
        self.key = jax.random.PRNGKey(seed)
        # Pre-split verify-RANSAC key pool (built by warm(); hot-path
        # dispatches index it instead of calling jax.random.split).
        self._key_pool = None
        self._key_ctr = 0
        self.last_match: Optional[int] = None  # temporal consistency
        self.r_drift = np.eye(3, dtype=np.float32)
        self.t_drift = np.zeros(3, dtype=np.float32)
        self._drift_dirty = False
        self.segment = 0
        # BoW place recognition state (dense [K, n_words] tf-idf rows);
        # sized from the LOADED vocabulary's word count (the shipped
        # asset may be deeper than the runtime-training fallback shape).
        self.vocab = vocab
        n_words = (vocab.n_words if vocab is not None
                   else lp.vocab_k ** lp.vocab_levels)
        self.bow = jnp.zeros((K, n_words), jnp.float32)
        # Host mirrors: every synchronous device fetch on the insert path
        # waits for the device queue, so the count, segments, and drift
        # live on the host (device copies of the drift feed the insert
        # jit).
        self.count = 0
        self._segments_np = np.zeros(K, np.int32)
        self._kf_t_np = np.zeros(K, np.float64)  # capture stamps (eval)
        # Stable keyframe identity across resample() compaction: row
        # indices captured by in-flight (deferred) detection/verify work
        # go stale when the 512-cap compaction remaps rows mid-stream;
        # UIDs let consumers re-resolve (or drop) them (ADVICE r4 #1).
        self.generation = 0          # bumped by every resample()
        self._uid_np = np.full(K, -1, np.int64)
        self._next_uid = 0
        # Host mirror of keyframe positions (raw odometry frame): the
        # detection gate's spatial temporal-consistency test reads it
        # every query — a device fetch there would sync on the in-flight
        # scan. Callers on the hot path pass p_host (already fetched).
        self._kf_p_np = np.zeros((K, 3), np.float32)
        # Raw yaw mirror (edge-refinement odometry compensation —
        # pipeline re-points refined edges at the keyframe nearest the
        # readout frame and composes the small raw-odometry gap in).
        self._kf_yaw_np = np.zeros(K, np.float32)
        # Loop-edge eviction count: absolute edge id - n_edges_evicted =
        # live row in the rolled edge table (see edge_index).
        self.n_edges_evicted = 0
        self._r_drift_dev = jnp.eye(3, dtype=jnp.float32)
        self._t_drift_dev = jnp.zeros(3, jnp.float32)
        # Device-resident verify constants (one upload instead of a
        # jnp.asarray transfer per dispatch).
        self._thresh_sq_dev = jnp.asarray(
            (lp.geo_ransac_px / cfg.camera.focal) ** 2, jnp.float32)
        self._max_msr_dev = jnp.asarray(lp.pnp_max_msr, jnp.float32)

        cfg_, Nf_ = cfg, self.Nf
        self._ins_plain = jax.jit(
            lambda db, graph, bow, *a: _insert_impl(
                db, graph, bow, *a, cfg=cfg_, Nf=Nf_, vocab=None))
        self._ins_vocab = jax.jit(
            lambda db, graph, bow, vocab, *a: _insert_impl(
                db, graph, bow, *a, cfg=cfg_, Nf=Nf_, vocab=vocab))
        self._scores_batch = jax.jit(
            lambda bow_db, rows: jax.vmap(
                lambda r: vocab_mod.score_database(bow_db, r))(rows))
        self._gdesc_scores_batch = jax.jit(
            lambda gdesc_db, rows: rows @ gdesc_db.T)
        self._opt_graph = jax.jit(functools.partial(
            optimize_pose_graph, iters=lp.pose_graph_iters,
            n_back=lp.sequential_edges))
        self._drift_jit = jax.jit(drift_from_solution)

    def warm(self) -> None:
        """Pre-compile every steady-state loop program (insert, batched
        scoring, geometric verify, relative-pose PnP, pose graph) via AOT
        lowering on shape structs — nothing executes, but each program
        lands in the persistent compilation cache so no compile fires
        mid-stream on the first keyframe/hit (a fresh compile is seconds
        on the critical path)."""
        cfg = self.cfg
        lp = cfg.loop
        H, W = cfg.camera.height, cfg.camera.width
        Mw = cfg.frontend.max_features
        sds = jax.ShapeDtypeStruct
        st = lambda tree: jax.tree.map(
            lambda x: sds(jnp.shape(x), x.dtype), tree)
        f32, i32 = jnp.float32, jnp.int32
        args = (sds((H, W), f32), sds((3,), f32), sds((4,), f32),
                sds((Mw, 2), f32), sds((Mw,), jnp.bool_),
                sds((Mw, 3), f32), sds((Mw,), jnp.bool_),
                sds((Mw,), i32), sds((), i32), sds((3, 3), f32),
                sds((3,), f32), sds((), i32))
        db_s, g_s, bow_s = st(self.db), st(self.graph), st(self.bow)
        self._ins_plain.lower(db_s, g_s, bow_s, *args).compile()
        if self.vocab is not None:
            self._ins_vocab.lower(db_s, g_s, bow_s, st(self.vocab),
                                  *args).compile()
        for Q in (1, _DETECT_PAD):
            self._scores_batch.lower(
                bow_s, sds((Q, self.bow.shape[1]), f32)).compile()
            self._gdesc_scores_batch.lower(
                st(self.db.gdesc),
                sds((Q, self.db.gdesc.shape[1]), f32)).compile()
        key_s = st(self.key)
        idx_s = sds((), i32)
        C = _VERIFY_PAD
        keys_s = sds((C,) + jnp.shape(self.key), self.key.dtype)
        _verify_hits_batch.lower(
            db_s, sds((C,), i32), sds((C,), i32), keys_s,
            st(self.tic), st(self.qic),
            max_dist=lp.match_max_dist, ratio=lp.match_ratio,
            hyps=lp.geo_ransac_hyps, thresh_sq=sds((), f32),
            max_msr=sds((), f32)).compile()
        self._opt_graph.lower(g_s, idx_s).compile()
        self._drift_jit.lower(g_s, idx_s).compile()
        # AOT lowering populates the persistent compile cache, but the
        # first REAL call of each program in a process still pays the
        # executable load from that cache. Execute every
        # hit-path program once on dummy inputs (pure functions; results
        # discarded) so the loads land HERE — untimed warmup — instead
        # of inside the measured stream when the first hit fires.
        lp_ = self.cfg.loop
        z = jnp.asarray(0, jnp.int32)
        zc = jnp.zeros((_VERIFY_PAD,), jnp.int32)
        # Pre-split key pool for the hot-path verify dispatches: ONE
        # split + ONE fetch here; the pool lives as host rows (a
        # device_put per dispatch ~1 ms vs ~770 ms for the first
        # in-region split). 64 dispatch rounds before reuse.
        rows = jax.random.split(self.key, 64 * _VERIFY_PAD + 1)
        self.key = rows[0]
        pool_h = np.asarray(jax.device_get(rows[1:])).reshape(
            64, _VERIFY_PAD, -1)
        self._key_pool = [pool_h[r] for r in range(64)]
        keys = jnp.asarray(self._key_pool[0])
        t0 = jnp.zeros((3,), f32)
        y0 = jnp.zeros((), f32)
        for vfn in (_verify_hits_batch, _verify_hits_batch_slim):
            jax.block_until_ready(vfn(
                self.db, zc, zc, keys, self.tic, self.qic,
                max_dist=lp_.match_max_dist, ratio=lp_.match_ratio,
                hyps=lp_.geo_ransac_hyps, thresh_sq=self._thresh_sq_dev,
                max_msr=self._max_msr_dev))
        jax.block_until_ready(_gather_anchor_rows(self.db, z))
        jax.block_until_ready(_evict_edge(self.graph, z))
        jax.block_until_ready(_set_loop_edge(self.graph, z, z, z, t0,
                                             y0, y0))
        jax.block_until_ready(_refine_loop_edge(self.graph, z, t0, y0,
                                                y0))
        jax.block_until_ready(self._opt_graph(self.graph, z))
        jax.block_until_ready(self._drift_jit(self.graph, z))
        jax.block_until_ready(_ypr_to_quat_rows(
            self.graph.yaw, self.graph.pitch, self.graph.roll))

    # -- vocabulary --------------------------------------------------------

    def _bow_row(self, idx: int) -> None:
        """(Re)compute the BoW vector for DB row idx with self.vocab."""
        _, bow = vocab_mod.transform(self.vocab, self.db.desc[idx],
                                     self.db.kp_ok[idx])
        self.bow = self.bow.at[idx].set(bow)

    def _maybe_train_vocab(self) -> None:
        """Auto-train the vocabulary once enough keyframes accumulated,
        then retro-fill BoW rows for every stored keyframe."""
        lp = self.cfg.loop
        n = self.count
        if (self.vocab is not None or lp.place_recognition != "bow"
                or n < lp.vocab_train_after):
            return
        desc = np.asarray(self.db.desc[:n]).reshape(-1, 8)
        ok = np.asarray(self.db.kp_ok[:n]).reshape(-1)
        img_ids = np.repeat(np.arange(n), self.Nf)
        self.vocab = vocab_mod.train_vocabulary(
            desc[ok], k=lp.vocab_k, levels=lp.vocab_levels,
            iters=lp.vocab_train_iters, image_ids=img_ids[ok])
        for i in range(n):
            self._bow_row(i)

    # -- insertion ---------------------------------------------------------

    def add_keyframe(self, img, p, q, window_pts_px, window_pts_ok,
                     window_pts_w, window_pts_w_ok,
                     window_ids=None, t: float = 0.0,
                     p_host=None, yaw_host=None) -> int:
        """Insert a keyframe; returns its slot index.

        p/q: VIO pose (body in world); window_*: the sliding window's
        tracked features at this frame with their world points;
        window_ids: [Mw] global track ids of the window rows (enables
        cross-keyframe landmark association for global BA);
        t: capture timestamp (seconds; evaluation/export only);
        p_host/yaw_host: host copies of the raw pose/yaw, if the caller
        already fetched them (block mode must — a device_get here would
        block on the in-flight scan); when None, fetched from p/q (fine
        off the streaming path).
        """
        if self.count == 0:
            # Lazy re-sync of the host count mirror: tests/tools may seed
            # rows via _add_row directly without touching the mirror (the
            # mirror exists so the hot insert path never blocks on a
            # device fetch).
            self.count = int(self.db.count)
        idx = self.count
        K = self.db.p.shape[0]
        if idx >= K:
            self.resample()
            idx = self.count

        Mw = window_pts_px.shape[0]
        if window_ids is None:
            window_ids = jnp.full((Mw,), -1, jnp.int32)
        args = (jnp.asarray(img, jnp.float32), p, q, window_pts_px,
                window_pts_ok, window_pts_w, window_pts_w_ok,
                jnp.asarray(window_ids, jnp.int32),
                jnp.asarray(idx, jnp.int32), self._r_drift_dev,
                self._t_drift_dev, jnp.asarray(self.segment, jnp.int32))
        if self.vocab is not None:
            self.db, self.graph, self.bow = self._ins_vocab(
                self.db, self.graph, self.bow, self.vocab, *args)
        else:
            self.db, self.graph, self.bow = self._ins_plain(
                self.db, self.graph, self.bow, *args)
        self._segments_np[idx] = self.segment
        self._kf_t_np[idx] = t
        self._kf_p_np[idx] = (np.asarray(p_host, np.float32)
                              if p_host is not None
                              else np.asarray(jax.device_get(p),
                                              np.float32))
        if yaw_host is None:
            qh = np.asarray(jax.device_get(q), np.float32)
            # yaw of R(q): atan2 of the rotated x-axis (w,x,y,z quat).
            w, x, y, z = qh
            yaw_host = np.arctan2(2 * (w * z + x * y),
                                  1 - 2 * (y * y + z * z))
        self._kf_yaw_np[idx] = float(yaw_host)
        self._uid_np[idx] = self._next_uid
        self._next_uid += 1
        self.count = max(self.count, idx + 1)
        if self.vocab is None:
            self._maybe_train_vocab()
        return idx

    def anchor_rows(self, old_idx: int):
        """DEVICE handles of keyframe old_idx's (desc, kp_ok, kp_norm)
        rows — the ride-time attachment payload (stream.LoopAnchor)."""
        return _gather_anchor_rows(self.db,
                                   jnp.asarray(old_idx, jnp.int32))

    # -- stable identity ---------------------------------------------------

    def uid_of(self, idx: int) -> int:
        """Stable UID of the keyframe currently in row idx."""
        return int(self._uid_np[idx])

    def row_of(self, uid: int) -> int:
        """Current row of a keyframe UID, or -1 if resampled away."""
        rows = np.flatnonzero(self._uid_np[:self.count] == uid)
        return int(rows[0]) if len(rows) else -1

    def rows_of(self, uids) -> list:
        """Current rows for a UID list, dropping resampled-away frames."""
        return [r for r in (self.row_of(u) for u in uids) if r >= 0]

    def edge_index(self, edge_abs: int) -> int:
        """Live edge-table row for an absolute edge id, -1 if evicted."""
        if edge_abs < 0:
            return -1
        try:
            return self._edge_abs_host.index(edge_abs)
        except ValueError:
            return -1

    # -- detection ---------------------------------------------------------

    def _place_scores_many(self, idxs) -> Tuple[np.ndarray, float]:
        """Similarity of each query keyframe in `idxs` to every DB row,
        as one device program + ONE host fetch ([Q, K]), plus the score
        floor. Uses the BoW vocabulary scorer when available, the grid
        global descriptor otherwise. Exact w.r.t. per-query scoring:
        row contents are insertion-order independent and candidates
        newer than a query are excluded by the dislocal window anyway."""
        lp = self.cfg.loop
        rows = jnp.asarray(np.asarray(idxs, np.int32))
        if lp.place_recognition == "bow" and self.vocab is not None:
            scores = np.asarray(self._scores_batch(self.bow,
                                                   self.bow[rows]))
            floor = lp.min_similarity_bow
        else:
            scores = np.asarray(self._gdesc_scores_batch(
                self.db.gdesc, self.db.gdesc[rows]))
            floor = lp.min_similarity
        return scores, floor

    def detect(self, cur_idx: int) -> Optional[LoopHit]:
        """Query keyframe cur_idx against all older keyframes."""
        return self.detect_many([cur_idx])[0]

    def detect_many(self, idxs) -> list:
        """Detect loops for several just-inserted keyframes with one
        batched scoring fetch (the per-query host logic — gating,
        islands, temporal consistency — runs sequentially, identical to
        calling detect() per keyframe). Returns a LoopHit-or-None per
        query index."""
        if len(idxs) == 0:
            return []
        scores_all, floor = self._place_scores_many(self._pad_queries(idxs))
        return self.detect_from_scores(idxs, scores_all, floor)

    @staticmethod
    def _pad_queries(idxs) -> list:
        """Pad the query batch to a fixed width so the scoring program
        compiles for at most two shapes (1 and _DETECT_PAD) instead of
        one per distinct batch size (each compile costs seconds)."""
        Q = len(idxs)
        pad = Q if Q <= 1 else _DETECT_PAD * ((Q + _DETECT_PAD - 1)
                                              // _DETECT_PAD)
        return list(idxs) + [idxs[0]] * (pad - Q)

    def dispatch_scores(self, idxs):
        """Async half of detect_many: dispatch the batched scoring
        program and return its DEVICE result (+ floor). The caller
        fetches it later — typically folded into an existing combined
        fetch so steady-state detection costs no extra round trip."""
        lp = self.cfg.loop
        rows = jnp.asarray(np.asarray(self._pad_queries(idxs), np.int32))
        if lp.place_recognition == "bow" and self.vocab is not None:
            return (self._scores_batch(self.bow, self.bow[rows]),
                    lp.min_similarity_bow)
        return (self._gdesc_scores_batch(self.db.gdesc,
                                         self.db.gdesc[rows]),
                lp.min_similarity)

    def detect_from_scores(self, idxs, scores_all, floor) -> list:
        """Host half of detect_many: gate + verify with already-fetched
        scores (rows follow _pad_queries(idxs) order)."""
        pend = self.gate_and_dispatch(idxs, scores_all, floor)
        fetched = jax.device_get(self.pending_verify_handles(pend))
        return self.finish_detect(pend, fetched)

    def gate_and_dispatch(self, idxs, scores_all, floor,
                          slim: bool = False):
        """Phase 1 of detection: sequential host-side gating (island +
        temporal state must be updated in query order; cheap numpy) then
        async dispatch of ONE fused geometric-verification program per
        gated candidate. Returns an opaque pend object whose device
        handles (pending_verify_handles) the caller fetches later —
        the streaming path folds them into the NEXT block's combined
        fetch, because a fetch issued here would block on the in-flight
        next scan (in-order device queue)."""
        import os as _os
        import time as _time
        _dbg = _os.environ.get("VINS_GATE_DEBUG")
        _t0 = _time.perf_counter()
        scores_all = np.asarray(scores_all)
        best_of = [self._gate(int(cur), scores_all[i].copy(), floor)
                   for i, cur in enumerate(idxs)]
        _t1 = _time.perf_counter()
        # Batch every gated candidate into ONE fused verification
        # program (padded to _VERIFY_PAD; per-candidate dispatches each
        # pay their own argument marshaling).
        # HARD CAP at _VERIFY_PAD per block: every pad multiple is a
        # separate compiled program whose first in-process use costs an
        # executable load — a hit-dense block tipping
        # into C=8 was measured at ~350 ms/block amortized. Dropped
        # candidates re-detect within a lap.
        if sum(b is not None for b in best_of) > _VERIFY_PAD:
            scored = sorted(
                (i for i, b in enumerate(best_of) if b is not None),
                key=lambda i: -float(scores_all[i][best_of[i]]))
            for i in scored[_VERIFY_PAD:]:
                best_of[i] = None
        gated = [(int(cur), best) for cur, best in zip(idxs, best_of)
                 if best is not None]
        uid_pairs = [None if best is None
                     else (self.uid_of(int(cur)), self.uid_of(best))
                     for cur, best in zip(idxs, best_of)]
        batch = None
        markers = []
        _t2 = _time.perf_counter()
        if gated:
            batch = self._dispatch_verify_batch(gated, slim=slim)
        if _dbg:
            _t3 = _time.perf_counter()
            print(f"[gate] Q={len(idxs)} gated={len(gated)} "
                  f"np={1e3 * (_t1 - _t0):.1f}ms "
                  f"uid={1e3 * (_t2 - _t1):.1f}ms "
                  f"dispatch={1e3 * (_t3 - _t2):.1f}ms", flush=True)
        j = 0
        for best in best_of:
            markers.append(None if best is None else j)
            j += best is not None
        # Generation stamp + UID pairs: a resample() between this
        # dispatch and finish_detect compacts DB rows; the dispatched
        # verify programs captured the (immutable) pre-compaction device
        # buffers, so their GEOMETRY stays valid, but the row indices
        # recorded into LoopHit/pose-graph edges must be re-resolved —
        # or the pend dropped — at finish time (ADVICE r4 #1).
        return (list(idxs), best_of, (markers, batch, slim),
                self.generation, uid_pairs)

    @staticmethod
    def pending_verify_handles(pend) -> list:
        """Device handles of a gate_and_dispatch result (fetch these):
        the single batched verify result, or [] if nothing was gated."""
        _, batch, _slim = pend[2]
        return [batch] if batch is not None else []

    def finish_detect(self, pend, fetched) -> list:
        """Phase 2: thresholds + LoopHit assembly from the FETCHED
        verify results (host-only). fetched = device_get of
        pending_verify_handles(pend).

        If a resample() fired since gate_and_dispatch, the captured row
        indices are remapped through the keyframe UIDs; entries whose
        endpoints were resampled away are dropped (their verify result
        is still consumed so `fetched` stays aligned)."""
        idxs, best_of, (markers, _batch, slim), gen, uid_pairs = pend
        stale = gen != self.generation
        batch_h = fetched[0] if fetched else None
        out = []
        for cur, best, mk, up in zip(idxs, best_of, markers, uid_pairs):
            if mk is None:
                out.append(None)
                continue
            cur_r, best_r = int(cur), best
            if stale:
                cur_r, best_r = self.row_of(up[0]), self.row_of(up[1])
                if cur_r < 0 or best_r < 0:
                    out.append(None)
                    continue
            if slim:
                out.append(self._finish_verify_slim(cur_r, best_r,
                                                    batch_h[mk]))
            else:
                row = tuple(leaf[mk] for leaf in batch_h)
                out.append(self._finish_verify(cur_r, best_r, row))
        return out

    def _gate(self, cur_idx: int, scores: np.ndarray,
              floor: float) -> Optional[int]:
        lp = self.cfg.loop
        n = self.count
        if cur_idx < 1 or n <= lp.dislocal:
            self.last_match = None
            return None

        # Relative gate vs the previous-keyframe score (demoDetector
        # alpha) with an absolute floor: grid cosine scores are signed
        # and BoW scores of unrelated views are near 0, so a small ns
        # must not make the gate vacuous.
        ns = float(scores[cur_idx - 1]) if cur_idx >= 1 else 1.0
        gate = max(lp.similarity_alpha * ns, floor)
        scores[max(0, cur_idx - lp.dislocal):] = -1.0  # dislocal + self/future
        # Different segments can't loop (failure resets trajectory frame).
        seg = self._segments_np
        scores[seg != seg[cur_idx]] = -1.0

        # Island grouping (TemplatedLoopDetector.h:890+): adjacent
        # above-gate entries form islands scored by their sum; the match
        # is the best entry of the best island.
        cand = np.where(scores[:n] >= gate)[0]
        if len(cand) == 0:
            self.last_match = None
            return None
        splits = np.where(np.diff(cand) > lp.island_gap)[0] + 1
        islands = np.split(cand, splits)
        best_island = max(islands, key=lambda isl: scores[isl].sum())
        best = int(best_island[np.argmax(scores[best_island])])

        # Temporal consistency (k=1): previous query matched nearby —
        # by ENTRY id (previous island overlaps / is adjacent, the
        # reference's test) OR by PLACE (the matched keyframes are
        # spatially close): after distance resampling + multi-lap
        # revisits the same place has aliased DB copies at scattered
        # entry ids, and index proximity alone suppressed most true
        # cross-lap re-matches (r4 soak recall 0.15 → dedup-aware ≥0.5).
        consistent = (self.last_match is not None
                      and (abs(self.last_match - best) <= lp.temporal_radius
                           or np.linalg.norm(self._kf_p_np[self.last_match]
                                             - self._kf_p_np[best])
                           <= lp.temporal_spatial_m))
        self.last_match = best
        if lp.temporal_k > 0 and not consistent:
            return None
        return best

    def _dispatch_verify_batch(self, pairs, slim: bool = False):
        """Async geometric verification + relative pose + hit-data
        gather for every gated (cur, old) pair in ONE fused program
        (padded to _VERIFY_PAD; pad rows repeat the first pair and are
        never read back). Returns DEVICE handles, each leaf [C, ...].
        Explicit dtypes so the runtime avals match the warm()-compiled
        signatures (weak-typed scalars would miss the in-process jit
        cache and re-trace on the first hit)."""
        lp = self.cfg.loop
        C = _VERIFY_PAD * (-(-len(pairs) // _VERIFY_PAD))
        padded = list(pairs) + [pairs[0]] * (C - len(pairs))
        # PRNG keys from the warm()-built pool when possible: the first
        # in-region `jax.random.split` compiles and loads a program; the
        # pool costs zero device ops per
        # dispatch. Pool reuse after _KEY_POOL rounds re-runs RANSAC
        # with the same hypothesis draws on different data — harmless.
        if self._key_pool is not None and C == _VERIFY_PAD:
            keys_c = jnp.asarray(
                self._key_pool[self._key_ctr % len(self._key_pool)])
            self._key_ctr += 1
        else:
            keys = jax.random.split(self.key, C + 1)
            self.key = keys[0]
            keys_c = keys[1:]
        curs = jnp.asarray(np.asarray([p[0] for p in padded], np.int32))
        olds = jnp.asarray(np.asarray([p[1] for p in padded], np.int32))
        fn = _verify_hits_batch_slim if slim else _verify_hits_batch
        return fn(
            self.db, curs, olds, keys_c, self.tic, self.qic,
            max_dist=lp.match_max_dist, ratio=lp.match_ratio,
            hyps=lp.geo_ransac_hyps,
            thresh_sq=self._thresh_sq_dev,
            max_msr=self._max_msr_dev)

    def _finish_verify_slim(self, cur_idx: int, best: int,
                            row: np.ndarray) -> Optional[LoopHit]:
        """Host half for a SLIM verify row ([21] float32, _SLIM_*
        layout): thresholds + LoopHit (without the big gather leaves —
        streaming consumers stage via device-side anchors) + edge."""
        lp = self.cfg.loop
        if int(row[_SLIM_NIN]) < lp.min_loop_matches:
            return None
        if row[_SLIM_GOOD] < 0.5:
            return None
        yaw_rel = float(row[_SLIM_YAW])
        t_rel = np.asarray(row[_SLIM_T])
        if (abs(yaw_rel) > np.deg2rad(lp.yaw_reject_deg)
                or float(np.linalg.norm(t_rel)) > lp.trans_reject_m):
            return None
        hit = LoopHit(
            old_idx=best, cur_idx=cur_idx,
            n_inliers=int(row[_SLIM_NIN]),
            t_rel=t_rel, yaw_rel=yaw_rel,
            p_old=np.asarray(row[_SLIM_P_OLD]),
            q_old=np.asarray(row[_SLIM_Q_OLD]),
            p_cur=np.asarray(row[_SLIM_P_CUR]),
            q_cur=np.asarray(row[_SLIM_Q_CUR]))
        return hit._replace(edge_abs=self._add_loop_edge(hit))

    def _finish_verify(self, cur_idx: int, best: int,
                       fetched) -> Optional[LoopHit]:
        """Host half: thresholds + LoopHit assembly + pose-graph edge."""
        lp = self.cfg.loop
        (n_in, t_rel, yaw_rel, good, msr, p_old, q_old, pts_w_cur,
         obs_old_g, match_ok_g, p_cur, q_cur, tid_cur) = fetched
        if int(n_in) < lp.min_loop_matches:
            return None
        if not bool(good):
            return None
        # Loop sanity rejection (ViewController.mm:836-840).
        if (abs(float(yaw_rel)) > np.deg2rad(lp.yaw_reject_deg)
                or float(np.linalg.norm(t_rel)) > lp.trans_reject_m):
            return None

        hit = LoopHit(
            old_idx=best, cur_idx=cur_idx, n_inliers=int(n_in),
            t_rel=t_rel, yaw_rel=float(yaw_rel),
            pts_w=pts_w_cur, obs_old=obs_old_g, match_ok=match_ok_g,
            p_old=p_old, q_old=q_old, p_cur=p_cur, q_cur=q_cur,
            tids=tid_cur)
        return hit._replace(edge_abs=self._add_loop_edge(hit))

    # -- pose graph --------------------------------------------------------

    # Edge weights: a detection-time PnP edge (against noisy triangulated
    # window points) is TENTATIVE — it enters the graph nearly inert and
    # only the window-solve refinement promotes it to full weight
    # (update_loop_edge). The reference's pose graph consumes ONLY
    # refined edges (VINS.cpp:663-680); unrefined PnP edges at
    # meaningful weight were measured to bend the graph by ~0.5 m on the
    # revisit fixture (their translation error is ~the landmark depth
    # error).
    W_TENTATIVE = 0.02
    W_REFINED = 1.0

    def _add_loop_edge(self, hit: LoopHit) -> int:
        """Record the hit as a (tentative) pose-graph edge; returns the
        edge's ABSOLUTE id (stable across evictions, see edge_index)."""
        e = self.n_loops
        E = self.graph.loop_w.shape[0]
        if e >= E:
            # Edge table full: evict the LOWEST-VALUE edge — tentative
            # (detection-time PnP) edges before refined ones, oldest
            # first among equals. A FIFO roll here was measured to evict
            # the few window-refined edges under the stream of tentative
            # ones (~1 tentative edge per verified hit, every lap).
            v = int(np.argmin(self._loop_w_host))
            self.graph = _evict_edge(self.graph, jnp.asarray(v, jnp.int32))
            self.n_loops = e = E - 1
            self._loop_i_host.pop(v)
            self._loop_w_host.pop(v)
            self._edge_abs_host.pop(v)
            self.n_edges_evicted += 1
        # ONE traced-index program: eager .at[e].set compiles a separate
        # program per distinct edge index, on the streaming critical
        # path.
        self.graph = _set_loop_edge(
            self.graph, jnp.asarray(e, jnp.int32),
            jnp.asarray(hit.old_idx, jnp.int32),
            jnp.asarray(hit.cur_idx, jnp.int32),
            jnp.asarray(hit.t_rel, self.graph.loop_t.dtype),
            jnp.asarray(hit.yaw_rel, self.graph.loop_yaw.dtype),
            jnp.asarray(self.W_TENTATIVE, self.graph.loop_w.dtype))
        self.n_loops += 1
        self._loop_i_host.append(int(hit.old_idx))
        self._loop_w_host.append(self.W_TENTATIVE)
        abs_id = self._next_edge_abs
        self._next_edge_abs += 1
        self._edge_abs_host.append(abs_id)
        return abs_id

    def update_loop_edge(self, e: int, t_rel: np.ndarray, yaw_rel: float,
                         j: int = None):
        """Refine an existing loop edge with the window-solve-derived
        relative pose (reference reads the constraint off the SOLVED
        window, VINS.cpp:663-680, and the pose graph consumes that —
        not the one-shot detection-time PnP). Promotes the edge from
        tentative to full weight.

        j: rewrite the edge's CURRENT endpoint to this keyframe row.
        The refined measurement is read against the solving window's
        newest frame (estimator.py loop_rel readout), which can be many
        keyframes — even a lap — past the detection-time keyframe when
        the constraint attached late; the caller re-points the edge at
        the keyframe nearest the readout (odometry-compensated) so the
        measurement and the endpoint agree."""
        if e < 0 or e >= self.n_loops:
            return
        if e < len(self._loop_w_host):
            self._loop_w_host[e] = self.W_REFINED
        if j is not None:
            self.graph = _set_loop_edge(
                self.graph, jnp.asarray(e, jnp.int32),
                jnp.asarray(self._loop_i_host[e], jnp.int32),
                jnp.asarray(j, jnp.int32),
                jnp.asarray(t_rel, self.graph.loop_t.dtype),
                jnp.asarray(yaw_rel, self.graph.loop_yaw.dtype),
                jnp.asarray(self.W_REFINED, self.graph.loop_w.dtype))
            return
        self.graph = _refine_loop_edge(
            self.graph, jnp.asarray(e, jnp.int32),
            jnp.asarray(t_rel, self.graph.loop_t.dtype),
            jnp.asarray(yaw_rel, self.graph.loop_yaw.dtype),
            jnp.asarray(self.W_REFINED, self.graph.loop_w.dtype))

    def optimize(self, defer_fetch: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Run the 4-DoF pose graph; update db poses and drift.
        Returns (r_drift [3,3], t_drift [3]).

        defer_fetch: skip the blocking host fetch of the drift — the
        device copies update now and the caller folds the host sync into
        its next combined fetch (sync_drift). Published poses then see
        the correction one cycle late, the same latency the block
        pipeline already has."""
        if self.n_loops == 0:
            return self.r_drift, self.t_drift
        self.n_optimizes += 1
        # Earliest loop node from the host mirror (a device min here is
        # a blocking round trip on the streaming path).
        first = (min(self._loop_i_host) if self._loop_i_host
                 else int(jnp.min(self.graph.loop_i[:self.n_loops])))
        g_after, cost = self._opt_graph(self.graph,
                                        jnp.asarray(first, jnp.int32))
        latest = self.count - 1
        R_d, t_d = self._drift_jit(g_after, jnp.asarray(latest, jnp.int32))
        self.graph = g_after
        # Write optimized poses back into the database (module-level jit:
        # an inline vmap here re-traced + re-dispatched eagerly on every
        # pose-graph run).
        q_new = _ypr_to_quat_rows(g_after.yaw, g_after.pitch,
                                  g_after.roll)
        self.db = self.db._replace(p=g_after.t, q=q_new)
        self._r_drift_dev, self._t_drift_dev = R_d, t_d
        if defer_fetch:
            self._drift_dirty = True
        else:
            self.r_drift = np.asarray(R_d)
            self.t_drift = np.asarray(t_d)
            self._drift_dirty = False
        return self.r_drift, self.t_drift

    def sync_drift(self, r_host=None, t_host=None) -> None:
        """Install host copies of the drift (from a caller's combined
        fetch), or fetch eagerly if none are supplied."""
        if not getattr(self, "_drift_dirty", False):
            return
        if r_host is None:
            r_host, t_host = jax.device_get(
                (self._r_drift_dev, self._t_drift_dev))
        self.r_drift = np.asarray(r_host)
        self.t_drift = np.asarray(t_host)
        self._drift_dirty = False

    def global_ba(self, mesh=None, iters: int = 8,
                  max_keyframes: int = 64, max_landmarks: int = 512,
                  defer_fetch: bool = False):
        """Global refinement pass over the REAL map: harvest keyframe
        poses + tracked landmarks from the DB into a BAProblem and run
        the (optionally landmark-sharded, psum-reduced) Schur BA; refined
        poses land back in the published (drift-corrected) pose columns.
        Scale-out role of keyfame_database.cpp:140-356 (SURVEY §2.3/§5.8).

        mesh: a jax Mesh with a `block` axis for the distributed path;
        None solves on one device. Returns the final cost or None if the
        map has no multi-keyframe tracks yet."""
        from ..parallel.dist_ba import solve_ba, solve_ba_sharded
        from ..parallel.harvest import apply_ba_result, harvest_ba_problem

        res = harvest_ba_problem(self.db, self.tic, self.qic,
                                 max_keyframes=max_keyframes,
                                 max_landmarks=max_landmarks)
        if res is None:
            return None
        if mesh is not None:
            bs = mesh.shape.get("block", 1)
            L = res.prob.mask.shape[0]
            Lp = -(-L // bs) * bs
            if Lp != L:
                padL = lambda a: jnp.concatenate(
                    [a, jnp.zeros((Lp - L,) + a.shape[1:], a.dtype)], 0)
                res = res._replace(
                    state=res.state._replace(pts=padL(res.state.pts)),
                    prob=res.prob._replace(obs=padL(res.prob.obs),
                                           mask=padL(res.prob.mask)))
            solved, cost, _ = solve_ba_sharded(res.state, res.prob, mesh,
                                               iters=iters)
        else:
            solved, cost, _ = solve_ba(res.state, res.prob, iters=iters)
        self.db = apply_ba_result(self.db, res, solved, self.tic, self.qic,
                                  r_drift=self._r_drift_dev,
                                  t_drift=self._t_drift_dev)
        # Refined raw poses also feed the pose graph's origin columns so
        # subsequent sequential-edge measurements see the refinement.
        idx = jnp.asarray(res.kf_indices)
        ypr = jax.vmap(lambda q: lie.rotmat_to_ypr(lie.quat_to_rotmat(q)))(
            self.db.q_origin[idx])
        self.graph = self.graph._replace(
            t_origin=self.graph.t_origin.at[idx].set(
                self.db.p_origin[idx]),
            yaw_origin=self.graph.yaw_origin.at[idx].set(ypr[:, 0]))
        # Re-publish through the pose graph: the drift composition above
        # is a single rigid transform (exact only near the latest node);
        # a graph re-run maps every refined ORIGIN pose through its own
        # node's correction, keeping the published map consistent.
        if self.n_loops > 0:
            self.optimize(defer_fetch=defer_fetch)
        if defer_fetch:
            return None
        return float(cost)

    def new_segment(self):
        """Failure recovery: later keyframes are a new trajectory segment
        (ViewController.mm:771-781)."""
        self.segment += 1

    def trajectory(self):
        """Pose-graph-corrected keyframe trajectory for consumers
        (t [K], p [K,3], q [K,4] host arrays) — the artifact an AR/viz
        consumer replays after loop closure (the reference re-publishes
        the whole corrected keyframe path in updateVisualization,
        keyfame_database.cpp:358). One combined fetch of the corrected
        DB columns."""
        n = self.count
        if n == 0:
            z = np.zeros((0, 3), np.float32)
            return (np.zeros(0, np.float64), z,
                    np.zeros((0, 4), np.float32))
        p, q = jax.device_get((self.db.p, self.db.q))
        return self._kf_t_np[:n].copy(), p[:n], q[:n]

    # -- capacity ----------------------------------------------------------

    def resample(self):
        """Distance-based keyframe decimation when the database is full
        (reference KeyFrameDatabase::resample, keyfame_database.cpp:44-76):
        drop keyframes spatially closest to their predecessor, protecting
        loop-edge endpoints and the most recent `dislocal` frames, then
        compact every array and remap loop-edge indices."""
        # The device count is authoritative here (tests and tools may
        # seed rows via _add_row directly); resample is rare, so the
        # fetch is fine, and it re-syncs the host mirror on exit.
        n = int(self.db.count)
        K = self.db.p.shape[0]
        p = np.asarray(self.db.p[:n])

        protected = np.zeros(n, bool)
        protected[max(0, n - self.cfg.loop.dislocal):] = True
        protected[0] = True
        li = np.asarray(self.graph.loop_i[:self.n_loops])
        lj = np.asarray(self.graph.loop_j[:self.n_loops])
        protected[li[li < n]] = True
        protected[lj[lj < n]] = True

        # Greedy spatial decimation: walk the trajectory, keep a frame if
        # it is far enough from the last kept one; raise the distance
        # threshold until at least 1/4 of the slots are free.
        seg_len = np.linalg.norm(np.diff(p, axis=0), axis=1)
        min_dist = max(float(np.median(seg_len)) * 2.0, 1e-3)
        keep = np.ones(n, bool)
        target_free = K // 4
        for _ in range(8):
            keep = protected.copy()
            last = p[0]
            for i in range(1, n):
                if protected[i]:
                    last = p[i]
                    continue
                if np.linalg.norm(p[i] - last) >= min_dist:
                    keep[i] = True
                    last = p[i]
            if (n - keep.sum()) >= target_free:
                break
            min_dist *= 1.6
        if (n - keep.sum()) < 1:
            # Everything protected (pathological); drop oldest unprotected.
            keep = protected.copy()

        old_idx = np.where(keep)[0]
        m = len(old_idx)
        remap = -np.ones(n, np.int64)
        remap[old_idx] = np.arange(m)

        def compact(a):
            a_np = np.asarray(a)
            out = np.zeros_like(a_np)
            out[:m] = a_np[old_idx]
            return jnp.asarray(out)

        self.db = KeyframeDB(
            count=jnp.asarray(m, jnp.int32),
            **{f: compact(getattr(self.db, f))
               for f in KeyframeDB._fields if f != "count"})
        self.bow = compact(self.bow)
        g = self.graph
        self.graph = g._replace(
            t=compact(g.t), yaw=compact(g.yaw), pitch=compact(g.pitch),
            roll=compact(g.roll), node_ok=compact(g.node_ok),
            t_origin=compact(g.t_origin),
            yaw_origin=compact(g.yaw_origin),
            loop_i=jnp.asarray(np.where(
                np.asarray(g.loop_i) < n,
                remap[np.clip(np.asarray(g.loop_i), 0, n - 1)],
                np.asarray(g.loop_i)).astype(np.int32)),
            loop_j=jnp.asarray(np.where(
                np.asarray(g.loop_j) < n,
                remap[np.clip(np.asarray(g.loop_j), 0, n - 1)],
                np.asarray(g.loop_j)).astype(np.int32)))
        if self.last_match is not None:
            nm = remap[self.last_match] if self.last_match < n else -1
            self.last_match = int(nm) if nm >= 0 else None
        self._loop_i_host = [
            int(remap[i]) if i < n and remap[i] >= 0 else int(i)
            for i in self._loop_i_host]
        self.count = m
        seg_old = self._segments_np
        self._segments_np = np.zeros(K, np.int32)
        self._segments_np[:m] = seg_old[old_idx]
        t_old = self._kf_t_np
        self._kf_t_np = np.zeros(K, np.float64)
        self._kf_t_np[:m] = t_old[old_idx]
        uid_old = self._uid_np
        self._uid_np = np.full(K, -1, np.int64)
        self._uid_np[:m] = uid_old[old_idx]
        p_old = self._kf_p_np
        self._kf_p_np = np.zeros((K, 3), np.float32)
        self._kf_p_np[:m] = p_old[old_idx]
        yaw_old = self._kf_yaw_np
        self._kf_yaw_np = np.zeros(K, np.float32)
        self._kf_yaw_np[:m] = yaw_old[old_idx]
        # Invalidate in-flight row-index captures (gate_and_dispatch
        # pends, insert lists): consumers re-resolve via UIDs or drop.
        self.generation += 1
