"""Motion-only high-rate estimator: the vinsPnP equivalent.

Re-design of the reference's 30 Hz front-end solver
(VINS_ios/vins_pnp.{hpp,cpp}): a PNP_SIZE+1 = 7-frame sliding window
(global_param.hpp:29) over IMU preintegration factors and fixed-landmark
perspective factors (perspective_factor.cpp:16-67), anchored to the most
recent backend solution by freezing overlapping frames (the reference's
`find_solved` + SetParameterBlockConstant, vins_pnp.cpp:63-83,288-293).
Landmark depths come from the backend's solved features
(`updateFeatures`, vins_pnp.cpp:85) and are held constant, so the
problem has NO landmark columns: a dense 7·15-parameter LM solve
(≤5 iterations, matching vins_pnp.cpp:329-331) of small dense matmuls —
this is what gives the full-camera-rate AR pose between
10 Hz backend solves.

Everything is fixed-shape and jittable; one `pnp_step` per camera frame.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import VinsConfig
from ..utils import lie
from . import preintegration as pre_mod
from .factors import Extrinsics, perspective_residual


class PnpState(NamedTuple):
    """Motion-only window state over S = pnp_size+1 frames."""

    p: jax.Array    # [S, 3]
    q: jax.Array    # [S, 4]
    v: jax.Array    # [S, 3]
    ba: jax.Array   # [S, 3]
    bg: jax.Array   # [S, 3]

    @staticmethod
    def identity(S: int, dtype=jnp.float32) -> "PnpState":
        return PnpState(
            p=jnp.zeros((S, 3), dtype),
            q=jnp.tile(lie.quat_identity(dtype), (S, 1)),
            v=jnp.zeros((S, 3), dtype),
            ba=jnp.zeros((S, 3), dtype),
            bg=jnp.zeros((S, 3), dtype))


class PnpFeatures(NamedTuple):
    """Fixed 3D landmarks + their per-frame observations.

    The backend publishes world points for solved features
    (reference solved_features feedback, ViewController.mm:733-757);
    the motion-only solver treats them as constants.
    """

    pts_w: jax.Array    # [Mp, 3] world landmarks (constant)
    obs: jax.Array      # [S, Mp, 2] normalized observations
    mask: jax.Array     # [S, Mp] bool
    weight: jax.Array   # [Mp] per-track weight (track_num/10, capped 1)

    @staticmethod
    def empty(S: int, Mp: int, dtype=jnp.float32) -> "PnpFeatures":
        return PnpFeatures(
            pts_w=jnp.zeros((Mp, 3), dtype),
            obs=jnp.zeros((S, Mp, 2), dtype),
            mask=jnp.zeros((S, Mp), bool),
            weight=jnp.zeros((Mp,), dtype))


class PnpWindow(NamedTuple):
    """Full motion-only tracker state carried frame to frame."""

    state: PnpState
    feats: PnpFeatures
    chunks: pre_mod.ImuChunk   # [S-1, N] raw IMU per edge
    anchored: jax.Array        # [S] bool — frame matches a backend solve
    # Per-edge preintegrations, propagated ONCE when an edge enters the
    # window (the reference likewise preintegrates each edge once,
    # vins_pnp.cpp:203-242; bias drift is handled to first order by the
    # propagated Jacobian in the residual). None = legacy construction:
    # the solver then repropagates all edges from `chunks` each call.
    preints: Optional[pre_mod.Preintegration] = None


def _perspective_local(pt_w, obs, p, q, ext: Extrinsics, sqrt_info):
    """(r [2], J [2,6]) of one fixed-landmark factor wrt the pose tangent."""

    def local(d):
        pp, qq = lie.pose_retract(p, q, d)
        return sqrt_info * perspective_residual(pt_w, obs, pp, qq, ext)

    zero = jnp.zeros(6, p.dtype)
    return local(zero), jax.jacfwd(local)(zero)


def _imu_local(pre, st: PnpState, e, gravity, S_info):
    """(r [15], J [15,30]) of IMU edge e wrt both frames' tangents."""

    def local(delta):
        di, dj = delta[:15], delta[15:]
        pi, qi = lie.pose_retract(st.p[e], st.q[e], di[0:6])
        pj, qj = lie.pose_retract(st.p[e + 1], st.q[e + 1], dj[0:6])
        r = pre_mod.evaluate(
            pre, pi, qi, st.v[e] + di[6:9], st.ba[e] + di[9:12],
            st.bg[e] + di[12:15], pj, qj, st.v[e + 1] + dj[6:9],
            st.ba[e + 1] + dj[9:12], st.bg[e + 1] + dj[12:15], gravity)
        return S_info @ r

    zero = jnp.zeros(30, st.p.dtype)
    return local(zero), jax.jacfwd(local)(zero)


def window_preints(win: PnpWindow, cfg: VinsConfig) -> pre_mod.Preintegration:
    """Propagate every edge's preintegration at the window's current bias
    estimates (legacy/bootstrap path; the streaming path carries them)."""
    W = win.state.p.shape[0] - 1
    return jax.vmap(
        lambda c, ba, bg: pre_mod.propagate(c, ba, bg, cfg.imu)
    )(win.chunks, win.state.ba[:W], win.state.bg[:W])


def solve_pnp_window(win: PnpWindow, cfg: VinsConfig, ext: Extrinsics,
                     gravity: jax.Array, iters: Optional[int] = None
                     ) -> Tuple[PnpState, jax.Array]:
    """Fixed-iteration LM over the motion-only window. Anchored frames are
    frozen (columns zeroed + identity damping), mirroring the reference's
    constant parameter blocks.

    Cost structure (this runs at full camera rate — the 30 Hz path):
    the S×Mp observation grid is ~80% padding, so active factors are
    compacted into `pnp_max_factors` slots before linearization, and
    factors on FROZEN frames are dropped entirely (the landmark is fixed
    and the pose column is zeroed — they contribute only a constant to
    the cost, which cancels in the LM accept test). The accept test
    itself evaluates residuals only (no Jacobians)."""
    st0 = win.state
    S, Mp = win.feats.mask.shape
    W = S - 1
    D = 15 * S
    dtype = st0.p.dtype
    focal_info = jnp.asarray(cfg.camera.focal / 1.5, dtype)
    if iters is None:
        iters = cfg.solver.pnp_iters

    free = (~win.anchored).astype(dtype)                     # [S]

    preints = win.preints if win.preints is not None \
        else window_preints(win, cfg)
    S_all = jax.vmap(pre_mod.sqrt_information)(preints)

    # Compact active factors: live observation, weighted landmark, free
    # frame. Grid is laid out NEWEST frame first so that on overflow the
    # dropped factors are the oldest frames' (the newest pose is the
    # output — its observations must never be dropped).
    fgrid = jnp.repeat(jnp.arange(S - 1, -1, -1, dtype=jnp.int32), Mp)
    mgrid = jnp.tile(jnp.arange(Mp, dtype=jnp.int32), S)
    n = S * Mp
    P = min(cfg.solver.pnp_max_factors, n)
    w_act = (win.feats.mask[fgrid, mgrid]
             & (win.feats.weight[mgrid] > 0)
             & (free[fgrid] > 0)).astype(dtype)
    score = w_act * (2.0 * n) - jnp.arange(n, dtype=dtype)
    _, order = jax.lax.top_k(score, P)
    selF, selM, selW = fgrid[order], mgrid[order], w_act[order]
    sel_si = focal_info * jnp.minimum(win.feats.weight[selM], 1.0)

    def imu_rows(st: PnpState):
        return jax.vmap(
            lambda e: _imu_local(jax.tree.map(lambda x: x[e], preints),
                                 st, e, gravity, S_all[e]))(jnp.arange(W))

    # Scatter-free dense assembly: factor row blocks are CONSECUTIVE
    # (reshape, no row scatter) and column placement is a contraction
    # with trace-time one-hot tensors (einsums instead of scatters).
    T_imu = np.zeros((W, 30, D), np.float32)
    for e in range(W):
        T_imu[e, :, 15 * e:15 * e + 30] = np.eye(30)
    T_imu = jnp.asarray(T_imu, dtype)
    T_per = np.zeros((S, 6, D), np.float32)
    for s in range(S):
        T_per[s, :, 15 * s:15 * s + 6] = np.eye(6)
    T_per_sel = jnp.asarray(T_per, dtype)[selF]              # [P,6,D]

    def build(st: PnpState):
        # IMU rows.
        r_imu, J_imu = imu_rows(st)
        col_scale = jnp.concatenate([
            jnp.repeat(free[:W, None], 15, 1),
            jnp.repeat(free[1:, None], 15, 1)], axis=1)      # [W,30]
        J_imu = J_imu * col_scale[:, None, :]

        def one(k):
            return _perspective_local(
                win.feats.pts_w[selM[k]], win.feats.obs[selF[k], selM[k]],
                st.p[selF[k]], st.q[selF[k]], ext, sel_si[k])

        r_per, J_per = jax.vmap(one)(jnp.arange(P))          # [P,2],[P,2,6]
        ok = selW[:, None] > 0
        r_per = jnp.where(ok, r_per, 0.0)
        J_per = jnp.where(ok[:, :, None], J_per, 0.0)

        J = jnp.concatenate([
            jnp.einsum('eic,ecd->eid', J_imu, T_imu).reshape(15 * W, D),
            jnp.einsum('pij,pjd->pid', J_per, T_per_sel).reshape(2 * P, D),
        ], axis=0)
        r = jnp.concatenate([r_imu.reshape(-1), r_per.reshape(-1)])
        return J, r

    def retract(st: PnpState, dx):
        d = dx.reshape(S, 15) * free[:, None]
        p, q = lie.pose_retract(st.p, st.q, d[:, 0:6])
        return PnpState(p=p, q=q, v=st.v + d[:, 6:9],
                        ba=st.ba + d[:, 9:12], bg=st.bg + d[:, 12:15])

    # Speculative linearization (same trick as the window solver): the
    # candidate's accept test and the next iteration's linearization
    # evaluate the same factors, so each iteration linearizes AT THE
    # CANDIDATE and carries (J, r) — one factor sweep per iteration.
    def lm_iter(carry, _):
        st, lam, cost, J, r = carry
        H = J.T @ J
        g = J.T @ r
        H = H + jnp.diag(lam * jnp.diagonal(H) + 1e-6 + lam)
        L = jnp.linalg.cholesky(H)
        dx = -jax.scipy.linalg.cho_solve((L, True), g)
        cand = retract(st, dx)
        J_c, r_c = build(cand)
        c2 = 0.5 * jnp.sum(r_c * r_c)
        good = jnp.isfinite(c2) & (c2 < cost)
        st = jax.tree.map(lambda a, b: jnp.where(good, b, a), st, cand)
        J = jnp.where(good, J_c, J)
        r = jnp.where(good, r_c, r)
        cost = jnp.where(good, c2, cost)
        lam = jnp.clip(jnp.where(good, lam * 0.3, lam * 10.0), 1e-9, 1e3)
        return (st, lam, cost, J, r), None

    J0, r0 = build(st0)
    cost0 = 0.5 * jnp.sum(r0 * r0)
    (st, _, cost, _, _), _ = jax.lax.scan(
        lm_iter, (st0, jnp.asarray(1e-4, dtype), cost0, J0, r0), None,
        length=iters)
    return st, cost


def pnp_step(win: PnpWindow, chunk: pre_mod.ImuChunk,
             obs: jax.Array, obs_mask: jax.Array,
             cfg: VinsConfig, ext: Extrinsics, gravity: jax.Array,
             do_solve=True, update_preints: bool = True
             ) -> Tuple[PnpWindow, Tuple[jax.Array, jax.Array, jax.Array]]:
    """One camera frame at full rate: slide, ingest, dead-reckon, solve.

    obs/obs_mask: [Mp] observations of the CURRENT backend landmark set
    (same slot order as win.feats.pts_w).
    do_solve: bool or traced scalar — when False the LM solve is skipped
    and the dead-reckoned state is returned (the streaming scan skips the
    solve on backend frames, whose published pose is the backend's and
    whose pnp window is immediately re-anchored).
    update_preints: static — when False (the scan's deadreckon policy,
    where no solve will ever read them), the per-edge preintegration
    propagate (15x15 covariance chain — measured as the bulk of the
    1.6 ms/frame advance cost) is SKIPPED and the carried preints go
    stale; the pipeline rebuilds them (window_preints) before the next
    interactive solve.
    Returns (window, (p, q, v)) — the 30 Hz pose output.
    """
    S = win.state.p.shape[0]
    W = S - 1

    # Slide every per-frame buffer left by one (oldest drops).
    def sl(x):
        return jnp.concatenate([x[1:], x[-1:]], axis=0)

    st = PnpState(*[sl(x) for x in win.state])
    feats = win.feats._replace(
        obs=jnp.concatenate([win.feats.obs[1:], obs[None]], 0),
        mask=jnp.concatenate([win.feats.mask[1:], obs_mask[None]], 0))
    chunks = jax.tree.map(
        lambda c, new: jnp.concatenate([c[1:], new[None]], 0),
        win.chunks, chunk)
    anchored = jnp.concatenate(
        [win.anchored[1:], jnp.zeros((1,), bool)], 0)

    # Dead-reckon the newest frame from the previous one.
    p_n, q_n, v_n = pre_mod.propagate_state(
        st.p[W - 1], st.q[W - 1], st.v[W - 1], st.ba[W - 1], st.bg[W - 1],
        chunk, gravity)
    st = st._replace(
        p=st.p.at[W].set(p_n), q=st.q.at[W].set(q_n), v=st.v.at[W].set(v_n),
        ba=st.ba.at[W].set(st.ba[W - 1]), bg=st.bg.at[W].set(st.bg[W - 1]))

    # Slide the carried preintegrations and propagate ONLY the new edge
    # (vins_pnp.cpp:203-242: one IntegrationBase per edge, integrated
    # once; bias drift handled first-order inside the residual).
    if not update_preints:
        # Stale placeholder keeps the pytree shape; consumers must
        # rebuild (window_preints) before solving.
        preints = jax.tree.map(
            lambda all_: jnp.concatenate([all_[1:], all_[-1:]], 0),
            win.preints)
    elif win.preints is not None:
        pre_new = pre_mod.propagate(chunk, st.ba[W - 1], st.bg[W - 1],
                                    cfg.imu)
        preints = jax.tree.map(
            lambda all_, new: jnp.concatenate([all_[1:], new[None]], 0),
            win.preints, pre_new)
    else:
        tmp = PnpWindow(state=st, feats=feats, chunks=chunks,
                        anchored=anchored)
        preints = window_preints(tmp, cfg)

    win2 = PnpWindow(state=st, feats=feats, chunks=chunks,
                     anchored=anchored, preints=preints)
    if isinstance(do_solve, bool):
        solved = (solve_pnp_window(win2, cfg, ext, gravity)[0]
                  if do_solve else win2.state)
    else:
        solved = jax.lax.cond(
            do_solve,
            lambda w: solve_pnp_window(w, cfg, ext, gravity)[0],
            lambda w: w.state, win2)
    win2 = win2._replace(state=solved)
    return win2, (solved.p[W], solved.q[W], solved.v[W])


def anchor_from_backend(win: PnpWindow, frame_idx: jax.Array,
                        p: jax.Array, q: jax.Array, v: jax.Array,
                        ba: jax.Array, bg: jax.Array) -> PnpWindow:
    """Inject the latest backend solution at window slot `frame_idx` and
    freeze it (reference setInit/find_solved, vins_pnp.cpp:63-83). Biases
    update every frame in the window (reference updates Bas/Bgs wholesale).
    """
    st = win.state
    S = st.p.shape[0]
    st = st._replace(
        p=st.p.at[frame_idx].set(p),
        q=st.q.at[frame_idx].set(q),
        v=st.v.at[frame_idx].set(v),
        ba=jnp.tile(ba[None], (S, 1)),
        bg=jnp.tile(bg[None], (S, 1)))
    return win._replace(state=st,
                        anchored=win.anchored.at[frame_idx].set(True))


def update_features(win: PnpWindow, pts_w: jax.Array, valid: jax.Array,
                    track_len: jax.Array) -> PnpWindow:
    """Refresh the fixed landmark set from the backend's solved features
    (reference updateFeatures, vins_pnp.cpp:85). Slots align with the
    backend's feature table; observations must be re-associated by the
    caller if slot order changed."""
    w = jnp.where(valid, jnp.minimum(track_len.astype(pts_w.dtype) / 10.0,
                                     1.0), 0.0)
    feats = win.feats._replace(pts_w=pts_w, weight=w)
    return win._replace(feats=feats)
