"""Sliding-window nonlinear least-squares solver: Levenberg-Marquardt with
explicit Schur complement over inverse-depth landmarks.

This is the dense replacement for the reference's Ceres solve
(DENSE_SCHUR + DOGLEG + use_explicit_schur_complement, VINS_ios/
VINS.cpp:639-662): instead of a virtual-dispatch cost-function graph, the
whole problem is assembled as ONE dense whitened Jacobian
  J : [R, D_c + M]   (R = prior + IMU + projection rows)
built by vmapped per-factor linearizations scattered into static row/col
slots, and the normal equations H = JᵀJ come from a single matmul.
The landmark block of H is diagonal by construction (each inverse depth
touches only its own factor rows), so the Schur complement is an
elementwise divide + one more matmul. Iterations are a fixed-count
`lax.scan` with accept/reject masking — the XLA analog of the reference's
wall-clock-bounded trust region (VINS.cpp:646-653).

Whitening/robustness parity: IMU rows whitened by the preintegration
sqrt-information (imu_factor.h:72), projection rows by f/1.5
(VINS.cpp:31) with Cauchy IRLS reweighting (VINS.cpp:485).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import VinsConfig
from ..utils import lie
from . import preintegration as pre_mod
from .factors import (Extrinsics, cauchy_rho, cauchy_weight,
                      imu_factor_local, projection_factor_local,
                      projection_residual)
from .state import FeatureTable, PriorFactor, WindowState, retract_window, \
    state_boxminus


class SolveStats(NamedTuple):
    final_cost: jax.Array      # [] robust total cost after solve
    initial_cost: jax.Array    # [] cost before solve
    visual_cost: jax.Array     # [] sum of squared whitened projection residuals
    visual_factor_num: jax.Array  # [] number of active projection factors
    accepted_iters: jax.Array  # [] LM iterations that reduced cost
    final_lambda: jax.Array    # []


class LoopProblem(NamedTuple):
    """Loop-reprojection block (reference VINS.cpp:571-637): observations
    of current-window landmarks in a retrieved old keyframe, constrained
    through an extra free 6-DoF "loop pose" parameter initialized at the
    window frame carrying the loop. After the solve, the relative pose
    between that window frame and the solved loop pose is the (drift-
    consistent, refined) constraint fed to the 4-DoF pose graph
    (VINS.cpp:663-680)."""

    obs_old: jax.Array   # [M, 2] normalized obs in the old keyframe
    ok: jax.Array        # [M] bool — slot-aligned, id-verified matches
    frame: jax.Array     # [] int32 — window frame carrying the loop
    weight: jax.Array    # [] float — 1.0 active / 0.0 inert


class WindowProblem(NamedTuple):
    """Static-shape factor-graph snapshot for one backend solve."""

    feats: FeatureTable
    preints: pre_mod.Preintegration   # stacked over W edges
    prior: PriorFactor
    ext: Extrinsics
    gravity: jax.Array                # [3]
    sqrt_info_proj: jax.Array         # [] (focal/1.5)
    # Optional per-frame freeze mask [F]: 1.0 = frame free, 0.0 = frozen
    # (used by init fine-tuning and tests; all-ones normally).
    frame_free: jax.Array             # [F]
    # Optional loop-reprojection block; None compiles the loop-free
    # program (zero overhead for the scan/bench paths).
    loop: Optional["LoopProblem"] = None


def _proj_grid_indices(F: int, M: int):
    """Flattened (frame j, slot m) grid index arrays, static."""
    fj = jnp.repeat(jnp.arange(F, dtype=jnp.int32), M)     # [F*M]
    mm = jnp.tile(jnp.arange(M, dtype=jnp.int32), F)       # [F*M]
    return fj, mm


class ProjSelection(NamedTuple):
    """Compacted active projection factors (fixed budget P).

    The F×M grid is mostly empty (~70 tracked features in 256 slots);
    evaluating residual/Jacobian per grid cell scales with M. Instead the
    valid cells are compacted once per solve into P slots — the factor
    count the reference bounds with NUM_OF_F (global_param.hpp:37).
    """

    fj: jax.Array   # [P] observing frame
    mm: jax.Array   # [P] landmark slot
    w: jax.Array    # [P] 1.0 active / 0.0 padding (or overflow-dropped)


def select_proj_factors(prob: WindowProblem, P: int) -> ProjSelection:
    F, M = prob.feats.mask.shape
    P = min(P, F * M)
    fj, mm = _proj_grid_indices(F, M)
    w_valid = _proj_factor_mask(prob, fj, mm)              # [F*M]
    # Longest-tracked landmarks first: on overflow (more valid cells than
    # the budget) the factors of short tracks are dropped, keeping the
    # best-constrained observations. Ties break on flat grid order (stable).
    # top_k with the index tie-break replaces a full argsort (top_k of
    # the first P is cheaper than a sort).
    n = fj.shape[0]
    track_len = jnp.sum(prob.feats.mask, axis=0).astype(w_valid.dtype)  # [M]
    score = (w_valid * (1.0 + track_len[mm]) * (2.0 * n)
             - jnp.arange(n, dtype=w_valid.dtype))
    _, order = jax.lax.top_k(score, P)
    w = w_valid[order]
    return ProjSelection(fj=fj[order], mm=mm[order], w=w)


def select_loop_factors(prob: WindowProblem, P: int) -> ProjSelection:
    """Compact the active loop-reprojection factors (landmark slots with a
    verified old-keyframe match AND a live anchored track) into P slots.
    fj is unused for loop factors (observer = the loop pose); it carries
    the anchor frame for convenience."""
    lp = prob.loop
    M = prob.feats.mask.shape[1]
    P = min(P, M)
    mm = jnp.arange(M, dtype=jnp.int32)
    a = prob.feats.anchor
    valid = (lp.ok & prob.feats.valid & prob.feats.mask[a, mm]
             & (prob.feats.track_id >= 0))
    w_valid = valid.astype(prob.gravity.dtype) * lp.weight
    score = w_valid * (2.0 * M) - jnp.arange(M, dtype=w_valid.dtype)
    _, order = jax.lax.top_k(score, P)
    return ProjSelection(fj=a[order], mm=mm[order], w=w_valid[order])


def _proj_factor_mask(prob: WindowProblem, fj, mm) -> jax.Array:
    feats = prob.feats
    a = feats.anchor[mm]
    return (
        feats.valid[mm]
        & feats.mask[fj, mm]
        & feats.mask[a, mm]
        & (fj != a)
    ).astype(prob.gravity.dtype)


def _residuals_only(state: WindowState, prob: WindowProblem,
                    cfg: VinsConfig, S_imu: jax.Array,
                    sel: ProjSelection, loop_pq=None, sel_loop=None):
    """Cheap robust-cost evaluation (no Jacobians) for LM accept tests.
    S_imu: [W,15,15] precomputed whitening; sel: compacted factors;
    loop_pq: (p, q) of the free loop pose when prob.loop is present."""
    F, M = prob.feats.mask.shape
    dtype = state.p.dtype

    # Prior.
    dx = state_boxminus(state, prob.prior)
    r_prior = (prob.prior.r + prob.prior.J @ dx) * prob.prior.weight
    cost = 0.5 * jnp.sum(r_prior * r_prior)

    # IMU edges.
    def imu_r(e):
        r = pre_mod.evaluate(
            jax.tree.map(lambda x: x[e], prob.preints),
            state.p[e], state.q[e], state.v[e], state.ba[e], state.bg[e],
            state.p[e + 1], state.q[e + 1], state.v[e + 1],
            state.ba[e + 1], state.bg[e + 1], prob.gravity)
        return S_imu[e] @ r

    r_imu = jax.vmap(imu_r)(jnp.arange(F - 1))
    cost += 0.5 * jnp.sum(r_imu * r_imu)

    # Compacted projection factors.
    fj, mm, w_valid = sel.fj, sel.mm, sel.w
    P = fj.shape[0]
    a = prob.feats.anchor[mm]

    def proj_r(k):
        r = projection_residual(
            prob.feats.obs[a[k], mm[k]], prob.feats.obs[fj[k], mm[k]],
            state.p[a[k]], state.q[a[k]], state.p[fj[k]], state.q[fj[k]],
            state.inv_depth[mm[k]], prob.ext)
        return prob.sqrt_info_proj * r

    r_proj = jnp.where(w_valid[:, None] > 0,
                       jax.vmap(proj_r)(jnp.arange(P)), 0.0)
    s = jnp.sum(r_proj * r_proj, axis=-1)
    cost += 0.5 * jnp.sum(cauchy_rho(s, cfg.solver.cauchy_c) * w_valid)

    # Loop-reprojection factors against the free loop pose.
    if prob.loop is not None:
        loop_p, loop_q = loop_pq
        lm, wl = sel_loop.mm, sel_loop.w
        al = prob.feats.anchor[lm]

        def loop_r(k):
            r = projection_residual(
                prob.feats.obs[al[k], lm[k]], prob.loop.obs_old[lm[k]],
                state.p[al[k]], state.q[al[k]], loop_p, loop_q,
                state.inv_depth[lm[k]], prob.ext)
            return prob.sqrt_info_proj * r

        r_loop = jnp.where(wl[:, None] > 0,
                           jax.vmap(loop_r)(jnp.arange(lm.shape[0])), 0.0)
        s_l = jnp.sum(r_loop * r_loop, axis=-1)
        cost += 0.5 * jnp.sum(cauchy_rho(s_l, cfg.solver.cauchy_c) * wl)
    return cost, (r_prior, r_imu, r_proj, w_valid)


def _place_blocks(J_blocks: jax.Array, cols: jax.Array, D: int) -> jax.Array:
    """Scatter-free placement of per-factor Jacobian blocks into dense
    rows: [K, R, C] blocks + [K, C] column indices → [K, R, D] via a
    one-hot contraction (one matmul instead of a scatter)."""
    iota = jnp.arange(D, dtype=cols.dtype)
    onehot = (cols[:, :, None] == iota[None, None, :]).astype(J_blocks.dtype)
    return jnp.einsum("krc,kcD->krD", J_blocks, onehot,
                      precision=jax.lax.Precision.HIGHEST)


def _linearize(state: WindowState, prob: WindowProblem, cfg: VinsConfig,
               S_imu: jax.Array, sel: ProjSelection,
               loop_pq=None, sel_loop=None):
    """Build the dense whitened Jacobian J [R, D_pose+M] and residual r [R]
    by one-hot block placement + concatenation (no scatters). With a loop
    block, 6 extra columns for the free loop pose sit between the frame
    tangents and the landmark columns (D_pose = 15F + 6)."""
    F, M = prob.feats.mask.shape
    dtype = state.p.dtype
    D_c = 15 * F
    D_pose = D_c + (6 if prob.loop is not None else 0)
    D = D_pose + M
    W = F - 1
    K = sel.fj.shape[0]

    # ---- Prior rows -----------------------------------------------------
    dx = state_boxminus(state, prob.prior)
    r_prior = (prob.prior.r + prob.prior.J @ dx) * prob.prior.weight
    J_top = jnp.pad(prob.prior.J * prob.prior.weight,
                    ((0, 0), (0, D - D_c)))

    # ---- IMU rows -------------------------------------------------------
    def imu_one(e):
        return imu_factor_local(
            jax.tree.map(lambda x: x[e], prob.preints), state, e,
            prob.gravity, S=S_imu[e])

    r_imu, J_imu = jax.vmap(imu_one)(jnp.arange(W))      # [W,15], [W,15,30]
    # Freeze masking: columns of frozen frames are zeroed.
    free_i = prob.frame_free[jnp.arange(W)]
    free_j = prob.frame_free[jnp.arange(W) + 1]
    col_scale = jnp.concatenate(
        [jnp.repeat(free_i[:, None], 15, 1), jnp.repeat(free_j[:, None], 15, 1)],
        axis=1)                                          # [W, 30]
    J_imu = J_imu * col_scale[:, None, :]
    cols_imu = (15 * jnp.arange(W, dtype=jnp.int32)[:, None]
                + jnp.arange(30, dtype=jnp.int32)[None, :])
    J_imu_full = _place_blocks(J_imu, cols_imu, D).reshape(15 * W, D)

    # ---- Projection rows ------------------------------------------------
    fj, mm, w_valid = sel.fj, sel.mm, sel.w              # [K]
    a = prob.feats.anchor[mm]

    def proj_one(k):
        return projection_factor_local(
            prob.feats.obs[a[k], mm[k]], prob.feats.obs[fj[k], mm[k]],
            state.p[a[k]], state.q[a[k]], state.p[fj[k]], state.q[fj[k]],
            state.inv_depth[mm[k]], prob.ext, prob.sqrt_info_proj)

    r_proj, J_proj = jax.vmap(proj_one)(jnp.arange(K))   # [K,2], [K,2,13]
    # Mask padded factors FIRST with where (not multiply): their raw
    # residuals/Jacobians can overflow fp32 (inv_depth 0, arbitrary
    # states), and inf·0 = NaN would poison the cost / normal equations.
    ok = w_valid[:, None] > 0
    r_proj = jnp.where(ok, r_proj, 0.0)
    J_proj = jnp.where(ok[:, :, None], J_proj, 0.0)

    # Cauchy IRLS reweighting + validity + freeze masking.
    w_rob = cauchy_weight(r_proj, cfg.solver.cauchy_c)   # [K,1]
    scale = w_rob * w_valid[:, None]
    r_proj_w = r_proj * scale
    J_proj_w = J_proj * scale[:, :, None]
    col_free = jnp.concatenate([
        jnp.repeat(prob.frame_free[a][:, None], 6, 1),
        jnp.repeat(prob.frame_free[fj][:, None], 6, 1),
        jnp.ones((K, 1), dtype)], axis=1)                # [K,13]
    J_proj_w = J_proj_w * col_free[:, None, :]

    cols_p = jnp.concatenate([
        15 * a[:, None] + jnp.arange(6, dtype=jnp.int32)[None, :],
        15 * fj[:, None] + jnp.arange(6, dtype=jnp.int32)[None, :],
        D_pose + mm[:, None]], axis=1)                   # [K,13]
    J_proj_full = _place_blocks(J_proj_w, cols_p, D).reshape(2 * K, D)

    rows = [J_top, J_imu_full, J_proj_full]
    res = [r_prior, r_imu.reshape(-1), r_proj_w.reshape(-1)]

    # Robust cost at linearization point (for LM bookkeeping).
    s = jnp.sum(r_proj * r_proj, axis=-1)
    cost = (0.5 * jnp.sum(r_prior * r_prior)
            + 0.5 * jnp.sum(r_imu * r_imu)
            + 0.5 * jnp.sum(cauchy_rho(s, cfg.solver.cauchy_c) * w_valid))
    vis_cost = jnp.sum(s * w_valid)
    vis_num = jnp.sum(w_valid)

    # ---- Loop-reprojection rows (VINS.cpp:571-637) ------------------------
    if prob.loop is not None:
        loop_p, loop_q = loop_pq
        lm, wl = sel_loop.mm, sel_loop.w                 # [Kl]
        al = prob.feats.anchor[lm]
        Kl = lm.shape[0]

        def loop_one(k):
            return projection_factor_local(
                prob.feats.obs[al[k], lm[k]], prob.loop.obs_old[lm[k]],
                state.p[al[k]], state.q[al[k]], loop_p, loop_q,
                state.inv_depth[lm[k]], prob.ext, prob.sqrt_info_proj)

        r_lp, J_lp = jax.vmap(loop_one)(jnp.arange(Kl))  # [Kl,2], [Kl,2,13]
        okl = wl[:, None] > 0
        r_lp = jnp.where(okl, r_lp, 0.0)
        J_lp = jnp.where(okl[:, :, None], J_lp, 0.0)
        w_rob_l = cauchy_weight(r_lp, cfg.solver.cauchy_c)
        scale_l = w_rob_l * wl[:, None]
        r_lp_w = r_lp * scale_l
        J_lp_w = J_lp * scale_l[:, :, None]
        # Freeze-mask the anchor columns only; the loop pose is always free.
        colf = jnp.concatenate([
            jnp.repeat(prob.frame_free[al][:, None], 6, 1),
            jnp.ones((Kl, 7), dtype)], axis=1)
        J_lp_w = J_lp_w * colf[:, None, :]
        cols_l = jnp.concatenate([
            15 * al[:, None] + jnp.arange(6, dtype=jnp.int32)[None, :],
            D_c + jnp.tile(jnp.arange(6, dtype=jnp.int32)[None, :], (Kl, 1)),
            D_pose + lm[:, None]], axis=1)               # [Kl,13]
        rows.append(_place_blocks(J_lp_w, cols_l, D).reshape(2 * Kl, D))
        res.append(r_lp_w.reshape(-1))
        s_l = jnp.sum(r_lp * r_lp, axis=-1)
        cost += 0.5 * jnp.sum(cauchy_rho(s_l, cfg.solver.cauchy_c) * wl)

    J = jnp.concatenate(rows, axis=0)
    r = jnp.concatenate(res)
    return J, r, cost, vis_cost, vis_num


def _schur_solve(J: jax.Array, r: jax.Array, lam: jax.Array,
                 D_c: int, landmark_active: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Damped normal-equation solve with landmark Schur elimination.

    Mirrors DENSE_SCHUR with explicit Schur complement (VINS.cpp:641-644):
    H_ll is diagonal, so the reduced camera system is
    H_s = H_cc − H_cl · H_ll⁻¹ · H_lc.
    """
    dtype = J.dtype
    H = jnp.matmul(J.T, J, precision=jax.lax.Precision.HIGHEST)
    g = J.T @ r
    H_cc = H[:D_c, :D_c]
    H_cl = H[:D_c, D_c:]
    h_ll = jnp.diagonal(H[D_c:, D_c:])
    g_c, g_l = g[:D_c], g[D_c:]

    # Marquardt scaling-aware damping + absolute floor for gauge freedom
    # and empty landmark slots.
    d_c = jnp.diagonal(H_cc)
    H_cc_d = H_cc + jnp.diag(lam * d_c + 1e-8 + lam)
    h_ll_d = h_ll + lam * h_ll + 1e-8 + lam
    inv_hll = jnp.where(landmark_active > 0, 1.0 / h_ll_d, 0.0)

    H_s = H_cc_d - (H_cl * inv_hll[None, :]) @ H_cl.T
    g_s = g_c - H_cl @ (inv_hll * g_l)

    # Solve via Cholesky; fp32-safe jitter already in damping.
    L = jnp.linalg.cholesky(H_s)
    ok = jnp.all(jnp.isfinite(L))
    dx_c = jax.lax.cond(
        ok,
        lambda: jax.scipy.linalg.cho_solve((L, True), g_s),
        lambda: jnp.linalg.solve(H_s, g_s),
    )
    dx_l = inv_hll * (g_l - H_cl.T @ dx_c)
    return -dx_c, -dx_l


def solve_window(state: WindowState, prob: WindowProblem,
                 cfg: VinsConfig,
                 iter_budget=None) -> Tuple[WindowState, SolveStats]:
    """Run the fixed-iteration LM loop (no loop-closure block).
    Pure function; jit/shard-safe."""
    assert prob.loop is None
    state, _, stats = _solve_window_impl(state, None, prob, cfg,
                                         iter_budget)
    return state, stats


def solve_window_with_loop(state: WindowState, loop_p: jax.Array,
                           loop_q: jax.Array, prob: WindowProblem,
                           cfg: VinsConfig, iter_budget=None):
    """Joint solve of the window AND a free loop pose constrained by
    loop-reprojection factors (VINS.cpp:571-637; the loop pose parameter
    block is initialized by the caller at the loop-carrying window frame's
    pose, VINS.cpp:588-590). Returns (state, (loop_p, loop_q), stats)."""
    assert prob.loop is not None
    return _solve_window_impl(state, (loop_p, loop_q), prob, cfg,
                              iter_budget)


def _solve_window_impl(state: WindowState, loop_pq, prob: WindowProblem,
                       cfg: VinsConfig, iter_budget=None):
    F, M = prob.feats.mask.shape
    D_c = 15 * F
    D_pose = D_c + (6 if prob.loop is not None else 0)
    dtype = state.p.dtype
    sc = cfg.solver

    # Compact the active projection factors once per solve (the feature
    # table is constant during the LM loop).
    sel = select_proj_factors(prob, cfg.solver.max_proj_factors)
    sel_loop = (select_loop_factors(prob, cfg.solver.max_loop_factors)
                if prob.loop is not None else None)
    if loop_pq is None:
        # Dummy carried value so the LM carry has a fixed structure.
        loop_pq = (jnp.zeros(3, dtype), lie.quat_identity(dtype))
    # A landmark column is active if it appears in >=1 valid factor.
    landmark_active = (
        jax.ops.segment_sum(sel.w, sel.mm, num_segments=M) > 0
    ).astype(dtype)
    if sel_loop is not None:
        landmark_active = jnp.maximum(
            landmark_active,
            (jax.ops.segment_sum(sel_loop.w, sel_loop.mm,
                                 num_segments=M) > 0).astype(dtype))

    # Whitening depends only on the preintegrations: compute once, not in
    # every linearize/cost call (10 × 15×15 inverse+Cholesky per call).
    S_imu = jax.vmap(pre_mod.sqrt_information)(prob.preints)

    def retract_all(st, lpq, dx_c, dx_l):
        win = retract_window(st, dx_c[:D_c] * jnp.repeat(prob.frame_free, 15),
                             dx_l)
        if prob.loop is None:
            return win, lpq
        lp, lq = lie.pose_retract(lpq[0], lpq[1], dx_c[D_c:D_c + 6])
        return win, (lp, lq)

    # Early-exit LM as a while_loop — the XLA analog of the reference's
    # convergence+wall-clock budget (VINS.cpp:646-653). Typical solves
    # stop in 3-5 of the max_iters iterations.
    #
    # Speculative linearization: the candidate's cost check and the next
    # iteration's linearization evaluate the same residuals, so each
    # iteration linearizes AT THE CANDIDATE (one factor sweep per
    # iteration instead of two) and carries (J, r, cost). On rejection
    # (rare: LM accepts most steps) the previous linearization is reused
    # from the carry.
    J0, r0, cost0, vis_cost0, vis_num0 = _linearize(state, prob, cfg,
                                                    S_imu, sel,
                                                    loop_pq, sel_loop)

    # Runtime-adjustable iteration budget — the XLA analog of the
    # reference's queue-depth-scaled wall-clock cap (60→40→30 ms,
    # VINS.cpp:646-653): a traced scalar clamps the compiled max.
    budget = (jnp.asarray(sc.max_iters, jnp.int32) if iter_budget is None
              else jnp.minimum(jnp.asarray(iter_budget, jnp.int32),
                               sc.max_iters))

    def cond(carry):
        it, converged = carry[5], carry[6]
        return (it < budget) & jnp.logical_not(converged)

    def lm_iter(carry):
        (st, lpq, lam, cost, accepted, it, _, small_prev, vis_cost,
         vis_num, J, r) = carry
        dx_c, dx_l = _schur_solve(J, r, lam, D_pose, landmark_active)
        dx_l = dx_l * landmark_active
        cand, lpq_c = retract_all(st, lpq, dx_c, dx_l)
        J_c, r_c, new_cost, vis_cost_c, vis_num_c = _linearize(
            cand, prob, cfg, S_imu, sel, lpq_c, sel_loop)
        good = jnp.isfinite(new_cost) & (new_cost < cost)
        # Converged only when the improvement is tiny on TWO consecutive
        # accepted steps AND the trust region is wide (lam at/below its
        # initial value): in a flat valley (e.g. the metric-scale
        # direction during init) heavily damped steps make per-iteration
        # improvement small long before the solve is done — a one-shot
        # exit there was measured to leave a 2.6x scale error on the
        # init-refinement solves.
        small = good & (cost - new_cost <= sc.rel_tol
                        * jnp.maximum(cost, 1.0))
        converged = small & small_prev & (lam <= sc.lambda_init)
        st = jax.tree.map(
            lambda a, b: jnp.where(good, b, a), st, cand)
        lpq = jax.tree.map(
            lambda a, b: jnp.where(good, b, a), lpq, lpq_c)
        J = jnp.where(good, J_c, J)
        r = jnp.where(good, r_c, r)
        cost = jnp.where(good, new_cost, cost)
        vis_cost = jnp.where(good, vis_cost_c, vis_cost)
        vis_num = jnp.where(good, vis_num_c, vis_num)
        lam = jnp.clip(jnp.where(good, lam * sc.lambda_down, lam * sc.lambda_up),
                       sc.lambda_min, sc.lambda_max)
        accepted = accepted + good.astype(jnp.int32)
        return (st, lpq, lam, cost, accepted, it + 1, converged, small,
                vis_cost, vis_num, J, r)

    init = (state, loop_pq, jnp.asarray(sc.lambda_init, dtype), cost0,
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            jnp.asarray(False), jnp.asarray(False),
            vis_cost0, vis_num0, J0, r0)
    (state_f, lpq_f, lam_f, cost_f, acc, _, _, _, vis_cost_f, vis_num_f,
     _, _) = jax.lax.while_loop(cond, lm_iter, init)

    stats = SolveStats(
        final_cost=cost_f, initial_cost=cost0,
        visual_cost=vis_cost_f, visual_factor_num=vis_num_f,
        accepted_iters=acc, final_lambda=lam_f)
    return state_f, lpq_f, stats
