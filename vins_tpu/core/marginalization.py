"""Schur-complement marginalization producing the dense linearized prior.

Dense replacement for the reference's 4-pthread marginalization
machinery (VINS_ios/marginalization_factor.cpp:118-300 and its use in
VINS::solve_ceres, VINS.cpp:690-830): instead of pointer-keyed
`ResidualBlockInfo` lists and a hand-threaded normal-equation build, the
drop sets here are *static by construction* (always frame 0 + its
anchored landmarks on a keyframe slide, or the second-newest pose on a
non-keyframe slide — SURVEY.md §7.1), so everything reduces to a few
dense linear-algebra steps on device:

  1. assemble H, g from the linearized prior + IMU edge 0 + projection
     factors anchored at frame 0 (Cauchy-rescaled, as
     marginalization_factor.cpp:45-76);
  2. eliminate dropped landmarks (diagonal block, elementwise);
  3. eliminate the dropped frame via an eigendecomposition-inverse with
     eigenvalue clamping (marginalization_factor.cpp:270-284);
  4. re-factorize the kept information into (J0, r0) through the
     eigen-sqrt (marginalization_factor.cpp:286-294);
  5. shift frame indexing down by one and zero the new frame's block.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import VinsConfig
from . import preintegration as pre_mod
from .factors import cauchy_weight, imu_factor_local, projection_factor_local
from .solver import WindowProblem
from .state import PriorFactor, WindowState, state_boxminus


def _eig_clamped_pinv(A: jax.Array, eps: float) -> jax.Array:
    """Pseudo-inverse via symmetric eigendecomposition with small
    eigenvalues zeroed (reference marginalization_factor.cpp:270-284)."""
    w, V = jnp.linalg.eigh(0.5 * (A + A.T))
    w_inv = jnp.where(w > eps, 1.0 / jnp.maximum(w, eps), 0.0)
    return (V * w_inv[None, :]) @ V.T


def _info_to_sqrt(H: jax.Array, g: jax.Array, eps: float,
                  method: str = "chol"):
    """(H, g) → (J0, r0) with J0ᵀJ0 ≈ H, J0ᵀ r0 = g.

    method="eigh" is the reference's eigen-sqrt with eigenvalue clamping
    (marginalization_factor.cpp:286-294). method="chol" factorizes
    H + eps·I = L Lᵀ instead: J0 = Lᵀ, r0 = L⁻¹ g. The ridge turns exact
    null directions (gauge) into a √eps-weak pull toward the
    linearization point — numerically equivalent to clamping at this eps
    — while replacing an O(n³) iterative eigensolve with one Cholesky.
    """
    Hs = 0.5 * (H + H.T)
    if method == "eigh":
        w, V = jnp.linalg.eigh(Hs)
        keep = w > eps
        s = jnp.sqrt(jnp.where(keep, w, 1.0))
        s_inv = jnp.where(keep, 1.0 / s, 0.0)
        s = jnp.where(keep, s, 0.0)
        J0 = s[:, None] * V.T
        r0 = (s_inv[:, None] * V.T) @ g
        return J0, r0
    n = Hs.shape[0]
    I = jnp.eye(n, dtype=Hs.dtype)
    # Relative ridge: fp32 round-off on a matrix with entries ~d scales
    # like 1e-7·d, so the ridge must track the diagonal magnitude.
    ridge = eps + 1e-6 * jnp.max(jnp.abs(jnp.diagonal(Hs)))
    L = jnp.linalg.cholesky(Hs + ridge * I)
    ok = jnp.all(jnp.isfinite(L))
    L = jnp.where(ok, L, jnp.linalg.cholesky(Hs + (100.0 * ridge) * I))
    J0 = L.T
    r0 = jax.scipy.linalg.solve_triangular(L, g, lower=True)
    return J0, r0


def marginalize_old(state: WindowState, prob: WindowProblem,
                    cfg: VinsConfig) -> PriorFactor:
    """Marginalize frame 0 and all landmarks anchored there; return the new
    prior in the *shifted* frame indexing (old frame k → new frame k-1; the
    newest slot's block is zero). Mirrors VINS.cpp:690-776."""
    F, M = prob.feats.mask.shape
    D = 15 * F
    dtype = state.p.dtype
    feats = prob.feats

    # --- Assemble H,g over [pose tangent D | landmark M] -----------------
    # One stacked whitened Jacobian, blocks placed scatter-free
    # (solver._place_blocks): H = JᵀJ, g = Jᵀr as matmuls.
    from .solver import _place_blocks

    # Prior factor (replayed at current state).
    dx = state_boxminus(state, prob.prior)
    r_p = (prob.prior.r + prob.prior.J @ dx) * prob.prior.weight
    J_p = jnp.pad(prob.prior.J * prob.prior.weight, ((0, 0), (0, M)))

    # IMU edge 0 (frames 0,1) — dropped with frame 0 (VINS.cpp:717-726).
    r_i, J_i = imu_factor_local(
        jax.tree.map(lambda x: x[0], prob.preints), state, 0, prob.gravity)
    J_i_full = jnp.pad(J_i, ((0, 0), (0, D + M - 30)))

    # Projection factors anchored at frame 0 (VINS.cpp:728-751),
    # compacted into the same fixed factor budget as the solver
    # (top_k with index tie-break, valid-first stable order).
    fj_g = jnp.repeat(jnp.arange(F, dtype=jnp.int32), M)
    mm_g = jnp.tile(jnp.arange(M, dtype=jnp.int32), F)
    anchored0 = (feats.anchor[mm_g] == 0)
    w_grid = (feats.valid[mm_g] & anchored0 & feats.mask[fj_g, mm_g]
              & feats.mask[0, mm_g] & (fj_g != 0))
    K = min(cfg.solver.max_proj_factors, F * M)
    n = fj_g.shape[0]
    score = w_grid.astype(dtype) * (2.0 * n) - jnp.arange(n, dtype=dtype)
    _, order = jax.lax.top_k(score, K)
    fj = fj_g[order]
    mm = mm_g[order]
    w_valid = w_grid[order].astype(dtype)

    def proj_one(k):
        return projection_factor_local(
            feats.obs[0, mm[k]], feats.obs[fj[k], mm[k]],
            state.p[0], state.q[0], state.p[fj[k]], state.q[fj[k]],
            state.inv_depth[mm[k]], prob.ext, prob.sqrt_info_proj)

    r_pr, J_pr = jax.vmap(proj_one)(jnp.arange(K))  # [K,2], [K,2,13]
    # where-mask padded factors (raw values can overflow; inf*0 = NaN).
    okm = w_valid[:, None] > 0
    r_pr = jnp.where(okm, r_pr, 0.0)
    J_pr = jnp.where(okm[:, :, None], J_pr, 0.0)
    w_rob = cauchy_weight(r_pr, cfg.solver.cauchy_c) * w_valid[:, None]
    r_pr = r_pr * w_rob
    J_pr = J_pr * w_rob[:, :, None]
    # Columns: [frame0 pose 0:6 | frame j pose | landmark].
    cols = jnp.concatenate([
        jnp.broadcast_to(jnp.arange(6, dtype=jnp.int32)[None, :], (K, 6)),
        15 * fj[:, None] + jnp.arange(6, dtype=jnp.int32)[None, :],
        D + mm[:, None]], axis=1)  # [K,13]
    J_pr_full = _place_blocks(J_pr, cols, D + M).reshape(2 * K, D + M)

    J_all = jnp.concatenate([J_p, J_i_full, J_pr_full], axis=0)
    r_all = jnp.concatenate([r_p, r_i, r_pr.reshape(-1)])
    pr = jax.lax.Precision.HIGHEST
    H = jnp.matmul(J_all.T, J_all, precision=pr)
    g = J_all.T @ r_all

    # --- Eliminate dropped landmarks (diagonal block) --------------------
    lm_dropped = (feats.valid & (feats.anchor == 0)).astype(dtype)  # [M]
    h_ll = jnp.diagonal(H[D:, D:])
    inv_hll = jnp.where((lm_dropped > 0) & (h_ll > 1e-10), 1.0 / h_ll, 0.0)
    H_dl = H[:D, D:]                                  # pose × landmark
    H_pose = H[:D, :D] - (H_dl * inv_hll[None, :]) @ H_dl.T
    g_pose = g[:D] - H_dl @ (inv_hll * g[D:])

    # --- Eliminate frame 0 (15×15 block) ---------------------------------
    # Eigen-clamped pseudo-inverse, NOT a ridge Cholesky: the dropped
    # block is rank-deficient in gauge directions, which the clamp must
    # remove (a ridge would invert them with 1/eps weight and poison the
    # prior — measured as a 3x ATE regression).
    Amm_inv = _eig_clamped_pinv(H_pose[:15, :15], cfg.solver.eig_eps)
    Arm = H_pose[15:, :15]
    H_keep = H_pose[15:, 15:] - Arm @ Amm_inv @ Arm.T
    g_keep = g_pose[15:] - Arm @ Amm_inv @ g_pose[:15]

    # --- Re-factorize to (J0, r0), shift indexing ------------------------
    J0s, r0s = _info_to_sqrt(H_keep, g_keep, cfg.solver.eig_eps,
                             cfg.solver.marg_sqrt)  # [D-15,...]
    J0 = jnp.zeros((D, D), dtype).at[:D - 15, :D - 15].set(J0s)
    r0 = jnp.zeros((D,), dtype).at[:D - 15].set(r0s)

    shift = lambda x: jnp.concatenate([x[1:], x[-1:]], axis=0)
    return PriorFactor(
        J=J0, r=r0,
        lin_p=shift(state.p), lin_q=shift(state.q), lin_v=shift(state.v),
        lin_ba=shift(state.ba), lin_bg=shift(state.bg),
        weight=jnp.ones((), dtype))


def marginalize_second_new(state: WindowState, prior: PriorFactor,
                           cfg: VinsConfig) -> PriorFactor:
    """Marginalize only the second-newest *pose* (6 dims) out of the prior
    (reference VINS.cpp:778-830: drop set = para_Pose[WINDOW_SIZE-1], prior
    factor only). The speed/bias block of that slot is retained — after the
    slide it refers to the merged newest frame, exactly as the reference's
    address-keyed bookkeeping does.

    Returned in the *shifted-at-the-top* indexing used by slide-new: frames
    0..F-3 unchanged, slot F-2 takes what the prior knew about the newest
    frame. Since the prior never constrains the newest frame (its block is
    always zero by construction), this is a pure drop of slot F-2's pose.
    """
    F = prior.lin_p.shape[0]
    D = 15 * F
    dtype = prior.J.dtype

    H = prior.J.T @ prior.J * prior.weight
    dx = state_boxminus(state, prior)
    r_now = prior.r + prior.J @ dx
    g = prior.J.T @ r_now * prior.weight

    # Reorder so the 6 dropped dims (pose of frame F-2) come first.
    drop = 15 * (F - 2) + jnp.arange(6)
    keep = jnp.array([i for i in range(D)
                      if not (15 * (F - 2) <= i < 15 * (F - 2) + 6)],
                     dtype=jnp.int32)
    Amm = H[drop[:, None], drop[None, :]]
    Arm = H[keep[:, None], drop[None, :]]
    Arr = H[keep[:, None], keep[None, :]]
    Amm_inv = _eig_clamped_pinv(Amm, cfg.solver.eig_eps)
    H_keep = Arr - Arm @ Amm_inv @ Arm.T
    g_keep = g[keep] - Arm @ Amm_inv @ g[drop]

    J0k, r0k = _info_to_sqrt(H_keep, g_keep, cfg.solver.eig_eps,
                             cfg.solver.marg_sqrt)
    # Scatter back: kept dims stay at their positions; dropped pose dims
    # become zero rows/cols.
    J0 = jnp.zeros((D, D), dtype)
    J0 = J0.at[keep[:, None], keep[None, :]].set(J0k)
    r0 = jnp.zeros((D,), dtype).at[keep].set(r0k)

    # New linearization point = the *current* state (the reference stores
    # keep_block_data at marginalization time), with slot F-2 taking the
    # newest frame's values to match the post-slide aliasing.
    def swap_last(x):
        return x.at[F - 2].set(x[F - 1])

    return PriorFactor(
        J=J0, r=r0,
        lin_p=swap_last(state.p), lin_q=swap_last(state.q),
        lin_v=swap_last(state.v), lin_ba=swap_last(state.ba),
        lin_bg=swap_last(state.bg),
        weight=prior.weight)


# ---------------------------------------------------------------------------
# Sliding-window shifts (reference VINS::slideWindow{,New,Old},
# VINS.cpp:1149-1233)
# ---------------------------------------------------------------------------


def slide_state_old(state: WindowState) -> WindowState:
    """Shift all frames down by one; the newest slot duplicates the last
    frame (it is overwritten by the incoming frame)."""
    shift = lambda x: jnp.concatenate([x[1:], x[-1:]], axis=0)
    return WindowState(
        p=shift(state.p), q=shift(state.q), v=shift(state.v),
        ba=shift(state.ba), bg=shift(state.bg),
        inv_depth=state.inv_depth)


def slide_state_new(state: WindowState) -> WindowState:
    """Drop the second-newest frame: slot F-2 ← slot F-1."""
    def sw(x):
        return x.at[-2].set(x[-1])
    return WindowState(
        p=sw(state.p), q=sw(state.q), v=sw(state.v),
        ba=sw(state.ba), bg=sw(state.bg), inv_depth=state.inv_depth)


def merge_chunks(a: pre_mod.ImuChunk, b: pre_mod.ImuChunk) -> pre_mod.ImuChunk:
    """Concatenate two sample chunks (reference slideWindowNew's
    preintegration merge, VINS.cpp:1269-1293) into the same fixed-size
    buffer. Valid rows (dt>0) of `b` are appended after the valid rows of
    `a`; `b`'s seed row is dropped (its boundary sample ≈ a's last). If the
    union overflows the buffer, adjacent samples of the result are pairwise
    averaged (dt summed) to fit — a bounded-error compaction.
    """
    N = a.dt.shape[0]
    a_n = jnp.sum(a.dt > 0) + 1  # seed row + valid rows
    # Positions for b's rows 1.. (skip seed): a_n + k.
    idx_b = a_n + jnp.arange(N - 1)
    b_valid = (b.dt[1:] > 0)
    total = a_n + jnp.sum(b_valid)

    def write(dst, src_rows, idx, valid):
        idx_c = jnp.where(valid & (idx < N), idx, N)  # OOB rows dropped
        return dst.at[idx_c].add(src_rows * valid.astype(src_rows.dtype).reshape(
            (-1,) + (1,) * (src_rows.ndim - 1)), mode="drop")

    overflow = total > N

    def no_compact():
        dt = write(a.dt, b.dt[1:], idx_b, b_valid)
        acc = write(a.acc, b.acc[1:], idx_b, b_valid)
        gyr = write(a.gyr, b.gyr[1:], idx_b, b_valid)
        return pre_mod.ImuChunk(dt, acc, gyr)

    def compact():
        # Pairwise-average a's rows first (dt summed, dt-weighted mean of
        # the measurements), halving its row count, then append b.
        dt_a = a.dt[1:]
        acc_a = a.acc[1:]
        gyr_a = a.gyr[1:]
        h = (N - 1) // 2
        dt_m = dt_a[0:2 * h:2] + dt_a[1:2 * h:2]
        w0 = jnp.where(dt_m > 0, dt_a[0:2 * h:2] / jnp.maximum(dt_m, 1e-12), 0.5)
        w1 = 1.0 - w0
        acc_m = acc_a[0:2 * h:2] * w0[:, None] + acc_a[1:2 * h:2] * w1[:, None]
        gyr_m = gyr_a[0:2 * h:2] * w0[:, None] + gyr_a[1:2 * h:2] * w1[:, None]
        a2 = pre_mod.ImuChunk(
            dt=jnp.zeros_like(a.dt).at[1:1 + h].set(dt_m),
            acc=jnp.zeros_like(a.acc).at[0].set(a.acc[0]).at[1:1 + h].set(acc_m),
            gyr=jnp.zeros_like(a.gyr).at[0].set(a.gyr[0]).at[1:1 + h].set(gyr_m),
        )
        a2_n = jnp.sum(a2.dt > 0) + 1
        idx2 = a2_n + jnp.arange(N - 1)
        dt = write(a2.dt, b.dt[1:], idx2, b_valid)
        acc = write(a2.acc, b.acc[1:], idx2, b_valid)
        gyr = write(a2.gyr, b.gyr[1:], idx2, b_valid)
        return pre_mod.ImuChunk(dt, acc, gyr)

    return jax.tree.map(
        lambda x, y: jnp.where(overflow, y, x), no_compact(), compact())
