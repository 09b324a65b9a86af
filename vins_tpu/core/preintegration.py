"""IMU preintegration as a `lax.scan` over fixed-size masked sample buffers.

Fixed-shape re-design of the reference's `IntegrationBase`
(VINS_ios/integration_base.h:17-223): midpoint integration of the
relative-motion deltas (Δp, Δq, Δv) between consecutive window frames,
with propagation of the 15×15 bias Jacobian and 15×15 covariance under an
18-dim noise model (VINS_ios/integration_base.h:63-139), and the
bias-corrected 15-dim residual (VINS_ios/integration_base.h:171-198).

Key transformation vs the reference: raw samples live in a *fixed-length*
padded buffer per window edge (`ImuChunk`), so propagation is a single
jitted scan and "repropagate on bias change"
(VINS_ios/integration_base.h:47-61) is just re-running the same scan with
a new linearization point — no mutation, no dynamic containers. Padding
rows have dt=0, which makes them exact no-ops in midpoint integration, so
no masks appear in the math.

Error-state ordering (matches the reference's O_P/O_R/O_V/O_BA/O_BG):
    [δp 0:3 | δθ 3:6 | δv 6:9 | δba 9:12 | δbg 12:15]
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import ImuConfig
from ..utils import lie

# Error-state block offsets.
O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


class ImuChunk(NamedTuple):
    """Raw IMU samples between two frames, fixed length, dt=0 padded.

    Row 0 is the sample at the previous frame time (the reference's
    acc_0/gyr_0 seed) and must have dt=0; rows 1..k carry the integration
    steps; rows k+1.. are padding with dt=0.
    """

    dt: jax.Array    # [N]
    acc: jax.Array   # [N, 3]
    gyr: jax.Array   # [N, 3]

    @staticmethod
    def empty(max_samples: int, dtype=jnp.float32) -> "ImuChunk":
        return ImuChunk(
            dt=jnp.zeros((max_samples,), dtype),
            acc=jnp.zeros((max_samples, 3), dtype),
            gyr=jnp.zeros((max_samples, 3), dtype),
        )


class Preintegration(NamedTuple):
    """Propagated relative-motion deltas + Jacobian/covariance."""

    dp: jax.Array             # [3]
    dq: jax.Array             # [4] wxyz
    dv: jax.Array             # [3]
    jacobian: jax.Array       # [15, 15] d(delta)/d(bias at linearization)
    covariance: jax.Array     # [15, 15]
    sum_dt: jax.Array         # []
    linearized_ba: jax.Array  # [3]
    linearized_bg: jax.Array  # [3]


def noise_covariance(imu: ImuConfig, dtype=jnp.float32) -> jax.Array:
    """18×18 diagonal noise: [na0, ng0, na1, ng1, nba, nbg] ⊗ I₃.

    Reference: VINS_ios/integration_base.h:28-37.
    """
    diag = jnp.concatenate([
        jnp.full((3,), imu.acc_n ** 2, dtype),
        jnp.full((3,), imu.gyr_n ** 2, dtype),
        jnp.full((3,), imu.acc_n ** 2, dtype),
        jnp.full((3,), imu.gyr_n ** 2, dtype),
        jnp.full((3,), imu.acc_w ** 2, dtype),
        jnp.full((3,), imu.gyr_w ** 2, dtype),
    ])
    return jnp.diag(diag)


def _midpoint_step(carry, sample, noise_cov):
    """One midpoint integration step (reference integration_base.h:63-139)."""
    dp, dq, dv, J, P, sum_dt, ba, bg, acc0, gyr0 = carry
    dt, acc1, gyr1 = sample
    dt2 = dt * dt

    un_acc_0 = lie.quat_rotate(dq, acc0 - ba)
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    dq_new = lie.quat_normalize(lie.quat_mul(dq, lie.delta_q(un_gyr * dt)))
    un_acc_1 = lie.quat_rotate(dq_new, acc1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    dp_new = dp + dv * dt + 0.5 * un_acc * dt2
    dv_new = dv + un_acc * dt

    # Error-state transition F (15×15) and noise map V (15×18).
    R_w_x = lie.skew(un_gyr)
    R_a_0_x = lie.skew(acc0 - ba)
    R_a_1_x = lie.skew(acc1 - ba)
    R0 = lie.quat_to_rotmat(dq)
    R1 = lie.quat_to_rotmat(dq_new)
    I3 = jnp.eye(3, dtype=dp.dtype)

    Rw = I3 - R_w_x * dt  # first-order exp(-[w]x dt)
    F = jnp.zeros((15, 15), dtype=dp.dtype)
    f_01 = -0.25 * R0 @ R_a_0_x * dt2 + (-0.25) * R1 @ R_a_1_x @ Rw * dt2
    F = F.at[O_P:O_P + 3, O_P:O_P + 3].set(I3)
    F = F.at[O_P:O_P + 3, O_R:O_R + 3].set(f_01)
    F = F.at[O_P:O_P + 3, O_V:O_V + 3].set(I3 * dt)
    F = F.at[O_P:O_P + 3, O_BA:O_BA + 3].set(-0.25 * (R0 + R1) * dt2)
    F = F.at[O_P:O_P + 3, O_BG:O_BG + 3].set(0.25 * R1 @ R_a_1_x * dt2 * dt)
    F = F.at[O_R:O_R + 3, O_R:O_R + 3].set(Rw)
    F = F.at[O_R:O_R + 3, O_BG:O_BG + 3].set(-I3 * dt)
    f_21 = -0.5 * R0 @ R_a_0_x * dt + (-0.5) * R1 @ R_a_1_x @ Rw * dt
    F = F.at[O_V:O_V + 3, O_R:O_R + 3].set(f_21)
    F = F.at[O_V:O_V + 3, O_V:O_V + 3].set(I3)
    F = F.at[O_V:O_V + 3, O_BA:O_BA + 3].set(-0.5 * (R0 + R1) * dt)
    F = F.at[O_V:O_V + 3, O_BG:O_BG + 3].set(0.5 * R1 @ R_a_1_x * dt * dt)
    F = F.at[O_BA:O_BA + 3, O_BA:O_BA + 3].set(I3)
    F = F.at[O_BG:O_BG + 3, O_BG:O_BG + 3].set(I3)

    V = jnp.zeros((15, 18), dtype=dp.dtype)
    v_01 = -0.125 * R1 @ R_a_1_x * dt2 * dt  # 0.25 * R1 a1x dt2 * 0.5 dt
    V = V.at[O_P:O_P + 3, 0:3].set(0.25 * R0 * dt2)
    V = V.at[O_P:O_P + 3, 3:6].set(v_01)
    V = V.at[O_P:O_P + 3, 6:9].set(0.25 * R1 * dt2)
    V = V.at[O_P:O_P + 3, 9:12].set(v_01)
    V = V.at[O_R:O_R + 3, 3:6].set(0.5 * I3 * dt)
    V = V.at[O_R:O_R + 3, 9:12].set(0.5 * I3 * dt)
    V = V.at[O_V:O_V + 3, 0:3].set(0.5 * R0 * dt)
    v_21 = -0.25 * R1 @ R_a_1_x * dt * dt
    V = V.at[O_V:O_V + 3, 3:6].set(v_21)
    V = V.at[O_V:O_V + 3, 6:9].set(0.5 * R1 * dt)
    V = V.at[O_V:O_V + 3, 9:12].set(v_21)
    V = V.at[O_BA:O_BA + 3, 12:15].set(I3 * dt)
    V = V.at[O_BG:O_BG + 3, 15:18].set(I3 * dt)

    J_new = F @ J
    P_new = F @ P @ F.T + V @ noise_cov @ V.T
    sum_dt_new = sum_dt + dt

    return (dp_new, dq_new, dv_new, J_new, P_new, sum_dt_new, ba, bg,
            acc1, gyr1), None


def propagate_sequential(chunk: ImuChunk, linearized_ba: jax.Array,
                         linearized_bg: jax.Array,
                         imu: ImuConfig) -> Preintegration:
    """Reference-order sequential scan (integration_base.h:141-169).
    Kept as the numeric reference implementation; `propagate` below is
    the parallel formulation used in production."""
    dtype = chunk.acc.dtype
    noise_cov = noise_covariance(imu, dtype)
    init = (
        jnp.zeros(3, dtype), lie.quat_identity(dtype), jnp.zeros(3, dtype),
        jnp.eye(15, dtype=dtype), jnp.zeros((15, 15), dtype),
        jnp.zeros((), dtype), linearized_ba, linearized_bg,
        chunk.acc[0], chunk.gyr[0],
    )
    # Scan over samples 1..N-1 (row 0 only seeds acc0/gyr0).
    xs = (chunk.dt[1:], chunk.acc[1:], chunk.gyr[1:])
    (dp, dq, dv, J, P, sum_dt, ba, bg, _, _), _ = jax.lax.scan(
        lambda c, s: _midpoint_step(c, s, noise_cov), init, xs
    )
    return Preintegration(dp, dq, dv, J, P, sum_dt, ba, bg)


def _delta_prefixes(chunk: ImuChunk, ba: jax.Array, bg: jax.Array):
    """Body-frame preintegration deltas via log-depth prefix scans (steps
    1-2 of the parallel `propagate` formulation — shared with the light
    dead-reckoning path, which needs no covariance/Jacobian).

    Returns (dt [S], R0 [S,3,3], R1 [S,3,3], a0, a1, un_gyr,
    dp [3], dq [4], dv [3], sum_dt)."""
    dtype = chunk.acc.dtype
    dt = chunk.dt[1:]                      # [S]
    acc0 = chunk.acc[:-1]
    acc1 = chunk.acc[1:]
    gyr0 = chunk.gyr[:-1]
    gyr1 = chunk.gyr[1:]

    # --- 1. rotation prefixes -------------------------------------------
    un_gyr = 0.5 * (gyr0 + gyr1) - bg                     # [S,3]
    dq_inc = jax.vmap(lambda w, d: lie.delta_q(w * d))(un_gyr, dt)
    dq_pref = jax.lax.associative_scan(
        jax.vmap(lie.quat_mul), dq_inc)                   # [S,4]
    dq_pref = dq_pref / jnp.linalg.norm(dq_pref, axis=-1, keepdims=True)
    dq0 = jnp.concatenate(
        [lie.quat_identity(dtype)[None], dq_pref[:-1]], axis=0)  # R at k-1
    R0 = jax.vmap(lie.quat_to_rotmat)(dq0)                # [S,3,3]
    R1 = jax.vmap(lie.quat_to_rotmat)(dq_pref)

    # --- 2. Δv / Δp cumulative sums --------------------------------------
    a0 = acc0 - ba
    a1 = acc1 - ba
    un_acc = 0.5 * (jnp.einsum("sij,sj->si", R0, a0)
                    + jnp.einsum("sij,sj->si", R1, a1))   # [S,3]
    dv_steps = un_acc * dt[:, None]
    dv_pref = jnp.cumsum(dv_steps, axis=0)
    dv_excl = jnp.concatenate([jnp.zeros((1, 3), dtype), dv_pref[:-1]], 0)
    dp = jnp.sum(dv_excl * dt[:, None] + 0.5 * un_acc * (dt * dt)[:, None],
                 axis=0)
    dv = dv_pref[-1]
    dq = dq_pref[-1]
    sum_dt = jnp.sum(dt)
    return dt, R0, R1, a0, a1, un_gyr, dp, dq, dv, sum_dt


def propagate(chunk: ImuChunk, linearized_ba: jax.Array,
              linearized_bg: jax.Array, imu: ImuConfig) -> Preintegration:
    """Integrate a chunk into a `Preintegration` (= reference `propagate`,
    and `repropagate` when called with updated biases).

    Parallel formulation of the same midpoint recursion
    (integration_base.h:63-139): a 31-step sequential scan of tiny matrix
    ops is latency-bound (31 dependent steps per edge). Instead:
      1. per-step incremental rotations δq_k depend only on gyro inputs →
         all rotation PREFIXES via one `associative_scan` of quaternion
         products (log depth);
      2. with rotations known, the midpoint accelerations are elementwise
         and Δv/Δp are cumulative sums;
      3. the Jacobian chain J = F_{N}···F_1 and covariance recursion
         P ← F P Fᵀ + V Q Vᵀ form an associative pair composition
         (A2·A1, A2·B1·A2ᵀ + B2) → one more `associative_scan` of batched
         15×15 matmuls.
    Padding rows (dt = 0) contribute identity/zero elements exactly, as
    in the sequential form.
    """
    dtype = chunk.acc.dtype
    noise_cov = noise_covariance(imu, dtype)
    ba, bg = linearized_ba, linearized_bg
    (dt, R0, R1, a0, a1, un_gyr, dp, dq, dv, sum_dt) = \
        _delta_prefixes(chunk, ba, bg)
    I3 = jnp.eye(3, dtype=dtype)

    # --- 3. batched F/V, then pair-composition scan -----------------------
    dt2 = dt * dt

    def fv_one(R0k, R1k, a0k, a1k, wk, dtk, dt2k):
        R_w_x = lie.skew(wk)
        R_a_0_x = lie.skew(a0k)
        R_a_1_x = lie.skew(a1k)
        Rw = I3 - R_w_x * dtk
        F = jnp.zeros((15, 15), dtype)
        f_01 = -0.25 * R0k @ R_a_0_x * dt2k \
            + (-0.25) * R1k @ R_a_1_x @ Rw * dt2k
        F = F.at[O_P:O_P + 3, O_P:O_P + 3].set(I3)
        F = F.at[O_P:O_P + 3, O_R:O_R + 3].set(f_01)
        F = F.at[O_P:O_P + 3, O_V:O_V + 3].set(I3 * dtk)
        F = F.at[O_P:O_P + 3, O_BA:O_BA + 3].set(-0.25 * (R0k + R1k) * dt2k)
        F = F.at[O_P:O_P + 3, O_BG:O_BG + 3].set(
            0.25 * R1k @ R_a_1_x * dt2k * dtk)
        F = F.at[O_R:O_R + 3, O_R:O_R + 3].set(Rw)
        F = F.at[O_R:O_R + 3, O_BG:O_BG + 3].set(-I3 * dtk)
        f_21 = -0.5 * R0k @ R_a_0_x * dtk \
            + (-0.5) * R1k @ R_a_1_x @ Rw * dtk
        F = F.at[O_V:O_V + 3, O_R:O_R + 3].set(f_21)
        F = F.at[O_V:O_V + 3, O_V:O_V + 3].set(I3)
        F = F.at[O_V:O_V + 3, O_BA:O_BA + 3].set(-0.5 * (R0k + R1k) * dtk)
        F = F.at[O_V:O_V + 3, O_BG:O_BG + 3].set(0.5 * R1k @ R_a_1_x * dt2k)
        F = F.at[O_BA:O_BA + 3, O_BA:O_BA + 3].set(I3)
        F = F.at[O_BG:O_BG + 3, O_BG:O_BG + 3].set(I3)

        V = jnp.zeros((15, 18), dtype)
        v_01 = -0.125 * R1k @ R_a_1_x * dt2k * dtk
        V = V.at[O_P:O_P + 3, 0:3].set(0.25 * R0k * dt2k)
        V = V.at[O_P:O_P + 3, 3:6].set(v_01)
        V = V.at[O_P:O_P + 3, 6:9].set(0.25 * R1k * dt2k)
        V = V.at[O_P:O_P + 3, 9:12].set(v_01)
        V = V.at[O_R:O_R + 3, 3:6].set(0.5 * I3 * dtk)
        V = V.at[O_R:O_R + 3, 9:12].set(0.5 * I3 * dtk)
        V = V.at[O_V:O_V + 3, 0:3].set(0.5 * R0k * dtk)
        v_21 = -0.25 * R1k @ R_a_1_x * dt2k
        V = V.at[O_V:O_V + 3, 3:6].set(v_21)
        V = V.at[O_V:O_V + 3, 6:9].set(0.5 * R1k * dtk)
        V = V.at[O_V:O_V + 3, 9:12].set(v_21)
        V = V.at[O_BA:O_BA + 3, 12:15].set(I3 * dtk)
        V = V.at[O_BG:O_BG + 3, 15:18].set(I3 * dtk)
        return F, V

    F_all, V_all = jax.vmap(fv_one)(R0, R1, a0, a1, un_gyr, dt, dt2)
    Q_all = jnp.einsum("sij,jk,slk->sil", V_all, noise_cov, V_all)

    def compose(x, y):
        A1, B1 = x
        A2, B2 = y
        A = jnp.einsum("...ij,...jk->...ik", A2, A1)
        B = jnp.einsum("...ij,...jk,...lk->...il", A2, B1, A2) + B2
        return A, B

    J_pref, P_pref = jax.lax.associative_scan(compose, (F_all, Q_all))
    J = J_pref[-1]
    P = P_pref[-1]
    return Preintegration(dp, dq, dv, J, P, sum_dt, ba, bg)


def evaluate(pre: Preintegration,
             p_i: jax.Array, q_i: jax.Array, v_i: jax.Array,
             ba_i: jax.Array, bg_i: jax.Array,
             p_j: jax.Array, q_j: jax.Array, v_j: jax.Array,
             ba_j: jax.Array, bg_j: jax.Array,
             gravity: jax.Array) -> jax.Array:
    """15-dim preintegration residual (reference integration_base.h:171-198).

    Bias deviations from the linearization point are folded in to first
    order via the propagated Jacobian blocks.
    """
    J = pre.jacobian
    dp_dba = J[O_P:O_P + 3, O_BA:O_BA + 3]
    dp_dbg = J[O_P:O_P + 3, O_BG:O_BG + 3]
    dq_dbg = J[O_R:O_R + 3, O_BG:O_BG + 3]
    dv_dba = J[O_V:O_V + 3, O_BA:O_BA + 3]
    dv_dbg = J[O_V:O_V + 3, O_BG:O_BG + 3]

    dba = ba_i - pre.linearized_ba
    dbg = bg_i - pre.linearized_bg

    corrected_dq = lie.quat_mul(pre.dq, lie.delta_q(dq_dbg @ dbg))
    corrected_dv = pre.dv + dv_dba @ dba + dv_dbg @ dbg
    corrected_dp = pre.dp + dp_dba @ dba + dp_dbg @ dbg

    dt = pre.sum_dt
    q_i_inv = lie.quat_conj(q_i)
    r_p = lie.quat_rotate(
        q_i_inv, 0.5 * gravity * dt * dt + p_j - p_i - v_i * dt
    ) - corrected_dp
    r_q = 2.0 * lie.quat_mul(
        lie.quat_conj(corrected_dq), lie.quat_mul(q_i_inv, q_j)
    )[1:]
    r_v = lie.quat_rotate(q_i_inv, gravity * dt + v_j - v_i) - corrected_dv
    r_ba = ba_j - ba_i
    r_bg = bg_j - bg_i
    return jnp.concatenate([r_p, r_q, r_v, r_ba, r_bg])


def sqrt_information(pre: Preintegration, eps: float = 1e-8) -> jax.Array:
    """Upper-triangular whitening: sqrt_info = chol(P⁻¹)ᵀ.

    Reference: IMUFactor whitens with LLT of covariance.inverse()
    (VINS_ios/imu_factor.h:72). We regularize the covariance before
    inversion for fp32 robustness.
    """
    P = pre.covariance + eps * jnp.eye(15, dtype=pre.covariance.dtype)
    info = jnp.linalg.inv(P)
    info = 0.5 * (info + info.T)
    # chol returns lower L with L Lᵀ = info; residual whitening uses Lᵀ r.
    L = jnp.linalg.cholesky(info)
    return L.T


def propagate_state(p: jax.Array, q: jax.Array, v: jax.Array,
                    ba: jax.Array, bg: jax.Array,
                    chunk: ImuChunk, gravity: jax.Array):
    """World-frame dead-reckoning over a chunk (reference VINS.cpp:359-370).

    Log-depth formulation: the per-step world recursion is EXACTLY the
    body-frame preintegration delta composed with constant gravity —
    v_j = v_i − g·Δt + R_i·Δv and
    p_j = p_i + v_i·Δt − ½·g·Δt² + R_i·Δp
    (the cross terms collapse because Σₖ tₖ₋₁·dtₖ + ½Σₖdtₖ² = ½(Σdtₖ)²
    for any step sizes), so the 31-step sequential scan reduces to the
    same prefix scans `propagate` uses. Returns (p, q, v).
    """
    _, _, _, _, _, _, dp, dq, dv, sdt = _delta_prefixes(chunk, ba, bg)
    R_i = lie.quat_to_rotmat(q)
    p_j = p + v * sdt - 0.5 * gravity * sdt * sdt + R_i @ dp
    v_j = v - gravity * sdt + R_i @ dv
    q_j = lie.quat_normalize(lie.quat_mul(q, dq))
    return p_j, q_j, v_j
