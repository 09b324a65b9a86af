"""Distributed bundle adjustment: landmark-block-sharded Schur BA.

The reference's only large NLLS problems are the init SfM BA
(inital_sfm.cpp:234-293) and the 4-DoF pose graph — both single-device,
Ceres. The scale-out here (SURVEY.md §2.3, §5.7) partitions the
*landmarks* of a global BA across the mesh's `block` axis:

  per device:  residuals/Jacobians for its landmark shard
               H_cc^(d), g_c^(d)      (pose-pose normal equations)
               S^(d) = Σ_l B_l Hpp_l⁻¹ B_lᵀ   (local Schur contribution)
  collective:  H_s = psum(H_cc − S), g_s = psum(g_c − ...)
  replicated:  Cholesky solve of the reduced camera system  [6K × 6K]
  per device:  landmark back-substitution for its shard (no comm)

This is the factor-graph analog of data-parallel gradient psum: the
reduced camera system plays the role of "the gradient", landmark blocks
the role of "the batch". One LM iteration = two matmuls + one psum.

Poses are gauge-fixed by freezing pose 0 (and the global scale by pose 1's
z if requested) via a diagonal mask, mirroring the reference's approach of
anchoring frame l in SfM.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils import lie
from .mesh import BLOCK_AXIS


class BAProblem(NamedTuple):
    """Dense observation grid of L landmarks over K keyframes.

    obs[l, k]: normalized camera-plane observation of landmark l in
    keyframe k; mask[l, k] ∈ {0,1}. The camera here is the body (pure
    BA problem; extrinsics are folded in by the caller).
    """

    obs: jax.Array    # [L, K, 2]
    mask: jax.Array   # [L, K] float
    # Per-pose freeze flags: 1.0 = free, 0.0 = fixed (gauge anchors).
    pose_free: jax.Array  # [K]
    # Optional position prior pulling every free pose toward prior_p with
    # weight prior_w (residual rows w·(p−p⁰)). In a mono BA the global
    # SCALE is observable only through the anchors; without this prior
    # the whole map re-scales to whatever the two frozen poses' short
    # baseline says, discarding the VIO's IMU-metric scale (measured as
    # a 2.4x keyframe-ATE degradation on the revisit fixture). The prior
    # distributes the metric anchor over every pose instead.
    prior_p: Optional[jax.Array] = None   # [K, 3]
    prior_w: Optional[jax.Array] = None   # [] weight per meter


class BAState(NamedTuple):
    p: jax.Array      # [K, 3] camera positions (world)
    q: jax.Array      # [K, 4] wxyz world-from-camera
    pts: jax.Array    # [L, 3] landmark world points


def _residual_lk(X, obs, p, q):
    """Reprojection residual of one landmark in one keyframe."""
    Xc = lie.quat_rotate(lie.quat_conj(q), X - p)
    z = Xc[2]
    z_safe = jnp.where(jnp.abs(z) < 1e-4, jnp.where(z < 0, -1e-4, 1e-4), z)
    return Xc[:2] / z_safe - obs


def _landmark_blocks(state: BAState, prob: BAProblem):
    """Per-landmark residuals and Jacobians for the local shard.

    Returns:
      r:   [L, K, 2]     masked residuals
      Jc:  [L, K, 2, 6]  ∂r/∂pose-tangent (masked)
      Jp:  [L, K, 2, 3]  ∂r/∂point (masked)
    """

    def one(X, obs_k, m_k):
        def per_k(obs, p, q, m):
            def local(d):
                pp, qq = lie.pose_retract(p, q, d[:6])
                return _residual_lk(X + d[6:9], obs, pp, qq)

            zero = jnp.zeros(9, state.p.dtype)
            r = local(zero)
            J = jax.jacfwd(local)(zero)
            return r * m, J[:, :6] * m, J[:, 6:9] * m

        return jax.vmap(per_k)(obs_k, state.p, state.q, m_k)

    r, Jc, Jp = jax.vmap(one)(state.pts, prob.obs, prob.mask)
    # Zero columns of frozen poses.
    Jc = Jc * prob.pose_free[None, :, None, None]
    return r, Jc, Jp


def _local_normal_eqs(state: BAState, prob: BAProblem):
    """This shard's contribution to the reduced camera system.

    Returns (H_cc [6K,6K], g_c [6K], S [6K,6K], gs_corr [6K],
             Hpp_inv [L,3,3], B [L,6K,3], g_p [L,3], cost []).
    """
    L, K = prob.mask.shape
    r, Jc, Jp = _landmark_blocks(state, prob)

    # Pose-pose block: within a landmark, different k rows never share a
    # pose column, so H_cc is block-diagonal per pose: [K,6,6].
    Hcc_k = jnp.einsum("lkri,lkrj->kij", Jc, Jc)
    g_c = jnp.einsum("lkri,lkr->ki", Jc, r).reshape(K * 6)

    # Landmark blocks.
    Hpp = jnp.einsum("lkri,lkrj->lij", Jp, Jp) + 1e-8 * jnp.eye(3)
    g_p = jnp.einsum("lkri,lkr->li", Jp, r)
    B = jnp.einsum("lkri,lkrj->lkij", Jc, Jp)  # [L,K,6,3]
    B = B.reshape(L, K * 6, 3)

    Hpp_inv = jnp.linalg.inv(Hpp)
    # Schur contribution: S = Σ_l B_l Hpp_l⁻¹ B_lᵀ  (one einsum).
    S = jnp.einsum("lia,lab,ljb->ij", B, Hpp_inv, B)
    gs_corr = jnp.einsum("lia,lab,lb->i", B, Hpp_inv, g_p)

    Hcc = _block_diag(Hcc_k)
    cost = 0.5 * jnp.sum(r * r)
    return Hcc, g_c, S, gs_corr, Hpp_inv, B, g_p, cost


def _block_diag(blocks: jax.Array) -> jax.Array:
    """[K,6,6] → [6K,6K] block-diagonal, static-shape."""
    K = blocks.shape[0]
    out = jnp.zeros((K * 6, K * 6), blocks.dtype)
    idx = 6 * jnp.arange(K)[:, None] + jnp.arange(6)[None, :]
    return out.at[idx[:, :, None], idx[:, None, :]].set(blocks)


def _lm_iteration(state: BAState, prob: BAProblem, lam: jax.Array,
                  axis_name: str | None):
    """One damped LM step. With axis_name, H_s/g_s/cost are psum-reduced
    across landmark shards; without, it is the single-device path."""
    K = prob.mask.shape[1]
    Hcc, g_c, S, gs_corr, Hpp_inv, B, g_p, cost = _local_normal_eqs(
        state, prob)

    H_s = Hcc - S
    g_s = g_c - gs_corr
    if axis_name is not None:
        H_s = jax.lax.psum(H_s, axis_name)
        g_s = jax.lax.psum(g_s, axis_name)
        cost = jax.lax.psum(cost, axis_name)

    # Pose-position prior (replicated: added AFTER the psum so shards
    # don't multiply it).
    if prob.prior_p is not None:
        w2 = prob.prior_w * prob.prior_w
        idxp = (6 * jnp.arange(K)[:, None]
                + jnp.arange(3)[None, :]).reshape(-1)
        free3 = jnp.repeat(prob.pose_free, 3)
        H_s = H_s.at[idxp, idxp].add(w2 * free3)
        dp = ((state.p - prob.prior_p)
              * prob.pose_free[:, None]).reshape(-1)
        g_s = g_s.at[idxp].add(w2 * dp)

    # Damping + gauge floor (frozen poses have zeroed columns → identity
    # rows via the absolute term keep the system SPD).
    d = jnp.diagonal(H_s)
    H_d = H_s + jnp.diag(lam * d + 1e-6 + lam)
    L_chol = jnp.linalg.cholesky(H_d)
    dx_c = -jax.scipy.linalg.cho_solve((L_chol, True), g_s)

    # Landmark back-substitution: local, no comm.
    rhs = g_p + jnp.einsum("lia,i->la", B, dx_c)
    dx_p = -jnp.einsum("lab,lb->la", Hpp_inv, rhs)

    d_pose = (dx_c.reshape(K, 6) * prob.pose_free[:, None])
    p_new, q_new = lie.pose_retract(state.p, state.q, d_pose)
    cand = BAState(p=p_new, q=q_new, pts=state.pts + dx_p)
    return cand, cost


def _ba_cost(state: BAState, prob: BAProblem, axis_name: str | None):
    r, _, _ = _landmark_blocks(state, prob)
    c = 0.5 * jnp.sum(r * r)
    if axis_name is not None:
        c = jax.lax.psum(c, axis_name)
    if prob.prior_p is not None:
        dp = (state.p - prob.prior_p) * prob.pose_free[:, None]
        c = c + 0.5 * (prob.prior_w ** 2) * jnp.sum(dp * dp)
    return c


def _solve_ba_core(state: BAState, prob: BAProblem, iters: int,
                   axis_name: str | None):
    def body(carry, _):
        st, lam, cost = carry
        cand, _ = _lm_iteration(st, prob, lam, axis_name)
        new_cost = _ba_cost(cand, prob, axis_name)
        good = jnp.isfinite(new_cost) & (new_cost < cost)
        st = jax.tree.map(lambda a, b: jnp.where(good, b, a), st, cand)
        cost = jnp.where(good, new_cost, cost)
        lam = jnp.clip(jnp.where(good, lam * 0.3, lam * 10.0), 1e-9, 1e3)
        return (st, lam, cost), cost

    cost0 = _ba_cost(state, prob, axis_name)
    (st, _, cost), hist = jax.lax.scan(
        body, (state, jnp.asarray(1e-4, state.p.dtype), cost0), None,
        length=iters)
    return st, cost, hist


def _materialize_prior(state: BAState, prob: BAProblem) -> BAProblem:
    """Fill absent prior fields with an inert (zero-weight) prior so the
    pytree structure is fixed (shard_map specs must match leaves)."""
    if prob.prior_p is not None:
        return prob
    return prob._replace(
        prior_p=jnp.zeros_like(state.p),
        prior_w=jnp.zeros((), state.p.dtype))


def solve_ba(state: BAState, prob: BAProblem, iters: int = 10):
    """Single-device reference LM Schur BA (also the per-shard math)."""
    return _solve_ba_core(state, _materialize_prior(state, prob), iters,
                          axis_name=None)


def solve_ba_sharded(state: BAState, prob: BAProblem, mesh: Mesh,
                     iters: int = 10):
    """Landmark-sharded distributed BA over the mesh's `block` axis.

    L must divide by the block-axis size. Poses replicate; landmarks,
    observations, and masks shard on their leading axis. The per-iteration
    collective is one psum of a [6K,6K] matrix + [6K] vector.
    """
    prob = _materialize_prior(state, prob)
    pspec_lm = P(BLOCK_AXIS)
    pspec_rep = P()

    in_specs = (
        BAState(p=pspec_rep, q=pspec_rep, pts=pspec_lm),
        BAProblem(obs=pspec_lm, mask=pspec_lm, pose_free=pspec_rep,
                  prior_p=pspec_rep, prior_w=pspec_rep),
    )
    out_specs = (
        BAState(p=pspec_rep, q=pspec_rep, pts=pspec_lm),
        pspec_rep, pspec_rep,
    )

    fn = jax.shard_map(
        functools.partial(_solve_ba_core, iters=iters, axis_name=BLOCK_AXIS),
        mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False)
    return fn(state, prob)
