"""Batched factor residuals and tangent-space Jacobians.

Dense batched re-design of the reference's Ceres cost functions:
  * IMU factor        — VINS_ios/imu_factor.h:27-184 (15-dim, whitened by
                        sqrt-information of the preintegration covariance)
  * Projection factor — VINS_ios/projection_facor.cpp:16-99 (2-dim residual
                        in the normalized image plane, sqrt_info = f/1.5·I2,
                        Cauchy robust loss VINS.cpp:485)
  * Perspective (PnP) factor — VINS_ios/perspective_factor.cpp:16-67
                        (fixed 3D landmark, used by the motion-only solver)

Instead of Ceres' per-block analytic Jacobians, every factor exposes a
*local* residual as a function of a small tangent perturbation; Jacobians
come from `jax.jacfwd` of that function, vmapped over the whole factor
table at once — one fused XLA program instead of N virtual calls.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..utils import lie
from . import preintegration as pre_mod
from .state import WindowState, FeatureTable


class Extrinsics(NamedTuple):
    """Camera-IMU extrinsics (held constant, as the reference does:
    extrinsic parameter block set constant in VINS.cpp:497-503)."""

    tic: jax.Array   # [3]
    qic: jax.Array   # [4] wxyz


# ---------------------------------------------------------------------------
# IMU factors (one per window edge)
# ---------------------------------------------------------------------------


def imu_residual_whitened(pre: pre_mod.Preintegration,
                          p_i, q_i, v_i, ba_i, bg_i,
                          p_j, q_j, v_j, ba_j, bg_j,
                          gravity: jax.Array) -> jax.Array:
    """Whitened 15-dim IMU residual for one edge."""
    r = pre_mod.evaluate(pre, p_i, q_i, v_i, ba_i, bg_i,
                         p_j, q_j, v_j, ba_j, bg_j, gravity)
    S = pre_mod.sqrt_information(pre)
    return S @ r


def imu_factor_local(pre: pre_mod.Preintegration, state: WindowState,
                     edge_i: jax.Array, gravity: jax.Array, S=None):
    """Residual+Jacobian of one IMU edge wrt the 30-dim tangent of its two
    frames. Returns (r [15], J [15, 30]). Pass a precomputed whitening S
    when linearizing repeatedly (it only depends on the preintegration)."""
    p_i, q_i = state.p[edge_i], state.q[edge_i]
    v_i, ba_i, bg_i = state.v[edge_i], state.ba[edge_i], state.bg[edge_i]
    j = edge_i + 1
    p_j, q_j = state.p[j], state.q[j]
    v_j, ba_j, bg_j = state.v[j], state.ba[j], state.bg[j]
    if S is None:
        S = pre_mod.sqrt_information(pre)

    def local(delta):
        di, dj = delta[:15], delta[15:]
        pi, qi = lie.pose_retract(p_i, q_i, di[0:6])
        pj, qj = lie.pose_retract(p_j, q_j, dj[0:6])
        r = pre_mod.evaluate(
            pre, pi, qi, v_i + di[6:9], ba_i + di[9:12], bg_i + di[12:15],
            pj, qj, v_j + dj[6:9], ba_j + dj[9:12], bg_j + dj[12:15], gravity)
        return S @ r

    zero = jnp.zeros(30, dtype=state.p.dtype)
    r = local(zero)
    J = jax.jacfwd(local)(zero)
    return r, J


# ---------------------------------------------------------------------------
# Projection factors (one per (frame, feature-slot) grid cell)
# ---------------------------------------------------------------------------


def projection_residual(obs_i: jax.Array, obs_j: jax.Array,
                        p_i, q_i, p_j, q_j, inv_dep: jax.Array,
                        ext: Extrinsics) -> jax.Array:
    """Unwhitened 2-dim reprojection residual: anchor frame i → frame j.

    Geometry matches ProjectionFactor::Evaluate
    (VINS_ios/projection_facor.cpp:16-40).
    """
    pts_i = jnp.concatenate([obs_i, jnp.ones_like(obs_i[..., :1])], axis=-1)
    pts_cam_i = pts_i / jnp.maximum(inv_dep, 1e-6)
    pts_imu_i = lie.quat_rotate(ext.qic, pts_cam_i) + ext.tic
    pts_w = lie.quat_rotate(q_i, pts_imu_i) + p_i
    pts_imu_j = lie.quat_rotate(lie.quat_conj(q_j), pts_w - p_j)
    pts_cam_j = lie.quat_rotate(lie.quat_conj(ext.qic), pts_imu_j - ext.tic)
    z = pts_cam_j[..., 2:3]
    # Guard the divide; behind-camera points yield a large (down-weighted)
    # residual rather than NaN.
    z_safe = jnp.where(jnp.abs(z) < 1e-4, jnp.where(z < 0, -1e-4, 1e-4), z)
    return pts_cam_j[..., 0:2] / z_safe - obs_j


def projection_factor_local(obs_i, obs_j, p_i, q_i, p_j, q_j, inv_dep,
                            ext: Extrinsics, sqrt_info: jax.Array):
    """Residual+Jacobian of one projection factor wrt its 13-dim tangent
    (6 anchor pose, 6 observing pose, 1 inverse depth).
    Returns (r [2], J [2, 13])."""

    def local(delta):
        pi, qi = lie.pose_retract(p_i, q_i, delta[0:6])
        pj, qj = lie.pose_retract(p_j, q_j, delta[6:12])
        r = projection_residual(obs_i, obs_j, pi, qi, pj, qj,
                                inv_dep + delta[12], ext)
        return sqrt_info * r

    zero = jnp.zeros(13, dtype=obs_i.dtype)
    r = local(zero)
    J = jax.jacfwd(local)(zero)
    return r, J


def cauchy_weight(r: jax.Array, c: float) -> jax.Array:
    """Sqrt-reweighting for a Cauchy robust loss ρ(s)=c²·log(1+s/c²)
    applied to whitened residuals (reference uses CauchyLoss(1.0),
    VINS.cpp:485; Triggs second-order term dropped as Ceres does for
    positive-definite reweighting)."""
    s = jnp.sum(r * r, axis=-1, keepdims=True)
    return jnp.sqrt(1.0 / (1.0 + s / (c * c)))


def cauchy_rho(s: jax.Array, c: float) -> jax.Array:
    return c * c * jnp.log1p(s / (c * c))


# ---------------------------------------------------------------------------
# Perspective (fixed-landmark PnP) factor for the motion-only solver
# ---------------------------------------------------------------------------


def perspective_residual(pt_world: jax.Array, obs: jax.Array,
                         p: jax.Array, q: jax.Array,
                         ext: Extrinsics) -> jax.Array:
    """2-dim residual of a fixed 3D world landmark observed at pose (p,q).

    Matches PerspectiveFactor (VINS_ios/perspective_factor.cpp:16-40); the
    reference weights by track_num/10 — callers fold that into sqrt_info.
    """
    pts_imu = lie.quat_rotate(lie.quat_conj(q), pt_world - p)
    pts_cam = lie.quat_rotate(lie.quat_conj(ext.qic), pts_imu - ext.tic)
    z = pts_cam[..., 2:3]
    z_safe = jnp.where(jnp.abs(z) < 1e-4, jnp.where(z < 0, -1e-4, 1e-4), z)
    return pts_cam[..., 0:2] / z_safe - obs
