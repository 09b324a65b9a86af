"""SO(3)/quaternion/Lie-group primitives for the VIO engine.

Functional equivalents of the reference's Eigen-based utility layer
(reference: VINS_ios/utility.hpp — deltaQ, Qleft/Qright, ypr<->R, g2R),
re-designed as pure-JAX, vmap/jit-friendly ops on fp32 arrays.

Conventions
-----------
* Quaternions are stored **wxyz** (scalar first), Hamilton convention,
  body-to-world passive rotation: ``w_v = R(q) @ b_v``.
* All functions are shape-polymorphic over leading batch dims where noted.
* Tangent/rotation vectors use the right-multiplication convention used by
  the reference estimator: ``q ⊞ δθ = q ⊗ exp(δθ)`` (reference:
  VINS_ios/pose_local_parameterization.cpp:11-27).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Quaternion core (wxyz, Hamilton)
# ---------------------------------------------------------------------------


def quat_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_conj(q: jax.Array) -> jax.Array:
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    return jnp.stack([w, -x, -y, -z], axis=-1)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product a ⊗ b (batch-broadcasting)."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v, without forming R."""
    qw = q[..., :1]
    qv = q[..., 1:]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def quat_to_rotmat(q: jax.Array) -> jax.Array:
    """Quaternion -> 3x3 rotation matrix (batched over leading dims)."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = jnp.stack(
        [
            ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: jax.Array) -> jax.Array:
    """3x3 rotation matrix -> wxyz quaternion, branch-free (Shepperd-style).

    Computes all four candidate quaternions (one per largest diagonal
    hypothesis) and selects the numerically best with `jnp.where`, so it is
    jit/vmap safe with no data-dependent branching.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*component^2 (always >= 0).
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    scores = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(scores, axis=-1)
    cand = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., 4(candidate), 4(wxyz)]
    q = jnp.take_along_axis(cand, best[..., None, None].astype(jnp.int32), axis=-2)
    q = q[..., 0, :]
    q = quat_normalize(q)
    # Canonicalize sign: w >= 0.
    return jnp.where(q[..., :1] < 0, -q, q)


# ---------------------------------------------------------------------------
# Small-angle / exp-log maps
# ---------------------------------------------------------------------------


def delta_q(theta: jax.Array) -> jax.Array:
    """First-order quaternion from a small rotation vector.

    Reference: Utility::deltaQ (VINS_ios/utility.hpp) — q = [1, θ/2],
    normalized for stability.
    """
    half = 0.5 * theta
    w = jnp.ones_like(half[..., :1])
    return quat_normalize(jnp.concatenate([w, half], axis=-1))


def so3_exp_quat(theta: jax.Array) -> jax.Array:
    """Exact exponential map: rotation vector -> quaternion (wxyz)."""
    angle_sq = jnp.sum(theta * theta, axis=-1, keepdims=True)
    angle = jnp.sqrt(angle_sq + 1e-24)
    half = 0.5 * angle
    # sin(x/2)/x with Taylor fallback for tiny angles.
    small = angle_sq < 1e-12
    k = jnp.where(small, 0.5 - angle_sq / 48.0, jnp.sin(half) / angle)
    w = jnp.where(small, 1.0 - angle_sq / 8.0, jnp.cos(half))
    return quat_normalize(jnp.concatenate([w, k * theta], axis=-1))


def so3_log(q: jax.Array) -> jax.Array:
    """Exact log map: quaternion (wxyz) -> rotation vector."""
    q = jnp.where(q[..., :1] < 0, -q, q)
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    angle = 2.0 * jnp.arctan2(vnorm, w)
    small = vnorm < 1e-9
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-6), angle / jnp.maximum(vnorm, 1e-24))
    return scale * v


def skew(v: jax.Array) -> jax.Array:
    """Skew-symmetric matrix [v]_x (batched)."""
    x, y, z = jnp.moveaxis(v, -1, 0)
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def quat_left(q: jax.Array) -> jax.Array:
    """4x4 left-multiplication matrix: quat_mul(q, p) == Qleft(q) @ p.

    Reference: Utility::Qleft (VINS_ios/utility.hpp), used by the analytic
    IMU-factor Jacobians (VINS_ios/imu_factor.h:93-180).
    """
    w = q[..., 0]
    v = q[..., 1:]
    top = jnp.concatenate([w[..., None, None], -v[..., None, :]], axis=-1)
    bottom_left = v[..., :, None]
    bottom_right = w[..., None, None] * jnp.broadcast_to(
        jnp.eye(3, dtype=q.dtype), q.shape[:-1] + (3, 3)
    ) + skew(v)
    bottom = jnp.concatenate([bottom_left, bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def quat_right(q: jax.Array) -> jax.Array:
    """4x4 right-multiplication matrix: quat_mul(p, q) == Qright(q) @ p."""
    w = q[..., 0]
    v = q[..., 1:]
    top = jnp.concatenate([w[..., None, None], -v[..., None, :]], axis=-1)
    bottom_left = v[..., :, None]
    bottom_right = w[..., None, None] * jnp.broadcast_to(
        jnp.eye(3, dtype=q.dtype), q.shape[:-1] + (3, 3)
    ) - skew(v)
    bottom = jnp.concatenate([bottom_left, bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# Euler (yaw-pitch-roll, ZYX) and gravity alignment
# ---------------------------------------------------------------------------


def rotmat_to_ypr(R: jax.Array) -> jax.Array:
    """Rotation matrix -> (yaw, pitch, roll) in radians, ZYX convention.

    Reference: Utility::R2ypr (VINS_ios/utility.hpp) (which returns degrees;
    we keep radians internally and convert at the I/O boundary).
    """
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    pitch = jnp.arctan2(
        -R[..., 2, 0],
        R[..., 0, 0] * jnp.cos(yaw) + R[..., 1, 0] * jnp.sin(yaw),
    )
    roll = jnp.arctan2(
        R[..., 0, 2] * jnp.sin(yaw) - R[..., 1, 2] * jnp.cos(yaw),
        -R[..., 0, 1] * jnp.sin(yaw) + R[..., 1, 1] * jnp.cos(yaw),
    )
    return jnp.stack([yaw, pitch, roll], axis=-1)


def ypr_to_rotmat(ypr: jax.Array) -> jax.Array:
    """(yaw, pitch, roll) radians -> rotation matrix, R = Rz(y) Ry(p) Rx(r)."""
    y, p, r = jnp.moveaxis(ypr, -1, 0)
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(r), jnp.sin(r)
    m = jnp.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        axis=-1,
    )
    return m.reshape(ypr.shape[:-1] + (3, 3))


def gravity_to_rotmat(g: jax.Array) -> jax.Array:
    """Rotation R0 such that R0 @ ĝ = +z, with yaw zeroed.

    Reference: Utility::g2R (VINS_ios/utility.cpp) used by visualInitialAlign
    (VINS_ios/VINS.cpp:1060-1065) to rotate the world frame gravity-aligned.
    """
    ng1 = g / jnp.linalg.norm(g, axis=-1, keepdims=True)
    ng2 = jnp.array([0.0, 0.0, 1.0], dtype=g.dtype)
    # Rotation taking ng1 to ng2 (axis-angle between the two unit vectors).
    axis = jnp.cross(ng1, jnp.broadcast_to(ng2, ng1.shape))
    sin_a = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    cos_a = jnp.sum(ng1 * ng2, axis=-1, keepdims=True)
    angle = jnp.arctan2(sin_a, cos_a)
    # Antiparallel degenerate case (g ≈ -z): cross is ~0 but angle ≈ π;
    # fall back to the x-axis, which is perpendicular to ±z.
    x_axis = jnp.zeros_like(ng1).at[..., 0].set(1.0)
    axis = jnp.where(sin_a < 1e-6, x_axis, axis / jnp.maximum(sin_a, 1e-12))
    R0 = quat_to_rotmat(so3_exp_quat(axis * angle))
    # Zero the yaw component.
    yaw = rotmat_to_ypr(R0)[..., 0]
    ypr_fix = jnp.stack([-yaw, jnp.zeros_like(yaw), jnp.zeros_like(yaw)], axis=-1)
    return ypr_to_rotmat(ypr_fix) @ R0


# ---------------------------------------------------------------------------
# Pose (SE3-style: position + quaternion) helpers
# ---------------------------------------------------------------------------


def pose_retract(p: jax.Array, q: jax.Array, delta: jax.Array):
    """Retract a 6-dim tangent [δp, δθ] onto (p, q).

    Matches the reference manifold: position adds, rotation right-multiplies
    a first-order quaternion (VINS_ios/pose_local_parameterization.cpp:11-27).
    """
    p_new = p + delta[..., 0:3]
    q_new = quat_normalize(quat_mul(q, delta_q(delta[..., 3:6])))
    return p_new, q_new


def quat_boxminus(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Rotation tangent of q2⁻¹ ⊗ q1 (i.e. q1 ⊟ q2), 2*vec part to first order.

    Matches the residual convention of the marginalization prior replay
    (reference: VINS_ios/marginalization_factor.cpp:352-360).
    """
    dq = quat_mul(quat_conj(q2), q1)
    dq = jnp.where(dq[..., :1] < 0, -dq, dq)
    return 2.0 * dq[..., 1:]


# ---------------------------------------------------------------------------
# Numpy twins — host-side scaffolding (dataset/fixture generation, boot
# bookkeeping). Every eager jax op is a dispatch (and a blocking fetch
# a device round trip) and every NEW eager program a compile, so
# host-side generators must never touch jax for small math. Same
# conventions as above (wxyz quaternions).
# ---------------------------------------------------------------------------
import numpy as _np


def np_yaw_quat(yaw) -> _np.ndarray:
    """wxyz quaternion(s) for pure-yaw rotation (vectorized numpy)."""
    half = 0.5 * _np.asarray(yaw, _np.float64)
    z = _np.zeros_like(half)
    return _np.stack([_np.cos(half), z, z, _np.sin(half)],
                     -1).astype(_np.float32)


def np_quat_to_rotmat(q) -> _np.ndarray:
    """Quaternion (wxyz) -> rotation matrix, batched (numpy twin of
    quat_to_rotmat)."""
    q = _np.asarray(q, _np.float64)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = _np.stack([
        ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
    ], -1)
    return r.reshape(q.shape[:-1] + (3, 3)).astype(_np.float32)


def np_rotmat_to_quat(R) -> _np.ndarray:
    """Rotation matrix -> wxyz quaternion, batched (numpy twin of
    rotmat_to_quat; same Shepperd-style candidate selection)."""
    R = _np.asarray(R, _np.float64)
    m = R.reshape(R.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = (
        m[..., 0], m[..., 1], m[..., 2], m[..., 3], m[..., 4],
        m[..., 5], m[..., 6], m[..., 7], m[..., 8])
    tr = m00 + m11 + m22
    qw = _np.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = _np.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                    m02 + m20], -1)
    qy = _np.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                    m12 + m21], -1)
    qz = _np.stack([m10 - m01, m02 + m20, m12 + m21,
                    1.0 - m00 - m11 + m22], -1)
    scores = _np.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    best = _np.argmax(scores, -1)
    cands = _np.stack([qw, qx, qy, qz], -2)  # [..., 4 cand, 4]
    q = _np.take_along_axis(cands, best[..., None, None].repeat(4, -1),
                            -2)[..., 0, :]
    q = _np.where(q[..., :1] < 0, -q, q)
    return (q / _np.linalg.norm(q, axis=-1, keepdims=True)).astype(
        _np.float32)


def np_quat_mul(a, b) -> _np.ndarray:
    """Hamilton product (wxyz), batched numpy twin of quat_mul."""
    a = _np.asarray(a, _np.float64)
    b = _np.asarray(b, _np.float64)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return _np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1).astype(_np.float32)


def np_so3_exp_quat(theta) -> _np.ndarray:
    """Rotation vector -> wxyz quaternion, numpy twin of so3_exp_quat."""
    theta = _np.asarray(theta, _np.float64)
    angle_sq = _np.sum(theta * theta, -1, keepdims=True)
    angle = _np.sqrt(angle_sq + 1e-24)
    half = 0.5 * angle
    small = angle_sq < 1e-12
    k = _np.where(small, 0.5 - angle_sq / 48.0, _np.sin(half) / angle)
    w = _np.where(small, 1.0 - angle_sq / 8.0, _np.cos(half))
    q = _np.concatenate([w, k * theta], -1)
    return (q / _np.linalg.norm(q, axis=-1, keepdims=True)).astype(
        _np.float32)
