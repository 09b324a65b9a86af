"""Batched fixed-hypothesis RANSAC estimators + pose recovery + PnP.

Batched replacements for the reference's adaptive OpenCV calls
(SURVEY.md §7.1): cv::findFundamentalMat(FM_RANSAC) used for outlier
culling (feature_tracker.cpp:89-105, :198), cv::findEssentialMat +
recoverPose for bootstrap relative pose (motion_estimator.cpp:200-236),
and cv::solvePnP for SfM pose chaining (inital_sfm.cpp:22-72).

Design: a FIXED number of minimal-set hypotheses is drawn with
jax.random, all model fits run as one batched SVD, inliers are counted
in one [hyp, N] elementwise pass, and the best hypothesis wins by argmax
— no data-dependent iteration (SURVEY.md §7.3 'RANSAC & PnP on device').
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..utils import lie


def _normalize_points(pts: jax.Array, valid: jax.Array):
    """Hartley normalization: zero-mean, mean distance sqrt(2).

    Invalid rows are excluded with `where`, not multiplication: a NaN in a
    masked-out row (e.g. a diverged undistortion of an off-image point)
    would otherwise poison the mean and with it EVERY hypothesis."""
    w = valid.astype(pts.dtype)[:, None]
    pts_safe = jnp.where(valid[:, None], pts, 0.0)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts_safe * w, axis=0) / n
    d = jnp.sqrt(jnp.sum((pts_safe - mean) ** 2, axis=-1) + 1e-12)
    scale = 1.41421356 / jnp.maximum(jnp.sum(d * valid) / n, 1e-9)
    T = jnp.array([[scale, 0.0, -scale * mean[0]],
                   [0.0, scale, -scale * mean[1]],
                   [0.0, 0.0, 1.0]], pts.dtype)
    pn = (pts - mean) * scale
    return pn, T


def _rank2_project(F: jax.Array) -> jax.Array:
    """Nearest rank-2 matrix (zero the smallest singular value)."""
    U, S, Vt = jnp.linalg.svd(F)
    S = S.at[2].set(0.0)
    return U @ jnp.diag(S) @ Vt


def _eight_point(p1: jax.Array, p2: jax.Array) -> jax.Array:
    """Fit F (or E) from 8 correspondences via the linear 8-point system.
    p1, p2: [8, 2]. Returns [3,3] WITHOUT rank-2 enforcement — Sampson
    scoring does not need it, so RANSAC projects only the winning
    hypothesis (a batched 3x3 SVD per hypothesis is an iterative solver
    call per hypothesis).

    The null vector comes from a complete QR of Aᵀ: the last column of Q
    is orthogonal to every row of A — exactly null(A) for an 8x9 system.
    Batched QR is 8 vectorized Householder steps, where a batched [8,9]
    SVD iterates the QR algorithm to convergence."""
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                   jnp.ones_like(x1)], axis=-1)        # [8, 9]
    Q, _ = jnp.linalg.qr(A.T, mode="complete")          # [9, 9]
    return Q[:, -1].reshape(3, 3)


def _sampson_dist(F: jax.Array, p1: jax.Array, p2: jax.Array) -> jax.Array:
    """Sampson distance of correspondences under F. p*: [N,2]."""
    ones = jnp.ones_like(p1[:, :1])
    x1 = jnp.concatenate([p1, ones], axis=-1)
    x2 = jnp.concatenate([p2, ones], axis=-1)
    Fx1 = x1 @ F.T       # [N,3] = F @ x1
    Ftx2 = x2 @ F        # [N,3] = F^T @ x2
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


class RansacResult(NamedTuple):
    model: jax.Array     # [3,3]
    inliers: jax.Array   # [N] bool
    n_inliers: jax.Array # []


def ransac_fundamental(p1: jax.Array, p2: jax.Array, valid: jax.Array,
                       key: jax.Array, n_hyps: int = 256,
                       thresh: float = 1e-5) -> RansacResult:
    """Batched 8-point F-RANSAC.

    p1, p2: [N,2] correspondences (normalized-plane or pixel coords —
    thresh must match the unit; the front-end uses normalized coords with
    thresh ≈ (px_thresh/focal)²).
    """
    N = p1.shape[0]
    pn1, T1 = _normalize_points(p1, valid)
    pn2, T2 = _normalize_points(p2, valid)

    # Sample minimal sets from valid indices (with replacement across
    # hypotheses, Gumbel-top-k within a hypothesis for distinctness).
    logits = jnp.where(valid, 0.0, -jnp.inf)
    keys = jax.random.split(key, n_hyps)

    def one(k):
        g = jax.random.gumbel(k, (N,)) + logits
        _, idx = jax.lax.top_k(g, 8)
        Fh = _eight_point(pn1[idx], pn2[idx])
        return T2.T @ Fh @ T1

    Fs = jax.vmap(one)(keys)                            # [hyp,3,3]
    d = jax.vmap(lambda F: _sampson_dist(F, p1, p2))(Fs)  # [hyp,N]
    inl = (d < thresh) & valid[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)
    # Rank-2 projection on the winner only (see _eight_point docstring).
    return RansacResult(model=_rank2_project(Fs[best]), inliers=inl[best],
                        n_inliers=counts[best])


def ransac_essential(p1: jax.Array, p2: jax.Array, valid: jax.Array,
                     key: jax.Array, n_hyps: int = 256,
                     thresh: float = 1e-5) -> RansacResult:
    """Essential matrix via the normalized 8-point algorithm on
    already-normalized camera-plane coordinates, with the (1,1,0)
    singular-value projection.

    The reference uses Nistér 5-point (cv::findEssentialMat,
    motion_estimator.cpp:203); with ≥8 well-spread correspondences the
    8-point estimate + projection is equivalent in accuracy for VIO
    bootstrap, and maps to one batched SVD instead of a 10th-degree
    polynomial solve. Degenerate (near-planar) scenes fall back to the
    initializer's parallax gate, as the reference does.
    """
    res = ransac_fundamental(p1, p2, valid, key, n_hyps, thresh)
    U, S, Vt = jnp.linalg.svd(res.model)
    E = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], res.model.dtype)) @ Vt
    return RansacResult(model=E, inliers=res.inliers, n_inliers=res.n_inliers)


def _triangulate_pair(R: jax.Array, t: jax.Array, p1: jax.Array,
                      p2: jax.Array) -> jax.Array:
    """Midpoint-free DLT triangulation for cam1=[I|0], cam2=[R|t].
    Returns [N,3] points in cam1 frame."""
    P2 = jnp.concatenate([R, t[:, None]], axis=1)       # [3,4]

    def one(a, b):
        A = jnp.stack([
            jnp.array([-1.0, 0.0, a[0], 0.0]),
            jnp.array([0.0, -1.0, a[1], 0.0]),
            b[0] * P2[2] - P2[0],
            b[1] * P2[2] - P2[1]])
        _, _, Vt = jnp.linalg.svd(A)
        X = Vt[-1]
        return X[:3] / jnp.where(jnp.abs(X[3]) < 1e-12, 1e-12, X[3])

    return jax.vmap(one)(p1, p2)


def recover_pose(E: jax.Array, p1: jax.Array, p2: jax.Array,
                 valid: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Cheirality-tested decomposition of E into (R, t) with |t|=1.

    Matches cv::recoverPose (motion_estimator.cpp:219): four candidate
    (R,t) pairs, pick the one with the most points in front of both
    cameras. Returns (R, t, n_good) with x2 ~ R x1 + t.
    """
    U, _, Vt = jnp.linalg.svd(E)
    # Enforce proper rotations.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    Wm = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                   E.dtype)
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    t = U[:, 2]

    def count_good(R, tt):
        X1 = _triangulate_pair(R, tt, p1, p2)
        z1 = X1[:, 2]
        X2 = X1 @ R.T + tt
        z2 = X2[:, 2]
        return jnp.sum((z1 > 0) & (z2 > 0) & valid)

    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    counts = jnp.stack([count_good(R, tt) for R, tt in cands])
    best = jnp.argmax(counts)
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    return Rs[best], ts[best], counts[best]


def translation_known_rotation(R: jax.Array, p1: jax.Array, p2: jax.Array,
                               valid: jax.Array
                               ) -> Tuple[jax.Array, jax.Array]:
    """Relative translation direction given a KNOWN relative rotation
    (e.g. gyro-preintegrated): the planar-degeneracy-immune seed.

    With x2 ~ R x1 + t, each correspondence gives the linear constraint
    t · (R x̃1 × x̃2) = 0 (epipolar with known R) — valid for ANY scene
    structure including pure planes, where the 8-point essential is
    degenerate (the reference avoids this via Nistér 5-point,
    motion_estimator.cpp:203; a VIO system can do better by using its
    gyro). Solves min|C t|, |t|=1 via SVD, fixes the sign by cheirality.
    Returns (t_unit, n_good).
    """
    h1 = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], axis=1)
    h2 = jnp.concatenate([p2, jnp.ones_like(p2[:, :1])], axis=1)
    y = h1 @ R.T                                  # R x1
    C = jnp.cross(y, h2) * valid[:, None].astype(p1.dtype)
    _, _, Vt = jnp.linalg.svd(C, full_matrices=False)
    t = Vt[-1]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    def count_good(tt):
        X1 = _triangulate_pair(R, tt, p1, p2)
        z1 = X1[:, 2]
        z2 = (X1 @ R.T + tt)[:, 2]
        return jnp.sum((z1 > 0) & (z2 > 0) & valid)

    n_pos = count_good(t)
    n_neg = count_good(-t)
    flip = n_neg > n_pos
    return jnp.where(flip, -t, t), jnp.maximum(n_pos, n_neg)


def pnp_gn(points_w: jax.Array, obs: jax.Array, valid: jax.Array,
           p0: jax.Array, q0: jax.Array, iters: int = 10,
           ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Gauss–Newton PnP: refine camera pose (p, q: world-from-camera)
    from fixed 3D points and normalized 2D observations.

    Replaces cv::solvePnP with-initial-guess (inital_sfm.cpp:48-66,
    VINS.cpp:957-978). Damped GN with fixed iterations; returns
    (p, q, mean_sq_residual).
    """
    w = valid.astype(points_w.dtype)

    def residual(p, q):
        pc = lie.quat_rotate(lie.quat_conj(q), points_w - p)   # cam frame
        z = jnp.where(jnp.abs(pc[:, 2:3]) < 1e-6, 1e-6, pc[:, 2:3])
        r = (pc[:, :2] / z - obs) * w[:, None]
        return r

    def step(carry, _):
        p, q = carry

        def res_local(d):
            pp, qq = lie.pose_retract(p, q, d)
            return residual(pp, qq).reshape(-1)

        z6 = jnp.zeros(6, points_w.dtype)
        r = res_local(z6)
        J = jax.jacfwd(res_local)(z6)
        H = J.T @ J + 1e-6 * jnp.eye(6, dtype=J.dtype)
        g = J.T @ r
        d = -jnp.linalg.solve(H, g)
        pp, qq = lie.pose_retract(p, q, d)
        # Accept only if improved (cheap safeguarded GN).
        better = jnp.sum(res_local(jnp.zeros(6)) ** 2) >= jnp.sum(
            residual(pp, qq) ** 2)
        p = jnp.where(better, pp, p)
        q = jnp.where(better, qq, q)
        return (p, q), None

    (p, q), _ = jax.lax.scan(step, (p0, q0), None, length=iters)
    msr = jnp.sum(residual(p, q) ** 2) / jnp.maximum(jnp.sum(w), 1.0)
    return p, q, msr
