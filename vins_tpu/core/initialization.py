"""Automatic visual-inertial initialization.

Re-design of the reference bootstrap chain (SURVEY.md §3.4):
  * relative-pose seeding   — VINS::relativePose (VINS_ios/VINS.cpp:1104-1145)
                              via batched 8-point essential RANSAC +
                              cheirality pose recovery (ops/ransac.py)
  * global SfM              — GlobalSFM::construct (inital_sfm.cpp:117-316):
                              two-view init, PnP chaining, DLT triangulation
                              sweeps, then a small full bundle adjustment
  * visual-inertial align   — VisualIMUAlignment (initial_aligment.cpp:221):
                              gyro-bias least squares + repropagation, then
                              the linear velocity/gravity/scale solve with
                              scale conditioning, then tangent-basis gravity
                              refinement
  * acceptance              — final window solve must reach cost below
                              cfg.init_max_cost (VINS.cpp:416), with the
                              failure taxonomy of VINS.hpp:134-145.

Initialization runs once per (re)bootstrap — a host-orchestrated sequence
of small jitted pieces rather than one giant compiled program.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import VinsConfig
from ..ops import ransac as ransac_mod
from ..utils import lie
from . import feature_manager as fm
from . import preintegration as pre_mod
from .factors import Extrinsics
from .solver import WindowProblem, solve_window
from .state import FeatureTable, PriorFactor, WindowState


class InitStatus(enum.Enum):
    SUCCESS = 0
    FAIL_IMU = 1        # insufficient IMU excitation
    FAIL_PARALLAX = 2   # no frame pair with enough parallax
    FAIL_RELATIVE = 3   # relative pose recovery failed
    FAIL_SFM = 4        # SfM BA diverged
    FAIL_PNP = 5        # PnP chaining failed
    FAIL_ALIGN = 6      # gravity/scale alignment failed
    FAIL_CHECK = 7      # final cost above acceptance threshold


# ---------------------------------------------------------------------------
# Relative pose seeding
# ---------------------------------------------------------------------------


def find_reference_frame(feats: FeatureTable, focal: float,
                         min_corres: int = 20,
                         min_parallax_px: float = 30.0):
    """Pick the earliest frame l with enough correspondences and parallax
    to the newest frame (reference relativePose, VINS.cpp:1104-1145).
    Returns (l, ok) as numpy scalars (host decision)."""
    F, M = feats.mask.shape
    newest = F - 1
    both = feats.mask & feats.mask[newest][None, :]          # [F, M]
    n_corr = jnp.sum(both, axis=1)
    d = feats.obs - feats.obs[newest][None]
    par = jnp.sqrt(jnp.sum(d * d, axis=-1)) * both           # [F, M]
    mean_par = jnp.sum(par, axis=1) / jnp.maximum(n_corr, 1)
    ok = (n_corr >= min_corres) & (mean_par * focal >= min_parallax_px)
    ok = ok.at[newest].set(False)
    l = jnp.argmax(ok)  # earliest True (argmax of bool picks first)
    return int(l), bool(ok[l])


# ---------------------------------------------------------------------------
# Global SfM
# ---------------------------------------------------------------------------


class SfmResult(NamedTuple):
    # Camera poses: world(=frame-l camera) from camera f.  x_w = R x_c + t.
    R_wc: jax.Array     # [F, 3, 3]
    t_wc: jax.Array     # [F, 3]
    pts_w: jax.Array    # [M, 3] triangulated points (SfM/world scale)
    pts_ok: jax.Array   # [M]


def _triangulate_pair_grid(obs_a, obs_b, mask, R_a, t_a, R_b, t_b):
    """DLT triangulation of [M] points from two camera poses (world-from-
    camera convention). Masked points get garbage (filtered by caller)."""
    # Projection: x_c = R^T (X - t).
    def one(oa, ob):
        rows = []
        for (R, t, o) in ((R_a, t_a, oa), (R_b, t_b, ob)):
            P = jnp.concatenate([R.T, (-R.T @ t)[:, None]], axis=1)  # [3,4]
            rows.append(o[0] * P[2] - P[0])
            rows.append(o[1] * P[2] - P[1])
        A = jnp.stack(rows)
        _, _, Vt = jnp.linalg.svd(A)
        X = Vt[-1]
        return X[:3] / jnp.where(jnp.abs(X[3]) < 1e-12, 1e-12, X[3])

    return jax.vmap(one)(obs_a, obs_b)


def _depth_in(R, t, X):
    return (jnp.einsum("ij,mi->mj", R, X - t[None]))[:, 2]


@jax.jit
def _sfm_tri_j(feats, R_all, t_all, pts_w, pts_ok, a, b):
    pair = (feats.mask[a] & feats.mask[b] & feats.valid & ~pts_ok)
    X = _triangulate_pair_grid(feats.obs[a], feats.obs[b], pair,
                               R_all[a], t_all[a], R_all[b], t_all[b])
    good = pair & (_depth_in(R_all[a], t_all[a], X) > 0.1) \
                & (_depth_in(R_all[b], t_all[b], X) > 0.1)
    return jnp.where(good[:, None], X, pts_w), pts_ok | good


@jax.jit
def _sfm_pnp_j(feats, R_all, t_all, pts_w, pts_ok, f, init_from, max_msr):
    usable = feats.mask[f] & pts_ok
    p0 = t_all[init_from]
    q0 = lie.rotmat_to_quat(R_all[init_from])
    p, q, msr = ransac_mod.pnp_gn(pts_w, feats.obs[f], usable, p0, q0,
                                  iters=12)
    n_use = jnp.sum(usable)
    ok = (n_use >= 6) & jnp.isfinite(msr) & (msr <= max_msr)
    R_new = jnp.where(ok, lie.quat_to_rotmat(q), R_all[f])
    t_new = jnp.where(ok, p, t_all[f])
    return R_all.at[f].set(R_new), t_all.at[f].set(t_new), ok


def global_sfm(feats: FeatureTable, l: int, R_rel: jax.Array,
               t_rel: jax.Array, cfg: VinsConfig
               ) -> Tuple[Optional[SfmResult], InitStatus]:
    """Vision-only structure from motion over the init window.

    Frame l is the world anchor; the newest frame's pose comes from the
    essential decomposition (x_new = R_rel x_l + t_rel with x in camera
    coords, so R_wc[newest] = R_relᵀ, t_wc[newest] = -R_relᵀ t_rel).
    Chains PnP forward l→newest and backward l→0 with triangulation sweeps,
    then runs a full LM bundle adjustment (poses + points).
    Mirrors GlobalSFM::construct (inital_sfm.cpp:117-316).
    """
    F, M = feats.mask.shape
    newest = F - 1
    obs = feats.obs

    # Stacked pose arrays with traced-index updates: every tri()/pnp() call
    # shares ONE module-level compiled program regardless of which frames
    # it touches or which init invocation runs it (a Python-unrolled
    # version recompiles per frame pair; a closure-jitted one recompiles
    # per bootstrap).
    R_all = jnp.tile(jnp.eye(3)[None], (F, 1, 1))
    t_all = jnp.zeros((F, 3))
    R_all = R_all.at[newest].set(R_rel.T)
    t_all = t_all.at[newest].set(-R_rel.T @ t_rel)

    pts_w = jnp.zeros((M, 3))
    pts_ok = jnp.zeros((M,), bool)

    def tri(a, b):
        nonlocal pts_w, pts_ok
        pts_w, pts_ok = _sfm_tri_j(feats, R_all, t_all, pts_w, pts_ok,
                                   jnp.asarray(a), jnp.asarray(b))

    def pnp(f, init_from):
        nonlocal R_all, t_all
        R_all, t_all, ok = _sfm_pnp_j(feats, R_all, t_all, pts_w, pts_ok,
                                      jnp.asarray(f), jnp.asarray(init_from),
                                      jnp.asarray(cfg.init_pnp_max_msr))
        return bool(ok)

    # Two-view seed.
    tri(l, newest)
    # Forward chain l+1 .. newest-1.
    for f in range(l + 1, newest):
        if not pnp(f, f - 1):
            return None, InitStatus.FAIL_PNP
        tri(f, newest)
    # Sweep: triangulate everything seen with frame l.
    for f in range(l + 1, newest):
        tri(l, f)
    # Backward chain l-1 .. 0.
    for f in range(l - 1, -1, -1):
        if not pnp(f, f + 1):
            return None, InitStatus.FAIL_PNP
        tri(f, l)
    # Final sweep: remaining points from consecutive-frame pairs.
    for f in range(F - 1):
        tri(f, f + 1)

    if int(jnp.sum(pts_ok)) < 15:
        return None, InitStatus.FAIL_SFM

    # ---- Full bundle adjustment (inital_sfm.cpp:234-293) ---------------
    q0 = lie.rotmat_to_quat(R_all)
    t0 = t_all

    obs_w = (feats.mask & feats.valid[None, :] & pts_ok[None, :])
    w = obs_w.astype(jnp.float32)

    def residual(tw, qw, X):
        # [F, M, 2] masked reprojection residuals.
        Xc = jax.vmap(lambda q, t: lie.quat_rotate(
            lie.quat_conj(q)[None], X - t[None]))(qw, tw)      # [F,M,3]
        z = jnp.where(jnp.abs(Xc[..., 2:3]) < 1e-6, 1e-6, Xc[..., 2:3])
        return (Xc[..., :2] / z - obs) * w[..., None]

    def pack_residual(delta):
        # delta: [F*6 + M*3]; frame l pose fixed (gauge anchor).
        d_pose = delta[:F * 6].reshape(F, 6)
        free = jnp.ones((F, 1)).at[l].set(0.0)
        d_pose = d_pose * free
        tw, qw = lie.pose_retract(t0, q0, d_pose)
        X = pts_w + delta[F * 6:].reshape(M, 3)
        return residual(tw, qw, X).reshape(-1)

    @jax.jit
    def ba_step(delta, lam):
        r = pack_residual(delta)
        J = jax.jacfwd(pack_residual)(delta)
        H = J.T @ J
        g = J.T @ r
        dn = jnp.linalg.solve(
            H + lam * (jnp.diag(jnp.diagonal(H)) + 1e-6 * jnp.eye(H.shape[0])),
            -g)
        cand = delta + dn
        c2 = jnp.sum(pack_residual(cand) ** 2)
        return cand, c2

    delta = jnp.zeros(F * 6 + M * 3)
    lam = 1e-3
    cost = float(jnp.sum(pack_residual(delta) ** 2))
    for _ in range(10):
        cand, c2_j = ba_step(delta, jnp.asarray(lam))
        c2 = float(c2_j)
        if np.isfinite(c2) and c2 < cost:
            delta, cost, lam = cand, c2, max(lam * 0.3, 1e-7)
        else:
            lam = min(lam * 10.0, 1e3)
    mean_sq = cost / max(float(jnp.sum(w)), 1.0)
    if not np.isfinite(mean_sq) or mean_sq > 1e-3:
        return None, InitStatus.FAIL_SFM

    d_pose = delta[:F * 6].reshape(F, 6) * jnp.ones((F, 1)).at[l].set(0.0)
    t_fin, q_fin = lie.pose_retract(t0, q0, d_pose)
    return SfmResult(
        R_wc=lie.quat_to_rotmat(q_fin), t_wc=t_fin,
        pts_w=pts_w + delta[F * 6:].reshape(M, 3), pts_ok=pts_ok
    ), InitStatus.SUCCESS


# ---------------------------------------------------------------------------
# Visual-inertial alignment (initial_aligment.cpp)
# ---------------------------------------------------------------------------


def solve_gyro_bias(q_bodies: jax.Array, preints: pre_mod.Preintegration
                    ) -> jax.Array:
    """Least-squares gyro bias from rotation consistency over edges
    (solveGyroscopeBias, initial_aligment.cpp:10-44)."""
    F = q_bodies.shape[0]
    W = F - 1

    def edge(e):
        J = preints.jacobian[e][pre_mod.O_R:pre_mod.O_R + 3,
                                pre_mod.O_BG:pre_mod.O_BG + 3]
        q_ij = lie.quat_mul(lie.quat_conj(q_bodies[e]), q_bodies[e + 1])
        dq = lie.quat_mul(lie.quat_conj(preints.dq[e]), q_ij)
        r = 2.0 * dq[1:]
        return J.T @ J, J.T @ r

    A, b = jax.vmap(edge)(jnp.arange(W))
    A = jnp.sum(A, axis=0) + 1e-8 * jnp.eye(3)
    b = jnp.sum(b, axis=0)
    return jnp.linalg.solve(A, b)


def linear_alignment(p_cam: jax.Array, R_body: jax.Array,
                     preints: pre_mod.Preintegration, tic_body: jax.Array,
                     g_mag: float):
    """Linear solve for per-frame velocities (body frame), gravity (in the
    SfM world), and metric scale (SolveScale, initial_aligment.cpp:135-219;
    scale column conditioned by /100 as :162).

    p_cam: [F,3] un-scaled SfM *camera* positions in the c0 frame — the
    scale multiplies these, while the camera-IMU lever arm stays metric and
    enters the residual as R_iᵀR_j·tic − tic (initial_aligment.cpp:150-160).
    R_body: [F,3,3] body orientations in the c0 frame.
    Returns (v_body [F,3], g_c0 [3], scale, ok).
    """
    F = p_cam.shape[0]
    W = F - 1
    n = 3 * F + 3 + 1
    A = jnp.zeros((n, n))
    b = jnp.zeros((n,))

    for e in range(W):
        dt = preints.sum_dt[e]
        Ri = R_body[e].T
        H = jnp.zeros((6, 10))
        z = jnp.zeros((6,))
        # Position row block.
        H = H.at[0:3, 0:3].set(-dt * jnp.eye(3))
        H = H.at[0:3, 6:9].set(0.5 * Ri @ jnp.eye(3) * dt * dt)
        H = H.at[0:3, 9].set((Ri @ (p_cam[e + 1] - p_cam[e])) / 100.0)
        z = z.at[0:3].set(preints.dp[e] + Ri @ R_body[e + 1] @ tic_body
                          - tic_body)
        # Velocity row block.
        H = H.at[3:6, 0:3].set(-jnp.eye(3))
        H = H.at[3:6, 3:6].set(Ri @ R_body[e + 1])
        H = H.at[3:6, 6:9].set(Ri * dt)
        z = z.at[3:6].set(preints.dv[e])

        idx = jnp.concatenate([
            3 * e + jnp.arange(3), 3 * (e + 1) + jnp.arange(3),
            3 * F + jnp.arange(4)])
        A = A.at[idx[:, None], idx[None, :]].add(H.T @ H * 1000.0)
        b = b.at[idx].add(H.T @ z * 1000.0)

    x = jnp.linalg.solve(A + 1e-8 * jnp.eye(n), b)
    v = x[:3 * F].reshape(F, 3)
    g_c0 = x[3 * F:3 * F + 3]
    scale = x[3 * F + 3] / 100.0
    ok = (jnp.abs(jnp.linalg.norm(g_c0) - g_mag) < 1.0) & (scale > 0)
    return v, g_c0, scale, ok


def refine_gravity(p_cam, R_body, preints, tic_body, g_mag, g0,
                   iters: int = 4):
    """Refine gravity on its 2-dof tangent (RefineGravity,
    initial_aligment.cpp:62-133). Returns (v, g, scale)."""
    F = p_cam.shape[0]
    W = F - 1
    g = g0 / jnp.linalg.norm(g0) * g_mag
    v = jnp.zeros((F, 3))
    scale = jnp.asarray(1.0)
    for _ in range(iters):
        # Tangent basis of g.
        a = g / jnp.linalg.norm(g)
        tmp = jnp.where(jnp.abs(a[2]) > 0.9, jnp.array([1.0, 0.0, 0.0]),
                        jnp.array([0.0, 0.0, 1.0]))
        b1 = jnp.cross(a, tmp)
        b1 = b1 / jnp.linalg.norm(b1)
        b2 = jnp.cross(a, b1)
        basis = jnp.stack([b1, b2], axis=1)  # [3,2]

        n = 3 * F + 2 + 1
        A = jnp.zeros((n, n))
        bb = jnp.zeros((n,))
        for e in range(W):
            dt = preints.sum_dt[e]
            Ri = R_body[e].T
            H = jnp.zeros((6, 9))
            z = jnp.zeros((6,))
            H = H.at[0:3, 0:3].set(-dt * jnp.eye(3))
            H = H.at[0:3, 6:8].set(0.5 * Ri @ basis * dt * dt)
            H = H.at[0:3, 8].set((Ri @ (p_cam[e + 1] - p_cam[e])) / 100.0)
            z = z.at[0:3].set(preints.dp[e] + Ri @ R_body[e + 1] @ tic_body
                              - tic_body - 0.5 * Ri @ g * dt * dt)
            H = H.at[3:6, 0:3].set(-jnp.eye(3))
            H = H.at[3:6, 3:6].set(Ri @ R_body[e + 1])
            H = H.at[3:6, 6:8].set(Ri @ basis * dt)
            z = z.at[3:6].set(preints.dv[e] - Ri @ g * dt)

            idx = jnp.concatenate([
                3 * e + jnp.arange(3), 3 * (e + 1) + jnp.arange(3),
                3 * F + jnp.arange(3)])
            A = A.at[idx[:, None], idx[None, :]].add(H.T @ H * 1000.0)
            bb = bb.at[idx].add(H.T @ z * 1000.0)

        x = jnp.linalg.solve(A + 1e-8 * jnp.eye(n), bb)
        dg = basis @ x[3 * F:3 * F + 2]
        g = (g + dg) / jnp.linalg.norm(g + dg) * g_mag
        v = x[:3 * F].reshape(F, 3)
        scale = x[3 * F + 2] / 100.0
    return v, g, scale


_REFINE_REL_TOL = 1e-4
_REFINE_MAX_ROUNDS = 40


def refine_init_window(window: WindowState, feats: FeatureTable,
                       chunks: pre_mod.ImuChunk, ext: Extrinsics,
                       cfg: VinsConfig):
    """Joint visual-inertial refinement of the freshly aligned window —
    the reference's accepting solve_ceres after visualInitialAlign
    (VINS.cpp:415-443). The caller gates acceptance on the final cost
    (≤ cfg.init_max_cost, VINS.cpp:416).

    The metric scale sits in a long LM valley (coherent expansion of all
    positions, velocities and depths). The linear alignment's scale is
    biased toward zero when the SfM positions are noisy and the window's
    motion is nearly constant-acceleration (on a 1 s arc of a steady
    circle, 2 mm of SfM position noise drags it from 0.98 to ~0.4), and
    the sliding window never corrects a scale it is started with. So the
    solve/re-triangulate rounds run until one improves the cost by less
    than _REFINE_REL_TOL (at most _REFINE_MAX_ROUNDS of them):
    three fixed rounds left the bench stream's scale 30 % off, and run to
    convergence it is 3 % off.

    Returns (window, final_cost).
    """
    F = cfg.window.num_frames
    W = F - 1
    dtype = window.p.dtype
    gravity = jnp.array([0.0, 0.0, cfg.imu.gravity], dtype)

    def one_round(window):
        preints = jax.vmap(
            lambda c, ba, bg: pre_mod.propagate(c, ba, bg, cfg.imu)
        )(chunks, window.ba[:W], window.bg[:W])
        prob = WindowProblem(
            feats=feats, preints=preints, prior=PriorFactor.empty(F),
            ext=ext, gravity=gravity,
            sqrt_info_proj=jnp.asarray(cfg.camera.focal / 1.5),
            frame_free=jnp.ones(F, dtype))
        window, stats = solve_window(window, prob, cfg)
        return fm.triangulate(window, feats, ext, cfg), stats.final_cost

    def cond(carry):
        r, _, cost, prev = carry
        return (r < _REFINE_MAX_ROUNDS) & (
            prev - cost > _REFINE_REL_TOL * jnp.maximum(cost, 1.0))

    def body(carry):
        r, window, cost, _ = carry
        window, new_cost = one_round(window)
        return r + 1, window, new_cost, cost

    window, cost = one_round(window)
    _, window, cost, _ = jax.lax.while_loop(
        cond, body, (jnp.ones((), jnp.int32), window, cost,
                     jnp.asarray(jnp.inf, dtype)))
    return window, cost


@jax.jit
def _camera_relative_rotation(dq_edges: jax.Array, l: jax.Array,
                              newest: jax.Array, ext: Extrinsics
                              ) -> jax.Array:
    """Gyro-preintegrated CAMERA rotation from frame l to `newest`:
    compose the per-edge body increments dq_e over e ∈ [l, newest), then
    conjugate by the extrinsic rotation. Convention matches recover_pose:
    x_newest ≈ R · x_l (camera frames)."""
    W = dq_edges.shape[0]

    def step(q, e):
        use = (e >= l) & (e < newest)
        q2 = lie.quat_mul(q, dq_edges[e])
        return jnp.where(use, q2, q), None

    q_rel, _ = jax.lax.scan(step, lie.quat_identity(dq_edges.dtype),
                            jnp.arange(W))
    R_b = lie.quat_to_rotmat(q_rel)        # body l → body newest (passive)
    R_ic = lie.quat_to_rotmat(ext.qic)
    # x_cam_newest = R_icᵀ R_bᵀ R_ic x_cam_l.
    return R_ic.T @ R_b.T @ R_ic


@jax.jit
def _imu_excitation_j(dv: jax.Array, sum_dt: jax.Array) -> jax.Array:
    """Stddev of per-edge mean specific force (delta_v / dt) over edges
    with nonzero span (the reference's aver_g/var check, VINS.cpp:839-858)."""
    ok = sum_dt > 1e-6
    g_edge = dv / jnp.maximum(sum_dt[:, None], 1e-6)        # [W, 3]
    n = jnp.maximum(jnp.sum(ok), 1)
    mean_g = jnp.sum(jnp.where(ok[:, None], g_edge, 0.0), axis=0) / n
    d2 = jnp.sum((g_edge - mean_g) ** 2, axis=-1)
    var = jnp.sum(jnp.where(ok, d2, 0.0)) / n
    return jnp.sqrt(var)


def imu_excitation(chunks: pre_mod.ImuChunk, cfg: VinsConfig) -> float:
    """Host-facing excitation statistic for a stacked [W]-edge chunk set."""
    pre = jax.vmap(lambda c: pre_mod.propagate(
        c, jnp.zeros(3), jnp.zeros(3), cfg.imu))(chunks)
    return float(_imu_excitation_j(pre.dv, pre.sum_dt))


# Module-level jitted wrappers: one compile per process, not per init call.
_solve_gyro_bias_j = jax.jit(solve_gyro_bias)
_linear_alignment_j = jax.jit(linear_alignment, static_argnames=("g_mag",))
_refine_gravity_j = jax.jit(refine_gravity, static_argnames=("g_mag", "iters"))


# ---------------------------------------------------------------------------
# Full initialization pipeline
# ---------------------------------------------------------------------------


class InitResult(NamedTuple):
    window: WindowState
    status: InitStatus


def initialize(feats: FeatureTable, chunks: pre_mod.ImuChunk,
               ext: Extrinsics, cfg: VinsConfig,
               seed: int = 0) -> InitResult:
    """Bootstrap the full metric window state from observations + raw IMU.

    Follows VINS::solveInitial + visualInitialAlign (VINS.cpp:833-1102):
    SfM in the camera-l frame, gyro-bias estimation + repropagation, linear
    alignment for velocity/gravity/scale, then rotation of the world so
    gravity is +z with zero initial yaw, scaling, and depth triangulation.
    The caller runs the accepting window solve (estimator handles that).
    """
    F, M = feats.mask.shape
    newest = F - 1
    fail = lambda s: InitResult(WindowState.identity(F, M), s)

    # 0. IMU excitation gate (VINS.cpp:839-858): stddev of the per-edge
    #    mean specific force Δv/Δt across the window. A static/constant-
    #    velocity window leaves scale unobservable; reject before paying
    #    for SfM + alignment. The zero-bias preintegration is reused by
    #    the gyro-bias solve in step 4.
    pre0 = jax.vmap(lambda c: pre_mod.propagate(
        c, jnp.zeros(3), jnp.zeros(3), cfg.imu))(chunks)
    if cfg.init_min_acc_var > 0:
        acc_var = float(_imu_excitation_j(pre0.dv, pre0.sum_dt))
        if not np.isfinite(acc_var) or acc_var < cfg.init_min_acc_var:
            return fail(InitStatus.FAIL_IMU)

    # 1. Reference frame + relative pose.
    l, ok = find_reference_frame(feats, cfg.camera.focal)
    if not ok:
        return fail(InitStatus.FAIL_PARALLAX)
    pair = feats.mask[l] & feats.mask[newest] & feats.valid
    key = jax.random.PRNGKey(seed)
    res = ransac_mod.ransac_essential(
        feats.obs[l], feats.obs[newest], pair, key,
        cfg.frontend.f_ransac_hyps, (1.0 / cfg.camera.focal) ** 2 * 9.0)
    R_rel, t_rel, n_good = ransac_mod.recover_pose(
        res.model, feats.obs[l], feats.obs[newest], res.inliers)

    # Planar-degeneracy guard: the 8-point essential has a solution
    # family on coplanar scenes (where the reference's 5-point does not,
    # motion_estimator.cpp:203) and can return a confidently-wrong
    # rotation. A VIO system carries a gyro: the preintegrated relative
    # rotation l→newest (bias-free to first order over the short boot
    # window) is structure-independent. If the visual rotation disagrees
    # with it, re-seed with the gyro rotation + the linear known-rotation
    # translation solve (planar-immune).
    R_gyro = _camera_relative_rotation(pre0.dq, l, newest, ext)
    ang = jnp.linalg.norm(lie.so3_log(lie.rotmat_to_quat(R_rel @ R_gyro.T)))
    if float(ang) > np.deg2rad(cfg.init_max_gyro_visual_deg):
        t_g, n_good_g = ransac_mod.translation_known_rotation(
            R_gyro, feats.obs[l], feats.obs[newest], res.inliers)
        R_rel, t_rel, n_good = R_gyro, t_g, n_good_g
    if int(n_good) < 12:
        return fail(InitStatus.FAIL_RELATIVE)

    # 2. Global SfM (camera poses in frame-l camera world).
    sfm, status = global_sfm(feats, l, R_rel, t_rel, cfg)
    if sfm is None:
        return fail(status)

    # 3. Body poses in the SfM world: T_wb = T_wc · T_cb, with
    #    T_cb = (R_icᵀ, -R_icᵀ t_ic).
    R_ic = lie.quat_to_rotmat(ext.qic)
    R_body = sfm.R_wc @ R_ic.T                                   # [F,3,3]
    p_cam = sfm.t_wc                                             # un-scaled

    # 4. Gyro bias + repropagation (pre0 from step 0).
    q_body = lie.rotmat_to_quat(R_body)
    bg = _solve_gyro_bias_j(q_body, pre0)
    if float(jnp.linalg.norm(bg)) > 1.0:
        return fail(InitStatus.FAIL_ALIGN)
    pre1 = jax.vmap(lambda c: pre_mod.propagate(
        c, jnp.zeros(3), bg, cfg.imu))(chunks)

    # 5. Linear alignment: velocities, gravity (SfM frame), metric scale.
    v_b, g_c0, scale, align_ok = _linear_alignment_j(
        p_cam, R_body, pre1, ext.tic, cfg.imu.gravity)
    if not bool(align_ok):
        return fail(InitStatus.FAIL_ALIGN)
    v_b, g_c0, scale = _refine_gravity_j(
        p_cam, R_body, pre1, ext.tic, cfg.imu.gravity, g_c0)
    if float(scale) <= 0:
        return fail(InitStatus.FAIL_ALIGN)

    # 6. Rotate world so gravity is +z, zero yaw at frame 0; apply scale.
    #    (visualInitialAlign, VINS.cpp:1046-1099)
    R0 = lie.gravity_to_rotmat(g_c0)         # R0 @ ĝ = +z
    yaw0 = lie.rotmat_to_ypr(R0 @ R_body[0])[0]
    Ryaw = lie.ypr_to_rotmat(jnp.stack([-yaw0, jnp.zeros(()), jnp.zeros(())]))
    Rw = Ryaw @ R0

    # Metric body positions: s·p_cam − R_wb·tic (VINS.cpp:1050-1053), then
    # re-expressed in the gravity-aligned world and zeroed at frame 0.
    p_b_metric = scale * p_cam - jnp.einsum("fij,j->fi", R_body, ext.tic)
    p_w = jnp.einsum("ij,fj->fi", Rw, p_b_metric)
    p_w = p_w - p_w[0:1]
    R_w = jnp.einsum("ij,fjk->fik", Rw, R_body)
    # Velocities were solved in body frames: v_world = R_wb v_b.
    v_w = jnp.einsum("fij,fj->fi", R_w, v_b)

    window = WindowState(
        p=p_w, q=lie.rotmat_to_quat(R_w), v=v_w,
        ba=jnp.zeros((F, 3)), bg=jnp.tile(bg[None], (F, 1)),
        inv_depth=jnp.zeros((M,)))
    window = fm.triangulate(window, feats, ext, cfg)
    return InitResult(window, InitStatus.SUCCESS)
