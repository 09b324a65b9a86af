"""4-DoF (x, y, z, yaw) pose-graph optimization.

Re-design of KeyFrameDatabase::optimize4DoFLoopPoseGraph
(VINS_ios/keyfame_database.cpp:140-356): per-node variables are yaw + t,
with roll/pitch frozen at their VIO values (gravity makes them
observable, so only 4 DoF drift — the reference's AngleLocalParameterization
+ FourDOFError/FourDOFWeightError, keyfame_database.h:74-360).

Edges:
  * sequential — each node to its ≤5 predecessors, relative translation
    expressed in the earlier node's full frame (keyfame_database.cpp:239);
  * loop — weighted relative-pose constraints from verified detections.

Static-shape discipline: fixed capacity K nodes and fixed edge tables with
validity weights; the whole LM loop is one jitted `lax.scan`, so repeated
pose-graph solves (every loop closure) never recompile.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..utils import lie


class PoseGraph(NamedTuple):
    """Fixed-capacity 4-DoF pose graph."""

    t: jax.Array          # [K, 3] node translations (world, optimized)
    yaw: jax.Array        # [K] node yaw (radians, optimized)
    pitch: jax.Array      # [K] frozen pitch
    roll: jax.Array       # [K] frozen roll
    node_ok: jax.Array    # [K] bool — slot holds a node
    # ORIGIN (raw odometry) poses: sequential-edge measurements derive
    # from THESE, exactly like the reference builds chain edges from
    # getOriginPose (keyfame_database.cpp:239). Deriving them from the
    # already-optimized t/yaw instead lets every optimize() re-measure
    # its own output — repeated runs then compound the loop constraints
    # and the solution wanders (measured 0.7 m after 12 runs on the
    # revisit fixture while per-run drift stayed ~0).
    t_origin: jax.Array   # [K, 3]
    yaw_origin: jax.Array  # [K]
    # Loop edges (fixed table, weight 0 = inactive).
    loop_i: jax.Array     # [E] int32 — earlier (old) node
    loop_j: jax.Array     # [E] int32 — later (new) node
    loop_t: jax.Array     # [E, 3] measured t_ij in node i's frame
    loop_yaw: jax.Array   # [E] measured relative yaw
    loop_w: jax.Array     # [E] weight (0 = inactive)

    @staticmethod
    def empty(K: int, E: int, dtype=jnp.float32) -> "PoseGraph":
        return PoseGraph(
            t=jnp.zeros((K, 3), dtype), yaw=jnp.zeros((K,), dtype),
            pitch=jnp.zeros((K,), dtype), roll=jnp.zeros((K,), dtype),
            node_ok=jnp.zeros((K,), bool),
            t_origin=jnp.zeros((K, 3), dtype),
            yaw_origin=jnp.zeros((K,), dtype),
            loop_i=jnp.zeros((E,), jnp.int32),
            loop_j=jnp.zeros((E,), jnp.int32),
            loop_t=jnp.zeros((E, 3), dtype),
            loop_yaw=jnp.zeros((E,), dtype),
            loop_w=jnp.zeros((E,), dtype))


def _node_rot(yaw, pitch, roll):
    return lie.ypr_to_rotmat(jnp.stack([yaw, pitch, roll]))


def sequential_measurements(g: PoseGraph, n_back: int = 5):
    """Relative (t_ij in frame i, yaw_ij) for each node j to its ≤n_back
    predecessors, measured from the ORIGIN (raw odometry) poses — NOT
    the optimized values (reference keyfame_database.cpp:239 builds the
    chain from getOriginPose; see PoseGraph.t_origin)."""
    K = g.t.shape[0]

    def one(j, d):
        i = j - d
        ok = (i >= 0) & g.node_ok[j] & g.node_ok[jnp.maximum(i, 0)]
        i = jnp.maximum(i, 0)
        Ri = _node_rot(g.yaw_origin[i], g.pitch[i], g.roll[i])
        t_ij = Ri.T @ (g.t_origin[j] - g.t_origin[i])
        yaw_ij = g.yaw_origin[j] - g.yaw_origin[i]
        return i, t_ij, yaw_ij, ok.astype(g.t.dtype)

    js = jnp.repeat(jnp.arange(K), n_back)
    ds = jnp.tile(jnp.arange(1, n_back + 1), K)
    i_all, t_all, yaw_all, w_all = jax.vmap(one)(js, ds)
    return js.astype(jnp.int32), i_all.astype(jnp.int32), t_all, yaw_all, \
        w_all


def optimize_pose_graph(g: PoseGraph, first_loop_node: jax.Array,
                        iters: int = 12, n_back: int = 5
                        ) -> Tuple[PoseGraph, jax.Array]:
    """Jitted LM over (t, yaw); nodes ≤ first_loop_node are fixed
    (the reference fixes the earliest loop node, keyfame_database.cpp:205).
    Returns (optimized graph, final cost)."""
    K = g.t.shape[0]
    dtype = g.t.dtype

    seq_j, seq_i, seq_t, seq_yaw, seq_w = sequential_measurements(g, n_back)

    free = (jnp.arange(K) > first_loop_node) & g.node_ok
    freef = free.astype(dtype)

    t0, yaw0 = g.t, g.yaw

    def unpack(x):
        d = x.reshape(K, 4) * freef[:, None]
        return t0 + d[:, :3], yaw0 + d[:, 3]

    def edge_residual(t, yaw, i, j, t_meas, yaw_meas, w):
        Ri = _node_rot(yaw[i], g.pitch[i], g.roll[i])
        r_t = Ri.T @ (t[j] - t[i]) - t_meas
        r_y = _wrap(yaw[j] - yaw[i] - yaw_meas)
        return jnp.concatenate([r_t, r_y[None]]) * w

    def residuals(x):
        t, yaw = unpack(x)
        r_seq = jax.vmap(
            lambda i, j, tm, ym, w: edge_residual(t, yaw, i, j, tm, ym, w)
        )(seq_i, seq_j, seq_t, seq_yaw, seq_w)
        r_loop = jax.vmap(
            lambda i, j, tm, ym, w: edge_residual(t, yaw, i, j, tm, ym, w)
        )(g.loop_i, g.loop_j, g.loop_t, g.loop_yaw, g.loop_w * 5.0)
        return jnp.concatenate([r_seq.reshape(-1), r_loop.reshape(-1)])

    def cost_of(x):
        r = residuals(x)
        return 0.5 * jnp.sum(r * r)

    def lm_iter(carry, _):
        x, lam, cost = carry
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        H = J.T @ J
        gvec = J.T @ r
        H = H + jnp.diag(lam * jnp.diagonal(H) + 1e-6 + lam)
        L = jnp.linalg.cholesky(H)
        dx = -jax.scipy.linalg.cho_solve((L, True), gvec)
        cand = x + dx
        c2 = cost_of(cand)
        good = jnp.isfinite(c2) & (c2 < cost)
        x = jnp.where(good, cand, x)
        cost = jnp.where(good, c2, cost)
        lam = jnp.clip(jnp.where(good, lam * 0.3, lam * 10.0), 1e-9, 1e3)
        return (x, lam, cost), None

    x0 = jnp.zeros((K * 4,), dtype)
    (x, _, cost), _ = jax.lax.scan(
        lm_iter, (x0, jnp.asarray(1e-4, dtype), cost_of(x0)), None,
        length=iters)
    t_f, yaw_f = unpack(x)
    return g._replace(t=t_f, yaw=yaw_f), cost


def _wrap(a):
    return jnp.arctan2(jnp.sin(a), jnp.cos(a))


def drift_from_solution(g_after: PoseGraph, node: jax.Array):
    """CUMULATIVE yaw/translation drift correction at `node` (reference
    r_drift/t_drift extraction, keyfame_database.cpp:310-330): optimized
    pose vs the ORIGIN (raw odometry) pose, applied to later raw poses
    as p' = R_drift p + t_drift.

    It must be measured against the ORIGIN pose, not the previous
    optimization's value: a per-call delta collapses to identity once
    the graph has converged, silently discarding the accumulated
    correction from the published outputs (found as corrected ATE ==
    raw ATE on the revisit fixture despite a 0.5 m graph correction)."""
    dyaw = _wrap(g_after.yaw[node] - g_after.yaw_origin[node])
    R_drift = lie.ypr_to_rotmat(jnp.stack([dyaw, jnp.zeros_like(dyaw),
                                           jnp.zeros_like(dyaw)]))
    t_drift = g_after.t[node] - R_drift @ g_after.t_origin[node]
    return R_drift, t_drift
