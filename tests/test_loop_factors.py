"""Loop-reprojection factors inside the sliding-window solve.

The reference injects matched old-keyframe observations as projection
factors against a free 'loop pose' parameter block (VINS.cpp:571-637) and
reads the loop relative pose off the SOLVED window (VINS.cpp:663-680);
these tests verify this design's equivalent: the recovered relative
constraint must equal ground truth and be invariant to the window's
accumulated drift (which is exactly what makes it a useful pose-graph
measurement).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vins_tpu.config import VinsConfig
from vins_tpu.core import preintegration as pre_mod
from vins_tpu.core.estimator import (BackendState, FrameInput, LoopInput,
                                     VinsEstimator, backend_step)
from vins_tpu.core.solver import (LoopProblem, WindowProblem,
                                  solve_window_with_loop)
from vins_tpu.core.state import PriorFactor
from vins_tpu.io.synthetic import make_synthetic_window, \
    make_synthetic_sequence
from vins_tpu.utils import lie

CFG = VinsConfig()
F = CFG.window.num_frames
M = CFG.window.max_landmarks


def _project_from(p, q, lms, ext):
    """Normalized obs of world points from a body pose (numpy)."""
    Rwb = np.asarray(lie.quat_to_rotmat(jnp.asarray(q, jnp.float32)))
    R_ic = np.asarray(lie.quat_to_rotmat(ext.qic))
    t_ic = np.asarray(ext.tic)
    pts_b = (np.asarray(lms) - np.asarray(p)) @ Rwb
    pts_c = (pts_b - t_ic) @ R_ic
    z = pts_c[:, 2]
    ok = z > 0.3
    xy = pts_c[:, :2] / np.maximum(z[:, None], 1e-6)
    ok &= (np.abs(xy[:, 0]) < 0.9) & (np.abs(xy[:, 1]) < 0.9)
    return xy.astype(np.float32), ok


def _drift_window(state, dp, dyaw):
    """Apply a rigid 4-DoF drift (what accumulates in real VIO) to a
    ground-truth window."""
    R = np.asarray(lie.ypr_to_rotmat(jnp.asarray([dyaw, 0.0, 0.0],
                                                 jnp.float32)))
    q_fix = lie.rotmat_to_quat(jnp.asarray(R))
    return state._replace(
        p=state.p @ jnp.asarray(R).T + jnp.asarray(dp, jnp.float32),
        q=jax.vmap(lambda q: lie.quat_mul(q_fix, q))(state.q),
        v=state.v @ jnp.asarray(R).T)


def _yaw(q):
    return float(lie.rotmat_to_ypr(lie.quat_to_rotmat(jnp.asarray(q)))[0])


@pytest.fixture(scope="module")
def syn():
    return make_synthetic_window(CFG, n_landmarks=220, seed=7)


def _loop_problem(syn, old_p, old_q):
    """Build the WindowProblem + LoopProblem where the 'old keyframe'
    observes the window's landmarks from (old_p, old_q)."""
    n_lms = syn.landmarks.shape[0]
    tid = np.asarray(syn.feats.track_id)
    valid = np.asarray(syn.feats.valid)
    obs_old = np.zeros((M, 2), np.float32)
    ok = np.zeros((M,), bool)
    xy, vis = _project_from(old_p, old_q, syn.landmarks, syn.ext)
    for m in range(M):
        if valid[m] and 0 <= tid[m] < n_lms and vis[tid[m]]:
            obs_old[m] = xy[tid[m]]
            ok[m] = True
    assert ok.sum() >= 20
    preints = jax.vmap(
        lambda c: pre_mod.propagate(c, jnp.zeros(3), jnp.zeros(3), CFG.imu)
    )(syn.chunks)
    return WindowProblem(
        feats=syn.feats, preints=preints, prior=PriorFactor.empty(F),
        ext=syn.ext, gravity=syn.gravity,
        sqrt_info_proj=jnp.asarray(CFG.camera.focal / 1.5),
        frame_free=jnp.ones(F),
        loop=LoopProblem(obs_old=jnp.asarray(obs_old), ok=jnp.asarray(ok),
                         frame=jnp.asarray(F - 1, jnp.int32),
                         weight=jnp.asarray(1.0)))


def _solve_rel(syn, prob, window):
    lf = F - 1
    lp0, lq0 = window.p[lf], window.q[lf]
    solved, (loop_p, loop_q), stats = jax.jit(
        lambda w, p0, q0, pr: solve_window_with_loop(w, p0, q0, pr, CFG)
    )(window, lp0, lq0, prob)
    R_loop = np.asarray(lie.quat_to_rotmat(loop_q))
    rel_t = R_loop.T @ (np.asarray(solved.p[lf]) - np.asarray(loop_p))
    rel_yaw = _yaw(solved.q[lf]) - _yaw(loop_q)
    return rel_t, rel_yaw, stats


def _old_pose_near(syn, dp=(0.15, -0.1, 0.05), dyaw=0.08):
    """A plausible loop keyframe pose: spatially near the current frame
    (that's what makes a place-recognition match fire) but offset."""
    R = np.asarray(lie.ypr_to_rotmat(jnp.asarray([dyaw, 0.0, 0.0],
                                                 jnp.float32)))
    old_p = np.asarray(syn.state.p[F - 1]) + np.asarray(dp, np.float32)
    old_q = np.asarray(lie.rotmat_to_quat(jnp.asarray(
        R @ np.asarray(lie.quat_to_rotmat(syn.state.q[F - 1])))))
    return old_p, old_q


def test_loop_solve_recovers_relative_pose(syn):
    """Old keyframe near the newest frame → recovered relative pose must
    equal the GT relative between it and frame F-1."""
    old_p, old_q = _old_pose_near(syn)
    prob = _loop_problem(syn, old_p, old_q)
    rel_t, rel_yaw, _ = _solve_rel(syn, prob, syn.state)

    R_old = np.asarray(lie.quat_to_rotmat(jnp.asarray(old_q)))
    rel_t_gt = R_old.T @ (np.asarray(syn.state.p[F - 1]) - old_p)
    rel_yaw_gt = _yaw(syn.state.q[F - 1]) - _yaw(old_q)
    assert np.linalg.norm(rel_t - rel_t_gt) < 0.02, (rel_t, rel_t_gt)
    assert abs(rel_yaw - rel_yaw_gt) < 0.01


def test_loop_constraint_is_drift_invariant(syn):
    """The same old-keyframe observations, but the window carries an
    accumulated 4-DoF drift: the recovered relative constraint must still
    equal the GT relative pose — that drift-invariance is what lets the
    pose graph measure (and remove) the drift. A one-shot PnP against the
    drifted map does NOT have this property at this accuracy, which is
    why the reference refines the constraint through the window solve."""
    old_p, old_q = _old_pose_near(syn)
    prob = _loop_problem(syn, old_p, old_q)

    R_old = np.asarray(lie.quat_to_rotmat(jnp.asarray(old_q)))
    rel_t_gt = R_old.T @ (np.asarray(syn.state.p[F - 1]) - old_p)
    rel_yaw_gt = _yaw(syn.state.q[F - 1]) - _yaw(old_q)

    for dp, dyaw in [((0.3, -0.2, 0.1), 0.06), ((-1.0, 0.5, -0.2), -0.12)]:
        drifted = _drift_window(syn.state, dp, dyaw)
        rel_t, rel_yaw, _ = _solve_rel(syn, prob, drifted)
        assert np.linalg.norm(rel_t - rel_t_gt) < 0.03, (dp, rel_t, rel_t_gt)
        assert abs((rel_yaw - rel_yaw_gt + np.pi) % (2 * np.pi) - np.pi) \
            < 0.015, (dp, rel_yaw, rel_yaw_gt)


def test_loop_inactive_matches_plain_solve(syn):
    """weight=0 loop block must not disturb the solve."""
    from vins_tpu.core.solver import solve_window

    prob = _loop_problem(syn, *_old_pose_near(syn))
    prob0 = prob._replace(
        loop=prob.loop._replace(weight=jnp.asarray(0.0)))
    drifted = _drift_window(syn.state, (0.05, 0.02, -0.01), 0.01)
    s_loop, _, _ = jax.jit(
        lambda w, pr: solve_window_with_loop(
            w, w.p[F - 1], w.q[F - 1], pr, CFG))(drifted, prob0)
    s_plain, _ = jax.jit(
        lambda w, pr: solve_window(w, pr, CFG)
    )(drifted, prob._replace(loop=None))
    np.testing.assert_allclose(np.asarray(s_loop.p), np.asarray(s_plain.p),
                               atol=1e-4)


def test_backend_step_loop_io():
    """Full backend_step with a LoopInput: id re-verification must drop
    stale slots; with matching ids the refined constraint is emitted."""
    from tests.test_estimator import bootstrap_from_sequence

    seq = make_synthetic_sequence(CFG, n_frames=F + 2, n_landmarks=300,
                                  seed=6)
    est = VinsEstimator(CFG, seq.ext)
    bootstrap_from_sequence(seq, est)

    k = F - 1
    lf = F - 2                      # window frame carrying the loop
    # 'Old keyframe' near the loop-carrying frame (GT of seq[lf], offset).
    R = np.asarray(lie.ypr_to_rotmat(jnp.asarray([0.06, 0.0, 0.0],
                                                 jnp.float32)))
    old_p = np.asarray(seq.p[lf]) + np.array([0.12, -0.08, 0.04], np.float32)
    old_q = np.asarray(lie.rotmat_to_quat(jnp.asarray(
        R @ np.asarray(lie.quat_to_rotmat(seq.q[lf])))))
    xy, vis = _project_from(old_p, old_q, seq.landmarks, seq.ext)

    tid = np.asarray(est.state.feats.track_id)
    obs_old = np.zeros((M, 2), np.float32)
    ok = np.zeros((M,), bool)
    n_lms = seq.landmarks.shape[0]
    for m in range(M):
        if 0 <= tid[m] < n_lms and vis[tid[m]]:
            obs_old[m] = xy[tid[m]]
            ok[m] = True
    assert ok.sum() >= 20

    win = est.state.window
    loop = LoopInput(obs_old=jnp.asarray(obs_old), ok=jnp.asarray(ok),
                     ids=jnp.asarray(tid),
                     # Loop pose initialized at the window's estimate of
                     # the loop frame.
                     p_init=win.p[lf], q_init=win.q[lf],
                     ttl=jnp.asarray(F, jnp.int32),
                     weight=jnp.asarray(1.0))
    inp = FrameInput(chunk=jax.tree.map(lambda x: x[k], seq.chunks),
                     ids=seq.ids[k], obs=seq.obs[k],
                     obs_valid=seq.obs_valid[k], loop=loop)
    out = est.process_frame(inp)
    assert not bool(out.failure)
    assert bool(out.loop_good)
    # The refined edge reads against the solved NEWEST window frame
    # (frame k), drift-free here, so expect rel pose old -> frame k.
    R_old = np.asarray(lie.quat_to_rotmat(jnp.asarray(old_q)))
    rel_t_gt = R_old.T @ (np.asarray(seq.p[k]) - old_p)
    rel_yaw_gt = _yaw(seq.q[k]) - _yaw(old_q)
    assert np.linalg.norm(np.asarray(out.loop_rel_t) - rel_t_gt) < 0.05, \
        (np.asarray(out.loop_rel_t), rel_t_gt)
    assert abs(float(out.loop_rel_yaw) - rel_yaw_gt) < 0.02

    # Stale ids (slot churn between detection and injection) must gate out.
    est2 = VinsEstimator(CFG, seq.ext)
    bootstrap_from_sequence(seq, est2)
    loop_stale = loop._replace(ids=jnp.full((M,), 999999, jnp.int32))
    out2 = est2.process_frame(inp._replace(loop=loop_stale))
    assert not bool(out2.loop_good)
