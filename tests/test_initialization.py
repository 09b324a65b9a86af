"""Automatic initialization tests (SURVEY.md §7.2 stage 6): recover known
scale, gravity direction, velocities, and relative poses on synthetic data
with NO ground-truth state provided."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vins_tpu.config import VinsConfig
from vins_tpu.core import preintegration as pre_mod
from vins_tpu.core.initialization import (InitStatus, initialize,
                                          find_reference_frame, global_sfm,
                                          solve_gyro_bias)
from vins_tpu.io.synthetic import make_synthetic_window
from vins_tpu.utils import lie

CFG = VinsConfig()
F = CFG.window.num_frames


@pytest.fixture(scope="module")
def syn():
    return make_synthetic_window(CFG, n_landmarks=128, seed=11)


def test_find_reference_frame(syn):
    l, ok = find_reference_frame(syn.feats, CFG.camera.focal)
    assert ok
    assert 0 <= l < F - 1


def test_gyro_bias_recovery(syn):
    # Corrupt the gyro with a constant bias; solver must recover it.
    bias = jnp.array([0.02, -0.01, 0.015])
    chunks = syn.chunks._replace(gyr=syn.chunks.gyr + bias[None, None, :])
    pre0 = jax.vmap(lambda c: pre_mod.propagate(
        c, jnp.zeros(3), jnp.zeros(3), CFG.imu))(chunks)
    bg = solve_gyro_bias(syn.state.q, pre0)
    np.testing.assert_allclose(np.asarray(bg), np.asarray(bias), atol=2e-3)


@pytest.mark.slow
def test_full_initialization_recovers_metric_state(syn):
    res = initialize(syn.feats, syn.chunks, syn.ext, CFG)
    assert res.status == InitStatus.SUCCESS
    win = res.window
    gt = syn.state

    # Scale: pairwise distances must match ground truth.
    d_est = np.linalg.norm(np.asarray(win.p[1:]) - np.asarray(win.p[:-1]),
                           axis=-1)
    d_gt = np.linalg.norm(np.asarray(gt.p[1:]) - np.asarray(gt.p[:-1]),
                          axis=-1)
    np.testing.assert_allclose(d_est, d_gt, rtol=0.05)

    # Gravity alignment: roll/pitch of every frame matches GT (yaw is gauge).
    ypr_est = np.asarray(lie.rotmat_to_ypr(lie.quat_to_rotmat(win.q)))
    ypr_gt = np.asarray(lie.rotmat_to_ypr(lie.quat_to_rotmat(gt.q)))
    np.testing.assert_allclose(ypr_est[:, 1:], ypr_gt[:, 1:], atol=0.02)

    # Relative poses in the frame-0 body frame match GT.
    R0e = np.asarray(lie.quat_to_rotmat(win.q[0]))
    R0g = np.asarray(lie.quat_to_rotmat(gt.q[0]))
    rel_e = np.einsum("ji,fj->fi", R0e,
                      np.asarray(win.p) - np.asarray(win.p[0]))
    rel_g = np.einsum("ji,fj->fi", R0g,
                      np.asarray(gt.p) - np.asarray(gt.p[0]))
    np.testing.assert_allclose(rel_e, rel_g, atol=0.05)

    # Velocities: magnitudes match (direction up to yaw gauge).
    v_est = np.linalg.norm(np.asarray(win.v), axis=-1)
    v_gt = np.linalg.norm(np.asarray(gt.v), axis=-1)
    np.testing.assert_allclose(v_est, v_gt, rtol=0.08)

    # Depths triangulated for most valid features.
    valid = np.asarray(syn.feats.valid)
    assert (np.asarray(win.inv_depth)[valid] > 0).mean() > 0.9


@pytest.mark.slow
def test_initialization_rejects_degenerate_motion():
    """Pure rotation (no translation) must be rejected (no parallax)."""
    syn = make_synthetic_window(CFG, n_landmarks=128, seed=12,
                                frame_dt=0.001)  # ~zero baseline
    res = initialize(syn.feats, syn.chunks, syn.ext, CFG)
    assert res.status != InitStatus.SUCCESS


def test_low_excitation_raises_fail_imu():
    """A constant-velocity (zero specific-force-variance) boot window must
    be rejected with FAIL_IMU before SfM (reference check VINS.cpp:839-858)."""
    syn = make_synthetic_window(CFG, n_landmarks=128, seed=9)
    S = syn.chunks.dt.shape[1]
    W = F - 1
    # Straight-line constant velocity: accel = +g only, no rotation.
    g = CFG.imu.gravity
    chunks = pre_mod.ImuChunk(
        dt=syn.chunks.dt,
        acc=jnp.tile(jnp.array([0.0, 0.0, g]), (W, S, 1)),
        gyr=jnp.zeros((W, S, 3)))
    res = initialize(syn.feats, chunks, syn.ext, CFG)
    assert res.status == InitStatus.FAIL_IMU


def test_excited_window_passes_imu_gate():
    """The standard synthetic circle must NOT trip the excitation gate."""
    from vins_tpu.core.initialization import imu_excitation

    syn = make_synthetic_window(CFG, n_landmarks=128, seed=11)
    assert imu_excitation(syn.chunks, CFG) > CFG.init_min_acc_var


def test_planar_scene_init_is_safe():
    """All landmarks on a single plane: the 8-point essential is
    degenerate there (the reference's Nister 5-point is not,
    motion_estimator.cpp:203). The system-level contract is graceful
    degradation: the SfM reprojection and alignment gates must reject a
    wrong-geometry bootstrap — initialization either succeeds with
    correct metric geometry or fails with a FAIL_* status, never accepts
    garbage."""
    import dataclasses

    syn = make_synthetic_window(CFG, n_landmarks=120, seed=31)
    # Flatten all landmarks onto z = 0.5 and rebuild observations.
    lms = np.array(syn.landmarks)
    lms[:, 2] = 0.5
    from vins_tpu.utils import lie as lie_mod
    Rwb = np.asarray(lie_mod.quat_to_rotmat(syn.state.q))
    R_ic = np.asarray(lie_mod.quat_to_rotmat(syn.ext.qic))
    t_ic = np.asarray(syn.ext.tic)
    F_ = CFG.window.num_frames
    M = CFG.window.max_landmarks
    obs = np.zeros((F_, M, 2), np.float32)
    mask = np.zeros((F_, M), bool)
    n = len(lms)
    for f in range(F_):
        pb = (lms - np.asarray(syn.state.p[f])) @ Rwb[f]
        pc = (pb - t_ic) @ R_ic
        z = pc[:, 2]
        ok = z > 0.3
        xy = pc[:, :2] / np.maximum(z[:, None], 1e-6)
        ok &= (np.abs(xy) < 0.7).all(1)
        obs[f, :n] = xy
        mask[f, :n] = ok
    first = np.argmax(mask, axis=0).astype(np.int32)
    valid = mask.sum(0) >= 2
    feats = syn.feats._replace(
        obs=jnp.asarray(obs), mask=jnp.asarray(mask),
        anchor=jnp.asarray(first), valid=jnp.asarray(valid),
        track_id=jnp.asarray(np.where(valid, np.arange(M), -1),
                             dtype=jnp.int32))

    res = initialize(feats, syn.chunks, syn.ext, CFG)
    if res.status == InitStatus.SUCCESS:
        # Accepting is fine ONLY if the geometry is right (init fixes its
        # own gauge at frame 0 — compare aligned, and require the metric
        # scale to be honest).
        from vins_tpu.io import evaluate

        a = evaluate.ate_rmse(np.asarray(res.window.p),
                              np.asarray(syn.state.p))
        assert a.rmse < 0.1, (res.status, a.rmse)
        a_s = evaluate.ate_rmse(np.asarray(res.window.p),
                                np.asarray(syn.state.p), with_scale=True)
        assert abs(a_s.s - 1.0) < 0.15, a_s.s


def test_refinement_recovers_metric_scale_from_noisy_features():
    """On a 1 s boot window of a steady circle the linear alignment's
    scale collapses under feature noise (the motion is nearly constant-
    acceleration); refine_init_window must walk the LM valley back to
    metric scale. Three fixed rounds stopped at a scale factor of 1.40
    on this window; run to convergence it reaches 1.06."""
    from vins_tpu.core import feature_manager as fm
    from vins_tpu.core.initialization import refine_init_window
    from vins_tpu.core.state import FeatureTable
    from vins_tpu.io import evaluate
    from vins_tpu.io.synthetic import make_synthetic_sequence

    seq = make_synthetic_sequence(
        CFG, n_frames=F, n_landmarks=300, seed=7, noise_px=0.5,
        frame_dt=0.1, traj_kwargs=dict(w=0.7, bob=0.15), imu_per_frame=12)
    feats = FeatureTable.empty(F, CFG.window.max_landmarks)
    for f in range(F):
        feats = fm.ingest_frame(feats, jnp.asarray(f), seq.ids[f],
                                seq.obs[f], seq.obs_valid[f])
    chunks = jax.tree.map(lambda x: x[1:], seq.chunks)
    res = initialize(feats, chunks, seq.ext, CFG)
    assert res.status == InitStatus.SUCCESS
    win, cost = jax.jit(lambda w: refine_init_window(
        w, feats, chunks, seq.ext, CFG))(res.window)
    assert float(cost) <= CFG.init_max_cost
    fit = evaluate.ate_rmse(np.asarray(win.p), np.asarray(seq.p),
                            with_scale=True)
    assert abs(fit.s - 1.0) < 0.15, f"metric scale off: {fit.s}"
    assert fit.rmse < 0.02
