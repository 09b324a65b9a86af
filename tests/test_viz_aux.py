"""Aux subsystem tests: IMU stream sync, Delaunay ground mesh, profiling."""
import numpy as np
import jax.numpy as jnp

from vins_tpu.io.imu_sync import (align_measurements, chunk_imu,
                                  interpolate_imu)
from vins_tpu.utils.profiling import StageTimers, cost_analysis, \
    speed_of_light
from vins_tpu.viz.delaunay import delaunay, triangulate_ground
from vins_tpu.viz.renderer import draw_ground_mesh


def test_interpolate_imu_fuses_async_streams():
    t_a = np.linspace(0.0, 1.0, 101)
    accel = np.stack([t_a, 2 * t_a, -t_a], axis=1)  # linear in t
    t_g = np.linspace(-0.05, 1.05, 97)  # offset rate, out-of-span ends
    gyro = np.tile(np.array([0.1, 0.2, 0.3]), (97, 1))
    t, a, g = interpolate_imu(t_g, gyro, t_a, accel)
    assert np.all(t >= t_a[0]) and np.all(t <= t_a[-1])
    assert np.all(np.diff(t) > 0)
    # Linear signal interpolates exactly.
    np.testing.assert_allclose(a, np.stack([t, 2 * t, -t], axis=1),
                               atol=1e-12)
    np.testing.assert_allclose(
        g, np.tile([0.1, 0.2, 0.3], (len(t), 1)), atol=1e-12)


def test_align_measurements_partitions_stream():
    t_imu = np.arange(100) * 0.01
    t_img = np.array([0.095, 0.20, 0.50])
    ranges = align_measurements(t_imu, t_img)
    assert len(ranges) == 3
    # Ranges are contiguous and each sample lands at t <= its image stamp.
    lo = 0
    for (a, b), ti in zip(ranges, t_img):
        assert a == lo
        lo = b
        assert np.all(t_imu[a:b] <= ti + 1e-12)
    # Consecutive: next range starts where previous ended.
    assert ranges[0][1] == ranges[1][0]


def test_chunk_imu_dt_sums_to_frame_interval():
    t_imu = np.arange(0.0, 1.0, 0.01)
    rng = np.random.default_rng(1)
    accel = rng.normal(size=(len(t_imu), 3))
    gyro = rng.normal(size=(len(t_imu), 3))
    t_img = np.array([0.3, 0.6, 0.9])
    ch = chunk_imu(t_imu, accel, gyro, t_img, 40)
    assert ch.dt.shape == (3, 40)
    # Row 0 is the dt=0 seed sample (ImuChunk contract).
    np.testing.assert_allclose(ch.dt[:, 0], 0.0)
    # Interior edges: sum of dts spans exactly the inter-image interval.
    np.testing.assert_allclose(ch.dt[1].sum(), 0.3, atol=1e-6)
    np.testing.assert_allclose(ch.dt[2].sum(), 0.3, atol=1e-6)
    # Overflow path: tiny capacity still conserves total time.
    ch2 = chunk_imu(t_imu, accel, gyro, t_img, 5)
    np.testing.assert_allclose(ch2.dt[1].sum(), 0.3, atol=1e-6)


def test_chunk_imu_preintegrates_constant_motion():
    """chunk_imu output feeds preintegration directly: constant accel,
    zero rotation → dp = 0.5 a t² in every edge."""
    import jax
    import jax.numpy as jnp

    from vins_tpu import default_config
    from vins_tpu.core.preintegration import propagate

    cfg = default_config()
    t_imu = np.arange(0.0, 1.0, 0.005)
    a_const = np.array([0.3, -0.1, 9.81 + 0.2])
    accel = np.tile(a_const, (len(t_imu), 1))
    gyro = np.zeros((len(t_imu), 3))
    t_img = np.array([0.30, 0.50, 0.70])
    ch = chunk_imu(t_imu, accel, gyro, t_img, cfg.window.max_imu_per_edge)
    pre = jax.vmap(lambda c: propagate(
        jax.tree.map(jnp.asarray, c), jnp.zeros(3), jnp.zeros(3),
        cfg.imu))(ch)
    # Edges 1, 2 span exactly 0.2 s each.
    for k in (1, 2):
        np.testing.assert_allclose(pre.sum_dt[k], 0.2, atol=1e-5)
        np.testing.assert_allclose(np.asarray(pre.dp[k]),
                                   0.5 * a_const * 0.2 ** 2,
                                   rtol=1e-3, atol=1e-5)


def test_delaunay_square_grid():
    # 4x4 grid → 2*(3*3) = 18 triangles, all CCW-orientable, covering area 9.
    xs, ys = np.meshgrid(np.arange(4.0), np.arange(4.0))
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    tris = delaunay(pts)
    assert len(tris) == 18
    area = 0.0
    for a, b, c in tris:
        pa, pb, pc = pts[a], pts[b], pts[c]
        area += 0.5 * abs((pb[0] - pa[0]) * (pc[1] - pa[1])
                          - (pc[0] - pa[0]) * (pb[1] - pa[1]))
    np.testing.assert_allclose(area, 9.0, atol=1e-9)


def test_triangulate_ground_selects_plane_inliers():
    rng = np.random.default_rng(2)
    ground = np.concatenate(
        [rng.uniform(-1, 1, size=(40, 2)), np.zeros((40, 1))], axis=1)
    outliers = rng.uniform(-1, 1, size=(20, 3)) + np.array([0, 0, 2.0])
    pts = np.vstack([ground, outliers])
    inl, tris = triangulate_ground(pts, np.array([0.0, 0, 1]), 0.0, 0.05)
    assert len(inl) == 40
    assert len(tris) > 0
    assert all(max(t) < 40 for t in tris)


def test_draw_ground_mesh_renders():
    img = np.zeros((48, 64), np.float32)
    rng = np.random.default_rng(3)
    pts = np.concatenate(
        [rng.uniform(-0.5, 0.5, size=(30, 2)), np.zeros((30, 1))], axis=1)
    pts[:, 2] += 2.0  # plane z = +2, in front of the camera (+z optical)
    out = draw_ground_mesh(img, np.eye(3), np.zeros(3), 60, 60, 32, 24,
                           pts, np.array([0.0, 0, 1]), -2.0)
    assert out.shape == (48, 64, 3)
    assert out.max() > 0  # something was drawn


def test_stage_timers_accumulate():
    t = StageTimers(sync=False)
    with t.stage("solve"):
        pass
    with t.stage("solve"):
        pass
    assert t.count["solve"] == 2
    assert "solve" in t.report()
    d = t.as_dict()
    assert d["solve"]["calls"] == 2


def test_cost_analysis_reports_flops():
    def f(x):
        return x @ x

    x = jnp.ones((64, 64), jnp.float32)
    costs = cost_analysis(f, x)
    # 64^3 multiply-adds = 2*64^3 flops; CPU backend reports flops.
    if "flops" in costs:
        assert costs["flops"] >= 2 * 64 ** 3 * 0.5
    sol = speed_of_light(f, x, device_kind="NVIDIA H100 80GB HBM3",
                         measured_s=1.0)
    assert sol["t_bound_s"] >= 0.0


def test_peak_table_rejects_unknown_device():
    """Roofline shares come only from a device with published peaks: an
    unknown device_kind (the CPU here) is an error, not a default."""
    import jax
    import pytest

    from vins_tpu.utils.profiling import PEAKS, device_peaks

    assert device_peaks("NVIDIA H100 80GB HBM3")["flops_per_s"] == 67e12
    assert jax.devices()[0].device_kind not in PEAKS
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(jax.devices()[0].device_kind)
    with pytest.raises(KeyError):
        speed_of_light(lambda x: x @ x, jnp.ones((8, 8)),
                       device_kind="unlisted accelerator")


def test_roofline_is_the_slower_of_compute_and_memory():
    import pytest

    from vins_tpu.utils.profiling import roofline

    kind = "NVIDIA H100 80GB HBM3"
    r = roofline(67e12, 0.5 * 3.35e12, kind, measured_s=4.0)
    assert r["t_compute_s"] == pytest.approx(1.0)
    assert r["t_memory_s"] == pytest.approx(0.5)
    assert r["t_bound_s"] == pytest.approx(1.0)
    assert r["sol_fraction"] == pytest.approx(0.25)
    assert roofline(0.0, 2 * 3.35e12, kind)["t_bound_s"] == pytest.approx(2.0)
    with pytest.raises(KeyError):
        roofline(1.0, 1.0, "unlisted accelerator")
