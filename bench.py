"""End-to-end throughput benchmark on the accelerator.

Two measurements:

  * system_frames_per_s — the headline metric:
    rendered 640x480 frames + IMU chunks through the FULL pipeline —
    CLAHE, pyramid, LK tracking, F-RANSAC, corner top-up, the 30 Hz
    motion-only solver, the complete sliding-window backend (solve +
    marginalization + slide) at freq=3, pnp resync, keyframe harvest, and
    host-side loop closure (BoW detect + pose graph) — via the pipelined
    block scan (pipeline.VinsSystem.process_stream / stream.run_vio_scan).

  * vio_frames_per_s — the backend-only rate (solve+marg+slide per frame,
    the reference's 10 Hz solve_ceres path, VINS_ios/VINS.cpp:480-830),
    kept for continuity with round-1 numbers.

Prints ONE JSON line with the system metric as primary and the device
it ran on. Every phase is fatal on failure, and a device missing from
utils/profiling.PEAKS is refused before any work.
"""
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def build_backend_inputs(cfg, n_frames, seed=0):
    from vins_tpu.core.estimator import BackendState, FrameInput
    from vins_tpu.io import synthetic

    F = cfg.window.num_frames
    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=F + n_frames, n_landmarks=300, seed=seed,
        noise_px=0.5, frame_dt=0.1)

    from vins_tpu.core import feature_manager as fm
    from vins_tpu.core.state import FeatureTable

    feats = FeatureTable.empty(F, cfg.window.max_landmarks)
    for f in range(F):
        feats = fm.ingest_frame(feats, jnp.asarray(f), seq.ids[f],
                                seq.obs[f], seq.obs_valid[f])
    chunks = jax.tree.map(lambda x: x[1:F], seq.chunks)
    win = BackendState.fresh(cfg).window._replace(
        p=seq.p[:F], q=seq.q[:F], v=seq.v[:F])
    win = fm.triangulate(win, feats, seq.ext, cfg)
    est = BackendState.bootstrap(cfg, win, feats, chunks, seq.ext,
                                 seq.gravity)

    inputs = FrameInput(
        chunk=jax.tree.map(lambda x: x[F:], seq.chunks),
        ids=seq.ids[F:], obs=seq.obs[F:], obs_valid=seq.obs_valid[F:])
    return est, inputs, seq.ext, seq.gravity


def bench_backend(cfg, n_frames=256):
    """Backend-only frames/s via run_sequence_scan (one device program)."""
    from vins_tpu.core.estimator import run_sequence_scan

    est, inputs, ext, gravity = build_backend_inputs(cfg, n_frames)
    run = jax.jit(lambda e, i: run_sequence_scan(e, i, cfg, ext, gravity))
    e2, out = run(est, inputs)
    jax.block_until_ready(out.pose_p)

    n_rep = 3
    t0 = time.perf_counter()
    for _ in range(n_rep):
        e2, out = run(est, inputs)
    jax.block_until_ready(out.pose_p)
    dt = (time.perf_counter() - t0) / n_rep
    return n_frames / dt


def bench_system(cfg, n_frames=528, block=48, seed=7):
    """Full-pipeline frames/s: frontend + pnp + backend + loop closure.

    The sequence revisits its own path (full circle) so loop closure has
    real work; the INITIAL phase and the first (compile) pass are
    untimed, as is staging the frames into HBM.
    """
    from vins_tpu.io import synthetic
    from vins_tpu.pipeline import VinsSystem

    # Place recognition uses the SHIPPED pre-trained vocabulary asset
    # (vins_tpu/assets/brief_k10L3.npz, trained offline on a held-out
    # corpus by tools/train_vocab.py — the reference likewise loads
    # brief_k10L6.bin at startup, ViewController.mm:892-900). No runtime
    # training happens in this bench.
    n_total = n_frames + 48  # lead-in for bootstrap
    # w=0.7 rad/s → one revolution every ~269 frames: the measured 432
    # frames cover ~1.6 laps of revisited path, so verified loop hits,
    # loop-factor window solves, and pose-graph runs all fire INSIDE the
    # timed region (a w=0.35 circle only closes at the very end, so its
    # timed region never pays for geometric verify or the 4-DoF graph).
    # Per-frame motion
    # (~0.023 rad/frame) matches the accuracy fixture's, which tracks
    # and closes loops reliably.
    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=n_total, n_landmarks=300, seed=seed,
        frame_dt=1.0 / 30.0, traj_kwargs=dict(w=0.7, bob=0.15),
        imu_per_frame=4)
    # Frames stay on the device (device=True): the scan consumes them
    # there.
    imgs = synthetic.render_sequence_images(seq, cfg, seed=seed,
                                            device=True)

    sys_ = VinsSystem(cfg, use_loop=True, ext=seq.ext)
    k = 0
    while k < 48 and not sys_.initialized:
        chunk = jax.tree.map(lambda x: x[k], seq.chunks)
        sys_.process_frame(jnp.asarray(imgs[k]), chunk,
                           t=float(seq.timestamps[k]))
        k += 1
    assert sys_.initialized, "automatic initialization failed by frame 48"

    # Stage the measured frames on device once (not timed).
    imgs_dev = jax.device_put(jnp.asarray(imgs[k:k + n_frames]))
    chunks_dev = jax.tree.map(
        lambda x: jax.device_put(x[k:k + n_frames]), seq.chunks)

    # Warm/compile pass over the first two blocks THROUGH process_stream
    # (not timed): compiles the scan, the traced-index block-slice and
    # row-gather programs, and the insert path — then AOT-compile the
    # remaining loop-closure programs (score/verify/pose-graph) so no
    # compile fires inside the timed region on the first hit.
    warm = sys_.process_stream(
        imgs_dev[:2 * block],
        jax.tree.map(lambda x: x[:2 * block], chunks_dev), block=block)
    assert all(o.initialized for o in warm), "pipeline failed during warmup"
    sys_.loop.warm()

    # Pre-compile the block-slicer programs for the MEASURED parent
    # shapes (the warm pass sliced a shorter staged array, a different
    # program per leaf, otherwise compiled inside the first measured
    # block).
    meas_imgs = imgs_dev[2 * block:]
    meas_chunks = jax.tree.map(lambda x: x[2 * block:], chunks_dev)
    z = jnp.asarray(0, jnp.int32)
    jax.block_until_ready(sys_._slice_block(meas_imgs, z, block))
    jax.tree.map(
        lambda x: jax.block_until_ready(sys_._slice_block(x, z, block)),
        meas_chunks)

    n_meas = n_frames - 2 * block
    sys_.timings = {}  # reset; buckets re-accumulate lazily
    # Snapshot loop-closure counters so the liveness numbers below are
    # deltas OVER THE MEASURED REGION only (warmup hits don't count).
    hits0 = int(sys_.loop.n_loops)
    opt0 = int(sys_.loop.n_optimizes)
    t0 = time.perf_counter()
    outs = sys_.process_stream(meas_imgs, meas_chunks, block=block)
    dt = time.perf_counter() - t0
    assert len(outs) == n_meas and all(o.initialized for o in outs), \
        "pipeline failed during measurement"
    # Published artifacts must be finite: poses always, point clouds on
    # every valid slot (invalid slots are zeroed at the source —
    # landmark_world_points; a NaN/inf here is a regression).
    for o in outs:
        assert np.all(np.isfinite(o.p)) and np.all(np.isfinite(o.q)), \
            "non-finite published pose"
        if o.point_cloud is not None:
            assert np.all(np.isfinite(o.point_cloud)), \
                "non-finite published point cloud"
    n_kf = sum(1 for o in outs if o.is_keyframe)
    # Loop-closure liveness in the measured region (the throughput claim
    # covers the FULL system; a bench where detection never fires would
    # overstate it). HARD gates: the headline number is invalid unless
    # verified hits AND pose-graph runs happened inside the timed window
    # (VERDICT r4 item 2) — a trajectory/config change that silently
    # regresses to loop-free must fail the bench, not inflate it.
    loop_hits = int(sys_.loop.n_loops) - hits0
    pose_graph_runs = int(sys_.loop.n_optimizes) - opt0
    assert loop_hits >= 1, \
        f"no verified loop hit in the measured region ({loop_hits})"
    assert pose_graph_runs >= 1, \
        f"no pose-graph run in the measured region ({pose_graph_runs})"
    budget_extra = {
        "loop_hits": loop_hits,
        "pose_graph_runs": pose_graph_runs,
        "keyframes_in_db": int(sys_.loop.count),
    }
    tm = sys_.timings
    nb = max(tm.get("blocks", 0), 1)
    budget = {f"{k}_ms_per_block": round(1e3 * v / nb, 1)
              for k, v in tm.items() if k != "blocks"}
    budget["block_frames"] = block
    budget["n_blocks"] = tm.get("blocks", 0)
    budget.update(budget_extra)
    return n_meas / dt, n_kf, k - 1, budget


def _timed(fn, *args, reps=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def bench_kernels(cfg, device_kind):
    """Per-call times of three hot programs: (a) the LK tracker the
    product dispatches (ops/klt.track_pyramid), (b) one backend
    sliding-window solve, (c) one distributed-BA LM iteration at L=2048
    landmarks. All three are loops (fori_loop, LM while_loop, scan), whose
    body XLA's cost analysis counts once, so only (a) carries a roofline
    share, from an analytic count: sol_fraction = roofline_ms /
    achieved_ms against utils/profiling.PEAKS (1.0 = speed of light; at
    VIO-sized shapes these programs are latency-bound)."""
    from vins_tpu.core.preintegration import propagate
    from vins_tpu.core.state import PriorFactor
    from vins_tpu.core.solver import WindowProblem, solve_window
    from vins_tpu.io.synthetic import make_ba_problem, make_synthetic_window
    from vins_tpu.ops import image as image_mod
    from vins_tpu.ops import klt
    from vins_tpu.parallel.dist_ba import solve_ba
    from vins_tpu.utils import profiling

    fe = cfg.frontend
    H, W = cfg.camera.height, cfg.camera.width
    M = fe.max_features
    rng = np.random.default_rng(0)
    out = {}

    def entry(fn, args, reps, per_call_scale=1.0, flops=0.0, nbytes=0.0):
        """per_call_scale: the share of one call that the row reports
        (1/iters for a per-iteration row). flops/nbytes: an analytic
        count of one row's work, for the roofline share."""
        t = _timed(fn, *args, reps=reps) * per_call_scale
        d = {"ms": round(1e3 * t, 3)}
        if flops or nbytes:
            sol = profiling.roofline(flops, nbytes, device_kind, t)
            d["roofline_ms"] = round(1e3 * sol["t_bound_s"], 4)
            d["sol_fraction"] = round(sol["sol_fraction"], 4)
            d["gflops"] = round(flops / 1e9, 3)
            d["gbytes"] = round(nbytes / 1e9, 4)
        return d

    # (a) whole-pyramid LK as dispatched (one frame's forward track; the
    # scan runs two per frame: forward + backward check). Analytic floor:
    # every LK iteration runs ~30 flops per window tap (bilinear sample,
    # residual, two gradient products, sums) for every slot and level,
    # and the four image planes of each level are read at least once.
    img0 = jnp.asarray(rng.random((H, W)), jnp.float32)
    img1 = jnp.roll(img0, (2, 3), (0, 1))
    pyr0 = list(image_mod.build_pyramid(img0, fe.pyramid_levels))
    pyr1 = list(image_mod.build_pyramid(img1, fe.pyramid_levels))
    grads = [image_mod.sobel_gradients(p) for p in pyr0]
    pts = jnp.asarray(rng.uniform(40, min(H, W) - 40, (M, 2)), jnp.float32)
    valid = jnp.ones((M,), bool)
    track = jax.jit(lambda p: klt.track_pyramid(
        pyr0, pyr1, p, valid, fe, grads_prev=grads).pts)
    lvl_px = sum(H * W / 4 ** lvl for lvl in range(fe.pyramid_levels))
    out["klt_pyramid"] = entry(
        track, (pts,), 30,
        flops=30.0 * M * fe.pyramid_levels * fe.klt_iters * fe.klt_window ** 2,
        nbytes=4 * 4.0 * lvl_px)

    # (b) one backend window solve (the 10 Hz solve_ceres analog) at the
    # shipped compiled shape (F frames x max_landmarks slots).
    syn = make_synthetic_window(cfg, n_landmarks=min(
        96, cfg.window.max_landmarks), seed=3)
    F = cfg.window.num_frames
    preints = jax.vmap(lambda c: propagate(
        c, jnp.zeros(3), jnp.zeros(3), cfg.imu))(syn.chunks)
    prob = WindowProblem(
        feats=syn.feats, preints=preints, prior=PriorFactor.empty(F),
        ext=syn.ext, gravity=syn.gravity,
        sqrt_info_proj=jnp.asarray(cfg.camera.focal / 1.5),
        frame_free=jnp.ones(F))
    wsolve = jax.jit(lambda s, p: solve_window(s, p, cfg))
    out["window_solve"] = entry(wsolve, (syn.state, prob), 20)

    # (c) one global-BA LM iteration at L=2048 (the scale-out unit of
    # parallel/dist_ba; measured single-chip, per-iteration).
    it = 8
    _, init, bprob = make_ba_problem(n_poses=64, n_landmarks=2048,
                                     seed=0, noise_px=0.5,
                                     pose_noise=0.05, point_noise=0.05)
    ba = jax.jit(lambda s, p: solve_ba(s, p, iters=it)[0].p)
    out["ba_iteration_L2048"] = entry(ba, (init, bprob), 5,
                                      per_call_scale=1.0 / it)
    return out


def main():
    from vins_tpu import default_config
    from vins_tpu.utils import profiling

    dev = jax.devices()[0]
    profiling.device_peaks(dev.device_kind)   # unknown device: refuse
    cfg = default_config()
    sys_fps, n_kf, init_at, budget = bench_system(cfg)
    vio_fps = bench_backend(cfg)
    kernels = bench_kernels(cfg, dev.device_kind)
    result = {
        "metric": "system_frames_per_s",
        "value": round(sys_fps, 2),
        "unit": "frames/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "vio_frames_per_s": round(vio_fps, 2),
        "keyframes_in_measurement": n_kf,
        "init_frame": init_at,
        "stage_budget": budget,
        "kernels": kernels,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
