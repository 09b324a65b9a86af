"""Smoke test of the VIO/SLAM main path on the GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the multi-card path only

One process drives the card. Phases, each fatal on failure:

  device       refuse anything but a GPU; print the card's name and
               power limit (nvidia-smi), device kind and count.
  kernels      LK tracking (the frontend's hot op) on the GPU against the
               same inputs on the CPU at both camera profiles' widths
               (640x480 portrait, 752x480), timed per call; the fused
               scan step's memory analysis.
  interactive  VinsSystem.process_frame on a rendered revisit sequence
               until automatic initialization (no ground-truth bootstrap).
  stream       VinsSystem.process_stream with loop closure live over
               the rest of the sequence in 48-frame blocks; asserts
               liveness, finiteness, the raw-VIO ATE of its first
               frames, and the shape and scale of the whole stream.

`--four` runs the landmark-sharded global BA on a 4-card `block` mesh
against single-card BA, and the backend step vmapped over 4 streams on
the `batch` axis against each stream alone.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# The GPU-vs-CPU comparison needs the CPU backend beside the GPU.
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# Flow agreement of the same FP32 LK program on two backends (no TF32:
# the package sets matmul precision "highest"): only the order of the
# 441-term window sums differs (~1e-7 relative), and converged tracks
# contract such differences over the iterations; 1e-3 px is three orders
# of magnitude under the 0.3 px forward-backward gate that consumes them.
FLOW_TOL_PX = 1e-3
ERR_TOL = 1e-4          # mean |residual| in image intensity units
# Accuracy gates. The raw-VIO ATE bound of 0.15 m is the block-mode bound
# of tests/test_pipeline.py, set for a span of ~30-40 frames: it holds
# over the first 48 stream frames (0.032-0.055 m in three H100 runs) and
# catches the initialization scale error that
# initialization.refine_init_window fixes (0.22 m with three fixed
# refinement rounds). Over the whole stream (432 frames, ~1.6 laps, a
# 30 m path) the window's metric scale drifts (1.03 -> 1.12-1.15; cause
# open, PERF.md), so the raw ATE there (0.39-0.45 m) is printed, not
# gated: the stream's shape (similarity-aligned ATE, 0.234-0.259 m) and
# its scale are, each with margin over those runs.
FIRST_FRAMES = 48
FIRST_RAW_ATE_MAX_M = 0.15
SIM_ATE_MAX_M = 0.35
SCALE_TOL = 0.25
INIT_BY_FRAME = 45      # tests/test_pipeline.py
BLOCK = 48
STREAM_FRAMES = 432     # >= 384 stream frames after initialization


_T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - _T0:7.1f}s]", *a, flush=True)


def require_gpu(count: int = 1):
    """Exit nonzero unless JAX's default devices are `count` or more
    GPUs. Returns the devices to use."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r}); refusing to run")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} GPUs, have {len(devs)}")
    return devs[:count]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _timed(fn, *args, reps=50):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------- kernels

def _lk_inputs(H, W, M, levels, seed=0):
    """Smooth random texture and a subpixel-shifted copy, their
    pyramids, and M points: interior, near each border, some dead."""
    from vins_tpu.ops import image

    rng = np.random.default_rng(seed)
    base = jnp.asarray(rng.uniform(0, 1, (H + 8, W + 8)), jnp.float32)
    for _ in range(3):
        base = image.gaussian_blur(base, 1.5)
    img0 = base[4:H + 4, 4:W + 4]
    # 2.4 px right, 1.3 px down, by bilinear resampling.
    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32) + 4 - 1.3,
                          jnp.arange(W, dtype=jnp.float32) + 4 - 2.4,
                          indexing="ij")
    img1 = image.bilinear_sample(
        base, jnp.stack([xs.ravel(), ys.ravel()], -1)).reshape(H, W)
    pyr0 = image.build_pyramid(img0, levels)
    pyr1 = image.build_pyramid(img1, levels)
    grads = [image.sobel_gradients(p) for p in pyr0]
    n_edge = 8
    pts = np.concatenate([
        rng.uniform(24, [W - 24, H - 24], (M - n_edge, 2)),
        [[0.5, 0.5], [W - 1.5, H - 1.5], [2.0, H / 2], [W - 2.0, H / 3],
         [W / 2, 1.0], [W / 3, H - 1.0], [0.0, H - 1.0], [W - 1.0, 0.0]]])
    valid = np.ones(M, bool)
    valid[rng.choice(M - n_edge, 8, replace=False)] = False
    return (list(pyr0), grads, list(pyr1), jnp.asarray(pts, jnp.float32),
            jnp.asarray(valid))


def _compare_lk(name, a, b, valid):
    """a, b: KltResult. Status masks must agree exactly; flows and
    residuals of the tracked slots within FLOW_TOL_PX / ERR_TOL."""
    sa, sb = np.asarray(a.status), np.asarray(b.status)
    if not np.array_equal(sa, sb):
        raise AssertionError(f"{name}: status differs at slots "
                             f"{np.flatnonzero(sa != sb).tolist()}")
    tr = sa & np.asarray(valid)
    dflow = float(np.abs(np.asarray(a.pts) - np.asarray(b.pts))[tr].max())
    derr = float(np.abs(np.asarray(a.err) - np.asarray(b.err))[tr].max())
    log(f"  {name}: {int(tr.sum())} tracked, max |dflow| {dflow:.3g} px, "
        f"max |derr| {derr:.3g}")
    assert dflow <= FLOW_TOL_PX, f"{name}: flow differs by {dflow} px"
    assert derr <= ERR_TOL, f"{name}: residual differs by {derr}"


def kernel_phase(cfg, sizes=((640, 480), (480, 752))):
    """sizes: (H, W) of the default (portrait phone) and EuRoC profiles."""
    from vins_tpu.ops import klt

    fe = cfg.frontend
    cpu = jax.devices("cpu")[0]
    for H, W in sizes:
        log(f"[kernels] LK {W}x{H}: M={fe.max_features} "
            f"L={fe.pyramid_levels} win={fe.klt_window} iters={fe.klt_iters}")
        pyr0, grads, pyr1, pts, valid = _lk_inputs(
            H, W, fe.max_features, fe.pyramid_levels)
        track = jax.jit(lambda pyr0, grads, pyr1, pts, valid: (
            klt.track_pyramid(pyr0, pyr1, pts, valid, fe, grads_prev=grads)))
        args = (pyr0, grads, pyr1, pts, valid)
        g_out = track(*args)
        c_out = track(*jax.device_put(args, cpu))
        _compare_lk("GPU vs CPU", g_out, c_out, valid)
        log(f"  time per call on the GPU: {1e3 * _timed(track, *args):.4f} ms")
    # The frontend's other patch ops, timed once at the phone profile:
    # the NCC gate (per frame) and BRIEF extraction (per keyframe).
    from vins_tpu.ops import brief

    pyr0, _, pyr1, pts, valid = _lk_inputs(640, 480, fe.max_features, 1)
    ncc = jax.jit(lambda a, b, p: klt.patch_ncc(a, b, p, p, fe.klt_window))
    log(f"[kernels] patch NCC, {fe.max_features} patches: "
        f"{1e3 * _timed(ncc, pyr0[0], pyr1[0], pts):.4f} ms per call")
    kp = jnp.tile(pts, (cfg.loop.max_kf_features // fe.max_features, 1))
    desc = jax.jit(lambda img, p: brief.extract_brief(
        img, p, jnp.ones(p.shape[0], bool)))
    log(f"[kernels] BRIEF, {kp.shape[0]} keypoints: "
        f"{1e3 * _timed(desc, pyr0[0], kp):.4f} ms per call")


def make_sequence(cfg, n_frames, seed=7):
    """The bench's revisit sequence: a 0.7 rad/s circle with vertical
    bob (~269 frames a lap at 30 Hz), 300 landmarks, 4 IMU samples per
    frame; frames ray-cast on the device."""
    from vins_tpu.io import synthetic

    seq = synthetic.make_synthetic_sequence(
        cfg, n_frames=n_frames, n_landmarks=300, seed=seed,
        frame_dt=1.0 / 30.0, traj_kwargs=dict(w=0.7, bob=0.15),
        imu_per_frame=4)
    imgs = synthetic.render_sequence_images(seq, cfg, seed=seed, device=True)
    chunks = jax.tree.map(jnp.asarray, seq.chunks)
    return seq, jax.block_until_ready(imgs), chunks


def run_system(cfg, seq, imgs, chunks, block=BLOCK, warm_blocks=2):
    """Interactive bootstrap, then the streamed remainder. Returns the
    system, the init frame, the stream outputs and the steady-state
    frames/s of the stream after its first `warm_blocks` blocks."""
    from vins_tpu.pipeline import VinsSystem

    take = jax.jit(lambda tree, i: jax.tree.map(
        lambda x: jax.lax.dynamic_index_in_dim(x, i, 0, False), tree))
    sys_ = VinsSystem(cfg, use_loop=True, ext=seq.ext)
    k = 0
    while k < INIT_BY_FRAME + 1 and not sys_.initialized:
        img, chunk = take((imgs, chunks), k)
        sys_.process_frame(img, chunk, t=float(seq.timestamps[k]))
        k += 1
    assert sys_.initialized, \
        f"automatic initialization failed by frame {INIT_BY_FRAME}"
    init_at = k - 1
    n = min(imgs.shape[0] - k, STREAM_FRAMES)
    w = warm_blocks * block
    sl = lambda x, s, e: jax.tree.map(lambda a: a[s:e], x)  # noqa: E731
    ts = np.asarray(seq.timestamps)
    outs = sys_.process_stream(imgs[k:k + w], sl(chunks, k, k + w),
                               block=block, ts=ts[k:k + w])
    sys_.loop.warm()   # compile the loop-hit programs outside the timing
    t0 = time.perf_counter()
    outs += sys_.process_stream(imgs[k + w:k + n], sl(chunks, k + w, k + n),
                                block=block, ts=ts[k + w:k + n])
    fps = (n - w) / (time.perf_counter() - t0)
    return sys_, init_at, k, outs, fps


def check_stream(seq, k, outs, sys_):
    from vins_tpu.io import evaluate

    n = len(outs)
    assert n >= 384, f"stream covered only {n} frames"
    assert all(o.initialized for o in outs), "stream lost initialization"
    for o in outs:
        assert np.all(np.isfinite(o.p)) and np.all(np.isfinite(o.q)), \
            "non-finite published pose"
        if o.point_cloud is not None:
            assert np.all(np.isfinite(o.point_cloud)), \
                "non-finite published point cloud"
    gt = np.asarray(seq.p[k:k + n])
    p_raw = np.stack([o.p_raw for o in outs])
    first = evaluate.ate_rmse(p_raw[:FIRST_FRAMES], gt[:FIRST_FRAMES]).rmse
    raw = evaluate.ate_rmse(p_raw, gt).rmse
    sim = evaluate.ate_rmse(p_raw, gt, with_scale=True)
    pub = evaluate.ate_rmse(np.stack([o.p for o in outs]), gt).rmse
    hits, runs = sys_.loop.n_loops, sys_.loop.n_optimizes
    log(f"  {n} stream frames, loop_hits {hits}, pose_graph_runs {runs}; "
        f"raw-VIO ATE {first:.4f} m over the first {FIRST_FRAMES} frames, "
        f"{raw:.4f} m over all (similarity-aligned {sim.rmse:.4f} m, "
        f"scale {sim.s:.4f}); drift-corrected ATE {pub:.4f} m (not gated)")
    assert hits >= 1, "no verified loop hit"
    assert runs >= 1, "no pose-graph run"
    assert first <= FIRST_RAW_ATE_MAX_M, \
        f"raw-VIO ATE over the first {FIRST_FRAMES} frames {first} m"
    assert sim.rmse <= SIM_ATE_MAX_M, f"similarity-aligned ATE {sim.rmse} m"
    assert abs(sim.s - 1.0) <= SCALE_TOL, f"metric scale off: {sim.s}"


def system_phases(cfg, card):
    seq, imgs, chunks = make_sequence(cfg, INIT_BY_FRAME + STREAM_FRAMES + 3)
    log("[interactive] process_frame until automatic initialization")
    sys_, init_at, k, outs, fps = run_system(cfg, seq, imgs, chunks)
    log(f"  initialized at frame {init_at}")
    log(f"[stream] process_stream, {BLOCK}-frame blocks, loop closure live")
    check_stream(seq, k, outs, sys_)
    mem = sys_._scan_jit.lower(
        sys_._scan_state(), imgs[:BLOCK],
        jax.tree.map(lambda a: a[:BLOCK], chunks)).compile().memory_analysis()
    log(f"[kernels] scan step ({BLOCK} frames) memory: {mem}")
    log(f"  stream {fps:.2f} frames/s after its first {2 * BLOCK} frames "
        f"(smoke figure, not a benchmark; {card})")


# -------------------------------------------------------------- four cards

def sharded_ba_phase(devs, n_poses=64, n_landmarks=8192, iters=10):
    """Landmark-sharded BA over a len(devs)-card block mesh vs one card."""
    from vins_tpu.io import synthetic
    from vins_tpu.parallel import make_mesh, solve_ba, solve_ba_sharded

    nd = len(devs)
    log(f"[four] global BA: {n_poses} poses, {n_landmarks} landmarks, "
        f"{iters} LM iterations, {nd}-card block mesh vs one card")
    _, init, prob = synthetic.make_ba_problem(
        n_poses=n_poses, n_landmarks=n_landmarks, seed=0, noise_px=0.5,
        pose_noise=0.05, point_noise=0.05)
    one = jax.jit(lambda s, p: solve_ba(s, p, iters=iters))
    st1, c1, _ = jax.block_until_ready(
        one(*jax.device_put((init, prob), devs[0])))
    mesh = make_mesh(batch=1, block=nd, devices=devs)
    shard = jax.jit(lambda s, p: solve_ba_sharded(s, p, mesh, iters=iters))
    stn, cn, _ = jax.block_until_ready(shard(init, prob))
    c1, cn = float(c1), float(cn)
    p1, pn = np.asarray(st1.p, np.float64), np.asarray(stn.p, np.float64)
    dp = float(np.abs(pn - p1).max())
    dq = float(np.abs(np.asarray(stn.q) - np.asarray(st1.q)).max())
    # Monocular BA fixes pose 0 only: its global scale is a near-flat
    # direction of the cost, along which FP32 rounding drifts freely.
    # Compare the poses after removing that one scale about pose 0.
    a, b = pn - pn[0], p1 - p1[0]
    scale = float((a * b).sum() / (a * a).sum())
    dp_s = float(np.abs(scale * a - b).max())
    log(f"  final cost one card {c1:.6g}, {nd} cards {cn:.6g}; "
        f"max |dp| {dp:.3g} m, scale ratio {scale:.6f}, max |dp| after "
        f"scale {dp_s:.3g} m, max |dq| {dq:.3g}")
    # The psum adds the per-shard normal equations in another order than
    # the one-card sum: FP32 rounding, re-amplified by each LM solve.
    assert abs(cn - c1) <= 1e-4 * c1, "sharded BA cost differs"
    assert abs(scale - 1.0) <= 1e-2, "sharded BA scale differs"
    assert dp_s <= 1e-4 and dq <= 1e-4, "sharded BA poses differ"
    shards = stn.pts.addressable_shards
    assert sorted(s.device.id for s in shards) == sorted(d.id for d in devs)
    pts_full = np.asarray(stn.pts)
    for s in shards:
        assert s.data.shape[0] == n_landmarks // nd
        np.testing.assert_array_equal(np.asarray(s.data),
                                      pts_full[s.index])
    log(f"  landmarks sharded: {nd} cards x {n_landmarks // nd}")
    t_1 = _timed(one, *jax.device_put((init, prob), devs[0]), reps=3)
    t_n = _timed(shard, init, prob, reps=3)
    log(f"  time per solve: one card {1e3 * t_1:.2f} ms, "
        f"{nd} cards {1e3 * t_n:.2f} ms")



def batched_backend_phase(devs, cfg):
    """The backend step vmapped over len(devs) streams on the batch axis
    vs each stream alone."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vins_tpu.core.estimator import BackendState, FrameInput, \
        backend_step
    from vins_tpu.io import synthetic
    from vins_tpu.parallel import (make_batched_step, make_mesh,
                                   stack_inputs, stack_states)
    from vins_tpu.parallel.mesh import BATCH_AXIS

    nd = len(devs)
    log(f"[four] backend_step vmapped over {nd} streams on the batch axis")
    F = cfg.window.num_frames
    ests, inps = [], []
    for seed in range(nd):
        w = synthetic.make_synthetic_window(
            cfg, n_landmarks=min(64, cfg.window.max_landmarks), seed=seed,
            noise_px=0.3)
        ests.append(BackendState.bootstrap(cfg, w.state, w.feats, w.chunks,
                                           w.ext, w.gravity))
        inps.append(FrameInput(
            chunk=jax.tree.map(lambda x: x[-1], w.chunks),
            ids=w.feats.track_id, obs=w.feats.obs[F - 1],
            obs_valid=w.feats.mask[F - 1] & w.feats.valid))
    ext, gravity = w.ext, w.gravity
    bmesh = make_mesh(batch=nd, block=1, devices=devs)
    sh = NamedSharding(bmesh, P(BATCH_AXIS))
    step_b = make_batched_step(cfg, ext, gravity, bmesh)
    est_b = jax.device_put(stack_states(ests), sh)
    inp_b = jax.device_put(stack_inputs(inps), sh)
    _, out_b = jax.block_until_ready(step_b(est_b, inp_b))
    single = jax.jit(lambda e, i: backend_step(e, i, cfg, ext, gravity))
    worst = 0.0
    for s in range(nd):
        _, o = single(*jax.device_put((ests[s], inps[s]), devs[0]))
        worst = max(worst, float(np.abs(np.asarray(o.pose_p)
                                        - np.asarray(out_b.pose_p[s])).max()))
    log(f"  max |pose_p batched - alone| {worst:.3g} m")
    assert worst <= 1e-3, f"batched backend differs by {worst} m"
    devs_held = sorted(sh_.device.id for sh_ in out_b.pose_p.addressable_shards)
    assert devs_held == sorted(d.id for d in devs), devs_held
    assert all(sh_.data.shape[0] == 1
               for sh_ in out_b.pose_p.addressable_shards)
    log(f"  streams sharded: one per card on {nd} cards")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path")
    args = ap.parse_args(argv)

    devs = require_gpu(4 if args.four else 1)
    card = card_line()
    kind = devs[0].device_kind
    log(f"[device] {card}")
    log(f"[device] jax: {devs[0].platform} {kind} x{len(jax.devices())}")

    from vins_tpu import default_config

    t0 = time.perf_counter()
    cfg = default_config()
    if args.four:
        sharded_ba_phase(devs)
        batched_backend_phase(devs, cfg)
    else:
        kernel_phase(cfg)
        system_phases(cfg, card.splitlines()[0])
    log(f"[done] {time.perf_counter() - t0:.1f} s after device check")
    print(card, flush=True)   # as nvidia-smi gives it
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
