"""Test harness: run everything on a virtual 8-device CPU mesh.

Standard JAX trick for testing pjit/shard_map topologies without real
devices (SURVEY.md §4): XLA_FLAGS gives the CPU backend 8 devices, and the
platform is the CPU whatever JAX_PLATFORMS says. Only `--gpu` adds the
GPU, for the card-only tests (`pytest tests/ -m gpu --gpu -n 0` on the
card), which take the `gpu` fixture.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true",
                     help="run on the GPU beside the CPU (card-only tests)")


def pytest_configure(config):
    platforms = "cuda,cpu" if config.getoption("--gpu") else "cpu"
    os.environ["JAX_PLATFORMS"] = platforms
    jax.config.update("jax_platforms", platforms)


@pytest.fixture
def gpu():
    """The GPU, for a test of code that runs only on the card; skips
    unless the run has one (--gpu)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run with --gpu on the card")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# Shared rendered sequence with a DISK cache: rendering a 110-frame
# 640x480 sequence costs ~1 min of CPU; several slow test files need the
# SAME sequence (same cfg/seed), so cache the rendered images across test
# files AND test sessions (keyed by the render parameters).
# ---------------------------------------------------------------------------
_RENDER_CACHE = os.path.join(os.path.dirname(__file__), ".render_cache")


def render_cached(cfg, n_frames, seed, frame_dt, traj_kwargs,
                  imu_per_frame, n_landmarks=60):
    """(seq, imgs) with imgs memoized on disk (the seq itself is cheap)."""
    from vins_tpu.io.synthetic import (make_synthetic_sequence,
                                       render_sequence_images)

    seq = make_synthetic_sequence(
        cfg, n_frames=n_frames, n_landmarks=n_landmarks, seed=seed,
        frame_dt=frame_dt, traj_kwargs=traj_kwargs,
        imu_per_frame=imu_per_frame)
    key = (f"n{n_frames}_s{seed}_dt{frame_dt:.5f}_l{n_landmarks}_"
           + "_".join(f"{k}{v}" for k, v in sorted(traj_kwargs.items()))
           + f"_h{cfg.camera.height}x{cfg.camera.width}")
    path = os.path.join(_RENDER_CACHE, key + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return seq, z["imgs"]
    imgs = np.asarray(render_sequence_images(seq, cfg, seed=seed))
    os.makedirs(_RENDER_CACHE, exist_ok=True)
    # np.savez appends ".npz" unless the name already ends with it.
    tmp = path + f".tmp{os.getpid()}.npz"
    np.savez_compressed(tmp, imgs=imgs)
    os.replace(tmp, path)
    return seq, imgs


def asl_fixture_cached(n_frames, seed, cam_hz=20.0, traj_kwargs=None,
                       cfg=None, **noise_kwargs):
    """Persistent ASL-fixture tree (PNG renders + csvs are the slow
    part — ~minutes for the 360-frame revisit on a 2-core host): the
    tree is generated once under tests/.render_cache and reused across
    test sessions. noise_kwargs (gyr_noise/gyr_walk/acc_noise/acc_walk/
    image_noise) pass through to generate_asl_fixture and key the cache
    — the drift-visible fixtures crank the IMU random walk. Returns
    (root, FixtureTruth)."""
    from vins_tpu.config import euroc_config
    from vins_tpu.io.asl_fixture import FixtureTruth, generate_asl_fixture

    cfg = cfg or euroc_config()
    key = (f"asl_n{n_frames}_s{seed}_hz{cam_hz:g}_"
           + "_".join(f"{k}{v}" for k, v in
                      sorted((traj_kwargs or {}).items()))
           + "".join(f"_{k}{v:g}" for k, v in sorted(noise_kwargs.items())))
    root = os.path.join(_RENDER_CACHE, key)
    truth_npz = os.path.join(root, "truth.npz")
    if os.path.exists(truth_npz):
        with np.load(truth_npz) as z:
            return root, FixtureTruth(cam_ts=z["cam_ts"], p=z["p"],
                                      q=z["q"])
    truth = generate_asl_fixture(root, cfg, n_frames=n_frames,
                                 cam_hz=cam_hz, seed=seed,
                                 traj_kwargs=traj_kwargs, **noise_kwargs)
    tmp = truth_npz + f".tmp{os.getpid()}.npz"
    np.savez_compressed(tmp, cam_ts=truth.cam_ts, p=truth.p, q=truth.q)
    os.replace(tmp, truth_npz)
    return root, truth
