"""chip_smoke.py's own checks, on the CPU: it refuses to run without a
GPU, and its four-card comparisons hold on four virtual CPU devices at a
small size."""
import importlib.util
import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_check_refuses_cpu():
    cs = _load()
    with pytest.raises(SystemExit) as e:
        cs.require_gpu()
    assert e.value.code != 0 and "no GPU" in str(e.value.code)


def test_script_exits_nonzero_without_gpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_four_card_checks_on_virtual_devices():
    import dataclasses

    from vins_tpu import default_config

    cs = _load()
    devs = jax.devices()[:4]
    assert len(devs) == 4
    cs.sharded_ba_phase(devs, n_poses=8, n_landmarks=64, iters=3)
    cfg = default_config()
    cfg = cfg.replace(window=dataclasses.replace(cfg.window,
                                                 max_landmarks=32))
    cs.batched_backend_phase(devs, cfg)
