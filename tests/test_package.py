"""Package-level settings: the persistent compilation cache location."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is used as is; otherwise the
    package keeps its cache at the fixed <checkout>/.xla_cache. Run in a
    fresh interpreter: the setting is applied at import."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    want = os.path.join(ROOT, ".xla_cache")
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, vins_tpu; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        check=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == want
