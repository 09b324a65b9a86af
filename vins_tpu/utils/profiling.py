"""Tracing / profiling: scoped stage timers + XLA cost analysis.

Replaces the reference's TS/TE tick-count macro pair
(VINS_ios/global_param.hpp:85-92, used around the Ceres solve
VINS.cpp:657-662, marginalization VINS.cpp:753-758, feature tracking
ViewController.mm:443,459) with:

  * `stage(name)` — a context manager that accumulates wall time per
    stage, blocking on device results so the number means what it says;
  * `StageTimers.report()` — the live metrics dashboard role of the
    reference's UI labels (ViewController.mm:1176-1276);
  * `trace(dir)` — wraps `jax.profiler.trace` for TensorBoard-level XLA
    traces;
  * `cost_analysis(fn, *args)` — compiled FLOP/byte counts from XLA, the
    speed-of-light denominator for kernel efficiency checks
    (SURVEY.md §5.1: "XLA cost analysis for speed-of-light checks").
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

import jax


class StageTimers:
    """Accumulating per-stage wall timers (TS/TE equivalent)."""

    def __init__(self, sync: bool = True):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.last_s: Dict[str, float] = {}
        self.sync = sync

    @contextlib.contextmanager
    def stage(self, name: str, result: Any = None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            out = box.get("result", result)
            if self.sync and out is not None:
                jax.block_until_ready(out)
            dt = time.perf_counter() - t0
            self.total_s[name] += dt
            self.count[name] += 1
            self.last_s[name] = dt

    def mean_ms(self, name: str) -> float:
        c = self.count.get(name, 0)
        return 1e3 * self.total_s[name] / c if c else 0.0

    def report(self) -> str:
        rows = [f"{'stage':24s} {'calls':>6s} {'mean ms':>9s} {'last ms':>9s}"]
        for name in sorted(self.total_s, key=lambda n: -self.total_s[n]):
            rows.append(
                f"{name:24s} {self.count[name]:6d} "
                f"{self.mean_ms(name):9.3f} "
                f"{1e3 * self.last_s.get(name, 0.0):9.3f}")
        return "\n".join(rows)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {n: {"calls": self.count[n], "mean_ms": self.mean_ms(n),
                    "total_s": self.total_s[n]} for n in self.total_s}


# Module-level default registry (the reference's macros are global too).
timers = StageTimers()


@contextlib.contextmanager
def trace(log_dir: str):
    """Device trace for TensorBoard/Perfetto (`jax.profiler.trace`)."""
    with jax.profiler.trace(log_dir):
        yield


def cost_analysis(fn: Callable, *args, static_argnums=()) -> Dict[str, float]:
    """Compiled-program cost counters from XLA.

    Returns a dict with at least `flops` and `bytes accessed` when the
    backend reports them (CPU and GPU both do). Use as the numerator-free
    side of a speed-of-light estimate: achieved_time vs
    flops/peak_flops and bytes/peak_bw.
    """
    jfn = jax.jit(fn, static_argnums=static_argnums)
    compiled = jfn.lower(*args).compile()
    costs = compiled.cost_analysis()
    if isinstance(costs, (list, tuple)):  # older jax returns [dict]
        costs = costs[0] if costs else {}
    return dict(costs) if costs else {}


# Published peaks per device, keyed by jax `Device.device_kind`. The
# package runs every f32 matmul at "highest" precision (no TF32), so the
# compute peak is the FP32 rate outside the tensor cores. Source: NVIDIA
# H100 SXM data sheet (dense rates, 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_per_s": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device_kind: str) -> Dict[str, float]:
    """Peak FP32 FLOP/s and HBM bytes/s of a device; an unknown device is
    an error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add it to PEAKS") from None


def roofline(flops: float, nbytes: float, device_kind: str,
             measured_s: Optional[float] = None) -> Dict[str, float]:
    """Compute- and memory-bound time lower bounds of `flops` and
    `nbytes` against the device's peaks (device_peaks), and, when
    `measured_s` is given, the fraction of speed-of-light achieved."""
    peaks = device_peaks(device_kind)
    t_compute = flops / peaks["flops_per_s"]
    t_memory = nbytes / peaks["hbm_bytes_per_s"]
    bound = max(t_compute, t_memory)
    out = {"flops": flops, "bytes": nbytes,
           "t_compute_s": t_compute, "t_memory_s": t_memory,
           "t_bound_s": bound}
    if measured_s is not None and bound > 0:
        out["sol_fraction"] = bound / measured_s
    return out


def speed_of_light(fn: Callable, *args, device_kind: str,
                   measured_s: Optional[float] = None) -> Dict[str, float]:
    """roofline() of a jitted fn from XLA's flop and byte counts.

    XLA counts the body of a while loop (fori_loop, scan, while_loop)
    once, whatever its trip count, so this is a bound only for loop-free
    programs; count a looped program analytically and call roofline().
    """
    costs = cost_analysis(fn, *args)
    return roofline(float(costs.get("flops", 0.0)),
                    float(costs.get("bytes accessed", 0.0)), device_kind,
                    measured_s)
