"""Distributed-BA scaling harness.

Measures strong-scaling of the landmark-sharded Schur BA over the mesh's
`block` axis and breaks each iteration into compute vs collective
(psum-of-reduced-camera-system) terms, so the ≥70 %-to-2-hosts north star
(BASELINE.md) can be projected from single-host measurements.

On the virtual CPU mesh the wall-clock numbers are indicative only; the
analytic model is the transferable part:

  per LM iteration and shard (L landmarks over B shards, K poses):
    compute ≈ (L/B)·K·c_lin  FLOPs for residual/Jacobian/normal eqs
              + (L/B)·(6K)²·3 for the local Schur contribution
    comm     = one psum of a [6K,6K]+[6K] fp32 buffer
             → ring all-reduce moves 2·(B−1)/B · bytes per link

  With K=64 poses the psum payload is 4·(384²+384) ≈ 0.6 MB; over
  NVLink's 450 GB/s each way that is a few µs — far below the per-shard
  compute at map-scale landmark counts.
"""
from __future__ import annotations

import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np


def scaling_report(blocks=(1, 2, 4, 8), n_poses: int = 16,
                   n_landmarks: int = 512, iters: int = 5,
                   n_rep: int = 3) -> List[dict]:
    """Strong-scaling table for solve_ba_sharded on the available devices.
    Returns one row per block count with measured wall time, speedup,
    efficiency, and the analytic comm payload."""
    from ..io.synthetic import make_ba_problem
    from .dist_ba import solve_ba_sharded
    from .mesh import make_mesh

    rows = []
    t1 = None
    for b in blocks:
        if b > len(jax.devices()):
            continue
        mesh = make_mesh(batch=1, block=b, devices=jax.devices()[:b])
        gt, init, prob = make_ba_problem(
            n_poses=n_poses, n_landmarks=n_landmarks, seed=0,
            pose_noise=0.02, point_noise=0.05)

        import functools
        run = jax.jit(functools.partial(
            solve_ba_sharded, mesh=mesh, iters=iters))
        st, cost, _ = run(init, prob)          # compile + warm
        jax.block_until_ready(cost)
        t0 = time.perf_counter()
        for _ in range(n_rep):
            st, cost, _ = run(init, prob)
        jax.block_until_ready(cost)
        dt = (time.perf_counter() - t0) / n_rep

        if t1 is None:
            t1 = dt
        K = n_poses
        psum_bytes = 4 * ((6 * K) ** 2 + 6 * K)
        rows.append({
            "block": b,
            "landmarks_per_shard": n_landmarks // b,
            "wall_s_per_solve": round(dt, 5),
            "speedup": round(t1 / dt, 3),
            "efficiency": round(t1 / dt / b, 3),
            "psum_bytes_per_iter": psum_bytes,
            "final_cost": float(cost),
        })
    return rows


def format_scaling_md(rows: List[dict], header: str = "") -> str:
    lines = [header, "",
             "| block | lm/shard | s/solve | speedup | efficiency | psum B/iter |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['block']} | {r['landmarks_per_shard']} | "
            f"{r['wall_s_per_solve']} | {r['speedup']} | "
            f"{r['efficiency']} | {r['psum_bytes_per_iter']} |")
    return "\n".join(lines) + "\n"
