"""Data-parallel VIO: B independent sliding-window streams per step.

The reference processes one camera stream on one phone; the frame here
for throughput is `vmap(backend_step)` over a leading stream axis whose
shards live on the `batch` mesh axis. No collectives are needed — streams
are independent — so scaling is embarrassingly parallel and efficiency is
bounded only by per-device occupancy.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import VinsConfig
from ..core.estimator import BackendState, FrameInput, backend_step
from ..core.factors import Extrinsics
from .mesh import BATCH_AXIS


def stack_states(states) -> BackendState:
    """Stack per-stream BackendStates along a new leading axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def stack_inputs(inputs) -> FrameInput:
    return jax.tree.map(lambda *xs: jnp.stack(xs), *inputs)


def make_batched_step(cfg: VinsConfig, ext: Extrinsics, gravity: jax.Array,
                      mesh: Mesh) -> Callable:
    """Compile one data-parallel backend step:
    (BackendState[B,...], FrameInput[B,...]) → (state, outputs).

    The leading (stream) axis of every leaf is sharded over the mesh's
    batch axis; everything else is replicated per device.
    """
    sh = NamedSharding(mesh, P(BATCH_AXIS))

    def step(est_b, inp_b):
        est_b = jax.lax.with_sharding_constraint(est_b, sh)
        inp_b = jax.lax.with_sharding_constraint(inp_b, sh)
        return jax.vmap(
            lambda e, i: backend_step(e, i, cfg, ext, gravity))(est_b, inp_b)

    return jax.jit(step, out_shardings=(sh, sh))


def make_batched_sequence_runner(cfg: VinsConfig, ext: Extrinsics,
                                 gravity: jax.Array, mesh: Mesh) -> Callable:
    """Compile a whole-sequence data-parallel runner:
    (BackendState[B], FrameInput[B, T]) → (final state, outputs[B, T]).

    scan over T on the inside, vmap over B on the outside: one device
    program per call, host dispatch amortized over B·T frames. Failure
    handling freezes a stream's state at its last good window (matching
    run_sequence_scan's semantics).
    """
    sh = NamedSharding(mesh, P(BATCH_AXIS))

    def run_one(est, inputs):
        def f(e, inp):
            e2, out = backend_step(e, inp, cfg, ext, gravity)
            e2 = jax.tree.map(lambda a, b: jnp.where(out.failure, a, b), e, e2)
            return e2, out

        return jax.lax.scan(f, est, inputs)

    def run(est_b, inputs_bt):
        est_b = jax.lax.with_sharding_constraint(est_b, sh)
        inputs_bt = jax.lax.with_sharding_constraint(inputs_bt, sh)
        return jax.vmap(run_one)(est_b, inputs_bt)

    return jax.jit(run, out_shardings=(sh, sh))
