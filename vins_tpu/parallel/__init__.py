"""Scale-out layer: device meshes, data-parallel VIO streams, and
block-sharded distributed bundle adjustment.

The reference is a single-process mobile app whose only parallelism is
five pthreads (SURVEY.md §2.3); the equivalents here are first-class:
`jax.sharding.Mesh` + `shard_map`, with an XLA collective (psum) for the
distributed normal-equation reduction.
"""
from .mesh import make_mesh, batch_sharding, replicated_sharding
from .batched import make_batched_step, make_batched_sequence_runner, \
    stack_states, stack_inputs
from .dist_ba import BAProblem, BAState, solve_ba, solve_ba_sharded
from .harvest import apply_ba_result, harvest_ba_problem
from .scaling import format_scaling_md, scaling_report

__all__ = [
    "make_mesh", "batch_sharding", "replicated_sharding",
    "make_batched_step", "make_batched_sequence_runner",
    "stack_states", "stack_inputs",
    "BAProblem", "BAState", "solve_ba", "solve_ba_sharded",
    "apply_ba_result", "harvest_ba_problem",
    "format_scaling_md", "scaling_report",
]
