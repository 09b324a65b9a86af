"""Device-mesh construction and sharding helpers.

Axes (SURVEY.md §7.1 "Scale-out"):
  * `batch` — data-parallel independent VIO streams (windows/sequences);
  * `block` — landmark-block partition of distributed bundle adjustment,
    reduced with `psum`.

Every device reaches every other at the same rate (the cards of one host
are joined all to all), so the mesh is a plain reshape of the device
list and follows the algorithm alone.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "batch"
BLOCK_AXIS = "block"


def make_mesh(batch: int = 0, block: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a (batch, block) mesh. batch=0 means "use all remaining
    devices on the batch axis"."""
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if batch == 0:
        assert n % block == 0, f"{n} devices not divisible by block={block}"
        batch = n // block
    use = batch * block
    grid = np.array(devs[:use]).reshape(batch, block)
    return Mesh(grid, (BATCH_AXIS, BLOCK_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding over the batch axis (leaf rank agnostic)."""
    return NamedSharding(mesh, P(BATCH_AXIS))


def block_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(BLOCK_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_leading(tree, sharding: NamedSharding):
    """Device-put every leaf with its leading axis sharded."""
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
