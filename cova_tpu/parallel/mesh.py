"""Device mesh and sharding helpers.

The reference scales out by fanning one bitstream across 32 entropy
decoder branches and batching their outputs through shared TensorRT
engines (reference: experiment/cova/config.yaml:15,33-35 and gopsplit's
round-robin GoP dealing, gstgopsplit.cpp:501-661). The equivalent
here:

  * GoP ranges / streams form a leading batch axis R;
  * a 1-D `stream` mesh shards R across GPUs with NamedSharding;
  * model parameters are replicated; XLA inserts the collectives.

Training (BlobNet) uses the same mesh data-parallel: batch sharded over
`stream`, parameters replicated, gradients all-reduced by XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

STREAM_AXIS = "stream"


def make_mesh(n_devices: int | None = None, axis: str = STREAM_AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(
            f"requested {n}-device mesh but only {len(devs)} devices "
            f"are visible (set XLA_FLAGS=--xla_force_host_platform_"
            f"device_count=N with JAX_PLATFORMS=cpu for virtual devices)"
        )
    return Mesh(np.array(devs[:n]), (axis,))


def shard_batch(mesh: Mesh, tree, axis: str = STREAM_AXIS):
    """Shard leading axis of every array in the pytree across the mesh."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree)


def replicate(mesh: Mesh, tree):
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(put, tree)
