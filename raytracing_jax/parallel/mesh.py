"""Device-mesh scaling.

The reference's parallelism is threads pulling 32x32 chunks off an atomic
counter (SURVEY §2 parallelism table). Here: batches of pixels go to the
devices of a 1-D `jax.sharding.Mesh` axis ("rays"), one batch per device;
the scene/BVH is replicated per device (helmet-scale geometry is ~5 MB —
trivially replicable); tracing needs NO collectives, and the only
cross-device traffic is the per-batch image readback (SURVEY §2
"Distributed communication backend").

Rays are embarrassingly parallel, so this is pure data parallelism; there is
no model to TP/PP (the reference has no parameters), and the "long axis"
(pixels x spp) shards exactly like the reference's chunk counter distributed
work across threads.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for per-ray/per-pixel arrays: split the leading axis."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Sharding for the scene pytree: replicate on every chip."""
    return NamedSharding(mesh, P())


def shard_scene(scene, mesh: Mesh):
    return jax.device_put(scene, replicated(mesh))


def shard_rays(arr, mesh: Mesh):
    return jax.device_put(arr, ray_sharding(mesh))
