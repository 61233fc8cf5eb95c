"""Device-mesh helpers for stream-batch data parallelism.

The workload has no cross-stream communication (SURVEY.md §2.5): the
only distributed axis is the stream batch.  We shard ``[streams, ...]``
arrays over a 1-D mesh axis ``"streams"``; XLA inserts collectives only
for metric reductions.  No serving path uses the mesh yet: it is
exercised by step-level tests on virtual CPU devices.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

STREAM_AXIS = "streams"


def stream_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (or given) devices with axis ``streams``."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (STREAM_AXIS,))

def stream_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard dim 0 (streams) over the mesh; replicate the rest."""
    spec = P(STREAM_AXIS, *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, *arrays):
    """Place each ``[streams, ...]`` array with dim-0 sharded over the mesh."""
    out = tuple(
        jax.device_put(a, stream_sharding(mesh, np.ndim(a))) for a in arrays
    )
    return out[0] if len(out) == 1 else out
