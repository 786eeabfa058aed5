"""Multi-chip execution: data parallelism over trajectory frames.

The reference's only parallelism is round-robin frame threading over OS
threads with an associative merge (SURVEY.md §2.7). The device-native
equivalent: frame batches are sharded across a 1-D device mesh on the
'frames' axis; every kernel in gorder_tpu.core is a pure per-frame map
followed by a per-frame reduction, so sharding the batch axis requires no
communication at all — the (B, 3, T) per-frame partial sums come back
frame-sharded and the exact fixed-point accumulation on the host is
order-invariant (the analogue of the reference's thread-count invariance).

For fully device-side reduction (e.g. benchmarking without host round
trips), `psum_over_frames` folds the batch axis with an ICI psum.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def frame_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'frames'."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), ("frames",))


def shard_batch(mesh: Mesh, *arrays):
    """Place per-frame arrays (leading batch axis) sharded over the mesh."""
    sharding = NamedSharding(mesh, P("frames"))
    out = tuple(jax.device_put(a, sharding) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, *arrays):
    """Place static arrays (index tensors, one-hots) replicated."""
    sharding = NamedSharding(mesh, P())
    out = tuple(jax.device_put(a, sharding) for a in arrays)
    return out if len(out) > 1 else out[0]


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("frames"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
