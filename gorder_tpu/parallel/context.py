"""Run-scoped device-mesh context for the analysis pipeline.

When several devices are visible, the pipeline data-parallelizes over
trajectory frames: per-batch arrays (leading frame axis) are sharded over a
1-D 'frames' mesh and constant tensors (bond indices, one-hots, selection
tables) are replicated, so every jitted kernel partitions automatically
under GSPMD — the device-native form of the reference's frame-round-robin
threading (SURVEY.md §2.7). `GORDER_TPU_MESH=0` disables, `=N` caps the
device count; the count is clipped to a divisor of the frame batch size.

The active mesh is a run-scoped module global (the pipeline is driven by a
single host thread); `activate()/deactivate()` bracket one analysis run.
"""

from __future__ import annotations

import os

_ACTIVE = None


def activate(batch_size: int):
    """Build and activate a frames mesh for this run (None = single device)."""
    global _ACTIVE
    import jax

    env = os.environ.get("GORDER_TPU_MESH", "")
    if env == "0":
        _ACTIVE = None
        return None
    devices = jax.devices()
    n = len(devices)
    if env.isdigit() and int(env) > 0:
        n = min(n, int(env))
    while n > 1 and batch_size % n:
        n -= 1
    if n <= 1:
        _ACTIVE = None
        return None
    from .mesh import frame_mesh

    _ACTIVE = frame_mesh(devices[:n])
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_mesh():
    return _ACTIVE


def put_const(x):
    """Device-put a constant tensor: replicated over the active mesh."""
    import jax

    if _ACTIVE is not None:
        from .mesh import replicated_sharding

        return jax.device_put(x, replicated_sharding(_ACTIVE))
    return jax.device_put(x)


def put_frames(x):
    """Device-put a per-frame array (leading batch axis): frame-sharded."""
    import jax

    if _ACTIVE is not None:
        from .mesh import batch_sharding

        return jax.device_put(x, batch_sharding(_ACTIVE))
    return jax.device_put(x)
