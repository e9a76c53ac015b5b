"""Meshes over the ranks of the default process group (the port's
``repro.launch.mesh``).

The reference builds a JAX mesh over the local devices of one process; the
port runs one rank per device (``torchrun``, or ranks spawned by a test)
and builds a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dims over their ranks.  Functions, not constants: importing this module
touches no process group.  ``make_production_mesh`` comes with the dry-run
slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["make_data_mesh", "mesh_devices"]


def make_data_mesh(n: Optional[int] = None, *, device="cuda"):
    """A 1-D ("data",) mesh over ranks ``0 .. n-1`` of the default process
    group (default: all of them), on ``device``'s type (the card unless the
    caller asks for the CPU).

    The PTQ launcher's sharding unit (``launch.quantize --shard``): Σ
    accumulation splits the calibration sequences over it, the CD solve
    splits output rows over it.  Returns None for a single rank; callers
    take the local path on None.  Every rank of the group must call it.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n is None else n
    if n <= 1:
        return None
    if n > world:
        raise ValueError(f"a data mesh of {n} ranks needs a process group of at least {n}, "
                         f"have {world}")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(torch.device(device).type, torch.arange(n), mesh_dim_names=("data",))


def mesh_devices(mesh) -> int:
    """The number of ranks (devices) of ``mesh``."""
    n = 1
    for v in tuple(mesh.shape):
        n *= v
    return n
