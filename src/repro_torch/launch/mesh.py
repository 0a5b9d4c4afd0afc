"""Meshes over the ranks of a process group (port of repro/launch/mesh.py).

Functions, not module-level constants, so importing this module touches
no process group. The production meshes are a single pod of 16 x 16 =
256 ranks over ('data', 'model') and two pods of 16 x 16 with a leading
'pod' axis (pure DP across the slow inter-pod link); the host mesh is
(1, world, 1) over ('pod', 'data', 'model'), the world size being what
``python -m torch.distributed.run`` started. Each mesh is a `DeviceMesh`
on the rank's device (`distributed.collectives.rank_device`).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch.distributed as dist

from repro_torch.distributed import collectives


def production_shape(multi_pod: bool = False) -> Dict[str, int]:
    """Axis name -> size of the production mesh."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def host_shape(world: int) -> Dict[str, int]:
    """Axis name -> size of the host mesh over ``world`` ranks."""
    return {"pod": 1, "data": world, "model": 1}


def make_mesh(shape: Mapping[str, int], device=None):
    """A `DeviceMesh` of ``shape`` (axis name -> size, in mesh order) over
    the world's ranks, joining the process group first if need be; the
    world must have exactly as many ranks as the mesh."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    dev = collectives.init(device)
    world = dist.get_world_size()
    n = 1
    for size in shape.values():
        n *= size
    if n != world:
        raise ValueError(f"a mesh of {dict(shape)} needs {n} ranks; this world has {world}")
    ranks = torch.arange(world).reshape(tuple(shape.values()))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(shape))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    return make_mesh(production_shape(multi_pod), device)


def make_host_mesh(device=None):
    """(1, world, 1) over ('pod', 'data', 'model') (tests and examples)."""
    collectives.init(device)
    return make_mesh(host_shape(dist.get_world_size()), device)
