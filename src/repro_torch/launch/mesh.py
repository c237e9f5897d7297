"""Device meshes (port of ``repro/launch/mesh.py``).

Functions, never module-level meshes: importing this module touches no
process group.  Each builds a ``DeviceMesh`` over the initialised world
(``torch.distributed.init_process_group`` first: NCCL or gloo across
processes, or the fake backend for the dry-run), on ``cuda`` unless the
caller asks for ``cpu``.  The shapes and axis names are the reference's,
so the cells stay the reference's cells.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16 x 16 ('data', 'model'), 256 ranks, or 2 x 16 x 16 ('pod', 'data',
    'model'), 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(data: Optional[int] = None, model: int = 1,
                    device_type: str = "cuda") -> DeviceMesh:
    """A ('data', 'model') mesh over the world's ranks; ``data`` defaults
    to the world size over ``model``."""
    n = dist.get_world_size()
    data = data if data is not None else max(1, n // model)
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
