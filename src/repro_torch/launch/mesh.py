"""Mesh builders over ``torch.distributed``.

The port of ``repro/launch/mesh.py``.  The production meshes keep
``repro``'s shapes: (data=16, model=16) = 256 ranks, and (pod=2, data=16,
model=16) = 512 ranks.  A ``DeviceMesh`` needs a process group of as many
ranks as the mesh has (``torchrun`` makes one, or ``init_process_group``
with an address, a world size and a rank; the dry run uses torch's
``"fake"`` backend, one process standing for every rank).  Functions, not
module constants, so importing never touches process-group state.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` on the running
    process group, whose size must be ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: {len(shape)} dims, {len(axes)} names")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh{shape}: no process group; start {n} ranks "
            f"(torchrun --nproc-per-node {n}, or init_process_group with "
            f"world_size={n})")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"make_mesh{shape}: the process group has "
            f"{dist.get_world_size()} ranks, the mesh needs {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def production_shape(multi_pod: bool = False):
    """(shape, axes) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    return make_mesh(*production_shape(multi_pod), device_type=device_type)
