"""The process-group side of the distributed strategies: the mesh a problem
runs on, and the gather of a result to every rank.

The port runs PyTorch's SPMD model: one process per rank, each calling the
same entry point with the same host problem and computing its own shard.
The caller starts the processes and initialises the default process group
(``torchrun --nproc-per-node N``, or ``torch.multiprocessing.spawn`` and
``torch.distributed.init_process_group``: NCCL on the card, gloo on the
CPU); nothing here starts a process or initialises a group.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# (default group, device type, shape, names) -> DeviceMesh
_MESHES: dict = {}


def _world(n_ranks: int, what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialised torch.distributed process group of "
            f"{n_ranks} ranks (torch.distributed.init_process_group, or "
            f"torchrun); none is initialised")
    world = dist.get_world_size()
    if world != n_ranks:
        raise ValueError(f"{what} has {n_ranks} ranks; the process group has "
                         f"{world}")


def resolve_mesh(mesh, shape: Sequence[int], names: Sequence[str],
                 device: torch.device, what: str = "the problem"):
    """The ``DeviceMesh`` a problem of mesh ``shape`` (one size per name in
    ``names``) runs on: ``mesh`` itself, checked, or for ``mesh=None`` the
    row-major mesh of the default process group on ``device``'s type
    (``init_device_mesh``, made once per group and shape).  Raises if no
    group is initialised, if its world size is not the problem's rank count,
    or if ``mesh`` has another shape, names or device type."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    _world(math.prod(shape), what)
    if mesh is None:
        from torch.distributed.device_mesh import init_device_mesh

        key = (device.type, shape, names)
        pg, hit = _MESHES.get(key, (None, None))
        if pg is not dist.group.WORLD:
            hit = init_device_mesh(device.type, shape, mesh_dim_names=names)
            _MESHES[key] = (dist.group.WORLD, hit)
        return hit
    if (tuple(mesh.shape) != shape
            or tuple(mesh.mesh_dim_names or ()) != names):
        raise ValueError(f"{what} needs a mesh {dict(zip(names, shape))}; "
                         f"got {tuple(mesh.shape)} named "
                         f"{mesh.mesh_dim_names}")
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the device "
                         f"{device}")
    return mesh


def group_of(mesh, name: str) -> Optional[object]:
    """The process group of mesh dimension ``name``, or None when that
    dimension has one rank (no collective is needed over it)."""
    if mesh.shape[mesh.mesh_dim_names.index(name)] == 1:
        return None
    return mesh.get_group(name)


def global_rank(mesh, *coord: int) -> int:
    """The default group's rank at mesh coordinate ``coord``."""
    return int(mesh.mesh[coord])


def gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of every rank, stacked [ranks, *x.shape] in the mesh's
    row-major order, on every rank (one ``all_gather_into_tensor`` over the
    default group, which the mesh spans)."""
    x = x.contiguous()
    world = dist.get_world_size()
    out = x.new_empty((world * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x)
    out = out.view((world,) + tuple(x.shape))
    order = mesh.mesh.flatten().to(device=out.device, dtype=torch.long)
    return out.index_select(0, order)
