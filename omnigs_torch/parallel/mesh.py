"""The (data, gauss) device mesh over a `torch.distributed` process group,
and the collectives the sharded path runs on its dims.

Counterpart of `omnigs_tpu/parallel/mesh.py`. One process per rank, one
device per rank:

* ``data``  — view parallelism: each data row trains on its own keyframes;
  parameter gradients average over the row's ranks;
* ``gauss`` — Gaussian parallelism: the capacity axis (parameters, Adam
  moments, preprocess) is split over the ranks of a data row, which
  composite disjoint tile windows after an all-gather of the compact
  per-Gaussian raster state.

Rank r sits at (r // gauss, r % gauss): the data dim is outermost, so the
ranks of one data row are consecutive (on one host when a host holds a
row). A dim of size 1 runs no collective at all: its all-gather, reduce-
scatter and all-reduce are the identity.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
GAUSS_AXIS = "gauss"


def make_mesh(
    data: int = 1, gauss: Optional[int] = None, device_type: Optional[str] = None
) -> DeviceMesh:
    """A (data, gauss) `DeviceMesh` over the initialized process group
    (`parallel/distributed.initialize`); ``gauss`` defaults to the ranks
    left over. ``device_type`` is "cuda" under NCCL and "cpu" otherwise
    unless given (two gloo ranks sharing one card pass "cuda")."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "omnigs_torch.parallel.distributed.initialize(...) first"
        )
    world = dist.get_world_size()
    if gauss is None:
        if world % data:
            raise ValueError(f"{world} ranks do not split into {data} data rows")
        gauss = world // data
    if data * gauss != world:
        raise ValueError(f"mesh ({data}, {gauss}) needs {data * gauss} ranks, not {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, gauss), mesh_dim_names=(DATA_AXIS, GAUSS_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The ranks' ``x`` (same shape on each) stacked along dim 0 in rank
    order of ``axis``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.get_group(axis))
    return out


def reduce_scatter(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum of the ranks' ``x`` over ``axis``, this rank's 1/n of dim 0."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=mesh.get_group(axis))
    return out


def all_reduce(
    x: torch.Tensor, mesh: DeviceMesh, axis: str, op=dist.ReduceOp.SUM
) -> torch.Tensor:
    """``op`` of the ranks' ``x`` over ``axis`` (a new tensor)."""
    if axis_size(mesh, axis) == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, op=op, group=mesh.get_group(axis))
    return x
