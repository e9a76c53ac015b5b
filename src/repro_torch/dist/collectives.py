"""The collectives the port's data-parallel paths use, over one named dim of
a :class:`torch.distributed.device_mesh.DeviceMesh`.

They stand for the reference's ``psum`` and the gathers and
reduce-scatters GSPMD inserts: each is one explicit ``torch.distributed``
call on the mesh dim's process group.  NCCL runs them on the card, gloo on
the CPU (and, two ranks on one card, on CUDA tensors as well).

* :func:`all_reduce` sums (or maxes, mins) a tensor in place over the dim.
* :func:`gather_dim` concatenates equal shards along a tensor dimension;
  :func:`gather_dim_grad` does the same inside autograd, its backward the
  reduce-scatter (sum) of the gradient back to each rank's shard, which is
  how an FSDP gradient arrives sharded.
* :func:`shard_dim` takes a rank's contiguous block of a tensor dimension.
* :func:`block_bounds` splits ``n`` items over the dim in contiguous
  blocks of ``ceil(n / size)``, as a batch-sharded JAX array lays them out
  (the last blocks may be short).

The tensor-parallel forward pass (:mod:`repro_torch.models.model`) calls
:func:`all_reduce` and :func:`gather_dim` on the mesh's "model" dim.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "axis_rank",
    "axis_size",
    "all_reduce",
    "gather_dim",
    "gather_dim_grad",
    "shard_dim",
    "block_bounds",
]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def axis_rank(mesh, axis: str = "data") -> int:
    """This rank's coordinate on the mesh dim ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_size(mesh, axis: str = "data") -> int:
    if mesh is None:
        return 1
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get(axis, 1)


def all_reduce(t: torch.Tensor, mesh, axis: str = "data", op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over the mesh dim (every rank gets the same
    result); returns ``t``."""
    dist.all_reduce(t, op=_OPS[op], group=mesh.get_group(axis))
    return t


def gather_dim(t: torch.Tensor, dim: int, mesh, axis: str = "data") -> torch.Tensor:
    """The mesh dim's equal shards of ``t`` concatenated along ``dim``, in
    rank order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, src, group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _reduce_scatter_dim(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=mesh.get_group(axis))
    return out.movedim(0, dim)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axis):
        ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
        return gather_dim(t, dim, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_dim(grad, ctx.dim, ctx.mesh, ctx.axis), None, None, None


def gather_dim_grad(t: torch.Tensor, dim: int, mesh, axis: str = "data") -> torch.Tensor:
    """:func:`gather_dim` under autograd: the gradient of the gathered
    tensor is summed over the mesh dim and each rank keeps its own shard
    (a reduce-scatter)."""
    return _GatherDim.apply(t, dim, mesh, axis)


def shard_dim(t: torch.Tensor, dim: int, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous block of ``t`` along ``dim`` (equal blocks)."""
    n = axis_size(mesh, axis)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not split over {n} ranks")
    return t.chunk(n, dim)[axis_rank(mesh, axis)].contiguous()


def block_bounds(n_items: int, n: int, rank: int) -> tuple:
    """``(lo, hi)`` of rank ``rank``'s contiguous block when ``n_items`` split
    over ``n`` ranks in blocks of ``ceil(n_items / n)``."""
    per = -(-n_items // n)
    return min(rank * per, n_items), min((rank + 1) * per, n_items)
