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
* :func:`copy_to`, :func:`reduce_from` and :func:`gather_from` are the
  tensor-parallel region's conjugate pair and its gather, under autograd:
  a tensor the ranks hold replicated that enters rank-local work goes
  through :func:`copy_to` (identity forward, all-reduce backward); rank-local
  partial sums that become replicated go through :func:`reduce_from`
  (out-of-place all-reduce forward, identity backward); a gather whose
  result every rank uses alike goes through :func:`gather_from` (its
  backward keeps the rank's own slice).  :func:`gather_dim_grad` is the
  gather whose result each rank uses in its own way.  Under
  ``torch.no_grad()`` each forward computes the bits of the plain call.
* :func:`max_over` is a max over the dim, outside autograd.
* :func:`broadcast_from` gives every rank of the dim its rank 0's floats:
  the serving engines' agreed clock.
* :func:`shard_dim` takes a rank's contiguous block of a tensor dimension.
* :func:`block_bounds` splits ``n`` items over the dim in contiguous
  blocks of ``ceil(n / size)``, as a batch-sharded JAX array lays them out
  (the last blocks may be short).

The tensor-parallel forward and backward passes
(:mod:`repro_torch.models.model`) run on the mesh's "model" dim through
:func:`copy_to`, :func:`reduce_from`, :func:`gather_from`,
:func:`gather_dim_grad` and :func:`max_over`; each makes its collectives
through this module's :func:`all_reduce` and :func:`gather_dim`, looked up
at call time, so wrapping those two counts every one of them.
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
    "copy_to",
    "reduce_from",
    "gather_from",
    "max_over",
    "broadcast_from",
    "shard_dim",
    "block_bounds",
]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def axis_rank(mesh, axis: str = "data") -> int:
    """This rank's coordinate on the mesh dim ``axis`` (0 without a mesh, or
    where the mesh has no such dim)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


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


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        # The rank-local gradients summed in fp32, cast once.
        total = grad.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
        return all_reduce(total, ctx.mesh, ctx.axis).to(grad.dtype), None, None


def copy_to(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """``t`` itself, entering work each rank does on its own part; the
    gradient is summed over the mesh dim (every rank's part contributes)."""
    if not (torch.is_grad_enabled() and t.requires_grad):
        return t
    return _CopyTo.apply(t, mesh, axis)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce(t.clone(memory_format=torch.contiguous_format), mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def reduce_from(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The sum of the ranks' partials ``t`` over the mesh dim, in a new
    tensor; every rank uses the sum alike, so its gradient passes to ``t``
    unchanged."""
    return _ReduceFrom.apply(t, mesh, axis)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axis):
        ctx.dim, ctx.size, ctx.rank = dim, t.shape[dim], axis_rank(mesh, axis)
        return gather_dim(t, dim, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None


def gather_from(t: torch.Tensor, dim: int, mesh, axis: str = "model") -> torch.Tensor:
    """:func:`gather_dim` where every rank uses the gathered tensor alike:
    the gradient of the whole is the same on every rank, and each keeps its
    own slice of it."""
    return _GatherFrom.apply(t, dim, mesh, axis)


def max_over(t: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """The elementwise max of ``t`` over the mesh dim, in a new tensor that
    carries no gradient."""
    return all_reduce(t.detach().clone(memory_format=torch.contiguous_format), mesh, axis, "max")


def broadcast_from(values, mesh, axis: str = "model") -> list:
    """Rank 0's ``values`` (floats) of the mesh dim on every rank of it, as
    a list, carried as float64 on the mesh's device type in one broadcast,
    so they arrive exactly.  Every rank passes as many; only rank 0's are
    read."""
    group = mesh.get_group(axis)
    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=dev)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t.tolist()


def shard_dim(t: torch.Tensor, dim: int, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous block of ``t`` along ``dim`` (equal blocks),
    in storage of its own where it is a part (a view would keep the whole
    tensor's bytes alive)."""
    n = axis_size(mesh, axis)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not split over {n} ranks")
    if n == 1:
        return t.contiguous()
    return t.chunk(n, dim)[axis_rank(mesh, axis)].clone(memory_format=torch.contiguous_format)


def block_bounds(n_items: int, n: int, rank: int) -> tuple:
    """``(lo, hi)`` of rank ``rank``'s contiguous block when ``n_items`` split
    over ``n`` ranks in blocks of ``ceil(n_items / n)``."""
    per = -(-n_items // n)
    return min(rank * per, n_items), min((rank + 1) * per, n_items)
