"""Int8-quantized FSDP gather (the port's ``repro.dist.qgather``), kept out
of default configs as in the reference.

Under FSDP each period's weights are gathered before use.  Gathering bf16
moves 2 bytes a parameter; quantizing each shard to int8 codes with one
fp32 scale per leading row, gathering codes and scales over "data", and
dequantizing after, moves about half that.

:func:`make_period_transform` returns a function applied to one period's
params (``ModelPlan.param_transform``): each float leaf of 2 or more
dimensions becomes ``codes · scale`` in its dtype, gathered whole; smaller
or integer leaves are gathered unquantized.  Codes and scales follow the
reference's arithmetic: ``scale = max |x| over the row / 127 + 1e-12``,
``codes = clip(round(x / scale), -127, 127)``.  Where the data axis shards
a dimension other than the leading one, a row's maximum is taken over the
whole row (an ``all_reduce`` of the shards' maxima), as the reference's
global reduction gives it.
"""

from __future__ import annotations

import torch

from repro_torch.dist.collectives import all_reduce, axis_size, gather_dim
from repro_torch.dist.sharding import Rules
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["make_period_transform", "int8_rows"]

_QUANT_DTYPES = (torch.bfloat16, torch.float32, torch.float16)


def int8_rows(x: torch.Tensor, mesh=None, dim=None) -> tuple:
    """``(codes int8, scale fp32 (rows, 1, …))`` of ``x`` per leading row;
    ``dim``: the dimension the mesh's data dim shards ``x`` on (None:
    whole), whose row maxima are reduced over the mesh."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True)
    if dim is not None and dim != 0 and axis_size(mesh) > 1:
        all_reduce(amax, mesh, op="max")
    scale = amax / 127.0 + 1e-12
    codes = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def _gather_int8(x: torch.Tensor, mesh, dim) -> torch.Tensor:
    """Quantize per leading row, gather codes and scales, dequantize."""
    codes, scale = int8_rows(x, mesh, dim)
    if dim is not None:
        codes = gather_dim(codes, dim, mesh)
        if dim == 0:
            scale = gather_dim(scale, 0, mesh)
    return (codes.to(torch.float32) * scale).to(x.dtype)


def make_period_transform(period_axes, rules: Rules, rep_rules: Rules):
    """The per-period transform: FSDP layout (``rules``) → replicated.
    ``rep_rules`` is the reference's target layout; on a data mesh it is
    every leaf whole on every rank, which is what the gather gives.

    ``period_axes``: the logical-axes tree of one period's params (the
    stacked "layers" axis already stripped)."""
    flat_ax = tree_flatten(period_axes, is_leaf=lambda x: isinstance(x, tuple))[0]
    mesh = rules.mesh

    def transform(p_period):
        flat_p, treedef = tree_flatten(p_period)
        out = []
        for leaf, ax in zip(flat_p, flat_ax):
            dim = rules.shard_dim(tuple(ax))
            if leaf.ndim >= 2 and leaf.dtype in _QUANT_DTYPES:
                out.append(_gather_int8(leaf, mesh, dim))
            else:
                out.append(leaf if dim is None else gather_dim(leaf, dim, mesh))
        return tree_unflatten(treedef, out)

    return transform
