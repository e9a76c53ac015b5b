"""Quantized serving parameters: restack the solver's ``emit="qt"`` output."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import require_on_device
from repro_torch.quant import QuantizedTensor

__all__ = ["quantize_params_for_serving"]


def _stack_qts(leaves: list) -> QuantizedTensor:
    first = leaves[0]
    static = lambda l: (l.bits, l.group_size, l.packed, l.pack_layout, l.pack_tile,
                        tuple(l.codes.shape), tuple(l.scale.shape))
    if len({static(l) for l in leaves}) != 1:
        raise NotImplementedError(
            "stacking QuantizedTensors of different bits or layouts (mixed "
            "precision) is not ported yet"
        )
    if any(l.outlier_values is not None or l.outlier_col_idx is not None for l in leaves):
        raise NotImplementedError("outlier planes arrive with Algorithm 3's slice")
    return dataclasses.replace(
        first,
        codes=torch.stack([l.codes for l in leaves]),
        scale=torch.stack([l.scale for l in leaves]),
        zero=torch.stack([l.zero for l in leaves]),
    )


def _stack_trees(trees: list):
    first = trees[0]
    if isinstance(first, QuantizedTensor):
        return _stack_qts(trees)
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def quantize_params_for_serving(plan, params: dict, solver_qt_dec: list, *, device="cuda") -> dict:
    """Restack per-period block lists (``ptq_quantize_model(..., emit="qt")``'s
    ``["dec"]``) into the stacked layout the model runs, for uniform bits.
    The params must live on ``device`` (default ``"cuda"``)."""
    require_on_device(params["embed"], device)
    out = dict(params)
    out["dec"] = _stack_trees(solver_qt_dec)
    return out
