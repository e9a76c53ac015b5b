"""Quantized serving parameters: restack the solver's ``emit="qt"`` output."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import require_on_device
from repro_torch.quant import QuantizedTensor, check_zero_points

__all__ = ["quantize_params_for_serving"]


def _stack_qts(leaves: list) -> QuantizedTensor:
    """Stack one leaf's per-period QuantizedTensors: codes, grid and any
    outlier planes gain a leading period dim."""
    values = lambda l: [getattr(l, f.name) for f in dataclasses.fields(l)]
    static = lambda l: tuple(tuple(v.shape) if isinstance(v, torch.Tensor) else v for v in values(l))
    if len({static(l) for l in leaves}) != 1:
        raise NotImplementedError(
            "stacking QuantizedTensors of different bits, layouts or outlier "
            "budgets (mixed precision) is not ported yet"
        )
    first = leaves[0]
    arrays = [f.name for f in dataclasses.fields(first) if isinstance(getattr(first, f.name), torch.Tensor)]
    return dataclasses.replace(first, **{f: torch.stack([getattr(l, f) for l in leaves]) for f in arrays})


def _stack_trees(trees: list):
    first = trees[0]
    if isinstance(first, QuantizedTensor):
        return _stack_qts(trees)
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def quantize_params_for_serving(plan, params: dict, solver_qt_dec: list, *, device="cuda") -> dict:
    """Restack per-period block lists (``ptq_quantize_model(..., emit="qt")``'s
    ``["dec"]``) into the stacked layout the model runs, for uniform bits;
    outlier planes (COO or columns) stack with the codes.
    The params must live on ``device`` (default ``"cuda"``).  Raises
    ``ValueError`` if a zero point is not an integer in ``[0, 2^bits − 1]``
    (the dequant-GEMM's precondition, checked here once per artifact)."""
    require_on_device(params["embed"], device)
    out = dict(params)
    out["dec"] = _stack_trees(solver_qt_dec)
    _check_tree(out["dec"])
    return out


def _check_tree(tree) -> None:
    if isinstance(tree, QuantizedTensor):
        check_zero_points(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _check_tree(v)
