"""Quantized serving parameters: restack the solver's ``emit="qt"`` output,
and the weight-layout prepack of a serving artifact.

The port's dequant-GEMM reads packed 4-bit codes in the linear layout, so
on the port's own backends (``"cuda"``, ``"cpu"``) every leaf stays linear.
``backend="tpu"`` reproduces the reference's tile-native prepack and its
decision labels, for an artifact that goes back to the JAX package; the
port un-prepacks such leaves where they enter it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import require_on_device
from repro_torch.quant import QuantizedTensor, check_zero_points
from repro_torch.quant.pack import prepack_codes, select_tile_k, unpack_codes

__all__ = ["quantize_params_for_serving", "prepack_params_for_serving"]


def _stack_qts(leaves: list) -> QuantizedTensor:
    """Stack one leaf's per-period QuantizedTensors: codes, grid and any
    outlier planes gain a leading period dim."""
    values = lambda l: [getattr(l, f.name) for f in dataclasses.fields(l)]
    static = lambda l: tuple(tuple(v.shape) if isinstance(v, torch.Tensor) else v for v in values(l))
    if len({static(l) for l in leaves}) != 1:
        raise NotImplementedError(
            "stacking QuantizedTensors of different bits, layouts or outlier "
            "budgets (a mixed-precision emit='qt' artifact) needs harmonize_qt_stack, "
            "which is not ported yet (ROADMAP queue 1 item 5); emit='fake' serves "
            "mixed precision"
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


def _tpu_tile(q: int, p: int, group_size) -> Optional[int]:
    """The k-tile where the reference's layout chooser
    (``repro.roofline.analysis.choose_weight_layout``) picks the tile-native
    layout for a packed 4-bit ``(q, p)`` leaf on a TPU, else None.  Its
    linear-packed candidate reads at half bandwidth, so tile wins wherever
    it is a candidate: p even and a multiple of the kernel's k-tile."""
    tk = select_tile_k(p, group_size)
    return tk if p % 2 == 0 and p % tk == 0 else None


def _tile_label(tk: int, p: int, group_size) -> str:
    gsz = group_size if group_size else p
    tiling = ("whole-groups" if group_size and tk % gsz == 0
              else "tile-in-group" if group_size else "per-channel")
    return f"tile{tk}/{tiling}"


def prepack_params_for_serving(plan, params: dict, *, backend=None):
    """The serving weight layout of every packed 4-bit linear leaf
    (``repro.serve.qparams.prepack_params_for_serving``).

    ``backend`` None, ``"cuda"`` or ``"cpu"``: every leaf stays in the linear
    layout the port's GEMM reads, labelled ``"linear-packed"`` (the
    reference's rule off a TPU).  ``"tpu"``: leaves the reference's chooser
    gives the tile-native layout are prepacked at its k-tile (an exact
    column permutation) and labelled as the reference labels them.

    Returns ``(params, decisions)``, decisions mapping ``"<block>.<name>"``
    to the layout label."""
    if backend not in (None, "cuda", "cpu", "tpu"):
        raise ValueError(f"unknown backend {backend!r}")
    decisions: dict[str, str] = {}

    def leaf(path: str, qt):
        if not (isinstance(qt, QuantizedTensor) and qt.packed and qt.bits == 4
                and qt.pack_layout == "linear"):
            return qt
        q, p = qt.shape[-2:]
        tk = _tpu_tile(q, p, qt.group_size) if backend == "tpu" else None
        if tk is None:
            decisions[path] = "linear-packed"
            return qt
        decisions[path] = _tile_label(tk, p, qt.group_size)
        codes = prepack_codes(unpack_codes(qt.codes, 4, p), 4, tk)
        return dataclasses.replace(qt, codes=codes, pack_layout="tile", pack_tile=tk)

    out = dict(params)
    out["dec"] = {key: {name: leaf(f"{key}.{name}", v) for name, v in blk.items()}
                  for key, blk in params["dec"].items()}
    return out, decisions
