"""Quantized serving parameters: restack the solver's ``emit="qt"`` output
(mixed bits included, through :func:`harmonize_qt_stack`), round-to-nearest
serving artifacts straight from dense weights (:func:`rtn_quantize_for_serving`,
the speculative engine's cheap drafts), and the weight-layout prepack of a
serving artifact.

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

from repro_torch.core.solver import QUANTIZABLE
from repro_torch.device import require_on_device
from repro_torch.quant import (
    GridSpec,
    QuantizedTensor,
    check_zero_points,
    dequantize_tensor,
    pack_codes,
    quantize_tensor,
)
from repro_torch.quant.pack import prepack_codes, select_tile_k, unpack_codes

__all__ = ["quantize_params_for_serving", "prepack_params_for_serving",
           "rtn_quantize_for_serving", "harmonize_qt_stack"]


def _static_meta(qt: QuantizedTensor) -> tuple:
    """What must agree for a plain leaf-for-leaf stack."""
    shape = lambda t: None if t is None else tuple(t.shape)
    return (qt.bits, qt.group_size, qt.packed, qt.pack_layout, qt.pack_tile,
            shape(qt.outlier_values), shape(qt.outlier_col_idx))


def harmonize_qt_stack(leaves: list) -> list:
    """One leaf's per-period QuantizedTensors brought to one common form, so
    a mixed-precision artifact (per-layer bits from the tuner) stacks over
    the periods.  The dequantization ``(codes − zero)·scale`` does not
    depend on ``bits`` once the codes are unpacked, so this is lossless:

    * codes are unpacked to uint8 (``packed=False``, the linear layout);
    * ``bits`` becomes the stack's largest, which then only labels the
      leaf: every period's codes and integer zero points lie in its own
      grid's ``[0, 2^bits − 1]``, inside the largest one's;
    * COO outlier planes are padded to the stack's largest ``s`` with
      (index 0, value 0) entries, additive no-ops;
    * ``group_size`` must agree (the scale planes' widths), and structured
      column outliers must be alike (padding a column plane would
      overwrite column 0): either mismatch raises ``ValueError``.

    A homogeneous stack is returned as it is (packed 4-bit stays packed)."""
    if len({_static_meta(l) for l in leaves}) == 1:
        return leaves
    if len({l.group_size for l in leaves}) != 1:
        raise ValueError(
            f"heterogeneous group_size across stacked layers "
            f"({sorted(map(str, {l.group_size for l in leaves}))}): per-period scale planes "
            "would not stack")
    if len({_static_meta(l)[6] for l in leaves}) != 1:
        raise ValueError(
            "structured column outliers must be structurally identical across a stack "
            "(padding a column plane would overwrite column 0)")
    bits = max(l.bits for l in leaves)
    s_max = max(0 if l.outlier_values is None else l.outlier_values.shape[-1] for l in leaves)
    out = []
    for l in leaves:
        codes = l.unpacked_codes()
        vals, idx = l.outlier_values, l.outlier_idx
        if s_max:
            lead, dev = codes.shape[:-2], codes.device
            if vals is None:
                vals = torch.zeros(*lead, s_max, dtype=torch.float16, device=dev)
                idx = torch.zeros(*lead, s_max, dtype=torch.int32, device=dev)
            elif vals.shape[-1] < s_max:
                pad = s_max - vals.shape[-1]
                vals = torch.cat([vals, vals.new_zeros(*lead, pad)], -1)
                idx = torch.cat([idx, idx.new_zeros(*lead, pad)], -1)
        out.append(dataclasses.replace(
            l, codes=codes, bits=bits, packed=False, pack_layout="linear", pack_tile=None,
            outlier_values=vals, outlier_idx=idx))
    return out


def _stack_qts(leaves: list) -> QuantizedTensor:
    """Stack one leaf's per-period QuantizedTensors: codes, grid and any
    outlier planes gain a leading period dim.  Each period's zero points are
    checked against its own bits first, then a mixed stack is harmonized."""
    for l in leaves:
        check_zero_points(l)
    leaves = harmonize_qt_stack(leaves)
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
    ``["dec"]``) into the stacked layout the model runs; outlier planes (COO
    or columns) stack with the codes, and a leaf whose periods differ in
    bits, packing or outlier budget is harmonized first
    (:func:`harmonize_qt_stack`).  The params must live on ``device``
    (default ``"cuda"``).  Raises ``ValueError`` if a zero point is not an
    integer in ``[0, 2^bits − 1]`` of its own period's bits (the
    dequant-GEMM's precondition, checked here once per artifact)."""
    require_on_device(params["embed"], device)
    out = dict(params)
    out["dec"] = _stack_trees(solver_qt_dec)
    return out


def _d_in(plan, name: str) -> int:
    """The input width of a quantizable linear (its matrix is (out, d_in))."""
    cfg, hp = plan.cfg, plan.heads
    return {"wo": hp.kv_pad * hp.g_pad * hp.head_dim, "wd": cfg.d_ff}.get(name, cfg.d_model)


def rtn_quantize_for_serving(plan, params: dict, *, bits: int, outlier_frac: float = 0.0):
    """Round-to-nearest every quantizable ``dec`` leaf into the serving
    layout (``repro.serve.qparams.rtn_quantize_for_serving``): per-channel
    grids from the weights themselves, no calibration and no solver.  The
    bytes are those the solver's artifact has: uint8 codes (packed two a
    byte at 4 bits), fp32 per-channel scale and zero, and with
    ``outlier_frac`` COO planes of the largest residuals (fp16 values, flat
    int32 indices, ascending by |residual|).  A dense leaf is read in its
    fp32 value; a QuantizedTensor leaf (a quantized target's draft) is
    dequantized first.  The result goes through
    :func:`prepack_params_for_serving`.

    Returns ``(params, layout_label)``; the leaves stay on the params'
    device, and every zero point is an integer in ``[0, 2^bits − 1]``."""
    spec = GridSpec(bits=bits)

    def qt_of(name, leaf):
        if isinstance(leaf, QuantizedTensor):
            w = dequantize_tensor(leaf)
        else:  # (n_periods, d_in, *out_dims) → (n_periods, out, d_in)
            d_in = _d_in(plan, name)
            w = leaf.to(torch.float32).reshape(leaf.shape[0], d_in, -1).transpose(1, 2)
        qts = []
        for wi in w:
            qt = quantize_tensor(wi, spec)
            if outlier_frac:
                resid = (wi - dequantize_tensor(qt)).reshape(-1)
                s = max(1, int(outlier_frac * resid.numel()))
                idx = torch.sort(resid.abs(), stable=True).indices[-s:]
                qt = dataclasses.replace(qt, outlier_values=resid[idx].to(torch.float16),
                                         outlier_idx=idx.to(torch.int32))
            if bits == 4 and qt.codes.shape[-1] % 2 == 0:
                qt = dataclasses.replace(qt, codes=pack_codes(qt.codes, 4), packed=True)
            qts.append(qt)
        return _stack_qts(qts)

    out = dict(params)
    out["dec"] = {key: {name: qt_of(name, leaf) if name in QUANTIZABLE else leaf
                        for name, leaf in blk.items()}
                  for key, blk in params["dec"].items()}
    out, decisions = prepack_params_for_serving(plan, out)
    return out, "+".join(sorted(set(decisions.values())) or ["linear"])


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
