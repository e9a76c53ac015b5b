"""Quantized serving parameters: restack the solver's ``emit="qt"`` output
(mixed bits included, through :func:`harmonize_qt_stack`), round-to-nearest
serving artifacts straight from dense weights (:func:`rtn_quantize_for_serving`,
the speculative engine's cheap drafts), and the weight-layout prepack of a
serving artifact.

Every leaf of ``core.solver.QUANTIZABLE`` is quantized; the rest stay
dense in their own dtype: norms, biases, embeddings, the MoE router, and a
Mamba block's dynamics (``wdt``, ``a_log`` and ``dt_bias`` in fp32,
``d_skip``, the convolution weights, ``norm_scale``).

The layout tables of a serving artifact are the reference's:
:func:`qt_param_shapes` (each leaf's shape and dtype, a quantized leaf's
codes, scale and zero as :class:`QTShape`), :func:`qt_param_axes` (its
logical axes: the codes matrix is ``(out_fused, d_in)``, column-parallel
linears name their out rows, row-parallel ones their in columns) and
:func:`qt_rules_extra` (the fused names' entries); :func:`serving_rules`
builds a model axis' rules from them, as the reference's dry-run does.

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

from repro_torch.core.solver import _MOE_NAMES, QUANTIZABLE, _stack_experts
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
           "rtn_quantize_for_serving", "harmonize_qt_stack", "QTShape", "qt_param_shapes",
           "qt_param_axes", "qt_rules_extra", "serving_rules"]


def _linear_meta(plan, name: str) -> tuple:
    """``(out_fused, d_in, axis_out, axis_in)`` of a quantizable leaf."""
    cfg, hp = plan.cfg, plan.heads
    d, hd = cfg.d_model, cfg.hd
    heads = hp.kv_pad * hp.g_pad * hd
    kv = hp.n_kv * hd
    ssm = cfg.ssm_nheads * cfg.ssm_headdim
    return {
        "wq": (heads, d, "heads_fused", "embed"),
        "wk": (kv, d, "kv_fused", "embed"),
        "wv": (kv, d, "kv_fused", "embed"),
        "wo": (d, heads, None, "heads_fused"),
        "wq_c": (heads, d, "heads_fused", "embed"),
        "wk_c": (kv, d, "kv_fused", "embed"),
        "wv_c": (kv, d, "kv_fused", "embed"),
        "wo_c": (d, heads, None, "heads_fused"),
        "wg": (cfg.d_ff, d, "ffn", "embed"),
        "wu": (cfg.d_ff, d, "ffn", "embed"),
        "wd": (d, cfg.d_ff, None, "ffn"),
        "wz": (ssm, d, "ssm_fused", "embed"),
        "wx": (ssm, d, "ssm_fused", "embed"),
        "wbc": (2 * cfg.ssm_ngroups * cfg.ssm_state, d, None, "embed"),
        "out_proj": (d, ssm, None, "ssm_fused"),
        "w_gate": (cfg.moe_ff, d, "expert_ffn", "embed"),
        "w_up": (cfg.moe_ff, d, "expert_ffn", "embed"),
        "w_down": (d, cfg.moe_ff, None, "expert_ffn"),
    }[name]


def qt_rules_extra(plan, axis_n: int) -> dict:
    """The fused names' rules entries: "model" where the fused width divides
    the axis, else replicated."""
    cfg, hp = plan.cfg, plan.heads
    fits = lambda n: n > 0 and n % axis_n == 0
    return {
        "heads_fused": "model" if fits(hp.kv_pad * hp.g_pad * cfg.hd) else None,
        "kv_fused": "model" if fits(hp.n_kv * cfg.hd) else None,
        "ssm_fused": "model" if fits(cfg.ssm_nheads * cfg.ssm_headdim) else None,
    }


@dataclasses.dataclass(frozen=True)
class QTShape:
    """A quantized leaf's layout: ``codes``, ``scale`` and ``zero`` as
    ``(shape, dtype)``, with the leaf's static fields."""

    codes: tuple
    scale: tuple
    zero: tuple
    bits: int
    group_size: Optional[int]
    packed: bool


def _lead(cfg, name: str, stack: str) -> tuple:
    n = cfg.n_enc_periods if stack == "enc" else cfg.n_periods
    return (n, cfg.n_experts) if name in _MOE_NAMES else (n,)


def _map_quantizable(plan, dense: dict, fn, params: Optional[dict] = None) -> dict:
    """``dense`` with each stack's quantizable leaves replaced by
    ``fn(name, stack)``; with ``params`` (an artifact), only those that are
    quantized there."""
    def quantized(stack, key, name):
        return name in QUANTIZABLE and (
            params is None or isinstance(params[stack][key][name], QuantizedTensor))

    out = dict(dense)
    for stack in ("dec", "enc"):
        if stack in dense:
            out[stack] = {key: {name: fn(name, stack) if quantized(stack, key, name) else leaf
                                for name, leaf in blk.items()}
                          for key, blk in dense[stack].items()}
    return out


def qt_param_shapes(plan, bits: int = 4) -> dict:
    """The serving artifact's leaves as ``(shape, dtype)`` (the reference's
    ShapeDtypeStruct tree): dense leaves as :func:`param_shapes` has them, a
    quantizable leaf a :class:`QTShape` of uint8 codes (two a byte at 4
    bits where d_in is even) and a per-channel fp32 grid."""
    from repro_torch.models import model as M

    dense = M.tree_map(lambda t: (tuple(t.shape), t.dtype), M.param_shapes(plan),
                       is_leaf=torch.is_tensor)

    def quant(name, stack):
        out_f, d_in, _, _ = _linear_meta(plan, name)
        lead = _lead(plan.cfg, name, stack)
        packed = bits == 4 and d_in % 2 == 0
        return QTShape(codes=((*lead, out_f, d_in // 2 if packed else d_in), torch.uint8),
                       scale=((*lead, out_f, 1), torch.float32),
                       zero=((*lead, out_f, 1), torch.float32),
                       bits=bits, group_size=None, packed=packed)

    return _map_quantizable(plan, dense, quant)


def qt_param_axes(plan, params: Optional[dict] = None) -> dict:
    """The serving artifact's logical axes: dense leaves as
    :func:`param_axes` has them, a quantizable leaf ``{"codes": (…, out,
    in), "scale": (…, out, None), "zero": (…, out, None)}`` with lead axes
    ``("layers",)`` or ``("layers", "experts")``.  With ``params`` (an
    artifact) a quantizable leaf it holds dense keeps its dense axes: an
    encoder-decoder artifact restacked without ``solver_qt_enc`` (the
    reference's restack) has a dense ``"enc"``."""
    from repro_torch.models import model as M

    def quant(name, stack):
        _, _, ax_o, ax_i = _linear_meta(plan, name)
        lead = ("layers", "experts") if name in _MOE_NAMES else ("layers",)
        return {"codes": (*lead, ax_o, ax_i), "scale": (*lead, ax_o, None),
                "zero": (*lead, ax_o, None)}

    return _map_quantizable(plan, M.param_axes(plan), quant, params)


def serving_rules(plan, mesh):
    """The rules of ``mesh`` for serving ``plan`` (the reference dry-run's
    table, batch left to the mesh): heads, kv heads, head dim, ffn and
    vocabulary at their padded sizes, and :func:`qt_rules_extra`'s fused
    names, so :func:`repro_torch.dist.sharding.shard_tree` cuts dense params
    by :func:`~repro_torch.models.model.param_axes` and an artifact by
    :func:`qt_param_axes` consistently.

    It departs from the reference's table on purpose (``ROADMAP.md`` §3) in
    two entries: it passes the per-expert ffn (``moe_ff``) and the SSD head
    count (``ssm_heads``), which the reference's ``launch.specs._rules_for``
    leaves at 0.  So ``expert_ffn`` stays whole where neither the experts
    nor the per-expert ffn divide the axis (the reference puts it on
    "model", which cannot split), and ``ssm_heads`` cuts the dense Mamba
    leaves and the Mamba cache on the heads ``ssm_fused`` cuts the quantized
    ``wz``/``wx`` rows on."""
    from repro_torch.dist.sharding import axis_sizes, make_rules

    cfg, hp = plan.cfg, plan.heads
    return make_rules(mesh, n_heads=hp.h_pad, n_kv_heads=hp.n_kv, head_dim=cfg.hd,
                      d_ff=cfg.d_ff, n_experts=cfg.n_experts, vocab=plan.vocab_pad,
                      d_model=cfg.d_model, moe_ff=cfg.moe_ff, ssm_heads=cfg.ssm_nheads,
                      extra=qt_rules_extra(plan, axis_sizes(mesh).get("model", 1)))


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


def quantize_params_for_serving(plan, params: dict, solver_qt_dec: list, *,
                                solver_qt_enc: Optional[list] = None, device="cuda") -> dict:
    """Restack per-period block lists (``ptq_quantize_model(..., emit="qt")``'s
    ``["dec"]``) into the stacked layout the model runs (lead axes
    ``(layers,)``, and ``(layers, experts)`` for an MoE matrix); outlier
    planes (COO or columns) stack with the codes, and a leaf whose periods
    differ in bits, packing or outlier budget is harmonized first
    (:func:`harmonize_qt_stack`).  The params must live on ``device``
    (default ``"cuda"``).  Raises ``ValueError`` if a zero point is not an
    integer in ``[0, 2^bits − 1]`` of its own period's bits (the
    dequant-GEMM's precondition, checked here once per artifact).

    ``solver_qt_enc``, an encoder-decoder model's ``["enc"]`` list, is
    restacked the same way into ``"enc"``.  This departs from the reference
    on purpose: its ``quantize_params_for_serving`` restacks ``"dec"``
    alone, so the encoder of a dense ``params`` stays unquantized, and a
    ``params`` whose ``"enc"`` is the solver's per-period list cannot run
    (its scan over periods raises).  Without ``solver_qt_enc`` the result is
    the reference's, leaf for leaf: ``"enc"`` stays as ``params`` has it."""
    require_on_device(params["embed"], device)
    out = dict(params)
    out["dec"] = _stack_trees(solver_qt_dec)
    if solver_qt_enc is not None:
        out["enc"] = _stack_trees(solver_qt_enc)
    return out


def _d_in(plan, name: str) -> int:
    """The input width of a quantizable linear (its matrix is (out, d_in))."""
    cfg, hp = plan.cfg, plan.heads
    attn_out = hp.kv_pad * hp.g_pad * hp.head_dim
    return {"wo": attn_out, "wo_c": attn_out, "wd": cfg.d_ff,
            "out_proj": cfg.ssm_nheads * cfg.ssm_headdim}.get(name, cfg.d_model)


def rtn_quantize_for_serving(plan, params: dict, *, bits: int, outlier_frac: float = 0.0):
    """Round-to-nearest every quantizable ``dec`` leaf into the serving
    layout (``repro.serve.qparams.rtn_quantize_for_serving``; an
    encoder-decoder model's encoder stays dense, as there): per-channel
    grids from the weights themselves, no calibration and no solver.  The
    bytes are those the solver's artifact has: uint8 codes (packed two a
    byte at 4 bits), fp32 per-channel scale and zero, and with
    ``outlier_frac`` COO planes of the largest residuals (fp16 values, flat
    int32 indices, ascending by |residual|).  A dense leaf is read in its
    fp32 value; a QuantizedTensor leaf (a quantized target's draft) is
    dequantized first.  The result goes through
    :func:`prepack_params_for_serving`.

    Returns ``(params, layout_label)``; the leaves stay on the params'
    device, and every zero point is an integer in ``[0, 2^bits − 1]``.  An
    MoE matrix is quantized expert by expert, lead axes ``(layers,
    experts)``."""
    spec = GridSpec(bits=bits)

    def qt_one(wi):  # (out, d_in) fp32
        qt = quantize_tensor(wi, spec)
        if outlier_frac:
            resid = (wi - dequantize_tensor(qt)).reshape(-1)
            s = max(1, int(outlier_frac * resid.numel()))
            idx = torch.sort(resid.abs(), stable=True).indices[-s:]
            qt = dataclasses.replace(qt, outlier_values=resid[idx].to(torch.float16),
                                     outlier_idx=idx.to(torch.int32))
        if bits == 4 and qt.codes.shape[-1] % 2 == 0:
            qt = dataclasses.replace(qt, codes=pack_codes(qt.codes, 4), packed=True)
        return qt

    def qt_of(name, leaf):
        if isinstance(leaf, QuantizedTensor):
            w = dequantize_tensor(leaf)
        elif name in _MOE_NAMES:  # (n_periods, E, d_in, d_out) → (n_periods, E, out, d_in)
            w = leaf.to(torch.float32).transpose(-1, -2)
        else:  # (n_periods, d_in, *out_dims) → (n_periods, out, d_in)
            d_in = _d_in(plan, name)
            w = leaf.to(torch.float32).reshape(leaf.shape[0], d_in, -1).transpose(1, 2)
        if name in _MOE_NAMES:
            return _stack_qts([_stack_experts([qt_one(we) for we in wi]) for wi in w])
        return _stack_qts([qt_one(wi) for wi in w])

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

    Both stacks are walked, ``"dec"`` and an encoder-decoder model's
    ``"enc"``, as the reference walks them.  Returns ``(params,
    decisions)``, decisions mapping ``"<block>.<name>"`` to the layout
    label (one entry per leaf position, shared by the two stacks as in the
    reference)."""
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
    for stack in ("dec", "enc"):
        if stack in params:
            out[stack] = {key: {name: leaf(f"{key}.{name}", v) for name, v in blk.items()}
                          for key, blk in params[stack].items()}
    return out, decisions
