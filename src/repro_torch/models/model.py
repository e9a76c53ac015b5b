"""Model assembly for every family: params, forward stack, train loss.

Param tree (leaves in ``cfg.dtype``), the reference's layout:

  embed          (vocab_pad, d)
  lm_head        (d, vocab_pad)          [unless tied]
  pos_emb        (max_seq, d)            [pos == "learned"]
  final_norm     {scale}
  dec            {"b0": {...}, ...}: every leaf has a leading n_periods dim
  enc            the encoder's stack, leading dim n_enc_periods  [encdec]
  enc_pos_emb    (n_frames, d)           [encdec]
  enc_final_norm {scale, bias}           [encdec]
  prefix_ln      {scale}                 [n_prefix]

Attention blocks and Mamba-2 (SSD) blocks (:mod:`.mamba2`: ``wz``/``wx``
(d, nh, hd), ``wbc`` (d, 2GN), ``wdt`` (d, nh), ``out_proj`` (nh, hd, d),
the convolution weights, and ``a_log``/``dt_bias`` (nh,) in fp32 whatever
the model's dtype), with dense or mixture-of-experts MLPs (:mod:`.moe`:
``router`` (d, E), ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d)),
rotary, learned or no positions.  The encoder-decoder family (Whisper)
runs a non-causal encoder stack over precomputed frames (plus
``enc_pos_emb``, then ``enc_final_norm``), and its decoder blocks add
cross-attention (``ln_c``, ``wq_c``/``wk_c``/``wv_c``/``wo_c``, no bias)
over the encoder's output; the prefix family (LLaVA) prepends the normed
patch embeddings (``prefix_ln``) to the text, masked out of the loss.
Both stubs take the front end's output from the batch (``"frames"``,
``"patches"``), as the reference does.  A stack is a Python loop over its
periods (the reference scans them), however many its leaves hold.

Serving: :func:`prefill` / :func:`decode_step` run on a contiguous per-slot
KV cache (:func:`init_cache`; a Mamba block keeps its recurrent state
there, a cross-attention block the encoder's keys and values ``ck``/``cv``
in bf16, written by the prefill), :func:`paged_prefill_chunk` /
:func:`paged_decode_step` on a block-paged one (:func:`init_paged_cache`,
attention-only stacks),
whose decode attention goes through ``kernels.ops.paged_attention``;
speculative serving adds :func:`paged_verify_tokens` and
:func:`paged_draft_tokens`, both built on :func:`paged_decode_step`.  Cache
leaves carry a leading period axis, as the reference's.  The reference
returns a new cache from each call; here the cache tensors are updated in
place and the same dict is returned, so callers keep the reference's form.
A Mamba block's new state takes the dtype it was computed in, as the
reference's returned cache does: in an fp32 model the bf16 convolution
buffers become fp32 leaves at the first prefill or decode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import (
    axis_rank,
    axis_size,
    copy_to,
    gather_dim,
    gather_dim_grad,
    gather_from,
    max_over,
    reduce_from,
)
from repro_torch.dist.sharding import current_rules, data_axis, model_axis
from repro_torch.models.common import (
    HeadPlan,
    HoistedDequant,
    activation,
    apply_linear,
    apply_norm,
    decode_attention,
    flash_attention,
    make_head_plan,
    rope,
    rmsnorm,
    softcap,
    _outlier_adds,
    _record_linear,
)
from repro_torch.models.mamba2 import mamba_apply, mamba_decode
from repro_torch.models.moe import BatchShard, ExpertShard, moe_apply, router_aux_loss
from repro_torch.quant import QuantizedTensor, kv_pack_int4, kv_unpack_int4

__all__ = [
    "ModelPlan",
    "make_plan",
    "model_defs",
    "init_params",
    "empty_params",
    "param_shapes",
    "param_axes",
    "cache_axes",
    "tp_rules",
    "train_loss",
    "encoder_inputs",
    "encoder",
    "decoder_inputs",
    "check_token_only",
    "tree_map",
    "period_slice",
    "cache_shapes",
    "init_cache",
    "paged_cache_shapes",
    "init_paged_cache",
    "prefill",
    "decode_step",
    "paged_prefill_chunk",
    "paged_decode_step",
    "paged_verify_tokens",
    "paged_draft_tokens",
]

KV_CACHE_DTYPES = ("bf16", "int8", "int4")


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    """Static plan: the config and the paddings of a "model" axis of
    ``axis_n`` (1: none)."""

    cfg: ModelConfig
    axis_n: int
    heads: HeadPlan
    vocab_pad: int
    # "bf16" | "int8" | "int4".  int4 is paged-engine only: pages store two
    # codes per byte (quant.kv_pack_int4, fold-in-half) and the contiguous
    # cache refuses it.
    kv_cache_dtype: str = "bf16"
    # MoE dispatch groups: every MoE layer routes, caps capacity and
    # combines within this many contiguous token groups (models/moe.py),
    # lined up with the data shards where the batch is split over "data".
    dispatch_groups: int = 1
    # Optional per-period param transform (the int8-quantized FSDP gather,
    # dist/qgather.py), applied to each period's params in train mode.
    param_transform: Optional[Callable] = dataclasses.field(default=None, compare=False)

    @property
    def dtype(self):
        return self.cfg.dtype


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("lm", "encdec"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.pos not in ("rope", "learned", "none"):
        raise ValueError(f"{cfg.name}: unknown positions {cfg.pos!r}")
    if cfg.family == "encdec" and not (cfg.enc_pattern and cfg.n_enc_periods):
        raise ValueError(f"{cfg.name}: an encoder-decoder model needs an encoder stack")
    for b in (*cfg.pattern, *cfg.enc_pattern):
        if b.kind not in ("attn", "mamba") or b.mlp not in ("dense", "moe", "none"):
            raise ValueError(f"{cfg.name}: unknown block {b}")
        if b.cross and (b.kind != "attn" or cfg.family != "encdec"):
            raise ValueError(f"{cfg.name}: block {b}: cross-attention needs an attention block "
                             "of an encoder-decoder model")


def check_token_only(cfg: ModelConfig, what: str) -> None:
    """Refuse an encoder-decoder or prefix model where ``what`` runs token
    ids alone (the reference's scorer and engines take no frames or
    patches)."""
    if cfg.family == "encdec" or cfg.n_prefix:
        family, extra = (("encoder-decoder", "frames") if cfg.family == "encdec"
                         else ("prefix", "patches"))
        raise ValueError(f"{what} runs token-only decoder models; {cfg.name} is of the {family} "
                         f"family, whose inputs carry {extra}")


def make_plan(cfg: ModelConfig, axis_n: int = 1, kv_cache_dtype: str = "bf16",
              param_transform=None, dispatch_groups: int = 1) -> ModelPlan:
    """The plan for a "model" axis of ``axis_n``: heads padded by
    :func:`~repro_torch.models.common.make_head_plan`, the vocabulary to a
    multiple of the axis (the reference's).  A padded plan is a model of
    its own (its params carry the padded slots and vocabulary rows); run on
    one rank it is the reference's padded plan on one device.
    ``dispatch_groups``: the MoE layers' token groups, in every mode
    (:func:`~repro_torch.models.moe.moe_apply`)."""
    _check_supported(cfg)
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r}; expected one of {KV_CACHE_DTYPES}")
    if dispatch_groups < 1:
        raise ValueError(f"dispatch_groups must be >= 1, got {dispatch_groups}")
    n = max(axis_n, 1)
    return ModelPlan(
        cfg=cfg, axis_n=axis_n, heads=make_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.hd, axis_n),
        vocab_pad=-(-cfg.vocab // n) * n, kv_cache_dtype=kv_cache_dtype,
        dispatch_groups=dispatch_groups, param_transform=param_transform,
    )


def tp_rules(plan: ModelPlan):
    """The ambient rules where their mesh has a "model" axis larger than 1
    (:func:`repro_torch.dist.sharding.model_axis`), else None.  Under them
    the forward pass is one rank's part of a tensor-parallel program on its
    local params (:func:`repro_torch.dist.sharding.shard_tree`), and each
    leaf's layout is the rules' (:meth:`Rules.shard_dim` of its logical
    axes, :data:`_TP_AXES`).  The plan must be padded for the axis, and
    the rules must cut the (padded) attention heads over it where the model
    has attention blocks.  Every family runs: attention, Mamba-2 and
    mixture-of-experts blocks, the encoder-decoder family's encoder stack
    and cross-attention (:func:`_cross_attention`), and the prefix family's
    patches, which every rank holds whole (:func:`decoder_inputs`)."""
    mesh = model_axis()
    if mesh is None:
        return None
    cfg, n = plan.cfg, axis_size(mesh, "model")
    if plan.axis_n != n:
        raise ValueError(f"the plan is padded for a \"model\" axis of {plan.axis_n}, the ambient "
                         f"rules' is {n}: make_plan(cfg, axis_n={n})")
    rules = current_rules()
    if (any(b.kind == "attn" for b in cfg.pattern)
            and rules.shard_dim(("heads",), "model") is None):
        raise ValueError("the rules keep the attention heads whole: a rank of a \"model\" axis "
                         "holds its kv slots (serve.qparams.serving_rules)")
    return rules


def _kv_slots(plan: ModelPlan) -> int:
    """The kv slots a rank holds: all of them, or its share of the ambient
    "model" axis."""
    return _rank_slots(plan.heads, tp_rules(plan))


# The logical axes of the leaves whose layout the tensor-parallel forward
# reads, per period (without "layers"): a dense leaf's as param_axes gives
# them, and a quantized leaf's codes matrix (out, in), behind its experts
# for an MoE matrix, as serve.qparams.qt_param_axes gives it (q and wo
# follow the heads, which a padded plan always cuts).
_TP_AXES = {
    "wk": (("embed", "kv_heads", "head_dim"), ("kv_fused", "embed")),
    "bk": (("kv_heads", "head_dim"), None),
    "wd": (("ffn", "embed"), (None, "ffn")),
    "embed": (("vocab", "embed"), None),
    "lm_head": (("embed", "vocab"), ("vocab", "embed")),
    "w_gate": (("experts", "embed", "expert_ffn"), ("experts", "expert_ffn", "embed")),
    "wz": (("embed", "ssm_heads", None), ("ssm_fused", "embed")),
    "out_proj": (("ssm_heads", None, "embed"), (None, "ssm_fused")),
}


def _cut(tp, leaf: str, w) -> Optional[int]:
    """The dimension of ``w`` (leaf ``leaf``'s local tensor; of a quantized
    weight, its (out, in) matrix) the rules ``tp`` cut over "model", or
    None: whole, or no model axis."""
    if tp is None:
        return None
    dense, quantized = _TP_AXES[leaf]
    return tp.shard_dim(quantized if isinstance(w, (QuantizedTensor, HoistedDequant)) else dense,
                        "model")


def _expert_shard(tp, p) -> Optional[ExpertShard]:
    """The MoE layer's layout on this rank (:class:`~repro_torch.models.moe.ExpertShard`):
    expert-parallel where the rules cut ``w_gate`` on its experts,
    ffn-parallel where they cut its per-expert ffn, None where the layer is
    whole (no model axis, or neither divides it) and every rank computes
    all of it with no collective."""
    d = _cut(tp, "w_gate", p["w_gate"])
    if d is None:
        return None
    kw = dict(psum=lambda t: reduce_from(t, tp.mesh, "model"),
              enter=lambda t: copy_to(t, tp.mesh, "model"))
    if d == 0:
        n_local = p["w_gate"].shape[0]
        return ExpertShard("experts", first=axis_rank(tp.mesh, "model") * n_local,
                           n_local=n_local, **kw)
    return ExpertShard("ffn", **kw)


def _batch_shard() -> Optional[BatchShard]:
    """The rank's block of a batch the ambient rules split over "data"
    (data-parallel training), for the MoE layers, or None."""
    mesh = data_axis()
    if mesh is None:
        return None
    return BatchShard(axis_rank(mesh, "data"), axis_size(mesh, "data"),
                      gather=lambda t: gather_dim(t, 0, mesh, "data"),
                      psum=lambda t: copy_to(reduce_from(t, mesh, "data"), mesh, "data"))


@dataclasses.dataclass(frozen=True)
class _SSMShard:
    """A Mamba-2 block's layout on one rank of a model axis, what
    :mod:`.mamba2` calls for its projections, its gated norm and
    ``out_proj``.  Where the rules cut ``ssm_heads`` the rank runs its
    heads (``heads``: first and count), its dense leaves, quantized rows
    and cache state are theirs, the norm's sum of squares is all-reduced
    and ``out_proj`` is row-parallel (:func:`_row_parallel`).  Where they
    keep the heads whole the rank runs every head: a quantized ``wz``/``wx``
    cut on its fused rows inside a head is projected on the rank's rows and
    all-gathered whole, and a quantized ``out_proj`` cut on its columns
    reads the rank's columns of the normed output, row-parallel.

    Under autograd a replicated tensor that enters the rank's own work
    (the block's input before a cut projection, the B/C activations, the
    whole ``a_log``/``dt_bias``/``d_skip`` sliced to the rank's heads)
    goes through :meth:`enter` (``copy_to``: its gradient summed over the
    axis); one that replicated work consumes does not."""

    tp: object
    heads: tuple
    channels: int  # nh·hd: the gated norm's width over every head
    split: bool

    def enter(self, t):
        return copy_to(t, self.tp.mesh, "model")

    def heads_of(self, t):
        """A tensor every rank holds whole, on its way to the rank's heads
        (through :meth:`enter` where those are a share of them)."""
        return self.enter(t) if self.split else t

    def project(self, w, x, xf, out_shape: tuple, name: str):
        """``x`` projected by ``wz``/``wx``/``wdt`` onto the heads the rank
        runs; ``xf`` is ``enter(x)``, what a rank-local product reads."""
        if self.split:
            return apply_linear(w, xf, out_shape=out_shape, name=name)
        if _cut(self.tp, "wz", w) is None:
            return apply_linear(w, x, out_shape=out_shape, name=name)
        y = gather_from(apply_linear(w, xf, name=name), -1, self.tp.mesh, "model").contiguous()
        return y.reshape(*x.shape[:-1], *out_shape)

    def rmsnorm(self, y, scale, eps: float = 1e-6):
        if not self.split:
            return rmsnorm(y, scale)
        y32 = y.to(torch.float32)
        # The whole sum of squares feeds each rank's own heads: summed both ways.
        ss = self.enter(reduce_from((y32 * y32).sum(-1, keepdim=True), self.tp.mesh, "model"))
        out = y32 * torch.rsqrt(ss / self.channels + eps)
        return (out * (1.0 + scale.to(torch.float32))).to(y.dtype)

    def out_proj(self, w, y):
        if _cut(self.tp, "out_proj", w) is None:
            return apply_linear(w, y, name="out_proj")
        if not self.split:
            cols = w.shape[-1]
            y = self.enter(y)[..., axis_rank(self.tp.mesh, "model") * cols :][..., :cols]
        return _row_parallel(w, y, self.tp, "out_proj")


def _ssm_heads(plan: ModelPlan, tp) -> tuple:
    """``(first head, heads)`` a rank runs: its share where the rules cut
    ``ssm_heads``, else all of them."""
    nh = plan.cfg.ssm_nheads
    if tp is None or tp.shard_dim(("ssm_heads",), "model") is None:
        return 0, nh
    n = axis_size(tp.mesh, "model")
    return axis_rank(tp.mesh, "model") * (nh // n), nh // n


def _ssm_shard(plan: ModelPlan, tp) -> Optional[_SSMShard]:
    if tp is None:
        return None
    cfg = plan.cfg
    heads = _ssm_heads(plan, tp)
    return _SSMShard(tp, heads, cfg.ssm_nheads * cfg.ssm_headdim, heads[1] < cfg.ssm_nheads)


def _row_parallel(w, x, tp, name: str):
    """y = x @ W for a row-parallel weight (``wo``'s kv slots, ``wd``'s ffn
    block): this rank's product is a partial sum, formed in fp32,
    all-reduced over "model" in fp32 (``reduce_from``) and cast once, to x's dtype for a
    quantized weight and to a dense weight's own (a bf16 ``o`` from bf16
    pages meets an fp32 ``wo`` upcast, as :func:`_apply_out_proj` does).
    Where the one-rank product rounds twice (a quantized weight with
    outlier planes and x not fp32: the GEMM's output is rounded to x's
    dtype before the fp32 outlier adds), the GEMM's and the adds' partials
    are reduced apart and rounded where it rounds."""
    quantized = isinstance(w, (QuantizedTensor, HoistedDequant))
    dt = x.dtype if quantized else w.dtype
    outliers = quantized and (w.outlier_values is not None or w.outlier_col_idx is not None)
    if not outliers or dt == torch.float32:
        y = apply_linear(w, x.to(dt), name=name, out_dtype=torch.float32)
        return reduce_from(y, tp.mesh, "model").to(dt)
    plain = dataclasses.replace(w, outlier_values=None, outlier_idx=None, outlier_col_idx=None,
                                outlier_col_vals=None)
    y = reduce_from(apply_linear(plain, x, name=name, out_dtype=torch.float32), tp.mesh, "model")
    x2 = x.reshape(-1, x.shape[-1])
    adds = _outlier_adds(w, x2, x2.new_zeros(x2.shape[0], y.shape[-1], dtype=torch.float32),
                         torch.float32)
    adds = reduce_from(adds, tp.mesh, "model").reshape(y.shape)
    return (y.to(dt).to(torch.float32) + adds).to(dt)


# ---------------------------------------------------------------------------
# Parameter definitions: (shape, init) per leaf, as the reference's _P.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _P:
    shape: tuple
    axes: tuple  # the reference's logical axes, one per dimension
    init: str = "normal"  # normal | zeros | ones | small_normal | conv | dt | alog

    @property
    def dtype_override(self):
        """The SSM dynamics (``a_log``, ``dt_bias``) are fp32 in any model."""
        return torch.float32 if self.init in ("dt", "alog") else None


def _norm_def(cfg, d) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": _P((d,), (None,), "ones"), "bias": _P((d,), (None,), "zeros")}
    return {"scale": _P((d,), (None,), "zeros")}  # (1 + scale) convention


def _attn_defs(cfg: ModelConfig, hp: HeadPlan, suffix: str = "") -> dict:
    """The projections of self-attention, or with ``suffix="_c"`` of
    cross-attention, which has no q/k/v bias and no post-norm."""
    d, hd = cfg.d_model, cfg.hd
    defs = {
        f"wq{suffix}": _P((d, hp.kv_pad, hp.g_pad, hd), ("embed", "heads", None, None)),
        f"wk{suffix}": _P((d, hp.n_kv, hd), ("embed", "kv_heads", "head_dim")),
        f"wv{suffix}": _P((d, hp.n_kv, hd), ("embed", "kv_heads", "head_dim")),
        f"wo{suffix}": _P((hp.kv_pad, hp.g_pad, hd, d), ("heads", None, None, "embed")),
    }
    if suffix:
        return defs
    if cfg.qkv_bias:
        defs["bq"] = _P((hp.kv_pad, hp.g_pad, hd), ("heads", None, None), "zeros")
        defs["bk"] = _P((hp.n_kv, hd), ("kv_heads", "head_dim"), "zeros")
        defs["bv"] = _P((hp.n_kv, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.post_norms:
        defs["post_ln"] = _norm_def(cfg, d)
    return defs


def _mamba_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    nh, hd = cfg.ssm_nheads, cfg.ssm_headdim
    gn2 = 2 * cfg.ssm_ngroups * cfg.ssm_state
    k = cfg.ssm_conv
    return {
        "wz": _P((d, nh, hd), ("embed", "ssm_heads", None)),
        "wx": _P((d, nh, hd), ("embed", "ssm_heads", None)),
        "wbc": _P((d, gn2), ("embed", None)),
        "wdt": _P((d, nh), ("embed", "ssm_heads"), "small_normal"),
        "conv_x_w": _P((nh, hd, k), ("ssm_heads", None, None), "conv"),
        "conv_x_b": _P((nh, hd), ("ssm_heads", None), "zeros"),
        "conv_bc_w": _P((gn2, k), (None, None), "conv"),
        "conv_bc_b": _P((gn2,), (None,), "zeros"),
        "a_log": _P((nh,), (None,), "alog"),
        "d_skip": _P((nh,), (None,), "ones"),
        "dt_bias": _P((nh,), (None,), "dt"),
        "norm_scale": _P((nh, hd), ("ssm_heads", None), "zeros"),
        "out_proj": _P((nh, hd, d), ("ssm_heads", None, "embed"), "small_normal"),
    }


def _block_defs(cfg: ModelConfig, hp: HeadPlan, b: BlockDef) -> dict:
    d = cfg.d_model
    defs = {"ln": _norm_def(cfg, d)}
    defs.update(_attn_defs(cfg, hp) if b.kind == "attn" else _mamba_defs(cfg))
    if b.cross:
        defs["ln_c"] = _norm_def(cfg, d)
        defs.update(_attn_defs(cfg, hp, suffix="_c"))
    if b.mlp != "none":
        defs["ln2"] = _norm_def(cfg, d)
        defs.update(_moe_defs(cfg) if b.mlp == "moe" else _mlp_defs(cfg))
        if cfg.post_norms:
            defs["post_ln2"] = _norm_def(cfg, d)
    return defs


def _mlp_defs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    defs = {"wg": _P((d, f), ("embed", "ffn")),
            "wd": _P((f, d), ("ffn", "embed"), "small_normal")}
    if cfg.gated_mlp:
        defs["wu"] = _P((d, f), ("embed", "ffn"))
    return defs


def _moe_defs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.n_experts
    defs = {"router": _P((d, e), (None, None)),
            "w_gate": _P((e, d, f), ("experts", "embed", "expert_ffn")),
            "w_down": _P((e, f, d), ("experts", "expert_ffn", "embed"), "small_normal")}
    if cfg.gated_mlp:
        defs["w_up"] = _P((e, d, f), ("experts", "embed", "expert_ffn"))
    return defs


def tree_map(fn, tree, is_leaf=None):
    """Map ``fn`` over the leaves of nested dicts/lists (QuantizedTensor and
    _P count as leaves)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, is_leaf) for v in tree]
    return fn(tree)


def _stack_defs(cfg: ModelConfig, hp: HeadPlan, stack: str) -> dict:
    pattern, n_periods = stack_layout(cfg, stack)
    return {f"b{i}": tree_map(lambda pd: _P((n_periods, *pd.shape), ("layers", *pd.axes), pd.init),
                              _block_defs(cfg, hp, b), is_leaf=lambda x: isinstance(x, _P))
            for i, b in enumerate(pattern)}


def model_defs(plan: ModelPlan) -> dict:
    cfg, hp = plan.cfg, plan.heads
    d = cfg.d_model
    defs = {"embed": _P((plan.vocab_pad, d), ("vocab", "embed")), "final_norm": _norm_def(cfg, d),
            "dec": _stack_defs(cfg, hp, "dec")}
    if not cfg.tie_embeddings:
        defs["lm_head"] = _P((d, plan.vocab_pad), ("embed", "vocab"))
    if cfg.pos == "learned":
        defs["pos_emb"] = _P((cfg.max_seq, d), (None, "embed"), "small_normal")
    if cfg.family == "encdec":
        defs["enc"] = _stack_defs(cfg, hp, "enc")
        defs["enc_pos_emb"] = _P((cfg.n_frames, d), (None, "embed"), "small_normal")
        defs["enc_final_norm"] = _norm_def(cfg, d)
    if cfg.n_prefix:
        defs["prefix_ln"] = _norm_def(cfg, d)
    return defs


def param_shapes(plan: ModelPlan) -> dict:
    """The params' shapes and dtypes, as tensors on the meta device (the
    reference's ``ShapeDtypeStruct`` tree)."""
    return empty_params(plan, device="meta")


def param_axes(plan: ModelPlan) -> dict:
    """The logical axes of every param leaf (the reference's tree): tuples
    read by :func:`repro_torch.dist.sharding.Rules.spec`."""
    return tree_map(lambda pd: pd.axes, model_defs(plan), is_leaf=lambda x: isinstance(x, _P))


def empty_params(plan: ModelPlan, *, device="cuda") -> dict:
    """Uninitialized params of the model's shapes and dtype: the template a
    checkpoint is loaded into (the reference's ``param_shapes``)."""
    dev = torch.device(device) if device == "meta" else resolve_device(device)
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=pd.dtype_override or plan.dtype,
                                           device=dev),
                    model_defs(plan), is_leaf=lambda x: isinstance(x, _P))


def init_params(plan: ModelPlan, seed, *, device="cuda") -> dict:
    """Seeded init with the reference's distributions (``_init_leaf``):
    N(0, 0.02²) for "normal", N(0, (0.02/√(2L))²) for "small_normal" (L
    counts the encoder's layers too),
    U(−1, 1)/√k for the convolution weights ("conv", k taps), and in fp32
    ``log(expm1(u))``, u ~ U(1e-3, 0.1), for ``dt_bias`` ("dt") and
    ``log(u)``, u ~ U(1, 16), for ``a_log`` ("alog").

    ``seed`` is an int or a ``torch.Generator`` on ``device``.  The numbers
    differ from the reference's (another generator); tests that compare the
    two packages carry the reference's params across with
    :mod:`repro_torch.interop`.
    """
    dev = resolve_device(device)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    n_layers = plan.cfg.n_layers + plan.cfg.n_enc_periods * len(plan.cfg.enc_pattern)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, dtype=torch.float32, device=dev) * (hi - lo) + lo

    def leaf(pd: _P):
        dtype = pd.dtype_override or plan.dtype
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=dev)
        if pd.init == "conv":
            return (uniform(pd.shape, -1.0, 1.0) / math.sqrt(pd.shape[-1])).to(dtype)
        if pd.init == "dt":
            return torch.log(torch.expm1(uniform(pd.shape, 1e-3, 0.1)))
        if pd.init == "alog":
            return torch.log(uniform(pd.shape, 1.0, 16.0))
        std = 0.02 if pd.init == "normal" else 0.02 / math.sqrt(max(2 * n_layers, 1))
        z = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=dev)
        return (z * std).to(dtype)

    return tree_map(leaf, model_defs(plan), is_leaf=lambda x: isinstance(x, _P))


# ---------------------------------------------------------------------------
# Forward blocks
# ---------------------------------------------------------------------------


def _rank_slots(hp: HeadPlan, tp) -> int:
    """The kv slots a rank runs under the rules ``tp`` (all without them)."""
    return hp.kv_pad // (axis_size(tp.mesh, "model") if tp else 1)


def _qkv(cfg, hp: HeadPlan, p, h, tp=None):
    """q on this rank's kv slots (all of them without a model axis), k and v
    expanded into the same slots (:func:`_kv`).  Under a model axis the
    rank's projections read ``copy_to(h)``: the gradient of the replicated
    ``h`` sums every rank's heads."""
    hf = h if tp is None else copy_to(h, tp.mesh, "model")
    q = apply_linear(p["wq"], hf, out_shape=(_rank_slots(hp, tp), hp.g_pad, hp.head_dim),
                     name="wq")
    if cfg.qkv_bias:
        q = q + p["bq"]
    return (q, *_kv(hp, p, h, bias=cfg.qkv_bias, tp=tp, hf=hf))


def _expand_kv(hp: HeadPlan, k):
    """(…, KV, hd) → (…, kv_pad, hd): GQA duplicates each kv head ``dup``
    times, MHA zero-pads the slots past KV (the reference's)."""
    if hp.dup > 1:
        return k.repeat_interleave(hp.dup, dim=-2)
    if hp.kv_pad > hp.n_kv:
        return torch.cat([k, k.new_zeros(*k.shape[:-2], hp.kv_pad - hp.n_kv, k.shape[-1])], -2)
    return k


def _whole(t, dim: Optional[int], tp):
    """The whole of ``t`` before a rank takes its own kv slots of it: the
    rank's part all-gathered over "model" on ``dim`` (counted from the
    end; the gradient reduce-scattered back), or, where ``dim`` is None,
    ``t`` itself, a whole leaf's output, through ``copy_to`` (the slots the
    ranks take from it sum its gradient)."""
    if dim is None:
        return copy_to(t, tp.mesh, "model")
    return gather_dim_grad(t, dim, tp.mesh, "model").contiguous()


def _kv(hp: HeadPlan, p, h, suffix: str = "", bias: bool = False, tp=None, hf=None):
    """k and v (plus ``bk``/``bv`` when ``bias``) in this rank's kv slots.

    Under a model axis ``wk``/``wv`` are stored as the rules lay them out
    (:func:`repro_torch.dist.sharding.make_rules`).  Where the rules cut
    the kv heads (dense) or the fused rows in whole heads (quantized) and
    no slot is padded, a rank's heads are its slots: nothing moves.
    Otherwise (the ``head_dim`` fallback, fused rows cut inside a head, or
    a replicated leaf) the rank projects its part, the parts are
    all-gathered into the whole (…, KV, hd), and the rank expands that and
    keeps its slots.  The gather, not a replicated copy of ``wk``/``wv``:
    each rank stores exactly its shard of the artifact, and the gathered
    k/v (tokens × KV × hd) are small beside the weights.  A projection on
    the rank's part of ``wk``/``wv`` reads ``hf`` (``copy_to(h)``), a whole
    one reads ``h``."""
    full = (hp.n_kv, hp.head_dim)
    out = []
    for w in "kv":
        wt, b = p[f"w{w}{suffix}"], p[f"b{w}"] if bias else None
        if tp is None:
            y = apply_linear(wt, h, out_shape=full, name=f"w{w}{suffix}")
            out.append(_expand_kv(hp, y if b is None else y + b))
            continue
        quantized = isinstance(wt, (QuantizedTensor, HoistedDequant))
        d = _cut(tp, "wk", wt)
        kv_slots = _rank_slots(hp, tp)
        # (…, rows) quantized, (…, KV', hd') dense
        y = apply_linear(wt, h if d is None else hf, name=f"w{w}{suffix}")
        if hp.kv_pad == hp.n_kv and d == (0 if quantized else 1):
            y = y.reshape(*h.shape[:-1], kv_slots, hp.head_dim)
            out.append(y if b is None else y + b)
            continue
        # the output dim the cut falls on: the fused rows, or dense (KV, hd)'s
        y = _whole(y, None if d is None else (-1 if quantized else d - 3), tp)
        y = y.reshape(*h.shape[:-1], *full)
        if b is not None:
            db = _cut(tp, "bk", b)
            y = y + _whole(b, None if db is None else db - 2, tp)
        lo = axis_rank(tp.mesh, "model") * kv_slots
        out.append(_expand_kv(hp, y)[..., lo : lo + kv_slots, :])
    return out


def _apply_out_proj(w, o, name=None, tp=None):
    """o: (B, S, KVp, Gp, hd) → (B, S, d); dense 4-D weight, or a
    QuantizedTensor / HoistedDequant of matrix (d, KVp·Gp·hd).  Under a
    model axis ``o`` holds the rank's slots and ``w`` is row-parallel
    (:func:`_row_parallel`)."""
    o2 = o.reshape(*o.shape[:2], -1)
    if tp is not None:
        return _row_parallel(w, o2, tp, name)
    if isinstance(w, (QuantizedTensor, HoistedDequant)):
        return apply_linear(w, o2, name=name)
    _record_linear(name, o2)
    # A bf16 o (paged prefill over bf16 pages) meets an fp32 weight exactly
    # upcast, as the reference's einsum promotes it.
    return o2.to(w.dtype) @ w.reshape(-1, w.shape[-1])


def _kv_quantize(x: torch.Tensor):
    """Per-(token, head) symmetric int8: (…, hd) → codes int8, scale fp32 (…, 1)."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    codes = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def _kv_quantize4(x: torch.Tensor):
    """Per-(token, head) symmetric int4, fold-in-half packed: (…, hd) →
    uint8 (…, hd/2), scale fp32 (…, 1).  Codes lie in [-7, 7]."""
    x32 = x.to(torch.float32)
    scale = x32.abs().amax(-1, keepdim=True) / 7.0 + 1e-12
    codes = torch.clamp(torch.round(x32 / scale), -7, 7).to(torch.int8)
    return kv_pack_int4(codes), scale


def _write_kv(cache, idx, k, v, kv_dtype):
    """Write k/v (quantized for int8/int4 caches) at ``cache[...][idx]``."""
    if kv_dtype in ("int8", "int4"):
        quantize = _kv_quantize4 if kv_dtype == "int4" else _kv_quantize
        k, ks = quantize(k)
        v, vs = quantize(v)
        cache["ks"][idx] = ks
        cache["vs"][idx] = vs
    cache["k"][idx] = k.to(cache["k"].dtype)
    cache["v"][idx] = v.to(cache["v"].dtype)


def _paged_attention(cfg, b, q, k, v, cache, *, mode, pos_ids, q_offset, kv_dtype,
                     page_table, page_write):
    """Paged KV: decode writes the new token at ``(page_write, pos % psz)``
    and attends through ``ops.paged_attention``; chunked prefill (one
    sequence) writes the chunk into its pages and attends the gathered
    context with ``flash_attention`` at ``q_offset``."""
    from repro_torch.kernels import ops as kops

    kc = cache["k"]  # (n_pages, psz, KVp, hd or hd/2)
    psz = kc.shape[1]
    quantized = kv_dtype in ("int8", "int4")
    if mode == "decode":
        pos_b = pos_ids[:, 0]
        # Inactive lanes all write (NULL_PAGE, 0): duplicates whose winner is
        # unspecified on the card, harmless because the null page is never
        # read unmasked.
        _write_kv(cache, (page_write, pos_b % psz), k[:, 0], v[:, 0], kv_dtype)
        o = kops.paged_attention(
            q[:, 0], kc, cache["v"], page_table, (pos_b + 1).to(torch.int32),
            window=b.window, attn_softcap=cfg.attn_softcap,
            k_scale_pages=cache["ks"] if quantized else None,
            v_scale_pages=cache["vs"] if quantized else None,
        )
        return o[:, None]
    pos = pos_ids.reshape(-1)  # (S,) absolute positions
    row = page_table[0].long()  # (n_pgs,)
    n = row.shape[0]
    # Pad positions past the table go to the null page explicitly (indexing
    # does not clamp; a clamp would clobber the last real page).
    pg = pos // psz
    pidx = torch.where(pg < n, row[torch.clamp(pg, max=n - 1)], torch.zeros_like(pg))
    _write_kv(cache, (pidx, pos % psz), k[0], v[0], kv_dtype)
    n_ctx = n * psz
    kctx = kc[row].reshape(1, n_ctx, *kc.shape[2:])
    vctx = cache["v"][row].reshape(1, n_ctx, *kc.shape[2:])
    if kv_dtype == "int4":
        kctx, vctx = kv_unpack_int4(kctx), kv_unpack_int4(vctx)
    if quantized:
        ksg = cache["ks"][row].reshape(1, n_ctx, -1, 1)
        vsg = cache["vs"][row].reshape(1, n_ctx, -1, 1)
        kctx = (kctx.to(torch.float32) * ksg).to(q.dtype)
        vctx = (vctx.to(torch.float32) * vsg).to(q.dtype)
    return flash_attention(q, kctx, vctx, causal=True, window=b.window,
                           attn_softcap=cfg.attn_softcap, q_offset=q_offset)


def _fill_cache(cache, k, v, window, kv_dtype="bf16"):
    """Prefill: write the contiguous cache (a ring buffer for windowed layers
    whose capacity is below the prompt)."""
    cap, S = cache["k"].shape[1], k.shape[1]
    if window is not None and cap < S:
        slots = torch.arange(S - cap, S, device=k.device) % cap
        _write_kv(cache, (slice(None), slots), k[:, S - cap :], v[:, S - cap :], kv_dtype)
    else:
        _write_kv(cache, (slice(None), slice(0, S)), k, v, kv_dtype)


def _attn_sublayer(cfg, hp, b: BlockDef, p, x, *, pos_ids, mode="train", cache=None,
                   kv_dtype="bf16", page_table=None, page_write=None, q_offset=0, enc_out=None,
                   tp=None):
    """Self-attention sublayer in ``train``, ``prefill`` or ``decode`` mode;
    with ``page_table`` set the KV cache is block-paged.  A cross block then
    attends ``enc_out`` (:func:`_cross_attention`).  Under a model axis
    (``tp``) the rank attends its kv slots alone, its caches hold them, and
    ``wo``'s partial sums are all-reduced."""
    h = apply_norm(p["ln"], x, cfg.norm)
    q, k, v = _qkv(cfg, hp, p, h, tp)
    if cfg.pos == "rope":
        q = rope(q, pos_ids, cfg.rope_theta)
        k = rope(k, pos_ids, cfg.rope_theta)
    if page_table is not None:
        o = _paged_attention(cfg, b, q, k, v, cache, mode=mode, pos_ids=pos_ids,
                             q_offset=q_offset, kv_dtype=kv_dtype, page_table=page_table,
                             page_write=page_write)
    elif mode == "decode":
        kc = cache["k"]
        B, cap = kc.shape[:2]
        pos_b = pos_ids[:, 0]
        # Ring buffers make the window implicit; the valid prefix is per slot.
        slot = pos_b % cap if b.window is not None else pos_b
        _write_kv(cache, (torch.arange(B, device=kc.device), slot), k[:, 0], v[:, 0], kv_dtype)
        o = decode_attention(
            q, kc, cache["v"], torch.clamp(pos_b + 1, max=cap), window=None,
            attn_softcap=cfg.attn_softcap,
            k_scale=cache.get("ks"), v_scale=cache.get("vs"),
        )
    else:
        o = flash_attention(
            q, k, v, causal=b.causal, window=b.window, attn_softcap=cfg.attn_softcap
        )
        if mode == "prefill":
            _fill_cache(cache, k, v, b.window, kv_dtype)
    out = _apply_out_proj(p["wo"], o, name="wo", tp=tp)
    if cfg.post_norms:
        out = apply_norm(p["post_ln"], out, cfg.norm)
    x = x + out
    if not b.cross:
        return x
    return _cross_attention(cfg, hp, p, x, mode=mode, cache=cache, enc_out=enc_out, tp=tp)


def _cross_attention(cfg, hp, p, x, *, mode, cache, enc_out, tp=None):
    """Cross-attention over the encoder's output, non-causal.  In ``train``
    and ``prefill`` mode K/V are projected from ``enc_out`` (a prefill also
    writes them into the cache's ``ck``/``cv``, in bf16 whatever the
    model's dtype, as the reference's cache holds them); ``decode`` reads
    them back and attends all ``n_frames`` keys.  Under a model axis
    (``tp``) the rank projects ``wq_c`` onto its kv slots, ``wk_c``/``wv_c``
    from ``enc_out`` as :func:`_kv` does for self-attention (the gathered
    fallback included), its cross caches hold those slots, and ``wo_c`` is
    row-parallel.  ``enc_out`` is replicated and feeds each rank's own
    slots: its projections read ``copy_to(enc_out)``, so the encoder's
    gradient sums every rank's part."""
    h = apply_norm(p["ln_c"], x, cfg.norm)
    hf = h if tp is None else copy_to(h, tp.mesh, "model")
    q = apply_linear(p["wq_c"], hf, out_shape=(_rank_slots(hp, tp), hp.g_pad, hp.head_dim),
                     name="wq_c")
    if mode == "decode":
        kc, vc = cache["ck"], cache["cv"]
        o = decode_attention(q, kc, vc, kc.shape[1], window=None)
    else:
        ef = enc_out if tp is None else copy_to(enc_out, tp.mesh, "model")
        k, v = _kv(hp, p, enc_out, "_c", tp=tp, hf=ef)
        if mode == "prefill":
            cache["ck"].copy_(k)
            cache["cv"].copy_(v)
        o = flash_attention(q, k, v, causal=False)
    return x + _apply_out_proj(p["wo_c"], o, name="wo_c", tp=tp)


def _mlp_sublayer(cfg, b: BlockDef, p, x, aux: Optional[list] = None, tp=None,
                  dispatch_groups: int = 1):
    """Dense or MoE MLP; an MoE block appends its router's load-balancing
    loss to ``aux`` when one is given (training).  Under a model axis whose
    rules cut "ffn", ``wg``/``wu`` are column-parallel and ``wd``
    row-parallel (:func:`_row_parallel`), reading ``copy_to(h)``; else the
    MLP is replicated.  An MoE layer routes within the plan's
    ``dispatch_groups``, takes the rank's layout (:func:`_expert_shard`)
    and, where "data" splits the batch, routes the whole batch's groups
    (:func:`_batch_shard`)."""
    if b.mlp == "none":
        return x
    h = apply_norm(p["ln2"], x, cfg.norm)
    if b.mlp == "moe":
        batch = _batch_shard()
        y, probs = moe_apply(p, h, n_experts=cfg.n_experts, top_k=cfg.top_k, act=cfg.act,
                             gated=cfg.gated_mlp, norm_topk=cfg.router_norm_topk,
                             return_aux=aux is not None, shard=_expert_shard(tp, p), batch=batch,
                             dispatch_groups=dispatch_groups)
        if aux is not None:
            aux.append(router_aux_loss(probs, batch))
    else:
        split = _cut(tp, "wd", p["wd"]) is not None
        if split:
            h = copy_to(h, tp.mesh, "model")
        u = activation(apply_linear(p["wg"], h, name="wg"), cfg.act)
        if cfg.gated_mlp:
            u = u * apply_linear(p["wu"], h, name="wu")
        if split:
            y = _row_parallel(p["wd"], u, tp, "wd")
        else:
            y = apply_linear(p["wd"], u, name="wd")
    if cfg.post_norms:
        y = apply_norm(p["post_ln2"], y, cfg.norm)
    return x + y


def _mamba_sublayer(cfg, p, x, *, mode="train", cache=None, shard=None):
    """The SSD block on the normed input.  In ``prefill`` and ``decode``
    mode the new state replaces ``cache``'s entries (:func:`_run_stack`
    writes them into the stacked cache).  Under a model axis ``shard`` is
    the rank's layout (:class:`_SSMShard`)."""
    h = apply_norm(p["ln"], x, cfg.norm)
    if mode == "decode":
        y, state = mamba_decode(p, h, cfg, cache, shard=shard)
    else:
        y, state = mamba_apply(p, h, cfg, return_cache=mode == "prefill", shard=shard)
    if state is not None:
        cache.update(state)
    return x + y


def _block_apply(cfg, hp, b, p, x, *, pos_ids, aux: Optional[list] = None, tp=None,
                 ssm=None, dispatch_groups: int = 1, **attn_kw):
    if b.kind == "mamba":
        x = _mamba_sublayer(cfg, p, x, mode=attn_kw.get("mode", "train"),
                            cache=attn_kw.get("cache"), shard=ssm)
    else:
        x = _attn_sublayer(cfg, hp, b, p, x, pos_ids=pos_ids, tp=tp, **attn_kw)
    return _mlp_sublayer(cfg, b, p, x, aux, tp=tp, dispatch_groups=dispatch_groups)


def _quantized(a) -> bool:
    return isinstance(a, (QuantizedTensor, HoistedDequant))


def period_slice(stack, i):
    """Period ``i`` (or a slice of periods) of a stacked block tree (dense,
    QuantizedTensor or HoistedDequant leaves)."""
    return tree_map(lambda a: a.map_arrays(lambda t: t[i]) if _quantized(a) else a[i],
                    stack, is_leaf=_quantized)


def stack_layout(cfg: ModelConfig, stack: str) -> tuple:
    """``(pattern, n_periods)`` of stack ``"dec"`` or ``"enc"``: the
    encoder's period count is its own, ``n_enc_periods``."""
    return (cfg.enc_pattern, cfg.n_enc_periods) if stack == "enc" else (cfg.pattern, cfg.n_periods)


def _run_stack(plan: ModelPlan, stack_params: dict, stack: str, x, *, mode: str, pos_ids,
               caches=None, **attn_kw):
    """Loop over the periods of ``stack`` (:func:`stack_layout`).
    ``caches`` (leaves with a leading period axis) are written in place
    through each period's views, a Mamba block's state after the block
    (:func:`_store_state`); ``aux`` (a list) collects the MoE blocks'
    router losses; ``enc_out`` is what a cross block attends."""
    cfg, hp = plan.cfg, plan.heads
    tp = tp_rules(plan)
    ssm = _ssm_shard(plan, tp)
    pattern, n_periods = stack_layout(cfg, stack)
    for period in range(n_periods):
        p_period = period_slice(stack_params, period)
        if plan.param_transform is not None and mode == "train":
            p_period = plan.param_transform(p_period)
        for i, b in enumerate(pattern):
            cache = None if caches is None else {k: t[period] for k, t in caches[f"b{i}"].items()}
            x = _block_apply(cfg, hp, b, p_period[f"b{i}"], x, mode=mode, pos_ids=pos_ids,
                             cache=cache, kv_dtype=plan.kv_cache_dtype, tp=tp, ssm=ssm,
                             dispatch_groups=plan.dispatch_groups, **attn_kw)
            if b.kind == "mamba" and cache is not None:
                _store_state(caches[f"b{i}"], period, cache)
    return x


def _store_state(stack: dict, period: int, state: dict) -> None:
    """Write one period's new Mamba state into its stacked cache leaves.  A
    leaf whose stack has another dtype than the state is replaced by one of
    the state's dtype first (the reference's scan returns the state's
    dtype), so an fp32 model's bf16 convolution buffers turn fp32."""
    for k, v in state.items():
        if stack[k].dtype != v.dtype:
            stack[k] = stack[k].to(v.dtype)
        stack[k][period].copy_(v)


# ---------------------------------------------------------------------------
# Loss / heads
# ---------------------------------------------------------------------------


def _local_logits(xc, head):
    """fp32 logits of the vocabulary the head (``lm_head``, or the tied
    embedding) holds: all of it, or on a rank of a model axis whose rules
    cut the vocabulary its block."""
    if isinstance(head, tuple) and head[0] == "tied":
        return xc.to(torch.float32) @ head[1].to(torch.float32).T
    if isinstance(head, QuantizedTensor):
        return apply_linear(head, xc).to(torch.float32)
    return xc.to(torch.float32) @ head.to(torch.float32)


def _head_cut(tp, head) -> bool:
    tied = isinstance(head, tuple) and head[0] == "tied"
    return _cut(tp, "embed" if tied else "lm_head", head[1] if tied else head) is not None


def _head_logits(xc, head, tp=None):
    """fp32 logits over the vocabulary.  Under a model axis whose rules cut
    the vocabulary, a rank's head (``lm_head``, or the tied embedding)
    holds its block of it: its logits are all-gathered on the vocabulary,
    which every rank then uses alike (serving, the eval scorer)."""
    if not _head_cut(tp, head):
        return _local_logits(xc, head)
    xf = copy_to(xc, tp.mesh, "model")
    return gather_from(_local_logits(xf, head), -1, tp.mesh, "model").contiguous()


def _logit_head(plan, params):
    if plan.cfg.tie_embeddings:
        return ("tied", params["embed"])
    return params["lm_head"]


def _embed_tokens(plan, params, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings.  Under a model axis a rank holds a block of the
    vocabulary's rows: it looks up the tokens that fall in its block (zero
    elsewhere) and the rows are summed over the axis in fp32, exactly, as
    one rank holds each."""
    emb, ids = params["embed"], tokens.long()
    tp = tp_rules(plan)
    if _cut(tp, "embed", emb) is not None:
        local = ids - axis_rank(tp.mesh, "model") * emb.shape[0]
        inside = (local >= 0) & (local < emb.shape[0])
        rows = emb[torch.clamp(local, 0, emb.shape[0] - 1)].to(torch.float32)
        x = reduce_from(torch.where(inside[..., None], rows, 0.0), tp.mesh, "model").to(plan.dtype)
    else:
        x = emb[ids].to(plan.dtype)
    if plan.cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(plan.cfg.d_model), dtype=plan.dtype, device=x.device)
    return x


def check_positions(cfg, n: int, what: str) -> None:
    """Learned positions end at ``cfg.max_seq``: refuse ``n`` positions past
    it (the reference's slice raises there and its gather reads NaN)."""
    if cfg.pos == "learned" and n > cfg.max_seq:
        raise ValueError(f"{what} {n} > max_seq {cfg.max_seq}: {cfg.name}'s learned positions "
                         "end there")


def _embed(plan, params, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus, for learned positions, ``pos_emb`` at ``pos``
    (broadcast against ``tokens``)."""
    return _add_positions(plan, params, _embed_tokens(plan, params, tokens), pos)


def _add_positions(plan, params, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``x`` plus, for learned positions, ``pos_emb`` at ``pos``.  A position
    past ``max_seq`` gets no positional term: only pad lanes reach one,
    since :func:`hidden_states`, :func:`prefill` and both engines refuse
    longer sequences (:func:`check_positions`)."""
    if plan.cfg.pos == "learned":
        pe, pos = params["pos_emb"], pos.long()
        inside = (pos < pe.shape[0])[..., None]
        x = x + torch.where(inside, pe[torch.clamp(pos, max=pe.shape[0] - 1)], 0.0).to(plan.dtype)
    return x


def _batch_array(batch: dict, key: str, plan, device) -> torch.Tensor:
    """A batch's ``frames`` or ``patches`` (numpy or torch, fp32) on
    ``device`` in the model's dtype."""
    if key not in batch:
        raise ValueError(f"{plan.cfg.name}: the batch carries no {key!r}")
    return torch.as_tensor(batch[key], device=device).to(plan.dtype)


def encoder_inputs(plan: ModelPlan, params, batch: dict, device) -> torch.Tensor:
    """The encoder stack's input: the batch's ``frames`` (B, n_frames, d)
    plus ``enc_pos_emb``, in the model's dtype."""
    return _batch_array(batch, "frames", plan, device) + params["enc_pos_emb"][None].to(plan.dtype)


def encoder(plan: ModelPlan, params, batch: dict, device):
    """The encoder's output (:func:`encoder_inputs` through the encoder
    stack, non-causal, train mode, then ``enc_final_norm``), or None for a
    model without one."""
    cfg = plan.cfg
    if cfg.family != "encdec":
        return None
    x = encoder_inputs(plan, params, batch, device)
    x = _run_stack(plan, params["enc"], "enc", x, mode="train",
                   pos_ids=torch.arange(x.shape[1], device=x.device))
    return apply_norm(params["enc_final_norm"], x, cfg.norm)


def decoder_inputs(plan: ModelPlan, params, tokens: torch.Tensor, batch: dict) -> torch.Tensor:
    """The decoder stack's input (B, P + S, d): a prefix model's patches,
    ``prefix_ln``-normed, before the token embeddings (P = ``n_prefix``,
    else 0), and learned positions over the whole sequence, as the
    reference adds them."""
    cfg, dev = plan.cfg, tokens.device
    x = _embed_tokens(plan, params, tokens)
    if cfg.n_prefix:
        pre = apply_norm(params["prefix_ln"], _batch_array(batch, "patches", plan, dev), cfg.norm)
        x = torch.cat([pre, x], 1)
    return _add_positions(plan, params, x, torch.arange(x.shape[1], device=dev))


def as_tokens(tokens, device) -> torch.Tensor:
    """numpy or torch token ids → int64 tensor on ``device``."""
    return torch.as_tensor(tokens, device=device).long()


def chunked_cross_entropy(x, head, labels, mask, *, real_vocab: int, chunk: int = 512,
                          logit_softcap: Optional[float] = None, tp=None) -> torch.Tensor:
    """Mean masked LM cross-entropy, logits formed one sequence chunk at a
    time.  Under a model axis whose rules cut the vocabulary the logits stay
    in the ranks' blocks (:func:`_vocab_parallel_ce`)."""
    if _head_cut(tp, head):
        return _vocab_parallel_ce(x, head, labels, mask, real_vocab=real_vocab, chunk=chunk,
                                  logit_softcap=logit_softcap, tp=tp)
    S = x.shape[1]
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        logits = softcap(_head_logits(x[:, s0 : s0 + chunk], head), logit_softcap)
        vp = logits.shape[-1]
        if vp > real_vocab:
            bias = torch.where(torch.arange(vp, device=x.device) < real_vocab, 0.0, -1e30)
            logits = logits + bias
        lse = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, labels[:, s0 : s0 + chunk, None])[..., 0]
        mc = mask[:, s0 : s0 + chunk]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp_min(cnt, 1.0)


def _vocab_parallel_ce(x, head, labels, mask, *, real_vocab: int, chunk: int,
                       logit_softcap: Optional[float], tp) -> torch.Tensor:
    """:func:`chunked_cross_entropy` with each rank's logits those of its
    vocabulary block (softcapped, then the pad columns past ``real_vocab``
    biased by −1e30): per chunk the row max is all-reduced (no gradient),
    then the sum of exponentials and the gold logit, which the rank owning
    the label contributes, are all-reduced together.  The loss is the same
    on every rank; the gradient of the replicated ``x`` sums the blocks'."""
    S = x.shape[1]
    xf = copy_to(x, tp.mesh, "model")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        logits = softcap(_local_logits(xf[:, s0 : s0 + chunk], head), logit_softcap)
        vl = logits.shape[-1]
        v0 = axis_rank(tp.mesh, "model") * vl
        col = torch.arange(v0, v0 + vl, device=x.device)
        if v0 + vl > real_vocab:
            logits = logits + torch.where(col < real_vocab, 0.0, -1e30)
        m = max_over(logits.amax(-1), tp.mesh, "model")
        lab = labels[:, s0 : s0 + chunk] - v0
        inside = (lab >= 0) & (lab < vl)
        gold = torch.gather(logits, -1, torch.clamp(lab, 0, vl - 1)[..., None])[..., 0]
        parts = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                             torch.where(inside, gold, 0.0)])
        sum_exp, gold = reduce_from(parts, tp.mesh, "model").unbind(0)
        lse = m + torch.log(sum_exp)
        mc = mask[:, s0 : s0 + chunk]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp_min(cnt, 1.0)


def _hidden(plan: ModelPlan, params, tokens: torch.Tensor, batch: dict,
            aux: Optional[list] = None) -> torch.Tensor:
    """(B, S) ids (and the batch's frames or patches) → (B, P + S, d)
    final-norm hidden states, teacher-forced."""
    cfg = plan.cfg
    check_positions(cfg, tokens.shape[1] + cfg.n_prefix, "sequence length")
    x = decoder_inputs(plan, params, tokens, batch)
    enc_out = encoder(plan, params, batch, tokens.device)
    x = _run_stack(plan, params["dec"], "dec", x, mode="train",
                   pos_ids=torch.arange(x.shape[1], device=x.device), aux=aux, enc_out=enc_out)
    return apply_norm(params["final_norm"], x, cfg.norm)


def hidden_states(plan: ModelPlan, params, tokens: torch.Tensor,
                  aux: Optional[list] = None) -> torch.Tensor:
    """(B, S) ids → (B, S, d) final-norm hidden states, teacher-forced
    (``aux``: see :func:`_run_stack`).  Token-only models: an
    encoder-decoder or prefix model raises ``ValueError``, as the
    reference's scorer does."""
    check_token_only(plan.cfg, "the eval scorer")
    return _hidden(plan, params, tokens, {}, aux)


def train_loss(plan: ModelPlan, params, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B, S)} (with ``"frames"`` (B, n_frames, d) for an
    encoder-decoder model, ``"patches"`` (B, n_prefix, d) for a prefix
    model) → scalar next-token loss, plus ``0.01 · Σ router losses /
    n_layers`` for MoE models.  The prefix's positions carry no loss.

    Under a model axis (:func:`tp_rules`) ``params`` are the rank's shards
    and the loss, the same on every rank, is the padded plan's: its
    backward pass runs the conjugate collectives of the forward
    (``dist.collectives.copy_to``/``reduce_from``), the cross-entropy is
    vocabulary-parallel, and every rank backpropagates the one loss."""
    cfg = plan.cfg
    tp = tp_rules(plan)
    tokens = as_tokens(batch["tokens"], params["embed"].device)
    aux = [] if any(b.mlp == "moe" for b in cfg.pattern) else None
    x = _hidden(plan, params, tokens, batch, aux)
    B, S = x.shape[:2]
    mask = torch.ones(B, S, dtype=torch.float32, device=x.device)
    if cfg.n_prefix:
        # The prefix's labels are token 0, masked out, as the reference pads them.
        tokens = torch.cat([tokens.new_zeros(B, cfg.n_prefix), tokens], 1)
        mask[:, : cfg.n_prefix] = 0.0
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], 1)
    mask[:, -1] = 0.0
    loss = chunked_cross_entropy(
        x, _logit_head(plan, params), labels, mask,
        real_vocab=cfg.vocab, logit_softcap=cfg.logit_softcap, tp=tp,
    )
    if aux is not None:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in aux:
            total = total + a
        loss = loss + 0.01 * total / max(cfg.n_layers, 1)
    return loss


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def _block_cache_shape(plan: ModelPlan, b: BlockDef, B: int, cap: int) -> dict:
    cfg, hp = plan.cfg, plan.heads
    if b.kind == "mamba":  # the recurrent state (a rank's heads): no sequence axis
        k, nh = cfg.ssm_conv, _ssm_heads(plan, tp_rules(plan))[1]
        return {"conv_x": ((B, k - 1, nh, cfg.ssm_headdim), torch.bfloat16),
                "conv_bc": ((B, k - 1, 2 * cfg.ssm_ngroups * cfg.ssm_state), torch.bfloat16),
                "ssm": ((B, nh, cfg.ssm_headdim, cfg.ssm_state), torch.float32)}
    c = min(cap, b.window) if b.window is not None else cap
    kv_slots = _kv_slots(plan)
    if plan.kv_cache_dtype == "int4":
        raise ValueError(
            "kv_cache_dtype='int4' is paged-engine only (packed pages, "
            "quant.kv_pack_int4); the contiguous cache supports bf16 and int8"
        )
    kv = (B, c, kv_slots, hp.head_dim)
    if plan.kv_cache_dtype == "int8":
        sc = ((B, c, kv_slots, 1), torch.float32)
        out = {"k": (kv, torch.int8), "v": (kv, torch.int8), "ks": sc, "vs": sc}
    else:
        out = {"k": (kv, torch.bfloat16), "v": (kv, torch.bfloat16)}
    if b.cross:  # the encoder's keys and values (the rank's slots), bf16 whatever the KV dtype
        ckv = ((B, cfg.n_frames, kv_slots, hp.head_dim), torch.bfloat16)
        out.update(ck=ckv, cv=ckv)
    return out


def _stacked(plan: ModelPlan, per_block: dict) -> dict:
    n = plan.cfg.n_periods
    return {blk: {k: ((n, *shape), dt) for k, (shape, dt) in leaves.items()}
            for blk, leaves in per_block.items()}


def cache_shapes(plan: ModelPlan, B: int, cap: int) -> dict:
    """``{"b<i>": {leaf: (shape, dtype)}}`` of the contiguous decode cache,
    stacked over periods (under a model axis, a rank's kv slots, its
    cross caches' included, and SSD heads: :func:`cache_axes`' layout)."""
    tp_rules(plan)  # the plan must be padded for the ambient axis
    return _stacked(plan, {f"b{i}": _block_cache_shape(plan, b, B, cap)
                           for i, b in enumerate(plan.cfg.pattern)})


def paged_cache_shapes(plan: ModelPlan, n_pages: int, page_size: int) -> dict:
    """``{"b<i>": {leaf: (shape, dtype)}}`` of the block-paged decode cache.

    Per attention layer ``k``/``v`` pages ``(n_pages, page_size, KVp, hd)``
    (int8 adds fp32 ``ks``/``vs`` scale planes ``(…, 1)``; int4 stores uint8
    pages of width ``hd/2`` with the same scale planes), stacked over
    periods: page id ``p`` addresses slot ``p`` of every layer's array.  No
    batch axis: ownership lives in the page tables.  Only self-attention
    decoder stacks page: a Mamba block's state stays on the contiguous
    engine, as in the reference (``ValueError``).
    """
    cfg, hp = plan.cfg, plan.heads
    if any(b.kind != "attn" or b.cross for b in cfg.pattern):
        raise ValueError("paged KV serving supports self-attention decoder stacks only")
    if cfg.family == "encdec" or cfg.n_prefix:
        raise ValueError("paged KV serving: decoder-only models only")
    kv_dt = plan.kv_cache_dtype
    if kv_dt == "int4":
        if hp.head_dim % 2:
            raise ValueError(
                f"int4 KV pages need an even head dim (fold-in-half packing), got hd={hp.head_dim}"
            )
        kdt, page_hd = torch.uint8, hp.head_dim // 2
    else:
        kdt, page_hd = (torch.int8 if kv_dt == "int8" else torch.bfloat16), hp.head_dim
    kv_slots = _kv_slots(plan)
    page = ((n_pages, page_size, kv_slots, page_hd), kdt)
    sh = {"k": page, "v": page}
    if kv_dt in ("int8", "int4"):
        sh["ks"] = sh["vs"] = ((n_pages, page_size, kv_slots, 1), torch.float32)
    return _stacked(plan, {f"b{i}": sh for i in range(len(cfg.pattern))})


def cache_axes(plan: ModelPlan, seq_shard: bool = False) -> dict:
    """The logical axes of :func:`cache_shapes`' leaves (the reference's):
    attention k/v (and int8 scales, cross ``ck``/``cv``) on "heads", a Mamba
    block's state on "ssm_heads"."""
    seq_ax = "cache_seq" if seq_shard else None
    out = {}
    for i, b in enumerate(plan.cfg.pattern):
        if b.kind == "attn":
            kv = ("layers", "batch", seq_ax, "heads", None)
            ax = {"k": kv, "v": kv}
            if plan.kv_cache_dtype == "int8":
                ax.update(ks=kv, vs=kv)
            if b.cross:
                ax.update(ck=("layers", "batch", None, "heads", None),
                          cv=("layers", "batch", None, "heads", None))
        else:
            ax = {"conv_x": ("layers", "batch", None, "ssm_heads", None),
                  "conv_bc": ("layers", "batch", None, None),
                  "ssm": ("layers", "batch", "ssm_heads", None, None)}
        out[f"b{i}"] = ax
    return out


def _zeros(shapes: dict, device) -> dict:
    dev = resolve_device(device)
    return {blk: {k: torch.zeros(shape, dtype=dt, device=dev) for k, (shape, dt) in leaves.items()}
            for blk, leaves in shapes.items()}


def init_cache(plan: ModelPlan, B: int, cap: int, *, device="cuda") -> dict:
    return _zeros(cache_shapes(plan, B, cap), device)


def init_paged_cache(plan: ModelPlan, n_pages: int, page_size: int, *, device="cuda") -> dict:
    return _zeros(paged_cache_shapes(plan, n_pages, page_size), device)


def _final_logits(plan, params, x):
    cfg = plan.cfg
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return softcap(_head_logits(x, _logit_head(plan, params), tp_rules(plan))[:, 0],
                   cfg.logit_softcap)


def _positions(pos, B: int, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(pos, device=device).long(), (B,))


@torch.no_grad()
def prefill(plan: ModelPlan, params, batch: dict, cache):
    """Full-sequence forward filling ``cache``; returns ``(last_logits,
    cache)``.  An encoder-decoder model's batch carries ``"frames"`` (the
    encoder runs here and its keys and values fill the cross cache); a
    prefix model's carries ``"patches"``, which take the first
    ``n_prefix`` positions, so its decode continues at ``n_prefix + S``."""
    dev = params["embed"].device
    tokens = as_tokens(batch["tokens"], dev)
    check_positions(plan.cfg, tokens.shape[1] + plan.cfg.n_prefix, "prefill length")
    x = decoder_inputs(plan, params, tokens, batch)
    enc_out = encoder(plan, params, batch, dev)
    x = _run_stack(plan, params["dec"], "dec", x, mode="prefill",
                   pos_ids=torch.arange(x.shape[1], device=dev), caches=cache, enc_out=enc_out)
    return _final_logits(plan, params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(plan: ModelPlan, params, tokens, cache, pos):
    """One decode step.  tokens: (B, 1); pos: scalar or (B,) positions (one
    per slot: continuous batching).  Returns ``(logits, cache)``."""
    dev = params["embed"].device
    tokens = as_tokens(tokens, dev)
    pos_b = _positions(pos, tokens.shape[0], dev)
    x = _embed(plan, params, tokens, pos_b[:, None])
    x = _run_stack(plan, params["dec"], "dec", x, mode="decode",
                   pos_ids=pos_b[:, None], caches=cache)
    return _final_logits(plan, params, x), cache


@torch.no_grad()
def paged_prefill_chunk(plan: ModelPlan, params, tokens, cache, page_table, offset):
    """One chunked-prefill step for a single sequence.

    ``tokens``: (1, C), chunk ``[offset, offset + C)`` of the prompt,
    right-padded (pad positions write into the null page or into slots that
    decode rewrites before any length mask exposes them).  ``page_table``:
    (1, n_pgs), the sequence's page row; ``offset``: the absolute position of
    ``tokens[:, 0]``.  Writes the chunk's KV into its pages and attends the
    gathered context.  Returns the cache (no logits: the engine replays the
    last prompt token as the first decode).
    """
    dev = params["embed"].device
    tokens = as_tokens(tokens, dev)
    if tokens.shape[0] != 1:
        raise ValueError("paged prefill processes one sequence per call")
    offset = int(offset)
    pos = offset + torch.arange(tokens.shape[1], device=dev)
    x = _embed(plan, params, tokens, pos)
    _run_stack(plan, params["dec"], "dec", x, mode="prefill", pos_ids=pos,
               caches=cache, page_table=torch.as_tensor(page_table, device=dev),
               q_offset=offset)
    return cache


@torch.no_grad()
def paged_decode_step(plan: ModelPlan, params, tokens, cache, pos, page_table, page_write):
    """One decode step over the paged KV pool.

    ``tokens``: (B, 1); ``pos``: (B,) positions; ``page_table``: (B, n_pgs)
    int32 (padded entries → null page); ``page_write``: (B,) the page
    holding position ``pos[b]`` (inactive lanes: the null page).  Writes each
    lane's new KV at ``(page_write, pos % page_size)`` and attends with
    lengths ``pos + 1``.  Returns ``(logits, cache)``.
    """
    dev = params["embed"].device
    tokens = as_tokens(tokens, dev)
    pos_b = _positions(pos, tokens.shape[0], dev)
    x = _embed(plan, params, tokens, pos_b[:, None])
    x = _run_stack(
        plan, params["dec"], "dec", x, mode="decode", pos_ids=pos_b[:, None],
        caches=cache, page_table=torch.as_tensor(page_table, device=dev, dtype=torch.int32),
        page_write=torch.as_tensor(page_write, device=dev).long(),
    )
    return _final_logits(plan, params, x), cache


@torch.no_grad()
def paged_verify_tokens(plan: ModelPlan, params, tokens, cache, pos0, page_table, write_pages):
    """The speculative verify forward: ``L`` positions per lane in one
    :func:`paged_decode_step` call.

    ``tokens``: (B, L), per lane the replayed last committed token and then
    the draft proposal (right-padded); ``pos0``: (B,) the position of
    ``tokens[:, 0]``; ``write_pages``: (B, L) the page holding position
    ``pos0[b] + j`` (the null page for pad columns and inactive lanes).
    Returns ``(logits (B, L, V), cache)``, ``logits[:, j]`` scoring the
    token after ``tokens[:, j]``.

    The positions run as ``B·L`` virtual lanes: lane ``(b, j)`` decodes
    ``tokens[b, j]`` at ``pos0[b] + j`` against lane b's table row.  Each
    layer writes every lane's K/V into the pages before its attention, so
    lane ``(b, j)`` reads the keys of ``(b, 0..j-1)`` and its length
    ``pos + 1`` hides ``(b, j+1..)``: every position takes the decode path's
    arithmetic, and the weights are read once for all of them.  Pad columns
    write into the null page; their logits are ignored by the engine.
    """
    dev = params["embed"].device
    tokens = as_tokens(tokens, dev)
    B, L = tokens.shape
    pos = (_positions(pos0, B, dev)[:, None] + torch.arange(L, device=dev)[None]).reshape(-1)
    table = torch.as_tensor(page_table, device=dev, dtype=torch.int32)
    logits, cache = paged_decode_step(
        plan, params, tokens.reshape(B * L, 1), cache, pos, table.repeat_interleave(L, dim=0),
        torch.as_tensor(write_pages, device=dev).reshape(-1),
    )
    return logits.reshape(B, L, -1), cache


@torch.no_grad()
def paged_draft_tokens(plan: ModelPlan, params, forced, n_forced, cache, pos0, page_table,
                       write_pages):
    """The greedy draft proposal: ``S`` decode steps of the draft stack with
    the argmax fed back on the device.

    Step ``j`` runs at position ``pos0[b] + j``; for ``j < n_forced[b]`` it
    is teacher-forced with ``forced[b, j]`` (committed tokens the draft's KV
    has not seen), later steps feed back the previous step's argmax.
    ``forced``: (B, S); ``n_forced``: (B,); ``write_pages``: (B, S), the page
    of position ``pos0[b] + j`` (null once a lane's steps run out).  Returns
    ``(tokens (B, S) int32, cache)``, ``tokens[b, j]`` step j's argmax
    (``torch.argmax`` takes the first maximal index, as the engine's
    ``np.argmax`` does).  Nothing comes back to the host before the end.
    """
    dev = params["embed"].device
    forced = as_tokens(forced, dev)
    B, S = forced.shape
    n_forced = torch.as_tensor(n_forced, device=dev).long()
    pos0 = _positions(pos0, B, dev)
    table = torch.as_tensor(page_table, device=dev, dtype=torch.int32)
    write_pages = torch.as_tensor(write_pages, device=dev)
    prev = torch.zeros(B, dtype=torch.long, device=dev)
    out = []
    for j in range(S):
        inp = torch.where(j < n_forced, forced[:, j], prev)
        logits, cache = paged_decode_step(plan, params, inp[:, None], cache, pos0 + j, table,
                                          write_pages[:, j])
        prev = torch.argmax(logits, dim=-1)
        out.append(prev)
    return torch.stack(out, 1).to(torch.int32), cache
