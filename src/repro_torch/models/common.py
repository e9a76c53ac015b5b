"""Shared model components: norms, RoPE, attention, linears, PTQ capture.

Attention heads are carried in the reference's grouped layout
``(kv_slots, q_per_slot, head_dim)``.  The :class:`HeadPlan` pads the kv
slots to a multiple of the "model" axis (tensor parallelism); at axis 1 it
is the true architecture.

Any weight may be a :class:`~repro_torch.quant.QuantizedTensor`;
:func:`apply_linear` sends those through the dequantizing GEMM
(:func:`repro_torch.kernels.ops.dequant_matmul`).  A :class:`HoistedDequant`
(:func:`hoist_dequant`) holds such a weight already dequantized, for the
plain path on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.quant import QuantizedTensor
from repro_torch.tree import register_dataclass

__all__ = [
    "HeadPlan",
    "make_head_plan",
    "rmsnorm",
    "layernorm",
    "apply_norm",
    "activation",
    "softcap",
    "rope",
    "capture_scope",
    "capture_gram_stats",
    "capture_linear_inputs",
    "apply_linear",
    "HoistedDequant",
    "hoist_dequant",
    "flash_attention",
    "decode_attention",
]


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """Padded grouped-head layout for one (config, model-axis size) pair.

    True q heads H and kv heads KV become ``kv_pad`` kv slots of ``g_pad``
    q heads each: each true kv head is duplicated ``dup`` times (GQA, exact),
    or the kv slots are zero-padded (MHA), so that ``kv_pad`` is a multiple
    of ``axis_n`` and a rank of the "model" axis holds whole slots.  At
    ``axis_n=1`` the plan is the true architecture.
    """

    n_heads: int
    n_kv: int
    head_dim: int
    axis_n: int
    dup: int
    kv_pad: int
    g_pad: int

    @property
    def h_pad(self) -> int:
        return self.kv_pad * self.g_pad


def make_head_plan(n_heads: int, n_kv: int, head_dim: int, axis_n: int = 1) -> HeadPlan:
    """The reference's plan: no padding at ``axis_n <= 1``; MHA zero-pads its
    kv slots to the next multiple of the axis (padded q slots read zero
    ``wq``/``wo`` rows in a padded model's own params); GQA duplicates each
    kv head ``lcm(KV, axis_n) / KV`` times and spreads the q heads over the
    copies, ``g_pad = ceil(H / kv_pad)``."""
    if axis_n <= 1 or n_kv == 0:
        g = max(n_heads // max(n_kv, 1), 1)
        return HeadPlan(n_heads, n_kv, head_dim, 1, 1, max(n_kv, 1), g)
    if n_kv == n_heads:
        kv_pad = -(-n_kv // axis_n) * axis_n
        return HeadPlan(n_heads, n_kv, head_dim, axis_n, 1, kv_pad, 1)
    dup = math.lcm(n_kv, axis_n) // n_kv
    kv_pad = n_kv * dup
    return HeadPlan(n_heads, n_kv, head_dim, axis_n, dup, kv_pad, -(-n_heads // kv_pad))


# --------------------------------------------------------------------------
# Norms / activations / positional
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, ..., head_dim); positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exponent)
    if positions.dim() == 1:
        positions = positions[None]
    ang = positions.to(torch.float32)[..., None] * freqs  # (B, S, half)
    while ang.dim() < x.dim():
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


# --------------------------------------------------------------------------
# Linears (dense or quantized) + PTQ calibration capture
# --------------------------------------------------------------------------

_capture_state = threading.local()


@contextlib.contextmanager
def capture_scope(name: str):
    """Inside a capture context, tags subsequent apply_linear calls."""
    prev = getattr(_capture_state, "scope", None)
    _capture_state.scope = name
    try:
        yield
    finally:
        _capture_state.scope = prev


@contextlib.contextmanager
def capture_linear_inputs(records: dict):
    """Collect ``{scope/name: [x2d, ...]}`` for every linear applied within:
    the raw activations, O(n·p) memory per layer (an MoE dispatch table is
    kept whole, ``(E, C, d_in)``).  The numerical oracle of the streaming
    path; the whole-model solver uses :func:`capture_gram_stats`."""
    prev = getattr(_capture_state, "records", None)
    _capture_state.records = records
    try:
        yield records
    finally:
        _capture_state.records = prev


@contextlib.contextmanager
def capture_gram_stats(stats: dict):
    """Accumulate ``{scope/name: CalibStats}`` for every linear applied within:
    each call folds its activations into that layer's Σ = XXᵀ on the spot.
    The folds are local: under a data mesh the solver reduces each Σ over
    the mesh once, after the block's capture."""
    prev = getattr(_capture_state, "stats", None)
    _capture_state.stats = stats
    try:
        yield stats
    finally:
        _capture_state.stats = prev


def _record_linear(name, x, expert_stacked: bool = False):
    """Fold ``x`` into the Σ of linear ``name`` under the capture context
    (and keep it under :func:`capture_linear_inputs`); ``expert_stacked``:
    x is an MoE dispatch table ``(E, C, d_in)`` and each expert gets its own
    Σ ``(E, p, p)``."""
    if name is None:
        return
    records = getattr(_capture_state, "records", None)
    stats = getattr(_capture_state, "stats", None)
    if records is None and stats is None:
        return
    scope = getattr(_capture_state, "scope", None)
    key = f"{scope}/{name}" if scope else name
    if records is not None:
        records.setdefault(key, []).append(x if expert_stacked else x.reshape(-1, x.shape[-1]))
    if stats is None:
        return
    from repro_torch.core.calib import CalibStats

    if key not in stats:
        stats[key] = CalibStats.zeros(x.shape[-1], experts=x.shape[0] if expert_stacked else 0,
                                      device=x.device)
    if expert_stacked:
        stats[key] = stats[key].update_expert_tokens(x)
    else:
        stats[key] = stats[key].update_tokens(x)


def _outlier_adds(w, x2: torch.Tensor, y2: torch.Tensor, out_dtype) -> torch.Tensor:
    """The post-GEMM outlier corrections of a quantized weight ``w`` (a
    QuantizedTensor or HoistedDequant), in fp32: the rank-s COO planes,
    ``y[:, rows] += x[:, cols] · vals``, then the structured columns; each
    result rounded to ``out_dtype``."""
    if w.outlier_values is not None:
        idx = w.outlier_idx.long()
        rows, cols = idx // w.shape[-1], idx % w.shape[-1]
        contrib = x2[:, cols].to(torch.float32) * w.outlier_values.to(torch.float32)
        y2 = y2.to(torch.float32).index_add(1, rows, contrib).to(out_dtype)
    if w.outlier_col_idx is not None:
        cols = w.outlier_col_idx.long()
        y2 = (y2.to(torch.float32)
              + x2[:, cols].to(torch.float32) @ w.outlier_col_vals.to(torch.float32).T
              ).to(out_dtype)
    return y2


def apply_linear(w, x: torch.Tensor, out_shape: tuple = (), name: str = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = x @ W, where W is ``(d_in, *out_dims)`` dense, or a QuantizedTensor
    or HoistedDequant whose matrix is ``(prod(out_dims), d_in)``.  x:
    ``(..., d_in)``.  ``out_dtype`` (default: x's) is the dtype y is formed
    and rounded in; a tensor-parallel rank asks fp32 for its row-parallel
    partial sums (the dequant-GEMM then writes fp32, the outlier adds stay
    fp32, a dense product runs over fp32 upcasts)."""
    _record_linear(name, x)
    if isinstance(w, (QuantizedTensor, HoistedDequant)):
        out_dtype = out_dtype or x.dtype
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if isinstance(w, HoistedDequant):
            # The plain GEMM's own contraction over the bytes it would rebuild.
            y2 = (x2.to(torch.float32) @ w.w.T).to(out_dtype)
        else:
            from repro_torch.kernels import ops

            if w.pack_layout != "linear":
                raise NotImplementedError(
                    "the port's dequant-GEMM reads the linear pack layout; tile-native "
                    "codes are un-prepacked where an artifact enters the port "
                    "(interop.qtensor_from_jax, dist.checkpoint, quant.as_linear_layout)")
            y2 = ops.dequant_matmul(
                x2, w.codes, w.scale, w.zero, packed4=w.packed and w.bits == 4,
                out_dtype=out_dtype, group_size=w.group_size,
            )
        y2 = _outlier_adds(w, x2, y2, out_dtype)
        return y2.reshape(*lead, *(out_shape or (w.shape[0],)))
    d_in = x.shape[-1]
    w2 = w.reshape(d_in, -1)
    y = x @ w2 if out_dtype is None else x.to(out_dtype) @ w2.to(out_dtype)
    if out_shape:
        y = y.reshape(*y.shape[:-1], *out_shape)
    elif w.dim() > 2 and w.shape[0] == d_in:
        y = y.reshape(*y.shape[:-1], *w.shape[1:])
    return y


@register_dataclass
@dataclasses.dataclass
class HoistedDequant:
    """A QuantizedTensor whose dequantization is hoisted out of the forward
    pass: ``w`` holds byte for byte the fp32 matrix the plain GEMM
    (``kernels/ref.dequant_matmul_ref``) rebuilds on every call,
    ``(codes − zero)·scale``, and the outlier planes stay post-GEMM
    corrections exactly as on the QuantizedTensor path, so the results are
    bitwise those of the un-hoisted plain path.

    Speculative serving (:mod:`repro_torch.serve.spec`) runs several
    positions through each weight per call; on the CPU hoisting pays the
    dequantization once per engine instead of once per call.  On the card
    the dequant-GEMM (kernel 3) dequantizes in its prologue, and a hoisted
    ``torch.matmul`` would replace it with a library product, so
    :func:`repro_torch.serve.spec.maybe_hoist` refuses card params.

    Leaves may carry a leading period axis like every other ``dec`` leaf."""

    w: torch.Tensor  # (..., q, p) fp32
    outlier_values: Optional[torch.Tensor] = None  # (..., s) fp16
    outlier_idx: Optional[torch.Tensor] = None  # (..., s) int32, row·p + col
    outlier_col_idx: Optional[torch.Tensor] = None  # (..., c) int32
    outlier_col_vals: Optional[torch.Tensor] = None  # (..., q, c) fp32

    @property
    def shape(self) -> tuple:
        return tuple(self.w.shape)

    def map_arrays(self, fn) -> "HoistedDequant":
        """Apply ``fn`` to every array field (slicing a period, a device move)."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def hoist_dequant(tree):
    """``tree`` with every QuantizedTensor leaf replaced by a
    :class:`HoistedDequant` of its plain-path fp32 matrix (packed codes are
    unpacked first); dense leaves pass through.  About ``32 / bits`` times
    the quantized leaves' memory."""
    from repro_torch.models.model import tree_map

    def one(leaf):
        if not isinstance(leaf, QuantizedTensor):
            return leaf
        codes = leaf.unpacked_codes()
        p = codes.shape[-1]
        scale, zero = leaf.scale, leaf.zero
        if scale.dim() == codes.dim() - 1:  # a per-channel grid stored flat
            scale, zero = scale[..., None], zero[..., None]
        gsz = leaf.group_size or -(-p // scale.shape[-1])
        idx = torch.arange(p, device=codes.device) // gsz
        return HoistedDequant(
            w=(codes.to(torch.float32) - zero[..., idx]) * scale[..., idx],
            outlier_values=leaf.outlier_values, outlier_idx=leaf.outlier_idx,
            outlier_col_idx=leaf.outlier_col_idx, outlier_col_vals=leaf.outlier_col_vals,
        )

    return tree_map(one, tree, is_leaf=lambda a: isinstance(a, QuantizedTensor))


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # (B, Sq, KVp, G, hd)
    k: torch.Tensor,  # (B, Sk, KVp, hd)
    v: torch.Tensor,  # (B, Sk, KVp, hd)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    q_offset: int = 0,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Softmax attention in grouped-head layout, query chunk by query chunk.

    Plain torch ops, with the reference's roundings: q is scaled in its own
    dtype, scores and the P·V sum are fp32 over the (exact) upcast operands,
    P is cast to v's dtype before the second product, normalisation comes
    last.  Each query chunk sees all keys at once, which is the reference's
    single-kv-chunk case (Sk ≤ 1024) exactly; above that the reference's
    online softmax over kv chunks differs from it by fp32 rounding.
    ``q_offset`` is the absolute position of the first query (chunked
    prefill attends a suffix of the keys).  Returns (B, Sq, KVp, G, hd).
    """
    B, Sq, KVp, G, hd = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    k_pos = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qb = (q[:, q0 : q0 + q_chunk] * scale).to(q.dtype).to(torch.float32)
        s = torch.einsum("bqkgd,btkd->bkgqt", qb, kf)
        s = softcap(s, attn_softcap)
        q_pos = q_offset + q0 + torch.arange(qb.shape[1], device=q.device)
        mask = torch.ones(qb.shape[1], Sk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1)
        acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).to(torch.float32), vf)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))
    return torch.cat(outs, 1).to(k.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, KVp, G, hd)
    k_cache: torch.Tensor,  # (B, S, KVp, hd) bf16, or int8 codes
    v_cache: torch.Tensor,  # (B, S, KVp, hd)
    cache_len,  # (B,) or scalar: valid prefix length
    *,
    window: Optional[int] = None,
    attn_softcap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # (B, S, KVp, 1) fp32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention against a KV cache, with the reference's
    roundings: q is pre-scaled in its own dtype, the cache is cast to q's
    dtype, scores accumulate in fp32, P is cast to q's dtype before the P·V
    product.  With int8 caches the per-(token, head) scales fold in after
    the dots, ``q·(s·k₈) = s·(q·k₈)`` and ``Σ p·(s·v₈) = Σ (p·s)·v₈``.
    Positions ``>= cache_len`` (and, with a window, ``< cache_len - window``)
    are masked.  Returns (B, 1, KVp, G, hd) in q's dtype.
    """
    S, hd = k_cache.shape[1], k_cache.shape[-1]
    qs = (q * (1.0 / math.sqrt(hd))).to(q.dtype)
    s = torch.einsum("bokgd,btkd->bkgot", qs.float(), k_cache.to(q.dtype).float())
    if k_scale is not None:
        s = s * k_scale[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    s = softcap(s, attn_softcap)
    pos = torch.arange(S, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos < clen
    if window is not None:
        valid = valid & (pos >= clen - window)
    s = torch.where(valid[:, None, None, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, -1)
    if v_scale is not None:
        p = p * v_scale[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bkgot,btkd->bokgd", p.to(q.dtype).float(), v_cache.to(q.dtype).float())
    return out.to(q.dtype)
