"""Model assembly for dense decoders: params, forward stack, train loss.

Param tree (leaves in ``cfg.dtype``), the reference's layout:

  embed        (vocab_pad, d)
  lm_head      (d, vocab_pad)          [unless tied]
  final_norm   {scale}
  dec          {"b0": {...}, ...}: every leaf has a leading n_periods dim

Attention blocks with dense MLPs are ported; other block kinds and the
encoder-decoder and prefix families raise ``NotImplementedError``.  The
stack is a Python loop over periods (the reference scans them).

Serving: :func:`prefill` / :func:`decode_step` run on a contiguous per-slot
KV cache (:func:`init_cache`), :func:`paged_prefill_chunk` /
:func:`paged_decode_step` on a block-paged one (:func:`init_paged_cache`),
whose decode attention goes through ``kernels.ops.paged_attention``;
speculative serving adds :func:`paged_verify_tokens` and
:func:`paged_draft_tokens`, both built on :func:`paged_decode_step`.  Cache
leaves carry a leading period axis, as the reference's.  The reference
returns a new cache from each call; here the cache tensors are updated in
place and the same dict is returned, so callers keep the reference's form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import BlockDef, ModelConfig
from repro_torch.device import resolve_device
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
    softcap,
    _record_linear,
)
from repro_torch.quant import QuantizedTensor, kv_pack_int4, kv_unpack_int4

__all__ = [
    "ModelPlan",
    "make_plan",
    "model_defs",
    "init_params",
    "empty_params",
    "train_loss",
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
    cfg: ModelConfig
    heads: HeadPlan
    vocab_pad: int
    # "bf16" | "int8" | "int4".  int4 is paged-engine only: pages store two
    # codes per byte (quant.kv_pack_int4, fold-in-half) and the contiguous
    # cache refuses it.
    kv_cache_dtype: str = "bf16"

    @property
    def dtype(self):
        return self.cfg.dtype


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "lm" or cfg.n_prefix or cfg.pos != "rope":
        raise NotImplementedError("the port runs rope token-only decoders so far")
    for b in cfg.pattern:
        if b.kind != "attn" or b.mlp not in ("dense", "none") or b.cross:
            raise NotImplementedError(f"block {b} is not ported yet")


def make_plan(cfg: ModelConfig, kv_cache_dtype: str = "bf16") -> ModelPlan:
    _check_supported(cfg)
    if kv_cache_dtype not in KV_CACHE_DTYPES:
        raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r}; expected one of {KV_CACHE_DTYPES}")
    return ModelPlan(
        cfg=cfg, heads=make_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.hd), vocab_pad=cfg.vocab,
        kv_cache_dtype=kv_cache_dtype,
    )


# ---------------------------------------------------------------------------
# Parameter definitions: (shape, init) per leaf, as the reference's _P.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _P:
    shape: tuple
    init: str = "normal"  # normal | zeros | ones | small_normal


def _norm_def(cfg, d) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": _P((d,), "ones"), "bias": _P((d,), "zeros")}
    return {"scale": _P((d,), "zeros")}  # (1 + scale) convention


def _block_defs(cfg: ModelConfig, hp: HeadPlan, b: BlockDef) -> dict:
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    defs = {
        "ln": _norm_def(cfg, d),
        "wq": _P((d, hp.kv_pad, hp.g_pad, hd)),
        "wk": _P((d, hp.n_kv, hd)),
        "wv": _P((d, hp.n_kv, hd)),
        "wo": _P((hp.kv_pad, hp.g_pad, hd, d)),
    }
    if cfg.qkv_bias:
        defs["bq"] = _P((hp.kv_pad, hp.g_pad, hd), "zeros")
        defs["bk"] = _P((hp.n_kv, hd), "zeros")
        defs["bv"] = _P((hp.n_kv, hd), "zeros")
    if cfg.post_norms:
        defs["post_ln"] = _norm_def(cfg, d)
    if b.mlp == "dense":
        defs["ln2"] = _norm_def(cfg, d)
        defs["wg"] = _P((d, f))
        defs["wd"] = _P((f, d), "small_normal")
        if cfg.gated_mlp:
            defs["wu"] = _P((d, f))
        if cfg.post_norms:
            defs["post_ln2"] = _norm_def(cfg, d)
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


def model_defs(plan: ModelPlan) -> dict:
    cfg, hp = plan.cfg, plan.heads
    d = cfg.d_model
    dec = {}
    for i, b in enumerate(cfg.pattern):
        dec[f"b{i}"] = tree_map(
            lambda pd: _P((cfg.n_periods, *pd.shape), pd.init),
            _block_defs(cfg, hp, b),
            is_leaf=lambda x: isinstance(x, _P),
        )
    defs = {"embed": _P((plan.vocab_pad, d)), "final_norm": _norm_def(cfg, d), "dec": dec}
    if not cfg.tie_embeddings:
        defs["lm_head"] = _P((d, plan.vocab_pad))
    return defs


def empty_params(plan: ModelPlan, *, device="cuda") -> dict:
    """Uninitialized params of the model's shapes and dtype: the template a
    checkpoint is loaded into (the reference's ``param_shapes``)."""
    dev = torch.device(device) if device == "meta" else resolve_device(device)
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=plan.dtype, device=dev),
                    model_defs(plan), is_leaf=lambda x: isinstance(x, _P))


def init_params(plan: ModelPlan, seed, *, device="cuda") -> dict:
    """Seeded init with the reference's distributions (``_init_leaf``):
    N(0, 0.02²) for "normal", N(0, (0.02/√(2L))²) for "small_normal".

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
    n_layers = plan.cfg.n_layers

    def leaf(pd: _P):
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=plan.dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=plan.dtype, device=dev)
        std = 0.02 if pd.init == "normal" else 0.02 / math.sqrt(max(2 * n_layers, 1))
        z = torch.randn(pd.shape, generator=gen, dtype=torch.float32, device=dev)
        return (z * std).to(plan.dtype)

    return tree_map(leaf, model_defs(plan), is_leaf=lambda x: isinstance(x, _P))


# ---------------------------------------------------------------------------
# Forward blocks
# ---------------------------------------------------------------------------


def _qkv(cfg, hp: HeadPlan, p, h):
    q = apply_linear(p["wq"], h, out_shape=(hp.kv_pad, hp.g_pad, hp.head_dim), name="wq")
    k = apply_linear(p["wk"], h, out_shape=(hp.n_kv, hp.head_dim), name="wk")
    v = apply_linear(p["wv"], h, out_shape=(hp.n_kv, hp.head_dim), name="wv")
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _apply_out_proj(w, o, name=None):
    """o: (B, S, KVp, Gp, hd) → (B, S, d); dense 4-D weight, or a
    QuantizedTensor / HoistedDequant of matrix (d, KVp·Gp·hd)."""
    o2 = o.reshape(*o.shape[:2], -1)
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
                   kv_dtype="bf16", page_table=None, page_write=None, q_offset=0):
    """Self-attention sublayer in ``train``, ``prefill`` or ``decode`` mode;
    with ``page_table`` set the KV cache is block-paged."""
    h = apply_norm(p["ln"], x, cfg.norm)
    q, k, v = _qkv(cfg, hp, p, h)
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
    out = _apply_out_proj(p["wo"], o, name="wo")
    if cfg.post_norms:
        out = apply_norm(p["post_ln"], out, cfg.norm)
    return x + out


def _mlp_sublayer(cfg, b: BlockDef, p, x):
    if b.mlp == "none":
        return x
    h = apply_norm(p["ln2"], x, cfg.norm)
    u = activation(apply_linear(p["wg"], h, name="wg"), cfg.act)
    if cfg.gated_mlp:
        u = u * apply_linear(p["wu"], h, name="wu")
    y = apply_linear(p["wd"], u, name="wd")
    if cfg.post_norms:
        y = apply_norm(p["post_ln2"], y, cfg.norm)
    return x + y


def _block_apply(cfg, hp, b, p, x, *, pos_ids, **attn_kw):
    x = _attn_sublayer(cfg, hp, b, p, x, pos_ids=pos_ids, **attn_kw)
    return _mlp_sublayer(cfg, b, p, x)


def _quantized(a) -> bool:
    return isinstance(a, (QuantizedTensor, HoistedDequant))


def period_slice(stack, i):
    """Period ``i`` (or a slice of periods) of a stacked block tree (dense,
    QuantizedTensor or HoistedDequant leaves)."""
    return tree_map(lambda a: a.map_arrays(lambda t: t[i]) if _quantized(a) else a[i],
                    stack, is_leaf=_quantized)


def _run_stack(plan: ModelPlan, stack_params: dict, pattern, x, *, mode: str, pos_ids,
               caches=None, **attn_kw):
    """Loop over periods.  ``caches`` (leaves with a leading period axis) are
    written in place through each period's views."""
    cfg, hp = plan.cfg, plan.heads
    for period in range(cfg.n_periods):
        p_period = period_slice(stack_params, period)
        for i, b in enumerate(pattern):
            cache = None if caches is None else {k: t[period] for k, t in caches[f"b{i}"].items()}
            x = _block_apply(cfg, hp, b, p_period[f"b{i}"], x, mode=mode, pos_ids=pos_ids,
                             cache=cache, kv_dtype=plan.kv_cache_dtype, **attn_kw)
    return x


# ---------------------------------------------------------------------------
# Loss / heads
# ---------------------------------------------------------------------------


def _head_logits(xc, head):
    if isinstance(head, tuple) and head[0] == "tied":
        return xc.to(torch.float32) @ head[1].to(torch.float32).T
    if isinstance(head, QuantizedTensor):
        return apply_linear(head, xc).to(torch.float32)
    return xc.to(torch.float32) @ head.to(torch.float32)


def _logit_head(plan, params):
    if plan.cfg.tie_embeddings:
        return ("tied", params["embed"])
    return params["lm_head"]


def _embed_tokens(plan, params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(plan.dtype)
    if plan.cfg.name.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(plan.cfg.d_model), dtype=plan.dtype, device=x.device)
    return x


def as_tokens(tokens, device) -> torch.Tensor:
    """numpy or torch token ids → int64 tensor on ``device``."""
    return torch.as_tensor(tokens, device=device).long()


def chunked_cross_entropy(x, head, labels, mask, *, real_vocab: int, chunk: int = 512,
                          logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Mean masked LM cross-entropy, logits formed one sequence chunk at a time."""
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


def hidden_states(plan: ModelPlan, params, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) ids → (B, S, d) final-norm hidden states, teacher-forced."""
    cfg = plan.cfg
    x = _embed_tokens(plan, params, tokens)
    pos = torch.arange(tokens.shape[1], device=x.device)
    x = _run_stack(plan, params["dec"], cfg.pattern, x, mode="train", pos_ids=pos)
    return apply_norm(params["final_norm"], x, cfg.norm)


def train_loss(plan: ModelPlan, params, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B, S)} → scalar next-token loss."""
    cfg = plan.cfg
    tokens = as_tokens(batch["tokens"], params["embed"].device)
    B, S = tokens.shape
    x = hidden_states(plan, params, tokens)
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], 1)
    mask = torch.ones(B, S, dtype=torch.float32, device=x.device)
    mask[:, -1] = 0.0
    return chunked_cross_entropy(
        x, _logit_head(plan, params), labels, mask,
        real_vocab=cfg.vocab, logit_softcap=cfg.logit_softcap,
    )


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------


def _block_cache_shape(plan: ModelPlan, b: BlockDef, B: int, cap: int) -> dict:
    hp = plan.heads
    c = min(cap, b.window) if b.window is not None else cap
    if plan.kv_cache_dtype == "int4":
        raise ValueError(
            "kv_cache_dtype='int4' is paged-engine only (packed pages, "
            "quant.kv_pack_int4); the contiguous cache supports bf16 and int8"
        )
    kv = (B, c, hp.kv_pad, hp.head_dim)
    if plan.kv_cache_dtype == "int8":
        sc = ((B, c, hp.kv_pad, 1), torch.float32)
        return {"k": (kv, torch.int8), "v": (kv, torch.int8), "ks": sc, "vs": sc}
    return {"k": (kv, torch.bfloat16), "v": (kv, torch.bfloat16)}


def _stacked(plan: ModelPlan, per_block: dict) -> dict:
    n = plan.cfg.n_periods
    return {blk: {k: ((n, *shape), dt) for k, (shape, dt) in leaves.items()}
            for blk, leaves in per_block.items()}


def cache_shapes(plan: ModelPlan, B: int, cap: int) -> dict:
    """``{"b<i>": {leaf: (shape, dtype)}}`` of the contiguous decode cache,
    stacked over periods."""
    return _stacked(plan, {f"b{i}": _block_cache_shape(plan, b, B, cap)
                           for i, b in enumerate(plan.cfg.pattern)})


def paged_cache_shapes(plan: ModelPlan, n_pages: int, page_size: int) -> dict:
    """``{"b<i>": {leaf: (shape, dtype)}}`` of the block-paged decode cache.

    Per attention layer ``k``/``v`` pages ``(n_pages, page_size, KVp, hd)``
    (int8 adds fp32 ``ks``/``vs`` scale planes ``(…, 1)``; int4 stores uint8
    pages of width ``hd/2`` with the same scale planes), stacked over
    periods: page id ``p`` addresses slot ``p`` of every layer's array.  No
    batch axis: ownership lives in the page tables.  Only self-attention
    decoder stacks page.
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
    page = ((n_pages, page_size, hp.kv_pad, page_hd), kdt)
    sh = {"k": page, "v": page}
    if kv_dt in ("int8", "int4"):
        sh["ks"] = sh["vs"] = ((n_pages, page_size, hp.kv_pad, 1), torch.float32)
    return _stacked(plan, {f"b{i}": sh for i in range(len(cfg.pattern))})


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
    return softcap(_head_logits(x, _logit_head(plan, params))[:, 0], cfg.logit_softcap)


def _positions(pos, B: int, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(pos, device=device).long(), (B,))


@torch.no_grad()
def prefill(plan: ModelPlan, params, batch: dict, cache):
    """Full-sequence forward filling ``cache``; returns ``(last_logits, cache)``."""
    dev = params["embed"].device
    tokens = as_tokens(batch["tokens"], dev)
    x = _embed_tokens(plan, params, tokens)
    pos = torch.arange(tokens.shape[1], device=dev)
    x = _run_stack(plan, params["dec"], plan.cfg.pattern, x, mode="prefill", pos_ids=pos,
                   caches=cache)
    return _final_logits(plan, params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(plan: ModelPlan, params, tokens, cache, pos):
    """One decode step.  tokens: (B, 1); pos: scalar or (B,) positions (one
    per slot: continuous batching).  Returns ``(logits, cache)``."""
    dev = params["embed"].device
    tokens = as_tokens(tokens, dev)
    pos_b = _positions(pos, tokens.shape[0], dev)
    x = _embed_tokens(plan, params, tokens)
    x = _run_stack(plan, params["dec"], plan.cfg.pattern, x, mode="decode",
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
    x = _embed_tokens(plan, params, tokens)
    pos = offset + torch.arange(tokens.shape[1], device=dev)
    _run_stack(plan, params["dec"], plan.cfg.pattern, x, mode="prefill", pos_ids=pos,
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
    x = _embed_tokens(plan, params, tokens)
    x = _run_stack(
        plan, params["dec"], plan.cfg.pattern, x, mode="decode", pos_ids=pos_b[:, None],
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
