"""Model assembly for dense decoders: params, forward stack, train loss.

Param tree (leaves in ``cfg.dtype``), the reference's layout:

  embed        (vocab_pad, d)
  lm_head      (d, vocab_pad)          [unless tied]
  final_norm   {scale}
  dec          {"b0": {...}, ...}: every leaf has a leading n_periods dim

Attention blocks with dense MLPs are ported; other block kinds and the
encoder-decoder and prefix families raise ``NotImplementedError``.  The
stack is a Python loop over periods (the reference scans them).
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
    activation,
    apply_linear,
    apply_norm,
    flash_attention,
    make_head_plan,
    rope,
    softcap,
    _record_linear,
)
from repro_torch.quant import QuantizedTensor

__all__ = [
    "ModelPlan",
    "make_plan",
    "model_defs",
    "init_params",
    "train_loss",
    "tree_map",
    "period_slice",
]


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    cfg: ModelConfig
    heads: HeadPlan
    vocab_pad: int

    @property
    def dtype(self):
        return self.cfg.dtype


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "lm" or cfg.n_prefix or cfg.pos != "rope":
        raise NotImplementedError("the port runs rope token-only decoders so far")
    for b in cfg.pattern:
        if b.kind != "attn" or b.mlp not in ("dense", "none") or b.cross:
            raise NotImplementedError(f"block {b} is not ported yet")


def make_plan(cfg: ModelConfig) -> ModelPlan:
    _check_supported(cfg)
    return ModelPlan(
        cfg=cfg, heads=make_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.hd), vocab_pad=cfg.vocab
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
# Forward blocks (train / teacher-forced mode)
# ---------------------------------------------------------------------------


def _qkv(cfg, hp: HeadPlan, p, h):
    q = apply_linear(p["wq"], h, out_shape=(hp.kv_pad, hp.g_pad, hp.head_dim), name="wq")
    k = apply_linear(p["wk"], h, out_shape=(hp.n_kv, hp.head_dim), name="wk")
    v = apply_linear(p["wv"], h, out_shape=(hp.n_kv, hp.head_dim), name="wv")
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _apply_out_proj(w, o, name=None):
    """o: (B, S, KVp, Gp, hd) → (B, S, d); dense 4-D weight or QuantizedTensor
    with codes (d, KVp·Gp·hd)."""
    o2 = o.reshape(*o.shape[:2], -1)
    if isinstance(w, QuantizedTensor):
        return apply_linear(w, o2, name=name)
    _record_linear(name, o2)
    return o2 @ w.reshape(-1, w.shape[-1])


def _attn_sublayer(cfg, hp, b: BlockDef, p, x, *, pos_ids):
    h = apply_norm(p["ln"], x, cfg.norm)
    q, k, v = _qkv(cfg, hp, p, h)
    q = rope(q, pos_ids, cfg.rope_theta)
    k = rope(k, pos_ids, cfg.rope_theta)
    o = flash_attention(
        q, k, v, causal=b.causal, window=b.window, attn_softcap=cfg.attn_softcap
    )
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


def _block_apply(cfg, hp, b, p, x, *, mode="train", pos_ids):
    if mode != "train":
        raise NotImplementedError("prefill/decode arrive with the serving slice")
    x = _attn_sublayer(cfg, hp, b, p, x, pos_ids=pos_ids)
    return _mlp_sublayer(cfg, b, p, x)


def period_slice(stack, i: int):
    """Period ``i`` of a stacked block tree (dense or QuantizedTensor leaves)."""
    return tree_map(
        lambda a: a.map_arrays(lambda t: t[i]) if isinstance(a, QuantizedTensor) else a[i],
        stack,
        is_leaf=lambda a: isinstance(a, QuantizedTensor),
    )


def _run_stack(plan: ModelPlan, stack_params: dict, pattern, x, *, mode: str, pos_ids):
    cfg, hp = plan.cfg, plan.heads
    for period in range(cfg.n_periods):
        p_period = period_slice(stack_params, period)
        for i, b in enumerate(pattern):
            x = _block_apply(cfg, hp, b, p_period[f"b{i}"], x, mode=mode, pos_ids=pos_ids)
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
