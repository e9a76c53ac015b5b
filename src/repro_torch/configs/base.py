"""Model configuration schema and registry (the port's copy of
``repro.configs.base``).

A model is ``n_periods`` repetitions of a period pattern, a tuple of
:class:`BlockDef`.  The schema keeps every field of the reference so the
same config transforms apply to both packages.  The port runs the token-only
decoders (attention and Mamba-2 (SSD) blocks with dense or
mixture-of-experts MLPs, rotary, learned or no positions), the
encoder-decoder family (Whisper: an encoder stack over precomputed frames,
cross-attention in the decoder) and the prefix family (LLaVA: projected
patch embeddings prepended to the text).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

import torch

__all__ = ["BlockDef", "ModelConfig", "register", "get_config", "list_configs", "ARCH_IDS"]


@dataclasses.dataclass(frozen=True)
class BlockDef:
    kind: str = "attn"  # "attn" | "mamba"
    mlp: str = "dense"  # "dense" | "moe" | "none"
    window: Optional[int] = None  # sliding-window size (None = full)
    causal: bool = True
    cross: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "lm"
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0  # 0 → d_model // n_heads
    d_ff: int = 2048
    vocab: int = 32000
    pattern: tuple = (BlockDef(),)
    n_periods: int = 2
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    post_norms: bool = False
    tie_embeddings: bool = False
    pos: str = "rope"
    max_seq: int = 1 << 19
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_norm_topk: bool = True
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    enc_pattern: tuple = ()
    n_enc_periods: int = 0
    n_frames: int = 1500
    n_prefix: int = 0
    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def n_layers(self) -> int:
        return self.n_periods * len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def param_count(self) -> int:
        """Total parameter count, the reference's ``ModelConfig.param_count``."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token meets (MoE: only its top-k experts counted)."""
        return _count_params(self, active_only=True)


def _attn_params(cfg: ModelConfig, cross: bool = False) -> int:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n = d * h * hd + 2 * d * kv * hd + h * hd * d  # q, k, v, o
    if cfg.qkv_bias and not cross:
        n += (h + 2 * kv) * hd
    return n


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    d = cfg.d_model
    return (2 * d * d_ff if cfg.gated_mlp else d * d_ff) + d_ff * d


def _mamba_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_nheads
    n = d * d_in_proj + cfg.conv_dim * cfg.ssm_conv + cfg.conv_dim
    n += 3 * cfg.ssm_nheads + cfg.d_inner  # A_log, D, dt_bias, gate norm
    n += cfg.d_inner * d
    return n


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.vocab * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab
    if cfg.pos == "learned":
        n += cfg.max_seq * cfg.d_model

    def block_count(b: BlockDef) -> int:
        c = 0
        if b.kind == "attn":
            c += _attn_params(cfg) + cfg.d_model  # + ln
            if b.cross:
                c += _attn_params(cfg, cross=True) + cfg.d_model
        else:
            c += _mamba_params(cfg) + cfg.d_model
        if b.mlp == "dense":
            c += _mlp_params(cfg, cfg.d_ff) + cfg.d_model
        elif b.mlp == "moe":
            e = cfg.top_k if active_only else cfg.n_experts
            c += cfg.d_model * cfg.n_experts  # router
            c += e * _mlp_params(cfg, cfg.moe_ff) + cfg.d_model
        return c

    n += cfg.n_periods * sum(block_count(b) for b in cfg.pattern)
    n += cfg.n_enc_periods * sum(block_count(b) for b in cfg.enc_pattern)
    return n


# The reference's architectures, all ported (the paper's OPT family, in
# ``opt_paper``, and ``bench_opt_s``, the benchmarks' trained model, are
# registered too).
ARCH_IDS = (
    "stablelm_12b",
    "gemma2_27b",
    "qwen15_32b",
    "phi3_mini_3_8b",
    "whisper_large_v3",
    "jamba_1_5_large",
    "olmoe_1b_7b",
    "mixtral_8x22b",
    "mamba2_2_7b",
    "llava_next_34b",
)
# The reference's architectures still to port: none.
NOT_PORTED = ()

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name not in _REGISTRY:
        try:
            importlib.import_module(f"repro_torch.configs.{name}")
        except ModuleNotFoundError:
            # family modules registering several configs (the paper's OPT family)
            importlib.import_module("repro_torch.configs.opt_paper")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    """Every registered config name, sorted, after importing the
    architectures and the OPT family."""
    for arch in ARCH_IDS:
        importlib.import_module(f"repro_torch.configs.{arch}")
    importlib.import_module("repro_torch.configs.opt_paper")
    return sorted(_REGISTRY)
