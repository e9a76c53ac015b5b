"""Model configuration schema and registry (the port's copy of
``repro.configs.base``).

A model is ``n_periods`` repetitions of a period pattern, a tuple of
:class:`BlockDef`.  The schema keeps every field of the reference so the
same config transforms apply to both packages; the port runs the dense
decoder subset (attention blocks with dense MLPs).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

import torch

__all__ = ["BlockDef", "ModelConfig", "register", "get_config", "ARCH_IDS"]


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


# Architectures the port runs so far (``bench_opt_s``, the benchmarks'
# trained model, is registered too: ``get_config("bench_opt_s")``).
ARCH_IDS = ("phi3_mini_3_8b",)

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name}")
    return _REGISTRY[name]
