"""Model configuration schema and registry (the port's copy of
``repro.configs.base``).

A model is ``n_periods`` repetitions of a period pattern, a tuple of
:class:`BlockDef`.  The schema keeps every field of the reference so the
same config transforms apply to both packages.  The port runs the token-only
decoders: attention blocks with dense or mixture-of-experts MLPs, rotary or
learned positions.  Mamba-2, Jamba, Whisper and LLaVA are not ported yet
(``ROADMAP.md`` §1 item 7): :func:`get_config` refuses them.
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
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff


# The reference's architectures the port runs (the paper's OPT family, in
# ``opt_paper``, and ``bench_opt_s``, the benchmarks' trained model, are
# registered too).
ARCH_IDS = (
    "stablelm_12b",
    "gemma2_27b",
    "qwen15_32b",
    "phi3_mini_3_8b",
    "olmoe_1b_7b",
    "mixtral_8x22b",
)
# The reference's architectures still to port (ROADMAP.md §1 item 7).
NOT_PORTED = ("whisper_large_v3", "jamba_1_5_large", "mamba2_2_7b", "llava_next_34b")

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    name = name.replace("-", "_").replace(".", "_")
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (Mamba-2, Jamba and the encoder-decoder and prefix "
            "families: ROADMAP.md §1 item 7)")
    if name not in _REGISTRY:
        try:
            importlib.import_module(f"repro_torch.configs.{name}")
        except ModuleNotFoundError:
            # family modules registering several configs (the paper's OPT family)
            importlib.import_module("repro_torch.configs.opt_paper")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    """Every registered config name, sorted, after importing the ported
    architectures and the OPT family."""
    for arch in ARCH_IDS:
        importlib.import_module(f"repro_torch.configs.{arch}")
    importlib.import_module("repro_torch.configs.opt_paper")
    return sorted(_REGISTRY)
