"""Jamba-1.5-Large (398B total / 94B active) [arXiv:2403.19887; hybrid].

72L, d_model 8192, 64 heads (GQA kv=8, head_dim 128), d_ff 24576,
vocab 65536; MoE 16 experts top-2 on every other layer; attention on every
8th layer (1:7 attn:mamba interleave).  Period of 8 = [attn, 7×mamba] with
MoE on odd in-period indices (4 MoE layers / period → every other layer).
No positional embeddings (the Mamba layers carry position).

The SSM layers use the Mamba-2 SSD chunked formulation rather than
Mamba-1's sequential selective scan, as the reference does.
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

_PERIOD = tuple(
    BlockDef(
        kind="attn" if i == 0 else "mamba",
        mlp="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = register(
    ModelConfig(
        name="jamba_1_5_large",
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab=65536,
        pattern=_PERIOD,
        n_periods=9,
        pos="none",
        n_experts=16,
        top_k=2,
        moe_d_ff=24576,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
    )
)
