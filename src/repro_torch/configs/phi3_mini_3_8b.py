"""Phi-3-mini-3.8B [arXiv:2404.14219; dense].

32L, d_model 3072, 32 heads (kv=32, head_dim 96), d_ff 8192, vocab 32064.
RoPE + SwiGLU + RMSNorm.
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="phi3_mini_3_8b",
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab=32064,
        pattern=(BlockDef(kind="attn", mlp="dense"),),
        n_periods=32,
        rope_theta=10_000.0,
    )
)
