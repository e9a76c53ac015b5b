"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family; dense].

64L, d_model 5120, 40 heads (GQA kv=40 — i.e. MHA, head_dim 128),
d_ff 27392, vocab 152064.  QKV bias (the Qwen signature), SwiGLU.
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen15_32b",
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab=152064,
        pattern=(BlockDef(kind="attn", mlp="dense"),),
        n_periods=64,
        rope_theta=1_000_000.0,
        qkv_bias=True,
    )
)
