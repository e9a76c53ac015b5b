"""StableLM-2-12B [hf:stabilityai/stablelm-2-1_6b family; dense].

40L, d_model 5120, 32 heads (GQA kv=8, head_dim 160), d_ff 13824,
vocab 100352.  Plain pre-norm SwiGLU decoder.
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm_12b",
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=160,
        d_ff=13824,
        vocab=100352,
        pattern=(BlockDef(kind="attn", mlp="dense"),),
        n_periods=40,
        rope_theta=10_000.0,
    )
)
