"""Gemma-2-27B [arXiv:2408.00118; dense].

46L, d_model 4608, 32 heads (GQA kv=16, head_dim 128), d_ff 36864,
vocab 256000.  Local(4096-window)/global alternating attention, logit
softcap 30, attention softcap 50, GeGLU, pre+post sublayer RMSNorms,
tied embeddings.
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma2_27b",
        d_model=4608,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=36864,
        vocab=256000,
        pattern=(
            BlockDef(kind="attn", mlp="dense", window=4096),  # local
            BlockDef(kind="attn", mlp="dense", window=None),  # global
        ),
        n_periods=23,
        rope_theta=10_000.0,
        logit_softcap=30.0,
        attn_softcap=50.0,
        act="gelu",
        post_norms=True,
        tie_embeddings=True,
    )
)
