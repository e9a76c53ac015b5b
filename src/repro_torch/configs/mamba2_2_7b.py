"""Mamba2-2.7B [arXiv:2405.21060; attention-free SSM].

64L, d_model 2560, d_inner 5120 (expand 2), headdim 64 (80 SSD heads),
ssm_state 128, vocab 50280.  Pure SSD (state-space duality) blocks — no
attention, no MLP (the Mamba block IS the mixer+channel mixer).
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2_2_7b",
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        pattern=(BlockDef(kind="mamba", mlp="none"),),
        n_periods=64,
        pos="none",
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        tie_embeddings=True,
    )
)
