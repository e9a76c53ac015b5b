"""OPT-family configs (the paper's own eval family, Zhang et al. 2022).

Registered alongside the 10 assigned archs so the PTQ pipeline can target
the paper's models directly (sizes from the OPT paper; ReLU MLPs modeled as
non-gated GELU-free silu-less dense blocks → we keep gelu, the closest
supported activation, and learned positions like OPT).
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register


def _opt(name, L, d, h, ff, max_seq=2048):
    return register(
        ModelConfig(
            name=name,
            d_model=d,
            n_heads=h,
            n_kv_heads=h,
            head_dim=d // h,
            d_ff=ff,
            vocab=50272,
            pattern=(BlockDef(kind="attn", mlp="dense"),),
            n_periods=L,
            norm="layernorm",
            act="gelu",
            gated_mlp=False,
            pos="learned",
            max_seq=max_seq,
            tie_embeddings=True,
        )
    )


OPT_125M = _opt("opt_125m", 12, 768, 12, 3072)
OPT_350M = _opt("opt_350m", 24, 1024, 16, 4096)
OPT_1_3B = _opt("opt_1_3b", 24, 2048, 32, 8192)
OPT_6_7B = _opt("opt_6_7b", 32, 4096, 32, 16384)
OPT_66B = _opt("opt_66b", 64, 9216, 72, 36864)
