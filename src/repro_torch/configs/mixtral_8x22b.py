"""Mixtral-8x22B [arXiv:2401.04088; MoE].

56L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), per-expert d_ff
16384, vocab 32768; 8 experts top-2 (softmax over selected logits);
sliding-window attention (4096) per the assignment note.
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mixtral_8x22b",
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab=32768,
        pattern=(BlockDef(kind="attn", mlp="moe", window=4096),),
        n_periods=56,
        rope_theta=1_000_000.0,
        n_experts=8,
        top_k=2,
        router_norm_topk=True,
    )
)
