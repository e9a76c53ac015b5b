"""OLMoE-1B-7B [arXiv:2409.02060; MoE].

16L, d_model 2048, 16 heads (kv=16, head_dim 128), per-expert d_ff 1024,
vocab 50304; 64 experts, top-8 (softmax-then-topk, no renorm).
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="olmoe_1b_7b",
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab=50304,
        pattern=(BlockDef(kind="attn", mlp="moe"),),
        n_periods=16,
        rope_theta=10_000.0,
        n_experts=64,
        top_k=8,
        router_norm_topk=False,
    )
)
