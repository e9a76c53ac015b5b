"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6 family; VLM].

Backbone: Yi-34B-class decoder — 60L, d_model 7168, 56 heads (GQA kv=8,
head_dim 128), d_ff 20480, vocab 64000.  The vision tower + anyres tiling
is a STUB, as in the reference: a batch carries (B, 2880, d_model)
projected patch embeddings (anyres 2×2 tiles + base → 5 × 24² patches,
``data.pipeline.make_batch_fn``) prepended to the text sequence.
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llava_next_34b",
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab=64000,
        pattern=(BlockDef(kind="attn", mlp="dense"),),
        n_periods=60,
        rope_theta=5_000_000.0,
        n_prefix=2880,
    )
)
