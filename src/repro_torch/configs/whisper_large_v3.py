"""Whisper-large-v3 [arXiv:2212.04356; audio enc-dec].

32 encoder + 32 decoder layers ("32L" in the assignment refers to the
per-stack depth of the large model), d_model 1280, 20 heads (kv=20,
head_dim 64), d_ff 5120, vocab 51866.  LayerNorm + plain (non-gated) GELU
MLPs, learned positions.  The conv frontend is a STUB, as in the
reference: a batch carries precomputed (B, 1500, d_model) frame embeddings
(``data.pipeline.make_batch_fn``).
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper_large_v3",
        family="encdec",
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab=51866,
        pattern=(BlockDef(kind="attn", mlp="dense", cross=True),),
        n_periods=32,
        enc_pattern=(BlockDef(kind="attn", mlp="dense", causal=False),),
        n_enc_periods=32,
        norm="layernorm",
        act="gelu",
        gated_mlp=False,
        pos="learned",
        max_seq=1 << 16,
        n_frames=1500,
    )
)
