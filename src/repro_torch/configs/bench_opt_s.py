"""``bench_opt_s``: the small dense decoder the reference's benchmarks train
on the synthetic corpus (the port's copy of ``benchmarks/common.py``'s
``BENCH_CFG``).

4 layers, d_model 128, 4 heads of 32 (kv 4), d_ff 384, vocab 256, max_seq
512.  RoPE + SwiGLU + RMSNorm, bf16 params.
"""

from repro_torch.configs.base import BlockDef, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="bench_opt_s",
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=384,
        vocab=256,
        pattern=(BlockDef(kind="attn", mlp="dense"),),
        n_periods=4,
        max_seq=512,
    )
)
