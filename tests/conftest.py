import dataclasses
import os
import sys

# NOTE: never set xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device; only launch/dryrun.py forges 512.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped where CUDA is absent"
    )


def reduce_cfg(cfg, **over):
    kw = dict(
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=256,
        n_periods=2,
        max_seq=512,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2),
        moe_d_ff=128 if cfg.n_experts else 0,
        ssm_state=16,
        ssm_headdim=8,
        ssm_expand=2,
        n_enc_periods=2 if cfg.n_enc_periods else 0,
        n_frames=32 if cfg.family == "encdec" else 1500,
        n_prefix=8 if cfg.n_prefix else 0,
    )
    kw.update(over)
    return dataclasses.replace(cfg, **kw)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def layer_problem():
    """A realistic (W, Σ) layer-quantization problem."""
    import jax.numpy as jnp

    r = np.random.default_rng(42)
    q, p, n = 96, 128, 512
    x = r.standard_normal((p, n)).astype(np.float32)
    w = r.standard_normal((q, p)).astype(np.float32)
    w[r.random((q, p)) < 0.003] *= 10.0
    return jnp.asarray(w), jnp.asarray(x @ x.T)
