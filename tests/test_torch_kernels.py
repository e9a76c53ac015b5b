"""Port parity for the kernel modules.

On the CPU the port's plain versions (``repro_torch.kernels.ref``) are held
against the JAX oracles and the Pallas kernels in interpret mode, on the
same numpy inputs.  Tolerances: atol 2e-4 on CD iterates (fp reassociation
only, as tests/test_fused_engine.py), rtol 1e-6 / atol 1e-5 on the GEMM.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dequant_matmul import dequant_matmul_pallas
from repro.kernels.quantease_cd import (
    quantease_block_sweep_pallas,
    quantease_fused_iteration_pallas,
)
from repro.quant import GridSpec, compute_grid, pack_codes, quantize_dequantize
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from tests._torch_cpu import one_torch_thread  # noqa: F401

ATOL_CD = 2e-4


def _cd_state(seed, q, p, bits=3):
    """A realistic mid-solve state: Σ̃ from a damped Gram, grid, base, Δ."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((p, 2 * p)).astype(np.float32)
    sigma = x @ x.T
    sigma += 0.01 * np.mean(np.diag(sigma)) * np.eye(p, dtype=np.float32)
    sig_norm = (sigma / np.diag(sigma)[None, :]).astype(np.float32)
    sig_tilde = (sig_norm - np.eye(p, dtype=np.float32)).astype(np.float32)
    w = r.standard_normal((q, p)).astype(np.float32)
    grid = compute_grid(jnp.asarray(w), GridSpec(bits=bits))
    scale, zero = (np.array(a) for a in grid.per_column(p))
    w_hat = np.array(quantize_dequantize(jnp.asarray(w), grid))
    base = (w @ sig_norm - w_hat @ sig_tilde).astype(np.float32)
    delta = (0.01 * r.standard_normal((q, p))).astype(np.float32)
    return dict(base=base, sig_tilde=sig_tilde, w_hat=w_hat, scale=scale, zero=zero,
                delta=delta, n_levels=1 << bits)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a.T))


def _sweep_inputs(seed, q, bsz):
    s = _cd_state(seed, q, bsz)
    return (s["base"], s["sig_tilde"], s["w_hat"], s["scale"], s["zero"]), s["n_levels"]


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("q,bsz", [(96, 64), (40, 128)])
def test_block_sweep_matches_jax_ref_and_pallas(q, bsz, quantize):
    args, n_levels = _sweep_inputs(q + bsz, q, bsz)
    kw = dict(n_levels=n_levels, quantize=quantize)
    jn, jd = jref.quantease_block_sweep_ref(*map(jnp.asarray, args), **kw)
    pn, pd = quantease_block_sweep_pallas(*map(jnp.asarray, args), interpret=True, **kw)
    tn, td = tref.quantease_block_sweep_ref(*map(torch.from_numpy, args), **kw)
    for t, j, pl in ((tn, jn, pn), (td, jd, pd)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL_CD)
        np.testing.assert_allclose(t.numpy(), np.asarray(pl), rtol=0, atol=ATOL_CD)


def test_block_sweep_transposed_batched_dispatch():
    """ops.quantease_block_sweep on CPU tensors (G, B, q) == per-slice sweeps."""
    sl = [_sweep_inputs(s, 48, 32) for s in range(3)]
    n_levels = sl[0][1]
    stacked = [torch.stack([_t(a[0][i]) for a in sl]) for i in range(5)]  # Σ̃ᵀ for i = 1
    tn, td = ops.quantease_block_sweep(*stacked, n_levels=n_levels, quantize=True)
    for g, (args, _) in enumerate(sl):
        jn, jd = jref.quantease_block_sweep_ref(*map(jnp.asarray, args), n_levels=n_levels, quantize=True)
        np.testing.assert_allclose(tn[g].T.numpy(), np.asarray(jn), rtol=0, atol=ATOL_CD)
        np.testing.assert_allclose(td[g].T.numpy(), np.asarray(jd), rtol=0, atol=ATOL_CD)


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [True, False])
def test_fused_iteration_matches_pallas(matmul_dtype, quantize):
    q, p, bsz = 96, 256, 128
    s = _cd_state(7, q, p)
    names = ("base", "sig_tilde", "w_hat", "scale", "zero", "delta")
    j_out = quantease_fused_iteration_pallas(
        *(jnp.asarray(s[k]) for k in names), n_levels=s["n_levels"], quantize=quantize,
        bsz=bsz, matmul_dtype=matmul_dtype, interpret=True,
    )
    sig_t = _t(s["sig_tilde"])
    sig_corr = sig_t.to(torch.bfloat16 if matmul_dtype == "bfloat16" else torch.float32)
    t_out = ops.quantease_fused_iteration(
        _t(s["base"]), sig_t, sig_corr, _t(s["w_hat"]), _t(s["scale"]), _t(s["zero"]),
        _t(s["delta"]), n_levels=s["n_levels"], quantize=quantize, bsz=bsz,
    )
    for t, j in zip(t_out, j_out):
        np.testing.assert_allclose(t.T.numpy(), np.asarray(j), rtol=0, atol=ATOL_CD)


def test_fused_iteration_batched_equals_per_slice():
    q, p, bsz = 32, 96, 32
    states = [_cd_state(20 + g, q, p) for g in range(2)]
    keys = ("base", "sig_tilde", "w_hat", "scale", "zero", "delta")

    def args(sts):
        base, sig, w, sc, z, d = (torch.stack([_t(s[k]) for s in sts]) for k in keys)
        return base, sig, sig, w, sc, z, d

    kw = dict(n_levels=states[0]["n_levels"], quantize=True, bsz=bsz)
    batched = tref.quantease_fused_iteration_ref(*args(states), **kw)
    for g in range(2):
        single = tref.quantease_fused_iteration_ref(*args(states[g : g + 1]), **kw)
        for b, s1 in zip(batched, single):
            np.testing.assert_allclose(b[g].numpy(), s1[0].numpy(), rtol=0, atol=1e-6)


def _gemm_problem(seed, m, q, p, n_groups):
    r = np.random.default_rng(seed)
    x = r.standard_normal((m, p)).astype(np.float32)
    codes = r.integers(0, 16, (q, p)).astype(np.uint8)
    scale = (r.random((q, n_groups)) * 0.1 + 0.01).astype(np.float32)
    zero = r.integers(0, 16, (q, n_groups)).astype(np.float32)
    return x, codes, scale, zero


@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("m,q,p,n_groups", [(8, 24, 256, 1), (5, 16, 256, 4), (3, 32, 320, 5)])
def test_dequant_matmul_matches_pallas(m, q, p, n_groups, packed4):
    x, codes, scale, zero = _gemm_problem(m * q + p, m, q, p, n_groups)
    jcodes = pack_codes(jnp.asarray(codes), 4) if packed4 else jnp.asarray(codes)
    jsc, jz = (jnp.asarray(scale[:, 0]), jnp.asarray(zero[:, 0])) if n_groups == 1 else (
        jnp.asarray(scale), jnp.asarray(zero))
    y_pl = dequant_matmul_pallas(jnp.asarray(x), jcodes, jsc, jz, packed4=packed4,
                                 out_dtype=jnp.float32, interpret=True)
    y_jr = jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale),
                                   jnp.asarray(zero))
    tcodes = torch.from_numpy(np.array(jcodes))
    y_t = ops.dequant_matmul(torch.from_numpy(x), tcodes, torch.from_numpy(scale),
                             torch.from_numpy(zero), packed4=packed4, out_dtype=torch.float32)
    for y in (y_pl, y_jr):
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y), rtol=1e-6, atol=1e-5)


def test_dequant_matmul_ragged_groups_and_bf16_out():
    x, codes, scale, zero = _gemm_problem(3, 4, 8, 384, 2)
    y_j = jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale),
                                  jnp.asarray(zero), group_size=256)
    y_t = tref.dequant_matmul_ref(torch.from_numpy(x), torch.from_numpy(codes),
                                  torch.from_numpy(scale), torch.from_numpy(zero), group_size=256)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6, atol=1e-5)
    y_b = ops.dequant_matmul(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(codes),
                             torch.from_numpy(scale), torch.from_numpy(zero), group_size=256)
    assert y_b.dtype == torch.bfloat16


def test_dispatch_refuses_other_devices():
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError):
        ops.dequant_matmul(meta, meta.to(torch.uint8), meta[:, 0], meta[:, 0])
    assert set(ops.launch_counts()) == set(ops.KERNELS)
