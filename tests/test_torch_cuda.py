"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
elsewhere.  This file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: atol 2e-4 on CD iterates (fp reassociation; a rounding tie that
flips cascades along its row, so the fused checks hold rows), 1e-4 of
max |R| on the outlier iteration's exact residual in rows whose sweep
agrees, rtol 1e-6 / atol 1e-4 on fp32 GEMM output (every variant; the
tensor-core variants flush their truncating MMA sums into an IEEE fp32
total every 128 k), 1e-2 of max |y| on bf16 GEMM output, atol 2e-2 (bf16 q) and
1e-5 (fp32 q) on paged attention; GPTQ 1e-4 of max |W| outside rows that
start at a rounding tie, one train step and ``eval_model`` 1e-3 relative
(card against CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import quantease as qe
from repro_torch.core.calib import damp_sigma
from repro_torch.kernels import ops, ref
from repro_torch.quant import GridSpec, compute_grid, pack_codes, quantize_dequantize

pytestmark = pytest.mark.cuda
ATOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import resolve_device

    return resolve_device("cuda")


def _state(seed, G, q, p, dev, bits=4):
    """A mid-solve fused-engine state, transposed (G, p, q), from numpy
    (a Gram of 2p tokens, or 1024 above p = 3072, to keep its CPU product
    short)."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((G, p, 2 * p if p <= 3072 else 1024)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((G, q, p)).astype(np.float32))
    grid = compute_grid(w, GridSpec(bits=bits))
    w32, _, scale, zero, sig_tilde, pmat = qe._prep(w, x @ x.transpose(-1, -2), GridSpec(bits=bits), 0.01, grid)
    w_hat = quantize_dequantize(w32, grid)
    t = lambda a: a.transpose(-1, -2).contiguous().to(dev)
    delta = torch.from_numpy((0.01 * r.standard_normal((G, q, p))).astype(np.float32))
    return dict(base=t(pmat - w_hat @ sig_tilde), sig_t=t(sig_tilde), w=t(w_hat),
                scale=t(scale), zero=t(zero), delta=t(delta), n_levels=1 << bits)


def _rows_ok(a, b, atol=ATOL):
    return float(((a - b).abs() <= atol).all(dim=-2).float().mean())


# Kernel 1's cases: B = 40 (a short last panel of 8 columns) and 48,
# q = 37 (rows not 16-byte multiples: 4-byte copies), B = 256 at q = 3072.
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("G,q,bsz", [(1, 70, 48), (3, 200, 128), (2, 96, 256), (2, 64, 40),
                                     (2, 37, 40), (1, 3072, 256)])
def test_block_sweep(cuda, G, q, bsz, quantize):
    s = _state(G * q + bsz, G, q, bsz, cuda)
    args = (s["base"], s["sig_t"], s["w"], s["scale"], s["zero"])
    kw = dict(n_levels=s["n_levels"], quantize=quantize)
    before = ops.launch_counts()["quantease_block_sweep"]
    kn, kd = ops.quantease_block_sweep(*args, **kw)
    assert ops.launch_counts()["quantease_block_sweep"] == before + 1
    pn, pd = ref.quantease_block_sweep_t_ref(*args, **kw)
    torch.testing.assert_close(kn, pn, rtol=0, atol=ATOL)
    torch.testing.assert_close(kd, pd, rtol=0, atol=ATOL)
    if G == 1:  # the unbatched (B, q) form
        k2 = ops.quantease_block_sweep(*(a[0] for a in args), **kw)
        torch.testing.assert_close(k2[0], kn[0], rtol=0, atol=0)


def _sweep_args(s):
    return (s["base"], s["sig_t"], s["w"], s["scale"], s["zero"])


def _all_sweep_plans():
    from repro_torch.kernels import quantease_cd as qcd

    return [(qcd.SWEEP_PANEL, r) for r in qcd.SWEEP_ROWS]


@pytest.mark.parametrize("G,q,bsz", [(2, 100, 256), (1, 70, 40), (3, 37, 128)])
def test_sweep_plans_agree_and_repeat_bitwise(cuda, G, q, bsz):
    """Every plan sums each β in the same order (one FMA chain over
    ascending j), so every plan and every repeat is bit-identical."""
    from repro_torch.kernels import quantease_cd as qcd

    s = _state(q + bsz, G, q, bsz, cuda)
    kw = dict(n_levels=s["n_levels"], quantize=True)
    first = qcd.block_sweep_cuda(*_sweep_args(s), **kw)
    for plan in _all_sweep_plans():
        for _ in range(2):
            out = qcd.block_sweep_cuda(*_sweep_args(s), **kw, sweep_plan=plan)
            assert torch.equal(out[0], first[0]) and torch.equal(out[1], first[1]), plan


@pytest.mark.parametrize("q", [33, 70, 96])
def test_sweep_reads_nothing_past_its_operands(cuda, q):
    """Each operand set in NaN off 16-byte alignment (q = 96 too, so the
    16-byte path would be taken but for the alignment): the outputs are
    finite and hold to the plain version, so no copy reached past an
    operand, under every plan."""
    from repro_torch.kernels import quantease_cd as qcd

    s = _state(q + 3, 2, q, 40, cuda)
    args = tuple(_nan_padded(a) for a in _sweep_args(s))
    kw = dict(n_levels=s["n_levels"], quantize=True)
    pn, pd = ref.quantease_block_sweep_t_ref(*_sweep_args(s), **kw)
    for plan in _all_sweep_plans():
        kn, kd = qcd.block_sweep_cuda(*args, **kw, sweep_plan=plan)
        assert bool(torch.isfinite(kn).all() and torch.isfinite(kd).all()), plan
        torch.testing.assert_close(kn, pn, rtol=0, atol=ATOL)
        torch.testing.assert_close(kd, pd, rtol=0, atol=ATOL)


@pytest.mark.parametrize("q", [70, 96])
def test_sweep_into_iteration_buffers(cuda, q):
    """``out=`` views of one block (B = 48) in the middle of (G, p_pad, q)
    buffers, as the iteration wrappers pass them: the block's rows match
    the plain version and nothing outside the block is written."""
    from repro_torch.kernels import quantease_cd as qcd

    s = _state(q, 2, q, 144, cuda)
    sl = slice(48, 96)
    args = (s["base"][:, sl], s["sig_t"][:, sl, sl], s["w"][:, sl], s["scale"][:, sl], s["zero"][:, sl])
    kw = dict(n_levels=s["n_levels"], quantize=True)
    w_new = torch.full_like(s["base"], float("nan"))
    delta = torch.full_like(s["base"], float("nan"))
    qcd.block_sweep_cuda(*args, **kw, out=(w_new[:, sl], delta[:, sl]))
    pn, pd = ref.quantease_block_sweep_t_ref(*args, **kw)
    torch.testing.assert_close(w_new[:, sl], pn, rtol=0, atol=ATOL)
    torch.testing.assert_close(delta[:, sl], pd, rtol=0, atol=ATOL)
    for t in (w_new, delta):
        assert bool(t[:, :48].isnan().all() and t[:, 96:].isnan().all())


# The correction's cases: q not a multiple of the 128-column tile (or of 4);
# B of 32 and 64 (the 64-row tile), 128 and 256 (the 128-row tile; at q =
# 3072 unsplit); B = 40, not a multiple of the 16-deep k-step (a k-step
# straddles each block boundary); k split by the planner at p = 2048, 3072
# and 8192 (q = 256 there, so that the 1 % of rows the check allows is two
# rows: at p = 8192 a rounding tie resolved the other way flips a row).
CORR_CASES = [(1, 100, 384, 128), (2, 64, 512, 256), (3, 33, 96, 32), (2, 70, 160, 40),
              (1, 3072, 512, 64), (1, 3072, 512, 256)]


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,q,p,bsz", CORR_CASES + [(1, 100, 2048, 256), (1, 256, 8192, 256)])
def test_fused_iteration(cuda, G, q, p, bsz, matmul_dtype):
    s = _state(p + q, G, q, p, cuda)
    sig_corr = s["sig_t"].to(torch.bfloat16) if matmul_dtype == "bfloat16" else s["sig_t"]
    args = (s["base"], s["sig_t"], sig_corr, s["w"], s["scale"], s["zero"], s["delta"])
    kw = dict(n_levels=s["n_levels"], quantize=True, bsz=bsz)
    before = ops.launch_counts()
    k_out = ops.quantease_fused_iteration(*args, **kw)
    after = ops.launch_counts()
    assert after["quantease_fused_iteration"] - before["quantease_fused_iteration"] == p // bsz
    assert after["quantease_block_sweep"] - before["quantease_block_sweep"] == p // bsz
    p_out = ref.quantease_fused_iteration_ref(*args, **kw)
    for k, pl in zip(k_out, p_out):
        assert _rows_ok(k, pl) >= 0.99


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_quantease_engine_matches_plain(cuda, matmul_dtype):
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((2, 320, 1024)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(r.standard_normal((2, 150, 320)).astype(np.float32)).to(cuda)
    sigma = x @ x.transpose(-1, -2)
    kw = dict(iterations=7, block_size=128, matmul_dtype=matmul_dtype)
    wk, hk = qe.quantease_quantize(w, sigma, GridSpec(bits=3), use_kernel="cuda", track_objective=True, **kw)
    wp, hp = qe.quantease_quantize(w, sigma, GridSpec(bits=3), use_kernel="torch", track_objective=True, **kw)
    ek, ep = qe.relative_error(w, wk, sigma), qe.relative_error(w, wp, sigma)
    torch.testing.assert_close(ek, ep, rtol=1e-3, atol=0)
    torch.testing.assert_close(hk, hp, rtol=1e-3, atol=0)
    assert _rows_ok(wk.transpose(-1, -2), wp.transpose(-1, -2)) >= 0.98


def _outlier_args(s, seed, cdt):
    """Kernel 4's operands: the fused-engine state plus a sparse dĤ (2 %)."""
    r = np.random.default_rng(seed)
    dh = np.where(r.random(tuple(s["base"].shape)) < 0.02,
                  r.standard_normal(tuple(s["base"].shape)), 0.0).astype(np.float32)
    sig_corr = s["sig_t"].to(cdt)
    return (s["base"], s["sig_t"], sig_corr, s["w"], s["scale"], s["zero"], s["delta"],
            torch.from_numpy(0.05 * dh).to(s["base"].device))


@pytest.mark.parametrize("matmul_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,q,p,bsz", CORR_CASES + [(2, 70, 160, 32), (1, 100, 3072, 128),
                                                    (1, 256, 8192, 128)])
def test_outlier_iteration(cuda, G, q, p, bsz, matmul_dtype):
    """Kernel 4 against its plain version at the correction's cases, plus B
    = 32 and 40 (suffix tiles whose rows straddle blocks) and corrections
    whose k range the planner splits."""
    s = _state(p + q + 1, G, q, p, cuda, bits=3)
    args = _outlier_args(s, p + q, matmul_dtype)
    kw = dict(n_levels=s["n_levels"], quantize=True, bsz=bsz)
    before = ops.launch_counts()
    k_out = ops.quantease_outlier_iteration(*args, **kw)
    after = ops.launch_counts()
    assert after["quantease_outlier_iteration"] - before["quantease_outlier_iteration"] == p // bsz + 1
    assert after["quantease_block_sweep"] - before["quantease_block_sweep"] == p // bsz
    p_out = ref.quantease_outlier_iteration_ref(*args, **kw)
    for k, pl in zip(k_out[:3], p_out[:3]):
        assert _rows_ok(k, pl) >= 0.99
    # R: rows (output channels) whose sweep agrees hold to 1e-4 of max |R|.
    same = torch.stack([((k - pl).abs() <= ATOL).all(dim=-2) for k, pl in zip(k_out[:3], p_out[:3])]).all(0)
    err = ((k_out[3] - p_out[3]).abs().amax(dim=-2))[same]
    assert float(err.max()) <= 1e-4 * float(p_out[3].abs().max())


def test_outlier_iteration_exact_residual(cuda):
    """R = P − Ŵ_new Σ̃ for the iterate the kernel returns, checked against a
    dense product (no sweep round-off in the identity)."""
    s = _state(9, 2, 80, 256, cuda, bits=3)
    args = _outlier_args(s, 9, torch.float32)
    w_new, base_new, dpure, r = ops.quantease_outlier_iteration(*args, n_levels=8, quantize=True, bsz=64)
    blk = torch.arange(256, device=cuda) // 64
    sig_suffix = torch.where(blk[None, :] >= blk[:, None], s["sig_t"], 0.0)
    torch.testing.assert_close(r, base_new + sig_suffix @ dpure, rtol=0, atol=1e-4)


def _iteration(engine, args, bsz, plan=None):
    """Kernel 2 (``engine="fused"``, the first 7 operands) or kernel 4 on
    ``args``, through the wrapper (a pinned ``plan``) and the plain version."""
    from repro_torch.kernels import quantease_cd as qcd

    kw = dict(n_levels=8, quantize=True, bsz=bsz)  # the 3-bit states below
    if engine == "fused":
        args = args[:7]
        return (qcd.fused_iteration_cuda(*args, **kw, plan=plan),
                ref.quantease_fused_iteration_ref(*args, **kw))
    return (qcd.outlier_iteration_cuda(*args, **kw, plan=plan)[:3],
            ref.quantease_outlier_iteration_ref(*args, **kw)[:3])


@pytest.mark.parametrize("engine", ["fused", "outlier"])
@pytest.mark.parametrize("matmul_dtype", [torch.float32, torch.bfloat16])
def test_corr_plans_agree_and_repeat_bitwise(cuda, engine, matmul_dtype):
    """Each tile, unsplit and split several ways through ``plan=``: a repeat
    is bit-identical (split-K partials are added in split order) and every
    plan holds to the plain version as the planner's own choice does."""
    s = _state(11, 2, 100, 512, cuda, bits=3)
    args = _outlier_args(s, 11, matmul_dtype)
    for plan in [None, (64, 1), (128, 1), (64, 3), (128, 4), (128, 32)]:
        k_out, p_out = _iteration(engine, args, 128, plan)
        again, _ = _iteration(engine, args, 128, plan)
        for k, a in zip(k_out, again):
            assert torch.equal(k, a), plan
        for k, pl in zip(k_out, p_out):
            assert _rows_ok(k, pl) >= 0.99, plan


def _nan_padded(t, pad=37):
    """A contiguous copy of ``t`` with ``pad`` NaN before it (which takes it
    off 16-byte alignment) and after it in the same buffer."""
    buf = torch.full((t.numel() + 2 * pad,), float("nan"), dtype=t.dtype, device=t.device)
    out = buf[pad:pad + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("engine", ["fused", "outlier"])
@pytest.mark.parametrize("q", [33, 70])
def test_corr_reads_nothing_past_its_operands(cuda, engine, q):
    """Rows of 33 and 70 floats (not 16-byte multiples), each operand set in
    NaN off 16-byte alignment: the outputs are finite and hold to the plain
    version, so no load reached past an operand."""
    s = _state(q, 2, q, 160, cuda, bits=3)
    args = _outlier_args(s, q, torch.float32)
    k_out, p_out = _iteration(engine, tuple(_nan_padded(a) for a in args), 32)
    for k, pl in zip(k_out, p_out):
        assert bool(torch.isfinite(k).all())
        assert _rows_ok(k, pl) >= 0.99


def _gemm(seed, m, q, p, n_groups, dev, x_dtype):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((m, p)).astype(np.float32)).to(dev, x_dtype)
    codes = torch.from_numpy(r.integers(0, 16, (q, p)).astype(np.uint8)).to(dev)
    scale = torch.from_numpy((r.random((q, n_groups)) * 0.1 + 0.01).astype(np.float32)).to(dev)
    zero = torch.from_numpy(r.integers(0, 16, (q, n_groups)).astype(np.float32)).to(dev)
    return x, codes, scale, zero


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("p,gsz", [(384, None), (384, 128), (384, 256), (70, 16)])
def test_dequant_matmul(cuda, p, gsz, packed4, x_dtype):
    n_groups = 1 if gsz is None else -(-p // gsz)
    x, codes, scale, zero = _gemm(p + n_groups, 77, 130, p, n_groups, cuda, x_dtype)
    kc = pack_codes(codes, 4) if packed4 else codes
    for out_dtype in (torch.float32, torch.bfloat16):
        before = ops.launch_counts()["dequant_matmul"]
        y = ops.dequant_matmul(x, kc, scale, zero, packed4=packed4, out_dtype=out_dtype, group_size=gsz)
        assert ops.launch_counts()["dequant_matmul"] == before + 1
        y_ref = ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.float32, group_size=gsz)
        assert y.dtype == out_dtype and y.shape == (77, 130)
        if out_dtype == torch.float32:
            torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=1e-4)
        else:
            assert float((y.float() - y_ref).abs().max()) <= 1e-2 * float(y_ref.abs().max())


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("gsz", [None, 128])
def test_dequant_matmul_experts(cuda, gsz, packed4, x_dtype):
    """The MoE layer's expert GEMMs on an expert-stacked QuantizedTensor
    (codes ``(E, q, p)``, packed 4-bit or uint8): one dequant-GEMM launch
    per expert, each expert against the plain version."""
    E, C, q, p = 4, 24, 130, 384
    n_groups = 1 if gsz is None else p // gsz
    per = [_gemm(e + 17 * n_groups, C, q, p, n_groups, cuda, x_dtype) for e in range(E)]
    xs, codes, scale, zero = (torch.stack([t[i] for t in per]) for i in range(4))
    kc = pack_codes(codes, 4) if packed4 else codes
    for out_dtype in (torch.float32, torch.bfloat16):
        before = ops.launch_counts()["dequant_matmul"]
        y = ops.dequant_matmul_experts(xs, kc, scale, zero, packed4=packed4, out_dtype=out_dtype,
                                       group_size=gsz)
        assert ops.launch_counts()["dequant_matmul"] == before + E
        assert y.dtype == out_dtype and y.shape == (E, C, q)
        for e in range(E):
            _dq_check(y[e], ref.dequant_matmul_ref(xs[e], codes[e], scale[e], zero[e],
                                                   out_dtype=torch.float32, group_size=gsz),
                      out_dtype)


GEMM_MS = (1, 8, 13, 64, 65, 128, 300)


def _dq_check(y, y_ref, out_dtype):
    if out_dtype == torch.float32:
        torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=1e-4)
    else:
        assert float((y.float() - y_ref).abs().max()) <= 1e-2 * float(y_ref.abs().max())


# tc_small takes group sizes that are multiples of 128 (its 128-k super-step);
# a group of 16 goes to tc_large, and the refusal is tested below.
TC_CASES = [(v, g) for v in ("tc_large", "tc_small") for g in (None, 16, 128, 256)
            if not (v == "tc_small" and g == 16)]


@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("p", [70, 384, 3072])
@pytest.mark.parametrize("variant,gsz", TC_CASES)
def test_dequant_matmul_tensor_core_variants(cuda, variant, gsz, p, packed4):
    """Each tensor-core variant, pinned, at its planned split, against the
    plain version (bf16 x; fp32 out at rtol 1e-6 / atol 1e-4)."""
    from repro_torch.kernels import dequant_matmul as dq

    n_groups = 1 if gsz is None else -(-p // gsz)
    x, codes, scale, zero = _gemm(p + n_groups, max(GEMM_MS), 130, p, n_groups, cuda, torch.bfloat16)
    kc = pack_codes(codes, 4) if packed4 else codes
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m in GEMM_MS:
        xm = x[:m].contiguous()
        y_ref = ref.dequant_matmul_ref(xm, codes, scale, zero, out_dtype=torch.float32, group_size=gsz)
        plan = (variant, dq.split_for(variant, m, 130, p, n_sm))
        for out_dtype in (torch.float32, torch.bfloat16):
            before = dict(dq.dequant_matmul_cuda.launches_by_variant)
            y = dq.dequant_matmul_cuda(xm, kc, scale, zero, packed4=packed4, out_dtype=out_dtype,
                                       group_size=gsz, plan=plan)
            assert dq.dequant_matmul_cuda.launches_by_variant[variant] == before[variant] + 1
            assert y.dtype == out_dtype and y.shape == (m, 130)
            _dq_check(y, y_ref, out_dtype)


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("q,p", [(3072, 3072), (3072, 8192)])
def test_dequant_matmul_row_parallel_partials(cuda, q, p, m):
    """The tensor-parallel row-parallel product (Phi-3-mini's ``wo`` and
    ``wd`` at a model axis of 2): each rank's k/2 columns of packed 4-bit
    per-channel codes, cut by ``dist.sharding.shard_tree``, through the
    dequant-GEMM with fp32 out (bf16 x), each partial against the plain
    version at rtol 1e-6 / atol 1e-4, and their sum against the whole
    product's plain version within 1e-4 of max |y| (two fp32 sums)."""
    from repro_torch.dist.sharding import make_rules, shard_tree
    from repro_torch.quant import QuantizedTensor

    x, codes, scale, zero = _gemm(q + p + m, m, q, p, 1, cuda, torch.bfloat16)
    qt = QuantizedTensor(codes=pack_codes(codes, 4), scale=scale, zero=zero, bits=4, packed=True)
    axes = {"codes": (None, "ffn"), "scale": (None, None), "zero": (None, None)}
    rules = make_rules({"model": 2}, d_ff=p)
    y_ref = ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.float32)
    parts = []
    for rank in range(2):
        part = shard_tree({"w": qt}, {"w": axes}, rules, rank=rank)["w"]
        assert part.codes.shape == (q, p // 4) and part.scale.data_ptr() == scale.data_ptr()
        xr = x[:, rank * p // 2:(rank + 1) * p // 2].contiguous()
        before = ops.launch_counts()["dequant_matmul"]
        y = ops.dequant_matmul(xr, part.codes, part.scale, part.zero, packed4=True,
                               out_dtype=torch.float32)
        assert ops.launch_counts()["dequant_matmul"] == before + 1 and y.dtype == torch.float32
        _dq_check(y, ref.dequant_matmul_ref(xr, part.unpacked_codes(), part.scale, part.zero,
                                            out_dtype=torch.float32), torch.float32)
        parts.append(y)
    total = parts[0] + parts[1]
    assert float((total - y_ref).abs().max()) <= 1e-4 * float(y_ref.abs().max())


@pytest.mark.parametrize("C", [8, 20])
def test_dequant_matmul_experts_on_a_ranks_shard(cuda, C):
    """An MoE layer's expert GEMMs on one rank of a model axis of 2, cut
    by ``dist.sharding.shard_tree`` from an expert-stacked packed 4-bit
    per-channel QuantizedTensor (8 experts of (384, 256); C slots an
    expert: 8 at a decode step, 20 on a prefill chunk): expert-parallel,
    each rank's 4 experts, one launch each, bf16 out; ffn-parallel, each
    rank's half of the in columns (``w_down``'s row shard) with fp32 out,
    and the two partials' sum against the whole product's plain version
    within 1e-4 of max |y|."""
    from repro_torch.dist.sharding import make_rules, shard_tree
    from repro_torch.quant import QuantizedTensor

    E, q, p = 8, 384, 256
    per = [_gemm(e + 31 * C, C, q, p, 1, cuda, torch.bfloat16) for e in range(E)]
    xs, codes, scale, zero = (torch.stack([t[i] for t in per]) for i in range(4))
    qt = QuantizedTensor(codes=pack_codes(codes, 4), scale=scale, zero=zero, bits=4, packed=True)
    whole = torch.stack([ref.dequant_matmul_ref(xs[e], codes[e], scale[e], zero[e],
                                                out_dtype=torch.float32) for e in range(E)])
    experts = {"codes": ("experts", None, None), "scale": ("experts", None, None),
               "zero": ("experts", None, None)}
    ffn = {"codes": (None, None, "expert_ffn"), "scale": (None, None, None),
           "zero": (None, None, None)}
    partials = []
    for rank in range(2):
        part = shard_tree({"w": qt}, {"w": experts}, make_rules({"model": 2}, n_experts=E),
                          rank=rank)["w"]
        assert part.codes.shape == (E // 2, q, p // 2)
        mine = slice(rank * E // 2, (rank + 1) * E // 2)
        before = ops.launch_counts()["dequant_matmul"]
        y = ops.dequant_matmul_experts(xs[mine].contiguous(), part.codes, part.scale, part.zero,
                                       packed4=True, out_dtype=torch.bfloat16)
        assert ops.launch_counts()["dequant_matmul"] == before + E // 2
        for e in range(E // 2):
            _dq_check(y[e], whole[mine][e], torch.bfloat16)
        part = shard_tree({"w": qt}, {"w": ffn}, make_rules({"model": 2}, moe_ff=p),
                          rank=rank)["w"]
        assert part.codes.shape == (E, q, p // 4) and part.scale.data_ptr() == scale.data_ptr()
        xr = xs[..., rank * p // 2 : (rank + 1) * p // 2].contiguous()
        before = ops.launch_counts()["dequant_matmul"]
        y = ops.dequant_matmul_experts(xr, part.codes, part.scale, part.zero, packed4=True,
                                       out_dtype=torch.float32)
        assert ops.launch_counts()["dequant_matmul"] == before + E and y.dtype == torch.float32
        unpacked = part.unpacked_codes()
        for e in range(E):
            _dq_check(y[e], ref.dequant_matmul_ref(xr[e], unpacked[e], scale[e], zero[e],
                                                   out_dtype=torch.float32), torch.float32)
        partials.append(y)
    total = partials[0] + partials[1]
    assert float((total - whole).abs().max()) <= 1e-4 * float(whole.abs().max())


@pytest.mark.parametrize("m,x_dtype,gsz,variant", [
    (8, torch.bfloat16, None, "tc_small"),
    (64, torch.bfloat16, 128, "tc_small"),
    (8, torch.bfloat16, 16, "tc_large"),
    (300, torch.bfloat16, None, "tc_large"),
    (8, torch.float32, None, "simt"),
    (300, torch.float32, 128, "simt"),
    (8, torch.bfloat16, 24, "simt"),
])
def test_dequant_matmul_variant_counters_as_planned(cuda, m, x_dtype, gsz, variant):
    """The wrapper launches the planned variant and counts it: fp32 x and a
    group size that is not a multiple of 16 go to simt."""
    from repro_torch.kernels import dequant_matmul as dq

    p = 384
    n_groups = 1 if gsz is None else -(-p // gsz)
    x, codes, scale, zero = _gemm(m + p, m, 96, p, n_groups, cuda, x_dtype)
    before = dict(dq.dequant_matmul_cuda.launches_by_variant)
    y = ops.dequant_matmul(x, pack_codes(codes, 4), scale, zero, packed4=True,
                           out_dtype=torch.float32, group_size=gsz)
    after = dq.dequant_matmul_cuda.launches_by_variant
    assert {v: after[v] - before[v] for v in after} == {v: int(v == variant) for v in after}
    y_ref = ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.float32, group_size=gsz)
    _dq_check(y, y_ref, torch.float32)


@pytest.mark.parametrize("variant,m", [("tc_small", 8), ("tc_small", 64), ("tc_large", 128)])
def test_dequant_matmul_split_k_repeat_is_bitwise(cuda, variant, m):
    """Split-K partials are summed in slice order without atomics: a repeat
    is bit-identical, and every split agrees with the unsplit sum."""
    from repro_torch.kernels import dequant_matmul as dq

    x, codes, scale, zero = _gemm(m, m, 200, 3072, 1, cuda, torch.bfloat16)
    kc = pack_codes(codes, 4)
    run = lambda split: dq.dequant_matmul_cuda(x, kc, scale, zero, packed4=True,
                                               out_dtype=torch.float32, plan=(variant, split))
    for split in (3, 24):
        a, b = run(split), run(split)
        assert torch.equal(a, b)
        torch.testing.assert_close(a, run(1), rtol=1e-6, atol=1e-4)


def test_dequant_matmul_refuses_a_variant_that_does_not_take_the_operands(cuda):
    """No fallback: a pinned variant that cannot take the operands raises."""
    from repro_torch.kernels import dequant_matmul as dq

    x, codes, scale, zero = _gemm(1, 8, 32, 384, 24, cuda, torch.bfloat16)
    with pytest.raises(RuntimeError):  # tc_small's super-step straddles groups of 16
        dq.dequant_matmul_cuda(x, codes, scale, zero, group_size=16, plan=("tc_small", 1))
    with pytest.raises(RuntimeError):  # the tensor-core variants take bf16 x only
        dq.dequant_matmul_cuda(x.float(), codes, scale, zero, group_size=16, plan=("tc_large", 1))
    with pytest.raises(RuntimeError):  # simt does not split k
        dq.dequant_matmul_cuda(x, codes, scale, zero, group_size=16, plan=("simt", 2))
    with pytest.raises(ValueError):
        dq.dequant_matmul_cuda(x, codes, scale, zero, group_size=16, plan=("wgmma", 1))


def test_wrappers_refuse_what_kernels_do_not_take(cuda):
    x, codes, scale, zero = _gemm(0, 8, 16, 64, 1, cuda, torch.float32)
    with pytest.raises(ValueError):
        ops.dequant_matmul(x.T, codes, scale, zero)  # not contiguous
    with pytest.raises(ValueError):
        ops.dequant_matmul(x.double(), codes, scale, zero)
    with pytest.raises(ValueError):
        ops.dequant_matmul(x, codes, scale, zero, packed4=True)  # codes cover 2p
    s = _state(0, 1, 40, 64, cuda)
    args = (s["base"], s["sig_t"], s["sig_t"], s["w"], s["scale"], s["zero"], s["delta"])
    with pytest.raises(ValueError):
        ops.quantease_fused_iteration(*args, n_levels=16, quantize=True, bsz=48)  # 48 ∤ 64
    dh = torch.zeros_like(s["base"])
    with pytest.raises(ValueError):
        ops.quantease_outlier_iteration(*args, dh, n_levels=16, quantize=True, bsz=48)  # 48 ∤ 64
    with pytest.raises(ValueError):
        ops.quantease_outlier_iteration(*args, dh[:, :, :20], n_levels=16, quantize=True, bsz=32)
    with pytest.raises(ValueError):
        strided = args[6].transpose(-1, -2).contiguous().transpose(-1, -2)  # same shape, not contiguous
        ops.quantease_outlier_iteration(*args[:6], strided, dh, n_levels=16, quantize=True, bsz=32)
    with pytest.raises(ValueError):
        ops.quantease_outlier_iteration(*args, dh.cpu(), n_levels=16, quantize=True, bsz=32)
    with pytest.raises(ValueError):
        ops.quantease_outlier_iteration(*args[:2], args[2].half(), *args[3:], dh, n_levels=16,
                                        quantize=True, bsz=32)
    from repro_torch.kernels import quantease_cd as qcd

    for plan in [(96, 1), (128, 0), (128, 5), (64, 2.0)]:  # 5 slices of 64 leave one empty
        with pytest.raises(ValueError):
            qcd.fused_iteration_cuda(*args, n_levels=16, quantize=True, bsz=32, plan=plan)
        with pytest.raises(ValueError):
            qcd.outlier_iteration_cuda(*args, dh, n_levels=16, quantize=True, bsz=32, plan=plan)
    with pytest.raises(ValueError):
        ops.quantease_block_sweep(s["base"][:, :32].double(), s["sig_t"][:, :32, :32],
                                  s["w"][:, :32], s["scale"][:, :32], s["zero"][:, :32],
                                  n_levels=16, quantize=True)
    blk = (s["base"][:, :32].contiguous(), s["sig_t"][:, :32, :32].contiguous(),
           s["w"][:, :32].contiguous(), s["scale"][:, :32].contiguous(), s["zero"][:, :32].contiguous())
    for sweep_plan in [(8, 32), (32, 32), (16, 16), (16, 32, 8), "16x32"]:
        with pytest.raises(ValueError):
            qcd.block_sweep_cuda(*blk, n_levels=16, quantize=True, sweep_plan=sweep_plan)
        with pytest.raises(ValueError):
            qcd.fused_iteration_cuda(*args, n_levels=16, quantize=True, bsz=32, sweep_plan=sweep_plan)
        with pytest.raises(ValueError):
            qcd.outlier_iteration_cuda(*args, dh, n_levels=16, quantize=True, bsz=32,
                                       sweep_plan=sweep_plan)


def test_slice_on_card_matches_cpu(cuda):
    """Reduced Phi-3 through PTQ (QuantEase, emit="qt") and perplexity: the
    kernel path on the card agrees with the plain path on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core import solver
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.eval.scorer import perplexity_on_stream
    from repro_torch.models import model as M
    from repro_torch.serve.qparams import quantize_params_for_serving

    cfg = dataclasses.replace(
        get_config("phi3_mini_3_8b"), d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=384, vocab=300, n_periods=2, dtype=torch.float32,
    )
    plan = M.make_plan(cfg)
    params_cpu = M.init_params(plan, 5, device="cpu")
    calib_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 64, split="calib")
    eval_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 64, split="eval")
    calib = [calib_fn(0), calib_fn(1)]
    pcfg = solver.PTQConfig(iterations=5, emit="qt")
    devices = (cuda, torch.device("cpu"))
    out = {}
    for dev in devices:
        params = M.tree_map(lambda a: a.to(dev), params_cpu)
        before = ops.launch_counts()
        q, rep = solver.ptq_quantize_model(plan, params, calib, pcfg, device=dev)
        served = quantize_params_for_serving(plan, params, q["dec"], device=dev)
        ppl = perplexity_on_stream(plan, served, eval_fn, n_batches=2, device=dev)["ppl"]
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        out[dev.type] = (rep, ppl, launched)
    (rk, pk, lk), (rp, pp, lp) = out["cuda"], out["cpu"]
    # QuantEase runs every kernel but the outlier-aware iteration (Algorithm 3's)
    # and paged attention (the serving engine's).
    assert all(n > 0 for k, n in lk.items()
               if k not in ("quantease_outlier_iteration", "paged_attention"))
    assert all(n == 0 for n in lp.values())
    assert list(rk) == list(rp)
    # The first period's linears see the same Σ up to fp32 rounding.
    for k in rp:
        if k.startswith("dec.p0."):
            assert rk[k] == pytest.approx(rp[k], rel=1e-3), k
    assert pk == pytest.approx(pp, rel=1e-3)

    # Period 1's inputs are period 0's quantized outputs, which differ between
    # the runs wherever a rounding tie in period 0 went the other way; so
    # period 1 is held on one set of inputs, the CPU's, on both devices.
    with torch.no_grad():
        xs = [M._embed_tokens(plan, params_cpu, M.as_tokens(b["tokens"], "cpu")) for b in calib]
        _, xs1 = solver._quantize_period(plan, M.period_slice(params_cpu["dec"], 0), 0, xs, pcfg, {})
        reps = {}
        for dev in devices:
            stack = M.tree_map(lambda a: a.to(dev), params_cpu["dec"])
            reps[dev.type] = {}
            solver._quantize_period(plan, M.period_slice(stack, 1), 1, [x.to(dev) for x in xs1],
                                    pcfg, reps[dev.type])
    assert list(reps["cuda"]) == [k for k in rp if k.startswith("dec.p1.")]
    for k, v in reps["cpu"].items():
        assert reps["cuda"][k] == pytest.approx(v, rel=1e-3), k


# Verified rounding ties of a QuantEase solve compared across two runs (here
# the card and the CPU; tests/test_torch_moe.py uses it for the two packages).
# Rows are independent in the CD, and each snapped value depends on every
# earlier one of its row, so a tie resolved the other way makes the rest of
# the row differ.  Where a row first parts (iteration it, column j; the runs
# agree on the columns before j in this iteration and on those after it in
# the previous one), the CD update's beta is recomputed in float64 and must
# lie within the fp32 rounding bound of a midpoint of the grid.

EPS32 = float(np.finfo(np.float32).eps)


def midpoint_gap(w_row, sigma, scale, zero, cur, prev, j, sig_rel=0.0, percdamp=0.01):
    """``(gap, tol)`` in grid steps for column ``j`` of one row: ``w_row``
    (p,) the original weights, ``sigma`` (p, p) the undamped Σ, ``scale``
    and ``zero`` the row's per-channel grid, ``cur`` the row after the
    iteration where it parts, ``prev`` before it.  ``sig_rel`` widens the
    bound by the measured relative difference of the two runs' Σ."""
    sig_d = damp_sigma(torch.as_tensor(np.asarray(sigma), dtype=torch.float64), percdamp).numpy()
    sig_norm = sig_d / np.diagonal(sig_d)[None, :]
    st = sig_norm[:, j].copy()
    st[j] -= 1.0
    pmat = float(np.asarray(w_row, np.float64) @ sig_norm[:, j])
    terms = np.concatenate([np.asarray(cur, np.float64)[:j] * st[:j],
                            np.asarray(prev, np.float64)[j + 1:] * st[j + 1:]])
    v = (pmat - terms.sum()) / scale + zero
    mag = abs(pmat) + np.abs(terms).sum()
    tol = (4 * len(st) * EPS32 + 2 * sig_rel) * mag / scale + 1e-6
    return abs(v - (np.floor(v) + 0.5)), tol


def _recording_solves(records):
    """Patch ``core.quantease`` so each ``quantease_quantize`` call appends
    ``(w3, Σ3, scale, zero, [Ŵ after each iteration])`` to ``records``."""
    import contextlib

    solve, step_of = qe.quantease_quantize, qe._iteration_step

    def quantize(w, sigma, spec, **kw):
        grid = kw.get("grid")
        records.append((w.detach().cpu(), sigma.detach().cpu(), grid.scale.cpu(), grid.zero.cpu(),
                        []))
        return solve(w, sigma, spec, **kw)

    def iteration_step(*a, **kw):
        step = step_of(*a, **kw)

        def recorded(*args, **kwargs):
            out = step(*args, **kwargs)
            records[-1][4].append((kwargs["quantize"], out[0].transpose(-1, -2).cpu()))
            return out
        return recorded

    @contextlib.contextmanager
    def patched():
        qe.quantease_quantize, qe._iteration_step = quantize, iteration_step
        try:
            yield
        finally:
            qe.quantease_quantize, qe._iteration_step = solve, step_of
    return patched()


def _verified_tie_rows(rec_card, rec_cpu, w, atol=1e-5):
    """The rows of weight matrix ``w`` (q, p) whose solves part between the
    card's and the CPU's records; each must start at a verified rounding
    tie (:func:`midpoint_gap`), its bound widened by the
    measured difference of the two runs' Σ."""
    def find(records):
        for i, (w3, *_rest) in enumerate(records):
            for g in range(w3.shape[0]):
                if torch.equal(w3[g, :, : w.shape[1]], w):
                    return i, g
        raise AssertionError("no recorded solve of this matrix")

    (ik, g), (ip, gp) = find(rec_card), find(rec_cpu)
    assert g == gp
    wk3, sk3, _, _, its_k = rec_card[ik]
    w3, s3, scale, zero, its_p = rec_cpu[ip]
    sig_rel = float((sk3[g] - s3[g]).abs().max() / s3[g].abs().max())
    rows = set()
    for r in range(w.shape[0]):
        parted = [i for i, ((qz, a), (_, b)) in enumerate(zip(its_k, its_p))
                  if not torch.allclose(a[g, r], b[g, r], rtol=0, atol=atol)]
        if not parted:
            continue
        it = parted[0]
        assert its_p[it][0], f"row {r} parts first in an unquantized iteration"
        p = w3.shape[-1]  # the iterates carry the engine's padded columns
        cur, other = its_p[it][1][g, r, :p], its_k[it][1][g, r, :p]
        prev = its_p[it - 1][1][g, r, :p] if it else w3[g, r]
        j = int(torch.nonzero((cur - other).abs() > atol)[0])
        gap, tol = midpoint_gap(w3[g, r].numpy(), s3[g].numpy(), float(scale[g, r, 0]),
                                float(zero[g, r, 0]), cur.numpy(), prev.numpy(), j, sig_rel)
        assert gap <= tol, (r, it, j, gap, tol)
        rows.add(r)
    return rows


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "opt_125m"])
def test_moe_and_opt_on_card_match_cpu(cuda, arch):
    """A reduced OLMoE (4 experts, top-2) and a reduced OPT (learned
    positions, LayerNorm, GELU, tied head) through PTQ (QuantEase, emit="qt")
    and perplexity on the card (kernels; the experts' GEMMs one kernel-3
    launch per expert) and on the CPU (plain versions).  In the first
    period each expert's and layer's Σ within 1e-5 relative (the same
    routing), its codes equal outside rows that start at a verified
    rounding tie (at most 1 % of rows), and its error within 1e-3 relative
    where the codes agree; the perplexity within 1e-3 relative."""
    from repro_torch.configs import get_config
    from repro_torch.core import solver
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.eval.scorer import perplexity_on_stream
    from repro_torch.models import model as M
    from repro_torch.serve.qparams import quantize_params_for_serving

    base = get_config(arch)
    cfg = dataclasses.replace(
        base, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=384, vocab=300,
        n_periods=2, max_seq=256, n_experts=4 if base.n_experts else 0,
        top_k=min(base.top_k, 2), moe_d_ff=256 if base.n_experts else 0, dtype=torch.float32,
    )
    plan = M.make_plan(cfg)
    params_cpu = M.init_params(plan, 5, device="cpu")
    calib_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 64, split="calib")
    eval_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 64, split="eval")
    calib = [calib_fn(0), calib_fn(1)]
    pcfg = solver.PTQConfig(iterations=5, emit="qt")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = M.tree_map(lambda a: a.to(dev), params_cpu)
        records = []
        with _recording_solves(records):
            q, rep = solver.ptq_quantize_model(plan, params, calib, pcfg, device=dev)
        served = quantize_params_for_serving(plan, params, q["dec"], device=dev)
        before = ops.launch_counts()["dequant_matmul"]
        ppl = perplexity_on_stream(plan, served, eval_fn, n_batches=2, device=dev)["ppl"]
        out[dev.type] = (rep, ppl, ops.launch_counts()["dequant_matmul"] - before, q, records)
    (rk, pk, nk, qk, reck), (rp, pp, np_, qp, recp) = out["cuda"], out["cpu"]
    assert nk > 0 and np_ == 0
    assert list(rk) == list(rp)
    if cfg.n_experts:
        assert sum(".e" in k for k in rp) == 2 * 3 * 4
    p0 = params_cpu["dec"]["b0"]
    keys = [k for k in rp if k.startswith("dec.p0.")]
    n_agree = n_rows = 0
    ties = []
    for k in keys:
        name = k.split("/")[1]
        leaf, e = name.split(".e") if ".e" in name else (name, None)
        w = p0[leaf][0] if e is None else p0[leaf][0, int(e)]
        w = w.reshape(w.shape[0], -1).T.contiguous()  # (q, p)
        ck, cp = (qd["dec"][0]["b0"][leaf].unpacked_codes().cpu() for qd in (qk, qp))
        if e is not None:
            ck, cp = ck[int(e)], cp[int(e)]
        n_rows += cp.shape[0]
        if torch.equal(ck, cp):
            assert rk[k] == pytest.approx(rp[k], rel=1e-3), k
            n_agree += 1
            continue
        differ = set(torch.nonzero((ck != cp).any(-1)).flatten().tolist())
        assert differ <= _verified_tie_rows(reck, recp, w), k
        ties += [(k, r) for r in differ]
    assert len(ties) <= max(1, 0.01 * n_rows) and n_agree >= len(keys) - 2, ties
    assert pk == pytest.approx(pp, rel=1e-3)


@pytest.mark.parametrize("method", ["qe_outlier", "qe_outlier_struct"])
def test_outlier_slice_on_card_matches_cpu(cuda, method):
    """Reduced Phi-3 through Algorithm 3 (3 bits, 2 % outliers, emit="qt"),
    the restack and perplexity: the kernel path on the card agrees with the
    plain path on the CPU within 1e-3 in period 0's errors and perplexity."""
    from repro_torch.configs import get_config
    from repro_torch.core import solver
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.eval.scorer import perplexity_on_stream
    from repro_torch.models import model as M
    from repro_torch.serve.qparams import quantize_params_for_serving

    cfg = dataclasses.replace(
        get_config("phi3_mini_3_8b"), d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=384, vocab=300, n_periods=2, dtype=torch.float32,
    )
    plan = M.make_plan(cfg)
    params_cpu = M.init_params(plan, 6, device="cpu")
    calib_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 64, split="calib")
    eval_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 64, split="eval")
    calib = [calib_fn(0), calib_fn(1)]
    pcfg = solver.PTQConfig(method=method, spec=GridSpec(bits=3), iterations=5, emit="qt",
                            outlier_frac=0.02)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = M.tree_map(lambda a: a.to(dev), params_cpu)
        before = ops.launch_counts()["quantease_outlier_iteration"]
        q, rep = solver.ptq_quantize_model(plan, params, calib, pcfg, device=dev)
        served = quantize_params_for_serving(plan, params, q["dec"], device=dev)
        assert served["dec"]["b0"]["wd"].outlier_idx.shape[0] == 2  # stacked over periods
        ppl = perplexity_on_stream(plan, served, eval_fn, n_batches=2, device=dev)["ppl"]
        out[dev.type] = (rep, ppl, ops.launch_counts()["quantease_outlier_iteration"] - before)
    (rk, pk, nk), (rp, pp, np_) = out["cuda"], out["cpu"]
    assert nk > 0 and np_ == 0
    assert list(rk) == list(rp)
    for k in rp:
        if k.startswith("dec.p0."):
            assert rk[k] == pytest.approx(rp[k], rel=1e-3), k
    assert pk == pytest.approx(pp, rel=1e-3)


# ---------------------------------------------------------------------------
# Kernel 5: paged decode attention
# ---------------------------------------------------------------------------


def _paged(seed, dev, *, kind, B=5, KVp=3, G=1, hd=96, psz=16, P=40, npg=6,
           q_dtype=torch.bfloat16, lengths=None):
    """Random pages of ``kind`` (bf16, int8, int4) and a page table whose
    entries past each sequence's last page point at the null page 0."""
    from repro_torch.quant import kv_pack_int4

    r = np.random.default_rng(seed)
    q = torch.from_numpy(r.standard_normal((B, KVp, G, hd)).astype(np.float32)).to(dev, q_dtype)
    shape = (P, psz, KVp, hd)
    ks = vs = None
    if kind == "bf16":
        kp = torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
        vp = torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dev, torch.bfloat16)
    else:
        lim = 127 if kind == "int8" else 7
        kp, vp = (torch.from_numpy(r.integers(-lim, lim + 1, shape).astype(np.int8)) for _ in range(2))
        if kind == "int4":
            kp, vp = kv_pack_int4(kp), kv_pack_int4(vp)
        kp, vp = kp.to(dev), vp.to(dev)
        ks, vs = (torch.from_numpy((r.random((P, psz, KVp, 1)) * 0.02 + 1e-3).astype(np.float32)).to(dev)
                  for _ in range(2))
    if lengths is None:
        lengths = r.integers(1, npg * psz + 1, B)
        lengths[: min(B, 3)] = [1, psz, npg * psz][: min(B, 3)]  # one token, one page, full table
    lengths = np.asarray(lengths)
    pt = r.permutation(np.arange(1, P))[: B * npg].reshape(B, npg)  # no page shared
    for b, n in enumerate(lengths):
        pt[b, -(-int(n) // psz):] = 0
    return dict(q=q, k_pages=kp, v_pages=vp,
                page_table=torch.from_numpy(pt.astype(np.int32)).to(dev),
                lengths=torch.from_numpy(lengths.astype(np.int32)).to(dev),
                k_scale_pages=ks, v_scale_pages=vs)


def _pa(fn, d, **kw):
    return fn(d["q"], d["k_pages"], d["v_pages"], d["page_table"], d["lengths"],
              k_scale_pages=d["k_scale_pages"], v_scale_pages=d["v_scale_pages"], **kw)


def _paged_plans(n_pgs):
    """The planner's plan (None), then pages per partition for one
    partition, two, and the most the table allows (one page each)."""
    return [None, n_pgs, -(-n_pgs // 2), 1]


@pytest.mark.parametrize("window,cap", [(None, None), (37, None), (None, 50.0), (20, 5.0)])
@pytest.mark.parametrize("G,hd", [(1, 96), (4, 128), (2, 16), (8, 256), (3, 40), (1, 6)])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_paged_attention(cuda, kind, G, hd, window, cap):
    """Kernel 5 against its plain version, bf16 q (atol 2e-2: the kernel keeps
    p in fp32, the plain version rounds it to bf16, as the TPU kernel and its
    oracle differ) and fp32 q (atol 1e-5: only the summation order differs),
    under the planner's plan and under one, two and six partitions of the
    six-page table; each call counts one launch whatever its plan.  Head
    dims 40 and 6 give rows that are not a multiple of 16 or of 4 bytes
    (4-byte and byte copies)."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    for q_dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        d = _paged(G * hd + len(kind), cuda, kind=kind, G=G, hd=hd, q_dtype=q_dtype)
        before = ops.launch_counts()["paged_attention"]
        out = _pa(ops.paged_attention, d, window=window, attn_softcap=cap)
        assert ops.launch_counts()["paged_attention"] == before + 1
        want = _pa(ref.paged_attention_ref, d, window=window, attn_softcap=cap)
        assert out.dtype == q_dtype and out.shape == d["q"].shape
        torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
        for plan in _paged_plans(d["page_table"].shape[1])[1:]:
            before = ops.launch_counts()["paged_attention"]
            out = _pa(paged_attention_cuda, d, window=window, attn_softcap=cap, plan=plan)
            assert ops.launch_counts()["paged_attention"] == before + 1
            torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol, msg=str(plan))


@pytest.mark.parametrize("kind", ["bf16", "int4"])
def test_paged_attention_hd160_gqa4(cuda, kind):
    """Kernel 5 at StableLM-2-12B's head shape (hd 160, G = 4; int4 pages
    of width 80) against its plain version, under each plan."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    d = _paged(160 + len(kind), cuda, kind=kind, KVp=2, G=4, hd=160)
    want = _pa(ref.paged_attention_ref, d)
    for plan in _paged_plans(d["page_table"].shape[1]):
        before = ops.launch_counts()["paged_attention"]
        out = _pa(paged_attention_cuda, d, plan=plan)
        assert ops.launch_counts()["paged_attention"] == before + 1
        torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=2e-2, msg=str(plan))


@pytest.mark.parametrize("window", [None, 21])
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_paged_attention_reads_no_masked_bytes(cuda, kind, window):
    """NaN in the null page, in the masked tail of each last page, (with a
    window) in every row before the window and (for quantized pages) in
    their scales: the kernel never loads them, so its output is finite and
    equals the plain version on clean pages, under every plan.  Partitions
    are whole pages, so the nearest a partition boundary comes to the last
    page's valid rows is the one-page plan, whose last partition holds only
    them and the poisoned tail; a window of 21 starts its first partition
    inside a page."""
    d = _paged(3, cuda, kind=kind, lengths=[1, 16, 37, 70, 96], npg=6)
    want = _pa(ref.paged_attention_ref, d, window=window)
    poisoned = dict(d)
    psz = d["k_pages"].shape[1]
    nan_plane = "k_pages" if kind == "bf16" else "k_scale_pages"
    for name in ({nan_plane, nan_plane.replace("k_", "v_")}):
        t = d[name].clone()
        t[0] = float("nan")
        for b, n in enumerate(d["lengths"].tolist()):
            if n % psz:
                t[int(d["page_table"][b, (n - 1) // psz]), n % psz:] = float("nan")
            for pos in range(max(0, n - window) if window else 0):
                t[int(d["page_table"][b, pos // psz]), pos % psz] = float("nan")
        poisoned[name] = t
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    for plan in _paged_plans(6):
        out = _pa(paged_attention_cuda, poisoned, window=window, plan=plan)
        assert torch.isfinite(out.float()).all(), plan
        torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=2e-2, msg=str(plan))


def test_paged_attention_is_deterministic(cuda):
    """The same output from run to run under every plan: no atomics in any
    sum, and the combine adds a sequence's partitions in ascending order."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    d = _paged(4, cuda, kind="bf16", B=8, KVp=32, npg=96, P=800)
    a, b = _pa(ops.paged_attention, d), _pa(ops.paged_attention, d)
    assert torch.equal(a, b)
    for plan in _paged_plans(96)[1:]:
        a, b = _pa(paged_attention_cuda, d, plan=plan), _pa(paged_attention_cuda, d, plan=plan)
        assert torch.equal(a, b), plan


def test_paged_attention_launches_one_kernel_per_partition_plan(cuda):
    """A one-partition plan launches the split kernel alone; a split plan
    launches it and the combine, one call each (the profiler's count).  The
    call always launches a kernel, so a trace with no device event at all is
    the profiler losing its trace (seen once on the H100): it is taken again,
    three times at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.paged_attention import paged_attention_cuda

    d = _paged(8, cuda, kind="int8")
    for plan, want in ((6, ["paged_attention_kernel"]),
                       (2, ["paged_attention_kernel", "paged_attention_combine_kernel"])):
        _pa(paged_attention_cuda, d, plan=plan)  # built and warm
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _pa(paged_attention_cuda, d, plan=plan)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
            if names:
                break
        ours = sorted(k for n in names for k in ("paged_attention_kernel", "paged_attention_combine_kernel")
                      if k in n)
        assert ours == sorted(want), (plan, names)


def test_paged_attention_refuses_what_it_does_not_take(cuda):
    d = _paged(5, cuda, kind="int8")
    args = [d[k] for k in ("q", "k_pages", "v_pages", "page_table", "lengths")]
    scales = dict(k_scale_pages=d["k_scale_pages"], v_scale_pages=d["v_scale_pages"])
    with pytest.raises(ValueError):
        ops.paged_attention(*args)  # int8 pages without scale planes
    with pytest.raises(ValueError):
        ops.paged_attention(*args, k_scale_pages=d["k_scale_pages"])  # one plane
    with pytest.raises(ValueError):
        ops.paged_attention(args[0].half(), *args[1:], **scales)  # fp16 q
    with pytest.raises(ValueError):
        ops.paged_attention(*args[:3], args[3].long(), args[4], **scales)  # int64 table
    with pytest.raises(ValueError):
        ops.paged_attention(*args[:4], args[4].cpu(), **scales)  # another device
    with pytest.raises(ValueError):
        ops.paged_attention(args[0], args[1].float(), args[2].float(), *args[3:], **scales)
    with pytest.raises(ValueError):
        ops.paged_attention(args[0], args[1][..., :48], args[2][..., :48], *args[3:], **scales)
    big_g = _paged(6, cuda, kind="bf16", G=9, hd=16)
    with pytest.raises(ValueError):
        _pa(ops.paged_attention, big_g)
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    for plan in [0, 257, -1, 6.0, True, "6", (6,), (6, 1), [3]]:
        with pytest.raises(ValueError):
            paged_attention_cuda(*args, **scales, plan=plan)


def test_paged_engine_on_card_matches_cpu(cuda):
    """A reduced fp32 Phi-3 served by the paged engine (bf16 and int4 KV) on
    the card and on the CPU: the first-decode logits agree within 1e-3 of
    their max |logit| (cuBLAS and the CPU's GEMMs round differently, which
    can flip a bf16 cache entry), kernel 5 runs once per decode step and
    period on the card and never on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServingEngine, Request

    cfg = dataclasses.replace(
        get_config("phi3_mini_3_8b"), d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=300, n_periods=2, dtype=torch.float32,
    )
    r = np.random.default_rng(7)
    prompts = [r.integers(0, 300, n).astype(np.int32) for n in (5, 40, 17, 64, 23)]
    for kv in ("bf16", "int4"):
        plan = M.make_plan(cfg, kv_cache_dtype=kv)
        params_cpu = M.init_params(plan, 3, device="cpu")
        out = {}
        for dev in (cuda, torch.device("cpu")):
            params = M.tree_map(lambda a: a.to(dev), params_cpu)
            eng = PagedServingEngine(plan, params, max_batch=3, max_seq=128, page_size=16,
                                     prefill_chunk=32, record_logits=True, device=dev)
            for i, p in enumerate(prompts):
                eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
            before = ops.launch_counts()["paged_attention"]
            eng.run()
            launched = ops.launch_counts()["paged_attention"] - before
            out[dev.type] = ({i: t[0] for i, t in eng.logit_trace.items()}, launched,
                             eng.n_decode_steps)
        (lk, nk, sk), (lp, np_, _) = out["cuda"], out["cpu"]
        assert nk == sk * cfg.n_periods and np_ == 0
        for i in lp:
            scale = float(np.abs(lp[i]).max())
            np.testing.assert_allclose(lk[i], lp[i], rtol=0, atol=1e-3 * scale)


# ---------------------------------------------------------------------------
# The quality path: GPTQ, a train step and eval_model, card against CPU
# ---------------------------------------------------------------------------


def _gptq_recording(w, sigma, spec):
    """GPTQ, recording each column's pre-rounding value w/s (on the CPU)."""
    from repro_torch.core import gptq

    seen, orig = [], gptq._quant_dequant_cols

    def record(wc, scale, zero, n_levels):
        seen.append((wc / scale).cpu())
        return orig(wc, scale, zero, n_levels)

    gptq._quant_dequant_cols = record
    try:
        out = gptq.gptq_quantize(w, sigma, spec)
    finally:
        gptq._quant_dequant_cols = orig
    return out, torch.stack(seen, -1)


@pytest.mark.parametrize("G,q,p,bits", [(1, 96, 128, 3), (3, 64, 200, 4), (2, 256, 384, 4)])
def test_gptq_on_card_matches_cpu(cuda, G, q, p, bits):
    """GPTQ on the card (cuSOLVER inverse, cuBLAS lazy batch) against the CPU:
    codes equal except in rows whose first differing column starts at a
    rounding tie (the CPU's pre-rounding w/s within max(1e-5, p·κ·ε) of a
    midpoint, the fp32 bound of inverting the damped Σ of condition κ);
    values within 1e-4 of max |W| in the other rows."""
    import math

    from repro_torch.core.calib import damp_sigma
    from repro_torch.quant import quantize_codes

    r = np.random.default_rng(G * q + p)
    x = r.standard_normal((G, p, 2 * p)).astype(np.float32)
    w = torch.from_numpy(r.standard_normal((G, q, p)).astype(np.float32))
    sigma = torch.from_numpy(x @ x.transpose(0, 2, 1))
    spec = GridSpec(bits=bits)
    wk, _ = _gptq_recording(w.to(cuda), sigma.to(cuda), spec)
    wp, pre = _gptq_recording(w, sigma, spec)
    grid = compute_grid(w, spec)
    ck, cp = quantize_codes(wk.cpu(), grid), quantize_codes(wp, grid)
    kappa = torch.linalg.cond(damp_sigma(sigma, 0.01).double())
    eps = torch.finfo(torch.float32).eps
    ok = torch.ones(G, q, dtype=torch.bool)
    for g, row in (ck != cp).any(-1).nonzero().tolist():
        j = int((ck[g, row] != cp[g, row]).nonzero()[0])
        v = float(pre[g, row, j])
        tol = max(1e-5, p * float(kappa[g]) * eps)
        assert abs(v - (math.floor(v) + 0.5)) <= tol * max(1.0, abs(v)), (g, row, j, v, tol)
        ok[g, row] = False
    assert float(ok.float().mean()) >= 0.95
    torch.testing.assert_close(wk.cpu()[ok], wp[ok], rtol=0, atol=1e-4 * float(w.abs().max()))


def test_train_step_on_card_matches_cpu(cuda):
    """One train step (2 microbatches, fp32 AdamW) of a reduced fp32
    bench_opt_s: loss and gradient norm within 1e-3 relative, the stepped
    params within 1e-3 relative (atol 2 % of lr: Adam moves an entry whose
    |g| is near fp32 noise by a fraction of lr that the noise decides)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("bench_opt_s"), n_periods=2, dtype=torch.float32)
    plan = M.make_plan(cfg)
    params_cpu = M.init_params(plan, 3, device="cpu")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, (4, 64)).astype(np.int32)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    step = make_train_step(plan, opt, 2)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = M.tree_map(lambda a: a.to(dev), params_cpu)
        new, _, metrics = step(params, adamw_init(params, opt), {"tokens": tokens})
        out[dev.type] = (new, metrics)
    (nk, mk), (np_, mp) = out["cuda"], out["cpu"]
    assert float(mk["loss"]) == pytest.approx(float(mp["loss"]), rel=1e-3)
    assert float(mk["grad_norm"]) == pytest.approx(float(mp["grad_norm"]), rel=1e-3)
    for a, b in zip(tree_leaves(nk), tree_leaves(np_)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=0.02 * opt.lr)


def test_eval_model_on_card_matches_cpu(cuda):
    """eval_model (smoke budget) of a reduced fp32 bench_opt_s's RTN 4-bit
    serving artifact, on the card (the dequant-GEMM) and on the CPU: every
    metric within 1e-3 relative."""
    from repro_torch.configs import get_config
    from repro_torch.core import solver
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.eval.harness import EvalBudget, eval_model
    from repro_torch.models import model as M
    from repro_torch.serve.qparams import quantize_params_for_serving

    cfg = dataclasses.replace(get_config("bench_opt_s"), n_periods=2, dtype=torch.float32)
    plan = M.make_plan(cfg)
    params_cpu = M.init_params(plan, 6, device="cpu")
    calib_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 48, split="calib")
    eval_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 48, split="eval")
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = M.tree_map(lambda a: a.to(dev), params_cpu)
        q, _ = solver.ptq_quantize_model(plan, params, [calib_fn(0)],
                                         solver.PTQConfig(method="rtn", emit="qt"), device=dev)
        served = quantize_params_for_serving(plan, params, q["dec"], device=dev)
        before = ops.launch_counts()["dequant_matmul"]
        out[dev.type] = eval_model(plan, served, eval_fn, budget=EvalBudget.smoke(), device=dev)
        out[dev.type + "_launches"] = ops.launch_counts()["dequant_matmul"] - before
    assert out["cuda_launches"] > 0 and out["cpu_launches"] == 0
    for k, v in out["cpu"].items():
        assert out["cuda"][k] == pytest.approx(v, rel=1e-3), k


@pytest.mark.parametrize("G,q,p,bsz", [(1, 96, 128, 32), (2, 70, 200, 64)])
def test_legacy_engine_on_card_matches_cpu(cuda, G, q, p, bsz):
    """QuantEase's legacy schedule: kernel 1 launched once per column block
    and iteration (fp32 ``torch.matmul`` corrections between), iterates
    within ATOL of the CPU's in at least 99 % of rows (a rounding tie flips
    the rest of its row); the outlier engine's legacy schedule within 1 %
    of the CPU's error."""
    r = np.random.default_rng(G * q + p)
    x = r.standard_normal((G, p, 2 * p)).astype(np.float32)
    w = torch.from_numpy(r.standard_normal((G, q, p)).astype(np.float32))
    sigma = torch.from_numpy(x @ x.transpose(0, 2, 1))
    kw = dict(iterations=4, block_size=bsz, engine="legacy")
    before = ops.launch_counts()["quantease_block_sweep"]
    wk, _ = qe.quantease_quantize(w.to(cuda), sigma.to(cuda), GridSpec(bits=3), **kw)
    launches = ops.launch_counts()["quantease_block_sweep"] - before
    wp, _ = qe.quantease_quantize(w, sigma, GridSpec(bits=3), **kw)
    assert launches == 4 * -(-p // bsz)
    assert _rows_ok(wk.cpu().transpose(-1, -2), wp.transpose(-1, -2)) >= 0.99

    from repro_torch.core.outlier import outlier_quantease

    s = max(int(0.01 * q * p), 1)
    ok = outlier_quantease(w.to(cuda), sigma.to(cuda), GridSpec(bits=3), s=s, iterations=4,
                           engine="legacy")
    op = outlier_quantease(w, sigma, GridSpec(bits=3), s=s, iterations=4, engine="legacy")
    ek = qe.relative_error(w, ok.w_eff.cpu(), sigma)
    ep = qe.relative_error(w, op.w_eff, sigma)
    torch.testing.assert_close(ek, ep, rtol=1e-2, atol=0)


@pytest.mark.parametrize("method", ["awq", "awq_qe", "spqr"])
def test_baselines_on_card_match_cpu(cuda, method):
    """AWQ, AWQ+QuantEase and SpQR on the card against the CPU, one layer:
    relative error within 1e-3 relative (α, the outlier mask and the sweeps
    may part only at rounding ties), every value of Ŵ finite."""
    from repro_torch.core import awq, spqr

    r = np.random.default_rng(7)
    x = r.standard_normal((128, 512)).astype(np.float32) * (r.random(128)[:, None] * 3 + 0.2)
    w = torch.from_numpy(r.standard_normal((96, 128)).astype(np.float32))
    sigma = torch.from_numpy(x @ x.T)
    spec = GridSpec(bits=3)
    run = {
        "awq": lambda a, b: awq.awq_quantize(a, b, spec),
        "awq_qe": lambda a, b: awq.awq_then_quantease(a, b, spec, iterations=6),
        "spqr": lambda a, b: spqr.spqr_quantize(a, b, spec, s=120)[0],
    }[method]
    before = ops.launch_counts()["quantease_fused_iteration"]
    wk = run(w.to(cuda), sigma.to(cuda)).cpu()
    if method == "awq_qe":
        assert ops.launch_counts()["quantease_fused_iteration"] > before
    wp = run(w, sigma)
    assert bool(torch.isfinite(wk).all())
    ek, ep = qe.relative_error(w, wk, sigma), qe.relative_error(w, wp, sigma)
    torch.testing.assert_close(ek, ep, rtol=1e-3, atol=0)


def test_kernel_dispatch_deny_on_the_card_raises_uncounted(cuda):
    """Under a plan, ``deny`` at kernel.dispatch on card tensors raises
    :class:`ops.DispatchDenied` (the port has no plain path on the card)
    without a launch, and the trail records it; the next call launches
    the kernel."""
    from repro_torch.faults import FaultPlan, FaultSpec, fault_plan

    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((8, 256)).astype(np.float32)).to(cuda, torch.bfloat16)
    codes = torch.from_numpy(r.integers(0, 16, (64, 256)).astype(np.uint8)).to(cuda)
    scale = torch.full((64, 1), 0.01, device=cuda)
    zero = torch.full((64, 1), 8.0, device=cuda)
    plan = FaultPlan([FaultSpec(site="kernel.dispatch", kind="deny", at=(0,))])
    before = ops.launch_counts()["dequant_matmul"]
    with fault_plan(plan):
        with pytest.raises(ops.DispatchDenied):
            ops.dequant_matmul(x, codes, scale, zero, out_dtype=torch.float32)
        assert ops.launch_counts()["dequant_matmul"] == before
        launched = ops.dequant_matmul(x, codes, scale, zero, out_dtype=torch.float32)
    assert ops.launch_counts()["dequant_matmul"] == before + 1
    assert plan.fired == [("kernel.dispatch", 0, "deny")]
    plain = ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.float32)
    torch.testing.assert_close(launched, plain, rtol=1e-2, atol=1e-2 * float(plain.abs().max()))


def test_kernel_dispatch_deny_on_expert_gemms_raises(cuda):
    """The MoE expert GEMMs pass the same fault site: a ``deny`` at the
    third expert raises :class:`ops.DispatchDenied` after the first two
    experts' launches, and no launch of its own."""
    from repro_torch.faults import FaultPlan, FaultSpec, fault_plan

    r = np.random.default_rng(0)
    E = 4
    xs = torch.from_numpy(r.standard_normal((E, 8, 256)).astype(np.float32)).to(cuda, torch.bfloat16)
    codes = torch.from_numpy(r.integers(0, 16, (E, 64, 256)).astype(np.uint8)).to(cuda)
    scale = torch.full((E, 64, 1), 0.01, device=cuda)
    zero = torch.full((E, 64, 1), 8.0, device=cuda)
    plan = FaultPlan([FaultSpec(site="kernel.dispatch", kind="deny", at=(2,))])
    before = ops.launch_counts()["dequant_matmul"]
    with fault_plan(plan):
        with pytest.raises(ops.DispatchDenied):
            ops.dequant_matmul_experts(xs, codes, scale, zero, out_dtype=torch.float32)
    assert ops.launch_counts()["dequant_matmul"] == before + 2
    assert plan.fired == [("kernel.dispatch", 2, "deny")]


def test_quantize_and_serve_clis_on_card(cuda, tmp_path, capsys):
    """``launch.train``, ``launch.quantize`` and ``launch.serve`` with
    ``--device cuda`` on the reduced Phi-3 (bf16): the quantize report is
    14 finite layers and runs the CD kernels, and every request completes
    with --max-new tokens on both engines, the paged one through kernel 5."""
    from repro_torch.launch import quantize, serve, train

    arch = ("--arch", "phi3_mini_3_8b", "--reduce")
    train.main([*arch, "--steps", "2", "--batch", "2", "--seq", "32",
                "--ckpt-dir", str(tmp_path / "t"), "--device", "cuda"])
    before = ops.launch_counts()
    out = quantize.main([*arch, "--ckpt-dir", str(tmp_path / "t"), "--out-dir", str(tmp_path / "q"),
                         "--method", "awq_qe", "--bits", "4", "--iterations", "3",
                         "--calib-batches", "2", "--seq", "32", "--device", "cuda"])
    assert out["layers"] == 14 and np.isfinite(out["mean_rel_error"])
    assert ops.launch_counts()["quantease_fused_iteration"] > before["quantease_fused_iteration"]
    for engine in ("paged", "contiguous"):
        k5 = ops.launch_counts()["paged_attention"]
        res = serve.main([*arch, "--ckpt-dir", str(tmp_path / "q"), "--requests", "3",
                          "--max-new", "5", "--engine", engine, "--device", "cuda"])
        assert all(r.status == "completed" and len(r.output) == 5 for r in res["requests"])
        launched = ops.launch_counts()["paged_attention"] - k5
        assert launched == (res["n_decode_steps"] * 2 if engine == "paged" else 0)


# ---------------------------------------------------------------------------
# Speculative serving and mixed-bits stacks on the card
# ---------------------------------------------------------------------------


def _spec_model(dev, bits=4):
    """A small bf16 Phi-3 quantized to ``bits`` by round-to-nearest (the
    serving layout), on ``dev``, with its dense params."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.qparams import rtn_quantize_for_serving

    cfg = dataclasses.replace(get_config("phi3_mini_3_8b"), d_model=128, n_heads=4, n_kv_heads=4,
                              head_dim=32, d_ff=256, vocab=300, n_periods=2)
    plan = M.make_plan(cfg)
    dense = M.tree_map(lambda a: a.to(dev), M.init_params(plan, 5, device="cpu"))
    return plan, rtn_quantize_for_serving(plan, dense, bits=bits)[0], dense


def _top2_margin(l):
    top2 = np.sort(l)[-2:]
    return top2[1] - top2[0]


def test_verify_matches_sequential_decode_on_card(cuda):
    """``paged_verify_tokens`` over 8 lanes x 5 positions (m = 40: the
    dequant-GEMM runs tc_small only) against 5 ``paged_decode_step`` calls
    on a copy of the cache: logits within 2e-2 of max |logit| (the card's
    kernels are not batch-invariant: kernel 5's plan and cuBLAS's head
    product depend on the lane count), argmaxes equal wherever the top-2
    margin exceeds that."""
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.models import model as M

    plan, params, _ = _spec_model(cuda)
    r = np.random.default_rng(11)
    B, L, psz = 8, 5, 16
    prompts = [r.integers(0, 300, n).astype(np.int32) for n in r.integers(5, 60, B)]
    n_pg = [-(-(len(p) + L) // psz) for p in prompts]
    table = np.zeros((B, max(n_pg)), np.int32)
    start = 1
    for b, n in enumerate(n_pg):
        table[b, :n] = np.arange(start, start + n)
        start += n
    cache = M.init_paged_cache(plan, start, psz, device=cuda)
    dt = torch.as_tensor(table, device=cuda)
    for b, p in enumerate(prompts):
        buf = np.zeros((1, 64), np.int32)
        buf[0, : len(p)] = p
        M.paged_prefill_chunk(plan, params, buf, cache, dt[b : b + 1], 0)
    pos0 = np.array([len(p) - 1 for p in prompts])
    wp = np.array([[table[b, (pos0[b] + j) // psz] for j in range(L)] for b in range(B)])
    toks = np.concatenate([[[p[-1]] for p in prompts], r.integers(0, 300, (B, L - 1))], 1)
    copy = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
    before = dict(dequant_matmul_cuda.launches_by_variant)
    got, _ = M.paged_verify_tokens(plan, params, toks, cache, pos0, dt, wp)
    took = {v: n - before[v] for v, n in dequant_matmul_cuda.launches_by_variant.items()}
    assert took["tc_small"] == 7 * plan.cfg.n_periods and took["tc_large"] == took["simt"] == 0
    got = got.float().cpu().numpy()
    for j in range(L):
        lg, _ = M.paged_decode_step(plan, params, toks[:, j : j + 1], copy, pos0 + j, dt, wp[:, j])
        lg = lg.float().cpu().numpy()
        for b in range(B):
            tol = 2e-2 * float(np.abs(lg[b]).max())
            np.testing.assert_allclose(got[b, j], lg[b], rtol=0, atol=tol)
            if _top2_margin(lg[b]) > tol:
                assert int(np.argmax(got[b, j])) == int(np.argmax(lg[b]))


def test_hoisting_card_params_raises(cuda):
    """A hoisted torch.matmul on the card would stand in for kernel 3: the
    explicit flag raises, and the default keeps the QuantizedTensors."""
    from repro_torch.serve import PagedServingEngine
    from repro_torch.serve.spec import SpecConfig, maybe_hoist

    plan, params, _ = _spec_model(cuda)
    with pytest.raises(ValueError, match="hoist_dequant=True with params on the card"):
        maybe_hoist(params, True)
    assert maybe_hoist(params, None) is params
    with pytest.raises(ValueError, match="hoist_dequant=True"):
        PagedServingEngine(plan, params, spec=SpecConfig(plan, params, hoist_dequant=True),
                           device=cuda)


@pytest.mark.parametrize("draft", ["self", "rtn3", "truncated"])
def test_spec_engine_on_card_matches_plain(cuda, draft):
    """The speculative paged engine on the card against the plain one: the
    streams agree up to the first step whose top-2 margin (plain run) is
    below 2e-2 of max |logit|, drafts were proposed, every page returns to
    the pool, and kernel 5 runs (verify rounds + propose steps) x periods."""
    from repro_torch.serve import PagedServingEngine, Request
    from repro_torch.serve.qparams import rtn_quantize_for_serving
    from repro_torch.serve.spec import SpecConfig, truncate_draft

    plan, params, dense = _spec_model(cuda)
    if draft == "self":
        spec = SpecConfig(plan, params, gamma=3)
    elif draft == "rtn3":
        spec = SpecConfig(plan, rtn_quantize_for_serving(plan, dense, bits=3)[0], gamma=3)
    else:
        spec = SpecConfig(*truncate_draft(plan, params, 1), gamma=3)
    r = np.random.default_rng(12)
    prompts = [r.integers(0, 300, n).astype(np.int32) for n in (5, 40, 17, 64, 23)]
    runs = {}
    for sp in (None, spec):
        eng = PagedServingEngine(plan, params, max_batch=3, max_seq=128, page_size=16,
                                 prefill_chunk=32, n_pages=1 + 2 * 3 * 8, spec=sp,
                                 record_logits=True, device=cuda)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=9))
        k5 = ops.launch_counts()["paged_attention"]
        fin = {q.rid: q for q in eng.run()}
        k5 = ops.launch_counts()["paged_attention"] - k5
        want = eng.n_decode_steps * plan.cfg.n_periods
        if sp is not None:
            want += eng.spec_mgr.n_propose_calls * 4 * sp.draft_plan.cfg.n_periods
            assert eng.n_draft_tokens > 0
            assert all(len(q.output) == q.n_draft_accepted + q.n_spec_rounds for q in fin.values())
        assert k5 == want and eng.pool.n_free == eng.n_pages - 1
        runs[sp is None] = (fin, eng.logit_trace)
    (plain, trace), (spec_fin, _) = runs[True], runs[False]
    for rid, q in plain.items():
        for j, l in enumerate(trace[rid]):
            if _top2_margin(l) < 2e-2 * float(np.abs(l).max()):
                break
            assert spec_fin[rid].output[j] == q.output[j], (rid, j)


def test_harmonized_mixed_stack_through_kernel3(cuda):
    """A 2/4/8-bit stack (4 packed, one period with COO outliers) harmonized
    to uint8 codes: each period's dequant-GEMM on the card (bf16 x at m = 8
    and 40 on tc_small, 128 on tc_large; fp32 x on simt) against its plain
    version, and the COO pad entries leave the product unchanged."""
    from repro_torch.models.common import apply_linear
    from repro_torch.quant import GridSpec, quantize_tensor
    from repro_torch.serve.qparams import harmonize_qt_stack

    r = np.random.default_rng(13)
    q, p = 192, 256
    leaves = []
    for bits in (2, 4, 8):
        qt = quantize_tensor(torch.from_numpy(r.standard_normal((q, p)).astype(np.float32)),
                             GridSpec(bits=bits))
        if bits == 4:
            qt = dataclasses.replace(qt, codes=pack_codes(qt.codes, 4), packed=True)
        if bits == 2:
            idx = np.sort(r.choice(q * p, 40, replace=False)).astype(np.int32)
            qt = dataclasses.replace(qt, outlier_idx=torch.from_numpy(idx), outlier_values=torch.from_numpy(
                r.standard_normal(40).astype(np.float16)))
        leaves.append(qt)
    out = harmonize_qt_stack(leaves)
    assert {(l.bits, l.packed) for l in out} == {(8, False)}
    for l in out:
        l = l.map_arrays(lambda t: t.to(cuda))
        for m, dt in ((8, torch.bfloat16), (40, torch.bfloat16), (128, torch.bfloat16),
                      (8, torch.float32)):
            x = torch.from_numpy(r.standard_normal((m, p)).astype(np.float32)).to(cuda, dt)
            got = ops.dequant_matmul(x, l.codes, l.scale, l.zero, out_dtype=torch.float32)
            want = ref.dequant_matmul_ref(x, l.codes, l.scale, l.zero, out_dtype=torch.float32)
            tol = (1e-2 if dt == torch.bfloat16 else 1e-4) * float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=tol)
            y = apply_linear(l, x)
            assert y.shape == (m, q) and bool(torch.isfinite(y.float()).all())


# ---------------------------------------------------------------------------
# Mamba-2 and Jamba: PTQ, eval and the contiguous engine, card against CPU
# ---------------------------------------------------------------------------

SIG_AGREE = 1e-5  # one solve's Σ, card against CPU, relative to max |Σ|
SIG_DRIFT = 1e-4  # the same after two quantized encoder periods (Whisper)


def _solver_matrix(w, name):
    """A dense leaf of one period → the solver's (q, p) matrix; ``wo`` and
    ``wo_c`` (KVp, Gp, hd, d) and ``out_proj`` (nh, hd, d) take their input
    over their leading axes."""
    return (w.reshape(-1, w.shape[-1]) if name in ("wo", "wo_c", "out_proj")
            else w.reshape(w.shape[0], -1)).T


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "jamba_1_5_large"])
def test_ssm_archs_on_card_match_cpu(cuda, arch):
    """A reduced fp32 Mamba-2 (2 layers) and Jamba (one period: attention,
    Mamba and MoE blocks) through QuantEase PTQ (``emit="qt"``) on the card
    (kernels 1, 2 and 3) and on the CPU (plain versions).  Every layer whose
    solve saw the same Σ (within 1e-5 relative) has its codes equal
    outside rows that start at a verified rounding tie and its error within
    1e-3 relative where they agree; a solve's Σ may part only downstream of
    such a tie and an MoE router (a token crosses a top-k boundary).  The
    CPU's artifact then scores on the card and on the CPU (perplexity
    within 1e-3 relative, kernel 3 launched on the card only) and serves
    three requests on the contiguous engine (first-decode logits within
    1e-3 of max |logit|, kernel 3 launched at every decode step)."""
    from repro_torch.configs import get_config
    from repro_torch.core import solver
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.eval.scorer import perplexity_on_stream
    from repro_torch.models import model as M
    from repro_torch.quant import QuantizedTensor
    from repro_torch.serve import Request, ServingEngine
    from repro_torch.serve.qparams import quantize_params_for_serving

    base = get_config(arch)
    cfg = dataclasses.replace(
        base, d_model=128, n_heads=4 if base.n_heads else 0, n_kv_heads=2 if base.n_heads else 0,
        head_dim=32, d_ff=256 if base.d_ff else 0, vocab=300,
        n_periods=1 if base.n_experts else 2, n_experts=4 if base.n_experts else 0,
        top_k=min(base.top_k, 2), moe_d_ff=256 if base.n_experts else 0, ssm_state=16,
        ssm_headdim=16, dtype=torch.float32,
    )
    plan = M.make_plan(cfg)
    params_cpu = M.init_params(plan, 5, device="cpu")
    calib_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 64, split="calib")
    eval_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 64, split="eval")
    calib = [calib_fn(0), calib_fn(1)]
    pcfg = solver.PTQConfig(iterations=5, emit="qt")
    out = []  # the card's run, then the CPU's
    for dev in (cuda, torch.device("cpu")):
        params = M.tree_map(lambda a: a.to(dev), params_cpu)
        records = []
        with _recording_solves(records):
            q, rep = solver.ptq_quantize_model(plan, params, calib, pcfg, device=dev)
        out.append((rep, q, records))
    (rk, qk, reck), (rp, qp, recp) = out
    assert list(rk) == list(rp) and not any(k.endswith("/wdt") for k in rp)

    def sig_rel(records_k, records_p, w):
        for (wk3, sk3, *_), (wp3, sp3, *_) in zip(records_k, records_p):
            for g in range(wp3.shape[0]):
                if torch.equal(wp3[g, :, : w.shape[1]], w):
                    return float((sk3[g] - sp3[g]).abs().max() / sp3[g].abs().max())
        raise AssertionError("no recorded solve of this matrix")

    ties, n_rows, parted, moe_seen = [], 0, [], False
    for period in range(cfg.n_periods):
        for bi, b in enumerate(cfg.pattern):
            scope = f"dec.p{period}.b{bi}"
            dense = params_cpu["dec"][f"b{bi}"]
            for k in [k for k in rp if k.startswith(scope + "/")]:
                leaf, e = k.split("/")[1].split(".e") if ".e" in k else (k.split("/")[1], None)
                w = dense[leaf][period] if e is None else dense[leaf][period, int(e)]
                w = _solver_matrix(w, leaf).contiguous()
                ck, cp = (qd["dec"][period][f"b{bi}"][leaf].unpacked_codes().cpu() for qd in (qk, qp))
                if e is not None:
                    ck, cp = ck[int(e)], cp[int(e)]
                n_rows += cp.shape[0]
                if sig_rel(reck, recp, w) > SIG_AGREE:
                    assert ties and moe_seen, (k, "Σ parted without a tie and a router before it")
                    parted.append(k)
                    continue
                if torch.equal(ck, cp):
                    assert rk[k] == pytest.approx(rp[k], rel=1e-3), k
                    continue
                differ = set(torch.nonzero((ck != cp).any(-1)).flatten().tolist())
                assert differ <= _verified_tie_rows(reck, recp, w), k
                ties += [(k, r) for r in differ]
            moe_seen |= b.mlp == "moe"
    assert len(ties) <= max(1, 0.01 * n_rows), ties
    assert not parted or cfg.n_experts, parted

    served_cpu = quantize_params_for_serving(plan, params_cpu, qp["dec"], device="cpu")
    r = np.random.default_rng(3)
    prompts = [r.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 17, 26)]
    res = []
    for dev in (cuda, torch.device("cpu")):
        served = M.tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor) else
                            a.map_arrays(lambda t: t.to(dev)), served_cpu,
                            is_leaf=lambda a: hasattr(a, "map_arrays"))
        before = ops.launch_counts()["dequant_matmul"]
        ppl = perplexity_on_stream(plan, served, eval_fn, n_batches=2, device=dev)["ppl"]
        eng = ServingEngine(plan, served, max_batch=2, max_seq=64, prefill_pad=16,
                            record_logits=True, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        eng.run()
        assert all(len(q.output) == 4 for q in eng.finished)
        res.append((ppl, ops.launch_counts()["dequant_matmul"] - before, eng))
    (pk, nk, ek), (pp, np_, ep) = res
    n_linears = sum(isinstance(v, QuantizedTensor) for per in qp["dec"] for blk in per.values()
                    for v in blk.values())
    assert np_ == 0 and nk >= ek.n_decode_steps * n_linears
    assert pk == pytest.approx(pp, rel=1e-3)
    for i, tr in ep.logit_trace.items():
        scale = float(np.abs(tr[0]).max())
        np.testing.assert_allclose(ek.logit_trace[i][0], tr[0], rtol=0, atol=1e-3 * scale)


# ---------------------------------------------------------------------------
# Whisper and LLaVA: PTQ (encoder first), the restack, prefill and decode
# ---------------------------------------------------------------------------


def _card_on_cpu_sigma(cuda, rec_cpu, w, pcfg):
    """The CPU's recorded solve of the group holding matrix ``w``, solved
    again on the card from the same W, Σ and grid: the rows of ``w`` that
    part, each verified to start at a rounding tie."""
    from repro_torch.quant import Grid

    i = next(i for i, (w3, *_r) in enumerate(rec_cpu)
             if any(torch.equal(w3[g, :, : w.shape[1]], w) for g in range(w3.shape[0])))
    w3, s3, scale, zero, _ = rec_cpu[i]
    rec_card = []
    with _recording_solves(rec_card):
        qe.quantease_quantize(w3.to(cuda), s3.to(cuda), pcfg.spec,
                              grid=Grid(pcfg.spec, scale.to(cuda), zero.to(cuda)),
                              **pcfg.qe_config().solve_kwargs())
    return _verified_tie_rows(rec_card, [rec_cpu[i]], w)


@pytest.mark.parametrize("arch", ["whisper_large_v3", "llava_next_34b"])
def test_encdec_prefix_archs_on_card_match_cpu(cuda, arch):
    """A reduced fp32 Whisper (2 encoder and 2 decoder periods, 64 frames)
    and LLaVA (2 layers, 16 patches) through QuantEase PTQ (``emit="qt"``,
    the encoder first) on the card (kernels 1, 2 and 3) and on the CPU
    (plain versions): report keys equal; every layer whose solve saw Σ
    within 1e-4 relative of the CPU's (fp32 rounding carried through the
    quantized layers before it by the kernels' summation order: measured
    1.5e-5 at Whisper's ``enc.p1`` ``wd``) has its codes equal outside rows
    that start at a verified rounding tie (the bound widened by that Σ
    difference) and its error within 1e-3 relative where they agree.  A
    solve's Σ may part further only downstream of such a tie (a flipped
    code moves that channel of every later input, and an encoder tie every
    decoder block's cross-attention input: 1.2e-4 at ``enc.p1`` ``wo`` in
    one run); such a group is solved once more on the card from the CPU's
    own W, Σ and grid, and held to the CPU's solve as above.  The CPU's artifact, both stacks restacked, then
    prefills (frames or patches in the batch) and takes three greedy decode
    steps on the card and on the CPU: logits within 1e-3 of max |logit|,
    the same tokens, kernel 3 launched on the card only."""
    from repro_torch.configs import get_config
    from repro_torch.core import solver
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.models import model as M
    from repro_torch.serve.qparams import quantize_params_for_serving

    base = get_config(arch)
    cfg = dataclasses.replace(
        base, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256, vocab=300,
        n_periods=2, n_enc_periods=2 if base.n_enc_periods else 0,
        n_frames=64 if base.family == "encdec" else base.n_frames,
        n_prefix=16 if base.n_prefix else 0, dtype=torch.float32,
    )
    plan = M.make_plan(cfg)
    params_cpu = M.init_params(plan, 5, device="cpu")
    calib_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 48, split="calib")
    calib = [calib_fn(0), calib_fn(1)]
    pcfg = solver.PTQConfig(iterations=5, emit="qt")
    out = []  # the card's run, then the CPU's
    for dev in (cuda, torch.device("cpu")):
        params = M.tree_map(lambda a: a.to(dev), params_cpu)
        records = []
        with _recording_solves(records):
            q, rep = solver.ptq_quantize_model(plan, params, calib, pcfg, device=dev)
        out.append((rep, q, records))
    (rk, qk, reck), (rp, qp, recp) = out
    assert list(rk) == list(rp)
    stacks = ("enc", "dec") if cfg.family == "encdec" else ("dec",)
    assert {k.split(".")[0] for k in rp} == set(stacks)

    def sig_rel(w):
        for (wk3, sk3, *_), (wp3, sp3, *_) in zip(reck, recp):
            for g in range(wp3.shape[0]):
                if torch.equal(wp3[g, :, : w.shape[1]], w):
                    return float((sk3[g] - sp3[g]).abs().max() / sp3[g].abs().max())
        raise AssertionError("no recorded solve of this matrix")

    ties, n_rows, parted = [], 0, []
    for k in rp:
        scope, leaf = k.split("/")
        stack, period, blk = scope.split(".")
        period = int(period[1:])
        w = _solver_matrix(params_cpu[stack][blk][leaf][period], leaf).contiguous()
        ck, cp = (qd[stack][period][blk][leaf].unpacked_codes().cpu() for qd in (qk, qp))
        n_rows += cp.shape[0]
        if sig_rel(w) > SIG_DRIFT:
            assert ties, (k, sig_rel(w), "Σ parted between the card and the CPU, no tie before")
            parted.append(k)
            ties += [(k, r) for r in _card_on_cpu_sigma(cuda, recp, w, pcfg)]
            continue
        if torch.equal(ck, cp):
            assert rk[k] == pytest.approx(rp[k], rel=1e-3), k
            continue
        differ = set(torch.nonzero((ck != cp).any(-1)).flatten().tolist())
        assert differ <= _verified_tie_rows(reck, recp, w), k
        ties += [(k, r) for r in differ]
    assert len(ties) <= max(1, 0.01 * n_rows), (ties, parted)

    served_cpu = quantize_params_for_serving(plan, params_cpu, qp["dec"],
                                             solver_qt_enc=qp.get("enc"), device="cpu")
    batch = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 2, 12, split="eval")[0](0)
    pos0 = 12 + cfg.n_prefix
    res = []
    for dev in (cuda, torch.device("cpu")):
        served = M.tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor) else
                            a.map_arrays(lambda t: t.to(dev)), served_cpu,
                            is_leaf=lambda a: hasattr(a, "map_arrays"))
        before = ops.launch_counts()["dequant_matmul"]
        logits, cache = M.prefill(plan, served, batch, M.init_cache(plan, 2, 64, device=dev))
        steps = [logits.float().cpu()]
        tok = steps[0].argmax(-1)
        for i in range(3):
            logits, cache = M.decode_step(plan, served, tok[:, None].to(dev), cache, pos0 + i)
            steps.append(logits.float().cpu())
            tok = steps[-1].argmax(-1)
        res.append((steps, ops.launch_counts()["dequant_matmul"] - before))
    (sk, nk), (sp, np_) = res
    assert np_ == 0 and nk > 0
    for a, b in zip(sk, sp):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * float(b.abs().max()))
        assert torch.isfinite(a).all()

