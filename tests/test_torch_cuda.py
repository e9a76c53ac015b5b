"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
elsewhere.  This file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: atol 2e-4 on CD iterates (fp reassociation; a rounding tie that
flips cascades along its row, so the fused checks hold rows), 1e-4 of
max |R| on the outlier iteration's exact residual in rows whose sweep
agrees, rtol 1e-6 / atol 1e-4 on fp32 GEMM output.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import quantease as qe
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
    """A mid-solve fused-engine state, transposed (G, p, q), from numpy."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((G, p, 2 * p)).astype(np.float32))
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


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("G,q,bsz", [(1, 70, 48), (3, 200, 128), (2, 96, 256)])
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


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,q,p,bsz", [(1, 100, 384, 128), (2, 64, 512, 256), (3, 33, 96, 32),
                                       (1, 100, 2048, 256)])  # the last splits k in two
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
@pytest.mark.parametrize("G,q,p,bsz", [(1, 100, 384, 128), (2, 64, 512, 256), (3, 33, 96, 32),
                                       (2, 70, 160, 32), (1, 100, 3072, 128)])
def test_outlier_iteration(cuda, G, q, p, bsz, matmul_dtype):
    """Kernel 4 against its plain version: q not a multiple of the 64-row
    tile, B of 32 (suffix tiles that straddle blocks), 128 and 256, and a
    correction whose k range is split in three."""
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
    with pytest.raises(ValueError):
        ops.quantease_block_sweep(s["base"][:, :32].double(), s["sig_t"][:, :32, :32],
                                  s["w"][:, :32], s["scale"][:, :32], s["zero"][:, :32],
                                  n_levels=16, quantize=True)


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
    # QuantEase runs every kernel but the outlier-aware iteration (Algorithm 3's).
    assert all(n > 0 for k, n in lk.items() if k != "quantease_outlier_iteration")
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
