"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):

1. card: CUDA must be present; prints the card's name and power limit;
2. build: compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``;
3. kernels: holds each kernel against its plain PyTorch version at the main
   path's shapes, and times kernel, plain version and (where one exists) a
   single PyTorch library call with CUDA events; the outlier-aware iteration
   (Algorithm 3) also at its three solver-group shapes, with a 25-iteration
   solve of kernel path against plain path;
4. small-input reference: ``tests/test_torch_cuda.py`` on the card, where a
   reduced Phi-3 quantized and scored on the card (kernels) and on the CPU
   (plain versions) must agree, and each kernel matches its plain version
   at small and ragged shapes;
5. main path: Phi-3-mini at full width (2 of 32 decoder layers, seeded
   random weights): RTN and QuantEase PTQ at 4 bits, then RTN, QuantEase and
   outlier-aware QuantEase (1 % outliers) at 3 bits, each through the
   serving restack and perplexity; mean relative error must order
   qe_outlier < quantease < rtn at 3 bits, the outlier artifact must carry
   its COO planes, and every kernel's launch counter must rise.

The second-to-last line is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.  Per-shape details go to
``chiprun_out/chip_smoke_detail.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores.  Every kernel here runs fp32 arithmetic.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
CD_ATOL = 1e-4
ROWS_OK = 0.999  # rows (output channels) within CD_ATOL in every output
ROWS_TIES = 0.998  # the floor when each row past ROWS_OK starts with a tie flip

# The main path's shapes (Phi-3-mini: d_model 3072, d_ff 8192, B = 256).
SWEEP_SHAPE = (4, 3072, 256)  # (G, q, B): the attention group's column block
FUSED_SHAPES = (  # (G, q, p, correction dtype): the three solver groups, then bf16
    (1, 3072, 8192, "float32"),
    (2, 8192, 3072, "float32"),
    (4, 3072, 3072, "float32"),
    (4, 3072, 3072, "bfloat16"),
)
CD_TOKENS = 8192  # calibration tokens behind each test Σ (16 x 512)
GEMM_M = 2048  # tokens per calibration / eval batch (4 x 512)
GEMM_VARIANT_SHAPE = (3072, 3072)
GEMM_PATH_SHAPES = (((3072, 3072), 4), ((8192, 3072), 2), ((3072, 8192), 1))  # (q, p), per layer
OUTLIER_SHAPES = FUSED_SHAPES  # the same three solver groups, then bf16 operands
OUTLIER_BLOCK = 128  # outlier_quantease's default cd_block_size, as on the path
OUTLIER_FRAC = 0.01
R_RTOL = 1e-4  # the exact residual R, relative to max |R|, in rows whose sweep agrees
MAIN_OVERRIDES = dict(n_periods=2)  # depth cut: 2 of 32 decoder layers
# (method, bits) of the main path's PTQ runs, in order.
MAIN_RUNS = (("rtn", 4), ("quantease", 4), ("rtn", 3), ("quantease", 3), ("qe_outlier", 3))
MAIN_BATCH, MAIN_SEQ, MAIN_CALIB_BATCHES, MAIN_EVAL_BATCHES = 4, 512, 4, 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and split the device time by
    kernel: ``{"wall_ms", "device_ms", "busy", "by_kernel": {name: ms}}``,
    our kernels by their source name and everything else (PyTorch's own
    kernels: top-k, elementwise, copies) under "torch".  The host wall time
    includes the profiler's own launch overhead, so ``busy`` (device time
    over wall time) is a lower bound.  Empty when the trace holds no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((k for k in ("qe_block_corr_kernel", "qe_block_sweep_kernel",
                                 "qe_suffix_resid_kernel", "dequant_matmul_kernel") if k in e.name),
                    "torch")
        by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_kernel:
        return {}
    dev = sum(by_kernel.values())
    return dict(wall_ms=wall, device_ms=dev, busy=dev / wall, by_kernel=by_kernel)


def bound(n_bytes: float, n_flop: float) -> tuple[float, str]:
    t_b, t_f = n_bytes / PEAK_BYTES * 1e3, n_flop / PEAK_FP32 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def cd_problem(gen, G, q, p, n_tokens, dev):
    """Weights and a damped-able Gram from Gaussian activations."""
    import torch

    x = torch.randn(G, p, n_tokens, generator=gen, device=dev)
    sigma = x @ x.transpose(-1, -2)
    del x
    w = torch.randn(G, q, p, generator=gen, device=dev) * 0.02
    return w, sigma


def cd_state(gen, G, q, p, dev, bits=4):
    """A mid-solve fused-engine state in the kernels' transposed layout."""
    import torch

    from repro_torch.core import quantease as qe
    from repro_torch.quant import GridSpec, compute_grid, quantize_dequantize

    w, sigma = cd_problem(gen, G, q, p, CD_TOKENS, dev)
    grid = compute_grid(w, GridSpec(bits=bits))
    w32, _, scale, zero, sig_tilde, pmat = qe._prep(w, sigma, GridSpec(bits=bits), 0.01, grid)
    w_hat = quantize_dequantize(w32, grid)
    t = lambda a: a.transpose(-1, -2).contiguous()
    base = t(pmat - w_hat @ sig_tilde)
    delta = 0.1 * (t(w32) - t(w_hat)) * torch.rand(G, p, q, generator=gen, device=dev)
    return dict(base=base, sig_t=t(sig_tilde), w=t(w_hat), scale=t(scale), zero=t(zero),
                delta=delta)


def rows_within(a, b, atol):
    """Fraction of rows (output channels) whose every entry is within atol."""
    ok = ((a - b).abs() <= atol).all(dim=-2)  # (G, q): over the p axis
    return float(ok.float().mean()), float((a - b).abs().max())


def tie_flip_rows(k_out, p_out, state, bsz, n_levels, atol):
    """Rows (output channels) that differ between kernel and plain version,
    and which of them do not start with a rounding tie.

    The sweep visits columns in order and each snapped value depends on all
    earlier ones in its row, so one tie resolved differently makes the rest
    of the row differ.  At a row's first differing column j (every earlier
    entry within ``atol``), each version's β is recomputed in float64 from
    its own stored β0 (``base_new``) and its own Δ of the block's columns
    before j.  The row is a tie flip only if (a) both β0 agree within
    ``atol``; (b) the snapped values are one grid step apart; (c) each is
    the snap of its own β; and (d) a rounding midpoint (k + ½)·s lies
    between the two β, widened by the fp32 rounding bound of β0 plus a dot
    product of up to B terms.
    Returns ``(n_rows_differing, n_unexplained, per-row records)``.
    """
    import torch

    (wk, bk, dk), (wp, bp, dp) = k_out, p_out
    diff = ((wk - wp).abs() > atol) | ((bk - bp).abs() > atol) | ((dk - dp).abs() > atol)
    rows = diff.any(dim=-2).nonzero().tolist()  # (g, r) pairs
    eps = torch.finfo(torch.float32).eps
    unexplained, records = 0, []
    for g, r in rows:
        j = int(diff[g, :, r].nonzero()[0])
        c0 = j - j % bsz
        s, z = float(state["scale"][g, j, r]), float(state["zero"][g, j, r])
        sig = state["sig_t"][g, j, c0:j].double()

        def beta(b_, d_):
            terms = sig * d_[g, c0:j, r].double()
            b0 = float(b_[g, j, r])
            return b0 + float(terms.sum()), abs(b0) + float(terms.abs().sum())

        def snaps(b, err):
            code = lambda v: min(max(round(v / s) + z, 0.0), n_levels - 1.0)
            return {(code(b - err) - z) * s, (code(b + err) - z) * s}

        (beta_k, mag_k), (beta_p, mag_p) = beta(bk, dk), beta(bp, dp)
        err = 2 * bsz * eps * max(mag_k, mag_p)
        lo, hi = (min(beta_k, beta_p) - err) / s, (max(beta_k, beta_p) + err) / s
        own = lambda w_, b: any(abs(float(w_[g, j, r]) - v) <= 1e-3 * s for v in snaps(b, err))
        ok = (abs(float(bk[g, j, r]) - float(bp[g, j, r])) <= atol
              and abs(abs(float(wk[g, j, r]) - float(wp[g, j, r])) - s) <= 1e-3 * s
              and own(wk, beta_k) and own(wp, beta_p)
              and math.floor(hi - 0.5) >= math.ceil(lo - 0.5))
        unexplained += not ok
        records.append(dict(g=g, row=r, col=j, tie=ok, beta_over_s=beta_p / s,
                            from_midpoint=beta_p / s - (math.floor(beta_p / s) + 0.5),
                            bound=err / s))
    return len(rows), unexplained, records


def check_block_sweep(gen, dev, detail):
    import torch

    from repro_torch.kernels import ops, ref

    G, q, bsz = SWEEP_SHAPE
    s = cd_state(gen, G, q, bsz, dev)
    args = (s["base"], s["sig_t"], s["w"], s["scale"], s["zero"])
    kw = dict(n_levels=16, quantize=True)
    kn, kd = ops.quantease_block_sweep(*args, **kw)
    pn, pd = ref.quantease_block_sweep_t_ref(*args, **kw)
    torch.cuda.synchronize()
    frac_n, err_n = rows_within(kn, pn, CD_ATOL)
    frac_d, err_d = rows_within(kd, pd, CD_ATOL)
    check(min(frac_n, frac_d) >= ROWS_OK, f"block sweep: rows within {CD_ATOL}: {frac_n}, {frac_d}")
    ms = cuda_ms(lambda: ops.quantease_block_sweep(*args, **kw))
    plain = cuda_ms(lambda: ref.quantease_block_sweep_t_ref(*args, **kw))
    n_bytes = 4 * (6 * G * bsz * q + G * bsz * bsz)
    n_flop = G * q * (bsz * (bsz - 1) + 8 * bsz)
    b_ms, b_by = bound(n_bytes, n_flop)
    detail["block_sweep"] = dict(shape=[G, q, bsz], rows_ok=min(frac_n, frac_d), ms=ms, plain_ms=plain)
    print(f"[kernel] block_sweep (G={G}, q={q}, B={bsz}): rows_ok={min(frac_n, frac_d):.6f} "
          f"max_abs_err={max(err_n, err_d):.3g} ms={ms:.4f} plain_ms={plain:.3f} bound_ms={b_ms:.4f}")
    return dict(max_abs_err=max(err_n, err_d), ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, shape=f"G={G} q={q} B={bsz}")


def fused_bytes_flop(G, q, p, bsz, bf16):
    state = G * p * q * 4
    n_bytes = 5 * state + G * p * p * 4 + (G * p * p * 2 if bf16 else 0) + 3 * state
    n_flop = 2 * G * q * p * p + G * q * p * (bsz + 8)
    return n_bytes, n_flop


def check_fused_iteration(gen, dev, detail):
    import torch

    from repro_torch.core import quantease as qe
    from repro_torch.kernels import ops, ref
    from repro_torch.quant import GridSpec

    totals = dict(ms=0.0, plain_ms=0.0, bytes=0.0, flop=0.0, err=0.0)
    detail["fused_iteration"] = []
    for G, q, p, dt in FUSED_SHAPES:
        bsz = min(256, p)  # QuantEaseConfig's block size, as on the path
        s = cd_state(gen, G, q, p, dev)
        sig_corr = s["sig_t"].to(torch.bfloat16) if dt == "bfloat16" else s["sig_t"]
        args = (s["base"], s["sig_t"], sig_corr, s["w"], s["scale"], s["zero"], s["delta"])
        kw = dict(n_levels=16, quantize=True, bsz=bsz)
        k_out = ops.quantease_fused_iteration(*args, **kw)
        p_out = ref.quantease_fused_iteration_ref(*args, **kw)
        torch.cuda.synchronize()
        fracs, errs = zip(*(rows_within(k, pl, CD_ATOL) for k, pl in zip(k_out, p_out)))
        n_diff, n_unexplained, ties = tie_flip_rows(k_out, p_out, s, bsz, 16, CD_ATOL)
        # Below ROWS_OK, every differing row must start with a rounding tie
        # resolved the other way (see tie_flip_rows), down to ROWS_TIES.
        check(min(fracs) >= ROWS_OK or (n_unexplained == 0 and min(fracs) >= ROWS_TIES),
              f"fused iteration {G}x({q},{p}) {dt}: rows ok {fracs}, "
              f"{n_unexplained} of {n_diff} differing rows do not start with a tie flip: {ties}")
        del k_out, p_out
        ms = cuda_ms(lambda: ops.quantease_fused_iteration(*args, **kw))
        plain = cuda_ms(lambda: ref.quantease_fused_iteration_ref(*args, **kw), reps=10, warmup=1)
        n_bytes, n_flop = fused_bytes_flop(G, q, p, bsz, dt == "bfloat16")
        b_ms, b_by = bound(n_bytes, n_flop)
        del s, args, sig_corr
        # 25 iterations from the same (W, Σ): kernel engine vs plain engine.
        w, sigma = cd_problem(gen, G, q, p, CD_TOKENS, dev)
        spec = GridSpec(bits=4)
        kw25 = dict(iterations=25, matmul_dtype=dt)
        t0 = time.monotonic()
        wk, _ = qe.quantease_quantize(w, sigma, spec, use_kernel="auto", **kw25)
        torch.cuda.synchronize()
        t_kernel = time.monotonic() - t0
        wp, _ = qe.quantease_quantize(w, sigma, spec, use_kernel="torch", **kw25)
        ek = qe.relative_error(w, wk, sigma)
        ep = qe.relative_error(w, wp, sigma)
        rel = float(((ek - ep).abs() / ep).max())
        check(rel <= 1e-3, f"25 iterations {G}x({q},{p}) {dt}: relative error {ek.tolist()} vs {ep.tolist()}")
        del w, sigma, wk, wp
        row = dict(G=G, q=q, p=p, dtype=dt, rows_ok=min(fracs), rows_differing=n_diff,
                   rows_unexplained=n_unexplained, tie_rows=ties, max_abs_err=max(errs), ms=ms,
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by, rel_err_kernel=ek.tolist(),
                   rel_err_plain=ep.tolist(), solve25_s=t_kernel)
        detail["fused_iteration"].append(row)
        print(f"[kernel] fused_iteration G={G} ({q},{p}) {dt}: rows_ok={min(fracs):.6f} "
              f"(rows differing {n_diff}, not starting with a tie flip {n_unexplained}) "
              f"max_abs_err={max(errs):.3g} ms={ms:.3f} plain_ms={plain:.1f} bound_ms={b_ms:.3f} "
              f"({b_by}) 25-iter solve {t_kernel:.2f}s rel_err {ek.mean():.6f} vs plain {ep.mean():.6f}")
        if dt == "float32":  # one decoder layer's fp32 iteration: the three path groups
            totals["ms"] += ms
            totals["plain_ms"] += plain
            totals["bytes"] += n_bytes
            totals["flop"] += n_flop
        totals["err"] = max(totals["err"], max(errs))
    b_ms, b_by = bound(totals["bytes"], totals["flop"])
    return dict(max_abs_err=totals["err"], ms=totals["ms"], plain_ms=totals["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape="one fp32 CD iteration of a decoder layer: "
                + " + ".join(f"G={G} ({q},{p})" for G, q, p, dt in FUSED_SHAPES if dt == "float32"))


def outlier_bytes_flop(G, q, p, bsz, bf16):
    """Kernel 4's least traffic and work: six state inputs and four outputs,
    Σ̃ᵀ read once (plus its bf16 copy); the correction, the block-suffix
    product (nb(nb+1)/2 block pairs) and the sweep."""
    state = G * p * q * 4
    n_bytes = 6 * state + G * p * p * 4 + (G * p * p * 2 if bf16 else 0) + 4 * state
    nb = p // bsz
    n_flop = 2 * G * q * p * p + nb * (nb + 1) // 2 * 2 * bsz * bsz * q * G + G * q * p * (bsz + 8)
    return n_bytes, n_flop


def check_outlier_iteration(gen, dev, detail):
    import torch

    from repro_torch.core import outlier
    from repro_torch.core import quantease as qe
    from repro_torch.kernels import ops, ref
    from repro_torch.quant import GridSpec

    bsz = OUTLIER_BLOCK
    totals = dict(ms=0.0, plain_ms=0.0, bytes=0.0, flop=0.0, err=0.0)
    detail["outlier_iteration"] = []
    for G, q, p, dt in OUTLIER_SHAPES:
        s = cd_state(gen, G, q, p, dev, bits=3)
        shape = s["base"].shape
        dh = torch.where(torch.rand(shape, generator=gen, device=dev) < OUTLIER_FRAC,
                         0.02 * torch.randn(shape, generator=gen, device=dev), 0.0)
        sig_corr = s["sig_t"].to(torch.bfloat16) if dt == "bfloat16" else s["sig_t"]
        args = (s["base"], s["sig_t"], sig_corr, s["w"], s["scale"], s["zero"], s["delta"], dh)
        kw = dict(n_levels=8, quantize=True, bsz=bsz)
        k_out = ops.quantease_outlier_iteration(*args, **kw)
        p_out = ref.quantease_outlier_iteration_ref(*args, **kw)
        torch.cuda.synchronize()
        fracs, errs = zip(*(rows_within(k, pl, CD_ATOL) for k, pl in zip(k_out[:3], p_out[:3])))
        n_diff, n_unexplained, ties = tie_flip_rows(k_out[:3], p_out[:3], s, bsz, 8, CD_ATOL)
        check(min(fracs) >= ROWS_OK or (n_unexplained == 0 and min(fracs) >= ROWS_TIES),
              f"outlier iteration {G}x({q},{p}) {dt}: rows ok {fracs}, "
              f"{n_unexplained} of {n_diff} differing rows do not start with a tie flip: {ties}")
        # R in the rows (output channels) whose sweep agrees: a flipped tie
        # changes its row's δŴ and so that row's R.
        same = torch.stack([((k - pl).abs() <= CD_ATOL).all(dim=-2)
                            for k, pl in zip(k_out[:3], p_out[:3])]).all(0)
        r_scale = float(p_out[3].abs().max())
        r_err = float((k_out[3] - p_out[3]).abs().amax(dim=-2)[same].max()) / r_scale
        check(r_err <= R_RTOL, f"outlier iteration {G}x({q},{p}) {dt}: R off by {r_err} of max |R|")
        # P_s of one IHT step: top-k of 1 % of the flattened state.
        cand = k_out[3] - k_out[0]
        n_top = max(int(OUTLIER_FRAC * q * p), 1)
        topk_ms = cuda_ms(lambda: torch.topk(cand.abs().reshape(G, -1), n_top, dim=-1, sorted=False))
        del k_out, p_out, cand
        ms = cuda_ms(lambda: ops.quantease_outlier_iteration(*args, **kw))
        split = device_profile(lambda: ops.quantease_outlier_iteration(*args, **kw))
        plain = cuda_ms(lambda: ref.quantease_outlier_iteration_ref(*args, **kw), reps=5, warmup=1)
        n_bytes, n_flop = outlier_bytes_flop(G, q, p, bsz, dt == "bfloat16")
        b_ms, b_by = bound(n_bytes, n_flop)
        del s, args, sig_corr, dh
        # 25 iterations from the same (W, Σ): kernel engine vs plain engine.
        w, sigma = cd_problem(gen, G, q, p, CD_TOKENS, dev)
        kw25 = dict(s=n_top, iterations=25, matmul_dtype=dt)
        t0 = time.monotonic()
        rk = outlier.outlier_quantease(w, sigma, GridSpec(bits=3), use_kernel="auto", **kw25)
        torch.cuda.synchronize()
        t_kernel = time.monotonic() - t0
        solve_split = device_profile(
            lambda: outlier.outlier_quantease(w, sigma, GridSpec(bits=3), use_kernel="auto", **kw25))
        rp = outlier.outlier_quantease(w, sigma, GridSpec(bits=3), use_kernel="torch", **kw25)
        ek = qe.relative_error(w, rk.w_eff, sigma)
        ep = qe.relative_error(w, rp.w_eff, sigma)
        rel = float(((ek - ep).abs() / ep).max())
        check(rel <= 1e-3, f"outlier 25 iterations {G}x({q},{p}) {dt}: relative error "
              f"{ek.tolist()} vs {ep.tolist()}")
        del w, sigma, rk, rp
        row = dict(G=G, q=q, p=p, dtype=dt, bsz=bsz, rows_ok=min(fracs), rows_differing=n_diff,
                   rows_unexplained=n_unexplained, tie_rows=ties, max_abs_err=max(errs),
                   r_rel_err=r_err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   topk_ms=topk_ms, rel_err_kernel=ek.tolist(), rel_err_plain=ep.tolist(),
                   solve25_s=t_kernel, iteration_profile=split, solve25_profile=solve_split)
        detail["outlier_iteration"].append(row)
        print(f"[kernel] outlier_iteration G={G} ({q},{p}) B={bsz} {dt}: rows_ok={min(fracs):.6f} "
              f"(rows differing {n_diff}, not starting with a tie flip {n_unexplained}) "
              f"max_abs_err={max(errs):.3g} R rel err={r_err:.3g} ms={ms:.3f} plain_ms={plain:.1f} "
              f"bound_ms={b_ms:.3f} ({b_by}) topk_ms={topk_ms:.3f} 25-iter solve {t_kernel:.2f}s "
              f"rel_err {ek.mean():.6f} vs plain {ep.mean():.6f}", flush=True)
        for what, prof in (("iteration", split), ("25-iter solve", solve_split)):
            print(f"[profile] outlier {what} G={G} ({q},{p}) {dt}: " + (
                "no device time in the trace" if not prof else
                f"wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms "
                f"(busy {prof['busy']:.3f}): " + ", ".join(
                    f"{k} {v:.2f}" for k, v in sorted(prof["by_kernel"].items()))), flush=True)
        if dt == "float32":  # one decoder layer's fp32 iteration: the three path groups
            totals["ms"] += ms
            totals["plain_ms"] += plain
            totals["bytes"] += n_bytes
            totals["flop"] += n_flop
        totals["err"] = max(totals["err"], max(errs))
    b_ms, b_by = bound(totals["bytes"], totals["flop"])
    return dict(max_abs_err=totals["err"], ms=totals["ms"], plain_ms=totals["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"one fp32 outlier-aware CD iteration of a decoder layer, B={bsz}: "
                + " + ".join(f"G={G} ({q},{p})" for G, q, p, dt in OUTLIER_SHAPES if dt == "float32"))


def check_dequant_matmul(gen, dev, detail):
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.quant import pack_codes

    m = GEMM_M
    detail["dequant_matmul"] = []
    err_max = 0.0

    def problem(q, p, n_groups):
        x = torch.randn(m, p, generator=gen, device=dev).to(torch.bfloat16)
        codes = torch.randint(0, 16, (q, p), generator=gen, device=dev, dtype=torch.uint8)
        scale = torch.rand(q, n_groups, generator=gen, device=dev) * 0.01 + 1e-3
        zero = torch.randint(0, 16, (q, n_groups), generator=gen, device=dev).float()
        return x, codes, scale, zero

    # Variants: uint8 / packed4 x per-channel / group 128, bf16 and fp32 out.
    vq, vp = GEMM_VARIANT_SHAPE
    for packed4 in (False, True):
        for gsz in (None, 128):
            for out_dtype in (torch.bfloat16, torch.float32):
                x, codes, scale, zero = problem(vq, vp, 1 if gsz is None else -(-vp // 128))
                kc = pack_codes(codes, 4) if packed4 else codes
                y = ops.dequant_matmul(x, kc, scale, zero, packed4=packed4, out_dtype=out_dtype, group_size=gsz)
                y_ref = ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.float32, group_size=gsz)
                torch.cuda.synchronize()
                err = float((y.float() - y_ref).abs().max())
                tol = (1e-2 if out_dtype == torch.bfloat16 else 1e-4) * float(y_ref.abs().max())
                check(err <= tol, f"dequant_matmul packed4={packed4} gsz={gsz} {out_dtype}: {err} > {tol}")
                err_max = max(err_max, err / float(y_ref.abs().max()))
                print(f"[kernel] dequant_matmul (m={m}, {vq}, {vp}) packed4={packed4} group={gsz} "
                      f"out={str(out_dtype)[6:]}: max_abs_err={err:.3g} (tol {tol:.3g})")
    # The path's own configuration (4-bit packed, per-channel, bf16) at its three shapes,
    # weighted by launches per decoder layer (wq wk wv wo; wg wu; wd).
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, flop=0.0)
    for (q, p), count in GEMM_PATH_SHAPES:
        x, codes, scale, zero = problem(q, p, 1)
        kc = pack_codes(codes, 4)
        y = ops.dequant_matmul(x, kc, scale, zero, packed4=True, out_dtype=torch.bfloat16)
        y_ref = ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.float32)
        torch.cuda.synchronize()
        err = float((y.float() - y_ref).abs().max())
        check(err <= 1e-2 * float(y_ref.abs().max()), f"dequant_matmul path shape ({q},{p}): {err}")
        ms = cuda_ms(lambda: ops.dequant_matmul(x, kc, scale, zero, packed4=True, out_dtype=torch.bfloat16))
        plain = cuda_ms(lambda: ops_plain(x, kc, scale, zero))
        xf = x.float()
        wt = ((codes.float() - zero) * scale).T.contiguous()
        lib = cuda_ms(lambda: torch.matmul(xf, wt))
        n_bytes = m * p * 2 + q * p // 2 + 2 * q * 4 + m * q * 2
        n_flop = 2 * m * q * p
        b_ms, b_by = bound(n_bytes, n_flop)
        detail["dequant_matmul"].append(dict(m=m, q=q, p=p, ms=ms, plain_ms=plain, library_ms=lib,
                                             bound_ms=b_ms, per_layer=count))
        print(f"[kernel] dequant_matmul path (m={m}, {q}, {p}) packed4 bf16: ms={ms:.3f} "
              f"plain_ms={plain:.3f} library_ms={lib:.3f} bound_ms={b_ms:.3f} ({b_by})")
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib)):
            tot[k] += count * v
        tot["bytes"] += count * n_bytes
        tot["flop"] += count * n_flop
    b_ms, b_by = bound(tot["bytes"], tot["flop"])
    return dict(max_abs_err=err_max, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b_ms,
                bound_by=b_by, library_ms=tot["library_ms"],
                shape=f"one decoder layer's 7 linears at m={m}, 4-bit packed per-channel, bf16")


def ops_plain(x, kc, scale, zero):
    """The plain path of the serving GEMM on the card: unpack, dequantize,
    fp32 product (what ops.dequant_matmul does for CPU tensors)."""
    from repro_torch.kernels import ref
    from repro_torch.quant import unpack_codes

    import torch

    codes = unpack_codes(kc, 4, kc.shape[-1] * 2)
    return ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# Phase 4: the port's tests on the card (small inputs, card against CPU)
# ---------------------------------------------------------------------------


def card_tests() -> None:
    """The slice on a small input, card against CPU, and every kernel against
    its plain version at small and ragged shapes: ``tests/test_torch_cuda.py``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [v for v in [os.environ.get("PYTHONPATH")] if v]))
    t0 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "tests/test_torch_cuda.py"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    tail = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else ""
    print(f"[reference] tests/test_torch_cuda.py: {tail} ({time.monotonic() - t0:.1f}s)", flush=True)
    check(run.returncode == 0 and "skipped" not in tail,
          f"tests/test_torch_cuda.py on the card:\n{run.stdout[-6000:]}\n{run.stderr[-2000:]}")


# ---------------------------------------------------------------------------
# Phase 5: the main path at full width
# ---------------------------------------------------------------------------


def main_path(dev, detail):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import solver
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.eval.scorer import perplexity_on_stream
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.quant import GridSpec
    from repro_torch.serve.qparams import quantize_params_for_serving

    cfg = dataclasses.replace(get_config("phi3_mini_3_8b"), **MAIN_OVERRIDES)
    plan = M.make_plan(cfg)
    params = M.init_params(plan, 0, device=dev)
    data = DataConfig(vocab=cfg.vocab, seed=0)
    calib_fn, _ = make_batch_fn(data, cfg, MAIN_BATCH, MAIN_SEQ, split="calib")
    eval_fn, _ = make_batch_fn(data, cfg, MAIN_BATCH, MAIN_SEQ, split="eval")
    calib = [calib_fn(i) for i in range(MAIN_CALIB_BATCHES)]
    n_eval_tokens = MAIN_EVAL_BATCHES * MAIN_BATCH * (MAIN_SEQ - 1)
    n_layers = 7 * cfg.n_periods

    blocks = []  # the solver's progress records: per-block seconds and errors

    def progress(label):
        def cb(r):
            blocks.append(dict(run=label, period=r["period"], seconds=r["seconds"],
                               mean_rel_error=r["mean_rel_error"]))
            print(f"[{label} p{r['period']} {r['done_blocks']}/{r['total_blocks']}] "
                  f"{r['n_linears']} linears mean_err={r['mean_rel_error']:.6f} {r['seconds']}s")
        return cb

    ops.reset_launch_counts()
    t_main = time.monotonic()
    results, coo = {}, {}
    for method, bits in MAIN_RUNS:
        label = f"{method}@{bits}"
        pcfg = solver.PTQConfig(method=method, spec=GridSpec(bits=bits), iterations=25, emit="qt",
                                outlier_frac=OUTLIER_FRAC)
        t0 = time.monotonic()
        qparams, report = solver.ptq_quantize_model(
            plan, params, calib, pcfg, progress_cb=progress(label), device=dev)
        served = quantize_params_for_serving(plan, params, qparams["dec"], device=dev)
        ppl = perplexity_on_stream(plan, served, eval_fn, n_batches=MAIN_EVAL_BATCHES, device=dev)
        results[label] = (report, ppl, time.monotonic() - t0)
        wq = served["dec"]["b0"]["wq"]
        q_wq, p_wq = wq.shape[-2:]
        coo[label] = (None if wq.outlier_idx is None else tuple(wq.outlier_idx.shape),
                      (cfg.n_periods, max(int(OUTLIER_FRAC * q_wq * p_wq), 1)))
        del qparams, served, wq
    dense_ppl = perplexity_on_stream(plan, params, eval_fn, n_batches=MAIN_EVAL_BATCHES, device=dev)
    torch.cuda.synchronize()
    t_main = time.monotonic() - t_main
    counts = ops.launch_counts()

    errs = {}
    for label, (report, ppl, secs) in results.items():
        vals = np.array(list(report.values()))
        check(np.all(np.isfinite(vals)) and len(vals) == n_layers, f"{label}: report {report}")
        check(math.isfinite(ppl["ppl"]) and ppl["n_tokens"] == n_eval_tokens, f"{label}: ppl {ppl}")
        errs[label] = vals
        print(f"[main] {label}: {len(vals)} layers mean_rel_error={vals.mean():.6f} "
              f"max_rel_error={vals.max():.6f} ppl={ppl['ppl']:.4f} nll={ppl['nll']:.6f} ({secs:.1f}s)")
    check(math.isfinite(dense_ppl["ppl"]), f"dense ppl {dense_ppl}")
    print(f"[main] dense: ppl={dense_ppl['ppl']:.4f} nll={dense_ppl['nll']:.6f}")
    check(len({tuple(r[0]) for r in results.values()}) == 1, "layer sets differ")
    mean = {label: v.mean() for label, v in errs.items()}
    check(mean["quantease@4"] < mean["rtn@4"],
          f"QuantEase mean error {mean['quantease@4']} not below RTN's {mean['rtn@4']} at 4 bits")
    check(mean["qe_outlier@3"] < mean["quantease@3"] < mean["rtn@3"],
          f"at 3 bits mean errors do not order qe_outlier < quantease < rtn: {mean}")
    # The outlier artifact carries its COO planes, stacked over the periods.
    have, want = coo["qe_outlier@3"]
    check(have == want and coo["quantease@3"][0] is None, f"serving params' COO planes: {coo}")
    print(f"[main] qe_outlier@3 serving wq carries COO planes of shape {have}")
    print(f"[main] launches during the main path: {counts}  ({t_main:.1f}s)")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    detail["main"] = dict(
        layers={m: dict(zip(r[0], map(float, r[0].values()))) for m, r in results.items()},
        ppl={m: r[1] for m, r in results.items()} | {"dense": dense_ppl},
        seconds_per_run={m: r[2] for m, r in results.items()},
        blocks=blocks,
        seconds=t_main,
    )
    return counts


def main() -> None:
    try:
        import torch

        from repro_torch.device import resolve_device
        from repro_torch.kernels import build, ops
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.monotonic()
    secs = build.build_all()
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"total {time.monotonic() - t0:.2f}s", flush=True)

    detail = {"card": card}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    measured = {
        "quantease_block_sweep": check_block_sweep(gen, dev, detail),
        "quantease_fused_iteration": check_fused_iteration(gen, dev, detail),
        "quantease_outlier_iteration": check_outlier_iteration(gen, dev, detail),
        "dequant_matmul": check_dequant_matmul(gen, dev, detail),
    }
    torch.cuda.empty_cache()
    card_tests()
    torch.cuda.empty_cache()
    counts = main_path(dev, detail)

    kernels = []
    for name, (_, source, replaces) in ops.KERNELS.items():
        m = measured[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=counts[name],
            max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=m["library_ms"],
            shape=m["shape"],
        ))
    detail["kernels"] = kernels
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_detail.json"), "w") as fh:
        json.dump(detail, fh, indent=1, default=str)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
