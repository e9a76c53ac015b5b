"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):

1. card: CUDA must be present; prints the card's name and power limit;
2. build: compiles every CUDA kernel from ``src/repro_torch/kernels/csrc``;
3. kernels: holds each kernel against its plain PyTorch version at the main
   path's shapes, and times kernel, plain version and (where one exists) a
   single PyTorch library call with CUDA events; the block sweep (kernel 1)
   at the six path shapes (three solver groups, B = 256 and 128), with its
   plan, CTAs per SM, registers and spills, every plan held bit-identical
   and timed, the bytes bound, the launches of the shape on the PTQ path,
   and an A/B line against the earlier kernel's time per call; the fused and the
   outlier-aware iteration (Algorithm 3) at the three solver-group shapes,
   each with a 25-iteration solve of kernel path against plain path and its
   device time split by kernel, and their SGEMMs alone (the block
   corrections of one iteration at the planned split and at two others, the
   outlier iteration's suffix product) against fp32 ``torch.matmul`` for
   the same products, with an A/B line against the earlier 64 x 64 tile's
   time at G=1 (3072, 8192); the dequant-GEMM's variants at
   m = 2048 (bf16 x on tc_large, fp32 x on simt), then the path's three
   shapes at the eval batch (m = 2048), a prefill chunk (128) and the decode
   batch (8), per decoder layer, with the variant each took, bounds on the
   bf16 tensor cores and in fp32, fp32 cuBLAS on the dequantized weight and
   bf16 cuBLAS on (c − z), a split-K repeat held bit for bit, and the
   per-layer time at m = 8 and 2048 held below fp32 cuBLAS's; paged
   attention (kernel 5) at the serving shape
   (8 sequences of up to 1536 tokens, 32 kv heads of 96) in bf16, int8 and
   int4 pages, at a long shape (32 x 4096 tokens, bf16 and int4) and at a
   GQA shape with a window and a softcap;
4. small-input reference: ``tests/test_torch_cuda.py`` on the card, where a
   reduced Phi-3 quantized and scored on the card (kernels) and on the CPU
   (plain versions) must agree, and each kernel matches its plain version
   at small and ragged shapes;
5. main path: Phi-3-mini at full width (2 of 32 decoder layers, seeded
   random weights): RTN and QuantEase PTQ at 4 bits, then RTN, QuantEase and
   outlier-aware QuantEase (1 % outliers) at 3 bits, each through the
   serving restack and perplexity; mean relative error must order
   qe_outlier < quantease < rtn at 3 bits, the outlier artifact must carry
   its COO planes, every PTQ kernel's launch counter must rise, and the
   dequant-GEMM must run tensor-core variants only (no simt launch);
6. serving: the 4-bit QuantEase artifact of phase 5 answers 24 requests
   (prompts of 16-1024 tokens, 4 sharing a 256-token prefix, 32 new tokens
   each) on the paged engine with bf16, int8 and int4 KV, again on bf16
   (repeat: same tokens), on bf16 with 40 % of the pages (preemption), and on
   the contiguous engine; paged and contiguous first-decode logits must agree,
   kernel 5 must launch once per decode step and period, and the decode
   steps' GEMMs must run tc_small (no simt launch).

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

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores, and dense bf16 FLOP/s on the tensor cores (the
# dequant-GEMM's tc_large and tc_small variants; every other kernel here
# runs fp32 arithmetic).
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16_TC = 989e12
CD_ATOL = 1e-4
ROWS_OK = 0.999  # rows (output channels) within CD_ATOL in every output
ROWS_TIES = 0.998  # the floor when each row past ROWS_OK starts with a tie flip

# The main path's shapes (Phi-3-mini: d_model 3072, d_ff 8192, B = 256).
PTQ_ITERATIONS = 25  # CD iterations of each PTQ solve on the main path
QE_BLOCK = 256  # QuantEaseConfig's block size, as on the path
# Kernel 1 at the three solver groups (G, q, p) and both block sizes of the
# path: QuantEase's and outlier_quantease's; the sweep's shape is (G, B, q).
SWEEP_SHAPES = tuple((G, q, p, B) for B in (256, 128)
                     for G, q, p in ((4, 3072, 3072), (2, 8192, 3072), (1, 3072, 8192)))
# The A/B against the sweep kernel before the panelled one, which is no
# longer in the tree: its time per call with events at G=4, q=3072, B=256
# from PERF.md's kernel table, row 1 (NVIDIA H100 80GB HBM3, 700 W).
OLD_SWEEP_SHAPE = (4, 3072, 3072, 256)
OLD_SWEEP_CALL_MS = 0.352
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
# The A/B against the correction's earlier 64 x 64 tile, which is no longer
# in the tree: its device time from PERF.md §5, the G=1 (3072, 8192)
# qe_outlier solve's split (NVIDIA H100 80GB HBM3, 700 W).
OLD_TILE_SHAPE = (1, 3072, 8192, "float32")
OLD_TILE_SOLVE_CORR_MS = 703.0  # qe_block_corr_kernel in one 25-iteration solve
OLD_TILE_CORR_MS = OLD_TILE_SOLVE_CORR_MS / 25
MAIN_OVERRIDES = dict(n_periods=2)  # depth cut: 2 of 32 decoder layers
# (method, bits) of the main path's PTQ runs, in order.
MAIN_RUNS = (("rtn", 4), ("quantease", 4), ("rtn", 3), ("quantease", 3), ("qe_outlier", 3))
MAIN_BATCH, MAIN_SEQ, MAIN_CALIB_BATCHES, MAIN_EVAL_BATCHES = 4, 512, 4, 2
SERVED_RUN = "quantease@4"  # the artifact phase 6 serves
GEMM_DECODE_M = 8  # the serving GEMM at decode: one token per lane, max_batch 8
GEMM_PREFILL_M = 128  # the serving GEMM on a prefill chunk (prefill_chunk = 128)
# Kernel 5's shapes: (label, B, KVp, G, hd, max length, window, softcap, page kinds).
PAGE = 16
PAGED_SHAPES = (
    ("serving", 8, 32, 1, 96, 1536, None, None, ("bf16", "int8", "int4")),
    ("long", 32, 32, 1, 96, 4096, None, None, ("bf16", "int4")),
    ("gqa", 8, 8, 4, 128, 1536, 256, 50.0, ("bf16", "int8", "int4")),
)
PAGED_ATOL = 2e-2  # the kernel keeps p in fp32, the plain version rounds it to bf16
# Phase 6: the serving traffic and engines.
SERVE_REQUESTS, SERVE_PROMPT_LO, SERVE_PROMPT_HI, SERVE_NEW_TOKENS = 24, 16, 1024, 32
SERVE_PREFIX, SERVE_N_SHARED = 256, 4
SERVE_PAGED = dict(max_batch=8, max_seq=1536, page_size=PAGE, prefill_chunk=128)
SERVE_CONTIG = dict(max_batch=8, max_seq=1536)
SERVE_SMALL_POOL = 0.3  # of the ample page count: forces preemption (0.4 does not)
# First-decode logits, paged bf16 against contiguous bf16, as a share of the
# contiguous run's max |logit| (bf16 activations; kernel 5 keeps p in fp32
# where decode_attention rounds it to bf16); also the margin below which
# the greedy streams may part.
SERVE_LOGIT_TOL = 2e-2
# int4/int8 KV against bf16: max |Δ logit| / max |logit| below this.  int4's
# step (max/7) is 18x int8's (max/127); at full width int4 moves the first
# logits by ~0.26 of max |logit| and int8 by ~0.02.
SERVE_KV_BOUND = 0.5


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


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls queued back to back
    behind a sleep kernel that outlasts their enqueue, then timed with events
    on the card.  Unlike :func:`cuda_ms` it leaves out the host work between
    launches (at the decode batch the wrapper's host time is longer than its
    kernels).  A timing whose enqueue outlasted the sleep is thrown away and
    taken again behind a sleep sized from that enqueue, at most three times:
    the host is shared, and one slow enqueue would otherwise end the run."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(3):
        if attempt:
            host_ms = enqueue_ms
        torch.cuda._sleep(int(4e6 * host_ms) + 100_000)  # ~2x the enqueue time at <= 2 GHz
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        b.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if enqueue_ms <= 2 * host_ms:
            break
    check(enqueue_ms <= 2 * host_ms,
          f"device_ms: enqueueing took {enqueue_ms:.3f} ms, longer than the sleep in front of it")
    return a.elapsed_time(b) / reps


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
        name = next((k for k in ("qe_block_corr_kernel", "qe_corr_reduce_kernel",
                                 "qe_block_sweep_kernel", "qe_suffix_resid_kernel",
                                 "dequant_matmul_tc_large_kernel",
                                 "dequant_matmul_tc_small_kernel", "dequant_matmul_reduce_kernel",
                                 "dequant_matmul_kernel", "paged_attention_kernel") if k in e.name),
                    "torch")
        by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by_kernel:
        return {}
    dev = sum(by_kernel.values())
    return dict(wall_ms=wall, device_ms=dev, busy=dev / wall, by_kernel=by_kernel)


def ptxas_summary(name: str) -> str:
    """Registers and spill stores of each kernel of library ``name``, from
    the ``-Xptxas -v`` report the build keeps: ``kernel<template args>
    regs/spill`` per entry, template args read from the mangled name."""
    import re

    from repro_torch.kernels import build

    out = []
    for chunk in build.ptxas_log(name).split("Compiling entry function '")[1:]:
        mangled = chunk.split("'", 1)[0]
        kernel = re.search(r"(qe_[a-z_]+_kernel)", mangled)
        targs = re.search(r"_kernelI(\w+?)EEv", mangled)
        args = []
        for num, flag, bf16 in re.findall(r"Li(\d+)E|Lb([01])E|(13__nv_bfloat16|f)",
                                          targs.group(1) if targs else ""):
            if num:
                args.append(num)
            elif flag:
                args.append("outlier" if flag == "1" else "plain")
            else:
                args.append("f32" if bf16 == "f" else "bf16")
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append(f"{kernel.group(1) if kernel else mangled}{'<' + ','.join(args) + '>' if args else ''} "
                   f"{regs.group(1) if regs else '?'} regs/{spill.group(1) if spill else '?'} B spill")
    return "; ".join(out)


def bound(n_bytes: float, n_flop: float, peak: float = PEAK_FP32) -> tuple[float, str]:
    t_b, t_f = n_bytes / PEAK_BYTES * 1e3, n_flop / peak * 1e3
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


def sweep_launches_on_path(p, bsz):
    """Kernel 1's launches at one solver group's shape in phase 5: p / B
    blocks per iteration, every iteration, layer and PTQ run whose engine
    sweeps blocks of B (QuantEase 256, qe_outlier OUTLIER_BLOCK)."""
    runs = sum(1 for m, _ in MAIN_RUNS
               if (m == "quantease" and bsz == QE_BLOCK) or (m == "qe_outlier" and bsz == OUTLIER_BLOCK))
    return p // bsz * PTQ_ITERATIONS * MAIN_OVERRIDES["n_periods"] * runs


def sweep_regs(summary, panel, rows):
    """``regs/spill`` of ``qe_block_sweep_kernel<panel,rows>`` in a
    :func:`ptxas_summary` line."""
    tag = f"qe_block_sweep_kernel<{panel},{rows}> "
    part = next((x for x in summary.split("; ") if x.startswith(tag)), None)
    return part[len(tag):] if part else "not in the build log"


def check_block_sweep(gen, dev, detail):
    """Kernel 1 at the six path shapes: against its plain version, every
    plan bit-identical to the planned one, the device time of every plan,
    the planned plan's call time, the plain version's, the bytes bound and
    the launches of the shape on the PTQ path; then the A/B line against the
    earlier kernel's time per call."""
    import torch

    from repro_torch.device import sm_count
    from repro_torch.kernels import quantease_cd as qcd
    from repro_torch.kernels import ops, ref

    summary = ptxas_summary("quantease_cd")
    plans = [(qcd.SWEEP_PANEL, r) for r in qcd.SWEEP_ROWS]
    detail["block_sweep"] = []
    record = None
    for G, q, p, bsz in SWEEP_SHAPES:
        s = cd_state(gen, G, q, bsz, dev)
        args = (s["base"], s["sig_t"], s["w"], s["scale"], s["zero"])
        kw = dict(n_levels=16, quantize=True)
        index = s["base"].device.index
        resident = [qcd.sweep_ctas_per_sm(index, r, bsz) for r in qcd.SWEEP_ROWS]
        plan = qcd.plan_sweep(G, q, bsz, sm_count(index), *resident)
        kn, kd = ops.quantease_block_sweep(*args, **kw)
        pn, pd = ref.quantease_block_sweep_t_ref(*args, **kw)
        torch.cuda.synchronize()
        frac_n, err_n = rows_within(kn, pn, CD_ATOL)
        frac_d, err_d = rows_within(kd, pd, CD_ATOL)
        check(min(frac_n, frac_d) >= ROWS_OK,
              f"block sweep G={G} q={q} B={bsz}: rows within {CD_ATOL}: {frac_n}, {frac_d}")
        plan_ms = {}
        for pl in plans:
            out = qcd.block_sweep_cuda(*args, **kw, sweep_plan=pl)
            check(torch.equal(out[0], kn) and torch.equal(out[1], kd),
                  f"block sweep G={G} q={q} B={bsz}: plan {pl} differs from the planned {plan}")
            plan_ms[f"{pl[0]}x{pl[1]}"] = device_ms(
                lambda: qcd.block_sweep_cuda(*args, **kw, sweep_plan=pl), 20)
        ms = plan_ms[f"{plan[0]}x{plan[1]}"]
        call = cuda_ms(lambda: ops.quantease_block_sweep(*args, **kw))
        plain = cuda_ms(lambda: ref.quantease_block_sweep_t_ref(*args, **kw), reps=5, warmup=1)
        n_bytes = 4 * (6 * G * bsz * q + G * bsz * bsz)
        n_flop = G * q * (bsz * (bsz - 1) + 8 * bsz)
        b_ms, b_by = bound(n_bytes, n_flop)
        launches = sweep_launches_on_path(p, bsz)
        regs = sweep_regs(summary, plan[0], plan[1])
        row = dict(G=G, q=q, p=p, B=bsz, plan=list(plan), ctas=qcd.sweep_ctas(G, q, plan[1]),
                   ctas_per_sm=dict(zip(qcd.SWEEP_ROWS, resident)), regs_spill=regs,
                   rows_ok=min(frac_n, frac_d), max_abs_err=max(err_n, err_d), ms=ms, call_ms=call, plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, launches_on_path=launches, plan_ms=plan_ms)
        detail["block_sweep"].append(row)
        print(f"[kernel] block_sweep G={G} q={q} B={bsz} (p={p}): plan {plan[0]}x{plan[1]} "
              f"({qcd.SWEEP_THREADS // plan[1]} lanes per row, {row['ctas']} CTAs; CTAs per SM "
              + ", ".join(f"{r} rows {n}" for r, n in zip(qcd.SWEEP_ROWS, resident))
              + f"; {regs}) "
              f"rows_ok={row['rows_ok']:.6f} max_abs_err={row['max_abs_err']:.3g} device "
              f"ms={ms:.4f} call_ms={call:.4f} plain_ms={plain:.3f} bound_ms={b_ms:.4f} ({b_by}) "
              f"launches on the PTQ path {launches}; every plan bit-identical, device ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in plan_ms.items()), flush=True)
        if (G, q, p, bsz) == OLD_SWEEP_SHAPE:
            record = row
            print(f"[A/B] block sweep G={G} q={q} B={bsz}, time per call with events: the kernel "
                  f"before the panels {OLD_SWEEP_CALL_MS:.3f} ms (PERF.md, kernel table) vs the panelled "
                  f"kernel {call:.4f} ms ({ms:.4f} ms device time)", flush=True)
        del s, args, kn, kd, pn, pd
    r = record
    return dict(max_abs_err=max(x["max_abs_err"] for x in detail["block_sweep"]), ms=r["ms"],
                call_ms=r["call_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=None,
                shape=f"G={r['G']} q={r['q']} B={r['B']} (plan {r['plan'][0]}x{r['plan'][1]}); "
                      "the other path shapes in block_sweep of the detail file")


def fused_bytes_flop(G, q, p, bsz, bf16):
    state = G * p * q * 4
    n_bytes = 5 * state + G * p * p * 4 + (G * p * p * 2 if bf16 else 0) + 3 * state
    n_flop = 2 * G * q * p * p + G * q * p * (bsz + 8)
    return n_bytes, n_flop


def print_profile(label, prof):
    print(f"[profile] {label}: " + (
        "no device time in the trace" if not prof else
        f"wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms "
        f"(busy {prof['busy']:.3f}): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(prof["by_kernel"].items()))), flush=True)


SGEMM_SUMS = ("corr_ms", "lib_corr_ms", "corr_flop", "corr_bound_ms",
              "suffix_ms", "lib_suffix_ms", "suffix_flop", "suffix_bound_ms")


def sgemm_layer(what, key, totals):
    """One decoder layer's SGEMM line: summed device ms, TFLOP/s and fp32
    bound, beside fp32 ``torch.matmul`` for the same products."""
    ms, lib, flop = totals[f"{key}_ms"], totals[f"lib_{key}_ms"], totals[f"{key}_flop"]
    return (f"{what} alone {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s), fp32 torch.matmul "
            f"{lib:.3f} ms ({flop / lib / 1e9:.1f} TFLOP/s), fp32 bound "
            f"{totals[f'{key}_bound_ms']:.3f} ms")


def corr_yardsticks(label, s, sig_corr, bsz, dh=None, reps=5):
    """The SGEMMs of kernels 2 and 4 at one shape, device time: the nb block
    corrections of one iteration alone (the C entry on this state, at the
    planner's plan and at two others; no sweeps), for kernel 4 (``dh``
    given) the suffix product alone, and fp32 ``torch.matmul`` (TF32 off)
    for the same products: ``Σ̃ᵀ[blk, :] @ Δ`` per block and
    ``Σ̃ᵀ[blk, blk0:] @ δŴ[blk0:]`` per block row.  Kernel 4 also times the
    alternative to staging dĤ in the correction: plain-Δ corrections plus
    one store of δŴ − dĤ per block (``torch.sub``, as a stand-in for a
    sweep that wrote it).  Returns a dict of ms, TFLOP/s and bounds."""
    import torch

    from repro_torch.device import sm_count
    from repro_torch.kernels import quantease_cd as qcd

    base, delta, sig32 = s["base"], s["delta"], s["sig_t"]
    G, p, q = base.shape
    dev = base.device
    bf16 = sig_corr.dtype == torch.bfloat16
    tile = qcd.corr_tile_rows(bsz)
    cps = qcd.ctas_per_sm(dev.index, tile, bf16, dh is not None)
    plan = qcd.plan_corr(G, q, bsz, p, sm_count(dev.index), cps)
    out = torch.empty_like(base)

    def corrections(plan, dh_t):
        part = torch.empty(plan[1] * G * bsz * q, device=dev) if plan[1] > 1 else None
        return lambda: [qcd.correction_cuda(sig_corr, delta, delta, base, out, col0=c, bsz=bsz,
                                            plan=plan, part=part, dh_t=dh_t)
                        for c in range(0, p, bsz)]

    row = dict(plan=list(plan), ctas_per_sm=cps, corr_ms=device_ms(corrections(plan, dh), reps))
    alts = {}
    for alt in sorted({(tile, 1), (tile, 2 * plan[1])} - {plan}):
        try:
            qcd.check_corr_plan(alt, p)
        except ValueError:
            continue
        alts[f"{alt[0]}x{alt[1]}"] = device_ms(corrections(alt, dh), reps)
    row["corr_alt_ms"] = alts
    blocks = [sig32[:, c:c + bsz] for c in range(0, p, bsz)]
    row["lib_corr_ms"] = device_ms(lambda: [torch.matmul(b, delta) for b in blocks], reps)
    corr_flop = 2 * G * q * p * p
    elem = 2 if bf16 else 4
    corr_bytes = G * p * p * elem + G * p * q * 4 * (3 if dh is None else 4)
    row["corr_flop"] = corr_flop
    row["corr_bound_ms"], _ = bound(corr_bytes, corr_flop)
    row["corr_tflops"] = corr_flop / row["corr_ms"] / 1e9
    row["lib_corr_tflops"] = corr_flop / row["lib_corr_ms"] / 1e9
    line = (f"[kernel] {label} corrections alone, plan {plan[0]}x{plan[1]} ({cps} CTAs/SM): "
            f"{row['corr_ms']:.3f} ms ({row['corr_tflops']:.1f} TFLOP/s; "
            + ", ".join(f"plan {k}: {v:.3f}" for k, v in alts.items())
            + f"), fp32 torch.matmul {row['lib_corr_ms']:.3f} ms ({row['lib_corr_tflops']:.1f} TFLOP/s), "
            f"fp32 bound {row['corr_bound_ms']:.3f} ms")
    if dh is not None:
        nb = p // bsz
        suf_flop = nb * (nb + 1) // 2 * 2 * bsz * bsz * q * G
        r = torch.empty_like(base)
        row["suffix_ms"] = device_ms(
            lambda: qcd.suffix_cuda(sig_corr, delta, base, r, bsz=bsz, tile_rows=plan[0]), reps)
        row["lib_suffix_ms"] = device_ms(
            lambda: [torch.matmul(sig32[:, c:c + bsz, c:], delta[:, c:]) for c in range(0, p, bsz)], reps)
        row["suffix_flop"] = suf_flop
        row["suffix_bound_ms"], _ = bound(G * p * p * elem / 2 + 3 * G * p * q * 4, suf_flop)
        row["suffix_tflops"] = suf_flop / row["suffix_ms"] / 1e9
        row["lib_suffix_tflops"] = suf_flop / row["lib_suffix_ms"] / 1e9
        row["corr_plain_delta_ms"] = device_ms(corrections(plan, None), reps)
        tmp = torch.empty_like(base)
        row["dh_store_ms"] = device_ms(lambda: [torch.sub(delta[:, c:c + bsz], dh[:, c:c + bsz],
                                                          out=tmp[:, c:c + bsz])
                                                for c in range(0, p, bsz)], reps)
        line += (f"; suffix alone {row['suffix_ms']:.3f} ms ({row['suffix_tflops']:.1f} TFLOP/s), "
                 f"fp32 torch.matmul {row['lib_suffix_ms']:.3f} ms ({row['lib_suffix_tflops']:.1f} "
                 f"TFLOP/s), fp32 bound {row['suffix_bound_ms']:.3f} ms; dĤ staged in the correction "
                 f"{row['corr_ms']:.3f} ms vs plain Δ {row['corr_plain_delta_ms']:.3f} ms + a δŴ − dĤ "
                 f"store per block {row['dh_store_ms']:.3f} ms")
    print(line, flush=True)
    return row


def check_fused_iteration(gen, dev, detail):
    import torch

    from repro_torch.core import quantease as qe
    from repro_torch.kernels import ops, ref
    from repro_torch.quant import GridSpec

    totals = dict(ms=0.0, plain_ms=0.0, bytes=0.0, flop=0.0, err=0.0, library_ms=0.0,
                  **dict.fromkeys(SGEMM_SUMS, 0.0))
    detail["fused_iteration"] = []
    for G, q, p, dt in FUSED_SHAPES:
        bsz = min(QE_BLOCK, p)
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
        sgemm = corr_yardsticks(f"fused_iteration G={G} ({q},{p}) B={bsz} {dt}", s, sig_corr, bsz)
        del s, args, sig_corr
        # 25 iterations from the same (W, Σ): kernel engine vs plain engine.
        w, sigma = cd_problem(gen, G, q, p, CD_TOKENS, dev)
        spec = GridSpec(bits=4)
        kw25 = dict(iterations=25, matmul_dtype=dt)
        t0 = time.monotonic()
        wk, _ = qe.quantease_quantize(w, sigma, spec, use_kernel="auto", **kw25)
        torch.cuda.synchronize()
        t_kernel = time.monotonic() - t0
        solve_split = device_profile(
            lambda: qe.quantease_quantize(w, sigma, spec, use_kernel="auto", **kw25))
        wp, _ = qe.quantease_quantize(w, sigma, spec, use_kernel="torch", **kw25)
        ek = qe.relative_error(w, wk, sigma)
        ep = qe.relative_error(w, wp, sigma)
        rel = float(((ek - ep).abs() / ep).max())
        check(rel <= 1e-3, f"25 iterations {G}x({q},{p}) {dt}: relative error {ek.tolist()} vs {ep.tolist()}")
        del w, sigma, wk, wp
        row = dict(G=G, q=q, p=p, dtype=dt, rows_ok=min(fracs), rows_differing=n_diff,
                   rows_unexplained=n_unexplained, tie_rows=ties, max_abs_err=max(errs), ms=ms,
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by, rel_err_kernel=ek.tolist(),
                   rel_err_plain=ep.tolist(), solve25_s=t_kernel, sgemm=sgemm,
                   solve25_profile=solve_split)
        detail["fused_iteration"].append(row)
        print(f"[kernel] fused_iteration G={G} ({q},{p}) {dt}: rows_ok={min(fracs):.6f} "
              f"(rows differing {n_diff}, not starting with a tie flip {n_unexplained}) "
              f"max_abs_err={max(errs):.3g} ms={ms:.3f} plain_ms={plain:.1f} bound_ms={b_ms:.3f} "
              f"({b_by}) 25-iter solve {t_kernel:.2f}s rel_err {ek.mean():.6f} vs plain {ep.mean():.6f}")
        print_profile(f"fused 25-iter solve G={G} ({q},{p}) {dt}", solve_split)
        if dt == "float32":  # one decoder layer's fp32 iteration: the three path groups
            totals["ms"] += ms
            totals["plain_ms"] += plain
            totals["bytes"] += n_bytes
            totals["flop"] += n_flop
            for k in ("corr_ms", "lib_corr_ms", "corr_flop", "corr_bound_ms"):
                totals[k] += sgemm[k]
            totals["library_ms"] += sgemm["lib_corr_ms"]
        totals["err"] = max(totals["err"], max(errs))
    b_ms, b_by = bound(totals["bytes"], totals["flop"])
    print(f"[kernel] fused_iteration, one decoder layer's fp32 iteration: ms={totals['ms']:.3f} "
          f"bound_ms={b_ms:.3f}; {sgemm_layer('corrections', 'corr', totals)}", flush=True)
    return dict(max_abs_err=totals["err"], ms=totals["ms"], plain_ms=totals["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=totals["library_ms"],
                corr_ms=totals["corr_ms"],
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
    totals = dict(ms=0.0, plain_ms=0.0, bytes=0.0, flop=0.0, err=0.0, library_ms=0.0,
                  **dict.fromkeys(SGEMM_SUMS, 0.0))
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
        sgemm = corr_yardsticks(f"outlier_iteration G={G} ({q},{p}) B={bsz} {dt}", s, sig_corr, bsz, dh)
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
                   solve25_s=t_kernel, iteration_profile=split, solve25_profile=solve_split,
                   sgemm=sgemm)
        detail["outlier_iteration"].append(row)
        print(f"[kernel] outlier_iteration G={G} ({q},{p}) B={bsz} {dt}: rows_ok={min(fracs):.6f} "
              f"(rows differing {n_diff}, not starting with a tie flip {n_unexplained}) "
              f"max_abs_err={max(errs):.3g} R rel err={r_err:.3g} ms={ms:.3f} plain_ms={plain:.1f} "
              f"bound_ms={b_ms:.3f} ({b_by}) topk_ms={topk_ms:.3f} 25-iter solve {t_kernel:.2f}s "
              f"rel_err {ek.mean():.6f} vs plain {ep.mean():.6f}", flush=True)
        for what, prof in (("iteration", split), ("25-iter solve", solve_split)):
            print_profile(f"outlier {what} G={G} ({q},{p}) {dt}", prof)
        if (G, q, p, dt) == OLD_TILE_SHAPE:
            new = solve_split.get("by_kernel", {}).get("qe_block_corr_kernel")
            print(f"[A/B] G={G} ({q},{p}) B={bsz} fp32 corrections per outlier iteration: the 64 x 64 "
                  f"tile {OLD_TILE_CORR_MS:.2f} ms (PERF.md §5: {OLD_TILE_SOLVE_CORR_MS:.0f} ms of "
                  f"qe_block_corr_kernel in a 25-iteration solve) vs the 128 x 128 tile "
                  f"{'not traced' if new is None else f'{new / 25:.2f} ms'} in this run's solve "
                  f"({sgemm['corr_ms']:.2f} ms alone)", flush=True)
        if dt == "float32":  # one decoder layer's fp32 iteration: the three path groups
            totals["ms"] += ms
            totals["plain_ms"] += plain
            totals["bytes"] += n_bytes
            totals["flop"] += n_flop
            for k in SGEMM_SUMS:
                totals[k] += sgemm[k]
            totals["library_ms"] += sgemm["lib_corr_ms"] + sgemm["lib_suffix_ms"]
        totals["err"] = max(totals["err"], max(errs))
    b_ms, b_by = bound(totals["bytes"], totals["flop"])
    print(f"[kernel] outlier_iteration, one decoder layer's fp32 iteration: ms={totals['ms']:.3f} "
          f"bound_ms={b_ms:.3f}; {sgemm_layer('corrections', 'corr', totals)}; "
          f"{sgemm_layer('suffix', 'suffix', totals)}", flush=True)
    return dict(max_abs_err=totals["err"], ms=totals["ms"], plain_ms=totals["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=totals["library_ms"],
                corr_ms=totals["corr_ms"], suffix_ms=totals["suffix_ms"],
                shape=f"one fp32 outlier-aware CD iteration of a decoder layer, B={bsz}: "
                + " + ".join(f"G={G} ({q},{p})" for G, q, p, dt in OUTLIER_SHAPES if dt == "float32"))


def check_dequant_matmul(gen, dev, detail):
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dequant_matmul import (
        SMALL_M_MAX,
        dequant_matmul_cuda,
        plan_dequant_matmul,
        split_for,
    )
    from repro_torch.quant import pack_codes

    m = GEMM_M
    detail["dequant_matmul"] = []
    err_max = 0.0
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def problem(m, q, p, n_groups):
        x = torch.randn(m, p, generator=gen, device=dev).to(torch.bfloat16)
        codes = torch.randint(0, 16, (q, p), generator=gen, device=dev, dtype=torch.uint8)
        scale = torch.rand(q, n_groups, generator=gen, device=dev) * 0.01 + 1e-3
        zero = torch.randint(0, 16, (q, n_groups), generator=gen, device=dev).float()
        return x, codes, scale, zero

    # Variants: uint8 / packed4 x per-channel / group 128, bf16 and fp32 out;
    # bf16 x (tc_large at m = 2048), then fp32 x (simt).
    vq, vp = GEMM_VARIANT_SHAPE
    for x_dtype in (torch.bfloat16, torch.float32):
        for packed4 in (False, True):
            for gsz in (None, 128):
                for out_dtype in (torch.bfloat16, torch.float32):
                    if x_dtype == torch.float32 and (packed4, out_dtype) != (True, torch.bfloat16):
                        continue  # the unchanged simt kernel: one configuration per grid
                    x, codes, scale, zero = problem(m, vq, vp, 1 if gsz is None else -(-vp // 128))
                    x = x.to(x_dtype)
                    kc = pack_codes(codes, 4) if packed4 else codes
                    before = dict(dequant_matmul_cuda.launches_by_variant)
                    y = ops.dequant_matmul(x, kc, scale, zero, packed4=packed4, out_dtype=out_dtype,
                                           group_size=gsz)
                    y_ref = ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.float32, group_size=gsz)
                    torch.cuda.synchronize()
                    took = [v for v, n in dequant_matmul_cuda.launches_by_variant.items() if n != before[v]]
                    err = float((y.float() - y_ref).abs().max())
                    tol = (1e-2 if out_dtype == torch.bfloat16 else 1e-4) * float(y_ref.abs().max())
                    check(err <= tol, f"dequant_matmul x={x_dtype} packed4={packed4} gsz={gsz} {out_dtype}: "
                          f"{err} > {tol}")
                    check(took == ["simt" if x_dtype == torch.float32 else "tc_large"],
                          f"dequant_matmul x={x_dtype} at m={m} took {took}")
                    err_max = max(err_max, err / float(y_ref.abs().max()))
                    print(f"[kernel] dequant_matmul (m={m}, {vq}, {vp}) x={str(x_dtype)[6:]} packed4={packed4} "
                          f"group={gsz} out={str(out_dtype)[6:]} variant={'/'.join(took)}: max_abs_err={err:.3g} "
                          f"(tol {tol:.3g})")
    # The path's own configuration (4-bit packed, per-channel, bf16) at its
    # three shapes, weighted by launches per decoder layer (wq wk wv wo; wg
    # wu; wd), at the eval batch (m = 2048), a prefill chunk (128) and the
    # decode batch (8).  Bounds: bytes at 3.35 TB/s against bf16 operations
    # on the tensor cores (the variant's peak) and, beside them, fp32 at 67
    # TFLOP/s.  library_ms is fp32 cuBLAS on the dequantized weight;
    # library_bf16_ms is cuBLAS bf16 on (c − z), times s: the same factored
    # function.  ms and the library times are device times (the profiler's:
    # at m = 8 the wrapper's host work is longer than its kernels);
    # call_ms and library_call_ms time each call with events, host included.
    detail["dequant_matmul_path"] = []
    layers = {}
    for mm in (GEMM_M, GEMM_PREFILL_M, GEMM_DECODE_M):
        reps = 10 if mm == GEMM_M else 50
        tot = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0, library_call_ms=0.0,
                   library_bf16_ms=0.0, bytes=0.0, flop=0.0)
        for (q, p), count in GEMM_PATH_SHAPES:
            x, codes, scale, zero = problem(mm, q, p, 1)
            kc = pack_codes(codes, 4)
            run = lambda: ops.dequant_matmul(x, kc, scale, zero, packed4=True, out_dtype=torch.bfloat16)
            variant, split = plan_dequant_matmul(mm, q, p, None, torch.bfloat16, n_sm)
            y = run()
            y_ref = ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.float32)
            torch.cuda.synchronize()
            err = float((y.float() - y_ref).abs().max())
            check(err <= 1e-2 * float(y_ref.abs().max()), f"dequant_matmul path shape m={mm} ({q},{p}): {err}")
            y32 = ops.dequant_matmul(x, kc, scale, zero, packed4=True, out_dtype=torch.float32)
            err32 = float((y32 - y_ref).abs().max())
            check(err32 <= 1e-4 * float(y_ref.abs().max()),
                  f"dequant_matmul path shape m={mm} ({q},{p}) fp32 out: {err32}")
            if split > 1:  # split-K partials are summed in a fixed order: a repeat is bit-identical
                check(torch.equal(y32, ops.dequant_matmul(x, kc, scale, zero, packed4=True,
                                                          out_dtype=torch.float32)),
                      f"dequant_matmul m={mm} ({q},{p}) split {split}: a repeat differs")
            ms, call = device_ms(run, reps), cuda_ms(run, reps=reps)
            plain = cuda_ms(lambda: ops_plain(x, kc, scale, zero), reps=reps)
            xf, wt = x.float(), ((codes.float() - zero) * scale).T.contiguous()
            lib_fn = lambda: torch.matmul(xf, wt)
            lib, lib_call = device_ms(lib_fn, reps), cuda_ms(lib_fn, reps=reps)
            wb, s_row = (codes.float() - zero).bfloat16().T.contiguous(), scale[:, 0]
            lib16 = device_ms(lambda: torch.matmul(x, wb) * s_row, reps)
            del xf, wt, wb
            n_bytes = mm * p * 2 + q * p // 2 + 2 * q * 4 + mm * q * 2
            n_flop = 2 * mm * q * p
            b_ms, b_by = bound(n_bytes, n_flop, PEAK_BF16_TC if variant != "simt" else PEAK_FP32)
            b32, _ = bound(n_bytes, n_flop)
            detail["dequant_matmul_path"].append(dict(
                m=mm, q=q, p=p, variant=variant, split=split, ms=ms, call_ms=call, plain_ms=plain,
                library_ms=lib, library_call_ms=lib_call, library_bf16_ms=lib16, bound_ms=b_ms, bound_by=b_by, bound_fp32_ms=b32, per_layer=count,
                max_abs_err=err, max_abs_err_fp32=err32))
            print(f"[kernel] dequant_matmul path (m={mm}, {q}, {p}) packed4 bf16 {variant}/{split}: "
                  f"ms={ms:.4f} call_ms={call:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"library_call_ms={lib_call:.4f} library_bf16_ms={lib16:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) fp32 bound {b32:.4f} max_abs_err={err:.3g} fp32 out "
                  f"{err32:.3g}", flush=True)
            for k, v in (("ms", ms), ("call_ms", call), ("plain_ms", plain), ("library_ms", lib),
                         ("library_call_ms", lib_call), ("library_bf16_ms", lib16), ("bytes", n_bytes),
                         ("flop", n_flop)):
                tot[k] += count * v
            variants = tot.setdefault("variants", [])
            variants.append(f"{variant}/{split}")
        tot["bound_ms"], tot["bound_by"] = bound(tot["bytes"], tot["flop"], PEAK_BF16_TC)
        tot["bound_fp32_ms"], _ = bound(tot["bytes"], tot["flop"])
        layers[mm] = tot
        print(f"[kernel] dequant_matmul, one decoder layer's 7 linears at m={mm} ({', '.join(tot['variants'])}): "
              f"ms={tot['ms']:.4f} call_ms={tot['call_ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
              f"library_ms={tot['library_ms']:.4f} library_call_ms={tot['library_call_ms']:.4f} "
              f"library_bf16_ms={tot['library_bf16_ms']:.4f} bound_ms={tot['bound_ms']:.4f} "
              f"({tot['bound_by']}, bf16 tensor cores) fp32 bound {tot['bound_fp32_ms']:.4f}", flush=True)
    detail["dequant_matmul_layer"] = layers
    # The threshold between the tiles: both, pinned at their planned splits,
    # per decoder layer at m = 64 (tc_small's largest) and 128 (a prefill
    # chunk), device time.
    tiles = {}
    for mm in (SMALL_M_MAX, GEMM_PREFILL_M):
        for variant in ("tc_small", "tc_large"):
            t = 0.0
            for (q, p), count in GEMM_PATH_SHAPES:
                x, codes, scale, zero = problem(mm, q, p, 1)
                kc = pack_codes(codes, 4)
                plan = (variant, split_for(variant, mm, q, p, n_sm))
                t += count * device_ms(lambda: dequant_matmul_cuda(x, kc, scale, zero, packed4=True,
                                                                   plan=plan), 50)
            tiles[f"m={mm} {variant}"] = t
        print(f"[kernel] dequant_matmul tiles at m={mm}, per decoder layer (device ms): "
              f"tc_small {tiles[f'm={mm} tc_small']:.4f}, tc_large {tiles[f'm={mm} tc_large']:.4f}; "
              f"the plan takes {plan_dequant_matmul(mm, 3072, 3072, None, torch.bfloat16, n_sm)[0]}",
              flush=True)
    detail["dequant_matmul_tiles"] = tiles
    for mm in (GEMM_M, GEMM_DECODE_M):
        check(layers[mm]["ms"] <= layers[mm]["library_ms"],
              f"dequant_matmul at m={mm}: {layers[mm]['ms']} ms of device time per layer, slower "
              f"than fp32 cuBLAS on the dequantized weight ({layers[mm]['library_ms']} ms)")
    big = layers[GEMM_M]
    return dict(max_abs_err=err_max, ms=big["ms"], call_ms=big["call_ms"], plain_ms=big["plain_ms"],
                bound_ms=big["bound_ms"],
                bound_by=big["bound_by"], library_ms=big["library_ms"],
                library_bf16_ms=big["library_bf16_ms"],
                shape=f"one decoder layer's 7 linears at m={m}, 4-bit packed per-channel, bf16 x "
                f"({', '.join(big['variants'])})")


def ops_plain(x, kc, scale, zero):
    """The plain path of the serving GEMM on the card: unpack, dequantize,
    fp32 product (what ops.dequant_matmul does for CPU tensors)."""
    from repro_torch.kernels import ref
    from repro_torch.quant import unpack_codes

    import torch

    codes = unpack_codes(kc, 4, kc.shape[-1] * 2)
    return ref.dequant_matmul_ref(x, codes, scale, zero, out_dtype=torch.bfloat16)


def paged_problem(gen, dev, B, KVp, G, hd, max_len, kind):
    """Phase 3's kernel-5 inputs: bf16 pages quantized as the engine writes
    them (``_kv_quantize`` / ``_kv_quantize4``), each sequence on its own
    pages, table entries past its length on the null page 0."""
    import torch

    from repro_torch.models import model as M

    n_pgs = -(-max_len // PAGE)
    P = 1 + B * n_pgs
    q = torch.randn(B, KVp, G, hd, generator=gen, device=dev).to(torch.bfloat16)
    if max_len == 1536:  # the serving shape: lengths drawn from 1..1536
        lengths = torch.randint(1, max_len + 1, (B,), generator=gen, device=dev)
    else:
        lengths = torch.full((B,), max_len, device=dev)
    kv = [torch.randn(P, PAGE, KVp, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2)]
    scales = [None, None]
    if kind != "bf16":
        quantize = M._kv_quantize4 if kind == "int4" else M._kv_quantize
        (k, ks), (v, vs) = quantize(kv[0]), quantize(kv[1])
        kv, scales = [k, v], [ks, vs]
    pages = torch.arange(1, P, device=dev, dtype=torch.int32).reshape(B, n_pgs)
    used = (lengths[:, None] + PAGE - 1) // PAGE
    table = torch.where(torch.arange(n_pgs, device=dev)[None] < used, pages, 0).to(torch.int32)
    return dict(q=q, k_pages=kv[0], v_pages=kv[1], page_table=table,
                lengths=lengths.to(torch.int32), k_scale_pages=scales[0], v_scale_pages=scales[1])


def paged_bytes_flop(d, kind, window):
    """Kernel 5's least traffic and work: each valid K/V row (and its scales)
    read once, q read and the output written once; 4·G·hd flop per valid
    position and kv head (the two dots)."""
    B, KVp, G, hd = d["q"].shape
    lengths = d["lengths"].long()
    rows = int((lengths if window is None else lengths.clamp(max=window)).sum())
    row_bytes = KVp * (hd * {"bf16": 2, "int8": 1, "int4": 0.5}[kind] + (4 if kind != "bf16" else 0))
    n_bytes = 2 * rows * row_bytes + 2 * B * KVp * G * hd * 2
    return n_bytes, 4 * G * hd * KVp * rows


def sdpa_yardstick(d):
    """The bf16 K/V of ``d`` gathered contiguous, and one
    ``scaled_dot_product_attention`` call over it with a length mask (the
    port never calls it)."""
    import torch
    import torch.nn.functional as F

    B, KVp, G, hd = d["q"].shape
    S = d["page_table"].shape[1] * PAGE
    gather = lambda pages: pages[d["page_table"].long()].reshape(B, S, KVp, hd).transpose(1, 2).contiguous()
    k, v = gather(d["k_pages"]), gather(d["v_pages"])
    q = d["q"].reshape(B, KVp * G, 1, hd)
    if G > 1:
        k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    mask = (torch.arange(S, device=k.device)[None] < d["lengths"][:, None])[:, None, None]
    return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))


def check_paged_attention(gen, dev, detail):
    import torch

    from repro_torch.kernels import ops, ref

    detail["paged_attention"] = []
    err_max, row_of_path = 0.0, None
    for label, B, KVp, G, hd, max_len, window, cap, kinds in PAGED_SHAPES:
        for kind in kinds:
            d = paged_problem(gen, dev, B, KVp, G, hd, max_len, kind)
            call = lambda fn: fn(d["q"], d["k_pages"], d["v_pages"], d["page_table"], d["lengths"],
                                 window=window, attn_softcap=cap, k_scale_pages=d["k_scale_pages"],
                                 v_scale_pages=d["v_scale_pages"])
            out = call(ops.paged_attention)
            want = call(ref.paged_attention_ref)
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            check(bool(torch.isfinite(out.float()).all()) and err <= PAGED_ATOL,
                  f"paged_attention {label} {kind}: max abs err {err} > {PAGED_ATOL}")
            err_max = max(err_max, err)
            ms = cuda_ms(lambda: call(ops.paged_attention), reps=20)
            # The kernel's own device time: at the serving shape it is shorter
            # than the wrapper's host work, which the events above include.
            prof = device_profile(lambda: [call(ops.paged_attention) for _ in range(20)])
            dev_ms = prof.get("by_kernel", {}).get("paged_attention_kernel")
            dev_ms = None if dev_ms is None else dev_ms / 20
            plain = cuda_ms(lambda: call(ref.paged_attention_ref), reps=5, warmup=1)
            lib = sdpa_yardstick(d) if kind == "bf16" else None
            n_bytes, n_flop = paged_bytes_flop(d, kind, window)
            b_ms, b_by = bound(n_bytes, n_flop)
            row = dict(shape=label, B=B, KVp=KVp, G=G, hd=hd, max_len=max_len, window=window,
                       softcap=cap, kind=kind, tokens=int(d["lengths"].sum()), max_abs_err=err, ms=ms,
                       device_ms=dev_ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by, bytes=n_bytes)
            detail["paged_attention"].append(row)
            print(f"[kernel] paged_attention {label} B={B} KVp={KVp} G={G} hd={hd} {kind} "
                  f"(window {window}, softcap {cap}, {row['tokens']} tokens): max_abs_err={err:.3g} "
                  f"ms={ms:.4f} device_ms={dev_ms if dev_ms is None else round(dev_ms, 4)} plain_ms={plain:.3f} "
                  f"library_ms={lib if lib is None else round(lib, 4)} "
                  f"bound_ms={b_ms:.4f} ({b_by})", flush=True)
            if (label, kind) == ("serving", "bf16"):
                row_of_path = row
            del d, out, want
            torch.cuda.empty_cache()
    # The kernel's time is its device time (the profiler's); ``call_ms`` is the
    # wrapper call timed with events, host work included.
    r = row_of_path
    return dict(max_abs_err=err_max, ms=r["device_ms"] if r["device_ms"] is not None else r["ms"],
                call_ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                shape="one decode step's attention at the serving shape: 8 sequences of 1-1536 "
                      "tokens, 32 kv heads of 96, bf16 pages of 16")


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
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
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
        pcfg = solver.PTQConfig(method=method, spec=GridSpec(bits=bits), iterations=PTQ_ITERATIONS, emit="qt",
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
        if label == SERVED_RUN:
            artifact = served
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
    variants = dict(dequant_matmul_cuda.launches_by_variant)
    print(f"[main] launches during the main path: {counts}; dequant_matmul by variant {variants}  "
          f"({t_main:.1f}s)")
    for name, n in counts.items():
        check(n > 0 or name == "paged_attention", f"kernel {name} was not launched on the main path")
    check(variants["simt"] == 0 and variants["tc_large"] > 0,
          f"the bf16 main path's dequant-GEMMs took {variants}: tensor-core variants only expected")
    detail["main"] = dict(
        layers={m: dict(zip(r[0], map(float, r[0].values()))) for m, r in results.items()},
        ppl={m: r[1] for m, r in results.items()} | {"dense": dense_ppl},
        seconds_per_run={m: r[2] for m, r in results.items()},
        blocks=blocks,
        seconds=t_main,
    )
    return counts, plan, artifact


# ---------------------------------------------------------------------------
# Phase 6: serving the QuantEase artifact at full width
# ---------------------------------------------------------------------------


def serve_traffic(vocab: int) -> list:
    """24 prompts of 16-1024 tokens (numpy seed 0); 4 prompts longer than
    the prefix, spread over the arrival order so that later ones arrive
    after an earlier one has prefilled, share a 256-token prefix."""
    import numpy as np

    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE_PROMPT_LO, SERVE_PROMPT_HI + 1, SERVE_REQUESTS)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lengths]
    prefix = rng.integers(0, vocab, SERVE_PREFIX).astype(np.int32)
    long = [i for i, p in enumerate(prompts) if len(p) > SERVE_PREFIX + PAGE]
    for i in long[:: max(len(long) // SERVE_N_SHARED, 1)][:SERVE_N_SHARED]:
        prompts[i][:SERVE_PREFIX] = prefix
    return prompts


def serve_run(label, make_engine, prompts):
    """Submit every prompt at once, run to the end, and collect the run's
    numbers (engine-clock times: ``time.monotonic``)."""
    import numpy as np
    import torch

    from repro_torch.serve import Request

    eng = make_engine()
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW_TOKENS))
    fin = eng.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    reqs = sorted(fin, key=lambda r: r.rid)
    ttft = np.array([r.first_token_t - r.submit_t for r in reqs]) * 1e3
    n_tok = sum(len(r.output) for r in reqs)
    paged = hasattr(eng, "pool")
    stats = dict(
        run=label, requests=len(reqs), wall_s=wall, tokens=n_tok,
        decode_steps=eng.n_decode_steps, decode_s=eng.decode_seconds,
        decode_tok_s=n_tok / eng.decode_seconds, e2e_tok_s=n_tok / wall,
        ms_per_step=eng.decode_seconds / eng.n_decode_steps * 1e3,
        ttft_p50_ms=float(np.median(ttft)), ttft_p90_ms=float(np.percentile(ttft, 90)),
        prefill_chunks=eng.n_prefill_chunks if paged else eng.n_prefills,
        prefill_s=eng.prefill_seconds if paged else None,
        prefix_hit_tokens=eng.n_prefix_hit_tokens if paged else 0,
        preemptions=eng.n_preemptions if paged else 0,
        kv_read_bytes=eng.kv_read_bytes() if paged else None,
        statuses=sorted({r.status for r in reqs}),
    )
    print(f"[serve] {label}: {stats['requests']} requests, {n_tok} tokens in {wall:.2f}s; "
          f"decode {stats['decode_tok_s']:.1f} tok/s, {stats['ms_per_step']:.2f} ms/step over "
          f"{eng.n_decode_steps} steps; TTFT p50 {stats['ttft_p50_ms']:.1f} ms p90 "
          f"{stats['ttft_p90_ms']:.1f} ms; prefill chunks {stats['prefill_chunks']}; prefix-hit "
          f"tokens {stats['prefix_hit_tokens']}; preemptions {stats['preemptions']}; "
          f"kv_read_bytes {stats['kv_read_bytes']}; statuses {stats['statuses']}", flush=True)
    outputs = {r.rid: r.output for r in reqs}
    return stats, outputs, eng


def agree_under_margin(trace_a, trace_b, out_a, out_b, tol_of):
    """Per request: the number of leading tokens compared, and whether they
    agree up to the first step where either run's top-2 margin is below
    ``tol_of(logits)`` (a near-tie there may go either way)."""
    import numpy as np

    bad = []
    for rid in out_a:
        for j, (la, lb) in enumerate(zip(trace_a[rid], trace_b[rid])):
            if min(np.diff(np.sort(l)[-2:])[0] for l in (la, lb)) < tol_of(la):
                break
            if out_a[rid][j] != out_b[rid][j]:
                bad.append((rid, j))
                break
    return bad


def serving(dev, detail, plan, artifact):
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServingEngine, ServingEngine

    cfg = plan.cfg
    prompts = serve_traffic(cfg.vocab)
    plans = {kv: M.make_plan(cfg, kv_cache_dtype=kv) for kv in ("bf16", "int8", "int4")}
    ample = 1 + SERVE_PAGED["max_batch"] * -(-SERVE_PAGED["max_seq"] // PAGE)
    small = int(SERVE_SMALL_POOL * ample)
    paged = lambda kv, **kw: lambda: PagedServingEngine(plans[kv], artifact, device=dev,
                                                         **SERVE_PAGED, **kw)
    runs = (
        ("paged bf16", paged("bf16", record_logits=True)),
        ("paged bf16 repeat", paged("bf16")),
        ("paged int8", paged("int8", record_logits=True)),
        ("paged int4", paged("int4", record_logits=True)),
        (f"paged bf16, {small} of {ample} pages", paged("bf16", n_pages=small)),
        ("contiguous bf16", lambda: ServingEngine(plans["bf16"], artifact, device=dev,
                                                  record_logits=True, **SERVE_CONTIG)),
    )
    ops.reset_launch_counts()
    t_serve = time.monotonic()
    res = {}
    for label, make in runs:
        res[label] = serve_run(label, make, prompts)
    t_serve = time.monotonic() - t_serve
    counts = ops.launch_counts()
    variants = dict(dequant_matmul_cuda.launches_by_variant)
    print(f"[serve] launches during serving: {counts}; dequant_matmul by variant {variants}  "
          f"({t_serve:.1f}s)", flush=True)
    # Where a paged bf16 run's time goes: its first 8 requests under the
    # profiler (device busy share, device time by kernel); not counted above.
    prof = device_profile(lambda: serve_run("paged bf16, 8 requests, profiled", paged("bf16"),
                                            prompts[:SERVE_PAGED["max_batch"]]))
    print("[profile] paged bf16 serving: " + (
        "no device time in the trace" if not prof else
        f"wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms (busy {prof['busy']:.3f}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(prof["by_kernel"].items()))), flush=True)

    for label, (stats, outputs, eng) in res.items():
        allowed = {"completed", "preempted_resumed"} if "pages" in label else {"completed"}
        check(stats["requests"] == SERVE_REQUESTS and set(stats["statuses"]) <= allowed
              and all(len(o) == SERVE_NEW_TOKENS for o in outputs.values()),
              f"{label}: requests {stats['requests']}, statuses {stats['statuses']}")
    small_label = runs[4][0]
    check(res[small_label][0]["preemptions"] >= 1, f"{small_label}: no preemption")
    check(res["paged bf16 repeat"][1] == res["paged bf16"][1], "the repeat bf16 paged run gave other tokens")
    bf, contig = res["paged bf16"][2], res["contiguous bf16"][2]
    first = lambda eng: {rid: tr[0] for rid, tr in eng.logit_trace.items()}
    f_bf, f_ct = first(bf), first(contig)
    scale = max(float(np.abs(l).max()) for l in f_ct.values())
    d_ct = max(float(np.abs(f_bf[i] - f_ct[i]).max()) for i in f_ct)
    bad = agree_under_margin(contig.logit_trace, bf.logit_trace, res["contiguous bf16"][1],
                             res["paged bf16"][1], lambda l: SERVE_LOGIT_TOL * float(np.abs(l).max()))
    same = np.mean([res["paged bf16"][1][i] == res["contiguous bf16"][1][i] for i in range(SERVE_REQUESTS)])
    d_q = {kv: max(float(np.abs(first(res[f"paged {kv}"][2])[i] - f_bf[i]).max()) for i in f_bf)
           for kv in ("int8", "int4")}
    paged_steps = sum(r[0]["decode_steps"] for label, r in res.items() if label.startswith("paged"))
    print(f"[serve] paged bf16 vs contiguous: first-decode max |Δ logit| {d_ct:.4g} (max |logit| "
          f"{scale:.4g}, tolerance {SERVE_LOGIT_TOL * scale:.4g}); identical outputs "
          f"{same:.3f} of requests; tokens parting above the margin: {bad}; KV quantization "
          f"max |Δ logit| int8 {d_q['int8']:.4g}, int4 {d_q['int4']:.4g} (bound "
          f"{SERVE_KV_BOUND * scale:.4g})", flush=True)
    check(d_ct <= SERVE_LOGIT_TOL * scale,
          f"paged vs contiguous first-decode logits differ by {d_ct} (max |logit| {scale})")
    check(not bad, f"paged vs contiguous tokens part above the margin at {bad}")
    check(d_q["int8"] < d_q["int4"] < SERVE_KV_BOUND * scale,
          f"KV quantization perturbs first-decode logits by {d_q} (max |logit| {scale})")
    check(counts["paged_attention"] == paged_steps * cfg.n_periods * len(cfg.pattern),
          f"paged_attention launched {counts['paged_attention']} times for {paged_steps} paged "
          f"decode steps x {cfg.n_periods} periods")
    check(counts["dequant_matmul"] > 0, "the serving GEMM did not launch while serving")
    check(variants["simt"] == 0 and variants["tc_small"] > 0,
          f"serving's dequant-GEMMs took {variants}: the decode steps must run tc_small, and "
          "nothing simt")
    detail["serving"] = dict(
        runs=[r[0] for r in res.values()], seconds=t_serve, launches=counts, gemm_variants=variants,
        first_decode_max_diff_contiguous=d_ct, logit_scale=scale, identical_share=float(same),
        kv_quant_max_diff=d_q, prompt_lengths=[len(p) for p in prompts], profile=prof,
    )
    for eng in (r[2] for r in res.values()):
        eng.logit_trace.clear()
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
    print(f"[build] quantease_cd, -Xptxas -v: {ptxas_summary('quantease_cd')}", flush=True)

    detail = {"card": card}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    measured = {
        "quantease_block_sweep": check_block_sweep(gen, dev, detail),
        "quantease_fused_iteration": check_fused_iteration(gen, dev, detail),
        "quantease_outlier_iteration": check_outlier_iteration(gen, dev, detail),
        "dequant_matmul": check_dequant_matmul(gen, dev, detail),
        "paged_attention": check_paged_attention(gen, dev, detail),
    }
    torch.cuda.empty_cache()
    card_tests()
    torch.cuda.empty_cache()
    counts_ptq, plan, artifact = main_path(dev, detail)
    expected = sum(x["launches_on_path"] for x in detail["block_sweep"])
    check(counts_ptq["quantease_block_sweep"] == expected,
          f"kernel 1 launched {counts_ptq['quantease_block_sweep']} times on the PTQ path, "
          f"phase 3's launches per shape sum to {expected}")
    print(f"[main] kernel 1's launches on the PTQ path {counts_ptq['quantease_block_sweep']} = the "
          f"sum of phase 3's launches per shape", flush=True)
    counts_serve = serving(dev, detail, plan, artifact)
    # Each path's counts were read just after it ran, from 0.
    counts = {k: counts_ptq[k] + counts_serve[k] for k in counts_ptq}
    detail["launches"] = dict(ptq=counts_ptq, serving=counts_serve)

    kernels = []
    for name, (_, source, replaces) in ops.KERNELS.items():
        m = measured[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=counts[name],
            max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=m["library_ms"],
            shape=m["shape"],
            **{k: m[k] for k in ("call_ms", "library_bf16_ms", "corr_ms", "suffix_ms") if k in m},
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
