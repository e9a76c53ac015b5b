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
   int4 pages, at a long shape (32 x 4096 tokens, bf16 and int4), at a GQA
   shape with a window and a softcap and at one sequence of 4096 tokens,
   each under its planned split and a second plan, with its device time
   (split and combine kernels summed) against the bound, SDPA and, per byte,
   the earlier kernel's; last, QuantEase's legacy schedule (kernel 1 alone
   per block, fp32 ``torch.matmul`` corrections) at the three solver groups,
   B = 128: one iteration on the kernel path against the plain path and
   against one fused iteration (rows outside verified tie flips), then
   25-iteration solves against the fused engine's, with kernel 1's launches
   held to n_blocks x 25, ms per layer iteration and device time by kernel,
   and Algorithm 3's legacy schedule at G=1 (3072, 8192), 3 bits, 1 %,
   within 1 % of the fused engine's error;
4. small-input reference: ``tests/test_torch_cuda.py`` on the card, where a
   reduced Phi-3 quantized and scored on the card (kernels) and on the CPU
   (plain versions) must agree, and each kernel matches its plain version
   at small and ragged shapes;
5. main path: Phi-3-mini at full width (2 of 32 decoder layers, seeded
   random weights): RTN, GPTQ and QuantEase PTQ at 4 bits, then RTN, GPTQ,
   QuantEase, outlier-aware QuantEase (1 % outliers), AWQ, AWQ+QuantEase
   and SpQR (1 %) at 3 bits, each
   through the serving restack and ``eval_model`` (perplexity, top-1/top-5,
   choice accuracy and margin, ``EvalBudget``'s defaults), with each
   method's seconds per decoder layer; mean relative error must order
   quantease < gptq < rtn at 4 and at 3 bits, qe_outlier < quantease <
   rtn, quantease < awq <= rtn and qe_outlier < spqr at 3 bits (AWQ+QuantEase
   against QuantEase is recorded), the zero points of the AWQ, AWQ+QuantEase
   and SpQR artifacts (grids re-derived from Ŵ) integers in [0, 7], the
   outlier artifact must carry its COO planes, every PTQ
   kernel's launch counter must rise, and the dequant-GEMM must run
   tensor-core variants only (no simt launch);
5b. training at full width: a ``Trainer`` on the phase-5 model (bf16 params
   on the card, fp32 AdamW moments) takes 8 steps at batch 4 x 512 of the
   synthetic corpus: every loss finite and the last below the first, ms per
   step after the first, and training's own peak memory (above what the
   earlier phases left allocated, per step); then one checkpoint of that
   state is saved (to a temporary directory) and restored, held bit for bit;
6. serving: the 4-bit QuantEase artifact of phase 5 answers 24 requests
   (prompts of 16-1024 tokens, 4 sharing a 256-token prefix, 32 new tokens
   each) on the paged engine with bf16, int8 and int4 KV, again on bf16
   (repeat: same tokens), on bf16 with 40 % of the pages (preemption), and on
   the contiguous engine; paged and contiguous first-decode logits must agree,
   kernel 5 must launch once per decode step and period, and the decode
   steps' GEMMs must run tc_small (no simt launch); then 8 users at
   3584-4032 tokens of context (16 new tokens each) under the profiler:
   decode ms per step, busy share, kernel 5's device time against the
   dequant-GEMM's, and kernel 5's launches held to decode steps x periods;
7. the quality table (the reference's ``benchmarks/bench_eval.py`` at its
   full budget): ``bench_opt_s`` trained 1,600 steps at batch 16 x 96, then
   ``run_grid`` over RTN, GPTQ and QuantEase at 4 and 3 bits and qe_outlier
   (2 %) at 3 bits (25 iterations, 24 calibration batches of 4 x 96, 24
   eval batches) and ``quantized_parity`` (prompts of 5, 13 and 29 tokens);
   the document goes to ``chiprun_out/BENCH_port_eval.json``.  It must pass
   ``validate_doc``'s schema and parity-tolerance checks (the perplexity
   orderings and paged == contiguous bitwise are recorded, not checked),
   dense perplexity must lie within 1.10 x the corpus entropy floor's,
   mean layer errors must order quantease < gptq < rtn at both widths and
   qe_outlier < quantease at 3 bits, paged against contiguous first-decode
   logits within 2 % of max |logit|, and every kernel must launch.  Each
   kernel is then held against its plain version at phase 7's own shapes,
   on the inputs phase 7 gave it (one kept call per signature: the CD
   iterations and every block sweep in them, each dequant-GEMM shape and
   variant, each paged-attention call shape), at phase 3's tolerances;
8. the command-line path at full width: ``repro_torch.launch.train``,
   ``quantize``, ``eval`` and ``serve`` called in process on Phi-3-mini cut
   to 2 of 32 decoder layers (registered as ``phi3_mini_3_8b_2l``), in a
   temporary directory checked for free space first: 4 training steps at 4
   x 512 (every loss finite, 4 checkpoints); QuantEase at 4 bits, then SpQR
   at 3 bits with ``--resume`` (14 layers, finite errors, one
   ``progress.jsonl`` record a block, the QuantEase report within 1e-3 per
   layer of ``ptq_quantize_model`` on the same params and batches); the
   eval grid (RTN, AWQ, SpQR, QuantEase, qe_outlier at 3 bits) and parity,
   whose document must pass ``validate_doc``'s schema, every kernel
   launched and held against its plain version on the eval's own calls;
   serving the quantize output on the paged engine (bf16, a repeat with
   the same tokens, int4 KV) and the contiguous one, every request complete
   and kernel 5 launched once per decode step and period.  Each step's wall
   seconds are printed; the CLIs' output goes to
   ``chiprun_out/chip_smoke_cli.txt``;
9. speculation and the tuner at full width: (a) phase 5's ``quantease@4``
   artifact serves phase 6's first 8 prompts (32 new tokens each) on the
   paged engine (bf16 KV, pages of 16, chunks of 128, a pool of twice the
   ample default) with γ = 4 and no draft, the target itself, a 3-bit RTN
   draft of the dense params and the 1-period truncation: decode tokens/s,
   rounds, proposed and accepted tokens, propose calls, ms per round, free
   pages before and after (equal: no leak), kernel 3's variants in the
   verify (tc_small only) and in the draft, kernel 5's launches held to
   (verify rounds + propose steps) x periods, no round with budget that
   proposed fewer than min(γ, budget), every speculative stream equal to
   the plain one up to the first position whose top-2 margin (plain run)
   is below ``SERVE_LOGIT_TOL`` of max |logit|, and the self-draft rejected
   only at such margins; (b) phase 7's trained ``bench_opt_s`` with a
   3-bit RTN and a 1-period draft (acceptance recorded, the same stream
   rule); then one verify call (8 lanes x 5 positions) against 5
   sequential decode steps within ``SERVE_LOGIT_TOL`` of max |logit|, and
   that call's and one RTN draft call's kernel 3 and 5 launches against
   their plain versions; (c) ``repro_torch.launch.tune`` on phase 8's
   training checkpoint (budget 3 bits, widths 2, 3, 4, 8, 10 iterations),
   the winner's perplexity at most the uniform candidate's, kernel 3
   launched by every candidate's artifact, kernels 1 and 2 by the solves,
   then ``--resume`` replaying every candidate; then ``launch.serve`` on
   the tuner's output, plain and with ``--speculate --draft-bits 3`` and
   ``--speculate --draft-layers 1``, held to the plain tokens by the same
   rule (output in ``chiprun_out/chip_smoke_tune_cli.txt``).

The second-to-last line is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.  Per-shape details go to
``chiprun_out/chip_smoke_detail.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# Phase 3's legacy rows: QuantEase's pre-fused schedule (kernel 1 alone, a
# torch.matmul correction between launches) at the three solver groups.
LEGACY_SHAPES = ((4, 3072, 3072), (2, 8192, 3072), (1, 3072, 8192))  # (G, q, p)
LEGACY_BLOCK = 128
LEGACY_FUSED_ATOL = 2e-4  # legacy against fused iterates (tests/test_fused_engine.py)
LEGACY_REL = 1e-3  # 25-iteration solves: relative error, legacy against fused
LEGACY_OUTLIER_REL = 1.01  # the outlier engines' errors (tests/test_outlier_fused.py)
MAIN_OVERRIDES = dict(n_periods=2)  # depth cut: 2 of 32 decoder layers
# (method, bits) of the main path's PTQ runs, in order.
MAIN_RUNS = (("rtn", 4), ("gptq", 4), ("quantease", 4), ("rtn", 3), ("gptq", 3), ("quantease", 3),
             ("qe_outlier", 3), ("awq", 3), ("awq_qe", 3), ("spqr", 3))
MAIN_BATCH, MAIN_SEQ, MAIN_CALIB_BATCHES = 4, 512, 4  # eval: EvalBudget's defaults on these batches
# Phase 5b: full-width training (the phase-5 model, fp32 AdamW moments).
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 512
TRAIN_OPT = dict(lr=5e-4, warmup_steps=0, total_steps=TRAIN_STEPS)
# Phase 7: the reference's quality table (benchmarks/bench_eval.py, its full
# budget): bench_opt_s trained 1,600 steps at batch 16 x 96, then the grid.
QUALITY_TRAIN = dict(steps=1600, batch=16, seq=96)
QUALITY_OPT = dict(lr=2e-3, total_steps=1600)
QUALITY_CELLS = tuple({"method": m, "bits": b} for b in (4, 3) for m in ("rtn", "gptq", "quantease")) + (
    {"method": "qe_outlier", "bits": 3, "outlier_frac": 0.02},)
QUALITY_ITERATIONS, QUALITY_PPL_BATCHES, QUALITY_CALIB_BATCHES = 25, 24, 24
QUALITY_BATCH, QUALITY_PARITY_ITERATIONS = 4, 10
QUALITY_PROMPT_LENS = (5, 13, 29)  # from numpy.random.default_rng(11), as the bench's
QUALITY_PARITY = dict(max_seq=64, page_size=8, prefill_chunk=16)
QUALITY_PPL_FLOOR = 1.10  # dense perplexity at most this times the corpus entropy floor's
# validate_doc's problems that the run records and does not fail on: the
# perplexity orderings (at 4 bits the reference's own GPTQ-QuantEase gap is
# 0.0015 ppl) and paged == contiguous bitwise (kernel 5 keeps p in fp32).
QUALITY_RECORDED = ("ordering violated", "outlier 3-bit", "parity: paged != contiguous bitwise")
# Phase 7's kernels against their plain versions on phase 7's own calls: of
# each kernel's calls at one signature (operand shapes and dtypes, options),
# the inputs of this call are kept (of the last one, where there were fewer).
PATH_CALL_KEPT = 8
# The CUDA wrappers that kernels.ops dispatches to (kernel 1 launches inside
# the iteration wrappers; its sweeps are checked from theirs).
PATH_WRAPPERS = ("fused_iteration_cuda", "outlier_iteration_cuda", "dequant_matmul_cuda",
                 "paged_attention_cuda")
SERVED_RUN = "quantease@4"  # the artifact phase 6 serves
# Phase 8: the command-line path at full width, in process, on Phi-3-mini
# cut to 2 of 32 decoder layers (registered under this name; the CLIs take
# a registered config and have no depth flag).
CLI_ARCH = "phi3_mini_3_8b_2l"
CLI_TRAIN = ("--steps", "4", "--batch", "4", "--seq", "512")
CLI_SEQ, CLI_ITERATIONS, CLI_CALIB = 512, 25, 4  # the quantize CLI's: 4 calibration batches of 4
CLI_EVAL = ("--methods", "rtn", "awq", "spqr", "quantease", "--bits", "3", "--outlier-bits", "3",
            "--iterations", "25", "--calib-batches", "4", "--eval-batches", "4", "--seq", "512")
CLI_SERVE = ("--requests", "6", "--max-new", "12")
CLI_REPORT_REL = 1e-3  # the quantize CLI's report against ptq_quantize_model, per layer
# Four training checkpoints of 3.94 GiB (bf16 params, fp32 moments), the
# quantize output (0.85 GiB) and headroom.
CLI_DISK_GIB = 20
# validate_doc's problems phase 8 records and does not fail on: its grid has
# no GPTQ and no 4-bit rows, so the ordering checks cannot hold; random
# weights order no perplexity; and the parity's absolute tol (0.05, set for
# the reference's small trained model) sits at ~1 % of max |logit| of the
# full-width random model (0.047 in a first run), so the scorer against each
# engine is held to SERVE_LOGIT_TOL of max |logit| instead.
CLI_RECORDED = ("grid: missing method row", "ordering violated", "outlier 3-bit",
                "parity: paged != contiguous bitwise", "parity: contiguous diff exceeds tol",
                "parity: paged diff exceeds tol")
GEMM_DECODE_M = 8  # the serving GEMM at decode: one token per lane, max_batch 8
GEMM_PREFILL_M = 128  # the serving GEMM on a prefill chunk (prefill_chunk = 128)
# Kernel 5's shapes: (label, B, KVp, G, hd, table length, lengths drawn from
# [lo, hi], window, softcap, page kinds).
PAGE = 16
PAGED_SHAPES = (
    ("serving", 8, 32, 1, 96, 1536, (1, 1536), None, None, ("bf16", "int8", "int4")),
    ("long", 32, 32, 1, 96, 4096, (4096, 4096), None, None, ("bf16", "int4")),
    ("gqa", 8, 8, 4, 128, 1536, (1, 1536), 256, 50.0, ("bf16", "int8", "int4")),
    ("single", 1, 32, 1, 96, 4096, (4096, 4096), None, None, ("bf16", "int4")),  # one user at 4k
    # Phase 6's long-context run: 8 lanes of a 4096-token table at the
    # lengths its decode steps reach (prompts of 3584-4032 + 16 new tokens).
    ("longctx", 8, 32, 1, 96, 4096, (3584, 4048), None, None, ("bf16",)),
)
PAGED_ATOL = 2e-2  # the kernel keeps p in fp32, the plain version rounds it to bf16
# The A/B against kernel 5 before the split design, which is no longer in
# the tree: (device ms per call from the profiler, bytes of that call's
# bound) per (shape, kind), from PERF.md's kernel table, row 5 (NVIDIA H100
# 80GB HBM3, 700.00 W).  The serving and GQA shapes draw random lengths, so
# the comparison is per byte.
OLD_PAGED = {
    ("serving", "bf16"): (0.05081285, 56930304), ("serving", "int8"): (0.0536129, 37627904),
    ("serving", "int4"): (0.0401515, 18232576), ("long", "bf16"): (1.1284486, 1611005952),
    ("long", "int4"): (0.5837283, 436600832), ("gqa", "bf16"): (0.02566495, 6393856),
    ("gqa", "int8"): (0.0255309, 4403648), ("gqa", "int4"): (0.045388, 2359296),
}
PAGED_KERNELS = ("paged_attention_kernel", "paged_attention_combine_kernel")
L2_FLUSH_BYTES = 128 << 20  # over the H100's 50 MB of L2
# torch.profiler now and then hands back a trace with no device event at all
# (once in a full run on the H100): device_profile runs its function again
# under a new profiler, at most this many times in all.
PROFILE_TRIES = 3
# Phase 6: the serving traffic and engines.
SERVE_REQUESTS, SERVE_PROMPT_LO, SERVE_PROMPT_HI, SERVE_NEW_TOKENS = 24, 16, 1024, 32
SERVE_PREFIX, SERVE_N_SHARED = 256, 4
SERVE_PAGED = dict(max_batch=8, max_seq=1536, page_size=PAGE, prefill_chunk=128)
SERVE_CONTIG = dict(max_batch=8, max_seq=1536)
SERVE_SMALL_POOL = 0.3  # of the ample page count: forces preemption (0.4 does not)
# Phase 6's long-context run: 8 users of a 4k-context deployment, each near
# the full context, where kernel 5 reads the most per decode step.
LONG_REQUESTS, LONG_PROMPT_LO, LONG_PROMPT_HI, LONG_NEW_TOKENS = 8, 3584, 4032, 16
SERVE_LONG = dict(max_batch=8, max_seq=4096, page_size=PAGE, prefill_chunk=128)
# First-decode logits, paged bf16 against contiguous bf16, as a share of the
# contiguous run's max |logit| (bf16 activations; kernel 5 keeps p in fp32
# where decode_attention rounds it to bf16); also the margin below which
# the greedy streams may part.
SERVE_LOGIT_TOL = 2e-2
# int4/int8 KV against bf16: max |Δ logit| / max |logit| below this.  int4's
# step (max/7) is 18x int8's (max/127); at full width int4 moves the first
# logits by ~0.26 of max |logit| and int8 by ~0.02.
SERVE_KV_BOUND = 0.5
# Phase 9: speculative serving, γ = 4, on phase 6's engine shape and its
# first 8 prompts; the pool holds twice the engine's ample default (target
# and draft pages share it), so no proposal shortens for want of pages.
SPEC_GAMMA, SPEC_REQUESTS, SPEC_NEW_TOKENS, SPEC_DRAFT_BITS = 4, 8, 32, 3
SPEC_PAGED = SERVE_PAGED
SPEC_POOL = 2
# (b): phase 7's trained bench_opt_s, prompts of 32 eval-split tokens.
SPEC_TRAINED_PROMPT = 32
SPEC_TRAINED = dict(max_batch=8, max_seq=128, page_size=PAGE, prefill_chunk=32, n_pages=1 + 2 * 8 * 8)
# (c): the tuner's CLI on phase 8's training checkpoint, then the serve CLI
# on its output (its default γ).
TUNE_CLI = ("--budget-avg-bits", "3", "--bits-candidates", "2,3,4,8", "--iterations", "10",
            "--calib-batches", "4")
TUNE_SERVE_GAMMA = 4
CLI_PERIODS = 2  # phi3_mini_3_8b_2l: 2 periods of one attention block


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


def behind_sleep(enqueue) -> None:
    """Run ``enqueue`` (launches that record their own events) queued behind
    a sleep kernel that outlasts its enqueue, so the events time the card's
    work alone, not the host work between launches.  A run whose enqueue
    outlasted the sleep is thrown away and made again behind a sleep sized
    from that enqueue, at most three times: the host is shared, and one
    slow enqueue would otherwise end the run.  Keep each enqueue to a few
    hundred launches: more fill CUDA's launch queue, and the enqueue
    then waits on the sleep."""
    import torch

    enqueue()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enqueue()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    for attempt in range(3):
        if attempt:
            host_ms = enqueue_ms
        torch.cuda._sleep(int(4e6 * host_ms) + 100_000)  # ~2x the enqueue time at <= 2 GHz
        t0 = time.perf_counter()
        enqueue()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms <= 2 * host_ms:
            break
    check(enqueue_ms <= 2 * host_ms,
          f"behind_sleep: enqueueing took {enqueue_ms:.3f} ms, longer than the sleep in front of it")


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: ``reps`` calls between two events,
    queued behind a sleep (:func:`behind_sleep`).  Unlike :func:`cuda_ms`
    it leaves out the host work between launches (at the decode batch the
    wrapper's host time is longer than its kernels)."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def enqueue():
        a.record()
        for _ in range(reps):
            fn()
        b.record()

    behind_sleep(enqueue)
    return a.elapsed_time(b) / reps


def device_profile(fn, tries: int = PROFILE_TRIES) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and split the device time by
    kernel: ``{"wall_ms", "device_ms", "busy", "by_kernel": {name: ms}}``,
    our kernels by their source name and everything else (PyTorch's own
    kernels: top-k, elementwise, copies) under "torch".  The host wall time
    includes the profiler's own launch overhead, so ``busy`` (device time
    over wall time) is a lower bound.  Every ``fn`` given here launches work
    on the card, so a trace with no device event at all is the profiler
    losing its trace: it is thrown away and ``fn`` runs again under a new
    profiler, ``tries`` times in all (``fn`` must bear being run again).
    Empty when no trace held device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
        print(f"[profile] try {attempt + 1} of {tries}: the trace holds no device event "
              f"({len(prof.events())} host events); "
              f"{'running again' if attempt + 1 < tries else 'giving up'}", flush=True)
    by_kernel = {}
    for e in events:
        name = next((k for k in ("qe_block_corr_kernel", "qe_corr_reduce_kernel",
                                 "qe_block_sweep_kernel", "qe_suffix_resid_kernel",
                                 "dequant_matmul_tc_large_kernel",
                                 "dequant_matmul_tc_small_kernel", "dequant_matmul_reduce_kernel",
                                 "dequant_matmul_kernel", *PAGED_KERNELS) if k in e.name),
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
        kernel = re.search(r"((?:qe|paged)_[a-z_]+_kernel)", mangled)
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


def sweep_launches_on_path(G, p, bsz):
    """Kernel 1's launches at one solver group's shape in phase 5: p / B
    blocks per iteration, every iteration, layer and PTQ run whose engine
    sweeps blocks of B (QuantEase 256, qe_outlier OUTLIER_BLOCK); awq_qe
    solves the group's G layers one at a time (QuantEase, B = 256)."""
    runs = sum(1 if m in ("quantease", "qe_outlier") else G for m, _ in MAIN_RUNS
               if (m in ("quantease", "awq_qe") and bsz == QE_BLOCK)
               or (m == "qe_outlier" and bsz == OUTLIER_BLOCK))
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
        launches = sweep_launches_on_path(G, p, bsz)
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


def check_legacy_engines(gen, dev, detail):
    """QuantEase's legacy schedule (kernel 1 launched alone per block, the
    full P̂ and each block's correction by fp32 ``torch.matmul``) at the
    three solver groups, B = LEGACY_BLOCK: one iteration from a mid-solve
    state on the kernel path against the card's plain path (rows within
    CD_ATOL outside verified tie flips) and against one fused iteration
    from the same state (LEGACY_FUSED_ATOL, again outside verified ties);
    then 25-iteration solves, legacy against fused (relative error within
    LEGACY_REL), with kernel 1's launches held to n_blocks x 25, wall ms
    per iteration and the legacy solve's device time by kernel.  Last,
    Algorithm 3's legacy schedule at G=1 (3072, 8192), 3 bits, 1 %: its
    error within LEGACY_OUTLIER_REL of the fused engine's, both ways."""
    import torch

    from repro_torch.core import quantease as qe
    from repro_torch.core.outlier import outlier_quantease
    from repro_torch.kernels import ops, ref
    from repro_torch.quant import GridSpec

    bsz, spec = LEGACY_BLOCK, GridSpec(bits=4)
    rows, t_legacy, t_fused = [], 0.0, 0.0
    for G, q, p in LEGACY_SHAPES:
        s = cd_state(gen, G, q, p, dev)
        pmat_t = s["base"] + s["sig_t"] @ s["w"]  # P, from base = P − ŴΣ̃
        args = (pmat_t, s["sig_t"], s["w"], s["scale"], s["zero"])
        kw = dict(n_levels=16, quantize=True, bsz=bsz)
        what = f"legacy iteration G={G} ({q},{p}) B={bsz}"
        k_out = qe._legacy_iteration(ops.quantease_block_sweep, *args, **kw)
        p_out = qe._legacy_iteration(ref.quantease_block_sweep_t_ref, *args, **kw)
        state = dict(scale=s["scale"], zero=s["zero"], sig_t=s["sig_t"])
        ok_p, err_p, diff_p = cd_rows_agree(k_out, p_out, state, bsz, 16, f"{what}, kernel vs plain")
        del p_out
        f_out = ops.quantease_fused_iteration(s["base"], s["sig_t"], s["sig_t"], s["w"], s["scale"],
                                              s["zero"], torch.zeros_like(s["w"]), **kw)
        ok_f, err_f, diff_f = cd_rows_agree(k_out, f_out, state, bsz, 16, f"{what}, legacy vs fused",
                                            atol=LEGACY_FUSED_ATOL)
        del k_out, f_out, s, args, pmat_t
        w, sigma = cd_problem(gen, G, q, p, CD_TOKENS, dev)
        solve = lambda engine: qe.quantease_quantize(w, sigma, spec, iterations=PTQ_ITERATIONS,
                                                     block_size=bsz, engine=engine)[0]
        torch.cuda.synchronize()
        before = ops.launch_counts()["quantease_block_sweep"]
        t0 = time.monotonic()
        wl = solve("legacy")
        torch.cuda.synchronize()
        t_l = time.monotonic() - t0
        launches = ops.launch_counts()["quantease_block_sweep"] - before
        want = p // bsz * PTQ_ITERATIONS
        check(launches == want, f"{what}: kernel 1 launched {launches} times in a 25-iteration "
                                f"solve, expected {want} (n_blocks x 25)")
        t0 = time.monotonic()
        wf = solve("fused")
        torch.cuda.synchronize()
        t_f = time.monotonic() - t0
        prof = device_profile(lambda: solve("legacy"))
        el, ef = qe.relative_error(w, wl, sigma), qe.relative_error(w, wf, sigma)
        rel = float(((el - ef).abs() / ef).max())
        check(rel <= LEGACY_REL, f"{what}: 25-iteration relative error legacy {el.tolist()} vs "
                                 f"fused {ef.tolist()}")
        t_legacy += t_l
        t_fused += t_f
        row = dict(G=G, q=q, p=p, B=bsz, rows_ok_plain=ok_p, max_abs_err_plain=err_p,
                   rows_differing_plain=diff_p, rows_ok_fused=ok_f, max_abs_err_fused=err_f,
                   rows_differing_fused=diff_f, launches=launches, solve25_s=t_l,
                   fused_solve25_s=t_f, rel_err_legacy=el.tolist(), rel_err_fused=ef.tolist(),
                   profile=prof)
        rows.append(row)
        print(f"[kernel] {what}: kernel vs plain rows_ok={ok_p:.6f} (differing {diff_p}) "
              f"max_abs_err={err_p:.3g}; vs one fused iteration rows_ok={ok_f:.6f} (differing "
              f"{diff_f}) max_abs_err={err_f:.3g}; 25-iteration solve {t_l:.3f}s "
              f"({t_l / PTQ_ITERATIONS * 1e3:.2f} ms per iteration; fused at B={bsz} "
              f"{t_f / PTQ_ITERATIONS * 1e3:.2f} ms), kernel 1 launched {launches} = "
              f"{p // bsz} blocks x {PTQ_ITERATIONS}, rel_err {el.mean():.6f} vs fused "
              f"{ef.mean():.6f}", flush=True)
        print_profile(f"legacy 25-iter solve G={G} ({q},{p})", prof)
        if (G, q, p) != LEGACY_SHAPES[-1]:
            del w, sigma
    print(f"[kernel] legacy engine, one decoder layer's iteration (the three groups): "
          f"{t_legacy / PTQ_ITERATIONS * 1e3:.2f} ms wall against the fused engine's "
          f"{t_fused / PTQ_ITERATIONS * 1e3:.2f} ms at B={bsz} "
          f"({t_legacy / t_fused:.2f}x)", flush=True)
    n_out = max(int(OUTLIER_FRAC * q * p), 1)
    spec3 = GridSpec(bits=3)
    t0 = time.monotonic()
    rl = outlier_quantease(w, sigma, spec3, s=n_out, iterations=PTQ_ITERATIONS, engine="legacy")
    torch.cuda.synchronize()
    t_ol = time.monotonic() - t0
    t0 = time.monotonic()
    rf = outlier_quantease(w, sigma, spec3, s=n_out, iterations=PTQ_ITERATIONS, engine="fused")
    torch.cuda.synchronize()
    t_of = time.monotonic() - t0
    el = float(qe.relative_error(w, rl.w_eff, sigma).max())
    ef = float(qe.relative_error(w, rf.w_eff, sigma).max())
    check(el <= LEGACY_OUTLIER_REL * ef and ef <= LEGACY_OUTLIER_REL * el,
          f"outlier engines at G=1 ({q},{p}) 3 bits: legacy error {el} vs fused {ef}")
    print(f"[kernel] legacy outlier engine G=1 ({q},{p}) 3 bits 1 %: rel_err {el:.6f} vs fused "
          f"{ef:.6f} (ratio {el / ef:.5f}); 25 iterations {t_ol:.2f}s vs fused {t_of:.2f}s",
          flush=True)
    detail["legacy"] = dict(rows=rows, layer_iteration_ms=t_legacy / PTQ_ITERATIONS * 1e3,
                            fused_layer_iteration_ms=t_fused / PTQ_ITERATIONS * 1e3,
                            outlier=dict(rel_err_legacy=el, rel_err_fused=ef, legacy_s=t_ol,
                                         fused_s=t_of))
    return sum(r["launches"] for r in rows)


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


def paged_problem(gen, dev, B, KVp, G, hd, table_len, lens, kind):
    """Phase 3's kernel-5 inputs: lengths drawn from ``lens = (lo, hi)``,
    bf16 pages quantized as the engine writes them (``_kv_quantize`` /
    ``_kv_quantize4``), each sequence on its own pages of a table of
    ``table_len`` positions, entries past its length on the null page 0."""
    import torch

    from repro_torch.models import model as M

    n_pgs = -(-table_len // PAGE)
    P = 1 + B * n_pgs
    q = torch.randn(B, KVp, G, hd, generator=gen, device=dev).to(torch.bfloat16)
    lo, hi = lens
    if lo == hi:
        lengths = torch.full((B,), hi, device=dev)
    else:
        lengths = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev)
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
    """The bf16 K/V of ``d`` gathered contiguous, and the device time of one
    ``scaled_dot_product_attention`` call over it with a length mask, timed
    as kernel 5 is (the port never calls it)."""
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
    return device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), reps=20)


def check_paged_attention(gen, dev, detail):
    """Kernel 5 at the five shapes and every page kind, under its planned
    plan and a second one (one partition where the plan splits, else a
    4-way split; a plan is pages per partition), each held against the plain version at PAGED_ATOL; the
    planned plan's device time (both kernels, ``device_ms``) against the
    bound, SDPA and the earlier kernel per byte, and each kernel's share
    of the profiler's trace."""
    import torch

    from repro_torch.device import sm_count
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pa

    detail["paged_attention"] = []
    err_max, row_of_path = 0.0, None
    for label, B, KVp, G, hd, table_len, lens, window, cap, kinds in PAGED_SHAPES:
        for kind in kinds:
            d = paged_problem(gen, dev, B, KVp, G, hd, table_len, lens, kind)
            n_pgs, idx = d["page_table"].shape[1], d["q"].device.index
            cps = pa.paged_ctas_per_sm(idx, True, kind, G, hd)
            planned = pa.plan_paged(B, KVp, G, hd, n_pgs, PAGE, kind, sm_count(idx), cps, window)
            splits = lambda plan: pa.paged_splits(n_pgs, plan)
            other = n_pgs if splits(planned) > 1 else -(-n_pgs // 4)
            call = lambda fn, **kw: fn(d["q"], d["k_pages"], d["v_pages"], d["page_table"], d["lengths"],
                                       window=window, attn_softcap=cap, k_scale_pages=d["k_scale_pages"],
                                       v_scale_pages=d["v_scale_pages"], **kw)
            want = call(ref.paged_attention_ref)
            errs, dev_ms, share = {}, {}, {}
            for plan in (planned, other):
                out = call(pa.paged_attention_cuda, plan=plan)
                torch.cuda.synchronize()
                errs[plan] = float((out.float() - want.float()).abs().max())
                check(bool(torch.isfinite(out.float()).all()) and errs[plan] <= PAGED_ATOL,
                      f"paged_attention {label} {kind} plan {plan}: max abs err {errs[plan]} > {PAGED_ATOL}")
                # Device time: calls queued behind a sleep and timed with
                # events (the wrapper's host work left out, the gaps between
                # launches in).  The profiler gives each kernel's share only:
                # late in a long run its kernel sums came out below the bound.
                dev_ms[plan] = device_ms(lambda: call(pa.paged_attention_cuda, plan=plan), reps=50)
                prof = device_profile(lambda: [call(pa.paged_attention_cuda, plan=plan) for _ in range(20)])
                by = prof.get("by_kernel", {})
                check(all(by.get(k, 0.0) > 0 for k in PAGED_KERNELS[:1 + (splits(plan) > 1)]),
                      f"paged_attention {label} {kind} plan {plan}: the profile holds {sorted(by)}")
                traced = sum(by.get(k, 0.0) for k in PAGED_KERNELS)
                share[plan] = {k: by.get(k, 0.0) / traced for k in PAGED_KERNELS}
                share[plan]["traced_ms"] = traced / 20
            out = call(ops.paged_attention)  # the dispatch the engines call: the planned plan
            check(torch.equal(out, call(pa.paged_attention_cuda, plan=planned)),
                  f"paged_attention {label} {kind}: ops dispatch differs from the planned plan")
            err = max(errs.values())
            err_max = max(err_max, err)
            ms = cuda_ms(lambda: call(ops.paged_attention), reps=20)
            plain = cuda_ms(lambda: call(ref.paged_attention_ref), reps=5, warmup=1)
            lib = sdpa_yardstick(d) if kind == "bf16" else None
            n_bytes, n_flop = paged_bytes_flop(d, kind, window)
            b_ms, b_by = bound(n_bytes, n_flop)
            k_ms = dev_ms[planned]
            old = OLD_PAGED.get((label, kind))
            row = dict(shape=label, B=B, KVp=KVp, G=G, hd=hd, table_len=table_len, lengths=lens,
                       window=window,
                       softcap=cap, kind=kind, tokens=int(d["lengths"].sum()), max_abs_err=err, ms=ms,
                       device_ms=k_ms, plan=planned, n_split=splits(planned), ctas_per_sm=cps,
                       kernel_share=share[planned],
                       other_plan=other, other_device_ms=dev_ms[other], plain_ms=plain, library_ms=lib,
                       bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / k_ms, bytes=n_bytes,
                       old_device_ms=None if old is None else old[0],
                       old_ms_per_gb=None if old is None else old[0] / old[1] * 1e9,
                       ms_per_gb=k_ms / n_bytes * 1e9)
            detail["paged_attention"].append(row)
            print(f"[kernel] paged_attention {label} B={B} KVp={KVp} G={G} hd={hd} {kind} "
                  f"(window {window}, softcap {cap}, {row['tokens']} tokens): plan {planned} pages x "
                  f"{splits(planned)} "
                  f"({cps} CTAs/SM) device_ms={k_ms:.4f} (profiler: split {share[planned][PAGED_KERNELS[0]]:.2f}, "
                  f"combine {share[planned][PAGED_KERNELS[1]]:.2f} of {share[planned]['traced_ms']:.4f}) "
                  f"call_ms={ms:.4f} "
                  f"bound_ms={b_ms:.4f} ({b_by}, {b_ms / k_ms:.0%} of it) "
                  f"library_ms={lib if lib is None else round(lib, 4)}"
                  f"{'' if lib is None else f' (kernel/SDPA {k_ms / lib:.2f})'} plain_ms={plain:.3f}; "
                  f"plan {other} pages x {splits(other)}: device_ms={dev_ms[other]:.4f}; "
                  f"max_abs_err={err:.3g}", flush=True)
            if old is not None:
                print(f"[A/B] paged_attention {label} {kind}: {row['old_ms_per_gb']:.4f} -> "
                      f"{row['ms_per_gb']:.4f} device ms per GB of the bound's bytes "
                      f"({row['old_ms_per_gb'] / row['ms_per_gb']:.2f}x; the earlier kernel: "
                      f"{old[0]:.4f} ms for {old[1]} bytes)", flush=True)
                check(row["ms_per_gb"] <= row["old_ms_per_gb"],
                      f"paged_attention {label} {kind}: {row['ms_per_gb']} device ms per GB, slower than "
                      f"the earlier kernel's {row['old_ms_per_gb']}")
            if (label, kind) == ("serving", "bf16"):
                row_of_path = row
            del d, out, want
            torch.cuda.empty_cache()
    # The kernel's time is its device time (both kernels, events behind a
    # sleep); ``call_ms`` is the wrapper call timed with events, host work
    # included.
    r = row_of_path
    return dict(max_abs_err=err_max, ms=r["device_ms"], call_ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                shape="one decode step's attention at the serving shape: 8 sequences of 1-1536 "
                      f"tokens, 32 kv heads of 96, bf16 pages of 16, plan {r['plan']} pages x "
                      f"{r['n_split']}")


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
    from repro_torch.eval.harness import EvalBudget, eval_model
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
    budget = EvalBudget()
    n_eval_tokens = budget.n_ppl_batches * MAIN_BATCH * (MAIN_SEQ - 1)
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
    results, coo, zero_points = {}, {}, {}
    for method, bits in MAIN_RUNS:
        label = f"{method}@{bits}"
        pcfg = solver.PTQConfig(method=method, spec=GridSpec(bits=bits), iterations=PTQ_ITERATIONS, emit="qt",
                                outlier_frac=OUTLIER_FRAC)
        t0 = time.monotonic()
        qparams, report = solver.ptq_quantize_model(
            plan, params, calib, pcfg, progress_cb=progress(label), device=dev)
        served = quantize_params_for_serving(plan, params, qparams["dec"], device=dev)
        t_ptq = time.monotonic() - t0
        metrics = eval_model(plan, served, eval_fn, budget=budget, device=dev)
        results[label] = (report, metrics, t_ptq, time.monotonic() - t0 - t_ptq)
        wq = served["dec"]["b0"]["wq"]
        q_wq, p_wq = wq.shape[-2:]
        coo[label] = (None if wq.outlier_idx is None else tuple(wq.outlier_idx.shape),
                      (cfg.n_periods, max(int(OUTLIER_FRAC * q_wq * p_wq), 1)))
        if label == SERVED_RUN:
            artifact = served
        if method in ("awq", "awq_qe", "spqr"):
            zero_points[label] = torch.cat([leaf.zero.flatten() for blk in served["dec"].values()
                                            for leaf in blk.values() if hasattr(leaf, "codes")])
        del qparams, served, wq
    dense = eval_model(plan, params, eval_fn, budget=budget, device=dev)
    torch.cuda.synchronize()
    t_main = time.monotonic() - t_main
    counts = ops.launch_counts()

    finite = lambda m: all(math.isfinite(m[k]) for k in ("ppl", "top1", "top5", "choice_acc",
                                                           "choice_margin"))
    errs = {}
    for label, (report, m, t_ptq, t_eval) in results.items():
        vals = np.array(list(report.values()))
        check(np.all(np.isfinite(vals)) and len(vals) == n_layers, f"{label}: report {report}")
        check(finite(m) and m["n_tokens"] == n_eval_tokens, f"{label}: eval {m}")
        errs[label] = vals
        print(f"[main] {label}: {len(vals)} layers mean_rel_error={vals.mean():.6f} "
              f"max_rel_error={vals.max():.6f} ppl={m['ppl']:.4f} nll={m['nll']:.6f} "
              f"top1={m['top1']:.4f} top5={m['top5']:.4f} choice_acc={m['choice_acc']:.4f} "
              f"margin={m['choice_margin']:.4f} (PTQ {t_ptq:.1f}s, eval {t_eval:.1f}s)")
    check(finite(dense), f"dense eval {dense}")
    print(f"[main] dense: ppl={dense['ppl']:.4f} nll={dense['nll']:.6f} top1={dense['top1']:.4f} "
          f"top5={dense['top5']:.4f} choice_acc={dense['choice_acc']:.4f} "
          f"margin={dense['choice_margin']:.4f}")
    per_layer = {label: [b["seconds"] for b in blocks if b["run"] == label] for label in results}
    print("[main] PTQ seconds per decoder layer: " + "; ".join(
        f"{label} {', '.join(f'{x:.2f}' for x in secs)}" for label, secs in per_layer.items()))
    check(len({tuple(r[0]) for r in results.values()}) == 1, "layer sets differ")
    mean = {label: v.mean() for label, v in errs.items()}
    for bits in (4, 3):
        check(mean[f"quantease@{bits}"] < mean[f"gptq@{bits}"] < mean[f"rtn@{bits}"],
              f"at {bits} bits mean errors do not order quantease < gptq < rtn: {mean}")
    check(mean["qe_outlier@3"] < mean["quantease@3"] < mean["rtn@3"],
          f"at 3 bits mean errors do not order qe_outlier < quantease < rtn: {mean}")
    # The paper's baselines at 3 bits: AWQ no worse than RTN, QuantEase below
    # AWQ, and outlier-aware QuantEase below SpQR at the same budget (§5.4).
    # AWQ+QuantEase against QuantEase is recorded only: random weights carry
    # no per-channel activation-scale structure for AWQ's scaling to use.
    check(mean["awq@3"] <= mean["rtn@3"] and mean["quantease@3"] < mean["awq@3"],
          f"at 3 bits mean errors do not order quantease < awq <= rtn: {mean}")
    check(mean["qe_outlier@3"] < mean["spqr@3"],
          f"at 3 bits qe_outlier is not below spqr at the same budget: {mean}")
    print(f"[main] 3 bits: awq {mean['awq@3']:.6f} <= rtn {mean['rtn@3']:.6f}, quantease "
          f"{mean['quantease@3']:.6f} < awq; qe_outlier {mean['qe_outlier@3']:.6f} < spqr "
          f"{mean['spqr@3']:.6f}; recorded: awq_qe {mean['awq_qe@3']:.6f} against quantease "
          f"({mean['awq_qe@3'] / mean['quantease@3']:.4f}x)", flush=True)
    # Their grids are re-derived from Ŵ at the emit: every zero point of the
    # three artifacts must still be an integer in [0, 7] (checked again by
    # quantize_params_for_serving when each was restacked).
    for label, z in zero_points.items():
        check(bool(((z == torch.round(z)) & (z >= 0) & (z <= 7)).all()),
              f"{label}: zero points not integers in [0, 7]")
    print(f"[main] zero points of {', '.join(zero_points)}: integers in [0, 7]", flush=True)
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
        eval={m: r[1] for m, r in results.items()} | {"dense": dense},
        ptq_seconds={m: r[2] for m, r in results.items()},
        eval_seconds={m: r[3] for m, r in results.items()},
        seconds_per_layer=per_layer,
        blocks=blocks,
        seconds=t_main,
    )
    return counts, plan, artifact, params


# ---------------------------------------------------------------------------
# Phase 5b: training at full width
# ---------------------------------------------------------------------------


def _same_bits(a, b) -> bool:
    import torch

    as_bytes = lambda t: t.detach().contiguous().reshape(-1).view(torch.uint8)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(as_bytes(a), as_bytes(b))


def train_full_width(dev, detail):
    """The phase-5 model (Phi-3-mini width, 2 of 32 layers, bf16 params on
    the card) trained ``TRAIN_STEPS`` steps with fp32 AdamW moments on the
    synthetic corpus; then one checkpoint of that state saved and restored,
    held bit for bit.  Returns the kernels' launch counts (the dense
    training path runs none of them)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("phi3_mini_3_8b"), **MAIN_OVERRIDES)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # Training's own memory: counted above what the earlier phases leave
        # allocated (phase 6's artifact), after their cyclic garbage is gone.
        before_gc = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, AdamWConfig(**TRAIN_OPT),
                          TrainerConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                        ckpt_every=TRAIN_STEPS + 1, ckpt_dir=ckpt_dir, log_every=1),
                          device=dev)
        built = torch.cuda.memory_allocated() - base
        stamps, peaks = [], []

        def stamp(step=None):  # runs before each step: the card has finished the one before
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            peaks.append(torch.cuda.max_memory_allocated() - base)  # since the last stamp
            torch.cuda.reset_peak_memory_stats()

        ops.reset_launch_counts()
        out = trainer.run(fault_hook=stamp)
        stamp()
        counts = ops.launch_counts()
        held = torch.cuda.memory_allocated()
        gc.collect()
        cyclic = held - torch.cuda.memory_allocated()  # card memory the run left in reference cycles
        peak = max(peaks)
        losses = [m["loss"] for m in out["log"]]
        ms_after_first = (stamps[-1] - stamps[1]) * 1e3 / (TRAIN_STEPS - 1)
        print(f"[train] {cfg.name} x{cfg.n_periods} layers, batch {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f"; first step {(stamps[1] - stamps[0]) * 1e3:.1f} ms, then {ms_after_first:.1f} ms "
              f"per step; launches {counts}", flush=True)
        print(f"[train] memory: earlier phases left {before_gc / 2**30:.3f} GiB allocated, "
              f"{base / 2**30:.3f} GiB after gc.collect(); above that the built Trainer holds "
              f"{built / 2**30:.3f} GiB and training peaks at {peak / 2**30:.3f} GiB (per step: "
              + ", ".join(f"{x / 2**30:.3f}" for x in peaks[1:])
              + f"); gc.collect() after the run freed {cyclic / 2**30:.3f} GiB", flush=True)
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
              f"training losses {losses}")
        check(losses[-1] < losses[0], f"the last loss {losses[-1]} is not below the first {losses[0]}")

        state = [t.clone() for t in tree_leaves({"params": trainer.params, "opt": trainer.opt_state})]
        n_bytes = sum(t.numel() * t.element_size() for t in state)
        t0 = time.monotonic()
        trainer.save(TRAIN_STEPS)
        t_save = time.monotonic() - t0
        t0 = time.monotonic()
        step = trainer.restore()
        t_restore = time.monotonic() - t0
        back = tree_leaves({"params": trainer.params, "opt": trainer.opt_state})
        same = len(back) == len(state) and all(_same_bits(a, b) for a, b in zip(state, back))
        print(f"[train] checkpoint of {len(state)} leaves, {n_bytes / 2**30:.2f} GiB: saved in "
              f"{t_save:.1f}s, restored in {t_restore:.1f}s, bit for bit: {same}", flush=True)
        check(step == TRAIN_STEPS and trainer.data_step == TRAIN_STEPS and same,
              f"checkpoint round trip: step {step}, data step {trainer.data_step}, bitwise {same}")
        check(all(t.device.type == "cuda" for t in back), "restored state left the card")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    detail["train"] = dict(losses=losses, ms_first=(stamps[1] - stamps[0]) * 1e3,
                           ms_per_step=ms_after_first, peak_bytes=peak, peak_bytes_per_step=peaks[1:],
                           base_bytes=base, base_bytes_before_gc=before_gc, trainer_bytes=built,
                           cyclic_bytes=cyclic, checkpoint_bytes=n_bytes,
                           save_s=t_save, restore_s=t_restore, launches=counts)
    return counts


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


def serve_run(label, make_engine, prompts, new_tokens=SERVE_NEW_TOKENS):
    """Submit every prompt at once, run to the end, and collect the run's
    numbers (engine-clock times: ``time.monotonic``)."""
    import numpy as np
    import torch

    from repro_torch.serve import Request

    eng = make_engine()
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
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
        long_context=long_context(dev, cfg, plans["bf16"], artifact,
                                  next(r for r in detail["paged_attention"]
                                       if (r["shape"], r["kind"]) == ("longctx", "bf16"))),
    )
    for eng in (r[2] for r in res.values()):
        eng.logit_trace.clear()
    return counts


def replay_device_ms(calls, batch: int = 32) -> list:
    """Device ms of each recorded kernel-5 call, replayed on its own inputs:
    ``batch`` calls at a time behind a sleep (:func:`behind_sleep`), each
    between two events, L2 flushed before each (as the run's GEMMs flush it
    between calls), so each time is the split and combine kernels' alone."""
    import torch

    from repro_torch.kernels.paged_attention import paged_attention_cuda

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=calls[0][0].device)
    times = []
    for i in range(0, len(calls), batch):
        part = calls[i:i + batch]
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in part]

        def enqueue():
            for (a, b), (q, k_pages, v_pages, table, lengths, kw) in zip(events, part):
                flush.zero_()
                a.record()
                paged_attention_cuda(q, k_pages, v_pages, table, lengths, **kw)
                b.record()

        behind_sleep(enqueue)
        times += [a.elapsed_time(b) for a, b in events]
    return times


def long_context(dev, cfg, plan, artifact, k5_row):
    """Eight users of a 4k-context deployment (prompts of 3584-4032 tokens,
    numpy seed 0; 16 new tokens each) on the paged bf16 engine, under the
    profiler: decode ms per step, the card's busy share, and device time by
    kernel, kernel 5's against the dequant-GEMM's.  The profiler's kernel
    sums are lower bounds (phase 3 found them below event times), so each
    kernel-5 call of the run is recorded (its table and lengths copied)
    and replayed after it, timed by events (:func:`replay_device_ms`);
    phase 3's time at the run's shape with all 8 lanes decoding
    (``k5_row``) stands beside.  Its launches are counted from 0 for this
    run alone and held to decode steps x periods."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve import PagedServingEngine

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in rng.integers(LONG_PROMPT_LO, LONG_PROMPT_HI + 1, LONG_REQUESTS)]
    calls, dispatch = [], ops.paged_attention

    def recording(q, k_pages, v_pages, table, lengths, **kw):
        calls.append((q, k_pages, v_pages, table.clone(), lengths.clone(), kw))
        return dispatch(q, k_pages, v_pages, table, lengths, **kw)

    out = {}

    def run():  # from a clean count: device_profile runs it again if the trace was lost
        calls.clear()
        ops.reset_launch_counts()
        out["run"] = serve_run("paged bf16, 8 users at 3.6-4k tokens, profiled",
                               lambda: PagedServingEngine(plan, artifact, device=dev, **SERVE_LONG),
                               prompts, new_tokens=LONG_NEW_TOKENS)

    ops.paged_attention = recording
    try:
        prof = device_profile(run)
    finally:
        ops.paged_attention = dispatch
    counts = ops.launch_counts()
    stats, outputs, _ = out["run"]
    check(stats["requests"] == LONG_REQUESTS and stats["statuses"] == ["completed"]
          and all(len(o) == LONG_NEW_TOKENS for o in outputs.values()),
          f"long-context run: requests {stats['requests']}, statuses {stats['statuses']}")
    layers = cfg.n_periods * len(cfg.pattern)
    check(counts["paged_attention"] == stats["decode_steps"] * layers,
          f"long-context run: paged_attention launched {counts['paged_attention']} times for "
          f"{stats['decode_steps']} decode steps x {layers} layers")
    check(bool(prof), "long-context run: the profile holds no device time")
    by = prof["by_kernel"]
    k5 = sum(by.get(k, 0.0) for k in PAGED_KERNELS)
    gemm = sum(v for k, v in by.items() if k.startswith("dequant_matmul"))
    check(len(calls) == counts["paged_attention"],
          f"long-context run: {len(calls)} kernel-5 calls recorded, {counts['paged_attention']} launched")
    replay = replay_device_ms(calls)
    k5_events = sum(replay)
    lanes = [int((c[4] > 1).sum()) for c in calls]  # idle lanes attend over 1 position
    per_call_bytes = stats["kv_read_bytes"] / len(calls)
    k5_bound = bound(per_call_bytes, 0)[0]
    del calls
    print(f"[profile] long context: decode {stats['ms_per_step']:.2f} ms/step over "
          f"{stats['decode_steps']} steps, TTFT p50 {stats['ttft_p50_ms']:.0f} ms; wall "
          f"{prof['wall_ms']:.1f} ms; profiler kernel sums (lower bounds): device "
          f"{prof['device_ms']:.1f} ms (busy {prof['busy']:.3f}), kernel 5 {k5:.2f} ms "
          f"({k5 / prof['device_ms']:.1%} of device time, {k5 / max(counts['paged_attention'], 1):.4f} "
          f"ms per call), dequant-GEMM {gemm:.2f} ms ({gemm / prof['device_ms']:.1%}); "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by.items())), flush=True)
    print(f"[profile] long context, kernel 5 by events (its {len(replay)} calls replayed): "
          f"{k5_events:.2f} ms, {k5_events / len(replay):.4f} ms per call (median "
          f"{statistics.median(replay):.4f}), {k5_events / prof['wall_ms']:.1%} of the run's wall time, "
          f"{k5_events / stats['decode_steps']:.4f} ms per decode step of {stats['ms_per_step']:.2f}; "
          f"lanes decoding per call: mean {np.mean(lanes):.2f}, max {max(lanes)}; KV bytes per call "
          f"{per_call_bytes:.0f} (the engine's count), bound {k5_bound:.4f} ms "
          f"({k5_bound * len(replay) / k5_events:.0%} of it); with all 8 lanes decoding (phase 3 "
          f"longctx): {k5_row['device_ms']:.4f} ms per call, {k5_row['bytes']} bytes", flush=True)
    return dict(stats=stats, profile=prof, launches=counts, kernel5_ms=k5, gemm_ms=gemm,
                kernel5_event_ms=k5_events, kernel5_replay_ms=replay, lanes_per_call=lanes,
                prompt_lengths=[len(p) for p in prompts])


# ---------------------------------------------------------------------------
# Phase 7: the quality table
# ---------------------------------------------------------------------------


def _signature(name, args, kwargs):
    import torch

    sig = lambda a: (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor) else a
    return (name, tuple(sig(a) for a in args), tuple(sorted((k, sig(v)) for k, v in kwargs.items())))


@contextlib.contextmanager
def recording_calls(kept: int = PATH_CALL_KEPT):
    """While open, every call that ``kernels.ops`` dispatches to a CUDA
    wrapper (``PATH_WRAPPERS``) goes through unchanged, and per signature
    (wrapper, operand shapes and dtypes, options) the inputs of the
    ``kept``-th call, or of the last one where there were fewer, are cloned
    into the dict it yields: ``{signature: (wrapper, args, kwargs, calls)}``.
    The launch counters live on the wrapped functions and are untouched."""
    import torch

    from repro_torch.kernels import ops

    calls = {}
    originals = {name: getattr(ops, name) for name in PATH_WRAPPERS}

    def recorder(name, fn):
        def call(*args, **kwargs):
            key = _signature(name, args, kwargs)
            n = calls[key][3] + 1 if key in calls else 1
            if n <= kept:
                clone = lambda a: a.clone() if isinstance(a, torch.Tensor) else a
                calls[key] = (name, [clone(a) for a in args], {k: clone(v) for k, v in kwargs.items()}, n)
            else:
                calls[key] = (*calls[key][:3], n)
            return fn(*args, **kwargs)
        return call

    for name, fn in originals.items():
        setattr(ops, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)


def cd_rows_agree(k_out, p_out, state, bsz, n_levels, what, atol=CD_ATOL):
    """Kernel against plain CD outputs ``(w, β0, Δ)``: rows (output
    channels) within CD_ATOL in every output, at least ROWS_OK of them, or
    every differing row starts at a verified rounding tie
    (:func:`tie_flip_rows`), at most 1 - ROWS_TIES of the rows and at least
    one (a path shape may have only 128 rows).  Returns ``(rows_ok,
    max_abs_err, rows_differing)``."""
    as3 = lambda t: t if t.dim() == 3 else t[None]
    k_out, p_out = [as3(t) for t in k_out], [as3(t) for t in p_out]
    state = {k: as3(v) for k, v in state.items()}
    fracs, errs = zip(*(rows_within(k, pl, atol) for k, pl in zip(k_out, p_out)))
    n_diff, n_unexplained, ties = tie_flip_rows(k_out, p_out, state, bsz, n_levels, atol)
    n_rows = k_out[0].shape[0] * k_out[0].shape[-1]
    check(min(fracs) >= ROWS_OK
          or (n_unexplained == 0 and n_diff <= max(1.0, (1 - ROWS_TIES) * n_rows)),
          f"{what}: rows ok {fracs}, {n_diff} of {n_rows} rows differ, {n_unexplained} not "
          f"starting with a tie flip: {ties}")
    return min(fracs), max(errs), n_diff


def check_path_calls(calls, variants, phase="phase 7"):
    """Each recorded call of ``phase`` once more through ``kernels.ops`` (the
    kernel) and through its plain version, on the same inputs, at the
    tolerances of phase 3: the CD iterations (kernels 2 and 4) row by row,
    kernel 4's R in the rows that agree, and kernel 1 on each block of each
    iteration (β0 from the plain iteration, the same for both); the
    dequant-GEMM (kernel 3) within 1e-2 of max |y| in bf16 and 1e-4 in
    fp32; paged attention (kernel 5) within PAGED_ATOL.  Every variant of
    kernel 3 that phase 7 launched (``variants``) must be among those
    checked.  Returns per kernel ``{"calls", "max_abs_err"}``: the calls
    checked (one per signature; kernel 1 once per block of each) and the
    largest difference (kernel 3's relative to max |y|)."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.quant import unpack_codes

    out = {}

    def note(kernel, err):
        row = out.setdefault(kernel, dict(calls=0, max_abs_err=0.0))
        row["calls"] += 1
        row["max_abs_err"] = max(row["max_abs_err"], err)

    checked_variants = set()
    for key in sorted(calls, key=str):
        name, args, kw, n = calls[key]
        a0 = args[0]
        if name == "dequant_matmul_cuda":
            what = (f"dequant_matmul m={a0.shape[0]} k={a0.shape[1]} n={args[1].shape[0]} x "
                    f"{str(a0.dtype)[6:]} {'packed4' if kw['packed4'] else str(args[1].dtype)[6:]} "
                    f"group {kw['group_size']} out {str(kw['out_dtype'])[6:]}")
        elif name == "paged_attention_cuda":
            what = (f"paged_attention B,KVp,G,hd={tuple(a0.shape)} pages {tuple(args[1].shape[:2])} "
                    f"{str(args[1].dtype)[6:]} table {tuple(args[3].shape)}")
        else:
            what = (f"{name[:-5]} G={a0.shape[0] if a0.dim() == 3 else 1} p={a0.shape[-2]} "
                    f"q={a0.shape[-1]} B={kw['bsz']} levels {kw['n_levels']} quantize {kw['quantize']}")
        what = f"{phase} {what}"
        if name in ("fused_iteration_cuda", "outlier_iteration_cuda"):
            outlier = name == "outlier_iteration_cuda"
            dispatch, plain = ((ops.quantease_outlier_iteration, ref.quantease_outlier_iteration_ref)
                               if outlier else (ops.quantease_fused_iteration, ref.quantease_fused_iteration_ref))
            k_out, p_out = dispatch(*args, **kw), plain(*args, **kw)
            sig_t, w_t, scale_t, zero_t = args[1], args[3], args[4], args[5]
            bsz, n_levels = kw["bsz"], kw["n_levels"]
            state = dict(scale=scale_t, zero=zero_t, sig_t=sig_t)
            ok, err, n_diff = cd_rows_agree(k_out[:3], p_out[:3], state, bsz, n_levels, what)
            line = f"rows_ok={ok:.6f} (differing {n_diff}) max_abs_err={err:.3g}"
            if outlier:
                same = torch.stack([((k - pl).abs() <= CD_ATOL).all(dim=-2)
                                    for k, pl in zip(k_out[:3], p_out[:3])]).all(0)
                r_scale = max(float(p_out[3].abs().max()), 1e-30)
                r_err = float((k_out[3] - p_out[3]).abs().amax(dim=-2)[same].max()) / r_scale
                check(r_err <= R_RTOL, f"{what}: R off by {r_err} of max |R|")
                line += f" R rel err={r_err:.3g}"
            note(name.replace("_cuda", ""), err)
            # Kernel 1 on every block of this iteration, from the plain
            # iteration's β0.
            sweep_ok, sweep_err, sweep_diff = 1.0, 0.0, 0
            for c0 in range(0, args[0].shape[-2], bsz):
                sl = slice(c0, c0 + bsz)
                blk = [t[..., sl, :].contiguous() for t in (p_out[1], w_t, scale_t, zero_t)]
                sig_blk = sig_t[..., sl, sl].contiguous()
                sweep_args = (blk[0], sig_blk, blk[1], blk[2], blk[3])
                skw = dict(n_levels=n_levels, quantize=kw["quantize"])
                kn, kd = ops.quantease_block_sweep(*sweep_args, **skw)
                pn, pd = ref.quantease_block_sweep_t_ref(*sweep_args, **skw)
                b_ok, b_err, b_diff = cd_rows_agree(
                    (kn, blk[0], kd), (pn, blk[0], pd), dict(scale=blk[2], zero=blk[3], sig_t=sig_blk),
                    bsz, n_levels, f"{what}, block sweep at column {c0}")
                sweep_ok, sweep_err = min(sweep_ok, b_ok), max(sweep_err, b_err)
                sweep_diff += b_diff
                note("block_sweep", b_err)
            line += (f"; its {args[0].shape[-2] // bsz} block sweeps rows_ok={sweep_ok:.6f} "
                     f"(differing {sweep_diff}) max_abs_err={sweep_err:.3g}")
        elif name == "dequant_matmul_cuda":
            x, codes, scale, zero = args
            before = dict(dequant_matmul_cuda.launches_by_variant)
            y = ops.dequant_matmul(*args, **kw)
            took = [v for v, c in dequant_matmul_cuda.launches_by_variant.items() if c != before[v]]
            checked_variants.update(took)
            full = unpack_codes(codes, 4, codes.shape[-1] * 2) if kw["packed4"] else codes
            y_ref = ref.dequant_matmul_ref(x, full, scale, zero, out_dtype=torch.float32,
                                           group_size=kw["group_size"])
            y_max = max(float(y_ref.abs().max()), 1e-30)
            err = float((y.float() - y_ref).abs().max())
            tol = (1e-2 if kw["out_dtype"] == torch.bfloat16 else 1e-4) * y_max
            check(err <= tol, f"{what}: max abs err {err} > {tol}")
            note("dequant_matmul", err / y_max)
            line = f"{'/'.join(took)} max_abs_err={err:.3g} (tol {tol:.3g})"
        else:
            want = ref.paged_attention_ref(*args, **kw)
            got = ops.paged_attention(*args, **kw)
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got.float()).all()) and err <= PAGED_ATOL,
                  f"{what}: max abs err {err} > {PAGED_ATOL} (max |out| {float(want.abs().max())})")
            note("paged_attention", err)
            line = f"max_abs_err={err:.3g} (max |out| {float(want.float().abs().max()):.3g})"
        print(f"[kernel] {what}, call {min(n, PATH_CALL_KEPT)} of {n}: {line}", flush=True)
    launched = {v for v, c in variants.items() if c}
    check(launched <= checked_variants,
          f"{phase} launched dequant-GEMM variants {sorted(launched)}, checked {sorted(checked_variants)}")
    return out


def quality_table(dev, detail, card):
    """The reference's quality table on the card: ``bench_opt_s`` trained
    with the reference's budget on the synthetic corpus, then ``run_grid``
    over RTN, GPTQ and QuantEase at 4 and 3 bits and qe_outlier (2 %) at 3
    bits, each scored as its serving artifact, and ``quantized_parity`` as
    the reference's bench runs it.  Writes the document to
    ``chiprun_out/BENCH_port_eval.json``.  Returns the kernels' launch
    counts over the grid and the parity check (training runs none)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.eval.harness import EVAL_SCHEMA, EvalBudget, quantized_parity, run_grid, validate_doc
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig

    cfg = get_config("bench_opt_s")
    steps = QUALITY_TRAIN["steps"]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_quality_")
    try:
        trainer = Trainer(cfg, AdamWConfig(**QUALITY_OPT),
                          TrainerConfig(**QUALITY_TRAIN, ckpt_every=steps, ckpt_dir=ckpt_dir,
                                        log_every=steps // 4, seed=0), device=dev)
        ops.reset_launch_counts()
        t0 = time.monotonic()
        log = trainer.run()["log"]
        torch.cuda.synchronize()
        t_train = time.monotonic() - t0
        train_counts = ops.launch_counts()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    plan, params = trainer.plan, trainer.params
    print(f"[quality] {cfg.name} trained {steps} steps at {QUALITY_TRAIN['batch']} x "
          f"{QUALITY_TRAIN['seq']} in {t_train:.1f}s ({t_train / steps * 1e3:.2f} ms per step): loss "
          + ", ".join(f"{m['step']}:{m['loss']:.4f}" for m in log), flush=True)
    check(all(math.isfinite(m["loss"]) for m in log), f"quality training losses {log}")

    # The corpus seed is the trainer's (TrainerConfig.seed = 0), as the bench's.
    data = DataConfig(vocab=cfg.vocab, seed=0)
    seq = QUALITY_TRAIN["seq"]
    calib_fn, _ = make_batch_fn(data, cfg, QUALITY_BATCH, seq, split="calib")
    eval_fn, corpus = make_batch_fn(data, cfg, QUALITY_BATCH, seq, split="eval")
    calib = [calib_fn(i) for i in range(QUALITY_CALIB_BATCHES)]
    floor_ppl = float(np.exp(corpus.entropy_floor()))
    cell_s, t_last = {}, [time.monotonic()]

    def progress(r):
        now = time.monotonic()
        cell_s[r["cell"]] = now - t_last[0]
        t_last[0] = now
        print(f"[quality] {r['cell']}: ppl={r['ppl']:.4f} top1={r['top1']:.4f} top5={r['top5']:.4f} "
              f"choice_acc={r['choice_acc']:.4f} margin={r['choice_margin']:.4f}"
              + (f" mean_layer_err={r['mean_layer_err']:.6f}" if "mean_layer_err" in r else "")
              + f" ({cell_s[r['cell']]:.1f}s)", flush=True)

    ops.reset_launch_counts()
    with recording_calls() as calls:
        t0 = time.monotonic()
        body = run_grid(plan, params, calib, eval_fn, [dict(c) for c in QUALITY_CELLS],
                        iterations=QUALITY_ITERATIONS, emit="qt",
                        budget=EvalBudget(n_ppl_batches=QUALITY_PPL_BATCHES), progress_cb=progress,
                        device=dev)
        t_grid = time.monotonic() - t0
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in QUALITY_PROMPT_LENS]
        t0 = time.monotonic()
        parity = quantized_parity(plan, params, calib, prompts, iterations=QUALITY_PARITY_ITERATIONS,
                                  device=dev, **QUALITY_PARITY)
        torch.cuda.synchronize()
        t_parity = time.monotonic() - t0
    counts = ops.launch_counts()
    variants = dict(dequant_matmul_cuda.launches_by_variant)
    # Every kernel at phase 7's own shapes, against its plain version on
    # the inputs phase 7 gave it (launched after the counts were read).
    t0 = time.monotonic()
    at_path = check_path_calls(calls, variants)
    del calls
    print(f"[quality] kernels against their plain versions on phase 7's calls: "
          + ", ".join(f"{k} {v['calls']} calls, max_abs_err {v['max_abs_err']:.3g}"
                      for k, v in at_path.items()) + f" ({time.monotonic() - t0:.1f}s)", flush=True)
    print(f"[quality] parity ({parity['cell']}): scorer vs contiguous {parity['max_abs_diff_contiguous']}, "
          f"vs paged {parity['max_abs_diff_paged']} (tol {parity['tol']}); paged vs contiguous "
          f"{parity['max_abs_diff_paged_contiguous']} of max |logit| {parity['max_abs_logit']}, "
          f"bitwise {parity['paged_bitwise_contiguous']} ({t_parity:.1f}s)", flush=True)
    print(f"[quality] launches over the grid and the parity check: {counts}; dequant_matmul by "
          f"variant {variants} (training: {train_counts}); grid {t_grid:.1f}s", flush=True)

    doc = {
        "schema": EVAL_SCHEMA,
        "smoke": False,
        "torch": torch.__version__,
        "backend": "cuda",
        "card": card,
        "arch": cfg.name,
        "data": {
            "vocab": cfg.vocab, "seq": seq, "eval_split": "eval", "calib_split": "calib",
            "entropy_floor_ppl": round(floor_ppl, 4),
        },
        "train": {**QUALITY_TRAIN, **QUALITY_OPT, "final_loss": log[-1]["loss"],
                  "seconds": round(t_train, 3)},
        "iterations": QUALITY_ITERATIONS,
        "emit": "qt",
        **body,
        "parity": parity,
    }
    problems = validate_doc(doc)
    doc["validate_problems"] = problems
    doc["seconds"] = {"grid": round(t_grid, 3), "parity": round(t_parity, 3),
                      "cells": {k: round(v, 3) for k, v in cell_s.items()}}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "BENCH_port_eval.json"), "w") as fh:
        json.dump(doc, fh, indent=1)
    print(f"[quality] validate_doc: {problems or 'no problems'}; wrote chiprun_out/BENCH_port_eval.json",
          flush=True)

    unexpected = [p for p in problems if not p.startswith(QUALITY_RECORDED)]
    check(not unexpected, f"BENCH_port_eval.json fails validate_doc: {unexpected}")
    dense_ppl = body["dense"]["ppl"]
    check(dense_ppl <= QUALITY_PPL_FLOOR * floor_ppl,
          f"dense perplexity {dense_ppl} above {QUALITY_PPL_FLOOR} x the entropy floor's {floor_ppl}")
    err = {f"{r['method']}@{r['bits']}": r["mean_layer_err"] for r in body["grid"]}
    for bits in (4, 3):
        check(err[f"quantease@{bits}"] < err[f"gptq@{bits}"] < err[f"rtn@{bits}"],
              f"at {bits} bits mean layer errors do not order quantease < gptq < rtn: {err}")
    check(err["qe_outlier@3"] < err["quantease@3"],
          f"qe_outlier's mean layer error is not below QuantEase's at 3 bits: {err}")
    check(parity["max_abs_diff_contiguous"] <= parity["tol"]
          and parity["max_abs_diff_paged"] <= parity["tol"], f"scorer vs engines: {parity}")
    check(parity["max_abs_diff_paged_contiguous"] <= SERVE_LOGIT_TOL * parity["max_abs_logit"],
          f"paged vs contiguous first-decode logits: {parity}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched by the quality table")
    for name in counts:
        check(name.replace("quantease_", "") in at_path,
              f"kernel {name} was not held against its plain version at phase 7's shapes")
    detail["quality"] = dict(doc=doc, train_log=log, launches=counts, train_launches=train_counts,
                             gemm_variants=variants, kernels_at_path_shapes=at_path)
    return {k: counts[k] + train_counts[k] for k in counts}, at_path, (plan, params)


# ---------------------------------------------------------------------------
# Phase 8: the command-line path at full width
# ---------------------------------------------------------------------------


def cli_path(dev, detail, root):
    """``repro_torch.launch.{train,quantize,eval,serve}`` in process
    (``main([...])``, stdout captured into ``chiprun_out/chip_smoke_cli.txt``)
    on Phi-3-mini at full width, 2 of 32 decoder layers, in the temporary
    directory ``root`` (phase 9 reads its training checkpoints; the caller
    removes it): train 4 steps (4 checkpoints); quantize with QuantEase at 4
    bits, then SpQR at 3 bits with ``--resume``; the eval grid (RTN, AWQ,
    SpQR, QuantEase and qe_outlier at 3 bits, 25 iterations) with the
    parity check; serve the quantize output on the paged engine (bf16, a
    repeat, int4 KV) and the contiguous one.  Returns the kernels' launch
    counts over the four CLIs; afterwards the eval's kernel calls are held
    against their plain versions and the QuantEase report against a direct
    ``ptq_quantize_model`` call."""
    import io
    import shutil

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.solver import PTQConfig, ptq_quantize_model
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.eval.harness import validate_doc
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.launch import eval as leval
    from repro_torch.launch import quantize as lquant
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.launch.common import load_params
    from repro_torch.launch.progress import load_progress
    from repro_torch.models import make_plan
    from repro_torch.quant import GridSpec

    cfg = configs.register(dataclasses.replace(configs.get_config("phi3_mini_3_8b"), name=CLI_ARCH,
                                               **MAIN_OVERRIDES))
    check(cfg.n_periods * len(cfg.pattern) == CLI_PERIODS, f"{CLI_ARCH}: {cfg.n_periods} periods")
    free = shutil.disk_usage(root).free / 2**30
    check(free >= CLI_DISK_GIB, f"phase 8 needs {CLI_DISK_GIB} GiB free under {root}, has {free:.1f}")
    train_dir, quant_dir = os.path.join(root, "train"), os.path.join(root, "quant")
    arch = ("--arch", CLI_ARCH)
    seconds, texts = {}, {}

    def run(label, cli, *argv):
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            res = cli.main([*arch, *argv, "--device", dev.type])
        torch.cuda.synchronize()
        seconds[label] = time.monotonic() - t0
        texts[label] = buf.getvalue()
        gc.collect()
        torch.cuda.empty_cache()
        return res

    try:
        ops.reset_launch_counts()
        log = run("train", ltrain, *CLI_TRAIN, "--ckpt-dir", train_dir)["log"]
        steps = ckpt.list_steps(train_dir)
        print(f"[cli] train: losses " + ", ".join(f"{m['step']}:{m['loss']:.4f}" for m in log)
              + f"; checkpoints {steps} ({seconds['train']:.1f}s)", flush=True)
        check(log and all(math.isfinite(m["loss"]) for m in log), f"train CLI losses {log}")
        check(steps == [1, 2, 3, 4], f"train CLI wrote checkpoints {steps}, expected 4")

        reports = {}
        for label, extra in (("quantease@4", ("--method", "quantease", "--bits", "4")),
                             ("spqr@3", ("--method", "spqr", "--bits", "3", "--resume"))):
            res = run(label, lquant, "--ckpt-dir", train_dir, "--out-dir", quant_dir,
                      "--seq", str(CLI_SEQ), "--iterations", str(CLI_ITERATIONS),
                      "--calib-batches", str(CLI_CALIB), *extra)
            reports[label] = res["report"]
            check(res["layers"] == 7 * cfg.n_periods and math.isfinite(res["mean_rel_error"]),
                  f"quantize CLI {label}: {res['layers']} layers, mean {res['mean_rel_error']}")
            recs = load_progress(os.path.join(quant_dir, "progress.jsonl"))
            check([r["done_blocks"] for r in recs] == list(range(1, cfg.n_periods + 1)),
                  f"quantize CLI {label}: progress.jsonl holds {recs}")
            print(f"[cli] quantize {label}: {res['layers']} layers mean_rel_error="
                  f"{res['mean_rel_error']:.6f} max={res['max_rel_error']:.6f}; progress.jsonl "
                  f"{len(recs)} records ({seconds[label]:.1f}s)", flush=True)
        check("previous run: 2/2 blocks" in texts["spqr@3"],
              "quantize CLI --resume did not report the previous run's progress")

        with recording_calls() as calls:
            doc = run("eval", leval, "--ckpt-dir", train_dir, "--out", os.path.join(root, "eval.json"),
                      *CLI_EVAL)
        eval_counts = ops.launch_counts()
        variants = dict(dequant_matmul_cuda.launches_by_variant)
        for r in doc["grid"]:
            print(f"[cli] eval {r['method']}@{r['bits']}: mean_layer_err={r['mean_layer_err']:.6f} "
                  f"ppl={r['ppl']:.4f} top1={r['top1']:.4f} choice_acc={r['choice_acc']:.4f}",
                  flush=True)
        problems = validate_doc(doc)
        print(f"[cli] eval: dense ppl={doc['dense']['ppl']:.4f}; parity {doc['parity']}; "
              f"validate_doc {problems}; launches {eval_counts}, dequant_matmul by variant "
              f"{variants} ({seconds['eval']:.1f}s)", flush=True)
        unexpected = [p for p in problems if not p.startswith(CLI_RECORDED)]
        check(not unexpected, f"the eval CLI's document fails validate_doc: {unexpected}")
        par = doc["parity"]
        check(max(par["max_abs_diff_contiguous"], par["max_abs_diff_paged"],
                  par["max_abs_diff_paged_contiguous"]) <= SERVE_LOGIT_TOL * par["max_abs_logit"],
              f"the eval CLI's parity: scorer and engines part by more than {SERVE_LOGIT_TOL} of "
              f"max |logit|: {par}")
        for name, n in eval_counts.items():
            check(n > 0, f"kernel {name} was not launched by the eval CLI")
        check(variants["tc_large"] > 0, f"the eval CLI's GEMMs took {variants}: tc_large expected")

        served = {}
        for label, extra in (("paged bf16", ()), ("paged bf16 repeat", ()),
                             ("paged int4", ("--kv-dtype", "int4")),
                             ("contiguous", ("--engine", "contiguous"))):
            k5 = ops.launch_counts()["paged_attention"]
            res = run(f"serve {label}", lserve, "--ckpt-dir", quant_dir, *CLI_SERVE, *extra)
            k5 = ops.launch_counts()["paged_attention"] - k5
            reqs = res["requests"]
            want_new = int(CLI_SERVE[CLI_SERVE.index("--max-new") + 1])
            check(len(reqs) == int(CLI_SERVE[1])
                  and all(r.status == "completed" and len(r.output) == want_new for r in reqs),
                  f"serve CLI {label}: {[(r.rid, r.status, len(r.output or [])) for r in reqs]}")
            paged = label.startswith("paged")
            want_k5 = res["n_decode_steps"] * cfg.n_periods * len(cfg.pattern) if paged else 0
            check(k5 == want_k5, f"serve CLI {label}: kernel 5 launched {k5} times, expected "
                                 f"{want_k5} (decode steps x periods)")
            served[label] = [r.output for r in reqs]
            print(f"[cli] serve {label}: {len(reqs)} requests x {want_new} tokens, "
                  f"{res['n_decode_steps']} decode steps, kernel 5 launched {k5} "
                  f"({seconds['serve ' + label]:.1f}s)", flush=True)
        check(served["paged bf16 repeat"] == served["paged bf16"],
              "the serve CLI's repeat paged bf16 run gave other tokens")
        counts = ops.launch_counts()

        t0 = time.monotonic()
        at_path = check_path_calls(calls, variants, phase="phase 8")
        del calls
        print(f"[cli] kernels against their plain versions on the eval CLI's calls: "
              + ", ".join(f"{k} {v['calls']} calls, max_abs_err {v['max_abs_err']:.3g}"
                          for k, v in at_path.items()) + f" ({time.monotonic() - t0:.1f}s)", flush=True)
        for name in counts:
            check(name.replace("quantease_", "") in at_path,
                  f"kernel {name} was not held against its plain version on the eval CLI's calls")

        # The quantize CLI's QuantEase report against the solver called
        # directly on the same loaded params and calibration batches.
        plan = make_plan(cfg)
        params, _ = load_params(train_dir, plan, dev)
        calib_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, 4, CLI_SEQ,
                                    split="calib")
        _, direct = ptq_quantize_model(plan, params, [calib_fn(i) for i in range(CLI_CALIB)],
                                       PTQConfig(method="quantease", spec=GridSpec(bits=4),
                                                 iterations=CLI_ITERATIONS), device=dev)
        del params
        cli_rep = reports["quantease@4"]
        rel = max(abs(cli_rep[k] - v) / v for k, v in direct.items())
        check(list(cli_rep) == list(direct) and rel <= CLI_REPORT_REL,
              f"quantize CLI report vs ptq_quantize_model: largest relative difference {rel}")
        print(f"[cli] quantize CLI quantease@4 against ptq_quantize_model on the same params and "
              f"batches: largest relative difference per layer {rel:.3g} (limit {CLI_REPORT_REL})",
              flush=True)
    finally:
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "chip_smoke_cli.txt"), "w") as fh:
            for label, text in texts.items():
                fh.write(f"==== {label} ({seconds[label]:.1f}s)\n{text}\n")
    print("[cli] wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()), flush=True)
    detail["cli"] = dict(seconds=seconds, reports=reports, doc=doc, validate_problems=problems,
                         served=served, launches=counts, eval_launches=eval_counts,
                         gemm_variants=variants, kernels_at_path_shapes=at_path,
                         report_rel_diff=rel)
    return counts, at_path


# ---------------------------------------------------------------------------
# Phase 9: speculative serving and the tuner at full width
# ---------------------------------------------------------------------------


def spec_agree(plain_trace, plain_out, spec_out, tol):
    """Per request, the speculative stream against the plain one: equal up
    to the first position where the plain run's top-2 margin is below
    ``tol`` × its max |logit| (a near-tie there may go either way).
    Returns ``(parted, compared)``: the requests parting before such a
    position, and the positions compared."""
    import numpy as np

    parted, compared = [], 0
    for rid, out in plain_out.items():
        for j, l in enumerate(plain_trace[rid]):
            top2 = np.sort(l)[-2:]
            if top2[1] - top2[0] < tol * float(np.abs(l).max()):
                break
            compared += 1
            if spec_out[rid][j] != out[j]:
                parted.append((rid, j))
                break
    return parted, compared


def _variant_delta(before) -> dict:
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda

    return {v: c - before[v] for v, c in dequant_matmul_cuda.launches_by_variant.items()}


def spec_serve(label, make_engine, prompts, new_tokens, gamma):
    """One engine run with every round watched: per round and lane the
    budget the engine gave the proposal and the tokens it then verified, the
    top-2 margin at each rejected position, and the dequant-GEMM's variants
    inside the verify calls and inside the draft calls.  Returns the run's
    numbers, the outputs and the engine."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.serve import Request

    eng = make_engine()
    free0 = eng.pool.n_free
    mgr = eng.spec_mgr
    rounds, rejections = [], []
    verify_variants = dict.fromkeys(dequant_matmul_cuda.launches_by_variant, 0)
    draft_variants = dict(verify_variants)
    budgets = {}

    def count_into(acc, fn):
        def call(*a, **kw):
            before = dict(dequant_matmul_cuda.launches_by_variant)
            out = fn(*a, **kw)
            for v, n in _variant_delta(before).items():
                acc[v] += n
            return out
        return call

    eng._verify = count_into(verify_variants, eng._verify)
    if mgr is not None:
        mgr._propose_fn = count_into(draft_variants, mgr._propose_fn)
        propose = mgr.propose

        def watched_propose(items):
            budgets.clear()
            budgets.update({lane: budget for lane, _, _, budget in items})
            return propose(items)

        mgr.propose = watched_propose
        commit = eng._commit

        def watched_commit(active, proposals, logits):
            for i in active:
                props = proposals[i]
                rounds.append((budgets.get(i, 0), len(props)))
                greedy = [int(np.argmax(logits[i, j])) for j in range(len(props) + 1)]
                a = next((j for j, (d, t) in enumerate(zip(props, greedy)) if d != t), len(props))
                if a < len(props):
                    l = logits[i, a]
                    top2 = np.sort(l)[-2:]
                    rejections.append(float((top2[1] - top2[0]) / np.abs(l).max()))
            return commit(active, proposals, logits)

        eng._commit = watched_commit
    k5 = ops.launch_counts()["paged_attention"]
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new_tokens))
    reqs = sorted(eng.run(), key=lambda r: r.rid)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    k5 = ops.launch_counts()["paged_attention"] - k5
    n_tok = sum(len(r.output) for r in reqs)
    cfg = eng.plan.cfg
    want_k5 = eng.n_decode_steps * cfg.n_periods * len(cfg.pattern)
    if mgr is not None:
        dcfg = mgr.cfg.draft_plan.cfg
        want_k5 += mgr.n_propose_calls * (gamma + 1) * dcfg.n_periods * len(dcfg.pattern)
    stats = dict(
        run=label, requests=len(reqs), tokens=n_tok, wall_s=wall, decode_s=eng.decode_seconds,
        propose_s=eng.propose_seconds, decode_tok_s=n_tok / eng.decode_seconds,
        decode_steps=eng.n_decode_steps, ms_per_round=eng.decode_seconds / eng.n_decode_steps * 1e3,
        spec_rounds=eng.n_spec_rounds, proposed=eng.n_draft_tokens, accepted=eng.n_draft_accepted,
        acceptance=eng.acceptance_rate(), propose_calls=mgr.n_propose_calls if mgr else 0,
        free_before=free0, free_after=eng.pool.n_free, k5_launches=k5, k5_expected=want_k5,
        verify_variants=verify_variants, draft_variants=draft_variants,
        short_rounds=[(b, n) for b, n in rounds if b >= 1 and n < min(gamma, b)],
        rounds_with_budget=sum(b >= 1 for b, _ in rounds), rejection_margins=rejections,
        statuses=sorted({r.status for r in reqs}),
    )
    acc = "-" if stats["acceptance"] is None else f"{stats['acceptance']:.3f}"
    print(f"[spec] {label}: {n_tok} tokens, decode {stats['decode_tok_s']:.1f} tok/s, "
          f"{stats['ms_per_round']:.2f} ms per round over {eng.n_decode_steps} rounds "
          f"({eng.n_spec_rounds} speculative, propose {eng.propose_seconds:.2f}s of "
          f"{eng.decode_seconds:.2f}s); proposed {eng.n_draft_tokens}, accepted "
          f"{eng.n_draft_accepted} (rate {acc}); propose calls {stats['propose_calls']}; free "
          f"pages {free0} -> {eng.pool.n_free}; kernel 3 by variant in the verify "
          f"{verify_variants}, in the draft {draft_variants}; kernel 5 launched {k5} (expected "
          f"{want_k5}); rounds with budget {stats['rounds_with_budget']}, short "
          f"{len(stats['short_rounds'])}; wall {wall:.2f}s", flush=True)
    check(len(reqs) == len(prompts) and stats["statuses"] == ["completed"]
          and all(len(r.output) == new_tokens for r in reqs),
          f"{label}: {[(r.rid, r.status, len(r.output)) for r in reqs]}")
    check(eng.pool.n_free == free0 and eng.pool.n_free == eng.n_pages - 1,
          f"{label}: {free0} free pages before, {eng.pool.n_free} after (of {eng.n_pages - 1})")
    check(k5 == want_k5, f"{label}: kernel 5 launched {k5} times, expected {want_k5} "
                         "((verify rounds + propose steps) x periods)")
    check(verify_variants["simt"] == 0 and verify_variants["tc_large"] == 0,
          f"{label}: the verify's GEMMs took {verify_variants}; tc_small only expected")
    if mgr is not None:
        check(eng.n_draft_tokens > 0, f"{label}: no draft token was proposed")
        check(not stats["short_rounds"],
              f"{label}: rounds proposed fewer than min(gamma, budget) tokens: "
              f"{stats['short_rounds'][:8]}")
        for r in reqs:
            check(len(r.output) == r.n_draft_accepted + r.n_spec_rounds,
                  f"{label}: request {r.rid}'s accounting {len(r.output)} != "
                  f"{r.n_draft_accepted} + {r.n_spec_rounds}")
    return stats, {r.rid: r.output for r in reqs}, eng


def verify_and_draft_calls(dev, plan, artifact, draft_plan, draft_params, prompts, gamma):
    """One verify call (B = 8 lanes, L = γ + 1) of the served artifact against
    L sequential ``paged_decode_step`` calls on a copy of the same cache, and
    one ``paged_draft_tokens`` call of the RTN draft; both calls' kernel 3
    and kernel 5 launches held against their plain versions at phase 3's
    tolerances (:func:`check_path_calls`).  Returns the verify's largest
    |Δ logit| as a share of max |logit| and the kernels' checks."""
    import numpy as np
    import torch

    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.models import model as M

    B, L, psz = len(prompts), gamma + 1, PAGE
    rng = np.random.default_rng(9)
    pages = [-(-(len(p) + L) // psz) for p in prompts]
    n_pages = 1 + sum(pages)
    table = np.zeros((B, max(pages)), np.int32)
    nxt = 1
    for b, n in enumerate(pages):
        table[b, :n] = np.arange(nxt, nxt + n)
        nxt += n
    checks = {}
    for who, pl, prm in (("verify", plan, artifact), ("draft", draft_plan, draft_params)):
        cache = M.init_paged_cache(pl, n_pages, psz, device=dev)
        dt = torch.as_tensor(table, device=dev)
        for b, p in enumerate(prompts):
            for off in range(0, len(p), SPEC_PAGED["prefill_chunk"]):
                buf = np.zeros((1, SPEC_PAGED["prefill_chunk"]), np.int32)
                chunk = p[off : off + SPEC_PAGED["prefill_chunk"]]
                buf[0, : len(chunk)] = chunk
                M.paged_prefill_chunk(pl, prm, buf, cache, dt[b : b + 1], off)
        pos0 = np.array([len(p) - 1 for p in prompts], np.int64)
        wp = np.array([[table[b, (pos0[b] + j) // psz] for j in range(L)] for b in range(B)])
        toks = np.concatenate([np.array([[p[-1]] for p in prompts]),
                               rng.integers(0, pl.cfg.vocab, (B, L - 1))], 1).astype(np.int32)
        copy = {k: {n: t.clone() for n, t in v.items()} for k, v in cache.items()}
        before = dict(dequant_matmul_cuda.launches_by_variant)
        with recording_calls(kept=1) as calls:
            if who == "verify":
                got, _ = M.paged_verify_tokens(pl, prm, toks, cache, pos0, dt, wp)
            else:
                got, _ = M.paged_draft_tokens(pl, prm, toks, np.ones(B, np.int32), cache, pos0,
                                              dt, wp)
        variants = _variant_delta(before)
        checks[who] = check_path_calls(calls, variants, phase=f"phase 9 {who}")
        del calls
        if who == "verify":
            got = got.float().cpu().numpy()
            seq = []
            for j in range(L):
                lg, _ = M.paged_decode_step(pl, prm, toks[:, j : j + 1], copy, pos0 + j, dt, wp[:, j])
                seq.append(lg.float().cpu().numpy())
            seq = np.stack(seq, 1)
            share = float(np.abs(got - seq).max() / np.abs(seq).max())
            print(f"[spec] verify of {B} lanes x {L} positions against {L} sequential decode steps: "
                  f"max |Δ logit| {share:.3g} of max |logit| (tolerance {SERVE_LOGIT_TOL}); its "
                  f"GEMMs by variant {variants}", flush=True)
            check(share <= SERVE_LOGIT_TOL, f"verify vs sequential decode: {share} of max |logit|")
            check(variants["tc_small"] > 0 and variants["tc_large"] == variants["simt"] == 0,
                  f"the verify's GEMMs at m = {B * L} took {variants}: tc_small only expected")
        else:
            print(f"[spec] draft call ({B} lanes x {L} steps, {draft_params['dec']['b0']['wq'].bits}-"
                  f"bit RTN codes): GEMMs by variant {variants}", flush=True)
            check(variants["tc_small"] > 0 and variants["simt"] == 0,
                  f"the draft's GEMMs at m = {B} took {variants}")
        del cache, copy
    return share, checks


def speculation(dev, detail, plan, artifact, dense, quality_model):
    """Phase 9 (a) and (b): the ``quantease@4`` artifact (Phi-3-mini, full
    width, 2 of 32 layers) served with γ = 4 by no draft, the target itself,
    a 3-bit RTN draft of the dense params and the 1-period truncation; then
    the trained ``bench_opt_s`` of phase 7 with a 3-bit RTN and a 1-period
    draft.  Afterwards one verify and one draft call are held against
    their plain versions.  Returns the kernels' launch counts over the
    served runs and those checks."""
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.serve import PagedServingEngine
    from repro_torch.serve.qparams import rtn_quantize_for_serving
    from repro_torch.serve.spec import SpecConfig, truncate_draft

    def runs_against_plain(tag, make_engine, drafts, prompts):
        """Each draft's run (the first, "plain", has none), one engine at a
        time, each speculative stream held to the plain one."""
        runs, plain = {}, None
        for label, spec in drafts.items():
            stats, out, eng = spec_serve(f"{tag}{label}", lambda: make_engine(spec), prompts,
                                         SPEC_NEW_TOKENS, SPEC_GAMMA)
            runs[label] = stats
            if plain is None:
                plain = (eng.logit_trace, out)
                continue
            del eng
            gc.collect()
            parted, compared = spec_agree(*plain, out, SERVE_LOGIT_TOL)
            stats["margin_rule"] = dict(parted=parted, compared=compared)
            print(f"[spec] {tag}{label} against plain under the margin rule: {compared} "
                  f"positions compared, parted at {parted}; identical streams "
                  f"{sum(out[i] == plain[1][i] for i in out)} of {len(out)}", flush=True)
            check(not parted, f"{tag}{label}: the speculative stream parts from the plain one "
                              f"above the margin at {parted}")
        return runs

    cfg = plan.cfg
    prompts = serve_traffic(cfg.vocab)[:SPEC_REQUESTS]
    ample = 1 + SPEC_PAGED["max_batch"] * -(-SPEC_PAGED["max_seq"] // PAGE)
    rtn, rtn_layout = rtn_quantize_for_serving(plan, dense, bits=SPEC_DRAFT_BITS)
    drafts = {
        "plain": None,
        "self-draft": SpecConfig(draft_plan=plan, draft_params=artifact, gamma=SPEC_GAMMA),
        f"{SPEC_DRAFT_BITS}-bit RTN draft": SpecConfig(draft_plan=plan, draft_params=rtn,
                                                       gamma=SPEC_GAMMA),
        "1-period draft": SpecConfig(*truncate_draft(plan, artifact, 1), gamma=SPEC_GAMMA),
    }
    ops.reset_launch_counts()
    t0 = time.monotonic()
    runs = runs_against_plain("", lambda spec: PagedServingEngine(
        plan, artifact, **SPEC_PAGED, n_pages=SPEC_POOL * ample, spec=spec, record_logits=True,
        device=dev), drafts, prompts)
    t_a = time.monotonic() - t0
    margins = runs["self-draft"]["rejection_margins"]
    print(f"[spec] self-draft: {len(margins)} rejections, the largest top-2 margin at one "
          f"{max(margins, default=0.0):.3g} of max |logit| (tolerance {SERVE_LOGIT_TOL}); "
          f"RTN draft layout {rtn_layout}; {t_a:.1f}s", flush=True)
    check(max(margins, default=0.0) < SERVE_LOGIT_TOL,
          f"the self-draft was rejected at top-2 margins {sorted(margins)[-4:]} of max |logit|")

    # (b) Acceptance on a model whose logits carry signal: random Phi-3
    # weights give near-uniform logits, so (a)'s rates say nothing of a draft.
    t0 = time.monotonic()
    qplan, qparams = quality_model
    fn, _ = make_batch_fn(DataConfig(vocab=qplan.cfg.vocab, seed=0), qplan.cfg, SPEC_REQUESTS,
                          SPEC_TRAINED_PROMPT, split="eval")
    qprompts = [t.astype("int32") for t in fn(0)["tokens"]]
    qdrafts = {
        "plain": None,
        f"{SPEC_DRAFT_BITS}-bit RTN draft": SpecConfig(
            qplan, rtn_quantize_for_serving(qplan, qparams, bits=SPEC_DRAFT_BITS)[0],
            gamma=SPEC_GAMMA),
        "1-period draft": SpecConfig(*truncate_draft(qplan, qparams, 1), gamma=SPEC_GAMMA),
    }
    trained = runs_against_plain(f"{qplan.cfg.name} ", lambda spec: PagedServingEngine(
        qplan, qparams, **SPEC_TRAINED, spec=spec, record_logits=True, device=dev),
        qdrafts, qprompts)
    counts = ops.launch_counts()
    variants = dict(dequant_matmul_cuda.launches_by_variant)
    print(f"[spec] {qplan.cfg.name} (trained {QUALITY_TRAIN['steps']} steps): acceptance "
          + ", ".join(f"{k} {v['acceptance']:.3f}" for k, v in trained.items()
                      if v["acceptance"] is not None)
          + f" ({time.monotonic() - t0:.1f}s); launches over phase 9's served runs: {counts}, "
          f"dequant_matmul by variant {variants}", flush=True)
    for name in ("dequant_matmul", "paged_attention"):
        check(counts[name] > 0, f"kernel {name} was not launched by speculative serving")

    # One verify and one draft call against their plain versions (after the
    # counts were read: these launches are checks).
    share, path_checks = verify_and_draft_calls(dev, plan, artifact, plan, rtn, prompts, SPEC_GAMMA)
    detail["speculation"] = dict(runs=runs, trained=trained, verify_share=share,
                                 kernels_at_path=path_checks, launches=counts,
                                 gemm_variants=variants, seconds_a=t_a)
    return counts, path_checks


def tune_cli(dev, detail, root, train_dir):
    """Phase 9 (c): ``repro_torch.launch.tune`` in process on
    ``phi3_mini_3_8b_2l`` from phase 8's training checkpoint, then with
    ``--resume`` (every candidate replayed); then ``launch.serve`` on the
    tuner's output, plain and with ``--speculate --draft-bits 3`` and
    ``--speculate --draft-layers 1``.  Returns the kernels' launch counts
    over the CLIs."""
    import io

    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import tune as ltune
    from repro_torch.launch.progress import load_progress
    from repro_torch.tune import search

    tune_dir = os.path.join(root, "tune")
    seconds, texts, per_cand = {}, {}, []
    evaluate = search.evaluate_candidate

    def counted(*a, **kw):
        before = ops.launch_counts()["dequant_matmul"]
        res = evaluate(*a, **kw)
        per_cand.append((res["label"], ops.launch_counts()["dequant_matmul"] - before))
        return res

    def run(label, cli, *argv):
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            res = cli.main(["--arch", CLI_ARCH, *argv, "--device", dev.type])
        torch.cuda.synchronize()
        seconds[label] = time.monotonic() - t0
        texts[label] = buf.getvalue()
        gc.collect()
        torch.cuda.empty_cache()
        return res

    ops.reset_launch_counts()
    search.evaluate_candidate = counted
    try:
        doc = run("tune", ltune, "--ckpt-dir", train_dir, "--out-dir", tune_dir, *TUNE_CLI)
        evaluated = list(per_cand)
        per_cand.clear()
        tune_counts = ops.launch_counts()
        variants = dict(dequant_matmul_cuda.launches_by_variant)
        resumed = run("tune --resume", ltune, "--ckpt-dir", train_dir, "--out-dir", tune_dir,
                      *TUNE_CLI, "--resume")
    finally:
        search.evaluate_candidate = evaluate
    cands = doc["candidates"]
    print("[tune] candidates: " + "; ".join(
        f"{c['label']} avg_bits {c['avg_bits']} ppl {c['ppl']:.4f} mean_layer_err "
        f"{c['mean_layer_err']:.6f}" + (f" bits {c['bits_histogram']}" if "bits_histogram" in c else "")
        for c in cands) + f"; winner {doc['best']['label']}; kernel 3 launches per candidate "
        f"{evaluated}; launches {tune_counts}, dequant_matmul by variant {variants} "
        f"({seconds['tune']:.1f}s); --resume replayed {len(resumed['candidates'])} and evaluated "
        f"{len(per_cand)} ({seconds['tune --resume']:.1f}s)", flush=True)
    check(doc["best"]["ppl"] <= doc["uniform"]["ppl"],
          f"the tuner's winner {doc['best']} is worse than uniform {doc['uniform']}")
    check(len(evaluated) == len(cands) and all(n > 0 for _, n in evaluated),
          f"kernel 3 launches per candidate artifact: {evaluated}")
    check(tune_counts["quantease_block_sweep"] > 0 and tune_counts["quantease_fused_iteration"] > 0,
          f"the tuner's QuantEase solves did not launch kernels 1 and 2: {tune_counts}")
    check(f"resume: {len(cands)} candidate(s) already evaluated" in texts["tune --resume"]
          and not per_cand and resumed["candidates"] == cands and resumed["best"] == doc["best"],
          f"tune --resume: {texts['tune --resume'][:300]}")
    recs = load_progress(os.path.join(tune_dir, "progress.jsonl"))
    check(sum("candidate" in r for r in recs) == len(cands),
          f"progress.jsonl holds {sum('candidate' in r for r in recs)} candidate records")

    served = {}
    for label, extra in (("plain", ()), ("--draft-bits 3", ("--speculate", "--draft-bits", "3")),
                         ("--draft-layers 1", ("--speculate", "--draft-layers", "1"))):
        k5 = ops.launch_counts()["paged_attention"]
        res = run(f"serve {label}", lserve, "--ckpt-dir", tune_dir, *CLI_SERVE, "--record-logits",
                  *extra)
        k5 = ops.launch_counts()["paged_attention"] - k5
        reqs = res["requests"]
        want_new = int(CLI_SERVE[CLI_SERVE.index("--max-new") + 1])
        check(all(r.status == "completed" and len(r.output) == want_new for r in reqs),
              f"serve {label} on the tuner's output: "
              f"{[(r.rid, r.status, len(r.output or [])) for r in reqs]}")
        want_k5 = res["n_decode_steps"] * CLI_PERIODS
        line = ""
        if "spec" in res:
            sp = res["spec"]
            want_k5 += sp["propose_calls"] * (TUNE_SERVE_GAMMA + 1) * sp["draft_periods"]
            line = next((l for l in texts[f"serve {label}"].splitlines()
                         if l.startswith("speculative:")), "")
            check(bool(line) and sp["draft_tokens"] > 0, f"serve {label}: no speculative report")
            parted, compared = spec_agree(served["plain"][0], served["plain"][1],
                                          {r.rid: r.output for r in reqs}, SERVE_LOGIT_TOL)
            check(not parted, f"serve {label}: parts from the plain serve above the margin at {parted}")
            line += f"; against plain: {compared} positions compared, none parted"
        check(k5 == want_k5, f"serve {label}: kernel 5 launched {k5}, expected {want_k5}")
        served[label] = (res["logit_trace"], {r.rid: r.output for r in reqs})
        print(f"[tune] serve {label} on the tuner's output: {len(reqs)} requests x {want_new} "
              f"tokens, {res['n_decode_steps']} decode rounds, kernel 5 launched {k5}"
              + (f"; {line}" if line else "") + f" ({seconds['serve ' + label]:.1f}s)", flush=True)
    counts = ops.launch_counts()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_tune_cli.txt"), "w") as fh:
        for label, text in texts.items():
            fh.write(f"==== {label} ({seconds[label]:.1f}s)\n{text}\n")
    detail["tune_cli"] = dict(seconds=seconds, doc=doc, per_candidate_gemm_launches=evaluated,
                              launches=counts, gemm_variants=variants)
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
    print(f"[build] paged_attention (q, kind, threads, tile), -Xptxas -v: "
          f"{ptxas_summary('paged_attention')}", flush=True)

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
    t0 = time.monotonic()
    check_legacy_engines(gen, dev, detail)
    print(f"[phase] 3, the legacy engines: {time.monotonic() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    card_tests()
    torch.cuda.empty_cache()
    counts_ptq, plan, artifact, dense = main_path(dev, detail)
    expected = sum(x["launches_on_path"] for x in detail["block_sweep"])
    check(counts_ptq["quantease_block_sweep"] == expected,
          f"kernel 1 launched {counts_ptq['quantease_block_sweep']} times on the PTQ path, "
          f"phase 3's launches per shape sum to {expected}")
    print(f"[main] kernel 1's launches on the PTQ path {counts_ptq['quantease_block_sweep']} = the "
          f"sum of phase 3's launches per shape", flush=True)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    counts_train = train_full_width(dev, detail)
    print(f"[phase] 5b, training at full width: {time.monotonic() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    counts_serve = serving(dev, detail, plan, artifact)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    counts_quality, at_path, quality_model = quality_table(dev, detail, card)
    print(f"[phase] 7, the quality table: {time.monotonic() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.monotonic()
        counts_cli, at_cli = cli_path(dev, detail, root)
        print(f"[phase] 8, the command-line path: {time.monotonic() - t0:.1f}s", flush=True)
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        counts_spec, at_spec = speculation(dev, detail, plan, artifact, dense, quality_model)
        del artifact, dense, quality_model
        gc.collect()
        torch.cuda.empty_cache()
        counts_tune = tune_cli(dev, detail, root, os.path.join(root, "train"))
        print(f"[phase] 9, speculation and the tuner at full width: {time.monotonic() - t0:.1f}s",
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # Each path's counts were read just after it ran, from 0.
    paths = dict(ptq=counts_ptq, train=counts_train, serving=counts_serve, quality=counts_quality,
                 cli=counts_cli, speculation=counts_spec, tune=counts_tune)
    counts = {k: sum(c[k] for c in paths.values()) for k in counts_ptq}
    detail["launches"] = paths

    kernels = []
    for name, (_, source, replaces) in ops.KERNELS.items():
        m = measured[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=counts[name],
            max_abs_err=m["max_abs_err"], ms=m["ms"], plain_ms=m["plain_ms"],
            bound_ms=m["bound_ms"], bound_by=m["bound_by"], library_ms=m["library_ms"],
            shape=m["shape"],
            **{k: m[k] for k in ("call_ms", "library_bf16_ms", "corr_ms", "suffix_ms") if k in m},
            quality_calls_checked=at_path[name.replace("quantease_", "")]["calls"],
            quality_max_abs_err=at_path[name.replace("quantease_", "")]["max_abs_err"],
            cli_calls_checked=at_cli[name.replace("quantease_", "")]["calls"],
            cli_max_abs_err=at_cli[name.replace("quantease_", "")]["max_abs_err"],
            spec_calls_checked=sum(c.get(name.replace("quantease_", ""), {}).get("calls", 0)
                                   for c in at_spec.values()),
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
