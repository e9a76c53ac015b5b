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
   each with a 25-iteration solve of kernel path against plain path (the
   plain engine's iterations replayed from CUDA graphs) and its
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
   at small and ragged shapes; it runs in a pytest process of its own
   beside phases 7 and 8 (host-bound: a small model's training and the
   command-line tools), and the script waits for it after phase 8;
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
   steps' GEMMs must run tc_small (no simt launch) (its profiled runs, a
   paged bf16 run of 8 requests and 8 users at 3584-4032 tokens of
   context, were cut for time: PERF.md §4);
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
   temporary directory checked for free space first: 2 training steps at 4
   x 512 (every loss finite, 2 checkpoints); QuantEase at 4 bits, then SpQR
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
   rule (output in ``chiprun_out/chip_smoke_tune_cli.txt``);
10. the other architectures at full width, seeded random bf16 weights,
   what the previous config left freed first: (a) OLMoE-1B-7B (1 of 16
   decoder layers, 64 experts of d_ff 1024, top-8): RTN and QuantEase at
   4 bits, QuantEase and qe_outlier (1 %) at 3 bits on one calibration
   batch of 16 x 512 tokens, each restacked and scored by ``eval_model``;
   seconds per decoder layer and the solver's groups (G, q, p), which
   must be 128 x (1024, 2048), 64 x (2048, 1024) and 4 x (2048, 2048); 64
   ``.e{i}`` report keys per MoE matrix and period; mean per-expert error
   quantease < rtn at 4 bits and qe_outlier < quantease at 3; kernels 1, 2,
   3 and 4 launched; then the ``quantease@4`` artifact serves 8 of phase
   6's prompts x 32 new tokens (paged, bf16 KV); (b) Qwen1.5-32B,
   StableLM-2-12B (bf16 and int4 KV: head dim 160), Gemma 2's local and
   global pair (window 4096, both softcaps, vocab 256,000) and OPT-66B
   (learned positions, d_ff 36,864), one period each: QuantEase at 4 bits
   (25 iterations, 4 x 512 calibration tokens), ``eval_model`` on 2
   batches of 2 x 512 (perplexity finite), 4 requests of 16-512 tokens x 16
   new; (c) Mixtral-8x22B, one layer (8 experts of (16384, 6144), G = 6
   heads a kv head, window 4096): a 4-bit RTN artifact serves 4 requests x
   16 new.  Every paged run completes with kernel 5 launched once per
   decode step and attention layer, and each config's kernel 3 and 5
   calls are held against their plain versions (one kept call per
   signature; kernel 5 within ``PAGED_ATOL`` scaled by max |out| above 1),
   with kernel 5's plan printed per head shape; of OLMoE's CD calls two
   signatures, right after their group's solve: the 64-expert group's
   quantizing fused iteration at 4 bits and its outlier-aware iteration
   (kernels 2 and 4, kernel 1 on each of their blocks), and of OPT-66B
   one: a quantizing fused iteration at p = 36,864 and its 144 block
   sweeps;
11. Mamba-2 and the hybrid Jamba at full width, seeded random bf16 weights:
   (a) Mamba-2-2.7B (4 of 64 layers; d 2560, 80 SSD heads of 64, state
   128, vocab 50,280 tied): RTN and QuantEase at 4 bits, QuantEase and
   qe_outlier (1 %) at 3 bits on one calibration batch of 16 x 512 tokens,
   each restacked and scored by ``eval_model`` on 2 batches of 2 x 512;
   the solver's groups must be 2 x (5120, 2560), 1 x (256, 2560) and 1 x
   (2560, 5120), the report keys wz, wx, wbc, out_proj (never wdt), mean
   error quantease < rtn at 4 bits and qe_outlier < quantease at 3; then
   the ``quantease@4`` artifact serves 8 of phase 6's prompts x 32 new
   tokens on the contiguous engine (tc_small at decode, no simt); (b)
   Jamba-1.5-Large, its period cut to two blocks: (i) blocks 0 and 2
   (attention and Mamba, dense MLPs; 64 heads of 128, kv 8, 256 SSD heads,
   d_ff 24,576): QuantEase at 4 bits on wz, wx, wbc and out_proj through
   ``layer_specs``, RTN on the other leaves, on 4 x 512 calibration tokens
   (QuantEase groups 2 x (16384, 8192), 1 x (256, 8192), 1 x (8192,
   16384)), then ``eval_model`` on 2 x 2 x 512; (ii) blocks 0 and 1 (the
   Mamba block with 16 experts of d_ff 24,576, top-2): a 4-bit RTN artifact
   serves 4 requests of 16-512 tokens x 16 new on the contiguous engine.
   Seconds per decoder layer per method, ms per decode step, kernel 3's
   launches by variant and peak device memory are printed; every kernel
   call is held against its plain version as in phase 10 (kernels 1, 2 and
   4 right after each group solve, kernel 3 at the end, one call a
   signature).
12. the encoder-decoder and prefix families at full width, seeded random
   bf16 weights: (a) Whisper-large-v3 (4 of 32 encoder and 4 of 32 decoder
   periods; d 1,280, 20 heads of 64, d_ff 5,120, 1,500 frames): RTN and
   QuantEase at 4 bits, QuantEase and qe_outlier (1 %) at 3 bits on 4
   calibration batches of 4 x 448 tokens with their frames, the encoder
   first, both stacks restacked (``solver_qt_enc``); then the
   ``quantease@4`` artifact prefills 4 sequences (a 4-token prompt and
   their frames) and takes 32 greedy decode steps; (b) LLaVA-NeXT-34B (2
   of 60 layers; d 7,168, 56 heads in 8 KV groups, d_ff 20,480): RTN and
   QuantEase at 4 bits on 4 batches of 4 x 512 tokens after their 2,880
   patches, then 2 sequences (2,880 patches and 32 tokens) prefill and
   take 16 greedy decode steps.  Seconds per layer per stack and method,
   mean error per stack and leaf kind (self-attention, cross-attention,
   MLP), ms per decode step, kernel 3's launches by variant and peak
   device memory are printed; QuantEase@4 must lie below RTN@4 in each
   stack and qe_outlier@3 below QuantEase@3, every logit must be finite,
   and the first decode step's logits must lie within 0.05 of max |logit|
   of a prefill over the prompt and that token (the reference's own bound
   in ``tests/test_models.py``); every kernel call is held against its
   plain version as in phase 10 (kernels 1, 2 and 4 right after each group
   solve, kernel 3 at the end, one call a signature).  Kernel 5 does not
   run: paged serving refuses both families, as in the reference.
13. the data-parallel mesh (run right after phase 5b, on its model): (a)
   two ranks on the one card, joined by gloo (NCCL refuses two ranks on
   one device; gloo takes the CUDA tensors of every collective used here),
   started with ``spawn`` after the kernels were built, each running
   ``ptq_quantize_model(mesh=)`` with QuantEase at 4 bits on its 8 of phase
   5's 16 calibration sequences and its half of every group's rows through
   kernels 1 and 2 (kernels 1 and 2 held against their plain versions on
   one of its calls per signature); every rank's params, Σ's and artifact
   the same bits; each group's Σ within 1e-5 of max |Σ| of a local Σ of
   the same 16 sequences (period 0's inputs phase 5's, period 1's the
   sharded artifact's period 0 output); the codes those of the local solve
   on that Σ (in period 0 phase 5's own ``quantease@4``) outside rows that
   start at a verified rounding tie (both solves replayed iteration by
   iteration); the mean error within 1e-4 of phase 5's; the restacked
   artifact's perplexity within 1e-3 relative of phase 5's beyond the
   largest move of two local solves whose Σ sums the same sequences in
   another exact fp32 order (the batches reversed; the ranks' blocks),
   which tie cascades on a random model reach; seconds per layer against
   phase 5's and the
   bytes each collective moved are printed (no speed-up is expected on one
   card); (b) ``Trainer(mesh=<data mesh of 1>, fsdp=True)`` in a one-rank
   NCCL group takes 2 steps of phase 5b's batches: losses within 1e-5
   relative of phase 5b's first two (bit for bit recorded), ms per step,
   peak memory, and the checkpoint round trip bit for bit; (c) after (a)
   the same ranks, as a ("model",) axis of 2, each cut their half of the
   restacked artifact (``dist.sharding.shard_tree``: every leaf's storage
   its shard, sharded leaves half, replicated ones whole) and serve 8
   requests × 16 greedy steps on the paged engine with bf16 and with int8
   KV (kernel 3 on column and row shards, fp32 partials all-reduced;
   kernel 5 on 16 kv slots; every kernel-3 and kernel-5 signature held
   against its plain version once); the parent serves the whole artifact
   on one rank with the same requests: the ranks' tokens the same, their
   first decode step's logits within 2 % of max |logit| of the one-rank
   run's, their tokens equal up to its first top-2 margin below that
   bound; launches, the collectives' calls, bytes and seconds, and ms per
   decode step against one rank are printed (kernel 3's fp32 partials cost
   nothing measurable against bf16 out: PERF.md); (g) right after (c) the
   same ranks serve (c)'s prompts on their shard speculatively (γ = 4; the
   1-period draft of the shard and an RTN@3 draft of the whole dense stack
   cut by ``shard_tree``), each stream held to (c)'s bf16 stream under the
   margin rule, with no page leaked and no round short of min(γ, budget),
   then under the SLO scheduler on a 40-page pool with mixed requests
   (deadlines none, generous, expiring mid-generation and provably
   unmeetable; priorities 0-2): rank 0's engine on a virtual clock, rank
   1's on ``time.monotonic() + 1e3``, every reading rank 0's, broadcast;
   both ranks must agree in every output, request and counter, request 4
   must expire, request 8 be shed and one request be preempted; then again
   with rank 0 on ``time.monotonic()`` and deadlines the card's timing
   decides, where only the ranks' agreement is required; the
   `[tp-spec]` and `[tp-slo]` lines print tok/s and ms a round against
   (c)'s ms a step, the acceptance, the collectives a round and the
   clock's readings; every kernel-3 and kernel-5 signature of (g) held
   against its plain version once; (d) the same
   ranks stay up, their card freed, until phases 10 and 11 have run: then
   each loads on the CPU the artifact those phases saved (10 (a)'s OLMoE
   quantease@4, one layer; 11 (b)(ii)'s Jamba blocks 0+1 RTN@4, 7.5 GB),
   moves its shard alone to the card (every leaf's storage its shard) and
   serves their requests with their engine settings (OLMoE paged, bf16 KV,
   8 x 32, its 64 experts 32 a rank; Jamba contiguous, 4 x 16: kv 8 -> 4,
   d_ff 24,576 -> 12,288, 256 SSD heads -> 128, 16 experts -> 8); those
   phases' served runs, their logits recorded, are the one-rank baselines:
   the ranks' tokens and router ids the same, their first decode step's
   logits within 2 % of max |logit| of the one-rank run's (a lane past it
   only at a router crossing: a top-k boundary whose one-rank probability
   gap is under 1e-2, on which the ranks' ids part; each printed), no
   token parting above the one-rank run's top-2 margin rule; every kernel-3
   and kernel-5 signature held against its plain version once; kernel 3's
   launches a decode step against one rank's, the collectives, ms per
   decode step and peak memory a rank printed; (e) then the same ranks, as
   a ("model",) axis of 2, train 2 steps each (``Trainer(mesh=)``: the
   model axis' collectives in the forward and backward passes, the
   vocabulary-parallel cross-entropy) of phase 5b's model (held against
   phase 5b's first 2 steps), OLMoE-1B-7B at one layer (32 of 64 experts a
   rank) and Mamba-2-2.7B at 2 of 64 layers (40 of 80 SSD heads a rank),
   from the seeded whole params of the one-rank run, which the parent
   trains for the last two while the ranks work: losses and gradient
   norms within 5e-3 relative of the one-rank run's, the params after step
   2 off its by at most 5 % of how far it moved them beyond a control's
   distance (the one-rank run again with its heads and ffn units permuted:
   bf16 params round apart under any other summation order), the loss and
   every leaf held whole the same bits on both ranks before each step and
   after the last, every rank's storage its shard; the `[tp-train]` lines
   print those, ms per step against one rank, peak memory and the
   collectives' calls, bytes and seconds; (f) the same ranks wait, their
   card freed, through phase 12, which saves its two served QuantEase@4
   artifacts with their batches and records its greedy runs' logits: then
   each rank loads each artifact on the CPU, moves its shard alone to the
   card (Whisper-large-v3 4 + 4 periods, both stacks quantized: 10 of 20
   heads, cross caches (4, 1,500, 10, 64) a layer, 25,933 of 51,866
   vocabulary rows; LLaVA-NeXT-34B 2 layers: 28 q and 4 kv heads, d_ff
   10,240, 32,000 rows) and prefills and decodes the same inputs greedily
   (4 × 32 and 2 × 16 steps), held against phase 12's runs as (d) holds
   its families (logits 2 %, the margin rule, bytes, kernel 3's calls
   against its plain version), one decode step's collectives counted (the
   embedding's all-reduce, one a layer for ``wo``, ``wo_c`` and ``wd``,
   the logits' gather); then they train 2 steps of Whisper at 1 + 1
   periods (4 × 448 tokens with their frames) and LLaVA at one layer (2 ×
   (2,880 patches + 512 tokens)) held as (e) holds its models, the parent
   training the one-rank runs and controls (heads, cross-attention heads
   and ffn units of both stacks permuted) beside them.  The ranks stop
   after (f).
   A failed collective or rank fails the phase.

The second-to-last line is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.  Per-shape details go to
``chiprun_out/chip_smoke_detail.json``.
"""

from __future__ import annotations

import atexit
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
# Phase 13: the data-parallel mesh.  (a) Two gloo ranks on the one card run
# phase 5's QuantEase@4 PTQ, each on its block of the calibration sequences
# and its rows of each group; (b) the FSDP trainer at world size 1 over NCCL.
SHARD_RANKS = 2
SHARD_TIMEOUT_S = 600  # a rank that reports nothing in this long fails the phase
SHARD_SIGMA_RTOL = 1e-5  # each group's Σ against phase 5's, of max |Σ|
SHARD_ERR_ATOL = 1e-4  # the mean relative error against phase 5's quantease@4
# The restacked artifact's perplexity against phase 5's: within this plus
# the largest deviation of the local solves whose Σ sums the same sequences
# in another exact order (their tie cascades move a random model's
# perplexity).  Those controls are two more local solves and evaluations
# (~6 s), the same to the last bit on every card run (NVIDIA H100 80GB
# HBM3; PERF.md, PRs 25–26): their recorded deviations stand here.
SHARD_PPL_RTOL = 1e-3
SHARD_PPL_CONTROLS = {"batches reversed": 0.00526163611809527,
                      "ranks' blocks": 0.002760105400254398}
SHARD_TRAIN_STEPS = 2
SHARD_LOSS_RTOL = 1e-5  # the FSDP trainer's losses against phase 5b's first steps
# (c) Tensor-parallel serving: the same ranks, as a ("model",) axis of 2,
# each serve their shard of the sharded solve's QuantEase@4 artifact (Phi-3-
# mini's 32 heads and 32,064-token vocabulary split in halves: no padding)
# on the paged engine, bf16 and int8 KV; the parent serves the whole
# artifact on one rank with the same requests.
TP_RANKS = SHARD_RANKS
TP_PROMPTS, TP_PROMPT_LO, TP_PROMPT_HI, TP_NEW = 8, 16, 256, 16
TP_PAGED = dict(max_batch=8, max_seq=512, page_size=16, prefill_chunk=128)  # PAGE, defined below
TP_KV = ("bf16", "int8")
TP_LOGIT_RTOL = 2e-2  # first-decode logits against the one-rank run's, of max |logit|
# (d) After phases 10 and 11 the same ranks serve two more families on the
# axis, each from the artifact its phase saved (loaded on the CPU, the
# rank's shard alone moved to the card): phase 10 (a)'s OLMoE-1B-7B
# quantease@4 (one layer; 16 heads, kv 8 a rank; 64 experts, 32 a rank:
# expert-parallel) on the paged engine, and phase 11 (b)(ii)'s Jamba-1.5-
# Large blocks 0 and 1 RTN@4 (kv 8 -> 4, d_ff 24,576 -> 12,288, 256 SSD
# heads -> 128, 16 experts -> 8) on the contiguous engine, each with its
# phase's requests and engine settings; those phases' own served runs, with
# their logits recorded, are the one-rank baselines.  A first-decode lane
# past TP_LOGIT_RTOL is allowed only where a router crosses: a top-k
# boundary whose one-rank probability gap is under TP_ROUTER_GAP, on which
# the ranks' top-k ids part from the one-rank run's.
TP_FAMILIES = ("olmoe", "jamba")
# How long the ranks wait after (c) for (d), after (d) for (e), and through
# phase 12 for (f).
TP_WAIT_S = 1800
TP_ROUTER_GAP = 1e-2
# (e) Training on the axis: after (d) the same ranks, as a ("model",) axis of
# 2, train TP_TRAIN_STEPS steps of each model of TP_TRAIN (bf16 params, fp32
# AdamW moments, TRAIN_OPT, TRAIN_BATCH x TRAIN_SEQ batches of the synthetic
# corpus) from the seeded whole params its one-rank run starts from: phase
# 5b's model (32 heads and the 32,064-token vocabulary in halves: no
# padding), held against phase 5b's first steps; OLMoE-1B-7B at one layer
# (64 experts, 32 a rank: expert-parallel) and Mamba-2-2.7B at 2 of 64
# layers (80 SSD heads, 40 a rank), whose one-rank runs the parent trains
# while the ranks work.  Losses and gradient norms within TP_TRAIN_LOSS_RTOL
# (bf16 sums in another order); the params after the last step off the
# one-rank run's by at most TP_TRAIN_UPDATE_RTOL of how far that run moved
# them beyond the noise floor of bf16 params: the distance of a control, the
# one-rank run again from the same params with its heads and ffn units
# permuted (the same model, every reduction over them in another order;
# measured 3.3-6.5 % of the movement, the ranks 4.0-7.7 %: NVIDIA H100 80GB
# HBM3, PERF.md §6), as phase 13 (a) bounds perplexity beyond its
# controls; the loss and every leaf the ranks hold whole the same bits on
# both ranks.
TP_TRAIN_STEPS = 2
TP_TRAIN = {"phi3": ("phi3_mini_3_8b", MAIN_OVERRIDES), "olmoe": ("olmoe_1b_7b", dict(n_periods=1)),
            "mamba": ("mamba2_2_7b", dict(n_periods=2))}
TP_TRAIN_LOSS_RTOL = 5e-3
TP_TRAIN_UPDATE_RTOL = 0.05
# (f) The encoder-decoder and prefix families on the axis.  The ranks wait,
# their card freed, through phase 12, which saves its two served QuantEase@4
# artifacts (Whisper-large-v3 at 4 + 4 periods with both stacks quantized;
# LLaVA-NeXT-34B at 2 of 60 layers) with their batches and records its own
# greedy runs, logits included, as the one-rank baselines.  (i) The same
# ranks, as a ("model",) axis of 2, load each artifact on the CPU, move
# their shard alone to the card (Whisper: 10 of 20 heads, 25,933 of 51,866
# vocabulary rows; LLaVA: 28 of 56 q heads, 4 of 8 kv heads, d_ff 10,240 of
# 20,480, 32,000 of 64,000 rows) and prefill and decode the same inputs
# greedily, held as (d) holds its families (first-decode logits within
# TP_LOGIT_RTOL, tokens up to the margin rule, bytes, kernel 3's calls
# against its plain version), with one decode step's collectives counted:
# the embedding's all-reduce, one a layer for wo, wo_c (Whisper) and wd,
# and the logits' gather.  (ii) They train TP_TRAIN_STEPS steps of each model
# of TP_TRAIN_F at full width (its depth cut, its batch × its tokens, with
# their frames or patches), held as (e) holds its models; the parent
# trains the one-rank runs and controls while the ranks work.
TP_ENCDEC = ("whisper_large_v3", "llava_next_34b")
# (g) Speculation and SLO deadlines on the axis: right after (c) the same
# ranks serve their shard of (c)'s artifact again on the paged engine (bf16
# KV, TP_PAGED, (c)'s TP_PROMPTS prompts).  (i) Speculatively, γ =
# SPEC_GAMMA, TP_NEW tokens a request, with the truncated self-draft (the
# first of the 2 periods of the rank's shard) and an RTN draft of the whole
# dense stack at SPEC_DRAFT_BITS, cut by shard_tree like any artifact; the
# pool holds SPEC_POOL times the ample one (target and draft pages share
# it).  Each stream is held to (c)'s bf16 stream on the rank under phase
# 9's margin rule (SERVE_LOGIT_TOL), with phase 9's per-run checks (every
# request complete, no page leaked, no round short of min(γ, budget),
# kernel 5 once a verify or draft step and layer, the verify's GEMMs
# tc_small).  (ii) The SLO scheduler on a pool of TP_SLO_PAGES pages, which
# forces preemption, with TP_SLO's requests (rid: (c)'s prompt, new tokens,
# deadline ms or None, priority), the last after the engine has measured
# its step costs.  Rank 0's engine reads a virtual clock, TP_SLO_TICK_S a
# reading (no token moves the schedule, so it is the CPU rehearsal's);
# rank 1's reads time.monotonic() + 1e3.  Every reading either engine
# takes is rank 0's, broadcast (a reading only recorded rides on the next
# broadcast): request 4 expires mid-generation, request 8 is shed as
# provably unmeetable, one request is preempted and resumes.  (iii) The
# same with rank 0's engine on time.monotonic (rank 1's skewed again) and
# TP_SLO_LIVE's requests: deadlines generous, tight (a few of (c)'s steps)
# or clearly unmeetable, so the card's real timing decides them and only
# the ranks' agreement is required.  Both ranks must end every request
# alike; tokens are held to (c)'s stream under the margin rule.
TP_SLO_TICK_S = 1e-3
TP_SLO_PAGES = 40
TP_SLO = ({0: (0, TP_NEW, None, 0), 1: (1, TP_NEW, None, 0), 2: (2, TP_NEW, 1e9, 1),
           3: (3, TP_NEW, 1e9, 1), 4: (4, 48, 100.0, 2), 5: (5, TP_NEW, None, 2),
           6: (6, TP_NEW, None, 1), 7: (7, TP_NEW, 1e9, 0)},
          {8: (0, TP_NEW, 10.0, 1)})
TP_SLO_LIVE = ({0: (0, TP_NEW, None, 0), 1: (1, TP_NEW, 1e6, 1), 2: (2, TP_NEW, 300.0, 2),
                3: (3, TP_NEW, 1.0, 0), 4: (4, 48, 600.0, 1)},
               {5: (5, TP_NEW, 1.0, 2), 6: (6, TP_NEW, 1e6, 0), 7: (7, TP_NEW, 400.0, 1)})
TP_TRAIN_F = {"whisper": ("whisper_large_v3", dict(n_periods=1, n_enc_periods=1), (4, 448)),
              "llava": ("llava_next_34b", dict(n_periods=1), (2, 512))}
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
CLI_TRAIN = ("--steps", "2", "--batch", "4", "--seq", "512")
CLI_SEQ, CLI_ITERATIONS, CLI_CALIB = 512, 25, 4  # the quantize CLI's: 4 calibration batches of 4
CLI_EVAL = ("--methods", "rtn", "awq", "spqr", "quantease", "--bits", "3", "--outlier-bits", "3",
            "--iterations", "25", "--calib-batches", "4", "--eval-batches", "4", "--seq", "512")
CLI_SERVE = ("--requests", "6", "--max-new", "12")
CLI_REPORT_REL = 1e-3  # the quantize CLI's report against ptq_quantize_model, per layer
# Two training checkpoints of 3.94 GiB (bf16 params, fp32 moments), the
# quantize output (0.85 GiB) and headroom.
CLI_DISK_GIB = 12
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
    # A long-context deployment's decode: 8 lanes of a 4096-token table at
    # the lengths 8 users' prompts of 3584-4032 tokens reach with 16 new ones.
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
# Phase 10: the other architectures at full width, seeded random bf16
# weights, depth cut.  (a) OLMoE-1B-7B, 1 of 16 decoder layers (2 until
# phase 12 came): one
# calibration batch of 16 x 512 tokens (8,192 tokens, top-8 of 64 experts:
# capacity 1,280 slots an expert), these artifacts, eval_model at
# EvalBudget's defaults on batches of 4 x 512, then the quantease@4
# artifact serves 8 of phase 6's prompts.
FAM_MOE = ("olmoe_1b_7b", 1)
FAM_MOE_CALIB = (16, 512)
FAM_MOE_RUNS = (("rtn", 4), ("quantease", 4), ("quantease", 3), ("qe_outlier", 3))
FAM_MOE_SERVED = "quantease@4"
FAM_MOE_REQUESTS, FAM_MOE_NEW = 8, 32
# (b) each dense config, one period (Gemma 2's is its local/global pair):
# QuantEase at 4 bits on 4 x 512 calibration tokens, eval_model on 2 batches
# of 2 x 512, 4 requests of 16-512 tokens, 16 new each, per KV dtype.
FAM_DENSE = (("qwen15_32b", ("bf16",)), ("stablelm_12b", ("bf16", "int4")),
             ("gemma2_27b", ("bf16",)), ("opt_66b", ("bf16",)))
FAM_DENSE_CALIB, FAM_DENSE_EVAL = (4, 512), (2, 512)
FAM_REQUESTS, FAM_PROMPT_LO, FAM_PROMPT_HI, FAM_NEW = 4, 16, 512, 16
# The CD calls (kernels 1, 2 and 4) of (a) and (b) held against their plain
# versions after each group solve: of OLMoE's three groups (phase 10 (a))
# the 64-expert group's quantizing fused iteration at 4 bits and its
# outlier-aware iteration, and of OPT-66B one signature of its p = 36,864
# group, a quantizing fused iteration (kernel 2's ``plan_corr`` split at
# that p) with its 144 block sweeps.  Qwen1.5's, StableLM-2's and Gemma 2's
# (48.5 s of plain column loops) were cut to keep the whole run within
# 1,000 s once phase 11 came, OPT-66B's other five signatures (~17 s) once
# phase 13 came, and OLMoE's other ten (~9 s of its 10.8) once phase 13 (d)
# came; their kernel-3 and kernel-5 calls are still held.
FAM_CD_REPLAYED = {
    "opt_66b": lambda key: key[1][0][0][-2] == 36864 and dict(key[2]).get("quantize"),
    "olmoe_1b_7b": lambda key: key[1][0][0][0] == 64 and dict(key[2]).get("quantize") and (
        key[0] == "outlier_iteration_cuda" or dict(key[2]).get("n_levels") == 16),
}
# (c) Mixtral-8x22B, one layer: a 4-bit RTN artifact serves 4 requests.
FAM_MIXTRAL = "mixtral_8x22b"
FAM_PAGED = dict(max_batch=8, max_seq=1536, page_size=PAGE, prefill_chunk=128)
# Phase 11: Mamba-2 and the hybrid Jamba at full width, seeded random bf16
# weights, depth cut.  (a) Mamba-2-2.7B, 4 of 64 layers (d 2560, 80 SSD
# heads of 64, state 128, vocab 50,280 tied): one calibration batch of 16 x
# 512 tokens, fed 4 sequences at a time (stream_chunk: the intra-chunk
# temporaries are (B, 4, 128, 128, 80) fp32), OLMoE's four runs, each
# scored by eval_model on 2 batches of 2 x 512; then the quantease@4
# artifact serves 8 of phase 6's prompts x 32 new tokens on the contiguous
# engine (Mamba state does not page, as in the reference).
SSM_MAMBA = ("mamba2_2_7b", 4)
SSM_CALIB, SSM_EVAL, SSM_STREAM = (16, 512), (2, 512), 4
SSM_RUNS = FAM_MOE_RUNS
SSM_SERVED = "quantease@4"
SSM_REQUESTS, SSM_NEW = 8, 32
SSM_CONTIG = dict(max_batch=8, max_seq=1536)
# (b) Jamba-1.5-Large, its period of 8 blocks cut to two: (i) blocks 0 and 2
# (attention with a dense MLP, Mamba with a dense MLP; d 8192, 64 heads of
# 128, kv 8, 256 SSD heads, d_ff 24,576), QuantEase at 4 bits on the Mamba
# linears through layer_specs and RTN on the rest, 4 x 512 calibration
# tokens, eval_model on 2 batches of 2 x 512; (ii) blocks 0 and 1 (the Mamba
# block with the MoE: 16 experts of d_ff 24,576, top-2, 19.3 GB of bf16
# experts): a 4-bit RTN artifact (rtn_quantize_for_serving) serves 4
# requests of 16-512 tokens x 16 new.  No calibration pass runs over the MoE
# block: its w_down's per-expert Σ alone would be 16 x 24,576² x 4 B.
SSM_JAMBA = "jamba_1_5_large"
SSM_JAMBA_PTQ, SSM_JAMBA_SERVE = (0, 2), (0, 1)
SSM_JAMBA_QE = ("wz", "wx", "wbc", "out_proj")
SSM_JAMBA_CALIB, SSM_JAMBA_STREAM = (4, 512), 2
# Phase 12: the encoder-decoder and prefix families at full width, seeded
# random bf16 weights, depth cut.  (a) Whisper-large-v3, 4 of 32 encoder and
# 4 of 32 decoder periods (kept equal, so the same cut also runs in the
# reference, whose encoder scan takes the decoder's period count): 4
# calibration batches of 4 x 448 tokens (the published decoder context),
# each with its (4, 1,500, 1,280) frames; RTN and QuantEase at 4 bits,
# QuantEase and qe_outlier (1 %) at 3 bits, encoder first, both stacks
# restacked; then 4 sequences (a 4-token prompt and their frames) prefill
# and take 32 greedy decode steps.  (b) LLaVA-NeXT-34B, 2 of 60 layers: 4
# calibration batches of 4 x 512 tokens, each sequence after its 2,880
# patches (3,392 positions); RTN and QuantEase at 4 bits; then 2 sequences
# (2,880 patches and 32 tokens) prefill and take 16 greedy decode steps.
ENC_WHISPER = ("whisper_large_v3", 4)
ENC_CALIB, ENC_CALIB_BATCHES = (4, 448), 4
ENC_RUNS = FAM_MOE_RUNS
ENC_SERVE = (4, 4, 32)  # sequences, prompt tokens, greedy decode steps
PFX_LLAVA = ("llava_next_34b", 2)
PFX_CALIB, PFX_CALIB_BATCHES, PFX_STREAM = (4, 512), 4, 2
PFX_RUNS = (("rtn", 4), ("quantease", 4))
PFX_SERVE = (2, 32, 16)
# The first decode step's logits against a prefill over the prompt and that
# token, of max |logit|: the reference's own bound
# (tests/test_models.py::test_decode_matches_prefill).
DECODE_PREFILL_TOL = 0.05
# Report keys by the leaf kinds of phase 12's mean errors.
LEAF_KINDS = {"self-attention": ("wq", "wk", "wv", "wo"),
              "cross-attention": ("wq_c", "wk_c", "wv_c", "wo_c"), "MLP": ("wg", "wu", "wd")}


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


class GraphedIteration:
    """A plain CD iteration (``fn``) replayed from CUDA graphs.  Per
    signature (operand shapes and dtypes, which operands are one tensor,
    options) the first call runs eagerly, the second is captured and
    replayed, and later calls copy their operands into the captured inputs
    and replay.  The kernels and their order are the plain version's: the
    graph only takes the host's launch of each off the time (a plain
    iteration is ~12 launches a column)."""

    def __init__(self, fn):
        self.fn, self.seen, self.graphs = fn, set(), {}

    def __call__(self, *args, **kw):
        import torch

        first = {}
        aliases = tuple(first.setdefault(id(a), i) for i, a in enumerate(args))
        key = (_signature("plain", args, kw), aliases)
        if key not in self.seen:
            self.seen.add(key)
            return self.fn(*args, **kw)
        if key not in self.graphs:
            check(not any(isinstance(v, torch.Tensor) for v in kw.values()),
                  "GraphedIteration copies positional tensors only")
            static = [a.clone() if isinstance(a, torch.Tensor) and j == i else a
                      for i, (a, j) in enumerate(zip(args, aliases))]
            static = [static[j] for j in aliases]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.fn(*static, **kw)
            self.graphs[key] = (graph, static, out)
        graph, static, out = self.graphs[key]
        for i, (s_, a) in enumerate(zip(static, args)):
            if isinstance(a, torch.Tensor) and aliases[i] == i:
                s_.copy_(a)
        graph.replay()
        return tuple(o.clone() for o in out)


@contextlib.contextmanager
def graphed_plain_iterations():
    """While open, a CD engine that asks for the plain iteration
    (``use_kernel="torch"``) on the card gets it through
    :class:`GraphedIteration`: phase 3's 25-iteration plain solves at the
    solver groups took ~160 s of host launches on the H100's host."""
    from repro_torch.core import quantease as qe

    iteration_step = qe._iteration_step

    def step(use_kernel, device, **kw):
        fn = iteration_step(use_kernel, device, **kw)
        return GraphedIteration(fn) if use_kernel == "torch" and device.type == "cuda" else fn

    qe._iteration_step = step
    try:
        yield
    finally:
        qe._iteration_step = iteration_step


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
        # The plain column loop holds the host ~0.7–2.9 s a call (host speed):
        # three timed calls, warm from the comparison above.
        plain = cuda_ms(lambda: ref.quantease_fused_iteration_ref(*args, **kw), reps=3, warmup=0)
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
        t0 = time.monotonic()
        with graphed_plain_iterations():
            wp, _ = qe.quantease_quantize(w, sigma, spec, use_kernel="torch", **kw25)
        t_plain = time.monotonic() - t0
        ek = qe.relative_error(w, wk, sigma)
        ep = qe.relative_error(w, wp, sigma)
        rel = float(((ek - ep).abs() / ep).max())
        check(rel <= 1e-3, f"25 iterations {G}x({q},{p}) {dt}: relative error {ek.tolist()} vs {ep.tolist()}")
        del w, sigma, wk, wp
        row = dict(G=G, q=q, p=p, dtype=dt, rows_ok=min(fracs), rows_differing=n_diff,
                   rows_unexplained=n_unexplained, tie_rows=ties, max_abs_err=max(errs), ms=ms,
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by, rel_err_kernel=ek.tolist(),
                   rel_err_plain=ep.tolist(), solve25_s=t_kernel, plain_solve25_s=t_plain,
                   sgemm=sgemm, solve25_profile=solve_split)
        detail["fused_iteration"].append(row)
        print(f"[kernel] fused_iteration G={G} ({q},{p}) {dt}: rows_ok={min(fracs):.6f} "
              f"(rows differing {n_diff}, not starting with a tie flip {n_unexplained}) "
              f"max_abs_err={max(errs):.3g} ms={ms:.3f} plain_ms={plain:.1f} bound_ms={b_ms:.3f} "
              f"({b_by}) 25-iter solve {t_kernel:.2f}s (plain, graphed, {t_plain:.2f}s) rel_err "
              f"{ek.mean():.6f} vs plain {ep.mean():.6f}")
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
        # As the fused iteration's: three timed calls of a host-bound plain loop.
        plain = cuda_ms(lambda: ref.quantease_outlier_iteration_ref(*args, **kw), reps=3, warmup=0)
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
        t0 = time.monotonic()
        with graphed_plain_iterations():
            rp = outlier.outlier_quantease(w, sigma, GridSpec(bits=3), use_kernel="torch", **kw25)
        t_plain = time.monotonic() - t0
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
                   solve25_s=t_kernel, plain_solve25_s=t_plain, iteration_profile=split,
                   solve25_profile=solve_split,
                   sgemm=sgemm)
        detail["outlier_iteration"].append(row)
        print(f"[kernel] outlier_iteration G={G} ({q},{p}) B={bsz} {dt}: rows_ok={min(fracs):.6f} "
              f"(rows differing {n_diff}, not starting with a tie flip {n_unexplained}) "
              f"max_abs_err={max(errs):.3g} R rel err={r_err:.3g} ms={ms:.3f} plain_ms={plain:.1f} "
              f"bound_ms={b_ms:.3f} ({b_by}) topk_ms={topk_ms:.3f} 25-iter solve {t_kernel:.2f}s "
              f"(plain, graphed, {t_plain:.2f}s) rel_err {ek.mean():.6f} vs plain {ep.mean():.6f}",
              flush=True)
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


def start_card_tests():
    """The slice on a small input, card against CPU, and every kernel against
    its plain version at small and ragged shapes: ``tests/test_torch_cuda.py``
    in a pytest process of its own, started here and collected by
    :func:`finish_card_tests`.  The script runs phases 7 and 8 meanwhile:
    both hold the host (training a small model, the command-line tools), not
    the card, and time nothing the kernels line or PERF.md's kernel table
    reads."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src")] + [v for v in [os.environ.get("PYTHONPATH")] if v]))
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--durations=8",
         "tests/test_torch_cuda.py"], cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
        text=True)
    return proc, out, time.monotonic()


def finish_card_tests(started) -> None:
    """Wait for :func:`start_card_tests`' pytest (within 900 s of its start)
    and fail unless every test passed and none skipped; print its slowest
    tests."""
    proc, out, t0 = started
    try:
        proc.wait(timeout=max(1.0, 900 - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    out.seek(0)
    text = out.read()
    out.close()
    lines = text.strip().splitlines()
    tail = lines[-1] if lines else ""
    slow = [ln.strip() for ln in lines if ln.strip()[:1].isdigit() and "s call" in ln]
    print(f"[reference] tests/test_torch_cuda.py: {tail} (done {time.monotonic() - t0:.1f}s after "
          f"its start); slowest: {'; '.join(slow[:8])}", flush=True)
    check(proc.returncode == 0 and "skipped" not in tail,
          f"tests/test_torch_cuda.py on the card:\n{text[-8000:]}")


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

    # Phase 13 holds its sharded run against the served run's groups: each
    # group's (W, Σ) kept as the solver saw them.
    kept_groups = []
    solve_group = solver._solve_group

    def keep_group(w3, sig3, gcfg, mesh=None):
        kept_groups.append((w3.clone(), sig3.clone()))
        return solve_group(w3, sig3, gcfg, mesh)

    ops.reset_launch_counts()
    t_main = time.monotonic()
    results, coo, zero_points = {}, {}, {}
    for method, bits in MAIN_RUNS:
        label = f"{method}@{bits}"
        pcfg = solver.PTQConfig(method=method, spec=GridSpec(bits=bits), iterations=PTQ_ITERATIONS, emit="qt",
                                outlier_frac=OUTLIER_FRAC)
        t0 = time.monotonic()
        solver._solve_group = keep_group if label == SERVED_RUN else solve_group
        try:
            qparams, report = solver.ptq_quantize_model(
                plan, params, calib, pcfg, progress_cb=progress(label), device=dev)
        finally:
            solver._solve_group = solve_group
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
    keep = dict(groups=kept_groups, report=results[SERVED_RUN][0], ppl=results[SERVED_RUN][1]["ppl"],
                seconds_per_layer=per_layer[SERVED_RUN])
    return counts, plan, artifact, params, keep


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
    training path runs none of them) and phase 13 (e)'s one-rank run of
    this model: the first TP_TRAIN_STEPS steps' losses, gradient norms and
    times, the seeded params' leaf sums, and the params before the first
    step and after step TP_TRAIN_STEPS on the CPU (their copy's seconds
    left out of the step times)."""
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
        stamps, peaks, copying = [], [], [0.0]
        one = dict(init=tree_to(trainer.params, "cpu"), sums=leaf_sums(trainer.params))

        def stamp(step=None):  # runs before each step: the card has finished the one before
            torch.cuda.synchronize()
            stamps.append(time.perf_counter() - copying[0])
            peaks.append(torch.cuda.max_memory_allocated() - base)  # since the last stamp
            torch.cuda.reset_peak_memory_stats()
            if step == TP_TRAIN_STEPS:
                t = time.perf_counter()
                one["after"] = tree_to(trainer.params, "cpu")
                copying[0] += time.perf_counter() - t

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
    log = out["log"][:TP_TRAIN_STEPS]
    one.update(losses=[m["loss"] for m in log], grad_norms=[m["grad_norm"] for m in log],
               ms=[(b - a) * 1e3 for a, b in zip(stamps, stamps[1:TP_TRAIN_STEPS + 1])])
    return counts, one


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
        kv_quant_max_diff=d_q, prompt_lengths=[len(p) for p in prompts],
    )
    for eng in (r[2] for r in res.values()):
        eng.logit_trace.clear()
    return counts


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
    An operand passed twice (the fp32 Σ̃ as ``sig_t`` and ``sig_corr``) is
    cloned once, so the replay sees the same aliasing.  The launch counters
    live on the wrapped functions and are untouched."""
    import torch

    from repro_torch.kernels import ops

    calls = {}
    originals = {name: getattr(ops, name) for name in PATH_WRAPPERS}

    def recorder(name, fn):
        def call(*args, **kwargs):
            key = _signature(name, args, kwargs)
            n = calls[key][3] + 1 if key in calls else 1
            if n <= kept:
                calls.pop(key, None)  # the earlier call's clones go before the new ones
                memo = {}

                def clone(a):
                    if isinstance(a, torch.Tensor) and id(a) not in memo:
                        memo[id(a)] = a.clone()
                    return memo.get(id(a), a)

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


def check_path_calls(calls, variants, phase="phase 7", paged_tol=lambda want: PAGED_ATOL):
    """Each recorded call of ``phase`` once more through ``kernels.ops`` (the
    kernel) and through its plain version, on the same inputs, at the
    tolerances of phase 3: the CD iterations (kernels 2 and 4) row by row,
    kernel 4's R in the rows that agree, and kernel 1 on each block of each
    iteration, from the plain iteration's β0 (its next base) and against
    the plain iteration's own sweep of that block; the
    dequant-GEMM (kernel 3) within 1e-2 of max |y| in bf16 and 1e-4 in
    fp32; paged attention (kernel 5) within ``paged_tol(plain output)``
    (PAGED_ATOL, whatever the outputs' size, unless a phase says otherwise:
    :func:`family_paged_tol`).  Every variant of
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
                # The plain sweep of this block on these inputs is the one the
                # plain iteration ran: its Ŵ and Δ rows of the block.
                pn, pd = p_out[0][..., sl, :], p_out[2][..., sl, :]
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
            tol = paged_tol(want)
            check(bool(torch.isfinite(got.float()).all()) and err <= tol,
                  f"{what}: max abs err {err} > {tol} (max |out| {float(want.abs().max())})")
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
    removes it): train 2 steps (2 checkpoints); quantize with QuantEase at 4
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
        check(steps == [1, 2], f"train CLI wrote checkpoints {steps}, expected 2")

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


# ---------------------------------------------------------------------------
# Phase 10: the paper's OPT family, the dense configs and MoE at full width
# ---------------------------------------------------------------------------


def _free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def family_prompts(vocab: int, n: int, lo: int, hi: int) -> list:
    import numpy as np

    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, int(k)).astype(np.int32) for k in rng.integers(lo, hi + 1, n)]


def family_serve(label, plan, artifact, prompts, new_tokens, dev, keep=None):
    """One paged run (every request completes, kernel 5 launched once per
    decode step and period); returns its stats.  With ``keep`` (a dict) the
    run records its logits and ``keep`` gets its outputs, logit trace and
    stats: phase 13 (d)'s one-rank baseline."""
    from repro_torch.kernels import ops
    from repro_torch.serve import PagedServingEngine

    k5 = ops.launch_counts()["paged_attention"]
    stats, outputs, eng = serve_run(label, lambda: PagedServingEngine(
        plan, artifact, **FAM_PAGED, record_logits=keep is not None, device=dev), prompts,
        new_tokens)
    k5 = ops.launch_counts()["paged_attention"] - k5
    n_attn = plan.cfg.n_periods * len(plan.cfg.pattern)
    check(stats["statuses"] == ["completed"] and all(len(o) == new_tokens for o in outputs.values()),
          f"{label}: statuses {stats['statuses']}")
    check(k5 == eng.n_decode_steps * n_attn,
          f"{label}: kernel 5 launched {k5}, expected {eng.n_decode_steps} x {n_attn}")
    if keep is not None:
        keep.update(outputs=outputs, trace=eng.logit_trace, stats=stats)
    del eng
    return stats


def family_checks(label, calls, variants, phase="phase 10"):
    """Phase 10's (or ``phase``'s) kernel calls of one config, one per signature, against
    their plain versions (:func:`check_path_calls`: the CD iterations with
    kernel 1 on each of their blocks, kernels 3 and 5); prints kernel 5's
    plan for each head shape it ran."""
    import torch

    from repro_torch.device import sm_count
    from repro_torch.kernels import paged_attention as pa

    for key in sorted(calls, key=str):
        name, args, kw, _ = calls[key]
        if name != "paged_attention_cuda":
            continue
        q, kp, table = args[0], args[1], args[3]
        B, KVp, G, hd = q.shape
        kind = {"torch.bfloat16": "bf16", "torch.int8": "int8", "torch.uint8": "int4"}[str(kp.dtype)]
        idx = q.device.index
        cps = pa.paged_ctas_per_sm(idx, q.dtype == torch.bfloat16, kind, G, hd)
        planned = pa.plan_paged(B, KVp, G, hd, table.shape[1], kp.shape[1], kind,
                                sm_count(idx), cps, kw.get("window"))
        print(f"[family] {label} kernel 5 plan: B,KVp,G,hd={(B, KVp, G, hd)} {kind} pages, table "
              f"{table.shape[1]} pages, window {kw.get('window')}: {planned} pages a partition, "
              f"{cps} CTAs per SM", flush=True)
    return check_path_calls(calls, variants, phase=f"{phase} {label}", paged_tol=family_paged_tol)


def family_paged_tol(want) -> float:
    """Phase 10's tolerance on kernel 5: PAGED_ATOL up to max |out| = 1,
    scaled by max |out| above it.  The kernel keeps p in fp32 and the plain
    version rounds it to bf16, so the bf16 outputs part by an ulp, which is
    2^-7 of the magnitude: 0.03125 at 4-8, where the random full-width
    OPT-66B's attention outputs reach.  Phases 7-9 keep the absolute
    PAGED_ATOL: their outputs reach 4.09 (phase 8), but their differences
    stayed at or under 0.0156, so the scaled rule would only loosen them."""
    return PAGED_ATOL * max(1.0, float(want.float().abs().max()))


def merge_checked(into: dict, more: dict) -> dict:
    """Sums :func:`check_path_calls` results per kernel."""
    for kernel, row in more.items():
        acc = into.setdefault(kernel, dict(calls=0, max_abs_err=0.0))
        acc["calls"] += row["calls"]
        acc["max_abs_err"] = max(acc["max_abs_err"], row["max_abs_err"])
    return into


@contextlib.contextmanager
def checked_solves(label, calls, on_solve=None, replay=True, phase="phase 10"):
    """While open, each group solve of the PTQ path is followed by the check
    of the CD calls it recorded in ``calls`` (kernels 2 and 4, kernel 1 on
    each of their blocks), each signature once over the whole run, against
    the plain versions (``replay``: True, False, or a function of the
    signature that says which; the others are dropped unchecked);
    ``on_solve(w3, gcfg)`` sees each group.  Checking
    as the solves go keeps one group's clones on the card at a time (Σ̃ alone
    is 5.4 GB at p = 36,864).  Yields a dict: ``checked``, the merged
    results; ``replayed``, the launches the replays made, which
    :func:`path_counts` takes off the path's counts; ``seconds``, the time
    the checks took, which :func:`less_checks` takes off the path's."""
    import torch

    from repro_torch.core import solver
    from repro_torch.kernels import ops

    solve_group = solver._solve_group
    st = dict(checked={}, replayed=dict.fromkeys(ops.launch_counts(), 0), seconds=0.0)
    done = set()

    def solve(w3, sig3, gcfg, mesh=None):
        out = solve_group(w3, sig3, gcfg, mesh)
        if on_solve is not None:
            on_solve(w3, gcfg)
        if w3.is_cuda:
            torch.cuda.synchronize()  # the solve's queued work is the solve's time
        t0 = time.monotonic()
        for key in [k for k in calls if k[0] in PATH_WRAPPERS[:2]]:
            one = {key: calls.pop(key)}  # one signature's clones on the card at a time
            if (replay(key) if callable(replay) else replay) and key not in done:
                done.add(key)
                before = ops.launch_counts()
                merge_checked(st["checked"], check_path_calls(one, {}, phase=f"{phase} {label}"))
                for k, v in ops.launch_counts().items():
                    st["replayed"][k] += v - before[k]
                del one
                # After a replay only: a collection per solve (every group of
                # every block) cost ~15 s of phase 11 and ~20 s of phase 12.
                _free()
            else:
                del one
        st["seconds"] += time.monotonic() - t0
        return out

    solver._solve_group = solve
    try:
        yield st
    finally:
        solver._solve_group = solve_group


def path_counts(st: dict) -> dict:
    """The launch counts with :func:`checked_solves`' replays taken off."""
    from repro_torch.kernels import ops

    return {k: v - st["replayed"][k] for k, v in ops.launch_counts().items()}


def less_checks(st: dict):
    """A function of seconds measured on the path that takes off the time
    :func:`checked_solves` spent checking since its previous call."""
    last = [st["seconds"]]

    def net(seconds: float) -> float:
        spent, last[0] = st["seconds"] - last[0], st["seconds"]
        return seconds - spent

    return net


def family_moe(dev, detail, tp_keep):
    """Phase 10 (a): OLMoE-1B-7B at full width, FAM_MOE's layers of 16.
    The served run is phase 13 (d)'s one-rank baseline: its logits, first
    decodes' routes and artifact go into ``tp_keep["olmoe"]``."""
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

    name, periods = FAM_MOE
    cfg = dataclasses.replace(get_config(name), n_periods=periods)
    plan = M.make_plan(cfg)
    params = M.init_params(plan, 0, device=dev)
    data = DataConfig(vocab=cfg.vocab, seed=0)
    calib = [make_batch_fn(data, cfg, *FAM_MOE_CALIB, split="calib")[0](0)]
    eval_fn, _ = make_batch_fn(data, cfg, MAIN_BATCH, MAIN_SEQ, split="eval")
    groups, blocks, results = [], [], {}

    def seen(w3, gcfg):
        groups.append((gcfg.method, gcfg.spec.bits, *w3.shape))

    ops.reset_launch_counts()
    t0 = time.monotonic()
    with recording_calls() as calls:
        with checked_solves(name, calls, seen, replay=FAM_CD_REPLAYED[name]) as st:
            net, net_all = less_checks(st), less_checks(st)
            for method, bits in FAM_MOE_RUNS:
                label = f"{method}@{bits}"
                pcfg = solver.PTQConfig(method=method, spec=GridSpec(bits=bits),
                                        iterations=PTQ_ITERATIONS, emit="qt", outlier_frac=OUTLIER_FRAC)
                t_net = less_checks(st)
                t1 = time.monotonic()
                q, report = solver.ptq_quantize_model(
                    plan, params, calib, pcfg, device=dev,
                    progress_cb=lambda r, label=label: blocks.append((label, r["period"],
                                                                      net(r["seconds"]))))
                served = quantize_params_for_serving(plan, params, q["dec"], device=dev)
                t_ptq = t_net(time.monotonic() - t1)
                metrics = eval_model(plan, served, eval_fn, budget=EvalBudget(), device=dev)
                results[label] = (report, metrics, t_ptq)
                if label == FAM_MOE_SERVED:
                    artifact = served
                del q, served
                _free()
        ptq_counts = path_counts(st)
        t_ptq_all = net_all(time.monotonic() - t0)
        del params
        _free()
        prompts = serve_traffic(cfg.vocab)[:FAM_MOE_REQUESTS]
        base = tp_keep["olmoe"] = dict(engine="paged", prompts=prompts, new=FAM_MOE_NEW)
        with first_decode_routes(prompts) as (routes, per_step):
            stats = family_serve(f"{name} {FAM_MOE_SERVED} paged bf16", plan, artifact, prompts,
                                 FAM_MOE_NEW, dev, keep=base)
        base.update(routes=routes, kernel3_per_step=per_step)
    torch.cuda.synchronize()
    counts = path_counts(st)
    variants = dict(dequant_matmul_cuda.launches_by_variant)
    seen_groups = sorted({g[2:] for g in groups}, key=lambda g: -g[0])
    print(f"[family] {name}: solver groups (G, q, p) {seen_groups}; seconds per decoder layer "
          + "; ".join(f"{lb} " + ", ".join(f"{s:.2f}" for l2, _, s in blocks if l2 == lb)
                      for lb in results), flush=True)
    expert_mean = {}
    for label, (report, m, t_ptq) in results.items():
        vals = np.array(list(report.values()))
        check(np.all(np.isfinite(vals)) and math.isfinite(m["ppl"]), f"{name} {label}: {m}")
        for p in range(periods):
            for mat in ("w_gate", "w_up", "w_down"):
                n_e = sum(k.startswith(f"dec.p{p}.b0/{mat}.e") for k in report)
                check(n_e == cfg.n_experts, f"{name} {label}: {n_e} expert keys for p{p} {mat}")
        expert_mean[label] = float(np.mean([v for k, v in report.items() if ".e" in k]))
        print(f"[family] {name} {label}: {len(vals)} report keys, mean per-expert rel error "
              f"{expert_mean[label]:.6f}, attention {np.mean([v for k, v in report.items() if '.e' not in k]):.6f}; "
              f"ppl {m['ppl']:.4f} top1 {m['top1']:.4f} choice_acc {m['choice_acc']:.4f} "
              f"(PTQ + restack {t_ptq:.1f}s)", flush=True)
    check(set(seen_groups) == {(2 * cfg.n_experts, cfg.moe_ff, cfg.d_model),
                               (cfg.n_experts, cfg.d_model, cfg.moe_ff), (4, cfg.d_model, cfg.d_model)},
          f"{name}: solver groups {seen_groups}")
    check(expert_mean["quantease@4"] < expert_mean["rtn@4"]
          and expert_mean["qe_outlier@3"] < expert_mean["quantease@3"],
          f"{name}: mean per-expert errors {expert_mean}")
    for k in ("quantease_block_sweep", "quantease_fused_iteration", "dequant_matmul",
              "quantease_outlier_iteration"):
        check(ptq_counts[k] > 0, f"{name}: kernel {k} not launched by PTQ and eval: {ptq_counts}")
    print(f"[family] {name}: launches {counts}, dequant_matmul by variant {variants} "
          f"(PTQ and eval {t_ptq_all:.1f}s, the CD checks' {st['seconds']:.1f}s apart); served "
          f"{FAM_MOE_SERVED}: decode {stats['decode_tok_s']:.1f} tok/s, {stats['ms_per_step']:.2f} "
          f"ms/step", flush=True)
    tp_save(tp_keep, "olmoe", f"{name} {FAM_MOE_SERVED}", cfg, artifact)
    del artifact
    _free()
    checked = merge_checked(family_checks(name, calls, variants), st["checked"])
    detail.setdefault("families", {})[name] = dict(
        groups=seen_groups, blocks=blocks, expert_mean=expert_mean, serve=stats, launches=counts,
        eval={k: r[1] for k, r in results.items()}, ptq_seconds={k: r[2] for k, r in results.items()},
        checked=checked)
    return counts, checked


def family_dense(dev, detail, name, kv_dtypes):
    """Phase 10 (b): one dense config at full width, one period."""
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

    cfg = dataclasses.replace(get_config(name), n_periods=1)
    plan = M.make_plan(cfg)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    params = M.init_params(plan, 0, device=dev)
    data = DataConfig(vocab=cfg.vocab, seed=0)
    calib = [make_batch_fn(data, cfg, *FAM_DENSE_CALIB, split="calib")[0](0)]
    eval_fn, _ = make_batch_fn(data, cfg, *FAM_DENSE_EVAL, split="eval")
    blocks = []
    with recording_calls() as calls:
        pcfg = solver.PTQConfig(method="quantease", spec=GridSpec(bits=4), iterations=PTQ_ITERATIONS,
                                emit="qt")
        t1 = time.monotonic()
        with checked_solves(name, calls, replay=FAM_CD_REPLAYED.get(name, False)) as st:
            net, t_net = less_checks(st), less_checks(st)
            q, report = solver.ptq_quantize_model(plan, params, calib, pcfg, device=dev,
                                                  progress_cb=lambda r: blocks.append(net(r["seconds"])))
        artifact = quantize_params_for_serving(plan, params, q["dec"], device=dev)
        del q, params
        _free()
        t_ptq = t_net(time.monotonic() - t1)
        m = eval_model(plan, artifact, eval_fn, budget=EvalBudget(n_ppl_batches=2), device=dev)
        prompts = family_prompts(cfg.vocab, FAM_REQUESTS, FAM_PROMPT_LO, FAM_PROMPT_HI)
        serve = {kv: family_serve(f"{name} quantease@4 paged {kv}", M.make_plan(cfg, kv_cache_dtype=kv),
                                  artifact, prompts, FAM_NEW, dev) for kv in kv_dtypes}
    torch.cuda.synchronize()
    counts = path_counts(st)
    variants = dict(dequant_matmul_cuda.launches_by_variant)
    vals = np.array(list(report.values()))
    check(np.all(np.isfinite(vals)) and math.isfinite(m["ppl"]), f"{name}: report {report}, eval {m}")
    if name in FAM_CD_REPLAYED:
        check(st["checked"].get("fused_iteration", {}).get("calls") == 1
              and st["checked"].get("block_sweep", {}).get("calls", 0) > 0,
              f"{name}: not one CD signature replayed: {st['checked']}")
    for k in ("quantease_block_sweep", "quantease_fused_iteration", "dequant_matmul", "paged_attention"):
        check(counts[k] > 0, f"{name}: kernel {k} not launched: {counts}")
    print(f"[family] {name}: {len(vals)} linears mean rel error {vals.mean():.6f}, ppl {m['ppl']:.4f}; "
          f"PTQ seconds per decoder layer {', '.join(f'{x:.2f}' for x in blocks)} (PTQ + restack "
          f"{t_ptq:.1f}s, the CD checks' {st['seconds']:.1f}s apart); "
          + "; ".join(f"{kv} decode {sv['decode_tok_s']:.1f} tok/s {sv['ms_per_step']:.2f} ms/step"
                      for kv, sv in serve.items())
          + f"; launches {counts}, dequant_matmul by variant {variants} ({time.monotonic() - t0:.1f}s)",
          flush=True)
    del artifact
    _free()
    checked = merge_checked(family_checks(name, calls, variants), st["checked"])
    detail.setdefault("families", {})[name] = dict(
        mean_rel_error=float(vals.mean()), eval=m, blocks=blocks, serve=serve, launches=counts,
        ptq_seconds=t_ptq, checked=checked)
    return counts, checked


def family_mixtral(dev, detail):
    """Phase 10 (c): Mixtral-8x22B at full width, one layer, a 4-bit RTN
    artifact served."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.models import model as M
    from repro_torch.serve.qparams import rtn_quantize_for_serving

    name = FAM_MIXTRAL
    cfg = dataclasses.replace(get_config(name), n_periods=1)
    plan = M.make_plan(cfg)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    params = M.init_params(plan, 0, device=dev)
    artifact, layout = rtn_quantize_for_serving(plan, params, bits=4)
    del params
    _free()
    t_rtn = time.monotonic() - t0
    w_up = artifact["dec"]["b0"]["w_up"]
    with recording_calls() as calls:
        prompts = family_prompts(cfg.vocab, FAM_REQUESTS, FAM_PROMPT_LO, FAM_PROMPT_HI)
        stats = family_serve(f"{name} rtn@4 paged bf16", plan, artifact, prompts, FAM_NEW, dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    variants = dict(dequant_matmul_cuda.launches_by_variant)
    check(counts["dequant_matmul"] >= cfg.n_experts * 3 and counts["paged_attention"] > 0,
          f"{name}: launches {counts}")
    print(f"[family] {name}: RTN 4-bit artifact [{layout}], expert codes {tuple(w_up.codes.shape)} "
          f"({t_rtn:.1f}s); decode {stats['decode_tok_s']:.1f} tok/s, {stats['ms_per_step']:.2f} "
          f"ms/step; launches {counts}, dequant_matmul by variant {variants}", flush=True)
    del artifact, w_up
    _free()
    checked = family_checks(name, calls, variants)
    detail.setdefault("families", {})[name] = dict(serve=stats, launches=counts, rtn_seconds=t_rtn,
                                                  checked=checked)
    return counts, checked


def families(dev, detail, tp_keep):
    """Phase 10: (a) OLMoE-1B-7B, (b) the dense configs, (c) Mixtral-8x22B,
    each at full width with its depth cut, seeded random bf16 weights, what
    the previous one left freed first.  Returns the kernels' launch counts
    summed over the configs (each read just after its config's path ran,
    from 0) and the checked calls per config; (a) fills ``tp_keep``."""
    per, checked = {}, {}
    _free()
    per[FAM_MOE[0]], checked[FAM_MOE[0]] = family_moe(dev, detail, tp_keep)
    for name, kvs in FAM_DENSE:
        _free()
        t0 = time.monotonic()
        per[name], checked[name] = family_dense(dev, detail, name, kvs)
        print(f"[phase] 10 {name}: {time.monotonic() - t0:.1f}s", flush=True)
    _free()
    per[FAM_MIXTRAL], checked[FAM_MIXTRAL] = family_mixtral(dev, detail)
    counts = {k: sum(c[k] for c in per.values()) for k in next(iter(per.values()))}
    return counts, checked


# ---------------------------------------------------------------------------
# Phase 11: Mamba-2 and Jamba-1.5-Large at full width
# ---------------------------------------------------------------------------


def ssm_serve(label, plan, artifact, prompts, new_tokens, dev, keep=None):
    """One contiguous run (every request completes with ``new_tokens``);
    returns its stats and kernel 3's launches by variant in the run.  With
    ``keep``, as :func:`family_serve`."""
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.serve import ServingEngine

    before = dict(dequant_matmul_cuda.launches_by_variant)
    stats, outputs, eng = serve_run(label, lambda: ServingEngine(
        plan, artifact, **SSM_CONTIG, record_logits=keep is not None, device=dev), prompts,
        new_tokens)
    by_variant = {v: c - before[v] for v, c in dequant_matmul_cuda.launches_by_variant.items()}
    check(stats["statuses"] == ["completed"] and all(len(o) == new_tokens for o in outputs.values()),
          f"{label}: statuses {stats['statuses']}")
    check(by_variant["tc_small"] > 0 and by_variant["simt"] == 0,
          f"{label}: kernel 3 launches by variant {by_variant}")
    if keep is not None:
        keep.update(outputs=outputs, trace=eng.logit_trace, stats=stats)
    del eng
    return stats, by_variant


def ssm_mamba(dev, detail):
    """Phase 11 (a): Mamba-2-2.7B at full width, 4 of 64 layers."""
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

    name, periods = SSM_MAMBA
    cfg = dataclasses.replace(get_config(name), n_periods=periods)
    plan = M.make_plan(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(plan, 0, device=dev)
    data = DataConfig(vocab=cfg.vocab, seed=0)
    calib = [make_batch_fn(data, cfg, *SSM_CALIB, split="calib")[0](0)]
    eval_fn, _ = make_batch_fn(data, cfg, *SSM_EVAL, split="eval")
    groups, blocks, results = [], [], {}

    def seen(w3, gcfg):
        groups.append((gcfg.method, gcfg.spec.bits, *w3.shape))

    ops.reset_launch_counts()
    t0 = time.monotonic()
    with recording_calls() as calls:
        with checked_solves(name, calls, seen, phase="phase 11") as st:
            net, net_all = less_checks(st), less_checks(st)
            for method, bits in SSM_RUNS:
                label = f"{method}@{bits}"
                pcfg = solver.PTQConfig(method=method, spec=GridSpec(bits=bits),
                                        iterations=PTQ_ITERATIONS, emit="qt", outlier_frac=OUTLIER_FRAC,
                                        stream_chunk=SSM_STREAM)
                t_net = less_checks(st)
                t1 = time.monotonic()
                q, report = solver.ptq_quantize_model(
                    plan, params, calib, pcfg, device=dev,
                    progress_cb=lambda r, label=label: blocks.append((label, r["period"],
                                                                      net(r["seconds"]))))
                served = quantize_params_for_serving(plan, params, q["dec"], device=dev)
                t_ptq = t_net(time.monotonic() - t1)
                metrics = eval_model(plan, served, eval_fn, budget=EvalBudget(n_ppl_batches=2),
                                     device=dev)
                results[label] = (report, metrics, t_ptq)
                if label == SSM_SERVED:
                    artifact = served
                del q, served
                _free()
        ptq_counts = path_counts(st)
        t_ptq_all = net_all(time.monotonic() - t0)
        del params
        _free()
        prompts = serve_traffic(cfg.vocab)[:SSM_REQUESTS]
        stats, by_variant = ssm_serve(f"{name} {SSM_SERVED} contiguous", plan, artifact, prompts,
                                      SSM_NEW, dev)
    torch.cuda.synchronize()
    counts = path_counts(st)
    peak = torch.cuda.max_memory_allocated() / 2**30
    variants = dict(dequant_matmul_cuda.launches_by_variant)
    seen_groups = sorted({g[2:] for g in groups}, key=lambda g: (-g[0], -g[1]))
    print(f"[ssm] {name}: solver groups (G, q, p) {seen_groups}; seconds per decoder layer "
          + "; ".join(f"{lb} " + ", ".join(f"{s:.2f}" for l2, _, s in blocks if l2 == lb)
                      for lb in results), flush=True)
    mean = {}
    for label, (report, m, t_ptq) in results.items():
        vals = np.array(list(report.values()))
        check(np.all(np.isfinite(vals)) and math.isfinite(m["ppl"]), f"{name} {label}: {m}")
        for p in range(periods):
            keys = sorted(k.split("/")[1] for k in report if k.startswith(f"dec.p{p}.b0/"))
            check(keys == ["out_proj", "wbc", "wx", "wz"], f"{name} {label}: p{p} report keys {keys}")
        mean[label] = float(vals.mean())
        print(f"[ssm] {name} {label}: {len(vals)} report keys, mean rel error {mean[label]:.6f}; "
              f"ppl {m['ppl']:.4f} top1 {m['top1']:.4f} choice_acc {m['choice_acc']:.4f} "
              f"(PTQ + restack {t_ptq:.1f}s)", flush=True)
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    check(set(seen_groups) == {(2, cfg.d_inner, cfg.d_model), (1, 2 * G * N, cfg.d_model),
                               (1, cfg.d_model, cfg.d_inner)}, f"{name}: solver groups {seen_groups}")
    check(mean["quantease@4"] < mean["rtn@4"] and mean["qe_outlier@3"] < mean["quantease@3"],
          f"{name}: mean errors {mean}")
    for k in ("quantease_block_sweep", "quantease_fused_iteration", "dequant_matmul",
              "quantease_outlier_iteration"):
        check(ptq_counts[k] > 0, f"{name}: kernel {k} not launched by PTQ and eval: {ptq_counts}")
    print(f"[ssm] {name}: launches {counts}; dequant_matmul by variant {variants} (serving "
          f"{by_variant}); PTQ and eval {t_ptq_all:.1f}s, the CD checks' {st['seconds']:.1f}s "
          f"apart; served {SSM_SERVED}: decode {stats['decode_tok_s']:.1f} tok/s, "
          f"{stats['ms_per_step']:.2f} ms per decode step; peak device memory {peak:.2f} GiB",
          flush=True)
    del artifact
    _free()
    checked = merge_checked(family_checks(name, calls, variants, "phase 11"), st["checked"])
    detail.setdefault("families", {})[name] = dict(
        groups=seen_groups, blocks=blocks, mean_rel_error=mean, serve=stats, launches=counts,
        serve_variants=by_variant, eval={k: r[1] for k, r in results.items()},
        ptq_seconds={k: r[2] for k, r in results.items()}, peak_gib=peak, checked=checked)
    return counts, checked


def ssm_jamba(dev, detail, tp_keep):
    """Phase 11 (b): Jamba-1.5-Large at full width, its period cut to two
    blocks: (i) PTQ and eval on blocks 0 and 2, (ii) an RTN artifact of
    blocks 0 and 1 served: phase 13 (d)'s one-rank baseline, whose logits,
    first decodes' routes and artifact go into ``tp_keep["jamba"]``."""
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
    from repro_torch.serve.qparams import quantize_params_for_serving, rtn_quantize_for_serving

    name, base = SSM_JAMBA, get_config(SSM_JAMBA)
    cut = lambda idx: dataclasses.replace(base, n_periods=1,
                                          pattern=tuple(base.pattern[i] for i in idx))
    # (i) PTQ and eval.
    cfg = cut(SSM_JAMBA_PTQ)
    plan = M.make_plan(cfg)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    params = M.init_params(plan, 0, device=dev)
    data = DataConfig(vocab=cfg.vocab, seed=0)
    calib = [make_batch_fn(data, cfg, *SSM_JAMBA_CALIB, split="calib")[0](0)]
    eval_fn, _ = make_batch_fn(data, cfg, *SSM_EVAL, split="eval")
    groups, blocks = [], []

    def seen(w3, gcfg):
        groups.append((gcfg.method, gcfg.spec.bits, *w3.shape))

    with recording_calls() as calls:
        pcfg = solver.PTQConfig(method="rtn", spec=GridSpec(bits=4), iterations=PTQ_ITERATIONS,
                                emit="qt", stream_chunk=SSM_JAMBA_STREAM,
                                layer_specs={n: solver.LayerSpec(method="quantease")
                                             for n in SSM_JAMBA_QE})
        t1 = time.monotonic()
        with checked_solves(name, calls, seen, phase="phase 11") as st:
            net, t_net = less_checks(st), less_checks(st)
            q, report = solver.ptq_quantize_model(plan, params, calib, pcfg, device=dev,
                                                  progress_cb=lambda r: blocks.append(net(r["seconds"])))
        artifact = quantize_params_for_serving(plan, params, q["dec"], device=dev)
        del q, params
        _free()
        t_ptq = t_net(time.monotonic() - t1)
        m = eval_model(plan, artifact, eval_fn, budget=EvalBudget(n_ppl_batches=2), device=dev)
        del artifact
        _free()
        torch.cuda.synchronize()
        counts_ptq = path_counts(st)
        variants_ptq = dict(dequant_matmul_cuda.launches_by_variant)
        peak_ptq = torch.cuda.max_memory_allocated() / 2**30
        # (ii) the MoE block, served from an RTN artifact.
        cfg2 = cut(SSM_JAMBA_SERVE)
        plan2 = M.make_plan(cfg2)
        torch.cuda.reset_peak_memory_stats()
        t2 = time.monotonic()
        params = M.init_params(plan2, 0, device=dev)
        served, layout = rtn_quantize_for_serving(plan2, params, bits=4)
        del params
        _free()
        t_rtn = time.monotonic() - t2
        w_up = served["dec"]["b1"]["w_up"]
        prompts = family_prompts(cfg2.vocab, FAM_REQUESTS, FAM_PROMPT_LO, FAM_PROMPT_HI)
        base = tp_keep["jamba"] = dict(engine="contiguous", prompts=prompts, new=FAM_NEW)
        with first_decode_routes(prompts) as (routes, per_step):
            stats, by_variant = ssm_serve(f"{name} blocks 0+1 rtn@4 contiguous", plan2, served,
                                          prompts, FAM_NEW, dev, keep=base)
        base.update(routes=routes, kernel3_per_step=per_step)
        torch.cuda.synchronize()
        peak_serve = torch.cuda.max_memory_allocated() / 2**30
    counts = path_counts(st)
    variants = dict(dequant_matmul_cuda.launches_by_variant)
    qe_groups = sorted({g[2:] for g in groups if g[0] == "quantease"}, key=lambda g: (-g[0], -g[1]))
    rtn_groups = sorted({g[2:] for g in groups if g[0] == "rtn"}, key=lambda g: (-g[0], -g[1]))
    vals = np.array(list(report.values()))
    mamba_keys = sorted(k.split("/")[1] for k in report if k.startswith("dec.p0.b1/"))
    check(np.all(np.isfinite(vals)) and math.isfinite(m["ppl"]), f"{name}: report {report}, eval {m}")
    check(mamba_keys == ["out_proj", "wbc", "wd", "wg", "wu", "wx", "wz"],
          f"{name}: the Mamba block's report keys {mamba_keys}")
    check(set(qe_groups) == {(2, cfg.d_inner, cfg.d_model), (1, 2 * cfg.ssm_ngroups * cfg.ssm_state,
                                                               cfg.d_model), (1, cfg.d_model, cfg.d_inner)},
          f"{name}: QuantEase groups {qe_groups}")
    for k in ("quantease_block_sweep", "quantease_fused_iteration", "dequant_matmul"):
        check(counts_ptq[k] > 0, f"{name}: kernel {k} not launched by PTQ and eval: {counts_ptq}")
    check(counts["dequant_matmul"] - counts_ptq["dequant_matmul"] >= cfg2.n_experts * 3,
          f"{name}: launches {counts}")
    qe = {k: v for k, v in report.items() if k.rsplit("/", 1)[1] in SSM_JAMBA_QE}
    print(f"[ssm] {name} blocks 0+2: QuantEase groups (G, q, p) {qe_groups}, RTN groups {rtn_groups}; "
          f"seconds per decoder layer {', '.join(f'{x:.2f}' for x in blocks)} (PTQ + restack "
          f"{t_ptq:.1f}s, the CD checks' {st['seconds']:.1f}s apart); QuantEase leaves' mean rel "
          f"error {np.mean(list(qe.values())):.6f}, all {len(vals)} linears {vals.mean():.6f}; ppl "
          f"{m['ppl']:.4f}; dequant_matmul by variant {variants_ptq}; peak device memory "
          f"{peak_ptq:.2f} GiB", flush=True)
    print(f"[ssm] {name} blocks 0+1: RTN 4-bit artifact [{layout}], expert codes "
          f"{tuple(w_up.codes.shape)} ({t_rtn:.1f}s); decode {stats['decode_tok_s']:.1f} tok/s, "
          f"{stats['ms_per_step']:.2f} ms per decode step; dequant_matmul by variant (serving) "
          f"{by_variant}; peak device memory {peak_serve:.2f} GiB; launches {counts} "
          f"({time.monotonic() - t0:.1f}s)", flush=True)
    del w_up
    tp_save(tp_keep, "jamba", f"{name} blocks 0+1 rtn@4", cfg2, served)
    del served
    _free()
    checked = merge_checked(family_checks(name, calls, variants, "phase 11"), st["checked"])
    detail.setdefault("families", {})[name] = dict(
        qe_groups=qe_groups, blocks=blocks, mean_rel_error=float(vals.mean()), eval=m,
        ptq_seconds=t_ptq, serve=stats, serve_variants=by_variant, rtn_seconds=t_rtn,
        peak_gib=dict(ptq=peak_ptq, serve=peak_serve), launches=counts, checked=checked)
    return counts, checked


def ssm_families(dev, detail, tp_keep):
    """Phase 11: (a) Mamba-2-2.7B, (b) Jamba-1.5-Large, at full width with
    their depth cut, seeded random bf16 weights, what the previous one left
    freed first.  Returns the kernels' launch counts summed over the two
    (each read just after its path ran, from 0) and the checked calls per
    config; (b) fills ``tp_keep``."""
    per, checked = {}, {}
    for name, fn in ((SSM_MAMBA[0], ssm_mamba), (SSM_JAMBA, lambda d, det: ssm_jamba(d, det, tp_keep))):
        _free()
        t0 = time.monotonic()
        per[name], checked[name] = fn(dev, detail)
        print(f"[phase] 11 {name}: {time.monotonic() - t0:.1f}s", flush=True)
    counts = {k: sum(c[k] for c in per.values()) for k in next(iter(per.values()))}
    return counts, checked


def greedy_decode(label, plan, params, batch, n_new, cap, dev, keep: dict) -> tuple:
    """Prefill ``batch`` (tokens with their frames or patches), then
    ``n_new`` greedy decode steps at the positions after the prompt (after
    the patches for a prefix model).  Every logit must be finite.  Returns
    the run's numbers and a function that holds the first step's logits
    within DECODE_PREFILL_TOL of max |logit| of a prefill over the prompt
    and that step's token: it launches kernels of its own, so the caller
    reads the path's launch counts before it calls it.  Each decode step's
    logits (kept on the card until the steps are timed, then cast to fp32)
    and tokens go into ``keep`` as an engine records them, ``trace`` and
    ``outputs`` by row, with the run's numbers under ``stats``: phase 13
    (f)'s baseline and each rank's run."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    B, S = tokens.shape
    pos0 = S + plan.cfg.n_prefix
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, cache = M.prefill(plan, params, batch, M.init_cache(plan, B, cap, device=dev))
    torch.cuda.synchronize()
    t_prefill = time.monotonic() - t0
    finite = torch.isfinite(logits).all()
    tok = logits.argmax(-1)
    first_tok, first, steps, toks = tok, None, [], []
    k3 = ops.launch_counts()["dequant_matmul"]
    t1 = time.monotonic()
    for step in range(n_new):
        logits, cache = M.decode_step(plan, params, tok[:, None], cache, pos0 + step)
        first = logits.float().clone() if first is None else first
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        steps.append(logits)
        toks.append(tok)
    torch.cuda.synchronize()
    t_decode = time.monotonic() - t1
    k3 = ops.launch_counts()["dequant_matmul"] - k3
    del cache
    check(bool(finite), f"{label}: a logit is not finite")
    out = dict(sequences=B, prompt_positions=pos0, decode_steps=n_new, prefill_s=t_prefill,
               ms_per_step=t_decode / n_new * 1e3, kernel3_per_step=k3 / n_new)
    print(f"[encdec] {label}: prefill {B} x {pos0} positions {t_prefill:.2f}s; {n_new} greedy "
          f"decode steps {out['ms_per_step']:.2f} ms per step, kernel 3 {k3 / n_new:g} launches "
          f"a step", flush=True)
    trace = torch.stack(steps, 1).float().cpu().numpy()  # (B, n_new, V)
    outs = torch.stack(toks, 1).cpu().tolist()
    keep.update(trace={b: list(trace[b]) for b in range(B)},
                outputs={b: outs[b] for b in range(B)}, stats=out)
    del steps, toks, trace

    def against_prefill():
        ref, _ = M.prefill(plan, params, dict(batch, tokens=torch.cat([tokens, first_tok[:, None]], 1)),
                           M.init_cache(plan, B, cap, device=dev))
        rel = float((first - ref.float()).abs().max()) / float(ref.float().abs().max())
        check(rel <= DECODE_PREFILL_TOL, f"{label}: the first decode step's logits part from a "
              f"prefill over the prompt and its token by {rel:.4f} of max |logit|")
        out["decode_vs_prefill"] = rel
        print(f"[encdec] {label}: the first decode step against a prefill over the prompt and its "
              f"token {rel:.5f} of max |logit| (tol {DECODE_PREFILL_TOL})", flush=True)

    return out, against_prefill


def leaf_kind_means(report: dict, stack: str) -> dict:
    """Mean relative error of ``stack``'s report keys by leaf kind."""
    import numpy as np

    out = {}
    for kind, names in LEAF_KINDS.items():
        vals = [v for k, v in report.items()
                if k.startswith(f"{stack}.") and k.rsplit("/", 1)[1] in names]
        if vals:
            out[kind] = float(np.mean(vals))
    return out


def encdec_config(dev, detail, name, cfg, runs, calib_shape, n_calib, stream, serve, served,
                  tp_keep: dict):
    """Phase 12, one config: each of ``runs`` (``emit="qt"``, the encoder
    first where there is one), both stacks restacked; then the ``served``
    artifact prefills and decodes greedily (:func:`greedy_decode`).  Every
    kernel call is held against its plain version, the CD calls right
    after each group solve, kernel 3 at the end.  Returns the launch counts
    and the checked calls.  The greedy run records its logits into
    ``tp_keep[name]``, phase 13 (f)'s one-rank baseline, and the served
    artifact, its batch and run settings are saved for (f)
    (:func:`tp_save`)."""
    import numpy as np
    import torch

    from repro_torch.core import solver
    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.models import model as M
    from repro_torch.quant import GridSpec
    from repro_torch.serve.qparams import quantize_params_for_serving

    plan = M.make_plan(cfg)
    stacks = ("enc", "dec") if cfg.family == "encdec" else ("dec",)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    params = M.init_params(plan, 0, device=dev)
    data = DataConfig(vocab=cfg.vocab, seed=0)
    calib_fn, _ = make_batch_fn(data, cfg, *calib_shape, split="calib")
    calib = [calib_fn(i) for i in range(n_calib)]
    t_data = time.monotonic() - t0
    groups, blocks, results = [], [], {}

    def seen(w3, gcfg):
        groups.append((gcfg.method, gcfg.spec.bits, *w3.shape))

    with recording_calls() as calls:
        with checked_solves(name, calls, seen, phase="phase 12") as st:
            net, net_all = less_checks(st), less_checks(st)
            t_all = time.monotonic()
            for method, bits in runs:
                label = f"{method}@{bits}"
                pcfg = solver.PTQConfig(method=method, spec=GridSpec(bits=bits),
                                        iterations=PTQ_ITERATIONS, emit="qt",
                                        outlier_frac=OUTLIER_FRAC, stream_chunk=stream)
                t_net = less_checks(st)
                t1 = time.monotonic()
                q, report = solver.ptq_quantize_model(
                    plan, params, calib, pcfg, device=dev,
                    progress_cb=lambda r, label=label: blocks.append(
                        (label, r["stack"], r["period"], net(r["seconds"]))))
                artifact = quantize_params_for_serving(plan, params, q["dec"],
                                                       solver_qt_enc=q.get("enc"), device=dev)
                results[label] = (report, t_net(time.monotonic() - t1))
                if label == served:
                    kept = artifact
                del q, artifact
                _free()
        ptq_counts = path_counts(st)
        t_ptq_all = net_all(time.monotonic() - t_all)
        variants_ptq = dict(dequant_matmul_cuda.launches_by_variant)
        peak_ptq = torch.cuda.max_memory_allocated() / 2**30
        del params, calib
        _free()
        B, S, n_new = serve
        batch = make_batch_fn(data, cfg, B, S, split="eval")[0](0)
        cap = -(-(S + cfg.n_prefix + n_new + 1) // 64) * 64
        base = tp_keep.setdefault(name, {})
        stats, against_prefill = greedy_decode(f"{name} {served}", plan, kept, batch, n_new, cap,
                                               dev, keep=base)
        torch.cuda.synchronize()
        counts = path_counts(st)
        variants = dict(dequant_matmul_cuda.launches_by_variant)
    # Outside the recording, after the counts: the check's own prefill.
    against_prefill()
    base.update(batch=batch, n_new=n_new, cap=cap)
    tp_save(tp_keep, name, f"{name} {served}", cfg, kept)
    del batch
    by_variant = {v: c - variants_ptq[v] for v, c in variants.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    seen_groups = sorted({g[2:] for g in groups}, key=lambda g: (-g[0], -g[1], -g[2]))
    for label in results:
        for stack in stacks:
            secs = [s_ for l2, st_, _, s_ in blocks if l2 == label and st_ == stack]
            print(f"[encdec] {name} {label} {stack}: seconds per layer "
                  f"{', '.join(f'{x:.2f}' for x in secs)}", flush=True)
    mean = {}
    for label, (report, t_ptq) in results.items():
        vals = np.array(list(report.values()))
        check(np.all(np.isfinite(vals)), f"{name} {label}: report {report}")
        for stack in stacks:
            svals = [v for k, v in report.items() if k.startswith(f"{stack}.")]
            check(len(svals) > 0, f"{name} {label}: no {stack} report keys")
            mean[label, stack] = float(np.mean(svals))
            kinds = leaf_kind_means(report, stack)
            print(f"[encdec] {name} {label} {stack}: {len(svals)} linears, mean rel error "
                  f"{mean[label, stack]:.6f}; by kind " + ", ".join(
                      f"{k} {v:.6f}" for k, v in kinds.items()) + f" (PTQ + restack {t_ptq:.1f}s)",
                  flush=True)
        mean[label] = float(vals.mean())
    for stack in stacks:
        check(mean["quantease@4", stack] < mean["rtn@4", stack],
              f"{name} {stack}: QuantEase@4 not below RTN@4: {mean}")
    if "qe_outlier@3" in mean:
        check(mean["qe_outlier@3"] < mean["quantease@3"],
              f"{name}: qe_outlier@3 not below QuantEase@3: {mean}")
    need = ["quantease_block_sweep", "quantease_fused_iteration", "dequant_matmul"]
    need += ["quantease_outlier_iteration"] if "qe_outlier@3" in mean else []
    for k in need:
        check(ptq_counts[k] > 0, f"{name}: kernel {k} not launched by PTQ: {ptq_counts}")
    check(by_variant["tc_small"] > 0 and by_variant["tc_large"] > 0 and variants["simt"] == 0,
          f"{name}: kernel 3 launches by variant: PTQ {variants_ptq}, serving {by_variant}")
    print(f"[encdec] {name}: solver groups (G, q, p) {seen_groups}; launches {counts}; kernel 3 by "
          f"variant in PTQ {variants_ptq}, in prefill and decode {by_variant}; PTQ and restack "
          f"{t_ptq_all:.1f}s, the CD checks' {st['seconds']:.1f}s apart, calibration data "
          f"{t_data:.1f}s; peak device memory {peak_ptq:.2f} GiB in PTQ, {peak:.2f} GiB in all",
          flush=True)
    del kept
    _free()
    checked = merge_checked(family_checks(name, calls, variants, "phase 12"), st["checked"])
    detail.setdefault("families", {})[name] = dict(
        groups=seen_groups, blocks=blocks, mean_rel_error={f"{k[0]} {k[1]}" if isinstance(k, tuple)
                                                           else k: v for k, v in mean.items()},
        by_kind={label: {stack: leaf_kind_means(r[0], stack) for stack in stacks}
                 for label, r in results.items()},
        ptq_seconds={k: r[1] for k, r in results.items()}, serve=stats, launches=counts,
        variants_ptq=variants_ptq, variants_serve=by_variant,
        peak_gib=dict(ptq=peak_ptq, all=peak), checked=checked)
    return counts, checked


def encdec_cfg(name: str):
    """Phase 12's config of Whisper-large-v3 or LLaVA-NeXT-34B: full width,
    the depth ENC_WHISPER or PFX_LLAVA gives (both of Whisper's stacks)."""
    from repro_torch.configs import get_config

    if name == ENC_WHISPER[0]:
        return dataclasses.replace(get_config(name), n_periods=ENC_WHISPER[1],
                                   n_enc_periods=ENC_WHISPER[1])
    return dataclasses.replace(get_config(name), n_periods=PFX_LLAVA[1])


def encdec_families(dev, detail, tp_keep: dict):
    """Phase 12: (a) Whisper-large-v3, (b) LLaVA-NeXT-34B, at full width
    with their depth cut, seeded random bf16 weights, what the previous
    one left freed first.  Returns the kernels' launch counts summed over
    the two (each read just after its path ran, from 0) and the checked
    calls per config.  ``tp_keep`` takes phase 13 (f)'s baselines and
    artifacts (:func:`encdec_config`)."""
    name, name_p = ENC_WHISPER[0], PFX_LLAVA[0]
    whisper, llava = encdec_cfg(name), encdec_cfg(name_p)
    per, checked = {}, {}
    for n, cfg, args in ((name, whisper, (ENC_RUNS, ENC_CALIB, ENC_CALIB_BATCHES, 0, ENC_SERVE,
                                          "quantease@4")),
                         (name_p, llava, (PFX_RUNS, PFX_CALIB, PFX_CALIB_BATCHES, PFX_STREAM,
                                          PFX_SERVE, "quantease@4"))):
        _free()
        t0 = time.monotonic()
        per[n], checked[n] = encdec_config(dev, detail, n, cfg, *args, tp_keep=tp_keep)
        print(f"[phase] 12 {n}: {time.monotonic() - t0:.1f}s", flush=True)
    counts = {k: sum(c[k] for c in per.values()) for k in next(iter(per.values()))}
    return counts, checked


# ---------------------------------------------------------------------------
# Phase 13: the data-parallel mesh (two gloo ranks on the card; FSDP at
# world size 1 over NCCL), and tensor-parallel serving on the same ranks
# ---------------------------------------------------------------------------


def solver_groups(blk_names: list, shapes: dict) -> list:
    """The solver's same-shape groups of one block, in its order: the
    quantizable leaves by name, grouped by (q, p) in order of first
    appearance (``core.solver._quantize_block`` with one config)."""
    from repro_torch.core.solver import QUANTIZABLE

    groups: dict = {}
    for name in sorted(blk_names):
        if name in QUANTIZABLE:
            groups.setdefault(shapes[name], []).append(name)
    return list(groups.values())


def _tree_bytes(tree) -> bytes:
    import hashlib

    import torch

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _sharded_rank(rank, world, store, out_path, dev_type, queue, go):
    """One rank of phase 13 (a): ``ptq_quantize_model(mesh=)`` on its
    sequences of phase 5's calibration set, QuantEase at 4 bits, its rows of
    each group through kernels 1 and 2 on the card, kernels 1 and 2 held
    against their plain versions on one call per signature.  Rank 0 saves
    its artifact and each group's Σ; every rank reports its launches, its
    collectives and the digests of its artifact, Σ's and params, with (c)'s
    results (:func:`tp_serve_rank`, (g) with them).  Then the rank frees the
    card and serves (d), (e) and (f) one message at a time
    (:func:`rank_messages`)."""
    import traceback

    import torch
    import torch.distributed as dist

    try:
        from repro_torch.configs import get_config
        from repro_torch.core import solver
        from repro_torch.data import DataConfig, make_batch_fn
        from repro_torch.device import resolve_device
        from repro_torch.dist.collectives import block_bounds
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_data_mesh
        from repro_torch.models import model as M
        from repro_torch.quant import GridSpec

        if dev_type == "cuda":
            torch.cuda.set_device(0)
        dev = resolve_device(torch.device("cuda", 0) if dev_type == "cuda" else "cpu")
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
        try:
            mesh = make_data_mesh(device=dev_type)
            cfg = dataclasses.replace(get_config("phi3_mini_3_8b"), **MAIN_OVERRIDES)
            plan = M.make_plan(cfg)
            params = M.init_params(plan, 0, device=dev)
            calib_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, MAIN_BATCH,
                                        MAIN_SEQ, split="calib")
            calib = [calib_fn(i) for i in range(MAIN_CALIB_BATCHES)]
            comm = {"all_reduce": [0, 0, 0.0], "all_gather": [0, 0, 0.0]}

            def counted(kind, fn, nbytes):
                def call(*a, **k):
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    if dev_type == "cuda":
                        torch.cuda.synchronize()
                    row = comm[kind]
                    row[0], row[1], row[2] = row[0] + 1, row[1] + nbytes(a, out), \
                        row[2] + time.perf_counter() - t0
                    return out
                return call

            size = lambda t: t.numel() * t.element_size()
            sigmas = []
            solve_group = solver._solve_group

            def keep_sigma(w3, sig3, gcfg, mesh=None):
                sigmas.append(sig3.clone())
                return solve_group(w3, sig3, gcfg, mesh)

            patched = dict(all_reduce=counted("all_reduce", solver.all_reduce,
                                              lambda a, out: size(a[0])),
                           gather_dim=counted("all_gather", solver.gather_dim,
                                              lambda a, out: size(out)),
                           _solve_group=keep_sigma)
            originals = {k: getattr(solver, k) for k in patched}
            blocks = []
            for k, v in patched.items():
                setattr(solver, k, v)
            try:
                pcfg = solver.PTQConfig(method="quantease", spec=GridSpec(bits=4),
                                        iterations=PTQ_ITERATIONS, emit="qt", shard=True)
                ops.reset_launch_counts()
                with recording_calls() as calls, \
                        checked_solves("sharded", calls, phase="phase 13") as st:
                    net = less_checks(st)
                    t0 = time.monotonic()
                    qparams, report = solver.ptq_quantize_model(
                        plan, params, calib, pcfg, mesh=mesh, device=dev,
                        progress_cb=lambda r: blocks.append(net(r["seconds"])))
                    if dev_type == "cuda":
                        torch.cuda.synchronize()
                    t_ptq = time.monotonic() - t0 - st["seconds"]
                counts = path_counts(st)
            finally:
                for k, v in originals.items():
                    setattr(solver, k, v)
            out = dict(counts=counts, checked=st["checked"], blocks=blocks, t_ptq=t_ptq,
                       comm=comm, report=report, artifact=_tree_bytes(qparams["dec"]),
                       sigmas=_tree_bytes(sigmas), params=_tree_bytes(params),
                       n_sequences=[hi - lo for lo, hi in
                                    (block_bounds(len(b["tokens"]), world, rank) for b in calib)])
            out["tp"] = tp_serve_rank(rank, plan, params, qparams["dec"], dev)
            if rank == 0:
                torch.save({"dec": tree_to(qparams["dec"], "cpu"),
                            "sigmas": [s.cpu() for s in sigmas]}, out_path)
            dist.barrier()
            queue.put((rank, True, out))
            del out, params, qparams, sigmas, calls, st, calib
            _free()
            rank_messages(rank, world, dev, queue, go)
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise


def rank_messages(rank, world, dev, queue, go) -> None:
    """A phase-13 rank's work after (c), one message at a time until None:
    ``("families", ...)`` serves each family of TP_FAMILIES
    (:func:`tp_family_rank`, (d)), ``("encdec", ...)`` each model of
    TP_ENCDEC (:func:`tp_encdec_rank`, (f)), ``("train", ...)`` trains each
    model it names (:func:`tp_train_rank`, (e) and (f)); the rank reports
    after each and frees the card."""
    import torch.distributed as dist

    while (msg := go.get(timeout=TP_WAIT_S)) is not None:
        kind, body = msg
        if kind == "families":
            out = {name: tp_family_rank(rank, world, body[name], dev) for name in TP_FAMILIES}
        elif kind == "encdec":
            out = {name: tp_encdec_rank(rank, world, body[name], dev) for name in TP_ENCDEC}
        else:
            out = {name: tp_train_rank(rank, world, name, body, dev) for name in body["names"]}
        dist.barrier()
        queue.put((rank, True, out))
        del out
        _free()


def tp_shard_bytes(whole, local, axes, rules, n: int) -> tuple:
    """Leaf by leaf, the bytes of storage a rank holds against its shard of
    ``whole``: a leaf the rules put on "model" 1/n, any other leaf whole
    (a per-channel grid of a row-parallel linear included; an MoE matrix
    cut on its experts cuts its grid too).  Returns ``(leaves that differ,
    bytes held, bytes of the whole)``."""
    from repro_torch.quant import QuantizedTensor

    bad, held, total = [], 0, 0

    def one(path, w, l, sharded):
        nonlocal held, total
        want = w.numel() * w.element_size() // (n if sharded else 1)
        got = l.untyped_storage().nbytes()
        held, total = held + got, total + w.numel() * w.element_size()
        if got != want:
            bad.append((path, got, want))

    def walk(w, l, ax, path):
        if isinstance(w, QuantizedTensor):
            check(w.outlier_idx is None and w.outlier_col_idx is None and not w.group_size,
                  f"{path}: phase 13 counts per-channel artifacts without outliers")
            dim = rules.shard_dim(tuple(ax["codes"]), "model")
            one(f"{path}.codes", w.codes, l.codes, dim is not None)
            for f in ("scale", "zero"):
                one(f"{path}.{f}", getattr(w, f), getattr(l, f),
                    dim is not None and dim <= w.codes.dim() - 2)
        elif isinstance(w, dict):
            for k in w:
                walk(w[k], l[k], ax[k], f"{path}.{k}" if path else k)
        else:
            one(path, w, l, rules.shard_dim(tuple(ax), "model") is not None)

    walk(whole, local, axes, "")
    return bad, held, total


@contextlib.contextmanager
def counted_collectives():
    """While open, the tensor-parallel collectives of the forward and
    backward passes (``dist.collectives.all_reduce``, ``gather_dim``,
    through which ``copy_to``, ``reduce_from``, ``gather_from`` and
    ``max_over`` run) and the agreed clock's ``broadcast_from`` (a serving
    engine's clock readings on the axis) are counted into the dict it
    yields: per kind the calls, the bytes a rank sends (its tensor, or its
    shard; 8 a broadcast reading) and the seconds each holds the host (gloo
    returns once the data has arrived)."""
    from repro_torch.dist import collectives as M

    import torch

    comm = {"all_reduce": [0, 0, 0.0], "all_gather": [0, 0, 0.0], "broadcast": [0, 0, 0.0]}

    def counted(kind, fn):
        def call(t, *a, **k):
            t0 = time.perf_counter()
            out = fn(t, *a, **k)
            row = comm[kind]
            n = t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 8 * len(t)
            row[0], row[1], row[2] = row[0] + 1, row[1] + n, row[2] + time.perf_counter() - t0
            return out
        return call

    originals = M.all_reduce, M.gather_dim, M.broadcast_from
    M.all_reduce, M.gather_dim, M.broadcast_from = (
        counted("all_reduce", M.all_reduce), counted("all_gather", M.gather_dim),
        counted("broadcast", M.broadcast_from))
    try:
        yield comm
    finally:
        M.all_reduce, M.gather_dim, M.broadcast_from = originals


def tp_serve_rank(rank, plan, params, qdec, dev) -> dict:
    """Phase 13 (c) on one rank: its shard (``dist.sharding.shard_tree``
    under ``serve.qparams.serving_rules``) of the restacked artifact, held
    leaf by leaf against 1/TP_RANKS of each sharded leaf, serves TP_PROMPTS
    requests on the paged engine inside the axis' rules, for each KV dtype
    of TP_KV; then every kernel-3 and kernel-5 signature of the runs once
    against its plain version.  Then (g) on the same shard
    (:func:`tp_spec_rank`).  Returns the outputs, the first decode step's
    logits, the launches, the collectives, the step times and (g)'s
    results."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import axis_rules, shard_tree
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServingEngine
    from repro_torch.serve.qparams import qt_param_axes, quantize_params_for_serving, serving_rules

    cfg = plan.cfg
    tplan = M.make_plan(cfg, TP_RANKS)
    check(tplan.heads.kv_pad == plan.heads.kv_pad and tplan.vocab_pad == cfg.vocab,
          "phase 13 (c): the axis pads the plan")
    mesh = DeviceMesh(dev.type, torch.arange(TP_RANKS), mesh_dim_names=("model",))
    rules = serving_rules(tplan, mesh)
    whole = quantize_params_for_serving(plan, params, qdec, device=dev)
    axes = qt_param_axes(tplan, whole)
    local = shard_tree(whole, axes, rules)
    bad, held, total = tp_shard_bytes(whole, local, axes, rules, TP_RANKS)
    del whole
    prompts = family_prompts(cfg.vocab, TP_PROMPTS, TP_PROMPT_LO, TP_PROMPT_HI)
    ops.reset_launch_counts()
    variants0 = dict(dequant_matmul_cuda.launches_by_variant)
    runs = {}
    with recording_calls() as calls, axis_rules(rules), counted_collectives() as comm:
        for kv in TP_KV:
            kplan = dataclasses.replace(tplan, kv_cache_dtype=kv)
            k5 = ops.launch_counts()["paged_attention"]
            stats, outputs, eng = serve_run(
                f"phase 13 (c) rank {rank} {kv}", lambda: PagedServingEngine(
                    kplan, local, **TP_PAGED, record_logits=True, device=dev), prompts, TP_NEW)
            n_attn = cfg.n_periods * len(cfg.pattern)
            check(ops.launch_counts()["paged_attention"] - k5 == eng.n_decode_steps * n_attn,
                  f"phase 13 (c) {kv}: kernel 5 not launched once a decode step and layer")
            runs[kv] = dict(stats=stats, outputs=outputs,
                            first={rid: t[0] for rid, t in eng.logit_trace.items()},
                            clock=(eng.clock.n_reads, eng.clock.n_broadcasts))
            if kv == "bf16":
                plain = (eng.logit_trace, outputs)
            del eng
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    variants = {v: n - variants0[v] for v, n in dequant_matmul_cuda.launches_by_variant.items()}
    checked = family_checks("tensor-parallel", calls, variants, phase="phase 13 (c)")
    del calls
    spec = tp_spec_rank(rank, tplan, rules, local, params, plain, prompts,
                        runs["bf16"]["stats"]["ms_per_step"], dev)
    return dict(runs=runs, counts=counts, comm=comm, variants=variants, checked=checked,
                bytes_bad=bad, bytes_held=held, bytes_whole=total,
                kv_slots=tplan.heads.kv_pad // TP_RANKS, prompts=[len(p) for p in prompts],
                spec=spec)


class _Ticks:
    """A virtual engine clock: ``dt`` seconds a reading."""

    def __init__(self, dt: float):
        self.t, self.dt = 0.0, dt

    def __call__(self) -> float:
        self.t += self.dt
        return self.t


def _prefix_agree(plain_trace, plain_out, out, tol) -> tuple:
    """:func:`spec_agree` over the steps both streams have (a request that
    expired holds only its first tokens)."""
    trace = {rid: plain_trace[rid][: len(out[rid])] for rid in out}
    return spec_agree(trace, {rid: plain_out[rid][: len(out[rid])] for rid in out}, out, tol)


def tp_spec_rank(rank, tplan, rules, local, dense, plain, prompts, plain_ms, dev) -> dict:
    """Phase 13 (g) on one rank, inside (c)'s rules on (c)'s shard: (i) the
    speculative runs of both drafts (:func:`spec_serve`, each stream held
    to (c)'s bf16 stream ``plain`` under the margin rule), (ii) the SLO run
    on the small pool (TP_SLO) with rank 0 on a virtual clock, (iii) again
    (TP_SLO_LIVE) with rank 0 on ``time.monotonic``, rank 1 skewed in both,
    then every kernel-3 and kernel-5 signature of (g) once against its
    plain version.  Returns
    each run's outputs, request records, counters, collectives and times,
    the launches of (g) (read before the replays) and the checks."""
    import torch

    from repro_torch.dist.sharding import axis_rules, shard_tree
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.serve import PagedServingEngine
    from repro_torch.serve.qparams import qt_param_axes, rtn_quantize_for_serving
    from repro_torch.serve.spec import SpecConfig, truncate_draft

    t_start = time.monotonic()
    rtn, layout = rtn_quantize_for_serving(tplan, dense, bits=SPEC_DRAFT_BITS)
    rtn_local = shard_tree(rtn, qt_param_axes(tplan, rtn), rules)
    del rtn
    pool = SPEC_POOL * (1 + TP_PAGED["max_batch"] * -(-TP_PAGED["max_seq"] // TP_PAGED["page_size"]))
    ops.reset_launch_counts()
    variants0 = dict(dequant_matmul_cuda.launches_by_variant)
    out = {"spec": {}, "rtn_layout": layout, "plain_ms": plain_ms}
    with recording_calls() as calls, axis_rules(rules):
        drafts = {"1-period draft": truncate_draft(tplan, local, 1),
                  f"{SPEC_DRAFT_BITS}-bit RTN draft": (tplan, rtn_local)}
        for label, draft in drafts.items():
            with counted_collectives() as comm:
                stats, outputs, eng = spec_serve(
                    f"phase 13 (g) rank {rank} {label}", lambda: PagedServingEngine(
                        tplan, local, **TP_PAGED, n_pages=pool,
                        spec=SpecConfig(*draft, gamma=SPEC_GAMMA), device=dev),
                    prompts, TP_NEW, SPEC_GAMMA)
            parted, compared = spec_agree(*plain, outputs, SERVE_LOGIT_TOL)
            check(not parted, f"phase 13 (g) rank {rank} {label}: the speculative stream parts "
                              f"from (c)'s above the margin at {parted}")
            stats.pop("rejection_margins")
            out["spec"][label] = dict(
                stats=stats, outputs=outputs, comm=comm, parted=parted, compared=compared,
                counters=(eng.n_decode_steps, eng.n_spec_rounds, eng.n_draft_tokens,
                          eng.n_draft_accepted, eng.spec_mgr.n_propose_calls),
                requests={r.rid: (r.n_spec_rounds, r.n_draft_tokens, r.n_draft_accepted)
                          for r in eng.finished})
            del eng
        skewed = lambda: time.monotonic() + 1e3
        out["slo"] = _tp_slo_run(local, tplan, prompts, plain, TP_SLO,
                                 _Ticks(TP_SLO_TICK_S) if rank == 0 else skewed, dev)
        out["slo_live"] = _tp_slo_run(local, tplan, prompts, plain, TP_SLO_LIVE,
                                      time.monotonic if rank == 0 else skewed, dev)
    out["counts"] = ops.launch_counts()
    variants = {v: n - variants0[v] for v, n in dequant_matmul_cuda.launches_by_variant.items()}
    out["variants"] = variants
    out["checked"] = family_checks("tensor-parallel (g)", calls, variants, phase="phase 13 (g)")
    del calls, rtn_local
    out["seconds"] = time.monotonic() - t_start
    return out


def _tp_slo_run(local, tplan, prompts, plain, waves, clock, dev) -> dict:
    """Phase 13 (g)'s SLO run on the rank: ``waves`` of requests (rid:
    (c)'s prompt, new tokens, deadline ms or None, priority) on a pool of
    TP_SLO_PAGES pages, the engine on ``clock``, each wave run to the end.
    Returns every request's record, the counters, the free pages, the
    collectives, the agreed clock's readings and broadcasts, the wall time
    and where a stream parts from (c)'s ``plain`` under the margin rule."""
    import torch

    from repro_torch.serve import PagedServingEngine, Request

    eng = PagedServingEngine(tplan, local, **TP_PAGED, n_pages=TP_SLO_PAGES, clock=clock,
                             device=dev)
    reqs, t0 = [], time.monotonic()
    with counted_collectives() as comm:
        for wave in waves:
            for rid, (i, n_new, deadline, prio) in wave.items():
                req = Request(rid=rid, prompt=prompts[i], max_new_tokens=n_new,
                              deadline_ms=deadline, priority=prio)
                eng.submit(req)
                reqs.append(req)
            eng.run()
        torch.cuda.synchronize()
    return dict(
        requests={r.rid: (r.status, r.output, r.error, r.n_preemptions, r.submit_t,
                          r.finish_t) for r in reqs},
        counters=(eng.n_shed, eng.n_deadline_missed, eng.n_preemptions, eng.n_decode_steps),
        free=(eng.pool.n_free, eng.n_pages - 1), comm=comm, reads=eng.clock.n_reads,
        broadcasts=eng.clock.n_broadcasts, wall_s=time.monotonic() - t0,
        parted=_prefix_agree(*plain, {r.rid: r.output for r in reqs if r.output and
                                      r.rid in plain[1]}, SERVE_LOGIT_TOL)[0])


def tokens_under_margin(trace: dict, outputs: dict, got: dict) -> tuple:
    """The margin rule of phase 13's serving checks: per request, the
    ranks' tokens ``got`` against the one-rank run's ``outputs`` while that
    run's top-2 margin (``trace``, its logits a step) stays at or above
    TP_LOGIT_RTOL of max |logit|.  Returns ``(tokens compared, [(request,
    step) where a token parted])``."""
    import numpy as np

    compared, parted = 0, []
    for rid, steps in trace.items():
        for j, logits in enumerate(steps):
            top2 = np.sort(logits)[-2:]
            if top2[1] - top2[0] < TP_LOGIT_RTOL * np.abs(logits).max():
                break
            compared += 1
            if got[rid][j] != outputs[rid][j]:
                parted.append((rid, j))
                break
    return compared, parted


def tp_against_one_rank(dev, detail, plan, served, ranks) -> None:
    """Phase 13 (c) in the parent: the whole artifact on one rank with the
    ranks' requests, each KV dtype; the ranks' tokens the same, their first
    decode step's logits within TP_LOGIT_RTOL of max |logit| of the one-rank
    run's, and their tokens equal to its up to its first top-2 margin below
    that bound; every rank's storage its shard."""
    import numpy as np

    from repro_torch.serve import PagedServingEngine

    cfg = plan.cfg
    prompts = family_prompts(cfg.vocab, TP_PROMPTS, TP_PROMPT_LO, TP_PROMPT_HI)
    out = {}
    for r, row in enumerate(ranks):
        tp = row["tp"]
        check(not tp["bytes_bad"], f"rank {r} holds other bytes than its shard: {tp['bytes_bad'][:4]}")
        print(f"[tp] rank {r}: holds {tp['bytes_held'] / 2**20:.1f} MiB of the whole artifact's "
              f"{tp['bytes_whole'] / 2**20:.1f} MiB, every leaf its shard ({TP_RANKS} ranks: "
              f"sharded leaves 1/{TP_RANKS}, replicated ones whole); kv slots "
              f"{tp['kv_slots']} of {plan.heads.kv_pad}; launches {tp['counts']}, kernel 3 by "
              f"variant {tp['variants']}; " + "; ".join(
                  f"{k} {n} calls {b / 2**20:.2f} MiB {t:.3f}s" for k, (n, b, t) in tp["comm"].items())
              + f"; checked {tp['checked']}", flush=True)
    for kv in TP_KV:
        kplan = dataclasses.replace(plan, kv_cache_dtype=kv)
        stats, outputs, eng = serve_run(f"phase 13 (c) one rank {kv}", lambda: PagedServingEngine(
            kplan, served, **TP_PAGED, record_logits=True, device=dev), prompts, TP_NEW)
        trace = eng.logit_trace
        del eng
        runs = [row["tp"]["runs"][kv] for row in ranks]
        check(all(r["outputs"] == runs[0]["outputs"] for r in runs), f"{kv}: the ranks' tokens differ")
        tp = runs[0]
        rel = max(float(np.abs(tp["first"][rid] - trace[rid][0]).max() / np.abs(trace[rid][0]).max())
                  for rid in trace)
        compared, parted = tokens_under_margin(trace, outputs, tp["outputs"])
        ms = [r["stats"]["ms_per_step"] for r in runs]
        print(f"[tp] {kv} KV: first-decode logits within {rel:.3g} of max |logit| of the one-rank "
              f"run (bound {TP_LOGIT_RTOL}); {compared} of {TP_PROMPTS * TP_NEW} tokens compared "
              f"before a top-2 margin under the bound, {len(parted)} parting {parted[:4]}; decode "
              f"{', '.join(f'{x:.2f}' for x in ms)} ms/step on the ranks against "
              f"{stats['ms_per_step']:.2f} on one rank (two ranks share one card and move "
              f"activations through gloo on the host: no speed-up can show); the agreed clock's "
              f"readings and broadcasts {tp['clock'][0]}, {tp['clock'][1]} over "
              f"{tp['stats']['decode_steps']} decode steps and {tp['stats']['prefill_chunks']} "
              f"prefill chunks", flush=True)
        check(rel <= TP_LOGIT_RTOL, f"{kv}: tensor-parallel first-decode logits off the one-rank run's")
        check(not parted, f"{kv}: tensor-parallel tokens part from the one-rank run's above the margin")
        out[kv] = dict(first_decode_rel=rel, tokens_compared=compared, parted=parted,
                       ms_per_step_ranks=ms, ms_per_step_one=stats["ms_per_step"],
                       clock=tp["clock"],
                       stats_ranks=[r["stats"] for r in runs], stats_one=stats)
    detail["sharded"]["tp"] = dict(
        runs=out, launches=[r["tp"]["counts"] for r in ranks], comm=[r["tp"]["comm"] for r in ranks],
        variants=[r["tp"]["variants"] for r in ranks], checked=[r["tp"]["checked"] for r in ranks],
        bytes_held=[r["tp"]["bytes_held"] for r in ranks], bytes_whole=ranks[0]["tp"]["bytes_whole"])


def _tp_slo_checks(slo, lead_clock, label) -> dict:
    """Both ranks' SLO runs alike in every request, counter, free page and
    clock count, every broadcast one ``broadcast_from``, fewer broadcasts
    than readings, no stream parting from (c)'s and the pool full again;
    prints a ``[tp-slo]`` line a rank and returns the statuses."""
    for key in ("requests", "counters", "free", "reads", "broadcasts"):
        check(all(x[key] == slo[0][key] for x in slo), f"phase 13 (g) {label}: the ranks' {key} differ")
    reqs, (n_shed, n_missed, n_pre, steps) = slo[0]["requests"], slo[0]["counters"]
    status = {rid: r[0] for rid, r in reqs.items()}
    for r, x in enumerate(slo):
        comm = x["comm"]
        clock = lead_clock if r == 0 else "time.monotonic() + 1e3"
        print(f"[tp-slo] {label} rank {r} ({clock}): statuses {status}; shed {n_shed}, deadline "
              f"missed {n_missed}, preemptions {n_pre}; {steps} decode steps; free pages "
              f"{x['free'][0]} of {x['free'][1]}; {x['reads']} clock readings in "
              f"{x['broadcasts']} broadcasts, " + ", ".join(
                  f"{k} {n} calls {t:.3f}s" for k, (n, b, t) in comm.items())
              + f"; wall {x['wall_s']:.2f}s; margin rule against (c): parted at {x['parted']}",
              flush=True)
        check(comm["broadcast"][0] == x["broadcasts"] < x["reads"],
              f"{label} rank {r}: {comm['broadcast'][0]} broadcasts for the clock's "
              f"{x['broadcasts']}, {x['reads']} readings")
        check(not x["parted"], f"phase 13 (g) {label} rank {r}: tokens part from (c)'s above the "
                               f"margin at {x['parted']}")
    check(slo[0]["free"][0] == slo[0]["free"][1], f"phase 13 (g) {label}: pages leaked {slo[0]['free']}")
    return status


def tp_spec_checks(detail, ranks) -> None:
    """Phase 13 (g) in the parent: both ranks' speculative runs and SLO run
    the same in every output, request and counter; the virtual-clock SLO
    run's decisions (request 4 expired mid-generation, request 8 shed as
    provably unmeetable, a preemption); the SLO run on rank 0's real time
    alike on both ranks; in both, the agreed clock's readings in fewer
    broadcasts than readings; the ranks' kernel launches of (g)."""
    spec = [r["tp"]["spec"] for r in ranks]
    s0 = spec[0]
    for label, run in s0["spec"].items():
        for key in ("outputs", "counters", "requests"):
            check(all(sp["spec"][label][key] == run[key] for sp in spec),
                  f"phase 13 (g) {label}: the ranks' {key} differ")
        for r, sp in enumerate(spec):
            st, comm = sp["spec"][label]["stats"], sp["spec"][label]["comm"]
            rounds = st["decode_steps"]
            acc = "-" if st["acceptance"] is None else f"{st['acceptance']:.3f}"
            print(f"[tp-spec] rank {r} {label}: {st['tokens']} tokens, decode "
                  f"{st['decode_tok_s']:.1f} tok/s, {st['ms_per_round']:.2f} ms a round over "
                  f"{rounds} rounds ({st['spec_rounds']} speculative; propose "
                  f"{st['propose_s']:.2f}s of {st['decode_s']:.2f}s) against (c)'s plain "
                  f"{sp['plain_ms']:.2f} ms a step; proposed {st['proposed']}, accepted "
                  f"{st['accepted']} (acceptance {acc}); free pages {st['free_before']} -> "
                  f"{st['free_after']}; rounds with budget {st['rounds_with_budget']}, short "
                  f"{len(st['short_rounds'])}; collectives a round: " + ", ".join(
                      f"{k} {n / rounds:.1f} ({b / rounds / 2**10:.1f} KiB, "
                      f"{t / rounds * 1e3:.2f} ms)" for k, (n, b, t) in comm.items())
                  + f"; margin rule against (c): {sp['spec'][label]['compared']} tokens "
                  f"compared, parted at {sp['spec'][label]['parted']}", flush=True)
    slo = [sp["slo"] for sp in spec]
    status = _tp_slo_checks(slo, f"a virtual clock, {TP_SLO_TICK_S} s a reading", "SLO")
    reqs, n_pre = slo[0]["requests"], slo[0]["counters"][2]
    check(status[4] == "deadline_missed" and 0 < len(reqs[4][1]) < TP_SLO[0][4][1],
          f"phase 13 (g) SLO: request 4 {status[4]} with {len(reqs[4][1])} tokens")
    check(status[8] == "shed" and "provably unmeetable" in (reqs[8][2] or ""),
          f"phase 13 (g) SLO: request 8 {status[8]} ({reqs[8][2]})")
    check(n_pre >= 1 and "preempted_resumed" in status.values(),
          f"phase 13 (g) SLO: {n_pre} preemptions")
    check(all(st in ("completed", "preempted_resumed") for rid, st in status.items()
              if rid not in (4, 8)), f"phase 13 (g) SLO: statuses {status}")
    live = [sp["slo_live"] for sp in spec]
    live_status = _tp_slo_checks(live, "time.monotonic()", "SLO on the card's time")
    for r, sp in enumerate(spec):
        print(f"[tp-spec] rank {r}: (g) took {sp['seconds']:.1f}s; launches {sp['counts']}, kernel "
              f"3 by variant {sp['variants']}; RTN draft layout {sp['rtn_layout']}; checked "
              f"{sp['checked']}", flush=True)
        for name in ("dequant_matmul", "paged_attention"):
            check(sp["counts"][name] > 0, f"rank {r}: (g) launched no {name}")
    detail["sharded"]["tp_spec"] = dict(
        spec={label: dict(stats=[sp["spec"][label]["stats"] for sp in spec],
                          comm=[sp["spec"][label]["comm"] for sp in spec],
                          compared=run["compared"], counters=run["counters"])
              for label, run in s0["spec"].items()},
        slo=dict(status=status, counters=slo[0]["counters"], comm=[x["comm"] for x in slo],
                 reads=slo[0]["reads"], broadcasts=slo[0]["broadcasts"],
                 wall_s=[x["wall_s"] for x in slo]),
        slo_live=dict(status=live_status, counters=live[0]["counters"],
                      comm=[x["comm"] for x in live], reads=live[0]["reads"],
                      broadcasts=live[0]["broadcasts"], wall_s=[x["wall_s"] for x in live]),
        launches=[sp["counts"] for sp in spec], checked=[sp["checked"] for sp in spec],
        seconds=[sp["seconds"] for sp in spec], plain_ms=[sp["plain_ms"] for sp in spec])


def tp_save(keep: dict, name: str, label: str, cfg, artifact) -> None:
    """Phase 13 (d)'s or (f)'s input from phase 10 (a), 11 (b)(ii) or 12:
    the served artifact and its config (and for (f) the batch and the run's
    settings in ``keep[name]``), moved to the CPU and saved under
    ``keep["dir"]``, whose path goes into ``keep[name]``."""
    import torch

    t0 = time.monotonic()
    path = os.path.join(keep["dir"], f"{name}.pt")
    extra = {k: keep[name][k] for k in ("batch", "n_new", "cap") if k in keep[name]}
    torch.save({"cfg": cfg, "params": tree_to(artifact, "cpu"), **extra}, path)
    keep[name].update(path=path, label=label)
    print(f"[tp] {label}: artifact saved for phase 13, {os.path.getsize(path) / 2**30:.2f} GiB "
          f"in {time.monotonic() - t0:.1f}s", flush=True)


@contextlib.contextmanager
def first_decode_routes(prompts):
    """While open, each request's first decode step as both engines run it
    (the prompt's last token replayed at position len - 1): per MoE layer,
    its router's top-k expert ids and the gap between the k-th and the
    (k+1)-th probability, ``{rid: [(ids, gap), ...]}``; and kernel 3's
    launches in each decode step, in a list.  Yields both."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.serve import engine as E

    keys = {(len(p) - 1, int(p[-1])): rid for rid, p in enumerate(prompts)}
    check(len(keys) == len(prompts), "two prompts end alike: their first decodes look the same")
    routes, layers, per_step = {}, [], []
    route = moe._route

    def routed(router, xf, top_k, norm_topk):
        out = route(router, xf, top_k, norm_topk)
        layers.append((out[0], out[2], top_k))
        return out

    def first_decodes(fn):
        def call(plan, params, tokens, cache, pos, *a, **k):
            layers.clear()
            k3 = ops.launch_counts()["dequant_matmul"]
            out = fn(plan, params, tokens, cache, pos, *a, **k)
            per_step.append(ops.launch_counts()["dequant_matmul"] - k3)
            toks, at = np.asarray(tokens).reshape(-1), np.asarray(pos).reshape(-1)
            for b in range(len(toks)):
                rid = keys.get((int(at[b]), int(toks[b])))
                if rid is None or rid in routes:
                    continue
                row = []
                for probs, ids, top_k in layers:
                    srt = torch.sort(probs[b], descending=True).values
                    row.append((ids[b].cpu().numpy(), float(srt[top_k - 1] - srt[top_k])))
                routes[rid] = row
            return out
        return call

    originals = E.decode_step, E.paged_decode_step, moe._route
    E.decode_step, E.paged_decode_step = first_decodes(E.decode_step), first_decodes(E.paged_decode_step)
    moe._route = routed
    try:
        yield routes, per_step
    finally:
        E.decode_step, E.paged_decode_step, moe._route = originals


def tp_load_shard(path: str, world: int, dev, part: str) -> tuple:
    """A saved artifact (:func:`tp_save`) loaded on the CPU (memory-mapped)
    and this rank's shard of it (``shard_tree`` under ``serving_rules`` of
    a ("model",) axis of ``world``, the artifact's own axes) alone moved to
    the card, held leaf by leaf against 1/world of each sharded leaf; the
    axis must pad nothing.  Returns ``(cfg, plan, rules, local params, the
    saved batch or None, {bytes_bad, bytes_held, bytes_whole, t_load})``."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.sharding import shard_tree
    from repro_torch.models import model as M
    from repro_torch.serve.qparams import qt_param_axes, serving_rules

    t0 = time.monotonic()
    saved = torch.load(path, map_location="cpu", mmap=True, weights_only=False)
    cfg, whole = saved["cfg"], saved["params"]
    tplan = M.make_plan(cfg, world)
    check(tplan.heads.kv_pad == M.make_plan(cfg).heads.kv_pad and tplan.vocab_pad == cfg.vocab,
          f"phase 13 {part} {cfg.name}: the axis pads the plan")
    mesh = DeviceMesh(dev.type, torch.arange(world), mesh_dim_names=("model",))
    rules = serving_rules(tplan, mesh)
    axes = qt_param_axes(tplan, whole)
    local = tree_to(shard_tree(whole, axes, rules), dev)
    torch.cuda.synchronize()
    t_load = time.monotonic() - t0
    bad, held, total = tp_shard_bytes(whole, local, axes, rules, world)
    batch = saved.get("batch")
    del saved, whole
    gc.collect()
    return cfg, tplan, rules, local, batch, dict(bytes_bad=bad, bytes_held=held,
                                                 bytes_whole=total, t_load=t_load)


def tp_family_rank(rank, world, spec, dev) -> dict:
    """Phase 13 (d) on one rank, one family: the rank's shard of the
    artifact ``spec["path"]`` (:func:`tp_load_shard`); then ``spec``'s requests on its engine (phase 10's paged
    or phase 11's contiguous settings) inside the axis' rules, logits
    recorded, kernel 5 launched once a decode step and attention layer on
    the paged engine; then every kernel-3 and kernel-5 signature of the run
    once against its plain version.  Returns the outputs, the first decode
    step's logits and routes, the launches (kernel 3 by variant and a
    decode step), the collectives, the step times and the peak device
    memory."""
    import numpy as np
    import torch

    from repro_torch.dist.sharding import axis_rules
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.serve import PagedServingEngine, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    cfg, tplan, rules, local, _, shard = tp_load_shard(spec["path"], world, dev, "(d)")
    if spec["engine"] == "paged":
        make = lambda: PagedServingEngine(tplan, local, **FAM_PAGED, record_logits=True, device=dev)
    else:
        make = lambda: ServingEngine(tplan, local, **SSM_CONTIG, record_logits=True, device=dev)
    ops.reset_launch_counts()
    variants0 = dict(dequant_matmul_cuda.launches_by_variant)
    with recording_calls() as calls, axis_rules(rules), counted_collectives() as comm, \
            first_decode_routes(spec["prompts"]) as (routes, per_step):
        stats, outputs, eng = serve_run(f"phase 13 (d) {cfg.name} rank {rank}", make,
                                        spec["prompts"], spec["new"])
        n_decode, trace = eng.n_decode_steps, eng.logit_trace
        del eng
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    variants = {v: n - variants0[v] for v, n in dequant_matmul_cuda.launches_by_variant.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_attn = sum(b.kind == "attn" for b in cfg.pattern) * cfg.n_periods
    if spec["engine"] == "paged":
        check(counts["paged_attention"] == n_decode * n_attn,
              f"phase 13 (d) {cfg.name}: kernel 5 launched {counts['paged_attention']}, expected "
              f"{n_decode} x {n_attn}")
    check(stats["statuses"] == ["completed"], f"phase 13 (d) {cfg.name}: {stats['statuses']}")
    del local
    _free()
    checked = family_checks(f"tensor-parallel {cfg.name}", calls, variants, phase="phase 13 (d)")
    del calls
    _free()
    return dict(outputs=outputs, first={rid: t[0] for rid, t in trace.items()}, routes=routes,
                stats=stats, counts=counts, variants=variants,
                kernel3_per_step=float(np.median(per_step)), comm=comm, checked=checked,
                peak_gib=peak, **shard,
                layouts={k: rules.table[k] for k in ("heads", "kv_heads", "head_dim", "ffn",
                                                      "experts", "expert_ffn", "ssm_heads",
                                                      "ssm_fused", "vocab")})


def tp_families(detail, ranks: "Ranks", keep: dict) -> tuple:
    """Phase 13 (d) in the parent: the ranks get the saved artifacts and the
    requests of TP_FAMILIES, serve them (:func:`tp_family_rank`) and stop.
    Per family: every rank's storage its shard; the ranks' tokens and router
    ids the same; their first-decode logits within TP_LOGIT_RTOL of max
    |logit| of the one-rank baseline's (phase 10 (a)'s or 11 (b)(ii)'s run),
    a lane past it allowed only at a router crossing (a top-k boundary
    whose one-rank probability gap is under TP_ROUTER_GAP, where the ranks'
    top-k ids part from the one-rank run's; each printed); their tokens
    equal to its up to its first top-2 margin below that bound.  The ranks
    stay up for (e) (:func:`tp_train`).  Returns the kernels' launches
    (both ranks) and the calls checked."""
    import numpy as np

    msg = {name: {k: keep[name][k] for k in ("path", "engine", "prompts", "new")}
           for name in TP_FAMILIES}
    t0 = time.monotonic()
    ranks.send(("families", msg))
    got = ranks.collect(timeout=TP_WAIT_S)
    print(f"[tp] (d) the ranks' loads, runs and checks: {time.monotonic() - t0:.1f}s", flush=True)
    counts, checked, out = {}, {}, {}
    for name in TP_FAMILIES:
        base, rows = keep[name], [g[name] for g in got]
        label = base["label"]
        for r, row in enumerate(rows):
            check(not row["bytes_bad"],
                  f"(d) {label}: rank {r} holds other bytes than its shard: {row['bytes_bad'][:4]}")
            print(f"[tp] (d) {label} rank {r}: holds {row['bytes_held'] / 2**30:.3f} GiB of the whole "
                  f"artifact's {row['bytes_whole'] / 2**30:.3f} GiB "
                  f"({row['bytes_held'] / row['bytes_whole']:.1%}), every leaf its shard; layouts "
                  f"{row['layouts']}; loaded and moved in {row['t_load']:.1f}s; peak device memory "
                  f"{row['peak_gib']:.2f} GiB; launches {row['counts']}; kernel 3 by variant "
                  f"{row['variants']}, {row['kernel3_per_step']:g} a decode step against "
                  f"{float(np.median(base['kernel3_per_step'])):g} on one rank; " + "; ".join(
                      f"{k} {n} calls {b / 2**20:.2f} MiB {t:.3f}s"
                      for k, (n, b, t) in row["comm"].items())
                  + f"; checked {row['checked']}", flush=True)
            for k, v in row["counts"].items():
                counts[k] = counts.get(k, 0) + v
            merge_checked(checked, row["checked"])
        r0 = rows[0]
        check(all(r["outputs"] == r0["outputs"] for r in rows), f"(d) {label}: the ranks' tokens differ")
        check(all(sorted(r["routes"]) == sorted(r0["routes"])
                  and all(np.array_equal(a, b) for rid in r0["routes"]
                          for (a, _), (b, _) in zip(r["routes"][rid], r0["routes"][rid]))
                  for r in rows), f"(d) {label}: the ranks' router ids differ")
        trace, outputs, one_routes = base["trace"], base["outputs"], base["routes"]
        check(sorted(one_routes) == sorted(trace) == sorted(r0["routes"]),
              f"(d) {label}: a request's first decode went unrecorded")
        lanes = {rid: float(np.abs(r0["first"][rid] - trace[rid][0]).max()
                            / np.abs(trace[rid][0]).max()) for rid in trace}
        crossed, unexplained = {}, []
        for rid, rel in sorted(lanes.items()):
            if rel <= TP_LOGIT_RTOL:
                continue
            cross = [(i, sorted(a.tolist()), sorted(b.tolist()), gap)
                     for i, ((a, gap), (b, _)) in enumerate(zip(one_routes[rid], r0["routes"][rid]))
                     if set(a.tolist()) != set(b.tolist()) and gap < TP_ROUTER_GAP]
            if not cross:
                unexplained.append((rid, rel))
                continue
            crossed[rid] = dict(rel=rel, crossings=cross)
            for i, a, b, gap in cross:
                print(f"[tp] (d) {label} lane {rid}: first-decode logits {rel:.3g} of max |logit| off "
                      f"the one-rank run's (past {TP_LOGIT_RTOL}) at a router crossing: MoE layer "
                      f"{i}, one rank's top-k {a}, the ranks' {b}, one-rank gap {gap:.3g} (under "
                      f"{TP_ROUTER_GAP})", flush=True)
        compared, parted = tokens_under_margin(trace, outputs, r0["outputs"])
        n_tok = sum(len(o) for o in outputs.values())
        ms = [r["stats"]["ms_per_step"] for r in rows]
        within = max((v for rid, v in lanes.items() if rid not in crossed), default=0.0)
        print(f"[tp] (d) {label}: first-decode logits within {within:.3g} of max |logit| of the "
              f"one-rank run (bound {TP_LOGIT_RTOL}) on {len(lanes) - len(crossed)} of {len(lanes)} "
              f"lanes, {len(crossed)} at router crossings, {len(unexplained)} unexplained "
              f"{unexplained[:4]}; {compared} of {n_tok} tokens compared before a top-2 margin under "
              f"the bound, {len(parted)} parting {parted[:4]}; decode "
              f"{', '.join(f'{x:.2f}' for x in ms)} ms/step on the ranks against "
              f"{base['stats']['ms_per_step']:.2f} on one rank (two ranks share one card and move "
              f"activations through gloo on the host: no speed-up can show)", flush=True)
        check(not unexplained, f"(d) {label}: first-decode logits off the one-rank run's "
              f"without a router crossing: {unexplained[:8]}")
        check(not parted, f"(d) {label}: tensor-parallel tokens part from the one-rank run's above "
              f"the margin: {parted[:8]}")
        out[name] = dict(label=label, lanes=lanes, crossed=crossed, tokens_compared=compared,
                         parted=parted, ms_per_step_ranks=ms,
                         ms_per_step_one=base["stats"]["ms_per_step"],
                         kernel3_per_step_ranks=[r["kernel3_per_step"] for r in rows],
                         kernel3_per_step_one=float(np.median(base["kernel3_per_step"])),
                         launches=[r["counts"] for r in rows], variants=[r["variants"] for r in rows],
                         comm=[r["comm"] for r in rows], checked=[r["checked"] for r in rows],
                         bytes_held=[r["bytes_held"] for r in rows], bytes_whole=r0["bytes_whole"],
                         load_seconds=[r["t_load"] for r in rows],
                         peak_gib=[r["peak_gib"] for r in rows], layouts=r0["layouts"])
    detail.setdefault("sharded", {})["tp_families"] = out
    return counts, checked


def tp_encdec_rank(rank, world, spec, dev) -> dict:
    """Phase 13 (f) (i) on one rank, one model of TP_ENCDEC: the rank's
    shard of phase 12's artifact ``spec["path"]`` (:func:`tp_load_shard`;
    Whisper's encoder quantized); then phase 12's batch
    prefilled and decoded greedily (:func:`greedy_decode`, logits recorded)
    inside the axis' rules, the collectives of its first decode step
    counted; then every kernel-3 signature of the run once against its
    plain version.  Returns the outputs, the logit trace, the launches
    (kernel 3 by variant and a decode step), the collectives, the step
    times and the peak device memory."""
    import torch

    from repro_torch.dist.sharding import axis_rules
    from repro_torch.kernels import ops
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
    from repro_torch.models import model as M

    torch.cuda.reset_peak_memory_stats()
    cfg, tplan, rules, local, batch, shard = tp_load_shard(spec["path"], world, dev, "(f)")
    enc_quantized = "enc" in local and any(
        not isinstance(v, torch.Tensor) for blk in local["enc"].values() for v in blk.values())
    ops.reset_launch_counts()
    variants0 = dict(dequant_matmul_cuda.launches_by_variant)
    keep, step_comm = {}, {}
    decode = M.decode_step

    def first_decode(*a, **k):
        before = {kind: row[0] for kind, row in comm.items()}
        out = decode(*a, **k)
        step_comm.setdefault("calls", {kind: row[0] - before[kind] for kind, row in comm.items()})
        return out

    M.decode_step = first_decode
    try:
        with recording_calls() as calls, axis_rules(rules), counted_collectives() as comm:
            stats, _ = greedy_decode(f"{cfg.name} rank {rank} of a \"model\" axis of {world}",
                                     tplan, local, batch, spec["n_new"], spec["cap"], dev,
                                     keep=keep)
            torch.cuda.synchronize()
            cross = [leaves["ck"][0] for leaves in M.cache_shapes(tplan, len(batch["tokens"]),
                                                                  spec["cap"]).values()
                     if "ck" in leaves]
    finally:
        M.decode_step = decode
    counts = ops.launch_counts()
    variants = {v: n - variants0[v] for v, n in dequant_matmul_cuda.launches_by_variant.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    del local
    _free()
    checked = family_checks(f"tensor-parallel {cfg.name}", calls, variants, phase="phase 13 (f)")
    del calls
    _free()
    return dict(outputs=keep["outputs"], trace=keep["trace"], stats=stats, counts=counts,
                variants=variants, comm=comm, decode_comm=step_comm["calls"], checked=checked,
                peak_gib=peak, **shard, enc_quantized=enc_quantized, cross_cache=[tuple(c) for c in cross],
                layouts={k: rules.table[k] for k in ("heads", "kv_heads", "head_dim", "ffn",
                                                      "heads_fused", "kv_fused", "vocab")})


def tp_encdec(detail, ranks: "Ranks", keep: dict) -> tuple:
    """Phase 13 (f) (i) in the parent: the ranks get phase 12's saved
    artifacts and serve them (:func:`tp_encdec_rank`).  Per model: every
    rank's storage its shard; the ranks' tokens the same; their first
    decode step's logits within TP_LOGIT_RTOL of max |logit| of phase 12's
    one-rank run's, and their tokens equal to its up to its first top-2
    margin under that bound; one decode step's collectives: the
    embedding's all-reduce, one a layer for ``wo``, ``wo_c`` (Whisper) and
    ``wd``, and the logits' gather; kernel 3 launched on prefill
    (``tc_large``) and decode (``tc_small``) shapes.  The ranks stay up.
    Returns the kernels' launches (both ranks) and the calls checked."""
    import numpy as np

    msg = {name: {k: keep[name][k] for k in ("path", "n_new", "cap")} for name in TP_ENCDEC}
    t0 = time.monotonic()
    ranks.send(("encdec", msg))
    got = ranks.collect(timeout=TP_WAIT_S)
    print(f"[tp] (f) the ranks' loads, runs and checks: {time.monotonic() - t0:.1f}s", flush=True)
    counts, checked, out = {}, {}, {}
    for name in TP_ENCDEC:
        base, rows = keep[name], [g[name] for g in got]
        label = base["label"]
        cfg = encdec_cfg(name)
        layers = cfg.n_periods * len(cfg.pattern)
        cross = int(any(b.cross for b in cfg.pattern))
        # No engine runs a greedy decode step, so it reads no agreed clock.
        want_comm = {"all_reduce": 1 + layers * (2 + cross), "all_gather": 1, "broadcast": 0}
        for r, row in enumerate(rows):
            check(not row["bytes_bad"],
                  f"(f) {label}: rank {r} holds other bytes than its shard: {row['bytes_bad'][:4]}")
            print(f"[tp] (f) {label} rank {r}: holds {row['bytes_held'] / 2**30:.3f} GiB of the whole "
                  f"artifact's {row['bytes_whole'] / 2**30:.3f} GiB "
                  f"({row['bytes_held'] / row['bytes_whole']:.1%}), every leaf its shard (encoder "
                  f"quantized: {row['enc_quantized']}); layouts {row['layouts']}; cross caches "
                  f"{row['cross_cache']} a rank; loaded and moved in {row['t_load']:.1f}s; peak "
                  f"device memory {row['peak_gib']:.2f} GiB; launches {row['counts']}; kernel 3 by "
                  f"variant {row['variants']}, {row['stats']['kernel3_per_step']:g} a decode step "
                  f"against {base['stats']['kernel3_per_step']:g} on one rank; one decode step's "
                  f"collectives {row['decode_comm']} (expected {want_comm}); " + "; ".join(
                      f"{k} {n} calls {b / 2**20:.2f} MiB {t:.3f}s"
                      for k, (n, b, t) in row["comm"].items())
                  + f"; checked {row['checked']}", flush=True)
            check(row["decode_comm"] == want_comm,
                  f"(f) {label}: rank {r}'s decode step ran {row['decode_comm']}, expected {want_comm}")
            check(row["variants"]["tc_large"] > 0 and row["variants"]["tc_small"] > 0
                  and row["variants"]["simt"] == 0 and row["checked"]["dequant_matmul"]["calls"] > 0,
                  f"(f) {label}: rank {r}: kernel 3 by variant {row['variants']}, checked "
                  f"{row['checked']}")
            for k, v in row["counts"].items():
                counts[k] = counts.get(k, 0) + v
            merge_checked(checked, row["checked"])
        r0 = rows[0]
        check(all(r["outputs"] == r0["outputs"] for r in rows), f"(f) {label}: the ranks' tokens differ")
        trace, outputs = base["trace"], base["outputs"]
        lanes = {b: float(np.abs(r0["trace"][b][0] - trace[b][0]).max() / np.abs(trace[b][0]).max())
                 for b in trace}
        compared, parted = tokens_under_margin(trace, outputs, r0["outputs"])
        n_tok = sum(len(o) for o in outputs.values())
        ms = [r["stats"]["ms_per_step"] for r in rows]
        prefill = ", ".join(f"{r['stats']['prefill_s']:.2f}" for r in rows)
        rel = max(lanes.values())
        print(f"[tp] (f) {label}: first-decode logits within {rel:.3g} of max |logit| of the one-rank "
              f"run (bound {TP_LOGIT_RTOL}) on {len(lanes)} lanes; {compared} of {n_tok} tokens "
              f"compared before a top-2 margin under the bound, {len(parted)} parting {parted[:4]}; "
              f"prefill {prefill}s on the ranks "
              f"against {base['stats']['prefill_s']:.2f}s; decode {', '.join(f'{x:.2f}' for x in ms)} "
              f"ms/step on the ranks against {base['stats']['ms_per_step']:.2f} on one rank (two "
              f"ranks share one card and move activations through gloo on the host: no speed-up "
              f"can show)", flush=True)
        check(rel <= TP_LOGIT_RTOL, f"(f) {label}: first-decode logits off the one-rank run's: "
              f"{sorted(lanes.items())}")
        check(not parted, f"(f) {label}: tensor-parallel tokens part from the one-rank run's above "
              f"the margin: {parted[:8]}")
        out[name] = dict(label=label, lanes=lanes, tokens_compared=compared, parted=parted,
                         ms_per_step_ranks=ms, ms_per_step_one=base["stats"]["ms_per_step"],
                         prefill_s_ranks=[r["stats"]["prefill_s"] for r in rows],
                         prefill_s_one=base["stats"]["prefill_s"],
                         kernel3_per_step_ranks=[r["stats"]["kernel3_per_step"] for r in rows],
                         kernel3_per_step_one=base["stats"]["kernel3_per_step"],
                         launches=[r["counts"] for r in rows], variants=[r["variants"] for r in rows],
                         comm=[r["comm"] for r in rows], decode_comm=[r["decode_comm"] for r in rows],
                         checked=[r["checked"] for r in rows],
                         bytes_held=[r["bytes_held"] for r in rows], bytes_whole=r0["bytes_whole"],
                         load_seconds=[r["t_load"] for r in rows],
                         peak_gib=[r["peak_gib"] for r in rows], layouts=r0["layouts"],
                         cross_cache=r0["cross_cache"])
    detail.setdefault("sharded", {})["tp_encdec"] = out
    return counts, checked


def tp_train_cfg(name: str):
    """The config of TP_TRAIN's or TP_TRAIN_F's model ``name``."""
    from repro_torch.configs import get_config

    arch, over = (TP_TRAIN.get(name) or TP_TRAIN_F[name])[:2]
    return dataclasses.replace(get_config(arch), **over)


def leaf_sums(tree) -> list:
    """Each leaf's fp64 sum: what two seeded inits must agree on."""
    from repro_torch.tree import tree_leaves

    return [float(t.double().sum()) for t in tree_leaves(tree)]


def whole_leaves_digest(params, shards) -> str:
    """The digest of the leaves a rank holds whole on "model"."""
    from repro_torch.tree import tree_leaves

    return _tree_bytes([t for t, d in zip(tree_leaves(params), shards.model_dims) if d is None])


def _train_settings(ckpt_dir: str, name: str):
    """(e)'s and (f)'s optimizer and trainer settings for model ``name``:
    TRAIN_BATCH x TRAIN_SEQ, or a TP_TRAIN_F model's own batch."""
    from repro_torch.train import AdamWConfig, TrainerConfig

    batch, seq = TP_TRAIN_F[name][2] if name in TP_TRAIN_F else (TRAIN_BATCH, TRAIN_SEQ)
    return AdamWConfig(**TRAIN_OPT), TrainerConfig(
        steps=TP_TRAIN_STEPS, batch=batch, seq=seq, ckpt_every=TP_TRAIN_STEPS + 1,
        ckpt_dir=ckpt_dir, log_every=1)


# The leaves a unit permutation moves, by block leaf, and the dimension
# (behind the period's): attention heads (kv slots with their query groups;
# a cross-attention's too), a dense MLP's ffn units, each expert's ffn
# units, Mamba-2's SSD heads.
_UNIT_DIMS = {
    "heads": {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "bq": 1, "bk": 1, "bv": 1,
              "wq_c": 2, "wk_c": 2, "wv_c": 2, "wo_c": 1},
    "ffn": {"wg": 2, "wu": 2, "wd": 1},
    "expert_ffn": {"w_gate": 3, "w_up": 3, "w_down": 2},
    "ssm_heads": {"wz": 2, "wx": 2, "wdt": 2, "conv_x_w": 1, "conv_x_b": 1, "a_log": 1,
                  "d_skip": 1, "dt_bias": 1, "norm_scale": 1, "out_proj": 1},
}


def permute_units(params, cfg, inverse: bool = False) -> dict:
    """``params`` of the same model with each block's attention heads (its
    cross-attention's too), ffn units (dense or each expert's) and SSD heads
    in another order (numpy seed 0; ``inverse`` puts them back), in the
    decoder's and the encoder's stacks: every reduction over those units
    runs in another fp32 order, the math unchanged.  Heads move where no
    kv slot is duplicated or padded, SSD heads where one B/C group serves
    them all."""
    import numpy as np
    import torch

    from repro_torch.models import model as M

    hp = M.make_plan(cfg).heads
    moved = {"ffn", "expert_ffn"} | ({"heads"} if hp.kv_pad == hp.n_kv else set()) \
        | ({"ssm_heads"} if cfg.ssm_ngroups == 1 else set())
    rng = np.random.default_rng(0)
    out = dict(params)
    for stack in ("dec", "enc"):
        if stack not in params:
            continue
        out[stack] = {}
        for blk, leaves in params[stack].items():
            new, perms = dict(leaves), {}
            for unit in sorted(moved):
                for leaf, dim in _UNIT_DIMS[unit].items():
                    if leaf not in leaves:
                        continue
                    t = leaves[leaf]
                    if unit not in perms:
                        perms[unit] = torch.from_numpy(rng.permutation(t.shape[dim]))
                    perm = perms[unit]
                    if inverse:
                        perm = torch.argsort(perm)
                    new[leaf] = t.index_select(dim, perm.to(t.device))
            out[stack][blk] = new
    return out


def tp_train_control(name: str, dev, one: dict) -> float:
    """(e)'s noise floor for ``name``: its one-rank run again from the same
    seeded params with their units permuted (:func:`permute_units`), the
    same model with every reduction over heads and ffn units in another
    order; the distance of its params after the last step, put back, from
    the one-rank run's ``one["after"]``."""
    import shutil

    from repro_torch.models import model as M
    from repro_torch.train import Trainer

    cfg = tp_train_cfg(name)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_control_")
    try:
        opt_cfg, tcfg = _train_settings(ckpt_dir, name)
        init = permute_units(M.init_params(M.make_plan(cfg), 0, device=dev), cfg)
        tr = Trainer(cfg, opt_cfg, tcfg, params=init, device=dev)
        del init
        tr.run()
        after = permute_units(tr.params, cfg, inverse=True)
        del tr
        off, _ = update_distance(after, one["after"], one["init"], dev)
        del after
        _free()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return off


def tp_train_rank(rank, world, name, spec, dev) -> dict:
    """Phase 13 (e) on one rank, one model of TP_TRAIN: the seeded whole
    params of the padded plan on the card (their leaf sums kept), cut by
    ``Trainer(mesh=<("model",) of world>)``, which trains TP_TRAIN_STEPS
    steps; the bytes the rank holds against its shard, each step's loss,
    gradient norm, time and the digest of the leaves held whole (before
    each step and after the last), the collectives of the run, its peak
    device memory and kernel launches.  Rank 0 saves the whole params the
    ranks gather after the run under ``spec["dir"]``."""
    import shutil

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train import Trainer

    cfg = tp_train_cfg(name)
    mesh = DeviceMesh(dev.type, torch.arange(world), mesh_dim_names=("model",))
    plan = M.make_plan(cfg, world)
    shapes = lambda p: [tuple(t.shape) for t in _leaves(M.param_shapes(p))]
    check(shapes(plan) == shapes(M.make_plan(cfg)),
          f"phase 13 (e) {cfg.name}: the axis pads the plan")
    whole = M.init_params(plan, 0, device=dev)
    sums = leaf_sums(whole)
    ckpt_dir = tempfile.mkdtemp(prefix=f"chip_smoke_tp_train_{rank}_")
    try:
        opt_cfg, tcfg = _train_settings(ckpt_dir, name)
        tr = Trainer(cfg, opt_cfg, tcfg, mesh=mesh, params=whole, device=dev)
        bad, held, total = tp_shard_bytes(whole, tr.params, M.param_axes(plan), tr.rules, world)
        del whole
        _free()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        marks, peers = [], []  # (before, after) the digest of the whole-held leaves

        def stamp(step=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            peers.append(whole_leaves_digest(tr.params, tr.shards))
            marks.append((t, time.perf_counter()))

        ops.reset_launch_counts()
        with counted_collectives() as comm:
            log = tr.run(fault_hook=stamp)["log"]
            stamp()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        moments = sum(t.untyped_storage().nbytes() for t in _leaves(tr.opt_state))
        params = tr._whole(tr.params, tr.shards)
        if rank == 0:
            torch.save(tree_to(params, "cpu"), os.path.join(spec["dir"], f"tp_train_{name}.pt"))
        del params, tr
        _free()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(losses=[m["loss"] for m in log], grad_norms=[m["grad_norm"] for m in log],
                ms=[(b[0] - a[1]) * 1e3 for a, b in zip(marks, marks[1:])], peers=peers, sums=sums,
                comm=comm, peak_gib=(peak - base) / 2**30, base_gib=base / 2**30,
                bytes_bad=bad, bytes_held=held, bytes_whole=total, moments_bytes=moments,
                launches=counts)


def _leaves(tree) -> list:
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


def tp_train_one_rank(name: str, dev) -> dict:
    """(e)'s one-rank run of TP_TRAIN's model ``name`` on the card (the
    parent's, while the ranks train): each step's loss, gradient norm and
    time, the seeded params' leaf sums, and the params before the first
    step and after the last, on the CPU."""
    import shutil

    import torch

    from repro_torch.train import Trainer

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_one_")
    try:
        opt_cfg, tcfg = _train_settings(ckpt_dir, name)
        tr = Trainer(tp_train_cfg(name), opt_cfg, tcfg, device=dev)
        init, sums = tree_to(tr.params, "cpu"), leaf_sums(tr.params)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        stamps = []

        def stamp(step=None):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        log = tr.run(fault_hook=stamp)["log"]
        stamp()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        after = tree_to(tr.params, "cpu")
        del tr
        _free()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return dict(losses=[m["loss"] for m in log], grad_norms=[m["grad_norm"] for m in log],
                ms=[(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])], sums=sums, init=init,
                after=after, peak_gib=peak, base_gib=base / 2**30)


def update_distance(got, want, init, dev) -> tuple:
    """``(‖got − want‖, ‖want − init‖)`` over every leaf, in fp64 on the card."""
    import torch

    off = moved = 0.0
    for g, w, i in zip(_leaves(got), _leaves(want), _leaves(init)):
        w64 = w.to(dev, torch.float64)
        off += float(((g.to(dev, torch.float64) - w64) ** 2).sum())
        moved += float(((w64 - i.to(dev, torch.float64)) ** 2).sum())
    return math.sqrt(off), math.sqrt(moved)


def tp_train(dev, detail, ranks: "Ranks", keep: dict, one: dict, names, part: str,
             beside: bool = True) -> None:
    """Phase 13 (e) or (f) (``part``) in the parent: the ranks train each
    model of ``names`` (:func:`tp_train_rank`) while (``beside``), or after,
    the parent trains the one-rank runs of those ``one`` lacks (in (e) it
    holds phase 5b's first steps, Phi-3's) and each model's control
    (:func:`tp_train_control`).  (f) runs them after: LLaVA's one-rank run
    (its fp32 moments and a layer's attention scores at 3,392 positions)
    and the two ranks' do not fit the card together.
    Per model: the seeded params the same on both sides (leaf sums); every
    rank holding exactly its shard; the losses and gradient norms within
    TP_TRAIN_LOSS_RTOL of the one-rank run's; the ranks' losses, gradient
    norms and whole-held leaves the same bits before each step and after
    the last; the params the ranks gathered off the one-rank run's after
    the last step by at most TP_TRAIN_UPDATE_RTOL of how far that run moved
    them beyond the control's distance; no kernel launched (dense training
    runs none).  The ranks stay up."""
    import torch

    t0 = time.monotonic()
    ranks.send(("train", {"dir": keep["dir"], "names": tuple(names)}))
    got = None if beside else ranks.collect(timeout=TP_WAIT_S)
    t1 = time.monotonic()
    one = dict(one)
    for name in names:
        if name not in one:
            one[name] = tp_train_one_rank(name, dev)
        one[name]["control_off"] = tp_train_control(name, dev, one[name])
    t_one = time.monotonic() - t1
    got = got or ranks.collect(timeout=TP_WAIT_S)
    print(f"[tp-train] {part}: the ranks' runs and the parent's one-rank runs and controls "
          f"{'beside them' if beside else 'after them'}: {time.monotonic() - t0:.1f}s (the "
          f"one-rank runs and controls {t_one:.1f}s)", flush=True)
    out = {}
    for name in names:
        rows, ref = [g[name] for g in got], one[name]
        label = tp_train_cfg(name).name
        path = os.path.join(keep["dir"], f"tp_train_{name}.pt")
        params = torch.load(path, map_location="cpu", mmap=True, weights_only=False)
        off, moved = update_distance(params, ref["after"], ref["init"], dev)
        ctrl = ref["control_off"]
        del params
        os.remove(path)
        r0 = rows[0]
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"])]
        norm_rel = [abs(a - b) / abs(b) for a, b in zip(r0["grad_norms"], ref["grad_norms"])]
        same_loss = all(r["losses"] == r0["losses"] and r["grad_norms"] == r0["grad_norms"]
                        for r in rows)
        same_leaves = [all(r["peers"][i] == r0["peers"][i] for r in rows)
                       for i in range(len(r0["peers"]))]
        for r, row in enumerate(rows):
            print(f"[tp-train] {label} rank {r}: holds {row['bytes_held'] / 2**30:.3f} GiB of the "
                  f"whole params' {row['bytes_whole'] / 2**30:.3f} GiB "
                  f"({row['bytes_held'] / row['bytes_whole']:.1%}), every leaf its shard: "
                  f"{not row['bytes_bad']}; moments {row['moments_bytes'] / 2**30:.3f} GiB; peak "
                  f"{row['peak_gib']:.2f} GiB above the {row['base_gib']:.2f} GiB held before the "
                  f"steps (one rank: {ref.get('peak_gib', float('nan')):.2f} above "
                  f"{ref.get('base_gib', float('nan')):.2f}); ms per step "
                  f"{', '.join(f'{x:.1f}' for x in row['ms'])}; " + "; ".join(
                      f"{k} {n} calls {b / 2**20:.2f} MiB {t:.3f}s"
                      for k, (n, b, t) in row["comm"].items())
                  + f"; launches {sum(row['launches'].values())}", flush=True)
        print(f"[tp-train] {label} on a \"model\" axis of {len(rows)}: losses "
              + ", ".join(f"{a:.6f}" for a in r0["losses"]) + " against one rank's "
              + ", ".join(f"{b:.6f}" for b in ref["losses"])
              + f" (rel {', '.join(f'{x:.3g}' for x in loss_rel)}; bound {TP_TRAIN_LOSS_RTOL}); "
              f"gradient norms " + ", ".join(f"{a:.5g}" for a in r0["grad_norms"]) + " against "
              + ", ".join(f"{b:.5g}" for b in ref["grad_norms"])
              + f" (rel {', '.join(f'{x:.3g}' for x in norm_rel)}); params after step "
              f"{TP_TRAIN_STEPS} off the one-rank run's by {off:.6g}, {off / moved:.4g} of its "
              f"movement {moved:.6g}, against the control's {ctrl:.6g}, {ctrl / moved:.4g} (bound "
              f"{TP_TRAIN_UPDATE_RTOL} of the movement beyond the control's); the ranks' losses "
              f"and "
              f"gradient norms the same bits: {same_loss}; whole-held leaves the same bits before "
              f"each step and after the last: {same_leaves}; ms per step "
              f"{[round(x, 1) for x in r0['ms']]} on the ranks against "
              f"{[round(x, 1) for x in ref['ms']]} on one rank (two ranks share one card over "
              f"gloo; the parent's one-rank runs share it with the ranks)", flush=True)
        check(all(r["sums"] == ref["sums"] for r in rows),
              f"{part} {label}: the ranks' seeded params differ from the one-rank run's")
        check(not any(r["bytes_bad"] for r in rows),
              f"{part} {label}: a rank holds other bytes than its shard: {r0['bytes_bad'][:4]}")
        check(len(r0["losses"]) == TP_TRAIN_STEPS
              and max(loss_rel + norm_rel) <= TP_TRAIN_LOSS_RTOL,
              f"{part} {label}: losses {r0['losses']} and gradient norms {r0['grad_norms']} against "
              f"one rank's {ref['losses']}, {ref['grad_norms']}")
        check(moved > 0 and off <= TP_TRAIN_UPDATE_RTOL * moved + ctrl,
              f"{part} {label}: params {off / moved:.4g} of the movement off the one-rank run's, "
              f"the control {ctrl / moved:.4g}")
        check(same_loss and all(same_leaves), f"{part} {label}: the ranks' losses or whole-held "
              f"leaves differ ({same_loss}, {same_leaves})")
        check(all(sum(r["launches"].values()) == 0 for r in rows),
              f"{part} {label}: dense training launched a kernel: {[r['launches'] for r in rows]}")
        out[name] = dict(label=label, losses=r0["losses"], losses_one=ref["losses"],
                         grad_norms=r0["grad_norms"], grad_norms_one=ref["grad_norms"],
                         loss_rel=loss_rel, norm_rel=norm_rel, update_off=off, update_moved=moved,
                         control_off=ctrl,
                         ms_ranks=[r["ms"] for r in rows], ms_one=ref["ms"],
                         comm=[r["comm"] for r in rows], peak_gib=[r["peak_gib"] for r in rows],
                         peak_gib_one=ref.get("peak_gib"),
                         bytes_held=[r["bytes_held"] for r in rows], bytes_whole=r0["bytes_whole"],
                         moments_bytes=[r["moments_bytes"] for r in rows])
    detail.setdefault("sharded", {})[f"tp_train {part}"] = out


class Ranks:
    """``target(rank, world, *args, queue, go)`` in ``world`` processes
    started with ``spawn``.  :meth:`collect` reads one result from each, in
    rank order: a rank that fails, or does not report within ``timeout``,
    fails the phase.  :meth:`send` hands every rank a message on ``go``;
    :meth:`close` sends None (stop) and stops every process, whatever state
    the ranks are in."""

    def __init__(self, target, world: int, *args):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.queue, self.go, self.closed = ctx.Queue(), ctx.Queue(), False
        self.procs = [ctx.Process(target=target, args=(r, world, *args, self.queue, self.go))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def collect(self, timeout: float = SHARD_TIMEOUT_S) -> list:
        got, failed = {}, []
        for _ in self.procs:
            rank, ok, out = self.queue.get(timeout=timeout)
            if ok:
                got[rank] = out
            else:
                failed.append(f"rank {rank}:\n{out}")
        check(not failed, "phase 13 rank failed: " + "\n".join(failed))
        return [got[r] for r in range(len(self.procs))]

    def send(self, msg) -> None:
        for _ in self.procs:
            self.go.put(msg)

    def close(self, strict: bool = True) -> None:
        """``strict``: a rank that exits other than 0 fails the phase."""
        if self.closed:
            return
        self.closed = True
        self.send(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        check(not strict or all(p.exitcode == 0 for p in self.procs),
              f"phase 13 ranks exited {[p.exitcode for p in self.procs]}")


def replay_solve(w3, sig3, grid3, rows=None):
    """A QuantEase solve of ``w3`` (the path's config) replayed: ``(final Ŵ,
    iterates)``, ``iterates`` each iteration's ``(quantize, Ŵ of rows)`` for
    the ``(n, 2)`` (g, r) index tensor ``rows``, kept in fp32 on the card."""
    from repro_torch.core import quantease as qe
    from repro_torch.core.solver import PTQConfig

    p = w3.shape[-1]
    records, step_of = [], qe._iteration_step

    def iteration_step(*a, **kw):
        step = step_of(*a, **kw)

        def recorded(*args, **kwargs):
            out = step(*args, **kwargs)
            records.append((kwargs["quantize"], out[0][rows[:, 0], :p, rows[:, 1]].clone()))
            return out
        return recorded

    if rows is not None:
        qe._iteration_step = iteration_step
    try:
        cfg = PTQConfig(method="quantease", iterations=PTQ_ITERATIONS)
        final = qe.quantease_quantize(w3, sig3, grid3.spec, grid=grid3,
                                      **cfg.qe_config().solve_kwargs())[0]
    finally:
        qe._iteration_step = step_of
    return final, records


def sharded_path(dev, detail, plan, artifact, dense, keep, tp_dir):
    """Phase 13 (a): SHARD_RANKS gloo ranks on the one card run
    ``ptq_quantize_model(mesh=)`` (QuantEase at 4 bits) on phase 5's model
    and calibration set, each on its block of the sequences and its rows of
    every group.  Every rank's params, Σ's and artifact must be the same
    bits; the mean error within SHARD_ERR_ATOL of phase 5's ``quantease@4``
    and the restacked artifact's perplexity within SHARD_PPL_RTOL of it
    beyond the largest deviation of two local solves whose Σ sums the same
    sequences in another exact order (SHARD_PPL_CONTROLS, recorded);
    each group's Σ within SHARD_SIGMA_RTOL of a local Σ of the same
    sequences (in period 0 phase 5's inputs; a later period's come from
    each run's own quantized periods before it); the codes those of the
    local solve on that Σ (in period 0 phase 5's artifact) outside rows
    that start at a verified rounding tie (both solves replayed iteration
    by iteration, the sharded one on its own rank's rows and Σ).  The ranks
    stay up for (d) (:func:`tp_families`): the caller closes them.  Returns
    the kernels' launches (both ranks' PTQ and the scoring), the calls
    checked against the plain versions and the ranks."""
    import numpy as np
    import torch

    from repro_torch.data import DataConfig, make_batch_fn
    from repro_torch.eval.harness import EvalBudget, eval_model
    from repro_torch.kernels import ops
    from repro_torch.quant import GridSpec, compute_grid
    from repro_torch.serve.qparams import quantize_params_for_serving

    cfg = plan.cfg
    t0 = time.monotonic()
    handle = Ranks(_sharded_rank, SHARD_RANKS, os.path.join(tp_dir, "store"),
                   os.path.join(tp_dir, "rank0.pt"), dev.type)
    # The gloo group's file store stays for (d): the ranks are closed at exit
    # whatever happens before.
    atexit.register(handle.close, strict=False)
    ranks = handle.collect()
    t_ranks = time.monotonic() - t0
    saved = torch.load(os.path.join(tp_dir, "rank0.pt"), weights_only=False)
    os.remove(os.path.join(tp_dir, "rank0.pt"))
    r0 = ranks[0]
    check(all(r["params"] == _tree_bytes(dense) for r in ranks),
          "a rank's seeded params differ from phase 5's")
    for key in ("artifact", "sigmas", "report"):
        check(all(r[key] == r0[key] for r in ranks), f"the ranks' {key} differ")
    check(list(r0["report"]) == list(keep["report"]), "report keys differ from phase 5's")
    print(f"[shard] {SHARD_RANKS} gloo ranks on one card, sequences per rank and batch "
          f"{[r['n_sequences'] for r in ranks]}: params, Σ's and artifacts the same bits on every "
          f"rank ({t_ranks:.1f}s with the ranks' start)", flush=True)

    q13 = tree_to(saved["dec"], dev)
    served = quantize_params_for_serving(plan, dense, q13, device=dev)
    eval_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, MAIN_BATCH, MAIN_SEQ,
                               split="eval")
    ops.reset_launch_counts()
    metrics = eval_model(plan, served, eval_fn, budget=EvalBudget(), device=dev)
    torch.cuda.synchronize()
    counts = {k: v + sum(r["counts"][k] + r["tp"]["counts"][k] + r["tp"]["spec"]["counts"][k]
                         for r in ranks)
              for k, v in ops.launch_counts().items()}

    mean13 = float(np.mean(list(r0["report"].values())))
    mean5 = float(np.mean(list(keep["report"].values())))
    ppl5, layer5 = keep["ppl"], keep["seconds_per_layer"]
    print(f"[shard] PTQ seconds per layer, rank 0: {', '.join(f'{x:.3f}' for x in r0['blocks'])} "
          f"against phase 5's {', '.join(f'{x:.3f}' for x in layer5)} (two ranks share one card: "
          f"no speed-up expected); PTQ {r0['t_ptq']:.2f}s", flush=True)
    for r, row in enumerate(ranks):
        print(f"[shard] rank {r}: " + "; ".join(
            f"{kind} {n} calls {b / 2**20:.1f} MiB {s:.2f}s" for kind, (n, b, s) in row["comm"].items())
            + f"; launches {row['counts']}; checked {row['checked']}", flush=True)
    print(f"[shard] mean error {mean13:.6f} against phase 5's {mean5:.6f} "
          f"(|Δ| {abs(mean13 - mean5):.3g}, bound {SHARD_ERR_ATOL})", flush=True)
    checked = {}
    for r in ranks:
        merge_checked(checked, r["checked"])
        merge_checked(checked, r["tp"]["checked"])
        merge_checked(checked, r["tp"]["spec"]["checked"])
    detail["sharded"] = out = dict(
        ranks=SHARD_RANKS, seconds_with_start=t_ranks, ptq_seconds=[r["t_ptq"] for r in ranks],
        seconds_per_layer=r0["blocks"], seconds_per_layer_local=layer5, comm=[r["comm"] for r in ranks],
        launches=[r["counts"] for r in ranks], eval_launches=counts, checked=checked,
        mean_error=mean13, mean_error_local=mean5, ppl=metrics["ppl"], ppl_local=ppl5,
    )

    # Σ of every group against a local Σ of the same sequences (one process,
    # all 16, each period's inputs the outputs of the sharded artifact's
    # periods before it); the codes against the local solve on that Σ (in
    # period 0 phase 5's own solve: its codes must be phase 5's artifact's)
    # outside rows that start at a verified rounding tie.
    check(len(saved["sigmas"]) == len(keep["groups"]), "the ranks solved other groups than phase 5")
    calib_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=0), cfg, MAIN_BATCH, MAIN_SEQ,
                                split="calib")
    calib = [calib_fn(i) for i in range(MAIN_CALIB_BATCHES)]
    local = local_sigmas(plan, dense, q13, calib, dev)
    spec = GridSpec(bits=4)
    groups, k = [], 0
    for period in range(cfg.n_periods):
        for bkey in sorted(q13[period]):
            blk = q13[period][bkey]
            shapes = {n: tuple(leaf.unpacked_codes().shape) for n, leaf in blk.items()
                      if hasattr(leaf, "codes")}
            for names in solver_groups(list(shapes), shapes):
                w3, s5 = keep["groups"][k]
                s13 = saved["sigmas"][k].to(dev)
                k += 1
                s_loc = torch.stack([local[(period, bkey, n)] for n in names])
                rel = float((s13 - s_loc).abs().max() / s_loc.abs().max())
                grid = compute_grid(w3, spec)
                c13 = torch.stack([served["dec"][bkey][n].unpacked_codes()[period] for n in names])
                c_ref = torch.round(replay_solve(w3, s_loc, grid)[0] / grid.scale + grid.zero)
                row = dict(period=period, block=bkey, names=names, sigma_rel=rel,
                           sigma_rel_phase5=float((s13 - s5).abs().max() / s5.abs().max()),
                           rows=c13.shape[0] * c13.shape[1])
                if period == 0:
                    c5 = torch.stack([artifact["dec"][bkey][n].unpacked_codes()[period]
                                      for n in names])
                    row["phase5_sigma_bitwise"] = torch.equal(s_loc, s5)
                    row["phase5_codes_equal"] = torch.equal(c_ref, c5.to(c_ref.dtype))
                    check(row["phase5_codes_equal"] or not row["phase5_sigma_bitwise"],
                          f"{bkey}.p0 {names}: the replayed local solve is not phase 5's")
                rows = (c13.to(c_ref.dtype) != c_ref).any(-1).nonzero()
                row.update(verify_tie_rows(w3, s_loc, s13, grid, rows, c_ref, c13, rel))
                groups.append(row)
                check(rel <= SHARD_SIGMA_RTOL, f"Σ of {bkey}.p{period} {names}: {rel:.3g} of max "
                      f"|Σ| off the same sequences' local Σ")
                del s13, s_loc
                _free()
    check(k == len(keep["groups"]), "groups left unmatched")
    out["groups"] = groups
    n_rows = sum(g["rows"] for g in groups)
    n_diff = sum(g["differing"] for g in groups)
    n_ties = sum(g["ties"] for g in groups)
    bad = [u for g in groups for u in g["unexplained"]]
    by_period = {}
    for g in groups:
        by_period[g["period"]] = max(by_period.get(g["period"], 0.0), g["sigma_rel_phase5"])
    print(f"[shard] Σ per group against the same sequences' local Σ: max "
          f"{max(g['sigma_rel'] for g in groups):.3g} of max |Σ| (bound {SHARD_SIGMA_RTOL}); "
          f"against phase 5's, max per period {by_period} (period 1 reads each run's own "
          f"quantized period 0); period 0's local Σ phase 5's bit for bit: "
          f"{all(g.get('phase5_sigma_bitwise', True) for g in groups)}, its local solve phase 5's "
          f"codes: {all(g.get('phase5_codes_equal', True) for g in groups)}", flush=True)
    print(f"[shard] codes against the local solve on the same Σ: {n_diff} of {n_rows} rows part "
          f"({', '.join(f'{g['block']}.p{g['period']} {g['names']} {g['differing']}' for g in groups)}),"
          f" {n_ties} at verified ties (largest gap / bound {max(g['worst'] for g in groups):.3g}), "
          f"{len(bad)} unexplained {bad[:4]}", flush=True)
    check(not bad and n_ties == n_diff,
          f"sharded codes part from the local solve's outside verified ties: {bad[:8]}")
    check(abs(mean13 - mean5) <= SHARD_ERR_ATOL, "sharded mean error off phase 5's")
    # Ties cascade along a row, and a row parting in period 0 changes every
    # input of period 1: how far that alone moves the perplexity was measured
    # on local solves whose Σ sums the same sequences in another exact order
    # (the batches reversed; each batch in the ranks' blocks).
    spread = SHARD_PPL_CONTROLS
    bound = SHARD_PPL_RTOL + max(abs(x) for x in spread.values())
    out["ppl_spread"] = spread
    print(f"[shard] ppl {metrics['ppl']:.4f} against phase 5's {ppl5:.4f}: rel "
          f"{metrics['ppl'] / ppl5 - 1:.3g}; local solves on Σ summed in other orders (recorded): "
          + ", ".join(f"{k} {v:.3g}" for k, v in spread.items())
          + f"; bound {bound:.3g}", flush=True)
    check(abs(metrics["ppl"] / ppl5 - 1) <= bound, "sharded perplexity off phase 5's")
    for name in ("quantease_block_sweep", "quantease_fused_iteration", "dequant_matmul"):
        check(all(r["counts"][name] > 0 for r in ranks), f"a rank launched no {name}")
    for name in ("dequant_matmul", "paged_attention"):
        check(all(r["tp"]["counts"][name] > 0 for r in ranks),
              f"a rank's tensor-parallel serving launched no {name}")
    t0 = time.monotonic()
    tp_against_one_rank(dev, detail, plan, served, ranks)
    print(f"[tp] the one-rank runs and checks: {time.monotonic() - t0:.1f}s", flush=True)
    tp_spec_checks(detail, ranks)
    return counts, checked, handle


def local_sigmas(plan, dense, q13, calib, dev) -> dict:
    """``{(period, block, name): Σ}`` of every quantizable linear over all of
    phase 5's calibration sequences in this one process, each period's
    inputs the outputs of the sharded artifact ``q13``'s periods before it
    (as ``core.solver`` runs them)."""
    import torch

    from repro_torch.core import solver
    from repro_torch.models import model as M
    from repro_torch.models.common import capture_gram_stats, capture_scope

    cfg = plan.cfg
    out = {}
    with torch.no_grad():
        xs = [M.decoder_inputs(plan, dense, M.as_tokens(b["tokens"], dev), b) for b in calib]
        for period in range(cfg.n_periods):
            p_period = M.period_slice(dense["dec"], period)
            for i, b in enumerate(cfg.pattern):
                stats, scope = {}, f"dec.p{period}.b{i}"
                with capture_gram_stats(stats), capture_scope(scope):
                    for x in xs:
                        solver._apply_block(plan, b, p_period[f"b{i}"], x)
                out.update({(period, f"b{i}", k.split("/")[1]): st.sigma for k, st in stats.items()})
                xs = [solver._apply_block(plan, b, q13[period][f"b{i}"], x) for x in xs]
    return out


def tree_to(tree, dev):
    from repro_torch.models import model as M

    return M.tree_map(lambda a: a.map_arrays(lambda t: t.to(dev)) if hasattr(a, "map_arrays")
                      else a.to(dev), tree, is_leaf=lambda a: hasattr(a, "map_arrays"))


def verify_tie_rows(w3, s_ref, s13, grid, rows, c_ref, c13, sig_rel) -> dict:
    """The ``(n, 2)`` (g, r) ``rows`` whose codes part between the local
    solve (Σ ``s_ref``, codes ``c_ref``) and the sharded run (Σ ``s13``,
    codes ``c13``, row r solved by rank ``r // per`` among its padded rows):
    both solves replayed with those rows' iterates kept on the card; the
    replays must give each run's codes; at the first iteration where a row
    parts (by more than 1e-5; a quantizing iteration) and its first such
    column, β from the sharded iterates must lie within the fp32 bound,
    widened by the Σ's relative difference ``sig_rel``, of a rounding
    midpoint (as tests/test_torch_cuda.py's ``midpoint_gap``).  Returns the
    counts, the largest gap over its bound among the ties, and the first
    unexplained rows."""
    import torch

    from repro_torch.core.calib import damp_sigma

    n = rows.shape[0]
    res = dict(differing=n, ties=0, worst=0.0, unexplained=[])
    if not n:
        return res
    q, p = w3.shape[1:]
    per = -(-q // SHARD_RANKS)
    pad = per * SHARD_RANKS - q
    g_i, r_i = rows[:, 0], rows[:, 1]
    scale, zero = grid.scale[g_i, r_i], grid.zero[g_i, r_i]  # (n, 1): per channel
    fin_ref, rec = replay_solve(w3, s_ref, grid, rows)
    flags = torch.tensor([qz for qz, _ in rec], device=w3.device)
    R = torch.stack([t for _, t in rec])
    del rec
    S, fin13 = torch.empty_like(R), torch.empty_like(R[0])
    wp = torch.nn.functional.pad(w3, (0, 0, 0, pad))
    sp = torch.nn.functional.pad(grid.scale, (0, 0, 0, pad), value=1.0)
    zp = torch.nn.functional.pad(grid.zero, (0, 0, 0, pad))
    for rank in range(SHARD_RANKS):
        idx = ((r_i // per) == rank).nonzero()[:, 0]
        if not len(idx):
            continue
        mine = rows[idx].clone()
        mine[:, 1] -= rank * per
        sl = slice(rank * per, (rank + 1) * per)
        g_b = dataclasses.replace(grid, scale=sp[:, sl].contiguous(), zero=zp[:, sl].contiguous())
        fin, rec = replay_solve(wp[:, sl].contiguous(), s13, g_b, mine)
        S[:, idx] = torch.stack([t for _, t in rec])
        fin13[idx] = fin[mine[:, 0], mine[:, 1]]
        del rec, fin
    codes = lambda w: torch.round(w / scale + zero)
    check(torch.equal(codes(fin_ref[g_i, r_i]), c_ref[g_i, r_i])
          and torch.equal(codes(fin13), c13[g_i, r_i].to(fin13.dtype)),
          "the replays do not give the runs' codes")
    D = (S - R).abs() > 1e-5  # (iterations, n, p)
    parted = D.any(-1)
    check(bool(parted.any(0).all()), "a row whose codes part never parts in the replays")
    it = parted.int().argmax(0)
    ar = torch.arange(n, device=w3.device)
    j = D[it, ar].int().argmax(-1)
    del D, R
    cur = S[it, ar].double()
    prev = torch.where((it > 0)[:, None], S[(it - 1).clamp_min(0), ar].double(),
                       w3[g_i, r_i].double())
    del S
    gap = torch.empty(n, dtype=torch.float64, device=w3.device)
    tol = torch.empty_like(gap)
    cols = torch.arange(p, device=w3.device)[None]
    for g in g_i.unique().tolist():
        sel = (g_i == g).nonzero()[:, 0]
        sd = damp_sigma(s13[g].double())
        sig_norm = sd / torch.diagonal(sd)[None, :]
        del sd
        jj = j[sel]
        col = sig_norm[:, jj].T.contiguous()  # (m, p): column j of each row
        pmat = (w3[g, r_i[sel]].double() * col).sum(-1)
        col[torch.arange(len(sel), device=w3.device), jj] -= 1.0
        terms = torch.where(cols < jj[:, None], cur[sel],
                            torch.where(cols > jj[:, None], prev[sel], 0.0)) * col
        sc, ze = scale[sel, 0].double(), zero[sel, 0].double()
        v = (pmat - terms.sum(-1)) / sc + ze
        mag = pmat.abs() + terms.abs().sum(-1)
        gap[sel] = (v - (torch.floor(v) + 0.5)).abs()
        tol[sel] = (4 * p * 2.0 ** -23 + 2 * sig_rel) * mag / sc + 1e-6
        del sig_norm, col, terms
    tie = flags[it] & (gap <= tol)
    res["ties"] = int(tie.sum())
    res["worst"] = float((gap / tol)[tie].max()) if res["ties"] else 0.0
    for k in (~tie).nonzero()[:8, 0].tolist():
        res["unexplained"].append(dict(g=int(g_i[k]), row=int(r_i[k]), iteration=int(it[k]),
                                       col=int(j[k]), quantize=bool(flags[it[k]]),
                                       gap=float(gap[k]), tol=float(tol[k])))
    return res


def fsdp_world_one(dev, detail):
    """Phase 13 (b): ``Trainer(mesh=<data mesh of 1>, fsdp=True)`` in this
    process, in a NCCL group of one rank (a ``file://`` store), on phase
    5b's model and batches for SHARD_TRAIN_STEPS steps: the losses within
    SHARD_LOSS_RTOL of phase 5b's first steps (bit for bit recorded), ms per
    step and peak memory, and the checkpoint round trip bit for bit.
    Returns the kernels' launches (the dense training path runs none)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("phi3_mini_3_8b"), **MAIN_OVERRIDES)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'store')}", rank=0,
                            world_size=1, device_id=dev if dev.index is not None
                            else torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
        _free()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, AdamWConfig(**TRAIN_OPT),
                          TrainerConfig(steps=SHARD_TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                        ckpt_every=SHARD_TRAIN_STEPS + 1,
                                        ckpt_dir=os.path.join(tmp, "ckpt"), log_every=1),
                          mesh=mesh, fsdp=True, device=dev)
        n_sharded = sum(d is not None for d in trainer.shards.dims)
        stamps = []

        def stamp(step=None):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        ops.reset_launch_counts()
        out = trainer.run(fault_hook=stamp)
        stamp()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        losses = [m["loss"] for m in out["log"]]
        local = detail["train"]["losses"][:SHARD_TRAIN_STEPS]
        rel = max(abs(a / b - 1) for a, b in zip(losses, local))
        ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        print(f"[fsdp] Trainer(mesh=<data 1>, fsdp=True) over NCCL, {n_sharded} of "
              f"{len(trainer.shards.dims)} leaves split on their embed dim: losses "
              + ", ".join(f"{x:.6f}" for x in losses)
              + f" against phase 5b's {', '.join(f'{x:.6f}' for x in local)} (rel {rel:.3g}, "
              f"bit for bit: {losses == local}); ms per step {', '.join(f'{x:.1f}' for x in ms)}; "
              f"peak {peak / 2**30:.3f} GiB above {base / 2**30:.3f} GiB", flush=True)
        check(len(losses) == SHARD_TRAIN_STEPS and rel <= SHARD_LOSS_RTOL,
              f"FSDP losses {losses} off phase 5b's {local}")
        state = [t.clone() for t in tree_leaves({"params": trainer.params, "opt": trainer.opt_state})]
        t0 = time.monotonic()
        trainer.save(SHARD_TRAIN_STEPS)
        t_save = time.monotonic() - t0
        t0 = time.monotonic()
        step = trainer.restore()
        t_restore = time.monotonic() - t0
        back = tree_leaves({"params": trainer.params, "opt": trainer.opt_state})
        same = len(back) == len(state) and all(_same_bits(a, b) for a, b in zip(state, back))
        n_bytes = sum(t.numel() * t.element_size() for t in state)
        print(f"[fsdp] checkpoint of {len(state)} leaves, {n_bytes / 2**30:.2f} GiB: saved in "
              f"{t_save:.1f}s, restored in {t_restore:.1f}s, bit for bit: {same}", flush=True)
        check(step == SHARD_TRAIN_STEPS and same, f"FSDP checkpoint round trip: step {step}, "
              f"bitwise {same}")
        del trainer, state, back
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    detail["fsdp"] = dict(losses=losses, losses_local=local, rel=rel, bitwise=losses == local,
                          ms_per_step=ms, peak_bytes=peak, base_bytes=base, save_s=t_save,
                          restore_s=t_restore, checkpoint_bytes=n_bytes, leaves_split=n_sharded)
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
    t_start = time.monotonic()
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
    t0 = time.monotonic()
    measured = {
        "quantease_block_sweep": check_block_sweep(gen, dev, detail),
        "quantease_fused_iteration": check_fused_iteration(gen, dev, detail),
        "quantease_outlier_iteration": check_outlier_iteration(gen, dev, detail),
        "dequant_matmul": check_dequant_matmul(gen, dev, detail),
        "paged_attention": check_paged_attention(gen, dev, detail),
    }
    print(f"[phase] 3, the kernels: {time.monotonic() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    check_legacy_engines(gen, dev, detail)
    print(f"[phase] 3, the legacy engines: {time.monotonic() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    counts_ptq, plan, artifact, dense, keep = main_path(dev, detail)
    print(f"[phase] 5, the main path: {time.monotonic() - t0:.1f}s", flush=True)
    expected = sum(x["launches_on_path"] for x in detail["block_sweep"])
    check(counts_ptq["quantease_block_sweep"] == expected,
          f"kernel 1 launched {counts_ptq['quantease_block_sweep']} times on the PTQ path, "
          f"phase 3's launches per shape sum to {expected}")
    print(f"[main] kernel 1's launches on the PTQ path {counts_ptq['quantease_block_sweep']} = the "
          f"sum of phase 3's launches per shape", flush=True)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    counts_train, tp_train_base = train_full_width(dev, detail)
    print(f"[phase] 5b, training at full width: {time.monotonic() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    tp_dir = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    atexit.register(shutil.rmtree, tp_dir, True)
    tp_keep = {"dir": tp_dir}
    counts_sharded, at_sharded, ranks = sharded_path(dev, detail, plan, artifact, dense, keep, tp_dir)
    del keep
    _free()
    counts_fsdp = fsdp_world_one(dev, detail)
    print(f"[phase] 13, the data-parallel mesh (two gloo ranks on the card; FSDP over NCCL): "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    counts_serve = serving(dev, detail, plan, artifact)
    print(f"[phase] 6, serving: {time.monotonic() - t0:.1f}s", flush=True)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    card_tests = start_card_tests()
    try:
        t0 = time.monotonic()
        counts_quality, at_path, quality_model = quality_table(dev, detail, card)
        print(f"[phase] 7, the quality table: {time.monotonic() - t0:.1f}s", flush=True)
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        counts_cli, at_cli = cli_path(dev, detail, root)
        print(f"[phase] 8, the command-line path: {time.monotonic() - t0:.1f}s", flush=True)
        t0 = time.monotonic()
        finish_card_tests(card_tests)
        print(f"[phase] 4, tests/test_torch_cuda.py beside phases 7 and 8: waited "
              f"{time.monotonic() - t0:.1f}s after them", flush=True)
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
        if card_tests[0].poll() is None:  # a failed phase 7 or 8: stop the tests' process
            card_tests[0].kill()
            card_tests[0].wait()
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.monotonic()
    counts_fam, at_fam = families(dev, detail, tp_keep)
    print(f"[phase] 10, the OPT family, the dense configs and MoE at full width: "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    t0 = time.monotonic()
    counts_ssm, at_ssm = ssm_families(dev, detail, tp_keep)
    print(f"[phase] 11, Mamba-2 and Jamba-1.5-Large at full width: {time.monotonic() - t0:.1f}s",
          flush=True)
    t0 = time.monotonic()
    counts_tpf, at_tpf = tp_families(detail, ranks, tp_keep)
    print(f"[phase] 13 (d), OLMoE and Jamba on a \"model\" axis of 2: {time.monotonic() - t0:.1f}s",
          flush=True)
    t0 = time.monotonic()
    tp_train(dev, detail, ranks, tp_keep, {"phi3": tp_train_base}, TP_TRAIN, "(e)")
    del tp_train_base
    _free()
    print(f"[phase] 13 (e), Phi-3-mini, OLMoE and Mamba-2 trained on a \"model\" axis of 2: "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    # The ranks wait, holding nothing on the card, through phase 12, whose
    # served runs and artifacts (f) takes.
    t0 = time.monotonic()
    counts_enc, at_enc = encdec_families(dev, detail, tp_keep)
    print(f"[phase] 12, Whisper-large-v3 and LLaVA-NeXT-34B at full width: "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    t0 = time.monotonic()
    counts_tpe, at_tpe = tp_encdec(detail, ranks, tp_keep)
    t_serve = time.monotonic() - t0
    tp_train(dev, detail, ranks, tp_keep, {}, TP_TRAIN_F, "(f)", beside=False)
    ranks.close()
    shutil.rmtree(tp_dir, ignore_errors=True)
    _free()
    print(f"[phase] 13 (f), Whisper-large-v3 and LLaVA-NeXT-34B served and trained on a \"model\" "
          f"axis of 2: {time.monotonic() - t0:.1f}s (serving {t_serve:.1f}s)", flush=True)
    at_fam.update(at_ssm)
    at_fam.update(at_enc)
    # Each path's counts were read just after it ran, from 0.
    paths = dict(ptq=counts_ptq, train=counts_train, serving=counts_serve, quality=counts_quality,
                 cli=counts_cli, speculation=counts_spec, tune=counts_tune, families=counts_fam,
                 ssm=counts_ssm, encdec=counts_enc, sharded=counts_sharded, fsdp=counts_fsdp,
                 tp_families=counts_tpf, tp_encdec=counts_tpe)
    detail["launches"] = paths
    # (d) and (f) report together under "tp_families", as the ranks' serving of the families.
    at_tpf = merge_checked(merge_checked({}, at_tpf), at_tpe)
    counts = {k: sum(c[k] for c in paths.values()) for k in counts_ptq}

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
            families={cfg: c.get(name.replace("quantease_", ""), {}).get("calls", 0)
                      for cfg, c in at_fam.items()},
            sharded_launches=counts_sharded[name],
            tp_spec_launches=sum(c[name] for c in detail["sharded"]["tp_spec"]["launches"]),
            sharded_calls_checked=at_sharded.get(name.replace("quantease_", ""), {}).get("calls", 0),
            tp_families_launches=counts_tpf.get(name, 0) + counts_tpe.get(name, 0),
            tp_families_calls_checked=at_tpf.get(name.replace("quantease_", ""), {}).get("calls", 0),
        ))
    detail["kernels"] = kernels
    detail["seconds"] = time.monotonic() - t_start
    print(f"[phase] all: {detail['seconds']:.1f}s", flush=True)
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
