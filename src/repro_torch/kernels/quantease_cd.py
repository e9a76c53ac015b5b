"""CUDA wrappers: QuantEase block sweep and fused CD iteration.

* :func:`block_sweep_cuda` launches ``qe_block_sweep_kernel``, the sweep of
  one column block (replaces ``quantease_block_sweep_pallas``), in column
  panels on a plan of :func:`plan_sweep`: panel width and rows per CTA.
* :func:`fused_iteration_cuda` runs one whole CD iteration (replaces
  ``quantease_fused_iteration_pallas``): for each column block in order it
  launches ``qe_block_corr_kernel`` (the full-width rolling-Δ correction,
  whose result is both β0 and the next base) and then the block sweep.
* :func:`outlier_iteration_cuda` runs one outlier-aware CD iteration
  (replaces ``quantease_outlier_iteration_t_pallas``): the same two
  launches per block with the correction's ``−dĤ_prev`` terms, then
  ``qe_suffix_resid_kernel`` once for the exact residual R.
* :func:`plan_corr` chooses each correction's tile (128 rows, or 64 for
  blocks of fewer than 128) and its split of k by counting waves of the
  CTAs an SM holds; both iteration wrappers take ``plan=`` to pin one, and
  :func:`correction_cuda` / :func:`suffix_cuda` launch one block's
  correction or the suffix product alone (uncounted; ``chip_smoke.py``
  times them against ``torch.matmul``).  All three wrappers take
  ``sweep_plan=`` to pin the sweep's plan.

Both take the transposed layout of ``csrc/quantease_cd.cu``: per-row
operands are ``(G, rows, q)`` or ``(rows, q)`` with q contiguous.  Each
wrapper counts its launches in ``.launches``.  They accept CUDA tensors
only; :mod:`repro_torch.kernels.ops` routes CPU tensors to the plain
versions.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

__all__ = ["block_sweep_cuda", "fused_iteration_cuda", "outlier_iteration_cuda", "correction_cuda",
           "suffix_cuda", "plan_corr", "check_corr_plan", "corr_tile_rows", "corr_slices",
           "corr_ctas", "ctas_per_sm", "plan_sweep", "check_sweep_plan", "sweep_panels",
           "sweep_ctas", "sweep_ctas_per_sm", "MAX_BLOCK", "TILE_ROWS", "TILE_COLS", "K_STEP",
           "MIN_K_CHUNK", "SWEEP_PANEL", "SWEEP_ROWS", "SWEEP_THREADS"]

MAX_BLOCK = 256  # the sweep's shared memory holds a block's sums for its rows
SWEEP_PANEL = 16  # the sweep's panel width (columns per panel)
SWEEP_ROWS = (32, 64)  # rows of q per sweep CTA, as plan_sweep's arguments order them
SWEEP_THREADS = 256  # threads per sweep CTA: SWEEP_THREADS // rows lanes share a row
TILE_ROWS = (64, 128)  # the correction SGEMM's tiles: rows of the block (or of p) per CTA
TILE_COLS = 128  # columns of q per CTA
K_STEP = 16  # the depth of one shared-memory stage; split-K slices are multiples of it
MIN_K_CHUNK = 512  # the shortest k range a split of the correction gets
# The planner's rates (H100 SXM data sheet): fp32 FMA on the CUDA cores and
# HBM bytes, to weigh a split's partial sums against the k-steps it saves.
_PEAK_FP32, _PEAK_BYTES, _LAUNCH_S = 67e12, 3.35e12, 4e-6


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def corr_tile_rows(bsz: int) -> int:
    """The correction's tile for a block of ``bsz`` rows: 128 rows, or the
    64-row instance of the same loop for blocks of fewer than 128."""
    return 128 if bsz >= 128 else 64


def corr_slices(p_pad: int, splits: int) -> list:
    """The k ranges ``[lo, hi)`` of the ``splits`` slices, as the kernel cuts
    them: ``ceil(ceil(p_pad/K_STEP)/splits)`` k-steps each, the last one
    short.  Raises ``ValueError`` if a slice would be empty."""
    _require(isinstance(splits, int) and splits >= 1, f"splits must be an int >= 1, got {splits!r}")
    chunk = _cdiv(_cdiv(p_pad, K_STEP), splits) * K_STEP
    _require((splits - 1) * chunk < p_pad, f"{splits} splits of p_pad={p_pad} leave a slice empty")
    return [(s * chunk, min(p_pad, (s + 1) * chunk)) for s in range(splits)]


def corr_ctas(G: int, q: int, bsz: int, tile_rows: int, splits: int) -> int:
    """CTAs of one block's correction launch (not the reduce)."""
    return G * _cdiv(q, TILE_COLS) * _cdiv(bsz, tile_rows) * splits


@functools.lru_cache(maxsize=4096)
def plan_corr(G: int, q: int, bsz: int, p_pad: int, n_sm: int, ctas_per_sm: int) -> tuple:
    """``(tile_rows, splits)`` for one block's correction.

    The tile is :func:`corr_tile_rows`'s.  The split counts waves: a wave is
    ``n_sm·ctas_per_sm`` CTAs (``ctas_per_sm``: CTAs of that tile resident
    on one SM at once), and a split of ``s`` runs ``ceil(ctas·s / wave)``
    waves of ``ceil(steps/s)`` k-steps each, so a last wave that is mostly
    idle costs as much as a full one.  Each split beyond the first adds its
    partial sums' round trip through memory (and the reduce launch), counted
    in the same wave k-steps at the card's fp32 and HBM rates.  Slices are
    whole k-steps, at least ``MIN_K_CHUNK`` long; the cheapest split wins,
    the smaller on a tie.
    """
    tile = corr_tile_rows(bsz)
    steps = _cdiv(p_pad, K_STEP)
    slots = n_sm * max(1, ctas_per_sm)
    tiles = corr_ctas(G, q, bsz, tile, 1)
    wave_step_s = max(1, ctas_per_sm) * tile * TILE_COLS * K_STEP * 2 / (_PEAK_FP32 / n_sm)
    best = (math.inf, 1)
    for s in range(1, steps + 1):
        chunk = _cdiv(steps, s)
        if _cdiv(steps, chunk) != s:
            continue  # the same slices as a smaller split
        if s > 1 and chunk * K_STEP < MIN_K_CHUNK:
            break
        cost = _cdiv(tiles * s, slots) * chunk
        if s > 1:
            cost += (2 * s * G * bsz * q * 4 / _PEAK_BYTES + _LAUNCH_S) / wave_step_s
        if cost < best[0]:
            best = (cost, s)
    return tile, best[1]


def sweep_panels(bsz: int, panel: int) -> list:
    """The sweep's panels of a block of ``bsz`` columns: ``[lo, hi)`` of
    ``panel`` columns each, the last one short."""
    return [(lo, min(lo + panel, bsz)) for lo in range(0, bsz, panel)]


def sweep_ctas(G: int, q: int, rows: int) -> int:
    """CTAs of one sweep launch: one per ``rows`` rows of q per group."""
    return G * _cdiv(q, rows)


@functools.lru_cache(maxsize=4096)
def plan_sweep(G: int, q: int, bsz: int, n_sm: int, ctas_32: int, ctas_64: int) -> tuple:
    """``(panel, rows)`` for sweeping a ``(G, bsz, q)`` block.

    Panels of 16 columns and 32 rows per CTA; 64 rows where 32-row CTAs
    need more rounds of the CTAs the ``n_sm`` SMs hold at once than 64-row
    CTAs do (G = 2, q = 8192, B = 128).  ``ctas_32`` and ``ctas_64``: CTAs
    of the 32- and 64-row instances resident on one SM at this ``bsz``
    (:func:`sweep_ctas_per_sm` on the card).  ``SWEEP_THREADS // rows``
    threads share a row in the panel update.
    """
    _require(min(G, q, bsz, n_sm, ctas_32, ctas_64) >= 1,
             f"plan_sweep({G}, {q}, {bsz}, {n_sm}, {ctas_32}, {ctas_64})")
    rounds = lambda rows, cps: _cdiv(sweep_ctas(G, q, rows), n_sm * cps)
    return SWEEP_PANEL, 64 if rounds(64, ctas_64) < rounds(32, ctas_32) else 32


def check_sweep_plan(plan) -> tuple:
    """``plan`` as ``(panel, rows)`` if the sweep kernel takes it: panels of
    :data:`SWEEP_PANEL` columns and rows of :data:`SWEEP_ROWS`.  Raises
    ``ValueError`` otherwise."""
    _require(isinstance(plan, (tuple, list)) and len(plan) == 2
             and all(isinstance(v, int) and not isinstance(v, bool) for v in plan),
             f"sweep_plan must be (panel, rows) ints, got {plan!r}")
    panel, rows = plan
    _require(panel == SWEEP_PANEL, f"panel {panel} is not {SWEEP_PANEL}")
    _require(rows in SWEEP_ROWS, f"rows {rows} not in {SWEEP_ROWS}")
    return panel, rows


@functools.lru_cache(maxsize=None)
def sweep_ctas_per_sm(index: int, rows: int, bsz: int) -> int:
    """CTAs of the sweep kernel with ``rows`` rows per CTA resident on one SM
    of card ``index`` for blocks of ``bsz`` columns (the CUDA occupancy
    calculator)."""
    n = build.load("quantease_cd").qe_sweep_ctas_per_sm(SWEEP_PANEL, rows, bsz, index)
    if n <= 0:
        raise RuntimeError(f"qe_sweep_ctas_per_sm({rows}, {bsz}): CUDA error {-n}")
    return n


def _sweep_plan(dev, G: int, q: int, bsz: int, sweep_plan) -> tuple:
    if sweep_plan is None:
        cps = (sweep_ctas_per_sm(dev.index, rows, bsz) for rows in SWEEP_ROWS)
        return plan_sweep(G, q, bsz, sm_count(dev.index), *cps)
    return check_sweep_plan(sweep_plan)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(tensors: dict, device: torch.device) -> None:
    for name, t in tensors.items():
        _require(t.device == device, f"{name} is on {t.device}, expected {device}")


def block_sweep_cuda(
    beta0_t, sig_t, w_old_t, scale_t, zero_t, *, n_levels: int, quantize: bool, out=None,
    sweep_plan=None,
):
    """Sweep the B columns of one block for G groups at once.

    ``beta0_t``, ``w_old_t``, ``scale_t``, ``zero_t``: ``(G, B, q)`` or
    ``(B, q)`` fp32 with identical strides and q contiguous; ``sig_t``:
    ``(G, B, B)`` or ``(B, B)`` fp32, row i = Σ̃_blk[:, i], last dim
    contiguous.  ``out``: optional ``(w_new_t, delta_t)`` with the same
    strides as ``beta0_t`` (views into the fused iteration's outputs);
    otherwise the inputs must be contiguous and outputs are allocated.
    ``sweep_plan``: ``(panel, rows)`` instead of :func:`plan_sweep`'s;
    one the kernel cannot take raises ``ValueError``.  Every plan gives
    bit-identical results.  Returns ``(w_new_t, delta_t)``.
    """
    dev = beta0_t.device
    rows = {"beta0_t": beta0_t, "w_old_t": w_old_t, "scale_t": scale_t, "zero_t": zero_t}
    _require(dev.type == "cuda", "block_sweep_cuda takes CUDA tensors")
    _check_cuda({**rows, "sig_t": sig_t}, dev)
    _require(beta0_t.dim() in (2, 3), f"beta0_t must be (G, B, q) or (B, q), got {tuple(beta0_t.shape)}")
    batched = beta0_t.dim() == 3
    G = beta0_t.shape[0] if batched else 1
    bsz, q = beta0_t.shape[-2], beta0_t.shape[-1]
    _require(0 < bsz <= MAX_BLOCK, f"block size {bsz} outside 1..{MAX_BLOCK}")
    for name, t in rows.items():
        _require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
        _require(t.shape == beta0_t.shape, f"{name} shape {tuple(t.shape)} != {tuple(beta0_t.shape)}")
        _require(t.stride() == beta0_t.stride(), f"{name} strides differ from beta0_t's")
    _require(beta0_t.stride(-1) == 1 and beta0_t.stride(-2) == q,
             "row operands need q contiguous and row stride q")
    _require(sig_t.dtype == torch.float32, "sig_t must be float32")
    _require(sig_t.shape == (*beta0_t.shape[:-2], bsz, bsz), f"sig_t shape {tuple(sig_t.shape)}")
    _require(sig_t.stride(-1) == 1, "sig_t rows must be contiguous")
    if out is None:
        _require(beta0_t.is_contiguous(), "inputs must be contiguous when out is not given")
        w_new, delta = torch.empty_like(beta0_t), torch.empty_like(beta0_t)
    else:
        w_new, delta = out
        for name, t in (("w_new", w_new), ("delta", delta)):
            _require(t.device == dev and t.dtype == torch.float32, f"out {name}: float32 on {dev}")
            _require(t.shape == beta0_t.shape and t.stride() == beta0_t.stride(),
                     f"out {name} must match beta0_t's shape and strides")
    panel, rows = _sweep_plan(dev, G, q, bsz, sweep_plan)
    gs = beta0_t.stride(0) if batched else 0
    sig_gs = sig_t.stride(0) if batched else 0
    lib = build.load("quantease_cd")
    err = lib.qe_block_sweep(
        beta0_t.data_ptr(), sig_t.data_ptr(), w_old_t.data_ptr(), scale_t.data_ptr(),
        zero_t.data_ptr(), w_new.data_ptr(), delta.data_ptr(),
        G, q, bsz, gs, sig_gs, sig_t.stride(-2), int(n_levels), int(bool(quantize)), panel, rows,
        torch.cuda.current_stream(dev).cuda_stream, dev.index,
    )
    build.check(err, "qe_block_sweep")
    block_sweep_cuda.launches += 1
    return w_new, delta


block_sweep_cuda.launches = 0


def _check_iteration(name, state: dict, sig_t, sig_corr, bsz: int):
    """Validate the per-row state and Σ̃ operands of a whole-iteration
    wrapper; returns ``(device, G, p_pad, q)``."""
    base_t = next(iter(state.values()))
    dev = base_t.device
    _require(dev.type == "cuda", f"{name} takes CUDA tensors")
    _check_cuda({**state, "sig_t": sig_t, "sig_corr": sig_corr}, dev)
    _require(base_t.dim() in (2, 3), f"base_t must be (G, p_pad, q) or (p_pad, q), got {tuple(base_t.shape)}")
    p_pad, q = base_t.shape[-2], base_t.shape[-1]
    G = base_t.shape[0] if base_t.dim() == 3 else 1
    _require(0 < bsz <= MAX_BLOCK and p_pad % bsz == 0,
             f"bsz={bsz} must be in 1..{MAX_BLOCK} and divide p_pad={p_pad}")
    for k, t in state.items():
        _require(t.dtype == torch.float32, f"{k} must be float32, got {t.dtype}")
        _require(t.shape == base_t.shape and t.is_contiguous(), f"{k}: contiguous {tuple(base_t.shape)}")
    sig_shape = (*base_t.shape[:-2], p_pad, p_pad)
    _require(sig_t.dtype == torch.float32 and sig_t.shape == sig_shape and sig_t.is_contiguous(),
             f"sig_t: contiguous float32 {sig_shape}")
    _require(sig_corr.dtype in (torch.float32, torch.bfloat16), "sig_corr must be float32 or bfloat16")
    _require(sig_corr.shape == sig_shape and sig_corr.is_contiguous(), f"sig_corr: contiguous {sig_shape}")
    return dev, G, p_pad, q


def check_corr_plan(plan, p_pad: int) -> tuple:
    """``plan`` as ``(tile_rows, splits)`` if the correction kernel takes it
    for a k range of ``p_pad``: a tile of :data:`TILE_ROWS` and a split whose
    slices are all non-empty.  Raises ``ValueError`` otherwise."""
    _require(isinstance(plan, (tuple, list)) and len(plan) == 2,
             f"plan must be (tile_rows, splits), got {plan!r}")
    tile, splits = plan
    _require(tile in TILE_ROWS, f"tile_rows {tile!r} not in {TILE_ROWS}")
    corr_slices(p_pad, splits)
    return tile, splits


@functools.lru_cache(maxsize=None)
def ctas_per_sm(index: int, tile_rows: int, bf16: bool, outlier: bool) -> int:
    """CTAs of the correction kernel at ``tile_rows`` resident on one SM of
    card ``index`` (the CUDA occupancy calculator on its registers and
    shared memory)."""
    n = build.load("quantease_cd").qe_corr_ctas_per_sm(tile_rows, int(bf16), int(outlier), index)
    if n <= 0:
        raise RuntimeError(f"qe_corr_ctas_per_sm({tile_rows}): CUDA error {-n}")
    return n


def _corr_plan(dev, G, q, bsz, p_pad, bf16, outlier, plan):
    """The plan (:func:`plan_corr`'s, or the caller's after
    :func:`check_corr_plan`) and the split-K scratch it needs."""
    if plan is None:
        tile = corr_tile_rows(bsz)
        cps = ctas_per_sm(dev.index, tile, bf16, outlier)
        plan = plan_corr(G, q, bsz, p_pad, sm_count(dev.index), cps)
    plan = check_corr_plan(plan, p_pad)
    part = None
    if plan[1] > 1:
        part = torch.empty(plan[1] * G * bsz * q, dtype=torch.float32, device=dev)
    return plan, part


def correction_cuda(sig_corr, delta_prev_t, delta_new_t, base_t, base_out_t, *, col0: int,
                    bsz: int, plan: tuple, part=None, dh_t=None) -> None:
    """Launch one block's correction, ``qe_block_corr`` (or
    ``qe_outlier_corr`` with ``dh_t``), on operands an iteration wrapper has
    checked, with a checked ``plan`` and the scratch it needs.  Counts
    nothing: the iteration wrappers count their launches, and
    ``chip_smoke.py`` times the corrections alone through this."""
    dev = base_t.device
    p_pad, q = base_t.shape[-2:]
    G = base_t.numel() // (p_pad * q)
    lib = build.load("quantease_cd")
    head = (sig_corr.data_ptr(), int(sig_corr.dtype == torch.bfloat16), delta_prev_t.data_ptr(),
            delta_new_t.data_ptr())
    tail = (base_t.data_ptr(), base_out_t.data_ptr(), None if part is None else part.data_ptr(),
            *plan, G, p_pad, q, col0, bsz, torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if dh_t is None:
        build.check(lib.qe_block_corr(*head, *tail), "qe_block_corr")
    else:
        build.check(lib.qe_outlier_corr(*head, dh_t.data_ptr(), *tail), "qe_outlier_corr")


def suffix_cuda(sig_corr, dpure_t, base_new_t, r_t, *, bsz: int, tile_rows: int) -> None:
    """Launch the exact residual ``qe_suffix_resid`` on checked operands
    (uncounted, as :func:`correction_cuda`)."""
    dev = base_new_t.device
    p_pad, q = base_new_t.shape[-2:]
    err = build.load("quantease_cd").qe_suffix_resid(
        sig_corr.data_ptr(), int(sig_corr.dtype == torch.bfloat16), dpure_t.data_ptr(),
        base_new_t.data_ptr(), r_t.data_ptr(), tile_rows, base_new_t.numel() // (p_pad * q),
        p_pad, q, bsz, torch.cuda.current_stream(dev).cuda_stream, dev.index,
    )
    build.check(err, "qe_suffix_resid")


def fused_iteration_cuda(
    base_t, sig_t, sig_corr, w_t, scale_t, zero_t, delta_prev_t, *,
    n_levels: int, quantize: bool, bsz: int, plan=None, sweep_plan=None,
):
    """One whole CD iteration of the fused engine.

    Per-row state: ``(G, p_pad, q)`` or ``(p_pad, q)`` contiguous fp32;
    ``sig_t``: Σ̃ᵀ ``(G, p_pad, p_pad)`` fp32 (diagonal blocks for the
    sweep); ``sig_corr``: Σ̃ᵀ in the correction dtype, fp32 or bf16.
    ``plan``: ``(tile_rows, splits)`` for the corrections instead of
    :func:`plan_corr`'s (tests and ``chip_smoke.py`` pin one), and
    ``sweep_plan`` the sweeps' as :func:`block_sweep_cuda`'s; a plan the
    kernel cannot take raises ``ValueError``.
    Returns ``(w_new_t, base_new_t, delta_new_t)``.  ``.launches`` counts
    correction launches, one per column block.
    """
    state = {"base_t": base_t, "w_t": w_t, "scale_t": scale_t, "zero_t": zero_t,
             "delta_prev_t": delta_prev_t}
    dev, G, p_pad, q = _check_iteration("fused_iteration_cuda", state, sig_t, sig_corr, bsz)
    plan, part = _corr_plan(dev, G, q, bsz, p_pad, sig_corr.dtype == torch.bfloat16, False, plan)
    sweep_plan = _sweep_plan(dev, G, q, bsz, sweep_plan)
    w_new = torch.empty_like(base_t)
    base_new = torch.empty_like(base_t)
    delta_new = torch.empty_like(base_t)
    for col0 in range(0, p_pad, bsz):
        correction_cuda(sig_corr, delta_prev_t, delta_new, base_t, base_new, col0=col0, bsz=bsz,
                        plan=plan, part=part)
        fused_iteration_cuda.launches += 1
        sl = slice(col0, col0 + bsz)
        block_sweep_cuda(
            base_new[..., sl, :], sig_t[..., sl, sl], w_t[..., sl, :], scale_t[..., sl, :],
            zero_t[..., sl, :], n_levels=n_levels, quantize=quantize,
            out=(w_new[..., sl, :], delta_new[..., sl, :]), sweep_plan=sweep_plan,
        )
    return w_new, base_new, delta_new


fused_iteration_cuda.launches = 0


def outlier_iteration_cuda(
    base_t, sig_t, sig_corr, w_t, scale_t, zero_t, delta_prev_t, dh_prev_t, *,
    n_levels: int, quantize: bool, bsz: int, plan=None, sweep_plan=None,
):
    """One outlier-aware CD iteration (Algorithm 3's Ŵ sweep plus its exact
    residual), operands and plans as :func:`fused_iteration_cuda` plus
    ``dh_prev_t``, the previous IHT step's dĤᵀ.  The suffix residual runs on
    the plan's tile.

    Returns ``(w_new_t, base_new_t, delta_pure_t, r_t)``.  ``.launches``
    counts this kernel's own launches: one correction per column block and
    the suffix residual (the sweeps count on :func:`block_sweep_cuda`).
    """
    state = {"base_t": base_t, "w_t": w_t, "scale_t": scale_t, "zero_t": zero_t,
             "delta_prev_t": delta_prev_t, "dh_prev_t": dh_prev_t}
    dev, G, p_pad, q = _check_iteration("outlier_iteration_cuda", state, sig_t, sig_corr, bsz)
    plan, part = _corr_plan(dev, G, q, bsz, p_pad, sig_corr.dtype == torch.bfloat16, True, plan)
    sweep_plan = _sweep_plan(dev, G, q, bsz, sweep_plan)
    w_new = torch.empty_like(base_t)
    base_new = torch.empty_like(base_t)
    dpure = torch.empty_like(base_t)
    r = torch.empty_like(base_t)
    for col0 in range(0, p_pad, bsz):
        correction_cuda(sig_corr, delta_prev_t, dpure, base_t, base_new, col0=col0, bsz=bsz,
                        plan=plan, part=part, dh_t=dh_prev_t)
        outlier_iteration_cuda.launches += 1
        sl = slice(col0, col0 + bsz)
        block_sweep_cuda(
            base_new[..., sl, :], sig_t[..., sl, sl], w_t[..., sl, :], scale_t[..., sl, :],
            zero_t[..., sl, :], n_levels=n_levels, quantize=quantize,
            out=(w_new[..., sl, :], dpure[..., sl, :]), sweep_plan=sweep_plan,
        )
    suffix_cuda(sig_corr, dpure, base_new, r, bsz=bsz, tile_rows=plan[0])
    outlier_iteration_cuda.launches += 1
    return w_new, base_new, dpure, r


outlier_iteration_cuda.launches = 0
