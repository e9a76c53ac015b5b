"""CUDA wrappers: QuantEase block sweep and fused CD iteration.

* :func:`block_sweep_cuda` launches ``qe_block_sweep_kernel``, the sweep of
  one column block (replaces ``quantease_block_sweep_pallas``).
* :func:`fused_iteration_cuda` runs one whole CD iteration (replaces
  ``quantease_fused_iteration_pallas``): for each column block in order it
  launches ``qe_block_corr_kernel`` (the full-width rolling-Δ correction,
  whose result is both β0 and the next base) and then the block sweep.
* :func:`outlier_iteration_cuda` runs one outlier-aware CD iteration
  (replaces ``quantease_outlier_iteration_t_pallas``): the same two
  launches per block with the correction's ``−dĤ_prev`` terms, then
  ``qe_suffix_resid_kernel`` once for the exact residual R.

Both take the transposed layout of ``csrc/quantease_cd.cu``: per-row
operands are ``(G, rows, q)`` or ``(rows, q)`` with q contiguous.  Each
wrapper counts its launches in ``.launches``.  They accept CUDA tensors
only; :mod:`repro_torch.kernels.ops` routes CPU tensors to the plain
versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["block_sweep_cuda", "fused_iteration_cuda", "outlier_iteration_cuda", "MAX_BLOCK"]

MAX_BLOCK = 256  # the sweep kernel prefetches a Σ̃ row as 8 registers per lane
_TILE = 64  # the correction SGEMM's output tile (rows of the block x q)
_MIN_K_CHUNK = 1024  # the shortest k range a split of the correction gets


def _corr_scratch(dev, G: int, q: int, bsz: int, p_pad: int):
    """Split-K of the per-block correction: ``(splits, scratch)``.

    A block's correction has ``ceil(q/64)·ceil(B/64)·G`` output tiles; where
    that is fewer than two per SM, its k range is split (into chunks of at
    least ``_MIN_K_CHUNK``) until it is not, and ``scratch`` holds the
    partial sums.  One split needs no scratch.
    """
    tiles = -(-q // _TILE) * -(-bsz // _TILE) * G
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = max(1, min(-(-2 * n_sm // tiles), p_pad // _MIN_K_CHUNK))
    if splits == 1:
        return 1, None
    return splits, torch.empty(splits * G * bsz * q, dtype=torch.float32, device=dev)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda(tensors: dict, device: torch.device) -> None:
    for name, t in tensors.items():
        _require(t.device == device, f"{name} is on {t.device}, expected {device}")


def block_sweep_cuda(
    beta0_t, sig_t, w_old_t, scale_t, zero_t, *, n_levels: int, quantize: bool, out=None
):
    """Sweep the B columns of one block for G groups at once.

    ``beta0_t``, ``w_old_t``, ``scale_t``, ``zero_t``: ``(G, B, q)`` or
    ``(B, q)`` fp32 with identical strides and q contiguous; ``sig_t``:
    ``(G, B, B)`` or ``(B, B)`` fp32, row i = Σ̃_blk[:, i], last dim
    contiguous.  ``out``: optional ``(w_new_t, delta_t)`` with the same
    strides as ``beta0_t`` (views into the fused iteration's outputs);
    otherwise the inputs must be contiguous and outputs are allocated.
    Returns ``(w_new_t, delta_t)``.
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
    gs = beta0_t.stride(0) if batched else 0
    sig_gs = sig_t.stride(0) if batched else 0
    lib = build.load("quantease_cd")
    err = lib.qe_block_sweep(
        beta0_t.data_ptr(), sig_t.data_ptr(), w_old_t.data_ptr(), scale_t.data_ptr(),
        zero_t.data_ptr(), w_new.data_ptr(), delta.data_ptr(),
        G, q, bsz, gs, sig_gs, sig_t.stride(-2), int(n_levels), int(bool(quantize)),
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


def fused_iteration_cuda(
    base_t, sig_t, sig_corr, w_t, scale_t, zero_t, delta_prev_t, *,
    n_levels: int, quantize: bool, bsz: int,
):
    """One whole CD iteration of the fused engine.

    Per-row state: ``(G, p_pad, q)`` or ``(p_pad, q)`` contiguous fp32;
    ``sig_t``: Σ̃ᵀ ``(G, p_pad, p_pad)`` fp32 (diagonal blocks for the
    sweep); ``sig_corr``: Σ̃ᵀ in the correction dtype, fp32 or bf16.
    Returns ``(w_new_t, base_new_t, delta_new_t)``.  ``.launches`` counts
    correction launches, one per column block.
    """
    state = {"base_t": base_t, "w_t": w_t, "scale_t": scale_t, "zero_t": zero_t,
             "delta_prev_t": delta_prev_t}
    dev, G, p_pad, q = _check_iteration("fused_iteration_cuda", state, sig_t, sig_corr, bsz)
    w_new = torch.empty_like(base_t)
    base_new = torch.empty_like(base_t)
    delta_new = torch.empty_like(base_t)
    splits, part = _corr_scratch(dev, G, q, bsz, p_pad)
    part_ptr = None if part is None else part.data_ptr()
    lib = build.load("quantease_cd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_bf16 = int(sig_corr.dtype == torch.bfloat16)
    for col0 in range(0, p_pad, bsz):
        err = lib.qe_block_corr(
            sig_corr.data_ptr(), is_bf16, delta_prev_t.data_ptr(), delta_new.data_ptr(),
            base_t.data_ptr(), base_new.data_ptr(), part_ptr, splits, G, p_pad, q, col0, bsz,
            stream, dev.index,
        )
        build.check(err, "qe_block_corr")
        fused_iteration_cuda.launches += 1
        sl = slice(col0, col0 + bsz)
        block_sweep_cuda(
            base_new[..., sl, :], sig_t[..., sl, sl], w_t[..., sl, :], scale_t[..., sl, :],
            zero_t[..., sl, :], n_levels=n_levels, quantize=quantize,
            out=(w_new[..., sl, :], delta_new[..., sl, :]),
        )
    return w_new, base_new, delta_new


fused_iteration_cuda.launches = 0


def outlier_iteration_cuda(
    base_t, sig_t, sig_corr, w_t, scale_t, zero_t, delta_prev_t, dh_prev_t, *,
    n_levels: int, quantize: bool, bsz: int,
):
    """One outlier-aware CD iteration (Algorithm 3's Ŵ sweep plus its exact
    residual), operands as :func:`fused_iteration_cuda` plus ``dh_prev_t``,
    the previous IHT step's dĤᵀ.

    Returns ``(w_new_t, base_new_t, delta_pure_t, r_t)``.  ``.launches``
    counts this kernel's own launches: one correction per column block and
    the suffix residual (the sweeps count on :func:`block_sweep_cuda`).
    """
    state = {"base_t": base_t, "w_t": w_t, "scale_t": scale_t, "zero_t": zero_t,
             "delta_prev_t": delta_prev_t, "dh_prev_t": dh_prev_t}
    dev, G, p_pad, q = _check_iteration("outlier_iteration_cuda", state, sig_t, sig_corr, bsz)
    w_new = torch.empty_like(base_t)
    base_new = torch.empty_like(base_t)
    dpure = torch.empty_like(base_t)
    r = torch.empty_like(base_t)
    splits, part = _corr_scratch(dev, G, q, bsz, p_pad)
    part_ptr = None if part is None else part.data_ptr()
    lib = build.load("quantease_cd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_bf16 = int(sig_corr.dtype == torch.bfloat16)
    for col0 in range(0, p_pad, bsz):
        err = lib.qe_outlier_corr(
            sig_corr.data_ptr(), is_bf16, delta_prev_t.data_ptr(), dpure.data_ptr(),
            dh_prev_t.data_ptr(), base_t.data_ptr(), base_new.data_ptr(), part_ptr, splits, G,
            p_pad, q, col0, bsz, stream, dev.index,
        )
        build.check(err, "qe_outlier_corr")
        outlier_iteration_cuda.launches += 1
        sl = slice(col0, col0 + bsz)
        block_sweep_cuda(
            base_new[..., sl, :], sig_t[..., sl, sl], w_t[..., sl, :], scale_t[..., sl, :],
            zero_t[..., sl, :], n_levels=n_levels, quantize=quantize,
            out=(w_new[..., sl, :], dpure[..., sl, :]),
        )
    err = lib.qe_suffix_resid(
        sig_corr.data_ptr(), is_bf16, dpure.data_ptr(), base_new.data_ptr(), r.data_ptr(),
        G, p_pad, q, bsz, stream, dev.index,
    )
    build.check(err, "qe_suffix_resid")
    outlier_iteration_cuda.launches += 1
    return w_new, base_new, dpure, r


outlier_iteration_cuda.launches = 0
