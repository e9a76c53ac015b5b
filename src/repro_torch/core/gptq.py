"""GPTQ baseline (Frantar et al., 2023): OBS column sweep with lazy batching.

One pass over the columns j = 1..p: quantize column j, then carry its OBS
correction to the columns not yet quantized through the upper Cholesky
factor U of ``H⁻¹`` (H = damped Σ).  Inside the active block of
``block_size`` columns the corrections go column by column; the trailing
columns take one batched matmul per block (the "lazy batch").

The reference computes GPTQ in plain ``jnp``, outside any Pallas kernel,
so here ``torch.linalg.inv``, ``torch.linalg.cholesky`` and ``torch.matmul``
carry it: the column sweep is a Python loop over a block's columns on
``(G, q, block_size)`` tensors, and the lazy update is one batched matmul
per block.  On the card that is a few small launches per column, so GPTQ
is host-bound at large p.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.calib import damp_sigma
from repro_torch.quant.grid import Grid, GridSpec, compute_grid

__all__ = ["gptq_quantize", "obs_sensitivity"]


def _quant_dequant_cols(w_cols, scale, zero, n_levels: int):
    codes = torch.clamp(torch.round(w_cols / scale) + zero, 0, n_levels - 1)
    return (codes - zero) * scale


def _cholesky_inv_upper(h: torch.Tensor) -> torch.Tensor:
    """Upper-triangular U with H⁻¹ = Uᵀ U (GPTQ's factor), batched."""
    return torch.linalg.cholesky(torch.linalg.inv(h)).mT


def gptq_quantize(
    w: torch.Tensor,
    sigma: torch.Tensor,
    spec: GridSpec,
    *,
    percdamp: float = 0.01,
    block_size: int = 128,
    act_order: bool = False,
    keep_mask: Optional[torch.Tensor] = None,
    grid: Optional[Grid] = None,
) -> torch.Tensor:
    """Quantize W: (q, p) against Σ: (p, p).  Returns the dequantized Ŵ (fp32).

    ``keep_mask``: optional (q, p) bool; True entries stay at full precision
    (the SpQR baseline's outliers): they absorb OBS corrections but are
    never rounded.  ``grid``: optional explicit grid, in the original column
    order.

    Batched: ``w: (G, q, p)`` with ``sigma: (G, p, p)`` solves G layers at
    once (``grid`` leaves ``(G, q, n_groups)``; ``keep_mask`` must be None).
    """
    if w.dim() == 3:
        if keep_mask is not None:
            raise ValueError("keep_mask unsupported on the batched path")
        return _gptq(w, sigma, spec, percdamp, block_size, act_order, None, grid)
    grid = None if grid is None else Grid(grid.spec, grid.scale[None], grid.zero[None])
    keep_mask = None if keep_mask is None else keep_mask[None]
    return _gptq(w[None], sigma[None], spec, percdamp, block_size, act_order, keep_mask, grid)[0]


def _permute_cols(a: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """a: (G, q, p), perm: (G, p) → a[g][:, perm[g]]."""
    return torch.take_along_dim(a, perm[:, None, :], dim=-1)


def _gptq(w, sigma, spec: GridSpec, percdamp, block_size, act_order, keep_mask, grid):
    G, q, p = w.shape
    w = w.to(torch.float32, copy=True)  # updated in place below
    sigma = damp_sigma(sigma.to(torch.float32), percdamp)

    perm = None
    if act_order:
        perm = torch.argsort(-torch.diagonal(sigma, dim1=-2, dim2=-1), dim=-1, stable=True)
        w = _permute_cols(w, perm)
        sigma = _permute_cols(torch.take_along_dim(sigma, perm[:, :, None], dim=-2), perm)
        if keep_mask is not None:
            keep_mask = _permute_cols(keep_mask, perm)

    if grid is None:
        grid = compute_grid(w, spec)  # from the (possibly permuted) w: aligned
        scale_pc, zero_pc = grid.per_column(p)
    else:
        scale_pc, zero_pc = grid.per_column(p)  # original column order
        if act_order:
            scale_pc, zero_pc = _permute_cols(scale_pc, perm), _permute_cols(zero_pc, perm)
    u = _cholesky_inv_upper(sigma)  # (G, p, p) upper

    bsz = block_size
    n_blocks = -(-p // bsz)
    pad = n_blocks * bsz - p
    if pad:
        # Padded columns: zero weight, unit scale, unit diagonal in U.
        padc = lambda a, v=0.0: torch.nn.functional.pad(a, (0, pad), value=v)
        w, scale_pc, zero_pc = padc(w), padc(scale_pc, 1.0), padc(zero_pc)
        if keep_mask is not None:
            keep_mask = padc(keep_mask, False)
        u = torch.nn.functional.pad(u, (0, pad, 0, pad))
        idx = torch.arange(p, p + pad, device=u.device)
        u[:, idx, idx] = 1.0
    p_pad = p + pad

    for col0 in range(0, p_pad, bsz):
        blk = slice(col0, col0 + bsz)
        w_blk = w[..., blk].clone()
        u_blk = u[:, blk, blk]
        err_blk = torch.empty(G, q, bsz, dtype=torch.float32, device=w.device)
        for i in range(bsz):
            c = col0 + i
            wc = w_blk[..., i]
            qc = _quant_dequant_cols(wc, scale_pc[..., c], zero_pc[..., c], spec.n_levels)
            if keep_mask is not None:
                qc = torch.where(keep_mask[..., c], wc, qc)
            err = (wc - qc) / u_blk[:, i, i, None]
            # Propagate inside the block, to the columns after i only.
            w_blk[..., i + 1 :] -= err[..., None] * u_blk[:, None, i, i + 1 :]
            w_blk[..., i] = qc
            err_blk[..., i] = err
        w[..., blk] = w_blk
        if col0 + bsz < p_pad:
            # Lazy-batch correction of every trailing column: one matmul.
            w[..., col0 + bsz :] -= err_blk @ u[:, blk, col0 + bsz :]

    w = w[..., :p]
    if act_order:
        w = _permute_cols(w, torch.argsort(perm, dim=-1))
    return w


def obs_sensitivity(w, sigma, w_rtn, *, percdamp: float = 0.01) -> torch.Tensor:
    """OBS saliency ω_ij = (W_ij − q(W_ij))² / [H⁻¹]_jj (SpQR Eq. 15)."""
    sigma = damp_sigma(sigma.to(torch.float32), percdamp)
    hinv_diag = torch.diagonal(torch.linalg.inv(sigma), dim1=-2, dim2=-1)
    return (w.to(torch.float32) - w_rtn) ** 2 / hinv_diag[..., None, :]
