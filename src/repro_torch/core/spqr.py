"""SpQR-style baseline (Dettmers et al., 2023) as described in QuantEase
§4.2 (the port's copy of ``repro.core.spqr``).

1. OBS saliency against the plain RTN grid,
   ω_ij = (W_ij − q(W_ij))² / [H⁻¹]_jj (:func:`obs_sensitivity`);
2. the s most salient entries are the outliers (ties go to the lower flat
   index, as ``jax.lax.top_k``'s);
3. GPTQ with those entries kept at full precision, on a grid whose range
   excludes them.

Unlike outlier-aware QuantEase the outlier set is fixed after step 2 — the
structural difference the paper credits for QuantEase's gain (§4.3).
"""

from __future__ import annotations

import torch

from repro_torch.core.gptq import gptq_quantize, obs_sensitivity
from repro_torch.quant.grid import (
    GridSpec,
    compute_grid,
    compute_grid_excluding_outliers,
    quantize_dequantize,
)

__all__ = ["spqr_quantize", "top_s_lowest_index"]


def top_s_lowest_index(a: torch.Tensor, s: int) -> torch.Tensor:
    """Boolean mask of the s largest entries of ``a``, ties broken toward
    the lower flat index (``jax.lax.top_k``'s rule)."""
    flat = a.reshape(-1)
    idx = torch.sort(flat, descending=True, stable=True).indices[:s]
    return torch.zeros_like(flat, dtype=torch.bool).index_fill_(0, idx, True).reshape(a.shape)


def spqr_quantize(w, sigma, spec: GridSpec, *, s: int, percdamp: float = 0.01,
                  block_size: int = 128):
    """Returns ``(Ŵ_eff fp32 (q, p), outlier mask bool (q, p))``; ``s`` is
    the number of outliers."""
    w = w.to(torch.float32)
    w_rtn = quantize_dequantize(w, compute_grid(w, spec))
    mask = top_s_lowest_index(obs_sensitivity(w, sigma, w_rtn, percdamp=percdamp), s)
    grid = compute_grid_excluding_outliers(w, spec, mask)
    w_hat = gptq_quantize(w, sigma, spec, percdamp=percdamp, block_size=block_size,
                          keep_mask=mask, grid=grid)
    return w_hat, mask
