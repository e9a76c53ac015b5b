"""AWQ baseline (Lin et al., 2023) as described in QuantEase §2.2.2 (the
port's copy of ``repro.core.awq``).

AWQ searches a per-input-channel scaling ``s ∈ R^p`` minimizing
``‖WX − q(s⊙W)(X⊙s⁻¹)‖²_F`` over the family ``s = s_X^α · s_W^{−β}``, α
(and β) grid-searched over [0, 1]; ``s_X`` is read from diag Σ and ``s_W``
is the per-channel mean |W|, each normalized by its geometric mean.  The
effective weight is ``Ŵ = q(s⊙W) ⊙ s⁻¹``, so each candidate's error is
``Tr(EΣEᵀ)`` with ``E = W − Ŵ``, from Σ alone (a fp32 ``torch.matmul``).

:func:`awq_then_quantease` (paper §6) runs QuantEase on the scaled problem
``W' = s⊙W``, ``Σ' = diag(1/s) Σ diag(1/s)`` and returns ``Ŵs ⊙ s⁻¹``;
on CUDA tensors its solve runs the CD kernels.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantease
from repro_torch.quant.grid import GridSpec, compute_grid, quantize_dequantize

__all__ = ["awq_quantize", "awq_then_quantease", "awq_search"]


def _candidate_error(w, sigma, spec: GridSpec, s):
    """Error of quantizing with column scaling s ``(p,)``; returns
    ``(Tr(EΣEᵀ), Ŵ)``."""
    ws = w * s[None, :]
    wq = quantize_dequantize(ws, compute_grid(ws, spec)) / s[None, :]
    e = w - wq
    return ((e @ sigma) * e).sum(), wq


def _geo_normalized(v):
    return v / torch.exp(torch.mean(torch.log(v)))


def _linspace01(n: int, device) -> torch.Tensor:
    # Rounded from float64, as jnp.linspace's fp32 points are (torch's fp32
    # linspace differs from them by an ulp at some interior points).
    return torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=device).to(torch.float32)


def _scales(w, sigma):
    sx = _geo_normalized(torch.sqrt(torch.clamp_min(torch.diagonal(sigma), 1e-12)))
    sw = torch.mean(w.abs(), dim=0)
    sw = sw / torch.exp(torch.mean(torch.log(torch.clamp_min(sw, 1e-12))))
    return sx, sw


def awq_search(w, sigma, spec: GridSpec, *, n_grid: int = 20, search_beta: bool = False):
    """The grid search: ``(candidates (n, 2) of (α, β), errors (n,), s_X,
    s_W)``.  The reference's order: α outer, β inner."""
    w = w.to(torch.float32)
    sigma = sigma.to(torch.float32)
    sx, sw = _scales(w, sigma)
    alphas = _linspace01(n_grid, w.device)
    betas = _linspace01(n_grid, w.device) if search_beta else torch.zeros(1, device=w.device)
    cands = torch.stack([alphas.repeat_interleave(betas.shape[0]), betas.repeat(alphas.shape[0])], 1)
    errs = torch.stack([
        _candidate_error(w, sigma, spec, torch.clamp(sx ** a * sw ** (-b), 1e-6, 1e6))[0]
        for a, b in cands
    ])
    return cands, errs, sx, sw


def awq_quantize(w, sigma, spec: GridSpec, *, n_grid: int = 20, search_beta: bool = False):
    """Grid-search α (and, with ``search_beta``, β) and return the best
    dequantized Ŵ ``(q, p)`` fp32.  ``search_beta=False`` (AWQ's published
    default) searches s = s_X^α only."""
    w = w.to(torch.float32)
    sigma = sigma.to(torch.float32)
    cands, errs, sx, sw = awq_search(w, sigma, spec, n_grid=n_grid, search_beta=search_beta)
    a, b = cands[torch.argmin(errs)]
    return _candidate_error(w, sigma, spec, torch.clamp(sx ** a * sw ** (-b), 1e-6, 1e6))[1]


def awq_then_quantease(w, sigma, spec: GridSpec, *, n_grid: int = 20, iterations: int = 20,
                       percdamp: float = 0.01):
    """AWQ's α search, then QuantEase CD on the scaled problem; returns the
    effective Ŵ ``(q, p)`` fp32 (off any single uniform grid: column j is
    scaled by 1/s_j)."""
    w = w.to(torch.float32)
    sigma = sigma.to(torch.float32)
    cands, errs, sx, _ = awq_search(w, sigma, spec, n_grid=n_grid)
    s = torch.clamp(sx ** cands[torch.argmin(errs), 0], 1e-6, 1e6)
    ws = w * s[None, :]
    sigma_s = sigma / s[:, None] / s[None, :]
    ws_hat, _ = quantease.quantease_quantize(ws, sigma_s, spec, iterations=iterations,
                                             percdamp=percdamp)
    return ws_hat / s[None, :]
