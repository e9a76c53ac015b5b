"""Calibration statistics for layer-wise PTQ.

Every algorithm here consumes only ``Σ = X Xᵀ`` (p×p) of the calibration
activations, never the raw ``X``.  :class:`CalibStats` folds each batch
into an fp32 Σ the moment it is seen (streaming capture).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

__all__ = ["CalibStats", "gram", "damp_sigma"]


def gram(x: torch.Tensor) -> torch.Tensor:
    """Σ = X Xᵀ for X: (p, n), fp32 accumulation whatever the input dtype."""
    x = x.to(torch.float32)
    return x @ x.T


@dataclasses.dataclass
class CalibStats:
    """Streaming Σ accumulator for one linear layer (unnormalized Gram; the
    algorithms are scale-invariant in Σ).  ``n`` counts samples."""

    sigma: torch.Tensor  # (p, p), or (E, p, p) for expert-stacked MoE linears; fp32
    n: int = 0

    @classmethod
    def zeros(cls, p: int, experts: int = 0, device="cuda") -> "CalibStats":
        """An empty Σ on ``device`` (the card unless the caller asks for the
        CPU, as every entry point of the port), one per expert if
        ``experts``."""
        shape = (experts, p, p) if experts else (p, p)
        return cls(sigma=torch.zeros(shape, dtype=torch.float32, device=resolve_device(device)),
                   n=0)

    @property
    def p(self) -> int:
        return self.sigma.shape[-1]

    def update_tokens(self, x_tokens: torch.Tensor) -> "CalibStats":
        """x_tokens: (..., p) activations in model layout."""
        x2 = x_tokens.reshape(-1, x_tokens.shape[-1]).to(torch.float32)
        return CalibStats(sigma=self.sigma + x2.T @ x2, n=self.n + x2.shape[0])

    def update_expert_tokens(self, x_experts: torch.Tensor) -> "CalibStats":
        """x_experts: (E, C, p), an MoE dispatch table.  Every slot counts,
        the empty ones included: the table fills those with the group's
        token 0 (``models.moe``), so each adds that token's x₀x₀ᵀ to its
        expert's Σ, as in the reference."""
        x32 = x_experts.to(torch.float32)
        return CalibStats(sigma=self.sigma + x32.transpose(1, 2) @ x32,
                          n=self.n + x_experts.shape[1])


def damp_sigma(sigma: torch.Tensor, percdamp: float = 0.01) -> torch.Tensor:
    """Σ + λI with λ = percdamp · mean(diag Σ), per matrix for batched Σ."""
    p = sigma.shape[-1]
    diag = torch.diagonal(sigma, dim1=-2, dim2=-1)
    mean_diag = torch.clamp_min(diag.mean(-1), 1e-8)
    eye = torch.eye(p, dtype=sigma.dtype, device=sigma.device)
    return sigma + (percdamp * mean_diag)[..., None, None] * eye
