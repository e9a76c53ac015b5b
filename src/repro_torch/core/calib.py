"""Calibration statistics for layer-wise PTQ.

Every algorithm here consumes only ``Σ = X Xᵀ`` (p×p) of the calibration
activations, never the raw ``X``.  :class:`CalibStats` folds each batch
into an fp32 Σ the moment it is seen (streaming capture).

Sharded accumulation: under a data mesh each rank holds its own token rows
(its block of the calibration sequences), contracts them into its local
Gram matrix in fp32, and an ``all_reduce`` over the mesh's data dim makes
Σ global (:func:`sharded_gram`, the reference's ``shard_map`` + ``psum``).
The collective hands every rank the same sum, so every rank holds the same
bits.  With no mesh, or one rank, it is the local ``XᵀX``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.collectives import all_reduce, axis_size

__all__ = ["CalibStats", "gram", "sharded_gram", "shard_axis", "damp_sigma"]


def gram(x: torch.Tensor) -> torch.Tensor:
    """Σ = X Xᵀ for X: (p, n), fp32 accumulation whatever the input dtype."""
    x = x.to(torch.float32)
    return x @ x.T


def shard_axis(mesh) -> Optional[str]:
    """The mesh dim PTQ shards over: "data" if present, else the first.
    One source for the Σ accumulation and the row-sharded CD solve, so they
    engage (or fall back) together."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    return "data" if "data" in names else names[0]


def sharded_gram(x2d: torch.Tensor, mesh=None, axis: Optional[str] = None) -> torch.Tensor:
    """Σ = XᵀX for X: (n, p) token-major, where each rank of the mesh dim
    ``axis`` (default :func:`shard_axis`) holds its own rows: the local
    Gram matrix in fp32, then an ``all_reduce`` (sum) over the dim.  Ranks
    may hold different row counts.  With ``mesh=None`` or a dim of size 1
    it is the local ``x.T @ x``."""
    x2d = x2d.to(torch.float32)
    g = x2d.T @ x2d
    axis = axis or shard_axis(mesh)
    if axis_size(mesh, axis) > 1:
        all_reduce(g, mesh, axis)
    return g


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

    def update_tokens(self, x_tokens: torch.Tensor, mesh=None) -> "CalibStats":
        """x_tokens: (..., p) activations in model layout; with a mesh, this
        rank's rows, reduced over the mesh by :func:`sharded_gram` (``n``
        then counts this rank's rows)."""
        x2 = x_tokens.reshape(-1, x_tokens.shape[-1])
        return CalibStats(sigma=self.sigma + sharded_gram(x2, mesh), n=self.n + x2.shape[0])

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
