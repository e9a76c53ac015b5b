"""Uniform per-channel / per-group quantization grids.

Each output channel ``i`` of ``W ∈ R^{q×p}`` is quantized onto the affine
grid ``Q_i = { s_i * (c - z_i) : c ∈ {0, …, 2^bits - 1} }``, one ``(s, z)``
pair per contiguous group of ``group_size`` input columns (``None``: one
group spanning the row).  Columns map to groups by ``col // group_size``, so
a ragged tail group is as wide as what is left.

All math is fp32 and every function accepts leading batch dims
``(..., q, p)``.  Rounding is half to even (``torch.round``), as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "GridSpec",
    "Grid",
    "compute_grid",
    "compute_grid_excluding_outliers",
    "quantize_codes",
    "dequantize_codes",
    "quantize_dequantize",
]


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of a grid: code width, symmetry, group size."""

    bits: int = 4
    symmetric: bool = False
    group_size: Optional[int] = None

    def __post_init__(self):
        if self.bits not in (2, 3, 4, 8):
            raise ValueError(f"unsupported bit-width {self.bits}")
        if self.group_size is not None and self.group_size <= 0:
            raise ValueError("group_size must be positive")

    @property
    def n_levels(self) -> int:
        return 1 << self.bits

    def n_groups(self, p: int) -> int:
        g = self.group_size or p
        return -(-p // g)


@dataclasses.dataclass
class Grid:
    """Per-(row, group) ``scale``/``zero``, fp32 ``(..., q, n_groups)``."""

    spec: GridSpec
    scale: torch.Tensor
    zero: torch.Tensor

    def per_column(self, p: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Expand ``(..., q, n_groups)`` → ``(..., q, p)`` per-column views."""
        g = self.spec.group_size or p
        idx = torch.arange(p, device=self.scale.device) // g
        return self.scale[..., idx], self.zero[..., idx]

    def __getitem__(self, i) -> "Grid":
        return Grid(self.spec, self.scale[i], self.zero[i])


def _group_reduce(w: torch.Tensor, group_size: Optional[int], fn) -> torch.Tensor:
    """Reduce ``(..., q, p)`` → ``(..., q, n_groups)`` with ``fn`` per group;
    the ragged tail pads with its edge value, which never widens a range."""
    p = w.shape[-1]
    g = group_size or p
    n_groups = -(-p // g)
    pad = n_groups * g - p
    if pad:
        w = torch.cat([w, w[..., -1:].expand(*w.shape[:-1], pad)], dim=-1)
    return fn(w.reshape(*w.shape[:-1], n_groups, g), -1)


def compute_grid(w: torch.Tensor, spec: GridSpec) -> Grid:
    """Min/max (or symmetric max-abs) grid from the weights themselves."""
    w = w.to(torch.float32)
    n = spec.n_levels - 1
    if spec.symmetric:
        amax = _group_reduce(w.abs(), spec.group_size, lambda a, d: a.amax(d))
        scale = torch.clamp_min(2.0 * amax / n, 1e-12)
        zero = torch.full_like(scale, float(1 << (spec.bits - 1)))
    else:
        wmin = torch.clamp_max(_group_reduce(w, spec.group_size, lambda a, d: a.amin(d)), 0.0)
        wmax = torch.clamp_min(_group_reduce(w, spec.group_size, lambda a, d: a.amax(d)), 0.0)
        scale = torch.clamp_min((wmax - wmin) / n, 1e-12)
        zero = torch.round(-wmin / scale)
    return Grid(spec=spec, scale=scale, zero=zero)


def compute_grid_excluding_outliers(
    w: torch.Tensor, spec: GridSpec, outlier_mask: torch.Tensor
) -> Grid:
    """Grid over non-outlier weights only (QuantEase §4.3 range shrink).

    ``outlier_mask`` is boolean, shaped like ``w``, True where the weight is
    an outlier: those weights leave the quantization pool before the
    per-channel ranges are taken, since Ĥ carries them."""
    w = w.to(torch.float32)
    n = spec.n_levels - 1
    keep = ~outlier_mask
    zeros = torch.zeros((), dtype=torch.float32, device=w.device)
    if spec.symmetric:
        amax = _group_reduce(torch.where(keep, w.abs(), zeros), spec.group_size,
                             lambda a, d: a.amax(d))
        scale = torch.clamp_min(2.0 * amax / n, 1e-12)
        zero = torch.full_like(scale, float(1 << (spec.bits - 1)))
    else:
        big = torch.tensor(3.4e38, dtype=torch.float32, device=w.device)
        wmin = torch.clamp_max(
            _group_reduce(torch.where(keep, w, big), spec.group_size, lambda a, d: a.amin(d)), 0.0)
        wmax = torch.clamp_min(
            _group_reduce(torch.where(keep, w, -big), spec.group_size, lambda a, d: a.amax(d)), 0.0)
        scale = torch.clamp_min((wmax - wmin) / n, 1e-12)
        zero = torch.round(-wmin / scale)
    return Grid(spec=spec, scale=scale, zero=zero)


def quantize_codes(w: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Nearest-grid-point codes: ``(..., q, p)`` float → uint8."""
    scale, zero = grid.per_column(w.shape[-1])
    n = grid.spec.n_levels - 1
    codes = torch.clamp(torch.round(w.to(torch.float32) / scale) + zero, 0, n)
    return codes.to(torch.uint8)


def dequantize_codes(codes: torch.Tensor, grid: Grid, dtype=torch.float32) -> torch.Tensor:
    scale, zero = grid.per_column(codes.shape[-1])
    return ((codes.to(torch.float32) - zero) * scale).to(dtype)


def quantize_dequantize(w: torch.Tensor, grid: Grid) -> torch.Tensor:
    """The paper's operator ``q_i(·)`` (Eq. 2): fp32 → nearest grid value."""
    scale, zero = grid.per_column(w.shape[-1])
    n = grid.spec.n_levels - 1
    codes = torch.clamp(torch.round(w.to(torch.float32) / scale) + zero, 0, n)
    return (codes - zero) * scale
