"""RTN (round-to-nearest) baseline (the port's ``repro.core.rtn``).

Quantizes each weight independently to its nearest grid point; no use of
calibration data.  The weakest baseline of the paper's tables.
"""

from __future__ import annotations

import torch

from repro_torch.quant import GridSpec, compute_grid, quantize_dequantize

__all__ = ["rtn_quantize"]


def rtn_quantize(w: torch.Tensor, spec: GridSpec) -> torch.Tensor:
    """W: (q, p) → nearest-grid Ŵ (fp32)."""
    grid = compute_grid(w, spec)
    return quantize_dequantize(w.to(torch.float32), grid)
