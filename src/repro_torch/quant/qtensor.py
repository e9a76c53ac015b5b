"""QuantizedTensor: codes plus an affine grid, as carried by quantized
parameters.

A linear layer computes ``y = x @ Wᵀ`` with ``W: (q, p)`` (out, in).  The
tensor stores ``codes`` (``(q, p)`` uint8, or ``(q, p/2)`` packed two per
byte for 4 bits) and ``scale``/``zero`` (``(q, n_groups)`` fp32).  Leading
dims (a period stack) are allowed on every field.  The outlier fields keep
the reference's schema; the port's path leaves them ``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.quant.grid import Grid, GridSpec

__all__ = ["QuantizedTensor", "dequantize_tensor"]


@dataclasses.dataclass
class QuantizedTensor:
    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int = 4
    group_size: Optional[int] = None
    packed: bool = False
    pack_layout: str = "linear"
    pack_tile: Optional[int] = None
    outlier_values: Optional[torch.Tensor] = None
    outlier_idx: Optional[torch.Tensor] = None
    outlier_col_idx: Optional[torch.Tensor] = None
    outlier_col_vals: Optional[torch.Tensor] = None

    @property
    def shape(self) -> tuple:
        if self.packed:
            return (*self.codes.shape[:-1], self.codes.shape[-1] * (8 // self.bits))
        return tuple(self.codes.shape)

    def unpacked_codes(self) -> torch.Tensor:
        if not self.packed:
            return self.codes
        from repro_torch.quant.pack import unpack_codes

        if self.pack_layout != "linear":
            raise NotImplementedError("the port reads the linear pack layout only")
        return unpack_codes(self.codes, self.bits, self.shape[-1])

    @property
    def spec(self) -> GridSpec:
        return GridSpec(bits=self.bits, group_size=self.group_size)

    @property
    def grid(self) -> Grid:
        return Grid(spec=self.spec, scale=self.scale, zero=self.zero)

    def map_arrays(self, fn) -> "QuantizedTensor":
        """Apply ``fn`` to every array field (slicing a period, a device move)."""
        kw = {
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **kw)


def dequantize_tensor(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    if qt.outlier_values is not None or qt.outlier_col_idx is not None:
        raise NotImplementedError("outlier planes arrive with Algorithm 3's slice")
    scale, zero = qt.grid.per_column(qt.shape[-1])
    return ((qt.unpacked_codes().to(torch.float32) - zero) * scale).to(dtype)
