"""QuantizedTensor: codes plus an affine grid, as carried by quantized
parameters.

A linear layer computes ``y = x @ Wᵀ`` with ``W: (q, p)`` (out, in).  The
tensor stores ``codes`` (``(q, p)`` uint8, or ``(q, p/2)`` packed two per
byte for 4 bits) and ``scale``/``zero`` (``(q, n_groups)`` fp32).  Leading
dims (a period stack) are allowed on every field.

Outlier-aware QuantEase (Algorithm 3) adds Ĥ as planes beside the codes:
unstructured outliers as COO (``outlier_idx``: flat int32 ``row·p + col``,
``outlier_values``: fp16), added after the dequant; structured outliers as
whole columns (``outlier_col_idx``: ``(c,)`` int32, ``outlier_col_vals``:
``(q, c)``), which replace the dequantized columns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.quant.grid import Grid, GridSpec

__all__ = ["QuantizedTensor", "dequantize_tensor", "check_zero_points"]


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

    def bits_per_weight(self) -> float:
        """Average storage bits per weight with the outlier overhead (paper
        §5.4 accounting: an unstructured outlier costs a 16-bit value and a
        32-bit index, a structured one a 16-bit value)."""
        n = 1
        for d in self.shape:
            n *= d
        total = float(n * self.bits) + self.scale.numel() * 32 * 2  # scales + zeros
        if self.outlier_values is not None:
            total += self.outlier_values.numel() * (16 + 32)
        if self.outlier_col_idx is not None:
            total += self.outlier_col_vals.numel() * 16
        return total / n

    def map_arrays(self, fn) -> "QuantizedTensor":
        """Apply ``fn`` to every array field (slicing a period, a device move)."""
        kw = {
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        return dataclasses.replace(self, **kw)


def dequantize_tensor(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """``(codes − z)·s``, then the COO outliers added and the structured
    outlier columns set, in fp32; leading (stack) dims allowed."""
    q, p = qt.shape[-2:]
    scale, zero = qt.grid.per_column(p)
    w = (qt.unpacked_codes().to(torch.float32) - zero) * scale
    if qt.outlier_values is not None:
        flat = w.reshape(-1, q * p)
        idx = qt.outlier_idx.reshape(flat.shape[0], -1).long()
        vals = qt.outlier_values.reshape(flat.shape[0], -1).to(torch.float32)
        w = flat.scatter_add(1, idx, vals).reshape(w.shape)
    if qt.outlier_col_idx is not None:
        cols = qt.outlier_col_idx.long()
        cols = cols[..., None, :].expand(*cols.shape[:-1], q, cols.shape[-1])
        w = w.scatter(-1, cols, qt.outlier_col_vals.to(torch.float32))
    return w.to(dtype)


def check_zero_points(qt: QuantizedTensor) -> None:
    """Raise ``ValueError`` unless every zero point is an integer in
    ``[0, 2^bits − 1]``.

    The dequant-GEMM's tensor-core variants rely on it (``c − z`` is then an
    exact bf16 integer and the scale factors out of each group's sum), and
    every grid ``compute_grid``/``compute_grid_excluding_outliers`` make
    satisfies it.  One host sync: call it where an artifact enters the port,
    not per GEMM."""
    z = qt.zero
    ok = (z == torch.round(z)) & (z >= 0) & (z <= (1 << qt.bits) - 1)
    if not bool(ok.all()):
        bad = z[~ok].flatten()[:4].tolist()
        raise ValueError(
            f"zero points must be integers in [0, {(1 << qt.bits) - 1}] for {qt.bits}-bit codes; "
            f"found {bad}"
        )
