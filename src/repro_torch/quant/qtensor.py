"""QuantizedTensor: codes plus an affine grid, as carried by quantized
parameters.

A linear layer computes ``y = x @ Wᵀ`` with ``W: (q, p)`` (out, in).  The
tensor stores ``codes`` (``(q, p)`` uint8, or ``(q, p/2)`` packed two per
byte for 4 bits) and ``scale``/``zero`` (``(q, n_groups)`` fp32).  Leading
dims (a period stack) are allowed on every field.

Packed codes are in the linear layout, or, in an artifact the reference
prepacked for its TPU GEMM, the tile-native one (``pack_layout="tile"``,
``pack_tile`` the k-tile); :meth:`QuantizedTensor.unpacked_codes` reads
both, and :func:`as_linear_layout` rewrites a tile leaf as linear once,
where it enters the port (the dequant-GEMM reads the linear layout).

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

from repro_torch.quant.grid import Grid, GridSpec, compute_grid, quantize_codes
from repro_torch.tree import register_dataclass, tree_flatten, tree_unflatten

__all__ = ["QuantizedTensor", "quantize_tensor", "dequantize_tensor", "check_zero_points",
           "as_linear_layout"]


_STATIC = dict(static=True)  # not a tree child (the reference's register_dataclass)


@register_dataclass
@dataclasses.dataclass
class QuantizedTensor:
    codes: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int = dataclasses.field(metadata=_STATIC, default=4)
    group_size: Optional[int] = dataclasses.field(metadata=_STATIC, default=None)
    packed: bool = dataclasses.field(metadata=_STATIC, default=False)
    pack_layout: str = dataclasses.field(metadata=_STATIC, default="linear")
    pack_tile: Optional[int] = dataclasses.field(metadata=_STATIC, default=None)
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
        from repro_torch.quant.pack import unpack_codes, unprepack_codes

        if self.pack_layout == "tile":
            return unprepack_codes(self.codes, self.bits, self.shape[-1], self.pack_tile)
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


def quantize_tensor(w: torch.Tensor, spec: GridSpec) -> QuantizedTensor:
    """Round-to-nearest into a QuantizedTensor (unpacked codes, no outliers)."""
    grid = compute_grid(w, spec)
    return QuantizedTensor(codes=quantize_codes(w, grid), scale=grid.scale, zero=grid.zero,
                           bits=spec.bits, group_size=spec.group_size)


def as_linear_layout(tree):
    """``tree`` (a QuantizedTensor, or params holding them) with every packed
    leaf in the linear layout: a tile-native leaf is un-prepacked and packed
    again linearly (an exact column permutation, so the dequantized weights
    are bit for bit the same); everything else is returned as it is."""
    from repro_torch.quant.pack import pack_codes

    def linear(x):
        if not (isinstance(x, QuantizedTensor) and x.packed and x.pack_layout == "tile"):
            return x
        return dataclasses.replace(x, codes=pack_codes(x.unpacked_codes(), x.bits),
                                   pack_layout="linear", pack_tile=None)

    leaves, treedef = tree_flatten(tree, is_leaf=lambda x: isinstance(x, QuantizedTensor))
    return tree_unflatten(treedef, [linear(x) for x in leaves])


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
