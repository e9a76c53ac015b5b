"""Quantization substrate: uniform grids, code packing, quantized tensors."""

from repro_torch.quant.grid import (
    Grid,
    GridSpec,
    compute_grid,
    compute_grid_excluding_outliers,
    dequantize_codes,
    quantize_codes,
    quantize_dequantize,
)
from repro_torch.quant.pack import (
    kv_pack_int4,
    kv_unpack_int4,
    pack_codes,
    packed_words_per_row,
    prepack_codes,
    tile_native_perm,
    unpack_codes,
    unprepack_codes,
)
from repro_torch.quant.qtensor import (
    QuantizedTensor,
    as_linear_layout,
    check_zero_points,
    dequantize_tensor,
    quantize_tensor,
)

__all__ = [
    "Grid",
    "GridSpec",
    "compute_grid",
    "compute_grid_excluding_outliers",
    "dequantize_codes",
    "quantize_codes",
    "quantize_dequantize",
    "kv_pack_int4",
    "kv_unpack_int4",
    "pack_codes",
    "packed_words_per_row",
    "unpack_codes",
    "prepack_codes",
    "unprepack_codes",
    "tile_native_perm",
    "QuantizedTensor",
    "as_linear_layout",
    "check_zero_points",
    "dequantize_tensor",
    "quantize_tensor",
]
