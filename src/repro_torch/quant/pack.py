"""Bit-packing of quantization codes into dense uint8 storage.

Codes ``(..., p)`` with values ``< 2^bits`` pack along the last axis into
``ceil(p * bits / 8)`` bytes, little-endian within each byte: code ``k``
occupies bits ``[(k*bits) % 8, …)`` of byte ``(k*bits) // 8``.  For 4 bits
byte ``b`` holds column ``2b`` in its low nibble and ``2b + 1`` in its high
nibble, the linear layout the dequant-GEMM kernel reads.  3-bit codes
straddle bytes and are a storage format only.

int4 KV pages (paged serving) pack fold-in-half instead: byte ``d`` of a
head row holds element ``d`` in its low nibble and ``d + hd/2`` in its high
nibble, both two's complement (:func:`kv_pack_int4`).

The reference's TPU GEMM can also read codes prepacked in a tile-native,
plane-wise order (:func:`prepack_codes`, ``pack_layout="tile"``).  The
port's dequant-GEMM reads the linear layout only, so a tile artifact is
un-prepacked once where it enters the port (:func:`unprepack_codes`, an
exact column permutation).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pack_codes", "unpack_codes", "packed_words_per_row", "kv_pack_int4", "kv_unpack_int4",
    "tile_native_perm", "prepack_codes", "unprepack_codes", "select_tile_k",
]


def packed_words_per_row(p: int, bits: int) -> int:
    return -(-p * bits // 8)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """``(…, p)`` uint8 codes → ``(…, ceil(p*bits/8))`` uint8 packed."""
    codes = codes.to(torch.uint8)
    p = codes.shape[-1]
    lead = codes.shape[:-1]
    if bits == 8:
        return codes
    if bits in (2, 4):
        per_byte = 8 // bits
        pad = (-p) % per_byte
        if pad:
            codes = torch.cat([codes, codes.new_zeros(*lead, pad)], dim=-1)
        grouped = codes.reshape(*lead, -1, per_byte).to(torch.int32)
        shifts = torch.arange(per_byte, dtype=torch.int32, device=codes.device) * bits
        return (grouped << shifts).sum(-1).to(torch.uint8)
    if bits == 3:
        three = torch.arange(3, dtype=torch.int32, device=codes.device)
        bitplane = ((codes[..., :, None].to(torch.int32) >> three) & 1).reshape(*lead, p * 3)
        nbytes = packed_words_per_row(p, 3)
        pad = nbytes * 8 - p * 3
        if pad:
            bitplane = torch.cat([bitplane, bitplane.new_zeros(*lead, pad)], dim=-1)
        eight = torch.arange(8, dtype=torch.int32, device=codes.device)
        by = bitplane.reshape(*lead, nbytes, 8)
        return (by << eight).sum(-1).to(torch.uint8)
    raise ValueError(f"unsupported bits={bits}")


def unpack_codes(packed: torch.Tensor, bits: int, p: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`; returns ``(…, p)`` uint8 codes."""
    lead = packed.shape[:-1]
    if bits == 8:
        return packed[..., :p]
    if bits in (2, 4):
        per_byte = 8 // bits
        shifts = torch.arange(per_byte, dtype=torch.int32, device=packed.device) * bits
        codes = (packed[..., :, None].to(torch.int32) >> shifts) & ((1 << bits) - 1)
        return codes.reshape(*lead, -1)[..., :p].to(torch.uint8)
    if bits == 3:
        eight = torch.arange(8, dtype=torch.int32, device=packed.device)
        bitplane = ((packed[..., :, None].to(torch.int32) >> eight) & 1).reshape(*lead, -1)
        tri = bitplane[..., : p * 3].reshape(*lead, p, 3)
        three = torch.arange(3, dtype=torch.int32, device=packed.device)
        return (tri << three).sum(-1).to(torch.uint8)
    raise ValueError(f"unsupported bits={bits}")


def kv_pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """``(…, hd)`` signed codes in [-7, 7] → ``(…, hd/2)`` uint8, fold-in-half."""
    hd = codes.shape[-1]
    if hd % 2:
        raise ValueError(f"int4 KV packing requires an even head dim, got {hd}")
    c = codes.to(torch.int32)
    lo = c[..., : hd // 2] & 0xF
    hi = c[..., hd // 2 :] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def kv_unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`kv_pack_int4`: ``(…, hd)`` int8 codes in [-8, 7]."""
    b = packed.to(torch.int32)
    lo = ((b & 0xF) ^ 8) - 8  # sign-extend the 4-bit two's complement
    hi = ((b >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


# Codes per byte-aligned packing word: the columns one storage word
# interleaves in the linear layout (3-bit codes straddle bytes; their word
# is the 3-byte block of 8 codes).
_PLANES = {2: 4, 3: 8, 4: 2, 8: 1}


def select_tile_k(p: int, group_size=None, tk: int = 512) -> int:
    """The k-tile the reference's TPU dequant-GEMM runs for a ``(·, p)``
    GEMM (``repro.kernels.dequant_matmul.select_tile_k``), the tile a
    tile-native prepack is made for."""
    tk = min(tk, p)
    gsz = group_size if group_size else p
    if group_size and p // gsz > 1:
        if tk >= gsz:
            tk = (tk // gsz) * gsz
        elif gsz % tk:
            tk = gsz
    return tk


def tile_native_perm(p: int, bits: int, tile_k: int) -> np.ndarray:
    """Column permutation putting each full k-tile in plane-wise order.

    With ``n = _PLANES[bits]`` planes, storage word ``i`` of a tile packs
    columns ``(i, i + tile_k/n, …, i + (n-1)·tile_k/n)``.  The ragged tail
    past the last full tile keeps the linear order."""
    n = _PLANES[bits]
    cols = np.arange(p, dtype=np.int64)
    n_full = p // tile_k
    if n == 1 or tile_k % n or n_full == 0:
        return cols
    head = cols[: n_full * tile_k].reshape(n_full, n, tile_k // n).transpose(0, 2, 1).reshape(-1)
    return np.concatenate([head, cols[n_full * tile_k:]])


def prepack_codes(codes: torch.Tensor, bits: int, tile_k: int) -> torch.Tensor:
    """``(…, p)`` uint8 linear codes → packed bytes in tile-native order."""
    perm = torch.from_numpy(tile_native_perm(codes.shape[-1], bits, tile_k)).to(codes.device)
    return pack_codes(codes[..., perm], bits)


def unprepack_codes(packed: torch.Tensor, bits: int, p: int, tile_k: int) -> torch.Tensor:
    """Inverse of :func:`prepack_codes`: ``(…, p)`` uint8 codes, linear order."""
    perm = tile_native_perm(p, bits, tile_k)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(p, dtype=np.int64)
    return unpack_codes(packed, bits, p)[..., torch.from_numpy(inv).to(packed.device)]
