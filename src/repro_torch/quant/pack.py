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
"""

from __future__ import annotations

import torch

__all__ = ["pack_codes", "unpack_codes", "packed_words_per_row", "kv_pack_int4", "kv_unpack_int4"]


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
