"""CUDA wrapper: paged decode attention (replaces ``paged_attention_pallas``).

One query token per sequence attends over the KV pages its page-table row
names, with an online softmax in fp32; pages are bf16, int8 or fold-in-half
int4 (uint8), quantized pages with fp32 scale planes.  See
``csrc/paged_attention.cu``.  Counts its launches in ``.launches``; CUDA
tensors only.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

__all__ = ["paged_attention_cuda"]

_PAGE_KIND = {torch.bfloat16: 0, torch.int8: 1, torch.uint8: 2}
_Q_DTYPES = (torch.float32, torch.bfloat16)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def paged_attention_cuda(
    q, k_pages, v_pages, page_table, lengths, *,
    window=None, attn_softcap=None, k_scale_pages=None, v_scale_pages=None,
):
    """q ``(B, KVp, G, hd)`` fp32/bf16 (unscaled); pages ``(n_pages, psz,
    KVp, hd)`` bf16/int8 or ``(…, hd/2)`` uint8; page_table ``(B, n_pgs)``
    and lengths ``(B,)`` int32; scale planes ``(n_pages, psz, KVp, 1)`` fp32
    for quantized pages.  Returns ``(B, KVp, G, hd)`` in q's dtype."""
    dev = q.device
    _require(dev.type == "cuda", "paged_attention_cuda takes CUDA tensors")
    named = {"k_pages": k_pages, "v_pages": v_pages, "page_table": page_table, "lengths": lengths}
    quantized = k_scale_pages is not None
    _require(quantized == (v_scale_pages is not None),
             "k_scale_pages and v_scale_pages must be passed together")
    if quantized:
        named |= {"k_scale_pages": k_scale_pages, "v_scale_pages": v_scale_pages}
    for name, t in named.items():
        _require(t.device == dev, f"{name} is on {t.device}, expected {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(q.dim() == 4 and q.dtype in _Q_DTYPES, "q must be a (B, KVp, G, hd) float32/bfloat16 tensor")
    B, KVp, G, hd = q.shape
    _require(G <= 8 and hd <= 256, f"the kernel takes G <= 8 and hd <= 256, got G={G}, hd={hd}")
    _require(k_pages.dtype in _PAGE_KIND and v_pages.dtype == k_pages.dtype,
             f"pages must be bfloat16, int8 or uint8 (int4) alike, got {k_pages.dtype}, {v_pages.dtype}")
    packed4 = k_pages.dtype == torch.uint8
    _require(not packed4 or hd % 2 == 0, "int4 pages need an even head dim")
    _require(quantized or k_pages.dtype == torch.bfloat16,
             "int8 and int4 pages require both scale planes")
    _require(k_pages.dim() == 4 and k_pages.shape[2:] == (KVp, hd // 2 if packed4 else hd)
             and v_pages.shape == k_pages.shape,
             f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    n_pages, psz = k_pages.shape[:2]
    if quantized:
        for t in (k_scale_pages, v_scale_pages):
            _require(t.dtype == torch.float32 and t.shape == (n_pages, psz, KVp, 1),
                     f"scale planes must be float32 {(n_pages, psz, KVp, 1)}")
    _require(page_table.dtype == torch.int32 and page_table.dim() == 2 and page_table.shape[0] == B,
             f"page_table must be (B={B}, n_pgs) int32")
    _require(lengths.dtype == torch.int32 and lengths.shape == (B,), f"lengths must be ({B},) int32")
    # The 1/sqrt(hd) pre-scale in q's dtype, as decode_attention applies it.
    qs = (q * (1.0 / math.sqrt(hd))).to(q.dtype).contiguous()
    out = torch.empty_like(qs)
    lib = build.load("paged_attention")
    err = lib.paged_attention(
        qs.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(), v_pages.data_ptr(),
        _PAGE_KIND[k_pages.dtype],
        k_scale_pages.data_ptr() if quantized else None,
        v_scale_pages.data_ptr() if quantized else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, KVp, G, hd, psz, page_table.shape[1], -1 if window is None else int(window),
        0.0 if attn_softcap is None else float(attn_softcap),
        torch.cuda.current_stream(dev).cuda_stream, dev.index,
    )
    build.check(err, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
