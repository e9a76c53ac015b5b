"""CUDA wrapper: paged decode attention (replaces ``paged_attention_pallas``).

One query token per sequence attends over the KV pages its page-table row
names, with an online softmax in fp32; pages are bf16, int8 or fold-in-half
int4 (uint8), quantized pages with fp32 scale planes.  See
``csrc/paged_attention.cu``.

The KV of each (sequence, kv head) is split over CTAs in partitions of
whole pages of the table; :func:`plan_paged` chooses the partition size
from shapes the host knows (the table's width, never ``lengths``, which
would cost a device sync per decode step), and ``plan=`` pins one; the
partitions are ``ceil(n_pgs / part_pages)``.  More than one adds the
combine kernel, which merges each sequence's partitions in a fixed order.
``.launches`` counts wrapper calls, one per decode attention call,
whatever runs inside.  CUDA tensors only.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

__all__ = ["paged_attention_cuda", "plan_paged", "check_paged_plan", "paged_splits",
           "paged_ctas_per_sm", "TILE", "MAX_PART_PAGES", "MIN_PART_TILES"]

_KIND_OF = {torch.bfloat16: "bf16", torch.int8: "int8", torch.uint8: "int4"}
_KIND_CODE = {"bf16": 0, "int8": 1, "int4": 2}  # the kernel's PageKind
_Q_DTYPES = (torch.float32, torch.bfloat16)
TILE = {"bf16": 64, "int8": 64, "int4": 128}  # positions per staged tile (bf16 rows over 192 wide: 32)
MAX_PART_PAGES = 256  # table entries a CTA stages in shared memory
MIN_PART_TILES = 2  # the shortest partition the planner makes, in tiles


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def paged_splits(n_pgs: int, part_pages: int) -> int:
    """Partitions of ``part_pages`` pages that cut a table of ``n_pgs``
    pages (one for an empty table)."""
    return max(1, _cdiv(n_pgs, part_pages))


@functools.lru_cache(maxsize=4096)
def plan_paged(B: int, KVp: int, G: int, hd: int, n_pgs: int, psz: int, kind: str, n_sm: int,
               ctas_per_sm: int, window=None) -> int:
    """Pages per partition for a ``(B, KVp, G, hd)`` decode over a table of
    ``n_pgs`` pages of ``psz`` positions and ``kind`` pages.

    A round is the ``n_sm·ctas_per_sm`` CTAs the card holds at once
    (``ctas_per_sm``: :func:`paged_ctas_per_sm`, which is where ``G`` and
    ``hd`` enter).  Where ``B·KVp`` CTAs leave part of a round idle, the
    table is cut into ``want = max(2, round // (B·KVp))`` partitions of
    ``ceil(n_pgs / want)`` pages: as many as full-length sequences fit in
    one round (a part-filled second round of full partitions cost the H100
    more than longer partitions in one), and at least two, because the
    sequences of a served batch are rarely all full and the longest one
    sets the time.  None shorter than ``MIN_PART_TILES`` tiles, none longer
    than ``MAX_PART_PAGES`` pages.  One partition where ``B·KVp`` CTAs fill
    a round already, or where a ``window`` spans fewer than two partitions'
    pages: splitting it would shorten no CTA by half and would add empty
    CTAs and the combine.  Only shapes enter, never ``lengths``.
    """
    _require(min(B, KVp, G, hd, psz, n_sm, ctas_per_sm) >= 1 and n_pgs >= 0 and kind in TILE
             and (window is None or window >= 0),
             f"plan_paged({B}, {KVp}, {G}, {hd}, {n_pgs}, {psz}, {kind!r}, {n_sm}, {ctas_per_sm}, "
             f"{window})")
    table = max(n_pgs, 1)
    slots = n_sm * ctas_per_sm
    want = 1 if B * KVp >= slots else max(2, slots // (B * KVp))
    part = max(_cdiv(table, want), _cdiv(MIN_PART_TILES * TILE[kind], psz))
    if window is not None and min(table, _cdiv(window, psz) + 1) < 2 * part:
        part = table
    return min(part, MAX_PART_PAGES, table)


def check_paged_plan(plan) -> int:
    """``plan``, pages per partition, if the kernel takes it: an int in
    ``1..MAX_PART_PAGES`` (longer than the table is one partition).  Raises
    ``ValueError`` otherwise."""
    _require(isinstance(plan, int) and not isinstance(plan, bool) and 1 <= plan <= MAX_PART_PAGES,
             f"plan must be an int of 1..{MAX_PART_PAGES} pages per partition, got {plan!r}")
    return plan


@functools.lru_cache(maxsize=None)
def paged_ctas_per_sm(index: int, q_bf16: bool, kind: str, G: int, hd: int) -> int:
    """CTAs of kernel 5 resident on one SM of card ``index`` (the CUDA
    occupancy calculator on the instance's registers and shared memory)."""
    n = build.load("paged_attention").paged_ctas_per_sm(int(q_bf16), _KIND_CODE[kind], G, hd, index)
    if n <= 0:
        raise RuntimeError(f"paged_ctas_per_sm({kind}, G={G}, hd={hd}): CUDA error {-n}")
    return n


def paged_attention_cuda(
    q, k_pages, v_pages, page_table, lengths, *,
    window=None, attn_softcap=None, k_scale_pages=None, v_scale_pages=None, plan=None,
):
    """q ``(B, KVp, G, hd)`` fp32/bf16 (unscaled); pages ``(n_pages, psz,
    KVp, hd)`` bf16/int8 or ``(…, hd/2)`` uint8; page_table ``(B, n_pgs)``
    and lengths ``(B,)`` int32; scale planes ``(n_pages, psz, KVp, 1)`` fp32
    for quantized pages.  ``plan``: pages per partition instead of
    :func:`plan_paged`'s; one the kernel cannot take raises ``ValueError``.
    Returns ``(B, KVp, G, hd)`` in q's dtype."""
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
    _require(k_pages.dtype in _KIND_OF and v_pages.dtype == k_pages.dtype,
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
    n_pgs = page_table.shape[1]
    kind = _KIND_OF[k_pages.dtype]
    if plan is None:
        cps = paged_ctas_per_sm(dev.index, q.dtype == torch.bfloat16, kind, G, hd)
        plan = plan_paged(B, KVp, G, hd, n_pgs, psz, kind, sm_count(dev.index), cps, window)
    part_pages = check_paged_plan(plan)
    n_split = paged_splits(n_pgs, part_pages)
    q = q.contiguous()
    out = torch.empty_like(q)
    part = None
    if n_split > 1:
        part = torch.empty(B * KVp * n_split * G * (hd + 2), dtype=torch.float32, device=dev)
    lib = build.load("paged_attention")
    err = lib.paged_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pages.data_ptr(), v_pages.data_ptr(),
        _KIND_CODE[kind],
        k_scale_pages.data_ptr() if quantized else None,
        v_scale_pages.data_ptr() if quantized else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        B, KVp, G, hd, psz, n_pgs, -1 if window is None else int(window),
        # The kernel scales q by this, rounded to fp32 by ctypes: PyTorch's
        # q * (1/sqrt(hd)) rounds the Python float the same way.
        0.0 if attn_softcap is None else float(attn_softcap), 1.0 / math.sqrt(hd),
        part_pages, torch.cuda.current_stream(dev).cuda_stream, dev.index,
    )
    build.check(err, "paged_attention")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
