"""Mixture-of-Experts layer: top-k routing with sort-based static dispatch
(the port's ``repro.models.moe``).

  1. router (fp32) → top-k expert ids and weights per token;
  2. the N tokens split into g dispatch groups of N/g contiguous tokens
     (``dispatch_groups``; g = 1 where it does not divide N); each group's
     N/g·k routed copies take slots in its own (E, C) table, C the capacity
     ``max(int(N/g·k/E · CAPACITY_FACTOR), 8)`` per (group, expert); copies
     past an expert's capacity in their group are dropped;
  3. gather → (E, g·C, D), expert e's slots of every group in group order,
     one batched product per projection over the stacked expert weights;
  4. weighted fp32 sum back to (N, D): each token gathers its kept copies
     and adds them in the order of their slots (the reference scatter-adds
     them), so the sum is the same on every run and device.

Empty slots of a group's table are filled with token 0 of that dispatch
group, as the reference fills them (``repro/models/moe.py:118``): their
outputs carry weight 0, so the forward pass is unaffected, but the
calibration capture records the whole (E, g·C) table, so each expert's Σ
gains one x₀x₀ᵀ of its group per empty slot.  The port copies this on
purpose (``ROADMAP.md`` §3).

A quantized expert weight runs through the dequant-GEMM once per expert
(``kernels.ops.dequant_matmul_experts``).  Its outlier planes are not
applied, as in the reference's expert product (``ROADMAP.md`` §3).

On a rank of a "model" axis (``shard``, an :class:`ExpertShard`) the
router and the dispatch table stay global: they run on the replicated
activations, so every rank routes alike.  Expert-parallel, the rank runs
the slots of its experts alone, combines its own copies (the others read
the zero row) and the (N, D) fp32 sums are all-reduced, then cast once.
Ffn-parallel, ``w_gate``/``w_up`` hold the rank's columns and ``w_down``
its rows: the (E·C, D) products are fp32 partial sums, all-reduced before
the per-slot cast, so the layer rounds where the one-rank layer does.
Under autograd the tokens the rank's experts read pass through
``shard.enter`` (their gradient summed over the axis), and so do, where
the experts split, the top-k weights that combine the rank's copies: the
router's gradient then holds every expert's share, while the router loss,
computed whole on every rank, is not summed again.

Where a "data" axis of d ranks splits the batch (``batch``, a
:class:`BatchShard`: data-parallel training) the groups are the whole
batch's, as the reference's one-device step routes them.  Where g is a
multiple of d (and divides the whole batch's tokens) the rank's block is
exactly its g/d groups: it dispatches them alone, with no collective.
Otherwise the rank's tokens share groups with other ranks': the ranks'
top-k ids are all-gathered, every rank builds the whole batch's tables and
keeps the slots of its own copies.  The router loss's means run over the
whole batch in both cases.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.models.common import HoistedDequant, _record_linear, activation
from repro_torch.quant import QuantizedTensor

__all__ = ["moe_apply", "router_aux_loss", "CAPACITY_FACTOR", "ExpertShard", "BatchShard"]

CAPACITY_FACTOR = 1.25  # slots an expert = tokens·k/E times this (the reference's default)


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """One rank's layout of an MoE layer on a "model" axis: ``"experts"``
    (experts ``first .. first + n_local − 1``) or ``"ffn"`` (each expert's
    ffn block); ``psum``, the fp32 sum of the ranks' partials over the axis
    (``dist.collectives.reduce_from``), and ``enter``, the identity whose
    gradient is summed over it (``copy_to``), for a replicated tensor that
    enters the rank's own work."""

    kind: str
    psum: Callable
    enter: Callable
    first: int = 0
    n_local: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """A rank's block of a batch split over a "data" axis: block ``rank`` of
    ``n`` equal ones, in rank order; ``gather`` all-gathers a tensor's rows
    over the axis, ``psum`` sums a tensor over it, its gradient summed too
    (every rank's loss reads the sum, and the trainer sums the ranks'
    gradients)."""

    rank: int
    n: int
    gather: Callable
    psum: Callable


def _expert_matmul(w, xs: torch.Tensor, name: str, out_dtype=None) -> torch.Tensor:
    """xs: (E, C, d_in) × stacked expert weights → (E, C, d_out), formed in
    ``out_dtype`` (default xs's).

    ``w`` is dense ``(E, d_in, d_out)``, a QuantizedTensor with codes
    ``(E, d_out, d_in)`` (per-expert grids stacked on the leading axis), or
    a HoistedDequant of one."""
    _record_linear(name, xs, expert_stacked=True)
    out_dtype = out_dtype or xs.dtype
    if isinstance(w, QuantizedTensor):
        from repro_torch.kernels import ops

        return ops.dequant_matmul_experts(
            xs.contiguous(), w.codes, w.scale, w.zero, packed4=w.packed and w.bits == 4,
            out_dtype=out_dtype, group_size=w.group_size,
        )
    if isinstance(w, HoistedDequant):
        return (xs.to(torch.float32) @ w.w.transpose(-1, -2)).to(out_dtype)
    if out_dtype != xs.dtype:
        return torch.bmm(xs.to(out_dtype), w.to(out_dtype))
    return torch.bmm(xs, w)


def _route(router: torch.Tensor, xf: torch.Tensor, top_k: int, norm_topk: bool):
    """(n, D) tokens → (router probs (n, E) fp32, top-k weights, top-k
    expert ids (n, k))."""
    probs = torch.softmax(xf.to(torch.float32) @ router.to(torch.float32), -1)
    # lax.top_k's order: descending, ties to the lower index.
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :top_k], top_e[:, :top_k]
    if norm_topk:
        top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


def _dispatch_table(expert_ids: torch.Tensor, n_experts: int, capacity: int):
    """expert_ids: (R,) expert of each routed copy → (copy of each slot
    ``(E·C,)`` int64, -1 where empty; slot of each copy ``(R,)``, ``E·C``
    where dropped)."""
    r, dev = expert_ids.shape[0], expert_ids.device
    order = torch.argsort(expert_ids, stable=True)  # groups copies by expert
    sorted_e = expert_ids[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n_experts, device=dev), side="left")
    pos_in_e = torch.arange(r, device=dev) - starts[sorted_e]
    slot_sorted = torch.where(pos_in_e < capacity, sorted_e * capacity + pos_in_e,
                              n_experts * capacity)
    slot = torch.empty(r, dtype=torch.long, device=dev)
    slot[order] = slot_sorted
    # Dropped copies all land in the overflow bucket at the end, trimmed.
    copy_for_slot = torch.full((n_experts * capacity + 1,), -1, dtype=torch.long, device=dev)
    copy_for_slot[slot] = torch.arange(r, device=dev)
    return copy_for_slot[:-1], slot


def _group_tables(ids: torch.Tensor, g: int, n_experts: int, capacity: int):
    """ids: (g·R,) the routed copies of g groups in group order → the
    (E, g·C) slot table (:func:`_dispatch_table`'s outputs with every index
    global: copy of each slot ``(E·g·C,)``, -1 where empty; slot of each
    copy ``(g·R,)``, ``E·g·C`` where dropped).  Each group ranks its copies
    by expert on its own (one table over (group, expert) keys), and slot
    ``(i, e, c)`` moves to ``e·g·C + i·C + c``."""
    if g == 1:
        return _dispatch_table(ids, n_experts, capacity)
    per = ids.shape[0] // g
    group = torch.arange(g, device=ids.device).repeat_interleave(per)
    copy_for_slot, slot = _dispatch_table(group * n_experts + ids, g * n_experts, capacity)
    copy_for_slot = copy_for_slot.reshape(g, n_experts, capacity).transpose(0, 1).reshape(-1)
    total = g * n_experts * capacity
    i, e, c = slot // (n_experts * capacity), slot // capacity % n_experts, slot % capacity
    slot = torch.where(slot < total, e * g * capacity + i * capacity + c, total)
    return copy_for_slot, slot


def moe_apply(p: dict, x: torch.Tensor, *, n_experts: int, top_k: int, act: str, gated: bool,
              norm_topk: bool, return_aux: bool = False, shard: Optional[ExpertShard] = None,
              batch: Optional[BatchShard] = None, dispatch_groups: int = 1):
    """x: (B, S, D) → ``(y, router probs or None)``; the tokens route within
    ``dispatch_groups`` contiguous groups (the reference's semantics; its
    trainer passes 1).  ``shard``: this rank's layout on a "model" axis
    (None: the whole layer); ``batch``: x is this rank's block of a batch
    split over a "data" axis (None: x is the whole batch)."""
    B, S, D = x.shape
    n = B * S
    xf = x.reshape(n, D)
    probs, top_w, top_e = _route(p["router"], xf, top_k, norm_topk)

    n_all = n * (batch.n if batch is not None else 1)  # the whole batch's tokens
    g = dispatch_groups if n_all % dispatch_groups == 0 else 1
    ng = n_all // g  # tokens a group
    capacity = max(int(ng * top_k / n_experts * CAPACITY_FACTOR), 8)
    aligned = batch is None or g % batch.n == 0
    g_here = g // batch.n if batch is not None and aligned else g  # groups in the table
    ids = top_e.reshape(-1) if aligned else batch.gather(top_e.reshape(-1))
    copy_for_slot, slot_of_copy = _group_tables(ids, g_here, n_experts, capacity)
    if not aligned:  # the whole batch's tables: the slots of this rank's copies
        c0 = batch.rank * n * top_k
        slot_of_copy = slot_of_copy[c0 : c0 + n * top_k]
        mine = (copy_for_slot >= c0) & (copy_for_slot < c0 + n * top_k)
        copy_for_slot = torch.where(mine, copy_for_slot - c0, -1)
    kind = shard.kind if shard is not None else None
    if kind is not None:
        xf = shard.enter(xf)
        if kind == "experts":
            top_w = shard.enter(top_w)
    filled = copy_for_slot >= 0
    # An empty slot reads its group's token 0 (the rank's own token 0 where
    # the tables are the whole batch's: its weight is 0 either way).
    first = 0
    if aligned and g_here > 1:
        first = (torch.arange(g_here, device=x.device) * ng).repeat_interleave(capacity)
        first = first.repeat(n_experts)
    token_for_slot = torch.where(filled, copy_for_slot // top_k, first)
    w_for_slot = torch.where(filled, top_w.reshape(-1)[copy_for_slot.clamp_min(0)], 0.0)

    gc = g_here * capacity  # an expert's slots
    e0, ne = (shard.first, shard.n_local) if kind == "experts" else (0, n_experts)
    s0, ns = e0 * gc, ne * gc  # this rank's slots
    xs = xf[token_for_slot[s0 : s0 + ns]].reshape(ne, gc, D)
    h = activation(_expert_matmul(p["w_gate"], xs, "w_gate"), act)
    if gated:
        h = h * _expert_matmul(p["w_up"], xs, "w_up")
    if kind == "ffn":
        ys = shard.psum(_expert_matmul(p["w_down"], h, "w_down", torch.float32)).to(xs.dtype)
    else:
        ys = _expert_matmul(p["w_down"], h, "w_down")
    ys = ys.reshape(ns, D) * w_for_slot[s0 : s0 + ns, None].to(ys.dtype)

    # Each token's copies in slot order; a dropped copy, and on an
    # expert-parallel rank another rank's, reads the zero row appended at
    # the rank's last slot.
    ys32 = torch.cat([ys.to(torch.float32), ys.new_zeros(1, D, dtype=torch.float32)])
    slots = slot_of_copy.reshape(n, top_k).sort(-1).values - s0
    contrib = ys32[torch.where((slots >= 0) & (slots < ns), slots, ns)]  # (n, k, D)
    y = contrib[:, 0]
    for i in range(1, top_k):
        y = y + contrib[:, i]
    if kind == "experts":
        y = shard.psum(y)
    return y.reshape(B, S, D).to(x.dtype), (probs if return_aux else None)


def router_aux_loss(probs: torch.Tensor, batch: Optional[BatchShard] = None) -> torch.Tensor:
    """Switch-style load-balancing loss: E · Σ_e f_e · P_e, the means over
    the whole batch (over every rank's block where ``batch`` splits it)."""
    e = probs.shape[1]
    top = (probs == probs.amax(-1, keepdim=True)).to(torch.float32)
    if batch is None:
        pe, fe = probs.mean(0), top.mean(0)
    else:
        n_all = probs.shape[0] * batch.n
        pe, fe = batch.psum(probs.sum(0)) / n_all, batch.psum(top.sum(0)) / n_all
    return e * torch.sum(fe * pe)
