"""Self-speculative greedy decoding (the port of ``repro.serve.spec``).

A cheap *draft* stack proposes up to γ greedy tokens per lane
(:func:`repro_torch.models.paged_draft_tokens`, one call of S = γ + 1 decode
steps with the argmax fed back on the device), the served *target* scores
every proposal and one bonus position in one call
(:func:`repro_torch.models.paged_verify_tokens`), and the longest prefix on
which the draft agrees with the target's own argmaxes commits, plus the
target's token at the first disagreement.  Every committed token is a target
argmax, so the output is the target's greedy stream: on the CPU token for
token, and on the card as far as the target's top-2 margins reach (kernel 5's
partitions and cuBLAS's algorithm depend on how many lanes a call has, so a
verify over B·(γ+1) lanes and a decode over B lanes round differently).  The
stochastic rule of Leviathan et al. is kept as a host-side reference
(:func:`rejection_sample_commit`); greedy serving reduces to
:func:`greedy_accept_len`.

Draft KV lives in the engine's own :class:`~repro_torch.serve.kv_cache.PagePool`:
the :class:`DraftManager` allocates draft-owned page ids from it (into a
cache of its own, indexed by the same ids) and never registers them in the
prefix cache; after each verify, draft pages past the committed frontier
roll back, and all of a lane's go with the lane.  A draft allocation that
would take the pool's last free page is declined and the proposal shortens,
down to none (plain decode): the target always wins the pool, and
preemption and the SLO rules are untouched.

Drafts: a lower-bit RTN copy of the target
(:func:`repro_torch.serve.qparams.rtn_quantize_for_serving`), the target's
first periods (:func:`truncate_draft`), or any stack with the same
vocabulary.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.models import (
    hoist_dequant,
    init_paged_cache,
    paged_cache_shapes,
    paged_draft_tokens,
    paged_prefill_chunk,
)
from repro_torch.models.model import ModelPlan, period_slice
from repro_torch.serve.kv_cache import NULL_PAGE, PagePool

__all__ = [
    "SpecConfig",
    "DraftManager",
    "greedy_accept_len",
    "maybe_hoist",
    "rejection_sample_commit",
    "truncate_draft",
]


# ---------------------------------------------------------------------------
# Acceptance rules
# ---------------------------------------------------------------------------


def greedy_accept_len(draft_tokens, target_greedy) -> int:
    """Length of the longest prefix on which the draft's proposal agrees with
    the target's greedy choices (``target_greedy[j]``: the target's argmax at
    the position ``draft_tokens[j]`` was proposed for)."""
    a = 0
    for d, t in zip(draft_tokens, target_greedy):
        if int(d) != int(t):
            break
        a += 1
    return a


def rejection_sample_commit(draft_tokens, draft_probs, target_probs, u, v):
    """Speculative rejection sampling, the host-side reference rule.

    Proposal ``t_j`` is accepted when ``u[j] < min(1, p_target(t_j) /
    p_draft(t_j))``; at the first rejection the replacement is drawn from the
    normalised residual ``max(p_target − p_draft, 0)`` by inverse CDF with
    ``v[j]``, and the round stops; if every proposal survives, a bonus token
    is drawn from the target's next row with ``v[len(draft)]``.  No committed
    token has zero target probability, and with one-hot target rows the rule
    is the greedy one.  ``draft_probs``/``target_probs``: per-position rows
    (the target has one more); ``u``: (n,) and ``v``: (n+1,) draws in [0, 1).
    Returns the committed tokens (accepted + 1 of them)."""
    n = len(draft_tokens)
    if len(u) < n or len(v) < n + 1 or len(target_probs) < n + 1:
        raise ValueError("need n accept draws, n+1 CDF draws, n+1 target rows")

    def inv_cdf(probs, draw):
        p = np.maximum(np.asarray(probs, np.float64), 0.0)
        tot = p.sum()
        if tot <= 0.0:
            raise ValueError("cannot sample from an all-zero distribution")
        idx = int(np.searchsorted(np.cumsum(p / tot), draw, side="right"))
        if idx >= p.size or p[idx] <= 0.0:
            # Round-off at the top of the CDF or a zero-mass boundary: the
            # heaviest token, which always has mass.
            idx = int(np.argmax(p))
        return idx

    committed = []
    for j, t in enumerate(draft_tokens):
        t = int(t)
        pd, pt = float(draft_probs[j][t]), float(target_probs[j][t])
        if pd <= 0.0:
            raise ValueError(f"draft proposed token {t} it assigns zero probability")
        if u[j] < min(1.0, pt / pd):
            committed.append(t)
            continue
        # Rejected: p_target(t) < p_draft(t), so the residual has mass.
        resid = np.maximum(np.asarray(target_probs[j], np.float64)
                           - np.asarray(draft_probs[j], np.float64), 0.0)
        committed.append(inv_cdf(resid, v[j]))
        return committed
    committed.append(inv_cdf(target_probs[n], v[n]))
    return committed


# ---------------------------------------------------------------------------
# Drafts
# ---------------------------------------------------------------------------


def truncate_draft(plan: ModelPlan, params, n_periods: int):
    """The target's first ``n_periods`` periods as a draft, sharing its
    embeddings, final norm and head: every ``dec`` leaf (dense,
    QuantizedTensor or HoistedDequant) is a view ``[:n_periods]``; the plan
    keeps the target's KV dtype.  Returns ``(draft_plan, draft_params)``."""
    cfg = plan.cfg
    if not 1 <= n_periods <= cfg.n_periods:
        raise ValueError(f"truncated draft needs 1 <= n_periods <= {cfg.n_periods}, got {n_periods}")
    d_plan = dataclasses.replace(plan, cfg=dataclasses.replace(cfg, n_periods=n_periods))
    d_params = dict(params)
    d_params["dec"] = period_slice(params["dec"], slice(0, n_periods))
    return d_plan, d_params


@dataclasses.dataclass
class SpecConfig:
    """Speculative decoding for the paged engine: the draft stack and γ, the
    most tokens proposed per round (the verify scores γ + 1 positions)."""

    draft_plan: ModelPlan
    draft_params: object
    gamma: int = 4
    # Hoist the dequantization of quantized leaves out of the forward passes
    # (models/common.HoistedDequant): None hoists where the params live on
    # the CPU (the plain GEMM rebuilds the weights every call there); True
    # on card params raises, since kernel 3 dequantizes in its prologue.
    hoist_dequant: Optional[bool] = None

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")


def maybe_hoist(params, flag: Optional[bool]):
    """Resolve ``SpecConfig.hoist_dequant`` against the params' device: hoist
    only where the dequant-GEMM takes its plain version anyway (the CPU), so
    hoisting never stands in for kernel 3."""
    on_cpu = params["embed"].device.type == "cpu"
    if flag is None:
        flag = on_cpu
    if flag and not on_cpu:
        raise ValueError("hoist_dequant=True with params on the card: the hoisted torch.matmul "
                         "would replace the dequant-GEMM kernel; leave it None or False")
    return hoist_dequant(params) if flag else params


# ---------------------------------------------------------------------------
# Draft-side paged state
# ---------------------------------------------------------------------------


class DraftManager:
    """The draft stack's paged KV beside the target's, in the same pool.

    Per lane it keeps the draft's page list and two cursors: ``synced``, the
    prompt positions the draft's chunked prefill covered (-1: detached), and
    ``frontier``, the next position a draft step writes.  The engine calls
    :meth:`attach` when a lane starts decoding, :meth:`propose` each round,
    :meth:`commit` after the verify (the frontier clamps back to the
    committed position and pages past it roll back) and
    :meth:`release_lane` when the lane ends in any way."""

    def __init__(self, cfg: SpecConfig, *, pool: PagePool, n_pages: int, max_batch: int,
                 max_seq: int, page_size: int, prefill_chunk: int, device):
        paged_cache_shapes(cfg.draft_plan, n_pages, page_size)  # the arch gate, at init
        self.cfg = cfg
        self.pool = pool
        self.device = device
        self.max_batch = max_batch
        self.page_size = page_size
        self.pages_per_seq = -(-max_seq // page_size)
        self.prefill_chunk = prefill_chunk
        self.cache = init_paged_cache(cfg.draft_plan, n_pages, page_size, device=device)
        self.table = np.full((max_batch, self.pages_per_seq), NULL_PAGE, np.int32)
        self._dev_table = None
        self.pages: list[list] = [[] for _ in range(max_batch)]
        self.synced = [-1] * max_batch
        self.frontier = [-1] * max_batch
        self.draft_params = maybe_hoist(cfg.draft_params, cfg.hoist_dequant)
        self._propose_fn = functools.partial(paged_draft_tokens, cfg.draft_plan)
        self.n_propose_calls = 0
        self.n_sync_chunks = 0

    # -- page plumbing ---------------------------------------------------
    def _dev_table_now(self) -> torch.Tensor:
        if self._dev_table is None:
            self._dev_table = torch.as_tensor(self.table, device=self.device)
        return self._dev_table

    def _append_page(self, lane: int) -> bool:
        """One more draft page for the lane, declining the pool's last free
        page (the target wins; speculation shortens instead)."""
        if len(self.pages[lane]) >= self.pages_per_seq or self.pool.n_free < 2:
            return False
        got = self.pool.alloc(1)
        if got is None:  # an injected denial ("pool.alloc") shortens too
            return False
        self.pages[lane].append(got[0])
        self.table[lane, len(self.pages[lane]) - 1] = got[0]
        self._dev_table = None
        return True

    def _covered(self, lane: int, pos: int) -> bool:
        while len(self.pages[lane]) <= pos // self.page_size:
            if not self._append_page(lane):
                return False
        return True

    # -- lifecycle -------------------------------------------------------
    def attach(self, lane: int, seq):
        """The lane starts decoding: reset its draft state; the prompt syncs
        at its first proposal (the draft's chunked prefill)."""
        self.release_lane(lane)
        self.synced[lane] = 0
        self.frontier[lane] = seq.n_target - 1  # the replay position

    def release_lane(self, lane: int):
        for p in self.pages[lane]:
            self.pool.release(p)
        self.pages[lane] = []
        self.synced[lane] = -1
        self.frontier[lane] = -1
        if self.table[lane].any():  # NULL_PAGE == 0
            self.table[lane] = NULL_PAGE
            self._dev_table = None

    def commit(self, lane: int, new_pos: int):
        """The committed frontier moved to ``new_pos``: draft KV past it is a
        rejected lookahead (or missing, after a fully accepted round), so the
        write cursor clamps back and pages holding only later positions
        return to the pool."""
        if self.synced[lane] < 0:
            return
        self.frontier[lane] = min(self.frontier[lane], new_pos)
        keep = new_pos // self.page_size + 1
        while len(self.pages[lane]) > keep:
            self.pool.release(self.pages[lane].pop())
            self.table[lane, len(self.pages[lane])] = NULL_PAGE
            self._dev_table = None

    # -- prompt sync -----------------------------------------------------
    def _sync_prompt(self, lane: int, seq) -> bool:
        """Chunk-prefill the draft's KV for ``seq.tokens[:n_target]``; a
        page-starved sync keeps its progress for the next round.  False
        until the whole prompt is in."""
        T = seq.n_target
        while self.synced[lane] < T:
            off = self.synced[lane]
            hi = min(off + self.prefill_chunk, T)
            if not self._covered(lane, hi - 1):
                return False
            buf = np.zeros((1, self.prefill_chunk), np.int32)
            buf[0, : hi - off] = seq.tokens[off:hi]
            self.cache = paged_prefill_chunk(self.cfg.draft_plan, self.draft_params, buf,
                                             self.cache, self._dev_table_now()[lane : lane + 1],
                                             off)
            self.synced[lane] = hi
            self.n_sync_chunks += 1
        return True

    # -- propose ---------------------------------------------------------
    def propose(self, items) -> dict:
        """One round.  For each ``(lane, seq, pos0, budget)`` (``pos0`` the
        lane's replay position, ``budget`` the most tokens worth proposing),
        teacher-force the draft over committed tokens it has not seen
        (``frontier..pos0``) and roll its argmax forward, all lanes in one
        :func:`paged_draft_tokens` call.  Returns ``{lane: [tokens]}``, an
        empty list where a lane is page-starved, unsynced or out of budget
        (the engine then verifies the replay column alone: plain decode)."""
        S = self.cfg.gamma + 1
        out = {it[0]: [] for it in items}
        live = []
        for lane, seq, pos0, budget in items:
            if self.synced[lane] < 0 or not self._sync_prompt(lane, seq):
                continue
            c = max(1, pos0 - self.frontier[lane] + 1)  # forced catch-up
            if c > S:
                # Too far behind to propose (starved earlier): catch up only.
                n_forced, d = S, 0
            else:
                n_forced = c
                d = max(0, min(self.cfg.gamma, budget, S - c + 1))
            steps = n_forced if d == 0 else c + d - 1
            start = self.frontier[lane]
            while steps > 0 and not self._covered(lane, start + steps - 1):
                steps -= 1
            if steps < n_forced:
                n_forced, d = steps, 0
            elif d:
                d = max(0, steps - c + 1)
            if steps <= 0:
                continue
            live.append((lane, n_forced, d, steps))
        if not live:
            return out
        forced = np.zeros((self.max_batch, S), np.int32)
        nf = np.zeros(self.max_batch, np.int32)
        pos = np.zeros(self.max_batch, np.int64)
        wp = np.full((self.max_batch, S), NULL_PAGE, np.int64)
        seq_of = {it[0]: it[1] for it in items}
        for lane, n_forced, d, steps in live:
            start = self.frontier[lane]
            pos[lane] = start
            nf[lane] = n_forced
            forced[lane, :n_forced] = seq_of[lane].tokens[start : start + n_forced]
            for j in range(steps):
                wp[lane, j] = self.pages[lane][(start + j) // self.page_size]
        drafts, self.cache = self._propose_fn(
            self.draft_params, forced, nf, self.cache, pos, self._dev_table_now(), wp)
        self.n_propose_calls += 1
        drafts = drafts.cpu().numpy()  # one copy per proposal
        for lane, n_forced, d, steps in live:
            self.frontier[lane] += steps
            if d:
                out[lane] = [int(t) for t in drafts[lane, n_forced - 1 : n_forced - 1 + d]]
        return out
