"""Batched serving engines for quantized models (continuous batching).

The port of ``repro.serve.engine``.  Both engines share the :class:`Request`
lifecycle (submit → waiting queue → prefill → shared batched decode with
per-slot positions → finished) and the greedy sampler; weights may be dense
or :class:`~repro_torch.quant.QuantizedTensor` (the PTQ artifact), whose
linears run through the dequantizing GEMM.

:class:`ServingEngine` is the contiguous baseline: every slot reserves
``max_seq`` KV positions, prompts prefill in one padded shot, and decode
attends through ``models.common.decode_attention``.

:class:`PagedServingEngine` keeps KV in a shared pool of fixed-size pages
(:mod:`repro_torch.serve.kv_cache`): admission is gated by free pages,
prompts stream in chunked prefills interleaved with decode steps, matching
prompt prefixes share pages (hash-chain prefix cache, copy-on-write partial
hits), and when the pool runs dry a sequence is preempted (pages freed,
request requeued, resumed later by re-prefilling prompt + generated tokens).
Decode attends through ``kernels.ops.paged_attention``: the CUDA kernel on
the card, its plain version on the CPU.

Scheduling (``scheduler="slo"``, the default): requests carry an optional
``deadline_ms`` (relative to submit) and an integer ``priority``; the engine
admits in (priority desc, deadline asc, arrival) order, sheds at admission a
request whose deadline even the optimistic bound (its own prefill chunks and
decode steps at the fastest step costs observed) overshoots, expires queued
or running requests whose deadline has passed (partial output kept, pages
freed), and preempts the lowest-priority, most-slack, newest lane.
``scheduler="fifo"`` keeps arrival order and preempts the newest.  Every
request ends with a status in :data:`TERMINAL_STATUSES`.

Both engines consult ``fault_point("engine.step")`` at the top of
:meth:`step`, before any state changes, so a transient fault is a no-op
step; page allocation goes through ``pool.alloc``.

Device: the engines run where the params live and take ``device="cuda"``
by default; params on another device are refused.  Each step's logits come
back to the host (``.cpu()`` synchronises), so the step timers behind the
shed floor read finished work; prefill chunks synchronise the card before
their timer stops.  ``decode_seconds`` and ``prefill_seconds`` sum the host
wall time (``time.perf_counter``) of those calls; the injectable ``clock``
is read exactly where the reference reads it.

Speculative decoding (``spec=``, a :class:`~repro_torch.serve.spec.SpecConfig`):
each decode round of the paged engine is propose → verify → commit.  A
draft stack proposes up to γ tokens per lane, the target scores them in one
:func:`~repro_torch.models.paged_verify_tokens` call, and the longest prefix
matching the target's own argmaxes commits with one bonus token
(:mod:`repro_torch.serve.spec`).  A round in which no lane has a proposal
is the plain decode step.  ``decode_seconds`` then covers the whole round,
and ``propose_seconds`` the draft's part of it (its prompt sync and its
proposals).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import require_on_device
from repro_torch.faults import TransientFault, fault_point
from repro_torch.models import (
    decode_step,
    init_cache,
    init_paged_cache,
    paged_decode_step,
    paged_prefill_chunk,
    prefill,
)
from repro_torch.models.model import ModelPlan, paged_verify_tokens
from repro_torch.serve.kv_cache import NULL_PAGE, PagePool, page_nbytes
from repro_torch.serve.spec import DraftManager, SpecConfig, greedy_accept_len, maybe_hoist

__all__ = ["Request", "ServingEngine", "PagedServingEngine", "TERMINAL_STATUSES"]

TERMINAL_STATUSES = ("completed", "preempted_resumed", "shed", "deadline_missed")

_INF = float("inf")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (n,) int32
    max_new_tokens: int = 16
    deadline_ms: Optional[float] = None  # SLO deadline, relative to submit
    priority: int = 0  # higher = more important (scheduler="slo" only)
    output: Optional[list] = None
    done: bool = False
    status: str = "pending"  # terminal: one of TERMINAL_STATUSES
    error: Optional[str] = None  # set when shed (the rejection reason)
    submit_t: Optional[float] = None  # engine-clock timestamps
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    n_preemptions: int = 0
    submit_order: int = -1  # arrival tie-break (assigned by the engine)
    # Speculative accounting (zero without speculation): commit rounds,
    # proposed and accepted draft tokens.  Each round commits accepted + 1
    # tokens, so len(output) == n_draft_accepted + n_spec_rounds.
    n_spec_rounds: int = 0
    n_draft_tokens: int = 0
    n_draft_accepted: int = 0

    def acceptance_rate(self) -> Optional[float]:
        """Accepted share of this request's proposed draft tokens (None
        when none was proposed)."""
        if self.n_draft_tokens == 0:
            return None
        return self.n_draft_accepted / self.n_draft_tokens

    def deadline_at(self) -> float:
        """Absolute engine-clock deadline (inf when no SLO attached)."""
        if self.deadline_ms is None or self.submit_t is None:
            return _INF
        return self.submit_t + self.deadline_ms / 1e3


def _host_logits(logits: torch.Tensor) -> np.ndarray:
    return logits.to(torch.float32).cpu().numpy()


class ServingEngine:
    """Contiguous-slot engine: per-slot ``max_seq`` KV reservation.

    Prefills are right-padded to ``prefill_pad`` buckets; the prompt's last
    real token is replayed as the first decode, so padding never enters the
    distribution (each slot's validity mask is its own position).
    """

    def __init__(
        self,
        plan: ModelPlan,
        params,
        *,
        max_batch: int = 4,
        max_seq: int = 512,
        prefill_pad: int = 32,
        record_logits: bool = False,
        clock: Optional[Callable[[], float]] = None,
        device="cuda",
    ):
        self.device = require_on_device(params["embed"], device)
        self.plan = plan
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.prefill_pad = prefill_pad
        self.record_logits = record_logits
        self.clock = clock or time.monotonic
        self.logit_trace: dict[int, list] = {}

        self.cache = init_cache(plan, max_batch, max_seq, device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int64)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._last_tok = np.zeros((max_batch, 1), np.int32)
        self._submitted = 0

        self.n_decode_steps = 0
        self.n_prefills = 0
        self.n_prefill_tokens = 0  # real prompt tokens (pad excluded)
        self.n_transient_faults = 0
        self.decode_seconds = 0.0

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        # Every generated token occupies a cache position, so prompt +
        # max_new must fit the window (a prompt of exactly max_seq cannot
        # decode even token 0).
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid} cannot fit: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} > max_seq {self.max_seq}"
            )
        req.output = []
        req.status = "queued"
        req.submit_t = self.clock()
        req.submit_order = self._submitted
        self._submitted += 1
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            n = len(req.prompt)
            pad = min(-(-n // self.prefill_pad) * self.prefill_pad, self.max_seq)
            toks = np.zeros((1, pad), np.int32)
            toks[0, :n] = req.prompt
            one = init_cache(self.plan, 1, self.max_seq, device=self.device)
            _, one = prefill(self.plan, self.params, {"tokens": toks}, one)
            self.n_prefills += 1
            self.n_prefill_tokens += n
            for blk, leaves in self.cache.items():
                for name, big in leaves.items():
                    big[:, slot : slot + 1].copy_(one[blk][name])
            self.slot_req[slot] = req
            # Positions [n, pad) hold pad-token KV; decode from position n - 1
            # by replaying the last real token (the mask pos < len hides pads).
            self.slot_pos[slot] = n - 1
            self._last_tok[slot, 0] = int(req.prompt[-1])

    def _retire(self):
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            if len(req.output) >= req.max_new_tokens or self.slot_pos[i] >= self.max_seq - 1:
                req.done = True
                req.status = "completed"
                req.finish_t = self.clock()
                self.finished.append(req)
                self.slot_req[i] = None

    def step(self) -> bool:
        try:
            fault_point("engine.step")
        except TransientFault:
            # Nothing mutated yet: a pure no-op step; retry next time.
            self.n_transient_faults += 1
            return True
        self._admit()
        self._retire()  # max_new_tokens == 0 finishes without a decode
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        w0 = time.perf_counter()
        logits, self.cache = decode_step(
            self.plan, self.params, self._last_tok, self.cache, self.slot_pos
        )
        logits = _host_logits(logits)
        self.decode_seconds += time.perf_counter() - w0
        self.n_decode_steps += 1
        now = self.clock()
        for i in active:
            tok = int(np.argmax(logits[i]))
            if self.record_logits:
                self.logit_trace.setdefault(self.slot_req[i].rid, []).append(logits[i])
            self._last_tok[i, 0] = tok
            req = self.slot_req[i]
            if not req.output:
                req.first_token_t = now
            req.output.append(tok)
            self.slot_pos[i] += 1
        self._retire()
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.finished


@dataclasses.dataclass
class _Seq:
    """Per-lane scheduler state of the paged engine."""

    req: Request
    tokens: list  # prompt + generated so far (resume recomputes from this)
    pages: list  # position-ordered page ids
    n_prefilled: int  # positions [0, n_prefilled) hold valid KV
    n_target: int  # == len(tokens) at admission; prefill ends here
    hashed_upto: int = 0  # pages registered into the prefix cache so far
    order: int = 0  # admission order (the final preemption tie-break)


class PagedServingEngine:
    """Paged-KV engine: shared page pool, chunked prefill, prefix cache,
    SLO-aware scheduling with preemption by eviction.  On bf16 KV its greedy
    outputs are token-identical to :class:`ServingEngine` on the CPU."""

    def __init__(
        self,
        plan: ModelPlan,
        params,
        *,
        max_batch: int = 8,
        max_seq: int = 512,
        page_size: int = 16,
        n_pages: Optional[int] = None,
        prefill_chunk: int = 64,
        prefix_cache: bool = True,
        record_logits: bool = False,
        scheduler: str = "slo",
        spec: Optional[SpecConfig] = None,
        clock: Optional[Callable[[], float]] = None,
        device="cuda",
    ):
        if scheduler not in ("slo", "fifo"):
            raise ValueError(f"unknown scheduler {scheduler!r}; expected slo|fifo")
        if spec is not None and spec.draft_plan.cfg.vocab != plan.cfg.vocab:
            raise ValueError(
                f"draft vocab {spec.draft_plan.cfg.vocab} != target vocab {plan.cfg.vocab}: "
                "draft proposals would not be target tokens")
        self.device = require_on_device(params["embed"], device)
        self.plan = plan
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_seq = -(-max_seq // page_size)
        if n_pages is None:
            n_pages = 1 + max_batch * self.pages_per_seq  # ample: no preemption
        self.n_pages = n_pages
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        self.record_logits = record_logits
        self.scheduler = scheduler
        self.clock = clock or time.monotonic

        self.cache = init_paged_cache(plan, n_pages, page_size, device=self.device)
        self.pool = PagePool(n_pages, page_size)
        self.table = np.full((max_batch, self.pages_per_seq), NULL_PAGE, np.int32)
        self._dev_table = None  # rebuilt lazily when self.table changes
        self.lanes: list[Optional[_Seq]] = [None] * max_batch
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.slot_pos = np.zeros(max_batch, np.int64)
        self._last_tok = np.zeros((max_batch, 1), np.int32)
        self._admitted = 0
        self._submitted = 0
        self.logit_trace: dict[int, list] = {}

        # Speculation: the draft proposes into its own pages of this pool,
        # the verify runs the target's decode step over B·(γ+1) lanes.
        self.spec = spec
        self.spec_mgr: Optional[DraftManager] = None
        if spec is not None:
            require_on_device(spec.draft_params["embed"], self.device, "draft params")
            self.spec_mgr = DraftManager(
                spec, pool=self.pool, n_pages=n_pages, max_batch=max_batch, max_seq=max_seq,
                page_size=page_size, prefill_chunk=prefill_chunk, device=self.device)
            # Hoisted on the CPU only (spec.maybe_hoist); the L = 1 branch
            # keeps self.params, the plain step's bytes.
            self._verify_params = maybe_hoist(params, spec.hoist_dequant)

        self.n_decode_steps = 0
        self.n_prefill_chunks = 0
        self.n_prefill_tokens = 0
        self.n_prefix_hit_tokens = 0
        self.n_cow_hits = 0
        self.n_guard_copies = 0  # replay-target copies off registered pages
        self.n_preemptions = 0
        self.n_shed = 0
        self.n_deadline_missed = 0
        self.n_transient_faults = 0
        self.decode_seconds = 0.0
        self.prefill_seconds = 0.0
        self.propose_seconds = 0.0
        self.n_spec_rounds = 0
        self.n_draft_tokens = 0
        self.n_draft_accepted = 0
        # Fastest step costs observed (engine clock): the optimistic floor
        # behind provable-shed admission.  None until measured, so a cold
        # engine never sheds.
        self._min_decode_s: Optional[float] = None
        self._min_chunk_s: Optional[float] = None
        # KV pages read by decode attention: Σ over steps and active lanes of
        # ceil(context / page_size); kv_read_bytes folds in the periods.
        self.n_kv_page_reads = 0

    def kv_read_bytes(self) -> int:
        """Decode-attention KV bytes implied by the page-read counter."""
        hp = self.plan.heads
        per_page = page_nbytes(
            self.page_size, hp.kv_pad, hp.head_dim,
            self.plan.cfg.n_periods, self.plan.kv_cache_dtype,
        )
        return self.n_kv_page_reads * per_page

    def acceptance_rate(self) -> Optional[float]:
        """Engine-wide draft acceptance (None before any proposal)."""
        if self.n_draft_tokens == 0:
            return None
        return self.n_draft_accepted / self.n_draft_tokens

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.page_size)
        if need > self.n_pages - 1 or len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"request {req.rid} cannot fit: needs {need} pages / "
                f"{len(req.prompt) + req.max_new_tokens} positions"
            )
        req.output = []
        req.status = "queued"
        req.submit_t = self.clock()
        req.submit_order = self._submitted
        self._submitted += 1
        self.queue.append(req)

    def _finish(self, req: Request, status: str, error: Optional[str] = None):
        req.done = True
        req.status = status
        req.error = error
        req.finish_t = self.clock()
        if status == "shed":
            self.n_shed += 1
        elif status == "deadline_missed":
            self.n_deadline_missed += 1
        self.finished.append(req)

    def _release_lane(self, lane: int):
        seq = self.lanes[lane]
        for p in seq.pages:
            self.pool.release(p)
        self.lanes[lane] = None
        self._set_row(lane, [])
        if self.spec_mgr is not None:  # draft pages go with the lane
            self.spec_mgr.release_lane(lane)

    def _dev_table_now(self) -> torch.Tensor:
        if self._dev_table is None:
            self._dev_table = torch.as_tensor(self.table, device=self.device)
        return self._dev_table

    def _set_row(self, lane: int, pages: list):
        self.table[lane] = NULL_PAGE
        self.table[lane, : len(pages)] = pages
        self._dev_table = None

    def _copy_page(self, src: int, dst: int):
        """COW: page ``dst`` becomes a copy of page ``src`` in every leaf and
        period (each leaf is (n_periods, n_pages, ...))."""
        for leaves in self.cache.values():
            for a in leaves.values():
                a[:, dst] = a[:, src]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- SLO bookkeeping ------------------------------------------------
    def _queue_pick(self) -> int:
        """Index into ``self.queue`` of the next request to admit: arrival
        order under ``fifo``; under ``slo`` highest priority, then earliest
        deadline, then arrival (low-priority work parks, holding no pages)."""
        if self.scheduler == "fifo" or len(self.queue) == 1:
            return 0
        return min(
            range(len(self.queue)),
            key=lambda i: (
                -self.queue[i].priority,
                self.queue[i].deadline_at(),
                self.queue[i].submit_order,
            ),
        )

    def _provably_unmeetable(self, req: Request) -> Optional[str]:
        """A rejection reason when even the optimistic completion bound (own
        prefill chunks + remaining decode steps at the fastest observed step
        costs, no queueing, no pool pressure) overshoots the deadline."""
        if req.deadline_ms is None or self._min_decode_s is None:
            return None  # no deadline, or no cost evidence: nothing is provable
        now = self.clock()
        deadline = req.deadline_at()
        T = len(req.prompt) + len(req.output)
        n_chunks = -(-T // self.prefill_chunk)
        remaining = req.max_new_tokens - len(req.output)
        t_min = n_chunks * (self._min_chunk_s or 0.0) + remaining * self._min_decode_s
        if now + t_min > deadline:
            return (
                f"deadline {req.deadline_ms:.1f}ms provably unmeetable: "
                f"optimistic completion needs {t_min * 1e3:.1f}ms "
                f"({n_chunks} prefill chunks + {remaining} decode steps at "
                f"best-observed step cost) but only "
                f"{max(deadline - now, 0.0) * 1e3:.1f}ms remain"
            )
        return None

    def _expire_deadlines(self):
        """Terminate queued and running requests whose deadline has passed:
        partial output is kept, pages are freed at once."""
        if self.scheduler != "slo":
            return
        now = self.clock()
        for req in [r for r in self.queue if r.deadline_at() <= now]:
            self.queue.remove(req)
            self._finish(req, "deadline_missed")
        for lane, seq in enumerate(self.lanes):
            if seq is not None and seq.req.deadline_at() <= now:
                req = seq.req
                self._release_lane(lane)
                self._finish(req, "deadline_missed")

    # -- admission ------------------------------------------------------
    def _admit(self):
        for lane in range(self.max_batch):
            if self.lanes[lane] is not None or not self.queue:
                continue
            req = self.queue[self._queue_pick()]
            if self.scheduler == "slo":
                reason = self._provably_unmeetable(req)
                if reason is not None:
                    self.queue.remove(req)
                    self._finish(req, "shed", reason)
                    continue
            if req.max_new_tokens <= 0:  # nothing to generate: skip the pool
                self.queue.remove(req)
                self._finish(req, "completed")
                continue
            toks = list(map(int, req.prompt)) + list(req.output)
            T = len(toks)
            tt = tuple(toks)
            pages, n_cached, cow_src = [], 0, None
            if self.prefix_cache:
                pages, n_cached = self.pool.match_full(tt)
                cow_src = self.pool.match_partial(tt, n_cached)
            need = -(-T // self.page_size) - len(pages)
            fresh = self.pool.alloc(need)
            if fresh is None:  # head-of-line blocking keeps priority order
                for p in pages:
                    self.pool.release(p)
                break
            if cow_src is not None and fresh:
                # Copy-on-write partial hit: the first fresh page starts as a
                # copy of the cached page, whose matched slots are valid KV.
                self._copy_page(cow_src, fresh[0])
                n_cached = T
                self.n_cow_hits += 1
            elif pages and n_cached >= T:
                # Full-coverage hit: the replay decode writes position T-1
                # with decode-path bytes, so never into a shared page; the
                # sequence gets a private copy of the last one.
                repl = self.pool.alloc(1)
                if repl is None:
                    for p in pages:
                        self.pool.release(p)
                    # Matched pages + 1 COW page beyond what the pool could
                    # ever hold: reject instead of re-matching forever.
                    if -(-T // self.page_size) + 1 > self.n_pages - 1:
                        self.queue.remove(req)
                        self._finish(
                            req, "shed",
                            f"request {req.rid} unsatisfiable: full prefix-"
                            f"cache hit needs {-(-T // self.page_size)} "
                            f"matched pages + 1 replay copy-on-write page, "
                            f"but the pool holds only {self.n_pages - 1} "
                            "allocatable pages — admission would livelock",
                        )
                        continue
                    break
                self._copy_page(pages[-1], repl[0])
                self.pool.release(pages[-1])
                pages[-1] = repl[0]
                self.n_cow_hits += 1
            self.queue.remove(req)
            seq = _Seq(
                req=req, tokens=toks, pages=pages + fresh,
                n_prefilled=n_cached, n_target=T,
                hashed_upto=len(pages), order=self._admitted,
            )
            self._admitted += 1
            self.n_prefix_hit_tokens += n_cached
            self.lanes[lane] = seq
            self._set_row(lane, seq.pages)
            if seq.n_prefilled >= T:
                self._arm_decode(lane, seq)

    def _arm_decode(self, lane: int, seq: _Seq):
        # The replay decode writes position T-1 with decode-path bytes.  If
        # that page is registered in the prefix cache (a page-aligned prompt's
        # final page), the sequence gets a private copy, so registered
        # content stays exactly what a cold prefill writes.
        pg = (seq.n_target - 1) // self.page_size
        pid = seq.pages[pg]
        if pid in self.pool.key_of:
            repl = self.pool.alloc(1)
            if repl is not None:
                self._copy_page(pid, repl[0])
                self.pool.release(pid)
                seq.pages[pg] = repl[0]
                self.table[lane, pg] = repl[0]
                self._dev_table = None
                self.n_guard_copies += 1
            else:
                # Pool dry: write in place, but drop the registration so no
                # later prefix hit reads the mutated bytes.
                self.pool._unregister(pid)
        self.slot_pos[lane] = seq.n_target - 1  # replay the last known token
        self._last_tok[lane, 0] = seq.tokens[-1]
        if self.spec_mgr is not None:
            self.spec_mgr.attach(lane, seq)

    # -- chunked prefill -------------------------------------------------
    def _register_ready(self, seq: _Seq):
        psz = self.page_size
        while (seq.hashed_upto + 1) * psz <= seq.n_prefilled:
            i = seq.hashed_upto
            self.pool.register(seq.pages[i], tuple(seq.tokens[: (i + 1) * psz]))
            seq.hashed_upto = i + 1

    def _prefill_step(self) -> bool:
        """Run one prompt chunk (the oldest unfinished prefill).  Chunks are
        padded to ``prefill_chunk``; pad positions write into the null page
        or into not-yet-valid slots that decode rewrites before any length
        mask exposes them."""
        cand = [
            (s.order, lane, s)
            for lane, s in enumerate(self.lanes)
            if s is not None and s.n_prefilled < s.n_target
        ]
        if not cand:
            return False
        _, lane, seq = min(cand)
        off = seq.n_prefilled
        C = min(self.prefill_chunk, seq.n_target - off)
        buf = np.zeros((1, self.prefill_chunk), np.int32)
        buf[0, :C] = seq.tokens[off : off + C]
        t0, w0 = self.clock(), time.perf_counter()
        self.cache = paged_prefill_chunk(
            self.plan, self.params, buf, self.cache,
            self._dev_table_now()[lane : lane + 1], off,
        )
        self._sync()
        self.prefill_seconds += time.perf_counter() - w0
        dt = self.clock() - t0
        if dt > 0:
            self._min_chunk_s = dt if self._min_chunk_s is None else min(self._min_chunk_s, dt)
        seq.n_prefilled += C
        self.n_prefill_chunks += 1
        self.n_prefill_tokens += C
        if self.prefix_cache:
            self._register_ready(seq)
        if seq.n_prefilled >= seq.n_target:
            self._arm_decode(lane, seq)
        return True

    # -- decode ----------------------------------------------------------
    def _preempt(self, lane: int):
        seq = self.lanes[lane]
        self._release_lane(lane)
        seq.req.n_preemptions += 1
        if self.scheduler == "fifo":
            self.queue.insert(0, seq.req)  # resume first; output so far is kept
        else:
            # slo: _queue_pick favours the earliest submit_order within a
            # priority class, so the request still resumes ahead of later
            # arrivals of equal urgency.
            self.queue.append(seq.req)
        self.n_preemptions += 1

    def _victim(self, victims: list) -> int:
        """Preemption victim: under ``slo`` the lowest-priority, most-slack,
        newest sequence; under ``fifo`` the newest."""
        if self.scheduler == "fifo":
            return max(victims, key=lambda i: self.lanes[i].order)
        now = self.clock()
        return max(
            victims,
            key=lambda i: (
                -self.lanes[i].req.priority,
                self.lanes[i].req.deadline_at() - now,
                self.lanes[i].order,
            ),
        )

    def _decode_ready(self):
        return [
            i for i, s in enumerate(self.lanes)
            if s is not None and s.n_prefilled >= s.n_target
        ]

    def _ensure_capacity(self) -> list[int]:
        """Grow each decoding lane's pages to cover its write position,
        preempting by deadline/priority when the pool runs dry."""
        while True:
            active = self._decode_ready()
            blocked = None
            for i in active:
                seq = self.lanes[i]
                pg = int(self.slot_pos[i]) // self.page_size
                if pg < len(seq.pages):
                    continue
                got = self.pool.alloc(1)
                if got is None:
                    blocked = i
                    break
                seq.pages.append(got[0])
                self.table[i, pg] = got[0]
                self._dev_table = None
            if blocked is None:
                return self._decode_ready()
            victims = self._decode_ready() + [
                j for j, s in enumerate(self.lanes)
                if s is not None and s.n_prefilled < s.n_target
            ]
            victim = self._victim(victims)
            if victim == blocked and len(victims) == 1:
                seq = self.lanes[blocked]
                need = -(-(len(seq.req.prompt) + seq.req.max_new_tokens) // self.page_size)
                if need > self.n_pages - 1:
                    raise RuntimeError(
                        "page pool too small for a single sequence"
                    )  # pragma: no cover — submit() bounds prevent this
                # The pool can hold this sequence, so the failure is a
                # transient denial: preempt the blocked sequence itself; a
                # later step resumes it once allocation succeeds again.
            self._preempt(victim)

    def _decode_step(self) -> bool:
        """One decode round: propose → verify → commit.  Without a
        SpecConfig there is no proposal and the verify is the plain
        single-token decode step."""
        active = self._ensure_capacity()
        if not active:
            return False
        w0 = time.perf_counter()
        proposals = self._propose(active)
        self.propose_seconds += time.perf_counter() - w0
        logits = self._verify(active, proposals)
        self.decode_seconds += time.perf_counter() - w0
        self._commit(active, proposals, logits)
        return True

    def _propose(self, active: list) -> dict:
        """``{lane: [draft tokens]}`` (all empty without speculation).  The
        budget keeps a round from writing past ``prompt + max_new − 2`` or
        the window, so γ beyond ``max_new`` shortens a proposal and never
        overshoots; draft pages come from the manager, which shortens on a
        dry pool and never preempts."""
        if self.spec_mgr is None:
            return {i: [] for i in active}
        items = []
        for i in active:
            seq = self.lanes[i]
            budget = min(seq.req.max_new_tokens - len(seq.req.output) - 1,
                         self.max_seq - 2 - int(self.slot_pos[i]))
            items.append((i, seq, int(self.slot_pos[i]), budget))
        return self.spec_mgr.propose(items)

    def _verify(self, active: list, proposals: dict) -> np.ndarray:
        """The target's fp32 logits ``(B, L, V)`` for every lane's replay
        token and proposal.  With no proposal anywhere this is the plain
        decode step (L = 1), the only branch that feeds the shed floor a
        single step's cost.  The target's lookahead pages are grown here; on
        a dry pool the proposal shortens (only ``_ensure_capacity``
        preempts)."""
        for i in active:
            seq, d = self.lanes[i], len(proposals[i])
            while d:
                pg = (int(self.slot_pos[i]) + d) // self.page_size
                if pg < len(seq.pages):
                    break
                got = self.pool.alloc(1)
                if got is None:
                    d -= 1
                    continue
                seq.pages.append(got[0])
                self.table[i, len(seq.pages) - 1] = got[0]
                self._dev_table = None
            proposals[i] = proposals[i][:d]

        if not any(proposals[i] for i in active):
            write_page = np.full(self.max_batch, NULL_PAGE, np.int64)
            pos = np.zeros(self.max_batch, np.int64)
            for i in active:
                seq = self.lanes[i]
                pos[i] = self.slot_pos[i]
                write_page[i] = seq.pages[int(self.slot_pos[i]) // self.page_size]
                self.n_kv_page_reads += -(-(int(self.slot_pos[i]) + 1) // self.page_size)
            t0 = self.clock()
            logits, self.cache = paged_decode_step(
                self.plan, self.params, self._last_tok, self.cache, pos,
                self._dev_table_now(), write_page,
            )
            logits = _host_logits(logits)
            self.n_decode_steps += 1
            dt = self.clock() - t0
            if dt > 0:
                self._min_decode_s = dt if self._min_decode_s is None else min(self._min_decode_s, dt)
            return logits[:, None]

        L = self.spec.gamma + 1  # one shape for every outcome
        toks = np.zeros((self.max_batch, L), np.int32)
        wp = np.full((self.max_batch, L), NULL_PAGE, np.int64)
        pos = np.zeros(self.max_batch, np.int64)
        for i in active:
            seq, p0 = self.lanes[i], int(self.slot_pos[i])
            pos[i] = p0
            toks[i, 0] = self._last_tok[i, 0]
            props = proposals[i]
            toks[i, 1 : 1 + len(props)] = props
            for j in range(len(props) + 1):
                wp[i, j] = seq.pages[(p0 + j) // self.page_size]
                self.n_kv_page_reads += -(-(p0 + j + 1) // self.page_size)
        t0 = self.clock()
        logits, self.cache = paged_verify_tokens(self.plan, self._verify_params, toks, self.cache,
                                                 pos, self._dev_table_now(), wp)
        logits = _host_logits(logits)
        self.n_decode_steps += 1
        self.n_spec_rounds += 1
        dt = self.clock() - t0
        if dt > 0:
            # Per position: a position never costs less, so the shed bound
            # stays a lower bound.
            per = dt / L
            self._min_decode_s = per if self._min_decode_s is None else min(self._min_decode_s, per)
        return logits

    def _commit(self, active: list, proposals: dict, logits: np.ndarray):
        """Per lane, commit the longest prefix of the proposal that matches
        the target's argmaxes and the target's token after it (the whole
        round without a proposal); draft pages past the new frontier roll
        back."""
        now = self.clock()
        for i in active:
            seq, props = self.lanes[i], proposals[i]
            greedy = [int(np.argmax(logits[i, j])) for j in range(len(props) + 1)]
            a = greedy_accept_len(props, greedy)
            if self.spec_mgr is not None:
                seq.req.n_spec_rounds += 1
                seq.req.n_draft_tokens += len(props)
                seq.req.n_draft_accepted += a
                self.n_draft_tokens += len(props)
                self.n_draft_accepted += a
            for j in range(a + 1):
                tok = greedy[j]
                if self.record_logits:
                    self.logit_trace.setdefault(seq.req.rid, []).append(logits[i, j])
                self._last_tok[i, 0] = tok
                if not seq.req.output:
                    seq.req.first_token_t = now
                seq.req.output.append(tok)
                seq.tokens.append(tok)
                self.slot_pos[i] += 1
            if self.spec_mgr is not None:
                self.spec_mgr.commit(i, int(self.slot_pos[i]))

    def _retire(self):
        for i, seq in enumerate(self.lanes):
            if seq is None or seq.n_prefilled < seq.n_target:
                continue
            req = seq.req
            if len(req.output) >= req.max_new_tokens or self.slot_pos[i] >= self.max_seq - 1:
                self._release_lane(i)
                self._finish(req, "preempted_resumed" if req.n_preemptions else "completed")

    # ------------------------------------------------------------------
    def step(self) -> bool:
        try:
            fault_point("engine.step")
        except TransientFault:
            # Raised before any state mutation: a pure no-op step.
            self.n_transient_faults += 1
            return True
        self._expire_deadlines()
        self._admit()
        progressed = self._prefill_step()
        # Nothing can decode yet (cold start, or after a preemption): drain
        # prefills instead of stepping empty, for time to first token.
        while progressed and not self._decode_ready():
            if not self._prefill_step():
                break
        progressed |= self._decode_step()
        self._retire()
        # Queued work, an idle engine and no progress: admission was blocked
        # by a transient allocation denial; keep stepping so it can pass.
        if not progressed and self.queue and not any(s is not None for s in self.lanes):
            return True
        return progressed

    def run(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or any(s is not None for s in self.lanes)) and steps < max_steps:
            if not self.step():
                break
            steps += 1
        return self.finished
