"""The port's serving engines: the engine tests of the JAX package
(``tests/test_paged_serve.py``, ``tests/test_slo_serve.py`` and the serving
cases of ``tests/test_chaos.py``) run on the port, and the port's engines
held against the reference's on the same requests.

Reduced Phi-3 on the CPU.  Tolerances: token streams and prefix-hit logits
exactly (the engines' own contracts); port against reference on a reduced
fp32 model, the recorded logits within 1e-4 of each step's max |logit|
(the KV cache is bf16 in both, so an fp32 rounding difference now and then
flips one cache entry by a bf16 ulp, which moves the logits by ~1e-5
absolute: a per-element relative bound would fail on logits near zero),
and the greedy tokens equal up to the first step where either run's top-2
margin falls below twice that tolerance (a near-tie there may go either
way, and then the streams part).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import solver as jsolver
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.quant import GridSpec as JSpec
from repro.serve import qparams as jqparams
from repro.serve.engine import PagedServingEngine as JPagedEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.data import pipeline as tpipe
from repro_torch.faults import FaultPlan, FaultSpec, fault_plan
from repro_torch.models import model as tm
from repro_torch.serve import PagedServingEngine, Request, ServingEngine
from repro_torch.serve.kv_cache import page_nbytes
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def served_model():
    cfg = reduce_cfg(tget("phi3_mini_3_8b"), d_model=96, head_dim=24, d_ff=192, n_periods=2)
    plan = tm.make_plan(cfg)
    params = tm.init_params(plan, 0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 250, n).astype(np.int32) for n in (6, 21, 47, 11, 33)]
    return plan, params, prompts


def _serve(eng, prompts, max_new=7):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    return [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]


def _paged(plan, params, **kw):
    return PagedServingEngine(plan, params, **CPU, **kw)


def _contig(plan, params, **kw):
    return ServingEngine(plan, params, **CPU, **kw)


# ---------------------------------------------------------------------------
# Paged engine behaviour (tests/test_paged_serve.py)
# ---------------------------------------------------------------------------


def test_paged_engine_token_identical_to_contiguous(served_model):
    plan, params, prompts = served_model
    contig = _serve(_contig(plan, params, max_batch=2, max_seq=128, prefill_pad=8), prompts)
    paged = _serve(_paged(plan, params, max_batch=2, max_seq=128, page_size=8, prefill_chunk=16),
                   prompts)
    assert contig == paged


def test_paged_long_prompt_spans_many_chunks(served_model):
    plan, params, prompts = served_model
    eng = _paged(plan, params, max_batch=1, max_seq=128, page_size=8, prefill_chunk=16)
    out = _serve(eng, [prompts[2]])
    assert eng.n_prefill_chunks == 3  # ceil(47 / 16)
    big = _paged(plan, params, max_batch=1, max_seq=128, page_size=8, prefill_chunk=64)
    assert out == _serve(big, [prompts[2]])


def test_paged_max_new_tokens_zero(served_model):
    plan, params, prompts = served_model
    for eng in (_contig(plan, params, max_batch=2, max_seq=64),
                _paged(plan, params, max_batch=2, max_seq=64, page_size=8)):
        eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=0))
        fin = eng.run()
        assert fin[0].done and fin[0].output == []
    assert eng.pool.n_free == eng.n_pages - 1  # no pages leaked


def test_paged_page_refill_mid_decode(served_model):
    """page_size 4 forces fresh pages mid-decode; outputs still match."""
    plan, params, prompts = served_model
    contig = _serve(_contig(plan, params, max_batch=2, max_seq=64, prefill_pad=8), prompts[:2])
    eng = _paged(plan, params, max_batch=2, max_seq=64, page_size=4, prefill_chunk=8)
    assert _serve(eng, prompts[:2]) == contig


def test_paged_unaligned_max_seq_pad_overflow(served_model):
    """max_seq not page-aligned: the final chunk's pad positions run past the
    page table and must land on the null page, not on the last real page."""
    plan, params, _ = served_model
    prompt = np.random.default_rng(13).integers(0, 250, 50).astype(np.int32)
    contig = _serve(_contig(plan, params, max_batch=1, max_seq=64, prefill_pad=8), [prompt], 4)
    paged = _serve(_paged(plan, params, max_batch=1, max_seq=55, page_size=8, prefill_chunk=16),
                   [prompt], 4)
    assert contig == paged


def test_prefix_cache_hit_bit_identical(served_model):
    plan, params, prompts = served_model
    eng = _paged(plan, params, max_batch=1, max_seq=128, page_size=8, prefill_chunk=16,
                 record_logits=True)
    eng.submit(Request(rid=0, prompt=prompts[2], max_new_tokens=5))
    eng.run()
    warm_before = eng.n_prefill_tokens
    eng.submit(Request(rid=1, prompt=prompts[2], max_new_tokens=5))
    eng.run()
    o0, o1 = (r.output for r in sorted(eng.finished, key=lambda r: r.rid))
    assert o0 == o1
    assert eng.n_prefix_hit_tokens == 40  # 5 full pages of the 47-token prompt
    assert eng.n_prefill_tokens - warm_before == 7
    assert all(np.array_equal(a, b) for a, b in zip(eng.logit_trace[0], eng.logit_trace[1]))


def test_prefix_cache_cow_partial_page(served_model):
    plan, params, _ = served_model
    A = np.random.default_rng(11).integers(0, 250, 48).astype(np.int32)
    eng = _paged(plan, params, max_batch=1, max_seq=128, page_size=8, prefill_chunk=16)
    eng.submit(Request(rid=0, prompt=A, max_new_tokens=4))
    eng.run()
    eng.submit(Request(rid=1, prompt=A[:43], max_new_tokens=4))
    eng.run()
    assert eng.n_cow_hits == 1
    warm = [r for r in eng.finished if r.rid == 1][0].output
    cold = _paged(plan, params, max_batch=1, max_seq=128, page_size=8, prefill_chunk=16,
                  prefix_cache=False)
    cold.submit(Request(rid=1, prompt=A[:43], max_new_tokens=4))
    assert warm == cold.run()[0].output


def test_full_prefix_hit_never_writes_live_shared_page(served_model):
    plan, params, _ = served_model
    A = np.random.default_rng(17).integers(0, 250, 48).astype(np.int32)

    def run(with_b):
        eng = _paged(plan, params, max_batch=2, max_seq=128, page_size=8, prefill_chunk=16)
        eng.submit(Request(rid=0, prompt=A, max_new_tokens=12))
        for _ in range(8):
            eng.step()
        snap = None
        if with_b:
            shared = eng.lanes[0].pages[1]
            snap = eng.cache["b0"]["k"][:, shared].clone()
            eng.submit(Request(rid=1, prompt=A[:16], max_new_tokens=4))
        eng.run()
        if with_b:
            assert eng.n_cow_hits == 1 and eng.n_guard_copies == 1
            assert torch.equal(snap, eng.cache["b0"]["k"][:, shared])
        return [r.output for r in sorted(eng.finished, key=lambda r: r.rid)]

    solo = run(False)[0]
    both = run(True)
    assert both[0] == solo
    cold = _paged(plan, params, max_batch=1, max_seq=128, page_size=8, prefill_chunk=16,
                  prefix_cache=False)
    cold.submit(Request(rid=1, prompt=A[:16], max_new_tokens=4))
    assert both[1] == cold.run()[0].output


def test_eviction_then_resume_deterministic(served_model):
    plan, params, prompts = served_model
    ample = _serve(_paged(plan, params, max_batch=3, max_seq=128, page_size=8, prefill_chunk=16),
                   prompts)
    tight = _paged(plan, params, max_batch=3, max_seq=128, page_size=8, n_pages=13,
                   prefill_chunk=16, prefix_cache=False)
    assert _serve(tight, prompts) == ample
    assert tight.n_preemptions >= 1
    assert tight.pool.n_free == tight.n_pages - 1


def test_paged_int8_kv_tracks_contiguous(served_model):
    plan_bf, params, prompts = served_model
    plan8 = tm.make_plan(plan_bf.cfg, kv_cache_dtype="int8")
    contig = _serve(_contig(plan8, params, max_batch=2, max_seq=128, prefill_pad=8), prompts[:3], 5)
    paged = _serve(_paged(plan8, params, max_batch=2, max_seq=128, page_size=8, prefill_chunk=16),
                   prompts[:3], 5)
    # Chunked prefill attends dequantized pages, the contiguous prefill fresh
    # k/v: a near-tie flip then compounds, so agreement, not identity.
    agree = np.mean([a == b for x, y in zip(paged, contig) for a, b in zip(x, y)])
    assert agree > 0.5


def test_submit_rejects_oversized_request(served_model):
    plan, params, _ = served_model
    eng = _paged(plan, params, max_batch=1, max_seq=64, page_size=8)
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=np.zeros(60, np.int32), max_new_tokens=16))
    with pytest.raises(ValueError):  # longer than max_seq on the contiguous engine
        _contig(plan, params, max_batch=1, max_seq=64).submit(
            Request(rid=0, prompt=np.zeros(65, np.int32), max_new_tokens=0))


def test_window_filling_prompt_both_engines(served_model):
    """len(prompt) == max_seq: refused with max_new > 0, served empty with 0."""
    plan, params, _ = served_model
    prompt = np.random.default_rng(5).integers(0, 250, 64).astype(np.int32)
    for make in (lambda: _contig(plan, params, max_batch=1, max_seq=64, prefill_pad=8),
                 lambda: _paged(plan, params, max_batch=1, max_seq=64, page_size=8)):
        with pytest.raises(ValueError):
            make().submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
        eng = make()
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=0))
        fin = eng.run()
        assert [r.output for r in fin] == [[]] and fin[0].done


def test_exact_fit_generates_all_tokens_both_engines(served_model):
    plan, params, _ = served_model
    prompt = np.random.default_rng(6).integers(0, 250, 60).astype(np.int32)
    outs = []
    for eng in (_contig(plan, params, max_batch=1, max_seq=64, prefill_pad=8),
                _paged(plan, params, max_batch=1, max_seq=64, page_size=8, prefill_chunk=16)):
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
        fin = eng.run()
        assert len(fin) == 1 and len(fin[0].output) == 4
        outs.append(fin[0].output)
    assert outs[0] == outs[1]


def test_paged_int4_kv_bounded_perturbation(served_model):
    """int4 KV perturbs the first decode logits boundedly (the reference's
    bound, 0.25), int8 strictly less, and the page-read counter prices int4
    at half a byte per element."""
    plan_bf, params, prompts = served_model

    def first_logits(plan):
        eng = _paged(plan, params, max_batch=2, max_seq=128, page_size=8, prefill_chunk=16,
                     record_logits=True)
        for i, p in enumerate(prompts[:3]):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
        eng.run()
        return eng, {i: tr[0] for i, tr in eng.logit_trace.items()}

    _, lg_bf = first_logits(plan_bf)
    eng4, lg4 = first_logits(tm.make_plan(plan_bf.cfg, kv_cache_dtype="int4"))
    _, lg8 = first_logits(tm.make_plan(plan_bf.cfg, kv_cache_dtype="int8"))
    d4 = max(float(np.abs(lg4[i] - lg_bf[i]).max()) for i in lg_bf)
    d8 = max(float(np.abs(lg8[i] - lg_bf[i]).max()) for i in lg_bf)
    assert 0 < d4 < 0.25
    assert d8 < d4
    hp = eng4.plan.heads
    assert eng4.n_kv_page_reads > 0
    assert eng4.kv_read_bytes() == eng4.n_kv_page_reads * page_nbytes(
        8, hp.kv_pad, hp.head_dim, plan_bf.cfg.n_periods, "int4")


def test_contiguous_cache_rejects_int4(served_model):
    plan_bf, params, _ = served_model
    with pytest.raises(ValueError, match="paged"):
        _contig(tm.make_plan(plan_bf.cfg, kv_cache_dtype="int4"), params, max_batch=2, max_seq=64)


def test_int4_eviction_then_resume_deterministic(served_model):
    plan_bf, params, prompts = served_model
    plan4 = tm.make_plan(plan_bf.cfg, kv_cache_dtype="int4")
    kw = dict(max_batch=3, max_seq=128, page_size=8, prefill_chunk=16, prefix_cache=False)
    ample = _serve(_paged(plan4, params, **kw), prompts)
    tight1 = _paged(plan4, params, n_pages=13, **kw)
    out1 = _serve(tight1, prompts)
    assert _serve(_paged(plan4, params, n_pages=13, **kw), prompts) == out1
    assert tight1.n_preemptions >= 1
    agree = np.mean([a == b for x, y in zip(out1, ample) for a, b in zip(x, y)])
    assert agree > 0.5
    assert tight1.pool.n_free == tight1.n_pages - 1


def test_admission_livelock_regression(served_model):
    """A zero-generation request whose prompt fully hits the prefix cache
    completes at admission without touching the pool."""
    plan, params, _ = served_model
    A = np.random.default_rng(9).integers(0, 250, 40).astype(np.int32)
    eng = _paged(plan, params, max_batch=2, max_seq=128, page_size=8, n_pages=6, prefill_chunk=16)
    pages = eng.pool.alloc(5)
    for j, p in enumerate(pages):
        eng.pool.register(p, tuple(int(t) for t in A[: 8 * (j + 1)]))
        eng.pool.release(p)
    req = Request(rid=0, prompt=A, max_new_tokens=0)
    eng.submit(req)
    fin = eng.run(max_steps=50)
    assert fin == [req] and req.status == "completed" and req.output == []
    assert eng.pool.n_free == eng.n_pages - 1


def test_port_specific_refusals(served_model):
    from repro_torch.serve.spec import SpecConfig, truncate_draft

    plan, params, _ = served_model
    on_meta = tm.tree_map(lambda a: a.to("meta"), params)
    with pytest.raises(ValueError, match="draft params live on meta"):
        _paged(plan, params, spec=SpecConfig(*truncate_draft(plan, on_meta, 1)))
    for make in (PagedServingEngine, ServingEngine):
        with pytest.raises(ValueError, match="live on meta"):
            make(plan, on_meta, device="cpu")
    if not torch.cuda.is_available():
        for make in (PagedServingEngine, ServingEngine):
            with pytest.raises(RuntimeError, match="CUDA"):
                make(plan, params)


# ---------------------------------------------------------------------------
# SLO scheduling (tests/test_slo_serve.py), on an injected clock
# ---------------------------------------------------------------------------


class StepClock:
    """Deterministic engine clock: each call advances one virtual second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1.0
        return self.t


@pytest.fixture(scope="module")
def slo_model():
    plan = tm.make_plan(reduce_cfg(tget("phi3_mini_3_8b")))
    params = tm.init_params(plan, 0, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 250, n).astype(np.int32) for n in (6, 10, 10, 9)]
    return plan, params, prompts


_KW = dict(max_batch=2, max_seq=128, page_size=8, prefill_chunk=16, prefix_cache=False)


def test_scheduler_name_validated(slo_model):
    plan, params, _ = slo_model
    with pytest.raises(ValueError, match="unknown scheduler"):
        _paged(plan, params, scheduler="edf", **_KW)


def test_queue_pick_priority_then_deadline_then_arrival(slo_model):
    plan, params, prompts = slo_model
    eng = _paged(plan, params, clock=StepClock(), **_KW)
    r0 = Request(rid=0, prompt=prompts[0], max_new_tokens=2)
    r1 = Request(rid=1, prompt=prompts[0], max_new_tokens=2, priority=1, deadline_ms=5_000)
    r2 = Request(rid=2, prompt=prompts[0], max_new_tokens=2, priority=1, deadline_ms=2_000)
    r3 = Request(rid=3, prompt=prompts[0], max_new_tokens=2, priority=2)
    for r in (r0, r1, r2, r3):
        eng.submit(r)
    for want in (r3, r2, r1, r0):
        got = eng.queue[eng._queue_pick()]
        assert got is want
        eng.queue.remove(got)
    fifo = _paged(plan, params, scheduler="fifo", clock=StepClock(), **_KW)
    for r in (Request(rid=0, prompt=prompts[0], max_new_tokens=2),
              Request(rid=1, prompt=prompts[0], max_new_tokens=2, priority=9)):
        fifo.submit(r)
    assert fifo._queue_pick() == 0


def test_provably_unmeetable_deadline_is_shed(slo_model):
    plan, params, prompts = slo_model
    eng = _paged(plan, params, clock=StepClock(), **_KW)
    hopeless = Request(rid=9, prompt=prompts[0], max_new_tokens=1, deadline_ms=0.001)
    assert eng._provably_unmeetable(hopeless) is None  # cold: nothing is provable
    eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=2))
    eng.run()
    assert eng._min_decode_s is not None and eng._min_chunk_s is not None
    doomed = Request(rid=1, prompt=prompts[0], max_new_tokens=20, deadline_ms=3_000)
    eng.submit(doomed)
    eng.run()
    assert doomed.status == "shed" and doomed.done and "provably unmeetable" in doomed.error
    assert doomed.output == [] and eng.n_shed == 1
    fine = Request(rid=2, prompt=prompts[0], max_new_tokens=20, deadline_ms=10_000_000)
    eng.submit(fine)
    eng.run()
    assert fine.status == "completed" and len(fine.output) == 20
    assert eng.pool.n_free == eng.n_pages - 1


def test_deadline_missed_mid_generation_keeps_partial_output(slo_model):
    plan, params, prompts = slo_model
    eng = _paged(plan, params, clock=StepClock(), **_KW)
    req = Request(rid=0, prompt=prompts[0], max_new_tokens=20, deadline_ms=20_000)
    eng.submit(req)
    fin = eng.run()
    assert fin == [req] and req.status == "deadline_missed"
    assert 0 < len(req.output) < 20 and req.first_token_t is not None
    assert eng.n_deadline_missed == 1
    assert eng.pool.n_free == eng.n_pages - 1


def test_fifo_scheduler_matches_slo_for_default_requests(slo_model):
    plan, params, prompts = slo_model

    def serve(**kw):
        eng = _paged(plan, params, **_KW | kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        eng.run()
        return eng, [r.output for r in sorted(eng.finished, key=lambda r: r.rid)]

    _, ample = serve()
    slo_eng, slo_out = serve(n_pages=7, scheduler="slo")
    fifo_eng, fifo_out = serve(n_pages=7, scheduler="fifo")
    assert slo_out == ample and fifo_out == ample
    assert slo_eng.n_preemptions == fifo_eng.n_preemptions
    assert slo_eng.pool.n_free == slo_eng.n_pages - 1


def test_priority_preemption_evicts_low_priority_lane(slo_model):
    plan, params, prompts = slo_model
    kw = dict(max_batch=2, max_seq=64, page_size=4, prefill_chunk=16, prefix_cache=False)

    def serve(**over):
        eng = _paged(plan, params, **kw | over)
        back = Request(rid=0, prompt=prompts[1], max_new_tokens=8)
        urgent = Request(rid=1, prompt=prompts[2], max_new_tokens=8, priority=5)
        eng.submit(back)
        eng.submit(urgent)
        eng.run()
        return eng, back, urgent

    _, back_a, urgent_a = serve()
    eng, back, urgent = serve(n_pages=7)
    assert eng.n_preemptions >= 1
    assert urgent.status == "completed" and urgent.n_preemptions == 0
    assert back.status == "preempted_resumed" and back.n_preemptions >= 1
    assert urgent.output == urgent_a.output and back.output == back_a.output
    assert eng.pool.n_free == eng.n_pages - 1


def test_low_priority_parks_until_urgent_work_drains(slo_model):
    plan, params, prompts = slo_model

    def serve(scheduler):
        eng = _paged(plan, params, scheduler=scheduler, **_KW | {"max_batch": 1})
        for r in (Request(rid=0, prompt=prompts[1], max_new_tokens=3),
                  Request(rid=1, prompt=prompts[2], max_new_tokens=3, priority=5),
                  Request(rid=2, prompt=prompts[3], max_new_tokens=3, priority=5)):
            eng.submit(r)
        return [r.rid for r in eng.run()]

    assert serve("slo") == [1, 2, 0]
    assert serve("fifo") == [0, 1, 2]


# ---------------------------------------------------------------------------
# Fault injection (the serving cases of tests/test_chaos.py)
# ---------------------------------------------------------------------------


def _serve_outputs(plan, params, prompts, fplan=None, **kw):
    eng = _paged(plan, params, **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=7))
    with fault_plan(fplan):
        eng.run(max_steps=2_000)
    return eng, {r.rid: r for r in eng.finished}


def test_chaos_serving_invariant(served_model):
    """Under engine-step transients, pool-exhaustion spikes and kernel-dispatch
    denials (on the CPU each denied call takes the plain version) every request
    finishes completed or preempted_resumed with the fault-free tokens, and no
    page leaks."""
    plan, params, prompts = served_model
    kw = dict(max_batch=3, max_seq=128, page_size=8, n_pages=13, prefill_chunk=16,
              prefix_cache=False)
    _, clean = _serve_outputs(plan, params, prompts, **kw)
    assert len(clean) == len(prompts)
    fplan = FaultPlan([
        FaultSpec(site="engine.step", kind="transient", at=(0, 3, 7), window=(11, 14)),
        FaultSpec(site="pool.alloc", kind="deny", at=(2, 5, 9), window=(12, 15), p=0.05,
                  max_fires=12),
        FaultSpec(site="kernel.dispatch", kind="deny", window=(0, 10_000)),
    ], seed=42)
    eng, chaotic = _serve_outputs(plan, params, prompts, fplan=fplan, **kw)
    assert fplan.fired and eng.n_transient_faults >= 3
    assert any(site == "kernel.dispatch" for site, _, _ in fplan.fired)
    assert len(chaotic) == len(prompts)
    for rid, req in chaotic.items():
        assert req.status in ("completed", "preempted_resumed")
        assert req.output == clean[rid].output
    assert eng.pool.n_free == eng.n_pages - 1


def test_chaos_alloc_denial_storm_self_preempts(served_model):
    plan, params, prompts = served_model
    kw = dict(max_batch=1, max_seq=128, page_size=8, prefill_chunk=16, prefix_cache=False)
    _, clean = _serve_outputs(plan, params, [prompts[1]], **kw)
    fplan = FaultPlan([FaultSpec(site="pool.alloc", kind="deny", window=(2, 8))])
    eng, chaotic = _serve_outputs(plan, params, [prompts[1]], fplan=fplan, **kw)
    assert chaotic[0].output == clean[0].output
    assert chaotic[0].status in ("completed", "preempted_resumed")
    assert eng.pool.n_free == eng.n_pages - 1


def test_engine_step_transient_is_pure_noop(served_model):
    plan, params, prompts = served_model
    for eng, idle in ((_paged(plan, params, max_batch=2, max_seq=128, page_size=8,
                              prefill_chunk=16), lambda e: e.lanes == [None, None]),
                      (_contig(plan, params, max_batch=2, max_seq=128),
                       lambda e: e.slot_req == [None, None])):
        eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=3))
        fplan = FaultPlan([FaultSpec(site="engine.step", kind="transient", at=(0,))])
        with fault_plan(fplan):
            assert eng.step() is True
            assert eng.n_transient_faults == 1 and idle(eng) and len(eng.queue) == 1
            fin = eng.run()
        assert len(fin) == 1 and fin[0].status == "completed"


# ---------------------------------------------------------------------------
# The port's engines against the reference's
# ---------------------------------------------------------------------------


def _fp32_pair(kv="bf16"):
    over = dict(d_model=96, head_dim=24, d_ff=192)
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b"), **over), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b"), **over), dtype=torch.float32)
    return jplan(jcfg, 1, kv_cache_dtype=kv), tm.make_plan(tcfg, kv_cache_dtype=kv)


def _run_both(jeng, teng, prompts, max_new=6):
    for eng, req in ((jeng, JRequest), (teng, Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=p, max_new_tokens=max_new))
        eng.run()
    outs = [{r.rid: r.output for r in e.finished} for e in (jeng, teng)]
    return outs, [e.logit_trace for e in (jeng, teng)]


def _agree(outs, traces, rtol=1e-4):
    """Logits within ``rtol`` of the step's max |logit| at every step both
    runs took with the same history; tokens equal while both top-2 margins
    exceed twice that."""
    (jo, to), (jt, tt) = outs, traces
    assert sorted(jo) == sorted(to)
    compared = 0
    for rid in jo:
        for j, (la, lb) in enumerate(zip(jt[rid], tt[rid])):
            tol = rtol * float(np.abs(la).max())
            np.testing.assert_allclose(lb, la, rtol=0, atol=tol)
            compared += 1
            if min(np.diff(np.sort(l)[-2:])[0] for l in (la, lb)) < 2 * tol:
                break  # a near-tie: the streams may part here
            assert jo[rid][j] == to[rid][j]
    return compared


@pytest.mark.parametrize("engine,kv", [("paged", "bf16"), ("paged", "int8"), ("paged", "int4"),
                                       ("contiguous", "bf16"), ("contiguous", "int8")])
def test_engines_match_jax(engine, kv):
    jp, tp = _fp32_pair(kv)
    params = jinit(jp, jax.random.PRNGKey(0))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 250, n).astype(np.int32) for n in (6, 21, 47, 11, 33)]
    if engine == "paged":
        kw = dict(max_batch=2, max_seq=128, page_size=8, prefill_chunk=16, n_pages=9,
                  record_logits=True)
        jeng, teng = JPagedEngine(jp, params, **kw), PagedServingEngine(tp, tparams, **CPU, **kw)
    else:
        kw = dict(max_batch=2, max_seq=128, prefill_pad=8, record_logits=True)
        jeng, teng = JEngine(jp, params, **kw), ServingEngine(tp, tparams, **CPU, **kw)
    outs, traces = _run_both(jeng, teng, prompts)
    assert _agree(outs, traces) >= len(prompts)
    if engine == "paged":  # a pool of 8 usable pages preempts; both engines alike
        assert teng.n_preemptions == jeng.n_preemptions >= 1
        assert (teng.n_prefill_chunks, teng.n_kv_page_reads, teng.kv_read_bytes()) == (
            jeng.n_prefill_chunks, jeng.n_kv_page_reads, jeng.kv_read_bytes())


def test_quantease_artifact_served_alike():
    """The reference's QuantEase artifact (4 bits, emit="qt", restacked by
    its quantize_params_for_serving) carried across: both paged engines
    serve it alike."""
    jp, tp = _fp32_pair()
    params = jinit(jp, jax.random.PRNGKey(1))
    calib_fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=tp.cfg.vocab, seed=0), tp.cfg, 2, 32,
                                      split="calib")
    calib = [{"tokens": jnp.asarray(calib_fn(i)["tokens"])} for i in range(2)]
    jq, _ = jsolver.ptq_quantize_model(
        jp, params, calib, jsolver.PTQConfig(method="quantease", spec=JSpec(bits=4), iterations=3,
                                             emit="qt"))
    served = jqparams.quantize_params_for_serving(jp, params, jq["dec"])
    tserved = interop.params_from_jax(jax.tree.map(np.asarray, served), device="cpu")
    assert type(tserved["dec"]["b0"]["wq"]).__name__ == "QuantizedTensor"
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 250, n).astype(np.int32) for n in (9, 30, 17)]
    kw = dict(max_batch=2, max_seq=64, page_size=8, prefill_chunk=16, record_logits=True)
    outs, traces = _run_both(JPagedEngine(jp, served, **kw),
                             PagedServingEngine(tp, tserved, **CPU, **kw), prompts)
    assert _agree(outs, traces) >= len(prompts)
