"""Speculative serving and SLO deadlines on a "model" axis, held against the
JAX package.

Two groups of gloo ranks (``tests/_torch_dist.py``: ``tp_spec_rank``, a 2-
and a 3-rank group, both started once for the module, beside the
reference's work here) serve reduced fp32 models from the whole params of
the padded plan (``make_plan(cfg, axis_n)``) the reference makes, carried
across by ``interop``, each rank on its shard (``dist.sharding.shard_tree``
under ``serve.qparams.serving_rules``):

* ``PagedServingEngine(spec=…)`` with the truncated draft (the first of two
  periods of the rank's local params: a view of its shard) and with a 3-bit
  RTN draft (the reference's ``rtn_quantize_for_serving`` of the whole
  params, cut like any artifact), on Phi-3 (at 3 ranks its heads pad and
  its vocabulary 256 → 258), Gemma 2 (a 16-token window, softcaps) and an
  OLMoE-like decoder (4 experts: expert-parallel at 2), against the
  reference's speculative engine on the same padded plan on one device:
  recorded logits within 1e-4 of each step's max |logit|, tokens equal up
  to the first step where a top-2 margin falls below twice that
  (``tests/test_torch_tp.py``'s engine rule); where the streams agree to
  the end, each request's rounds, proposed and accepted draft tokens and
  the pool's free pages equal the reference's.
* The SLO scheduler on a pool that preempts, with requests of no deadline,
  a generous one, one that expires mid-generation and one provably
  unmeetable once the engine is warm, at priorities 0–2, alone and with
  speculation: rank 0's engine reads a ``StepClock``
  (``tests/test_torch_paged_engine.py``'s), every other rank's a clock
  1,000 s ahead running at three times the host's rate, and the
  reference's engine one ``StepClock``.  Every request's status, output,
  error kind and timestamps and the engine's ``n_shed``,
  ``n_deadline_missed`` and ``n_preemptions`` equal the reference's: the
  agreed clock (``serve.engine.AgreedClock``) makes rank 0's decisions on
  every rank, its readings carried in fewer broadcasts than readings (a
  reading that is only recorded rides on the next), and the other ranks'
  clocks are never read.  Their logits are not held to the reference's: in the
  speculative case at 2 ranks one bf16 KV entry of a prompt's prefill
  rounds one ulp from the reference's in period 0 (verified: the port's
  one-rank run of the same padded plan has it too), and the cascade moves
  that request's logits by 1.4e-4 of their max, past the engine rule's
  1e-4, while every token stays the reference's.
* The contiguous engine takes deadline requests on the axis and
  timestamps them as the reference does, with no broadcast in a step that
  stamps no request.

On every rank the outputs, counters, logits (bit for bit), the draft's
proposals and the pool's allocations and releases, in order, are the
same: every rank commits the same tokens and its shared pool stays the
same.  Without ranks: ``SpecConfig`` refuses a draft padded for another
axis, a one-rank engine reads its clock directly, and the agreed clock,
over a stand-in broadcast, delivers its noted readings in order with the
next agreed one.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import model as jmodel
from repro.serve import qparams as jqparams
from repro.serve import spec as jspec
from repro.serve.engine import PagedServingEngine as JPagedEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.models import model as tmodel
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests._torch_dist import StepClock, _error_kind, start_group, tp_spec_rank, tp_spec_serve
from tests.test_torch_tp_families import _family_cfgs

ENGINE_RTOL = 1e-4  # × each step's max |logit|: the engines' recorded logits
GAMMA = 3
SPEC_KW = dict(max_batch=2, max_seq=64, page_size=8, prefill_chunk=16)
SLO_KW = dict(max_batch=3, max_seq=64, page_size=8, prefill_chunk=16, n_pages=9)
CONTIG_KW = dict(max_batch=2, max_seq=64, prefill_pad=8)


def _plain_waves(rng):
    return [[dict(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32), max_new=8)
             for i, n in enumerate((5, 19, 11, 23))]]


def _slo_waves(rng):
    """The first wave: no deadline (priority 0, twice), a generous deadline
    (1), one that expires mid-generation (2); the second, once the engine
    has measured its step costs: one provably unmeetable (1) and a generous
    one (2)."""
    p = lambda n: rng.integers(0, 256, n).astype(np.int32)
    return [[dict(rid=0, prompt=p(19), max_new=10),
             dict(rid=1, prompt=p(11), max_new=10, deadline_ms=1e7, priority=1),
             dict(rid=2, prompt=p(5), max_new=24, deadline_ms=40_000.0, priority=2),
             dict(rid=3, prompt=p(13), max_new=8)],
            [dict(rid=4, prompt=p(9), max_new=20, deadline_ms=3_000.0, priority=1),
             dict(rid=5, prompt=p(7), max_new=6, deadline_ms=1e7, priority=2)]]


def _deadline_waves(rng):
    return [[dict(rid=i, prompt=rng.integers(0, 256, n).astype(np.int32), max_new=6,
                  deadline_ms=d, priority=i % 3)
             for i, (n, d) in enumerate(((5, 50.0), (19, None), (11, 1e7)))]]


# (label, arch, config overrides, engine, draft, workload)
SPEC = [
    ("phi3_trunc", "phi3_mini_3_8b", {}, "paged", "truncate", "plain"),
    ("phi3_rtn", "phi3_mini_3_8b", {}, "paged", "rtn", "plain"),
    ("gemma2_trunc", "gemma2_27b", {}, "paged", "truncate", "plain"),
]
SLO = [
    ("slo", "phi3_mini_3_8b", {}, "paged", None, "slo"),
    ("slo_spec", "phi3_mini_3_8b", {}, "paged", "truncate", "slo"),
]
GROUPS = {
    2: SPEC + [("olmoe_trunc", "olmoe_1b_7b", {}, "paged", "truncate", "plain")] + SLO + [
        ("contiguous", "phi3_mini_3_8b", {}, "contiguous", None, "deadlines")],
    3: SPEC + [("gemma2_rtn", "gemma2_27b", {}, "paged", "rtn", "plain"),
               ("slo_spec_rtn", "phi3_mini_3_8b", {}, "paged", "rtn", "slo")],
}
WAVES = {"plain": _plain_waves, "slo": _slo_waves, "deadlines": _deadline_waves}
KW = {"plain": SPEC_KW, "slo": SLO_KW, "deadlines": CONTIG_KW}


def _case(label, arch, over, engine, draft, workload, world, seed):
    """One case: the reference's padded plan and params (and RTN draft),
    the requests, and what a rank needs in port tensors."""
    jcfg, tcfg = _family_cfgs(arch, **over)
    jp = jmodel.make_plan(jcfg, world)
    params = jmodel.init_params(jp, jax.random.PRNGKey(seed))
    rtn = jqparams.rtn_quantize_for_serving(jp, params, bits=3)[0] if draft == "rtn" else None
    to_port = lambda tree: interop.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    return dict(label=label, jp=jp, jparams=params, jrtn=rtn, cfg=tcfg, params=to_port(params),
                rtn=None if rtn is None else to_port(rtn), engine=engine, draft=draft,
                gamma=GAMMA, clock="step", kw=KW[workload], workload=workload,
                waves=WAVES[workload](np.random.default_rng(300 + seed)))


def _sent(case):
    """What a rank needs (torch and numpy only: a rank loads no JAX)."""
    keep = ("cfg", "params", "rtn", "engine", "draft", "gamma", "clock", "kw", "waves")
    return {k: case[k] for k in keep}


def _reference(case):
    """The reference's engine on the padded plan on one device, on one
    ``StepClock``, as :func:`tests._torch_dist.tp_spec_serve` runs the port."""
    jp, params = case["jp"], case["jparams"]
    if case["engine"] == "contiguous":
        eng = JEngine(jp, params, record_logits=True, clock=StepClock(), **case["kw"])
    else:
        spec = None
        if case["draft"] == "truncate":
            spec = jspec.SpecConfig(*jspec.truncate_draft(jp, params, 1), gamma=case["gamma"])
        elif case["draft"] == "rtn":
            spec = jspec.SpecConfig(jp, case["jrtn"], gamma=case["gamma"])
        eng = JPagedEngine(jp, params, spec=spec, record_logits=True, clock=StepClock(),
                           **case["kw"])
    reqs = []
    for wave in case["waves"]:
        for r in wave:
            req = JRequest(rid=r["rid"], prompt=r["prompt"], max_new_tokens=r["max_new"],
                           deadline_ms=r.get("deadline_ms"), priority=r.get("priority", 0))
            eng.submit(req)
            reqs.append(req)
        eng.run()
    out = {
        "outputs": {r.rid: list(r.output) for r in reqs},
        "requests": {r.rid: dict(status=r.status, error=_error_kind(r.error),
                                 n_preemptions=r.n_preemptions,
                                 n_spec_rounds=getattr(r, "n_spec_rounds", 0),
                                 n_draft_tokens=getattr(r, "n_draft_tokens", 0),
                                 n_draft_accepted=getattr(r, "n_draft_accepted", 0),
                                 submit_t=r.submit_t, first_token_t=r.first_token_t,
                                 finish_t=r.finish_t)
                     for r in reqs},
        "trace": {rid: [np.asarray(l, np.float32) for l in ls]
                  for rid, ls in eng.logit_trace.items()},
        "counters": {k: getattr(eng, k, None) for k in (
            "n_decode_steps", "n_shed", "n_deadline_missed", "n_preemptions", "n_spec_rounds",
            "n_draft_tokens", "n_draft_accepted")},
    }
    if case["engine"] == "paged":
        out["free"] = (eng.pool.n_free, eng.n_pages - 1)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each group's ranks start as soon as its cases are made; the
    reference's engines run on two threads meanwhile."""
    tmp = tmp_path_factory.mktemp("tp_spec")
    groups = {}

    def world(w):
        cases = {c[0]: _case(*c, world=w, seed=i) for i, c in enumerate(GROUPS[w])}
        groups[w] = start_group(tp_spec_rank, w, tmp, {k: _sent(c) for k, c in cases.items()})
        return cases, {k: _reference(c) for k, c in cases.items()}

    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            done = dict(zip(GROUPS, pool.map(world, GROUPS)))
        yield {w: (d[0], d[1], groups[w]) for w, d in done.items()}
    finally:
        for g in groups.values():
            g.close()


def _got(runs, world):
    cases, want, group = runs[world]
    return cases, want, group.result()


def _margin(l) -> float:
    top2 = np.sort(l)[-2:]
    return float(top2[1] - top2[0])


def _agree(want, got) -> tuple:
    """Recorded logits within ENGINE_RTOL of the step's max |logit| on every
    step both runs took with the same history; tokens equal while both
    top-2 margins exceed twice that.  Returns ``(positions compared, every
    stream agreed to its end)``."""
    assert sorted(want["outputs"]) == sorted(got["outputs"])
    compared, whole = 0, True
    for rid, out in want["outputs"].items():
        jt, tt = want["trace"].get(rid, []), got["trace"].get(rid, [])
        assert len(jt) == len(out) and len(tt) == len(got["outputs"][rid])
        for j, (la, lb) in enumerate(zip(jt, tt)):
            tol = ENGINE_RTOL * float(np.abs(la).max())
            np.testing.assert_allclose(lb, la, rtol=0, atol=tol, err_msg=f"request {rid} step {j}")
            compared += 1
            if min(_margin(la), _margin(lb)) < 2 * tol:
                whole = False
                break
            assert out[j] == got["outputs"][rid][j], (rid, j)
        else:
            whole = whole and out == got["outputs"][rid]
    return compared, whole


def _ranks_agree(got, label):
    """Every rank's outputs, request records, counters, logits (bits), the
    draft's proposals, the pool's allocations and releases, its clock
    readings and its collectives equal rank 0's."""
    r0 = got[0][label]
    for rank, out in enumerate(o[label] for o in got):
        for key in ("outputs", "requests", "counters", "clock_reads", "clock_broadcasts", "comm",
                    "free", "pool_log",
                    "proposals"):
            assert out.get(key) == r0.get(key), f"rank {rank} {key}"
        assert out["trace"].keys() == r0["trace"].keys()
        for rid in r0["trace"]:
            assert all(a.tobytes() == b.tobytes() for a, b in zip(out["trace"][rid],
                                                                  r0["trace"][rid])), rank


def _clock_checks(got, label):
    """The agreed clock's readings travel in fewer broadcasts than there
    are readings, each broadcast one ``broadcast_from``; only rank 0's clock
    is read."""
    for rank, out in enumerate(o[label] for o in got):
        assert 0 < out["clock_broadcasts"] < out["clock_reads"]
        assert out["comm"]["broadcast_from"] == out["clock_broadcasts"]
        assert out["own_clock_reads"] == (None if rank == 0 else 0), rank


# ---------------------------------------------------------------------------
# Speculative serving on the axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,label", [(w, c[0]) for w in GROUPS for c in GROUPS[w]
                                         if c[4] and c[5] == "plain"])
def test_speculative_streams_match_the_reference(runs, world, label):
    cases, want, got = _got(runs, world)
    ref = want[label]
    _ranks_agree(got, label)
    out = got[0][label]
    compared, whole = _agree(ref, out)
    assert compared >= sum(len(w) for w in cases[label]["waves"])
    c = out["counters"]
    assert c["n_spec_rounds"] > 0 and c["n_draft_tokens"] > 0
    assert out["free"][0] == out["free"][1], "a page leaked"
    for r in out["requests"].values():
        assert r["status"] == "completed"
    if whole:
        assert out["counters"] == ref["counters"]
        assert out["requests"] == ref["requests"]
        assert out["free"] == ref["free"]
    assert out["comm"]["gather_dim"] > 0  # the logits, gathered every round


# ---------------------------------------------------------------------------
# SLO decisions on ranks with skewed clocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,label", [(w, c[0]) for w in GROUPS for c in GROUPS[w]
                                         if c[5] == "slo"])
def test_slo_decisions_agree_across_skewed_clocks(runs, world, label):
    cases, want, got = _got(runs, world)
    ref = want[label]
    _ranks_agree(got, label)
    _clock_checks(got, label)
    out = got[0][label]
    assert out["outputs"] == ref["outputs"]
    for key in ("n_shed", "n_deadline_missed", "n_preemptions"):
        assert out["counters"][key] == ref["counters"][key], key
    assert out["requests"] == ref["requests"]
    assert out["counters"] == ref["counters"]
    assert out["free"] == ref["free"] and out["free"][0] == out["free"][1]
    status = {rid: r["status"] for rid, r in out["requests"].items()}
    assert status[2] == "deadline_missed" and 0 < len(out["outputs"][2]) < 24
    assert status[4] == "shed" and out["requests"][4]["error"] == "provably unmeetable"
    assert status[1] == status[5] == "completed"
    assert out["counters"]["n_preemptions"] >= 1 and "preempted_resumed" in status.values()
    if cases[label]["draft"]:
        assert out["counters"]["n_spec_rounds"] > 0


def test_contiguous_engine_takes_deadlines_on_the_axis(runs):
    _, want, got = _got(runs, 2)
    ref = want["contiguous"]
    _ranks_agree(got, "contiguous")
    _clock_checks(got, "contiguous")
    out = got[0]["contiguous"]
    _, whole = _agree(ref, out)
    assert whole and out["requests"] == ref["requests"]
    assert all(r["status"] == "completed" and r["submit_t"] is not None
               for r in out["requests"].values())
    # Nothing decides on time here: a broadcast for each submit, and one at
    # the end of a step that stamps a first token or a finish.
    assert out["clock_broadcasts"] <= 3 * len(out["requests"]) < out["counters"]["n_decode_steps"]


@pytest.mark.parametrize("world", list(GROUPS))
def test_broadcast_from_gives_rank_zeros_value(runs, world):
    got = _got(runs, world)[2]
    for out in got:  # rank 0's float to the last bit
        assert out["broadcast"] == [0.25 + 1e-12, -3.5]


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


def test_spec_config_refuses_a_draft_padded_for_another_axis():
    from repro_torch.serve.spec import SpecConfig

    cfg = _family_cfgs("phi3_mini_3_8b")[1]
    target = tmodel.make_plan(cfg, 3)
    SpecConfig(target, None).check_target(target)
    for other in (tmodel.make_plan(cfg, 1), tmodel.make_plan(cfg, 2),
                  dataclasses.replace(target, heads=tmodel.make_plan(cfg, 2).heads)):
        with pytest.raises(ValueError, match="padded for a \"model\" axis"):
            SpecConfig(other, None).check_target(target)
    with pytest.raises(ValueError, match="draft vocab"):
        SpecConfig(tmodel.make_plan(dataclasses.replace(cfg, vocab=300), 3), None).check_target(
            target)


def test_one_rank_engine_reads_its_own_clock():
    """Without a model axis the engines keep the given clock: no
    collective, the reference's readings."""
    from repro_torch.serve import PagedServingEngine, ServingEngine

    cfg = _family_cfgs("phi3_mini_3_8b")[1]
    plan = tmodel.make_plan(cfg)
    params = tmodel.init_params(plan, 0, device="cpu")
    clock = StepClock()
    for cls in (PagedServingEngine, ServingEngine):
        assert cls(plan, params, max_batch=1, max_seq=32, clock=clock, device="cpu").clock is clock
    case = dict(engine="paged", clock="step", kw=SLO_KW, gamma=GAMMA,
                waves=_slo_waves(np.random.default_rng(300)))
    got = tp_spec_serve(plan, params, case)
    assert got["clock_reads"] is None and got["own_clock_reads"] is None
    assert got["requests"][4]["status"] == "shed" and got["free"][0] == got["free"][1]


@pytest.mark.parametrize("rank", [0, 1])
def test_agreed_clock_carries_noted_readings_on_the_next_broadcast(monkeypatch, rank):
    """Over a stand-in broadcast that hands every rank rank 0's list: an
    agreed reading is one broadcast carrying the readings noted since the
    last, each delivered to its ``then`` in order before the reading is
    returned; a note without ``then`` is read and sent nowhere; ``settle``
    sends what is noted and nothing when nothing is; only rank 0's clock is
    read."""
    import types

    from repro_torch.dist import collectives
    from repro_torch.serve import AgreedClock

    lead = StepClock()
    sent = []

    def broadcast(values, mesh, axis):
        assert axis == "model"
        sent.append(list(values))
        return [float(10 * (i + 1)) for i in range(len(values))]  # rank 0's, as it arrives

    monkeypatch.setattr(collectives, "broadcast_from", broadcast)
    mesh = types.SimpleNamespace(mesh_dim_names=("model",), shape=(2,),
                                 get_local_rank=lambda axis: rank)
    own = StepClock()
    clock = AgreedClock(lead if rank == 0 else own, mesh)
    got = []
    clock.note(got.append)
    clock.note()
    clock.note(lambda t: got.append(-t), stamp=True)
    assert clock.stamped and not sent and not got
    assert clock() == 30.0 and got == [10.0, -20.0] and not clock.stamped
    want = [1.0, 3.0, 4.0] if rank == 0 else [0.0, 0.0, 0.0]
    assert sent == [want]
    clock.settle()
    clock.note(got.append)
    clock.settle()
    assert got == [10.0, -20.0, 10.0] and len(sent) == 2
    assert (clock.n_reads, clock.n_broadcasts) == (5, 2)
    assert (lead.t, own.t) == ((5.0, 0.0) if rank == 0 else (0.0, 0.0))
