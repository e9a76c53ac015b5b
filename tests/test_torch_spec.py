"""The port's speculative serving against the JAX package's: the acceptance
rules, the batched verify and the fused draft of the model, the hoisted
dequantization, the drafts, and the speculative paged engine.

Tolerances: the acceptance rules exactly (hypothesis-drawn inputs); the
verify's logits within 1e-5 of max |logit| of the reference's on the same
fp32 weights (carried by ``interop``), the draft's tokens equal up to the
first step whose top-2 margin is below that; the port's verify against L of
its own sequential decode steps, the hoisted linears against the quantized
ones and speculative against plain greedy tokens bit for bit (on the CPU
every position of a verify takes the decode step's arithmetic), the engine's
recorded logits with and without speculation within 1e-5 of max |logit|; the port's
speculative engine against the reference's speculative engine run live, the
recorded logits within 1e-4 of max |logit| and the tokens equal up to the
first step whose top-2 margin is below twice that (``test_torch_paged_engine``'s
rule: bf16 KV now and then rounds an fp32 difference to another ulp).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import common as jcommon
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.models import model as jm
from repro.quant import GridSpec as JSpec
from repro.quant import quantize_tensor as jquantize
from repro.quant.pack import pack_codes as jpack
from repro.serve import spec as jspec
from repro.serve.engine import PagedServingEngine as JPagedEngine
from repro.serve.engine import Request as JRequest
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ref
from repro_torch.models import model as tm
from repro_torch.models.common import HoistedDequant, apply_linear, hoist_dequant
from repro_torch.serve import PagedServingEngine, Request
from repro_torch.serve import spec as tspec
from repro_torch.serve.qparams import rtn_quantize_for_serving
from tests._hypothesis_compat import given, settings, st
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests.conftest import reduce_cfg

CPU = dict(device="cpu")


# ---------------------------------------------------------------------------
# Acceptance rules, against the reference's on the same inputs
# ---------------------------------------------------------------------------


def _random_spec_case(seed):
    """Draft and target distributions with zero-mass tokens, proposals from
    the draft's support, and the rule's draws, all from one seed."""
    rng = np.random.default_rng(seed)
    V, n = int(rng.integers(3, 9)), int(rng.integers(1, 5))

    def dist(bias):
        p = rng.random(V) ** 3
        p[rng.random(V) < bias] = 0.0
        if p.sum() <= 0:
            p[int(rng.integers(V))] = 1.0
        return p / p.sum()

    draft = [dist(0.3) for _ in range(n)]
    target = [dist(0.4) for _ in range(n + 1)]
    tokens = [int(rng.choice(V, p=d)) for d in draft]
    return tokens, draft, target, rng.random(n), rng.random(n + 1)


@settings(max_examples=100, deadline=None)
@given(st.integers(min_value=0, max_value=2**32 - 1))
def test_greedy_accept_len_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 7))
    draft, target = rng.integers(0, 3, n).tolist(), rng.integers(0, 3, n + 1).tolist()
    assert tspec.greedy_accept_len(draft, target) == jspec.greedy_accept_len(draft, target)


@settings(max_examples=150, deadline=None)
@given(st.integers(min_value=0, max_value=2**32 - 1))
def test_rejection_sample_commit_matches_reference(seed):
    case = _random_spec_case(seed)
    assert tspec.rejection_sample_commit(*case) == jspec.rejection_sample_commit(*case)
    tokens, draft, target, u, v = case
    one_hot = [np.eye(len(t))[int(np.argmax(t))] for t in target]
    got = tspec.rejection_sample_commit(tokens, draft, one_hot, u, v)
    assert got == jspec.rejection_sample_commit(tokens, draft, one_hot, u, v)
    greedy = [int(np.argmax(t)) for t in target]
    a = tspec.greedy_accept_len(tokens, greedy)
    assert got == tokens[:a] + [greedy[a]]  # one-hot rows: the greedy rule


def test_rejection_sampling_rejects_malformed_inputs():
    for mod in (tspec, jspec):
        with pytest.raises(ValueError, match="draws"):
            mod.rejection_sample_commit([0], [[1.0]], [[1.0]], [0.5], [0.5])
        with pytest.raises(ValueError, match="zero probability"):
            mod.rejection_sample_commit([1], [np.array([1.0, 0.0])], [np.array([0.5, 0.5])] * 2,
                                        [0.5], [0.5, 0.5])


# ---------------------------------------------------------------------------
# The model: batched verify and fused draft, against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fp32_pair():
    over = dict(d_model=96, head_dim=24, d_ff=192)
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b"), **over), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b"), **over), dtype=torch.float32)
    jp, tp = jplan(jcfg, 1), tm.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(0))
    return jp, params, tp, interop.params_from_jax(jax.tree.map(np.asarray, params), **CPU)


_PSZ, _PAGES = 8, 14
_ROWS = np.array([[3, 5, 1, 7, 11, 0], [2, 9, 12, 4, 0, 0], [0, 0, 0, 0, 0, 0]], np.int32)


def _prefilled(fp32_pair):
    """Both packages' paged caches after prefilling two prompts (29 and 11
    tokens; lane 2 inactive)."""
    jp, params, tp, tparams = fp32_pair
    r = np.random.default_rng(3)
    prompts = [r.integers(0, 256, 29).astype(np.int32), r.integers(0, 256, 11).astype(np.int32)]
    jc, tc = jm.init_paged_cache(jp, _PAGES, _PSZ), tm.init_paged_cache(tp, _PAGES, _PSZ, **CPU)
    for row, p in enumerate(prompts):
        buf = np.zeros((1, 32), np.int32)
        buf[0, : len(p)] = p
        pt = _ROWS[row : row + 1]
        jc = jm.paged_prefill_chunk(jp, params, jnp.asarray(buf), jc, jnp.asarray(pt), 0)
        tc = tm.paged_prefill_chunk(tp, tparams, buf, tc, pt, 0)
    return prompts, jc, tc


def _write_pages(pos0, n):
    return np.array([[_ROWS[b, (pos0[b] + j) // _PSZ] if b < 2 else 0 for j in range(n)]
                     for b in range(3)], np.int32)


def _margin(l):
    top2 = np.sort(l)[-2:]
    return top2[1] - top2[0]


def test_paged_verify_tokens_matches_jax(fp32_pair):
    """Four positions a lane (crossing a page boundary in lane 0), a lane
    inactive: logits within 1e-5 of max |logit| of the reference's."""
    jp, params, tp, tparams = fp32_pair
    prompts, jc, tc = _prefilled(fp32_pair)
    L = 4
    pos0 = np.array([28, 10, 0], np.int32)
    toks = np.random.default_rng(4).integers(0, 256, (3, L)).astype(np.int32)
    toks[0, 0], toks[1, 0] = prompts[0][-1], prompts[1][-1]
    wp = _write_pages(pos0, L)
    jl, _ = jm.paged_verify_tokens(jp, params, jnp.asarray(toks), jc, jnp.asarray(pos0),
                                   jnp.asarray(_ROWS), jnp.asarray(wp))
    tl, _ = tm.paged_verify_tokens(tp, tparams, toks, tc, pos0, _ROWS, wp)
    jl, tl = np.asarray(jl), tl.numpy()
    assert tl.shape == jl.shape == (3, L, 256)
    for b in range(2):
        np.testing.assert_allclose(tl[b], jl[b], rtol=0, atol=1e-5 * np.abs(jl[b]).max())


def test_paged_draft_tokens_matches_jax(fp32_pair):
    """Five steps, the first one or two teacher-forced: the tokens equal the
    reference's up to the first step whose top-2 margin is below 1e-5 of
    max |logit| (found from the port's own step logits)."""
    jp, params, tp, tparams = fp32_pair
    prompts, jc, tc = _prefilled(fp32_pair)
    S = 5
    pos0 = np.array([27, 10, 0], np.int32)
    forced = np.zeros((3, S), np.int32)
    forced[0, :2] = prompts[0][-2:]
    forced[1, 0] = prompts[1][-1]
    nf = np.array([2, 1, 0], np.int32)
    wp = _write_pages(pos0, S)
    tc2 = {k: {n: t.clone() for n, t in v.items()} for k, v in tc.items()}
    jt, _ = jm.paged_draft_tokens(jp, params, jnp.asarray(forced), jnp.asarray(nf), jc,
                                  jnp.asarray(pos0), jnp.asarray(_ROWS), jnp.asarray(wp))
    tt, _ = tm.paged_draft_tokens(tp, tparams, forced, nf, tc, pos0, _ROWS, wp)
    jt, tt = np.asarray(jt), tt.numpy()
    assert tt.dtype == np.int32 and tt.shape == (3, S)
    prev = np.zeros(3, np.int64)
    for j in range(S):  # the port's own steps, for their margins
        inp = np.where(j < nf, forced[:, j], prev)
        lg, tc2 = tm.paged_decode_step(tp, tparams, inp[:, None], tc2, pos0 + j, _ROWS, wp[:, j])
        lg = lg.numpy()
        assert np.array_equal(np.argmax(lg, -1), tt[:, j])
        prev = tt[:, j]
        for b in range(2):
            if _margin(lg[b]) < 1e-5 * np.abs(lg[b]).max():
                return
            assert tt[b, j] == jt[b, j], (b, j)


def test_verify_equals_sequential_port_decode(fp32_pair):
    """The port's verify against L of its own decode steps on a copy of the
    cache: logits and every KV byte equal."""
    _, _, tp, tparams = fp32_pair
    prompts, _, tc = _prefilled(fp32_pair)
    L = 4
    pos0 = np.array([28, 10, 0], np.int32)
    toks = np.random.default_rng(5).integers(0, 256, (3, L)).astype(np.int32)
    wp = _write_pages(pos0, L)
    seq_cache = {k: {n: t.clone() for n, t in v.items()} for k, v in tc.items()}
    got, tc = tm.paged_verify_tokens(tp, tparams, toks, tc, pos0, _ROWS, wp)
    for j in range(L):
        lg, seq_cache = tm.paged_decode_step(tp, tparams, toks[:, j : j + 1], seq_cache, pos0 + j,
                                             _ROWS, wp[:, j])
        assert torch.equal(got[:2, j], lg[:2])
    for blk, leaves in tc.items():
        for name, t in leaves.items():
            assert torch.equal(t[:, 1:], seq_cache[blk][name][:, 1:])  # page 0: pad scratch


# ---------------------------------------------------------------------------
# Hoisted dequantization and drafts
# ---------------------------------------------------------------------------


def _qt_pair(bits, group_size=None, outliers=0, cols=0, seed=0):
    """A reference QuantizedTensor and the port's copy (interop)."""
    r = np.random.default_rng(seed)
    q, p = 24, 64
    w = r.standard_normal((q, p)).astype(np.float32)
    qt = jquantize(jnp.asarray(w), JSpec(bits=bits, group_size=group_size))
    if bits == 4:
        qt = dataclasses.replace(qt, codes=jpack(qt.codes, 4), packed=True)
    if outliers:
        idx = np.sort(r.choice(q * p, outliers, replace=False)).astype(np.int32)
        qt = dataclasses.replace(qt, outlier_idx=jnp.asarray(idx), outlier_values=jnp.asarray(
            r.standard_normal(outliers).astype(np.float16)))
    if cols:
        qt = dataclasses.replace(qt, outlier_col_idx=jnp.asarray(np.arange(cols, dtype=np.int32) * 5),
                                 outlier_col_vals=jnp.asarray(r.standard_normal((q, cols)), jnp.float32))
    return qt, interop.qtensor_from_jax(qt, **CPU)


@pytest.mark.parametrize("bits,group_size,outliers,cols", [
    (4, None, 0, 0), (3, None, 7, 0), (4, 16, 5, 0), (8, 32, 0, 3), (2, None, 0, 0)])
def test_hoist_dequant_bytes_and_linear(bits, group_size, outliers, cols):
    """The hoisted matrix is byte for byte the plain GEMM's (the reference's
    hoist and the port's dequant_matmul_ref on the identity), and a hoisted
    linear equals the quantized one exactly, outlier planes included."""
    jqt, tqt = _qt_pair(bits, group_size, outliers, cols, seed=bits)
    h = hoist_dequant({"w": tqt})["w"]
    assert isinstance(h, HoistedDequant) and h.shape == tqt.shape
    jh = jcommon.hoist_dequant({"w": jqt})["w"]
    assert np.array_equal(h.w.numpy(), np.asarray(jh.w))
    p = tqt.shape[-1]
    eye = ref.dequant_matmul_ref(torch.eye(p), tqt.unpacked_codes(), tqt.scale, tqt.zero,
                                 group_size=tqt.group_size)
    assert torch.equal(h.w, eye.T)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 3, p)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(apply_linear(h, x.to(dt)), apply_linear(tqt, x.to(dt)))
    jy = jcommon.apply_linear(jh, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(apply_linear(h, x).numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_maybe_hoist_on_the_cpu():
    plan = tm.make_plan(reduce_cfg(tget("phi3_mini_3_8b")))
    params = tm.init_params(plan, 0, **CPU)
    qp, label = rtn_quantize_for_serving(plan, params, bits=4)
    assert label == "linear-packed"
    hoisted = tspec.maybe_hoist(qp, None)
    assert isinstance(hoisted["dec"]["b0"]["wq"], HoistedDequant)
    assert tspec.maybe_hoist(qp, False) is qp
    assert tm.period_slice(hoisted["dec"], 1)["b0"]["wq"].shape == qp["dec"]["b0"]["wq"].shape[1:]


def test_truncate_draft_matches_reference(fp32_pair):
    jp, params, tp, tparams = fp32_pair
    jdp, jdparams = jspec.truncate_draft(jp, params, 1)
    tdp, tdparams = tspec.truncate_draft(tp, tparams, 1)
    assert tdp.cfg.n_periods == jdp.cfg.n_periods == 1 and tdp.kv_cache_dtype == tp.kv_cache_dtype
    for name, leaf in tdparams["dec"]["b0"].items():
        if isinstance(leaf, dict):
            continue
        assert leaf.shape[0] == 1
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jdparams["dec"]["b0"][name]))
    assert tdparams["embed"] is tparams["embed"]
    for bad in (0, 3):
        with pytest.raises(ValueError, match="n_periods"):
            tspec.truncate_draft(tp, tparams, bad)
    qp, _ = rtn_quantize_for_serving(tp, tparams, bits=3)
    _, qd = tspec.truncate_draft(tp, qp, 1)
    assert qd["dec"]["b0"]["wq"].codes.shape[0] == 1 and qd["dec"]["b0"]["wq"].bits == 3
    with pytest.raises(ValueError, match="gamma"):
        tspec.SpecConfig(tdp, tdparams, gamma=0)


# ---------------------------------------------------------------------------
# The speculative paged engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spec_model():
    cfg = reduce_cfg(tget("phi3_mini_3_8b"), d_model=96, head_dim=24, d_ff=192, n_periods=2)
    plan = tm.make_plan(cfg)
    params = tm.init_params(plan, 0, **CPU)
    draft_plan, draft_params = tspec.truncate_draft(plan, params, 1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 250, n).astype(np.int32) for n in (6, 21, 47, 11)]
    return plan, params, draft_plan, draft_params, prompts


def _spec(draft_plan, draft_params, gamma):
    return tspec.SpecConfig(draft_plan=draft_plan, draft_params=draft_params, gamma=gamma)


def _serve(eng, prompts, max_new=7):
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    return [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]


def _engine(plan, params, *, spec=None, max_batch=2, max_seq=128, page_size=8, **kw):
    # Target and draft pages share the pool: a generous one for the identity
    # tests (shortened proposals are a test of their own).
    kw.setdefault("n_pages", 1 + 2 * max_batch * -(-max_seq // page_size))
    return PagedServingEngine(plan, params, max_batch=max_batch, max_seq=max_seq,
                              page_size=page_size, prefill_chunk=16, spec=spec, **CPU, **kw)


@pytest.mark.parametrize("gamma", [1, 2, 4])
def test_spec_token_identical_to_plain_greedy(spec_model, gamma):
    plan, params, dplan, dparams, prompts = spec_model
    base = _serve(_engine(plan, params), prompts)
    eng = _engine(plan, params, spec=_spec(dplan, dparams, gamma))
    assert _serve(eng, prompts) == base
    assert eng.n_spec_rounds > 0 and eng.n_draft_tokens > 0


@pytest.mark.parametrize("draft", ["self", "rtn3"])
def test_spec_on_a_quantized_target_token_identical(spec_model, draft):
    """A 4-bit target (its verify hoisted on the CPU, its plain step not)
    with the target itself or a 3-bit RTN copy as the draft."""
    plan, params, _, _, prompts = spec_model
    target, _ = rtn_quantize_for_serving(plan, params, bits=4)
    dparams = target if draft == "self" else rtn_quantize_for_serving(plan, params, bits=3)[0]
    base = _serve(_engine(plan, target), prompts)
    eng = _engine(plan, target, spec=_spec(plan, dparams, 3))
    assert _serve(eng, prompts) == base
    assert isinstance(eng._verify_params["dec"]["b0"]["wq"], HoistedDequant)
    if draft == "self":
        assert eng.acceptance_rate() == 1.0


def test_spec_gamma_overruns_max_new(spec_model):
    """γ above the remaining budget: proposals shorten, outputs stay the
    plain ones; with max_new 1 the budget is 0 every round (plain steps)."""
    plan, params, dplan, dparams, prompts = spec_model
    for max_new in (1, 3):
        base = _serve(_engine(plan, params), prompts[:2], max_new=max_new)
        eng = _engine(plan, params, spec=_spec(dplan, dparams, 4))
        assert _serve(eng, prompts[:2], max_new=max_new) == base
        assert all(len(o) == max_new for o in base)
        if max_new == 1:
            assert eng.n_draft_tokens == 0 and eng.acceptance_rate() is None


def test_spec_window_edge_prompt(spec_model):
    plan, params, dplan, dparams, _ = spec_model
    max_seq, max_new = 64, 6
    prompt = np.random.default_rng(23).integers(0, 250, max_seq - max_new).astype(np.int32)
    base = _serve(_engine(plan, params, max_seq=max_seq), [prompt], max_new=max_new)
    eng = _engine(plan, params, max_seq=max_seq, spec=_spec(dplan, dparams, 4))
    out = _serve(eng, [prompt], max_new=max_new)
    assert out == base and len(out[0]) == max_new


def test_spec_acceptance_accounting_exact(spec_model):
    plan, params, dplan, dparams, prompts = spec_model
    eng = _engine(plan, params, spec=_spec(dplan, dparams, 3))
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=9))
    fin = sorted(eng.run(), key=lambda r: r.rid)
    for r in fin:
        assert len(r.output) == r.n_draft_accepted + r.n_spec_rounds
        assert 0 <= r.n_draft_accepted <= r.n_draft_tokens
    assert 0 < eng.n_spec_rounds <= sum(r.n_spec_rounds for r in fin)
    assert eng.n_draft_tokens == sum(r.n_draft_tokens for r in fin)
    assert eng.n_draft_accepted == sum(r.n_draft_accepted for r in fin)
    assert eng.acceptance_rate() == eng.n_draft_accepted / eng.n_draft_tokens
    assert eng.propose_seconds <= eng.decode_seconds


def test_spec_zero_page_leaks(spec_model):
    plan, params, dplan, dparams, prompts = spec_model
    for prefix_cache in (True, False):
        eng = _engine(plan, params, spec=_spec(dplan, dparams, 3), prefix_cache=prefix_cache)
        _serve(eng, prompts, max_new=9)
        assert eng.pool.n_free == eng.n_pages - 1
        assert all(not pgs for pgs in eng.spec_mgr.pages)
        assert not eng.spec_mgr.table.any()  # NULL_PAGE == 0


def test_spec_preemption_resume_deterministic(spec_model):
    """A pool too small for the batch preempts mid-speculation; draft pages
    shorten proposals and never preempt; outputs equal the ample run's."""
    plan, params, dplan, dparams, prompts = spec_model
    sp = _spec(dplan, dparams, 3)
    ample = _serve(_engine(plan, params, max_batch=3, spec=sp), prompts)
    tight = _engine(plan, params, max_batch=3, n_pages=13, prefix_cache=False, spec=sp)
    assert _serve(tight, prompts) == ample
    assert tight.n_preemptions >= 1
    assert tight.pool.n_free == tight.n_pages - 1


class StepClock:
    """Each call advances one virtual second."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_spec_slo_shed_and_expire(spec_model):
    """Under the SLO scheduler with speculation: an impossible deadline
    sheds, an overdue request expires mid-generation (partial output kept),
    and the surviving request's tokens equal the plain run's."""
    plan, params, dplan, dparams, prompts = spec_model

    def run(spec):
        eng = _engine(plan, params, n_pages=1 + 4 * 16, clock=StepClock(), spec=spec)
        eng.submit(Request(rid=0, prompt=prompts[1], max_new_tokens=8))
        eng.submit(Request(rid=1, prompt=prompts[2], max_new_tokens=30, deadline_ms=20_000))
        eng.run()
        eng.submit(Request(rid=2, prompt=prompts[0], max_new_tokens=30, deadline_ms=3_000))
        fin = {r.rid: r for r in eng.run()}
        assert eng.pool.n_free == eng.n_pages - 1
        return fin

    base, fin = run(None), run(_spec(dplan, dparams, 3))
    assert fin[2].status == base[2].status == "shed" and "provably unmeetable" in fin[2].error
    assert fin[1].status == base[1].status == "deadline_missed"
    assert 0 < len(fin[1].output) < 30
    assert fin[0].status == "completed" and fin[0].output == base[0].output


def test_spec_none_is_the_plain_step(spec_model, monkeypatch):
    """Without a SpecConfig every round is one ``paged_decode_step`` over the
    engine's B lanes and nothing of speculation runs.  A speculative
    engine's trace holds the same logits within 1e-5 of max |logit| (a
    one-row and a four-row product of the fp32 head may take other BLAS
    kernels) and the same tokens."""
    from repro_torch.serve import engine as eng_mod

    plan, params, dplan, dparams, prompts = spec_model
    calls = []
    real = eng_mod.paged_decode_step
    monkeypatch.setattr(eng_mod, "paged_decode_step",
                        lambda *a, **k: calls.append(np.asarray(a[2]).shape) or real(*a, **k))

    def trace(spec):
        eng = _engine(plan, params, max_batch=1, record_logits=True, spec=spec)
        _serve(eng, prompts[:2], max_new=6)
        return eng, {rid: np.stack(v) for rid, v in eng.logit_trace.items()}

    plain, legacy = trace(None)
    assert plain.spec_mgr is None and plain.n_spec_rounds == plain.n_draft_tokens == 0
    assert len(calls) == plain.n_decode_steps and set(calls) == {(1, 1)}
    assert plain.propose_seconds < 1e-3 * max(plain.decode_seconds, 1e-3)
    spec_eng, spec = trace(_spec(dplan, dparams, 3))
    assert spec_eng.n_spec_rounds > 0 and legacy.keys() == spec.keys()
    for rid in legacy:
        np.testing.assert_allclose(spec[rid], legacy[rid], rtol=0,
                                   atol=1e-5 * np.abs(legacy[rid]).max())
        assert np.array_equal(spec[rid].argmax(-1), legacy[rid].argmax(-1))


def test_spec_refusals(spec_model):
    plan, params, dplan, dparams, _ = spec_model
    other = dataclasses.replace(dplan, cfg=dataclasses.replace(dplan.cfg, vocab=300))
    with pytest.raises(ValueError, match="draft vocab"):
        _engine(plan, params, spec=_spec(other, dparams, 2))
    on_meta = tm.tree_map(lambda a: a.to("meta"), dparams)
    with pytest.raises(ValueError, match="live on meta"):
        _engine(plan, params, spec=_spec(dplan, on_meta, 2))


def test_spec_engine_matches_the_reference_live(fp32_pair):
    """The port's and the reference's speculative engines (γ = 3, the
    1-period draft, a pool that preempts) on the same fp32 weights and
    requests: recorded logits within 1e-4 of max |logit|, tokens equal up
    to a near-tie, the same acceptance counts where no stream parted."""
    jp, params, tp, tparams = fp32_pair
    jdraft, tdraft = jspec.truncate_draft(jp, params, 1), tspec.truncate_draft(tp, tparams, 1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 250, n).astype(np.int32) for n in (6, 21, 47, 11, 33)]
    kw = dict(max_batch=2, max_seq=128, page_size=8, prefill_chunk=16, n_pages=1 + 2 * 2 * 16,
              record_logits=True)
    jeng = JPagedEngine(jp, params, spec=jspec.SpecConfig(*jdraft, gamma=3), **kw)
    teng = PagedServingEngine(tp, tparams, spec=tspec.SpecConfig(*tdraft, gamma=3), **CPU, **kw)
    for eng, req in ((jeng, JRequest), (teng, Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=p, max_new_tokens=8))
        eng.run()
    jo, to = ({r.rid: r for r in e.finished} for e in (jeng, teng))
    parted, compared = False, 0
    for rid in jo:
        for j, (la, lb) in enumerate(zip(jeng.logit_trace[rid], teng.logit_trace[rid])):
            la = np.asarray(la)
            tol = 1e-4 * float(np.abs(la).max())
            np.testing.assert_allclose(lb, la, rtol=0, atol=tol)
            compared += 1
            if min(_margin(la), _margin(lb)) < 2 * tol:
                parted = True
                break
            assert jo[rid].output[j] == to[rid].output[j]
    assert compared >= len(prompts) and teng.n_spec_rounds > 0
    if not parted:
        assert [(r.n_spec_rounds, r.n_draft_tokens, r.n_draft_accepted) for r in to.values()] == [
            (r.n_spec_rounds, r.n_draft_tokens, r.n_draft_accepted) for r in jo.values()]
