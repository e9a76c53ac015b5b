"""The port's mixed-precision tuner and the serving-side quantization it
needs, against the JAX package: ``harmonize_qt_stack`` (the reference's
four cases), ``rtn_quantize_for_serving``, the mixed-bits emit and its
restack, the allocator, the sensitivity probes (``collect_sensitivity``),
``tune_model`` and ``launch.tune``.

Tolerances: harmonized stacks, allocations and upgrade sequences exactly;
RTN codes exactly, scales within 2 ulp, outlier index sets equal but for
entries whose |residual| lies within one ulp of the set's boundary; λ_max
within 1e-5 relative and per-layer probe errors within 1e-4 relative (fp32
on reduced Phi-3, the packages' products summing in other orders); the two
tune CLIs at fp32: the same candidates, allocations and winner, perplexities
within 1e-3 relative.
"""

import contextlib
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.configs import get_config as jget
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.quant import GridSpec as JSpec
from repro.quant import quantize_tensor as jquantize
from repro.quant.pack import pack_codes as jpack
from repro.serve import qparams as jqparams
from repro.tune import sensitivity as jsens
from repro.tune.allocate import AllocConfig as JAllocConfig
from repro.tune.allocate import allocate as jallocate
from repro.tune.allocate import upgrade_sequence as jupgrade_sequence
from repro_torch import interop
from repro_torch.core import solver as tsolver
from repro_torch.core.solver import LayerSpec, PTQConfig
from repro_torch.models import model as tm
from repro_torch.quant import GridSpec, QuantizedTensor
from repro_torch.serve import PagedServingEngine, Request, ServingEngine
from repro_torch.serve import qparams as tqparams
from repro_torch.tune import (
    AllocConfig,
    LayerStat,
    TuneConfig,
    allocate,
    build_candidates,
    probe_layer_stats,
    tune_model,
    upgrade_sequence,
)
from tests._hypothesis_compat import given, settings, st
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests.conftest import reduce_cfg

CPU = dict(device="cpu")


# ---------------------------------------------------------------------------
# harmonize_qt_stack: the reference's four cases (tests/test_tune.py)
# ---------------------------------------------------------------------------


def _qt(w, bits, *, outliers=0, group_size=None, packed=False, seed=0):
    """A reference QuantizedTensor and the port's copy of it."""
    qt = jquantize(jnp.asarray(w), JSpec(bits=bits, group_size=group_size))
    if packed:
        qt = dataclasses.replace(qt, codes=jpack(qt.codes, bits), packed=True)
    if outliers:
        rng = np.random.default_rng(seed)
        idx = rng.choice(w.size, size=outliers, replace=False).astype(np.int32)
        qt = dataclasses.replace(qt, outlier_values=jnp.asarray(
            rng.standard_normal(outliers).astype(np.float16)), outlier_idx=jnp.asarray(np.sort(idx)))
    return qt, interop.qtensor_from_jax(qt, **CPU)


def test_harmonize_homogeneous_passthrough():
    w = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    leaves = [_qt(w, 4, packed=True)[1], _qt(w + 1, 4, packed=True)[1]]
    assert tqparams.harmonize_qt_stack(leaves) is leaves


def test_harmonize_mixed_bits_matches_reference():
    rng = np.random.default_rng(2)
    ws = [rng.standard_normal((8, 16)).astype(np.float32) for _ in range(4)]
    pairs = [_qt(ws[0], 2), _qt(ws[1], 3, outliers=5, seed=3), _qt(ws[2], 4, packed=True),
             _qt(ws[3], 8, outliers=2, seed=4)]
    jout = jqparams.harmonize_qt_stack([p[0] for p in pairs])
    before = [tm.tree_map(lambda a: a, p[1]) for p in pairs]
    out = tqparams.harmonize_qt_stack([p[1] for p in pairs])
    assert {(l.bits, l.packed, l.group_size) for l in out} == {(8, False, None)}
    assert {l.outlier_values.shape[-1] for l in out} == {5}
    from repro_torch.quant import dequantize_tensor

    for l, j, b in zip(out, jout, before):
        for f in ("codes", "scale", "zero", "outlier_values", "outlier_idx"):
            np.testing.assert_array_equal(getattr(l, f).numpy(), np.asarray(getattr(j, f)))
        assert torch.equal(dequantize_tensor(l), dequantize_tensor(b))
    stacked = tqparams._stack_qts(out)
    assert stacked.codes.shape == (4, 8, 16) and stacked.bits == 8


def test_harmonize_rejects_heterogeneous_group_size():
    w = np.random.default_rng(5).standard_normal((8, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="group_size"):
        tqparams.harmonize_qt_stack([_qt(w, 2, group_size=8)[1], _qt(w, 4)[1]])


def test_harmonize_rejects_mismatched_column_outliers():
    w = np.random.default_rng(6).standard_normal((8, 16)).astype(np.float32)
    b = dataclasses.replace(_qt(w, 4)[1], outlier_col_idx=torch.tensor([3], dtype=torch.int32),
                            outlier_col_vals=torch.from_numpy(w[:, 3:4].copy()))
    with pytest.raises(ValueError, match="column outliers"):
        tqparams.harmonize_qt_stack([_qt(w, 2)[1], b])


def test_zero_points_checked_against_each_periods_own_bits():
    """A 2-bit period whose zero point is 5 (inside the stack's 8 bits, not
    its own 2) is refused before the harmonized stack could hide it."""
    w = np.random.default_rng(7).standard_normal((8, 16)).astype(np.float32)
    bad = _qt(w, 2)[1]
    bad = dataclasses.replace(bad, zero=torch.full_like(bad.zero, 5.0))
    with pytest.raises(ValueError, match=r"integers in \[0, 3\]"):
        tqparams._stack_qts([bad, _qt(w, 8)[1]])


# ---------------------------------------------------------------------------
# rtn_quantize_for_serving
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fp32_pair():
    over = dict(d_model=96, head_dim=24, d_ff=192)
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b"), **over), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget_phi3(), **over), dtype=torch.float32)
    jp, tp = jplan(jcfg, 1), tm.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(0))
    return jp, params, tp, interop.params_from_jax(jax.tree.map(np.asarray, params), **CPU)


def tget_phi3():
    return tconfigs.get_config("phi3_mini_3_8b")


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("bits,frac", [(2, 0.0), (3, 0.0), (4, 0.0), (8, 0.0), (3, 0.01), (4, 0.02)])
def test_rtn_quantize_for_serving_matches_reference(fp32_pair, bits, frac):
    jp, params, tp, tparams = fp32_pair
    jq, jlabel = jqparams.rtn_quantize_for_serving(jp, params, bits=bits, outlier_frac=frac)
    tq, tlabel = tqparams.rtn_quantize_for_serving(tp, tparams, bits=bits, outlier_frac=frac)
    assert tlabel == ("linear-packed" if bits == 4 else "linear")
    for key, blk in tq["dec"].items():
        for name, t in blk.items():
            j = jq["dec"][key][name]
            if not isinstance(t, QuantizedTensor):
                continue
            assert (t.bits, t.packed) == (j.bits, j.packed) == (bits, bits == 4)
            np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
            js = np.asarray(j.scale)
            assert np.all(np.abs(t.scale.numpy() - js) <= 2 * _ulp(js))
            z = t.zero.numpy()
            np.testing.assert_array_equal(z, np.asarray(j.zero))
            assert np.all((z == np.round(z)) & (z >= 0) & (z <= (1 << bits) - 1))
            if not frac:
                assert t.outlier_idx is None and j.outlier_idx is None
                continue
            # Index sets per period: equal but for entries within one ulp of
            # the boundary |residual|.
            dq = tqparams.dequantize_tensor(dataclasses.replace(t, outlier_idx=None,
                                                                outlier_values=None))
            w = tparams["dec"][key][name]
            w = w.reshape(w.shape[0], -1, dq.shape[-2]).transpose(1, 2)
            for period in range(t.codes.shape[0]):
                resid = np.abs((w[period] - dq[period]).numpy().ravel())
                ti, ji = set(t.outlier_idx[period].tolist()), set(np.asarray(j.outlier_idx[period]).tolist())
                assert len(ti) == len(ji) == t.outlier_idx.shape[-1]
                edge = min(resid[list(ti)])
                for i in ti ^ ji:
                    assert abs(resid[i] - edge) <= _ulp(edge), (key, name, period, i)
                common = sorted(ti & ji)
                tv = dict(zip(t.outlier_idx[period].tolist(), t.outlier_values[period].tolist()))
                jv = dict(zip(np.asarray(j.outlier_idx[period]).tolist(),
                              np.asarray(j.outlier_values[period], np.float32).tolist()))
                assert [tv[i] for i in common] == [jv[i] for i in common]


def test_rtn_draft_of_a_quantized_target_dequantizes_first(fp32_pair):
    _, _, tp, tparams = fp32_pair
    q4, _ = tqparams.rtn_quantize_for_serving(tp, tparams, bits=4)
    d3, _ = tqparams.rtn_quantize_for_serving(tp, q4, bits=3)
    wq = d3["dec"]["b0"]["wq"]
    assert wq.bits == 3 and not wq.packed and wq.codes.shape == q4["dec"]["b0"]["wq"].shape
    assert int(wq.codes.max()) <= 7


# ---------------------------------------------------------------------------
# The mixed-bits emit, its restack, and serving it
# ---------------------------------------------------------------------------


def _mixed_specs(keys):
    """Every candidate width across the layers, COO outliers on every fourth."""
    specs = {}
    for i, key in enumerate(sorted(keys)):
        b = (2, 3, 4, 8)[i % 4]
        specs[key] = (LayerSpec(bits=b, outlier_frac=0.02, method="qe_outlier") if i % 4 == 3
                      else LayerSpec(bits=b))
    return specs


@pytest.fixture(scope="module")
def small_model():
    cfg = reduce_cfg(tget_phi3(), d_model=96, head_dim=24, d_ff=192, n_periods=3)
    plan = tm.make_plan(cfg)
    params = tm.init_params(plan, 0, **CPU)
    calib = [{"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (2, 96)).astype(np.int32)}]
    return plan, params, calib


@pytest.fixture(scope="module")
def mixed_artifact(small_model):
    plan, params, calib = small_model
    _, probe = tsolver.ptq_quantize_model(plan, params, calib, PTQConfig(method="rtn"), **CPU)
    specs = _mixed_specs(probe)
    qp, rep = tsolver.ptq_quantize_model(
        plan, params, calib, PTQConfig(method="quantease", spec=GridSpec(bits=8), iterations=3,
                                       emit="qt", layer_specs=specs), **CPU)
    return plan, params, qp, rep, specs


def test_mixed_emit_respects_layer_specs(mixed_artifact):
    plan, params, qp, rep, specs = mixed_artifact
    seen = set()
    for period, blocks in enumerate(qp["dec"]):
        for bkey, blk in blocks.items():
            for name, leaf in blk.items():
                if isinstance(leaf, QuantizedTensor):
                    key = f"dec.p{period}.{bkey}/{name}"
                    assert leaf.bits == specs[key].bits, key
                    assert (leaf.outlier_values is not None) == bool(specs[key].outlier_frac), key
                    seen.add(leaf.bits)
    assert seen == {2, 3, 4, 8}


def test_mixed_restack_token_identity(mixed_artifact):
    """Every width in one stacked artifact; the contiguous and the paged
    engine give the same tokens, and the hoisted speculative verify (the
    artifact as its own draft) the same again."""
    from repro_torch.serve.spec import SpecConfig

    plan, params, qp, _, _ = mixed_artifact
    serving = tqparams.quantize_params_for_serving(plan, params, qp["dec"], **CPU)
    wq = serving["dec"]["b0"]["wq"]
    assert wq.codes.shape[0] == plan.cfg.n_periods and not wq.packed and wq.bits == 8
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, plan.cfg.vocab, n).astype(np.int32) for n in (5, 11, 23)]

    def generate(make):
        eng = make()
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=8))
        return [r.output for r in sorted(eng.run(), key=lambda r: r.rid)]

    contig = generate(lambda: ServingEngine(plan, serving, max_batch=2, max_seq=96, prefill_pad=8,
                                            **CPU))
    paged = generate(lambda: PagedServingEngine(plan, serving, max_batch=2, max_seq=96, page_size=8,
                                                prefill_chunk=16, **CPU))
    spec = generate(lambda: PagedServingEngine(plan, serving, max_batch=2, max_seq=96, page_size=8,
                                               prefill_chunk=16, n_pages=1 + 4 * 12,
                                               spec=SpecConfig(plan, serving, gamma=3), **CPU))
    assert contig == paged == spec


def test_mixed_restack_matches_the_reference_restack(mixed_artifact):
    """The reference's harmonized restack of the port's per-period leaves
    (carried across) holds the same bytes as the port's."""
    plan, params, qp, _, _ = mixed_artifact
    serving = tqparams.quantize_params_for_serving(plan, params, qp["dec"], **CPU)
    to_j = lambda l: jqparams.QuantizedTensor(**{
        f.name: (jnp.asarray(getattr(l, f.name).numpy())
                 if isinstance(getattr(l, f.name), torch.Tensor) else getattr(l, f.name))
        for f in dataclasses.fields(l)})
    for name in ("wq", "wd"):
        jleaves = jqparams.harmonize_qt_stack([to_j(p["b0"][name]) for p in qp["dec"]])
        for f in ("codes", "scale", "zero", "outlier_values", "outlier_idx"):
            got = getattr(serving["dec"]["b0"][name], f)
            want = [getattr(l, f) for l in jleaves]
            if got is None:
                assert all(w is None for w in want)
            else:
                np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(w) for w in want]))


# ---------------------------------------------------------------------------
# The allocator, against the reference on the same stats
# ---------------------------------------------------------------------------


def _random_stats(seed):
    rng = np.random.default_rng(seed)
    stats = {}
    for i in range(int(rng.integers(1, 9))):
        key = f"dec.p{i // 3}.b0/w{'qkvogud'[i % 7]}"
        errs = np.sort(rng.random(4))[::-1] * rng.choice([1.0, 0.1])
        err = dict(zip((2, 3, 4, 8), map(float, errs)))
        if rng.random() < 0.5:
            err[(2, 0.01)] = float(errs[0] * rng.random())
        stats[key] = (int(rng.choice([64, 256, 1024])), float(rng.random() * 10), err)
    budget = float(rng.choice([2.0, 2.5, 3.0, 3.7, 4.0, 8.0]))
    policy = str(rng.choice(["sensitivity", "error"]))
    fracs = (0.01,) if rng.random() < 0.5 else ()
    return stats, budget, policy, fracs


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=0, max_value=2**32 - 1))
def test_allocate_matches_reference(seed):
    raw, budget, policy, fracs = _random_stats(seed)
    tstats = {k: LayerStat(k, n, lam, dict(e)) for k, (n, lam, e) in raw.items()}
    jstats = {k: jsens.LayerStat(k, n, lam, dict(e)) for k, (n, lam, e) in raw.items()}
    tcfg = AllocConfig(budget_avg_bits=budget, outlier_frac_candidates=fracs, policy=policy)
    jcfg = JAllocConfig(budget_avg_bits=budget, outlier_frac_candidates=fracs, policy=policy)
    assert upgrade_sequence(tstats, tcfg) == jupgrade_sequence(jstats, jcfg)
    t, j = allocate(tstats, tcfg), jallocate(jstats, jcfg)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.avg_bits <= budget + 1e-9


def test_allocator_refusals():
    with pytest.raises(ValueError, match="ascending"):
        AllocConfig(bits_candidates=(4, 2))
    with pytest.raises(ValueError, match="policy"):
        AllocConfig(policy="random")
    st_ = {"a": LayerStat("a", 10, 1.0, {2: 0.5, 3: 0.2})}
    with pytest.raises(ValueError, match="floor width"):
        allocate(st_, AllocConfig(budget_avg_bits=1.5))
    with pytest.raises(ValueError, match="below every candidate"):
        TuneConfig(budget_avg_bits=1.0).uniform_bits()


# ---------------------------------------------------------------------------
# Probes, collect_sensitivity and tune_model
# ---------------------------------------------------------------------------


def _calib(plan, n=2, seq=32, split="calib"):
    from repro_torch.data import DataConfig, make_batch_fn

    fn, _ = make_batch_fn(DataConfig(vocab=plan.cfg.vocab, seed=0), plan.cfg, 2, seq, split=split)
    return fn, [fn(i) for i in range(n)]


def test_probe_layer_stats_and_sensitivity_match_reference(fp32_pair):
    jp, params, tp, tparams = fp32_pair
    _, calib = _calib(tp)
    jstats = jsens.probe_layer_stats(jp, params, [{"tokens": jnp.asarray(b["tokens"])} for b in calib],
                                     bits_candidates=(3,))
    tstats = probe_layer_stats(tp, tparams, calib, bits_candidates=(3,), **CPU)
    assert list(tstats) == list(jstats) and len(tstats) == 14
    for k, t in tstats.items():
        j = jstats[k]
        assert t.n_weights == j.n_weights and set(t.err) == set(j.err) == {3}
        assert t.lambda_max == pytest.approx(j.lambda_max, rel=1e-5)
        assert t.err[3] == pytest.approx(j.err[3], rel=1e-4)
    # The solver's records carry λ_max per block, keyed as the report.
    recs = []
    tsolver.ptq_quantize_model(tp, tparams, calib, PTQConfig(method="rtn", collect_sensitivity=True),
                               progress_cb=recs.append, **CPU)
    assert [sorted(r["lambda_max"]) for r in recs] == [sorted(r["layer_errors"]) for r in recs]
    recs = []
    tsolver.ptq_quantize_model(tp, tparams, calib, PTQConfig(method="rtn"), progress_cb=recs.append,
                               **CPU)
    assert all("lambda_max" not in r for r in recs)


@pytest.fixture(scope="module")
def tuned(small_model):
    plan, params, _ = small_model
    eval_fn, _ = _calib(plan, split="eval")
    _, calib = _calib(plan)
    tcfg = TuneConfig(bits_candidates=(2, 3, 4, 8), iterations=2, n_ppl_batches=1)
    stats = probe_layer_stats(plan, params, calib, bits_candidates=tcfg.bits_candidates, **CPU)
    doc = tune_model(plan, params, calib, eval_fn, tcfg, stats=stats, **CPU)
    return plan, params, calib, eval_fn, tcfg, stats, doc


def test_tune_model_never_worse_than_uniform(tuned):
    plan, params, calib, eval_fn, tcfg, stats, doc = tuned
    assert [c["label"] for c in doc["candidates"]] == [
        "uniform@3b", "greedy-sensitivity", "greedy-error"]
    assert doc["best"]["ppl"] <= doc["uniform"]["ppl"]
    for c in doc["candidates"][1:]:
        assert c["avg_bits"] <= tcfg.budget_avg_bits + 1e-9
        assert sum(c["bits_histogram"].values()) == len(stats)
    assert [c["label"] for c in build_candidates(stats, tcfg)] == [
        c["label"] for c in doc["candidates"]]


def test_tune_model_resumes_and_retries(tuned, monkeypatch):
    """Prior results replay without evaluation; a failed candidate is
    retried by the runner and the document equals the uninterrupted one."""
    from repro_torch.dist.elastic import RetryingRunner
    from repro_torch.tune import search

    plan, params, calib, eval_fn, tcfg, stats, doc = tuned
    real, calls = search.evaluate_candidate, []

    def flaky(*a, **kw):
        calls.append(a[4]["label"])
        if len(calls) == 1:
            raise RuntimeError("injected candidate failure")
        return real(*a, **kw)

    monkeypatch.setattr(search, "evaluate_candidate", flaky)
    persisted = []
    again = tune_model(plan, params, calib, eval_fn, tcfg, stats=stats,
                       prior_results=doc["candidates"][:1], result_cb=persisted.append,
                       runner_factory=lambda s, r: RetryingRunner(s, r, sleep_fn=lambda _: None),
                       **CPU)
    assert calls == ["greedy-sensitivity", "greedy-sensitivity", "greedy-error"]
    assert [p["label"] for p in persisted] == ["greedy-sensitivity", "greedy-error"]
    assert again == doc
    calls.clear()
    assert tune_model(plan, params, calib, eval_fn, tcfg, stats=stats,
                      prior_results=doc["candidates"], **CPU) == doc
    assert calls == []


# ---------------------------------------------------------------------------
# launch.tune against the reference's CLI, and serving its output
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fp32_configs():
    jget_, tget_ = jconfigs.get_config, tconfigs.get_config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfigs, "get_config", lambda n: dataclasses.replace(jget_(n), dtype=jnp.float32))
        mp.setattr(tconfigs, "get_config", lambda n: dataclasses.replace(tget_(n), dtype=torch.float32))
        yield


_TUNE = ("--arch", "phi3_mini_3_8b", "--reduce", "--budget-avg-bits", "3", "--bits-candidates",
         "2,4", "--policies", "sensitivity", "--iterations", "2", "--calib-batches", "1", "--seq",
         "32", "--ppl-batches", "1")


@pytest.fixture(scope="module")
def tune_clis(tmp_path_factory):
    from repro.launch import tune as jtune
    from repro_torch.launch import train as ttrain
    from repro_torch.launch import tune as ttune

    d = tmp_path_factory.mktemp("tune")
    with fp32_configs():
        ttrain.main(["--arch", "phi3_mini_3_8b", "--reduce", "--steps", "2", "--batch", "2",
                     "--seq", "32", "--ckpt-dir", str(d / "train"), "--device", "cpu"])
        tdoc = ttune.main([*_TUNE, "--ckpt-dir", str(d / "train"), "--out-dir", str(d / "t"),
                           "--device", "cpu"])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["tune", *_TUNE, "--ckpt-dir", str(d / "train"),
                                     "--out-dir", str(d / "j")])
            jtune.main()
    return d, tdoc, json.load(open(d / "j" / "tune.json"))


def test_tune_cli_matches_the_reference_cli(tune_clis):
    d, tdoc, jdoc = tune_clis
    assert json.load(open(d / "t" / "tune.json")) == json.loads(json.dumps(tdoc))
    assert [c["label"] for c in tdoc["candidates"]] == [c["label"] for c in jdoc["candidates"]]
    for t, j in zip(tdoc["candidates"], jdoc["candidates"]):
        assert t["avg_bits"] == j["avg_bits"] and t.get("bits_histogram") == j.get("bits_histogram")
        assert t["ppl"] == pytest.approx(j["ppl"], rel=1e-3)
    assert tdoc["best"]["label"] == jdoc["best"]["label"]
    if "winner_allocation" in jdoc:
        assert tdoc["winner_allocation"]["bits"] == jdoc["winner_allocation"]["bits"]


def test_tune_cli_resume_replays_every_candidate(tune_clis, capsys):
    from repro_torch.launch import tune as ttune
    from repro_torch.launch.progress import load_progress

    d, tdoc, _ = tune_clis
    with fp32_configs():
        again = ttune.main([*_TUNE, "--ckpt-dir", str(d / "train"), "--out-dir", str(d / "t"),
                            "--resume", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resume: 2 candidate(s) already evaluated" in out and "[candidate]" not in out
    assert again["candidates"] == json.loads(json.dumps(tdoc["candidates"]))
    recs = load_progress(str(d / "t" / "progress.jsonl"))
    assert sum("candidate" in r for r in recs) == 2


def test_tuned_artifact_loads_and_serves_with_speculation(tune_clis):
    """The tuner's checkpoint (QuantizedTensor leaves, their layout in the
    manifest's meta) loads through ``launch.common.load_params`` and serves,
    plainly and speculatively, with the same tokens."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch.common import load_params, model_config

    d = tune_clis[0]
    with fp32_configs():
        plan = tm.make_plan(model_config("phi3_mini_3_8b", True))
        params, manifest = load_params(str(d / "t"), plan, "cpu")
        assert manifest["meta"]["tuned"] and "qt_layout" in manifest["meta"]
        wq = params["dec"]["b0"]["wq"]
        assert isinstance(wq, QuantizedTensor) and wq.codes.shape[0] == plan.cfg.n_periods
        base = ("--arch", "phi3_mini_3_8b", "--reduce", "--ckpt-dir", str(d / "t"), "--requests", "3",
                "--max-new", "5", "--device", "cpu")
        plain = tserve.main(list(base))
        for extra in (("--draft-bits", "3"), ("--draft-layers", "1")):
            spec = tserve.main([*base, "--speculate", *extra])
            assert [r.output for r in spec["requests"]] == [r.output for r in plain["requests"]]
            assert spec["spec"]["draft_tokens"] > 0
