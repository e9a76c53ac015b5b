"""The port's mixture-of-experts path against the reference's.

Reduced (``reduce_cfg``: 4 experts, top-2) fp32 OLMoE and Mixtral, the
reference's params carried across with ``repro_torch.interop``, numpy-seeded
inputs.  Tolerances:

* the dispatch table (slots, drops) exactly; ``moe_apply``'s output within
  1e-5 of max |y|, its router probabilities within 1e-6;
  ``router_aux_loss`` within 1e-6 relative;
* per-expert Σ from ``capture_gram_stats`` within 1e-6 of each expert's
  max |Σ|, the empty slots' rows of token 0 included: an expert nothing is
  routed to has Σ = C · x₀x₀ᵀ in both packages (the reference's fill,
  copied on purpose: ``ROADMAP.md`` §3);
* the solver on the reduced OLMoE (``emit="qt"``): report keys equal as a
  set (one ``.e{i}`` per expert), errors within 1e-4 relative; zero points
  and COO planes equal, scales within 2 fp32 ulp (the reference's jitted
  outlier engine divides by multiplying), codes equal outside rows that
  start at a verified rounding tie (:func:`_tie_rows`); the reference's
  restacked artifacts carried across score within 1e-5 relative;
* expert grids' zero points are checked like every other grid's; RTN
  serving quantizes each expert as the reference's ``quantize_tensor``;
  the tuner's ``_leaf_key`` and leaf sizes agree; checkpoints of MoE and
  learned-position params cross between the packages bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import quantease as jquantease
from repro.core import solver as jsolver
from repro.dist import checkpoint as jckpt
from repro.eval import scorer as jscorer
from repro.models import common as jcommon
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.quant import GridSpec as JSpec
from repro.quant import quantize_tensor as jquantize
from repro.serve import qparams as jqparams
from repro.tune import sensitivity as jsens
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.core import quantease as tquantease
from repro_torch.core import solver as tsolver
from repro_torch.dist import checkpoint as tckpt
from repro_torch.eval import scorer as tscorer
from repro_torch.models import common as tcommon
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.quant import GridSpec as TSpec
from repro_torch.quant import compute_grid as tgrid
from repro_torch.quant import QuantizedTensor
from repro_torch.serve import qparams as tqparams
from repro_torch.tree import tree_leaves
from repro_torch.tune import sensitivity as tsens
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests.test_torch_cuda import midpoint_gap

CPU = "cpu"
JIT_ULP = 2.4e-7  # two fp32 ulp


def _np(t):
    return t.detach().cpu().numpy()


def _moe_inputs(seed, *, B=2, S=24, D=64, E=4, F=96, gated=True, dead_expert=None):
    r = np.random.default_rng(seed)
    p = {"router": r.standard_normal((D, E)).astype(np.float32) * 0.3,
         "w_gate": r.standard_normal((E, D, F)).astype(np.float32) * 0.1,
         "w_down": r.standard_normal((E, F, D)).astype(np.float32) * 0.1}
    if gated:
        p["w_up"] = r.standard_normal((E, D, F)).astype(np.float32) * 0.1
    if dead_expert is not None:
        p["router"][:, dead_expert] = 0.0
        x = r.standard_normal((B, S, D)).astype(np.float32)
        x[..., 0] = np.abs(x[..., 0]) + 1.0  # feature 0 > 0 everywhere ...
        p["router"][0, dead_expert] = -100.0  # ... so this expert is never picked
    else:
        x = r.standard_normal((B, S, D)).astype(np.float32)
    return p, x


def _both(p, x):
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))


# ---------------------------------------------------------------------------
# moe_apply and its pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [5, 8, 40])
def test_dispatch_table_is_exact(capacity):
    """Slots and drops equal; ``capacity`` 5 and 8 overflow some experts."""
    ids = np.random.default_rng(capacity).integers(0, 4, 48).astype(np.int32)
    jcopy, jslot = jmoe._dispatch_table(jnp.asarray(ids), 4, capacity)
    tcopy, tslot = tmoe._dispatch_table(torch.from_numpy(ids).long(), 4, capacity)
    np.testing.assert_array_equal(_np(tcopy), np.asarray(jcopy))
    np.testing.assert_array_equal(_np(tslot), np.asarray(jslot))
    assert (capacity >= 40) == bool((_np(tslot) < 4 * capacity).all())


@pytest.mark.parametrize("norm_topk,top_k,dead_expert", [
    (True, 2, None), (False, 2, None), (True, 1, None), (False, 3, None), (True, 2, 3),
])
def test_moe_apply_matches(norm_topk, top_k, dead_expert):
    """``dead_expert``: one expert no token picks, so the others overflow
    their capacity and drop copies."""
    p, x = _moe_inputs(1, dead_expert=dead_expert)
    jp, jx, tp, tx = _both(p, x)
    kw = dict(n_experts=4, top_k=top_k, act="silu", gated=True, norm_topk=norm_topk,
              return_aux=True)
    jy, jprobs = jmoe.moe_apply(jp, jx, **kw)
    ty, tprobs = tmoe.moe_apply(tp, tx, **kw)
    jy = np.asarray(jy)
    np.testing.assert_allclose(_np(ty), jy, rtol=0, atol=1e-5 * np.abs(jy).max())
    np.testing.assert_allclose(_np(tprobs), np.asarray(jprobs), rtol=0, atol=1e-6)
    assert float(tmoe.router_aux_loss(tprobs)) == pytest.approx(
        float(jmoe.router_aux_loss(jprobs)), rel=1e-6)


def test_moe_apply_non_gated_gelu():
    p, x = _moe_inputs(2, gated=False)
    jp, jx, tp, tx = _both(p, x)
    kw = dict(n_experts=4, top_k=2, act="gelu", gated=False, norm_topk=True)
    jy = np.asarray(jmoe.moe_apply(jp, jx, **kw)[0])
    np.testing.assert_allclose(_np(tmoe.moe_apply(tp, tx, **kw)[0]), jy, rtol=0,
                               atol=1e-5 * np.abs(jy).max())


def _capture(pkg, p, x, **kw):
    stats = {}
    common, moe = (jcommon, jmoe) if pkg == "jax" else (tcommon, tmoe)
    with common.capture_gram_stats(stats), common.capture_scope("blk"):
        moe.moe_apply(p, x, **kw)
    return stats


@pytest.mark.parametrize("dead_expert", [None, 3])
def test_expert_sigma_matches_reference(dead_expert):
    p, x = _moe_inputs(3, dead_expert=dead_expert)
    jp, jx, tp, tx = _both(p, x)
    kw = dict(n_experts=4, top_k=2, act="silu", gated=True, norm_topk=True)
    jst, tst = _capture("jax", jp, jx, **kw), _capture("torch", tp, tx, **kw)
    assert sorted(tst) == sorted(jst) == ["blk/w_down", "blk/w_gate", "blk/w_up"]
    for k in jst:
        js, ts = np.asarray(jst[k].sigma), _np(tst[k].sigma)
        assert ts.shape == js.shape and ts.shape[0] == 4
        assert tst[k].n == jst[k].n
        for e in range(4):
            np.testing.assert_allclose(ts[e], js[e], rtol=0, atol=1e-6 * np.abs(js[e]).max())


def test_empty_slots_add_token_zero_to_sigma():
    """The reference fills every empty dispatch slot with token 0 of the
    group and records the whole table, so an expert that no token picks has
    Σ = C · x₀x₀ᵀ, C the capacity; the port copies it."""
    p, x = _moe_inputs(4, dead_expert=3)
    jp, jx, tp, tx = _both(p, x)
    kw = dict(n_experts=4, top_k=2, act="silu", gated=True, norm_topk=True)
    n = x.shape[0] * x.shape[1]
    cap = max(int(n * 2 / 4 * 1.25), 8)
    x0 = x.reshape(n, -1)[0].astype(np.float64)
    want = cap * np.outer(x0, x0)
    for pkg, pp, xx in (("jax", jp, jx), ("torch", tp, tx)):
        sig = np.asarray(_capture(pkg, pp, xx, **kw)["blk/w_gate"].sigma[3])
        np.testing.assert_allclose(sig, want, rtol=0, atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The solver, the serving restack and the quantized forward on reduced OLMoE
# ---------------------------------------------------------------------------

SOLVER_METHODS = ("rtn", "quantease", "qe_outlier")


def _olmoe_pair(seed=0):
    jcfg = dataclasses.replace(reduce_cfg(jget("olmoe_1b_7b")), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("olmoe_1b_7b")), dtype=torch.float32)
    jp, tp = jplan(jcfg, 1), tm.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(seed))
    return jp, params, tp, interop.params_from_jax(jax.tree.map(np.asarray, params), device=CPU)


class _Runs(dict):
    """Each method's solver runs in both packages, computed on first use
    (once per module): the first test of a method pays for its runs."""

    def __init__(self):
        super().__init__()
        jp, params, tp, tparams = _olmoe_pair()
        r = np.random.default_rng(7)
        calib = [{"tokens": r.integers(0, 256, (2, 32)).astype(np.int32)} for _ in range(2)]
        evals = [r.integers(0, 256, (2, 32)).astype(np.int32) for _ in range(2)]
        self["setup"] = (jp, params, tp, tparams, calib, evals)

    def __missing__(self, method):
        jp, params, tp, tparams, calib, _ = self["setup"]
        kw = dict(method=method, iterations=3, emit="qt", outlier_frac=0.02)
        jq, jrep = jsolver.ptq_quantize_model(
            jp, params, [{"tokens": jnp.asarray(b["tokens"])} for b in calib],
            jsolver.PTQConfig(spec=JSpec(bits=4), **kw))
        records = []
        tq, trep = tsolver.ptq_quantize_model(tp, tparams, calib,
                                              tsolver.PTQConfig(spec=TSpec(bits=4), **kw),
                                              progress_cb=records.append, device=CPU)
        jserve = jqparams.quantize_params_for_serving(jp, params, jq["dec"])
        tserve = tqparams.quantize_params_for_serving(tp, tparams, tq["dec"], device=CPU)
        self[method] = dict(jq=jq, tq=tq, jrep=jrep, trep=trep, jserve=jserve, tserve=tserve,
                            records=records)
        return self[method]


@pytest.fixture(scope="module")
def moe_runs():
    return _Runs()


@pytest.mark.parametrize("method", SOLVER_METHODS)
def test_solver_report_keys_and_errors_match(moe_runs, method):
    r = moe_runs[method]
    assert set(r["trep"]) == set(r["jrep"])
    experts = [k for k in r["trep"] if ".e" in k.rsplit("/", 1)[1]]
    assert len(experts) == 2 * 3 * 4  # periods × matrices × experts
    for k in ("dec.p0.b0/w_gate.e0", "dec.p1.b0/w_down.e3", "dec.p0.b0/wq"):
        assert k in r["trep"]
    for k, v in r["jrep"].items():
        assert r["trep"][k] == pytest.approx(v, rel=1e-4), k
    rec = r["records"][0]
    assert rec["n_linears"] == 4 + 3 * 4 and set(rec["layer_errors"]) <= set(r["trep"])


def _group(pkg, blk, stats, scope, name):
    """The solver's group of ``name``: every quantizable leaf of the block
    with its solver shape, in sorted order, as ``(names, w3, Σ3)``."""
    def item(n):
        w, sig = blk[n], stats[f"{scope}/{n}"].sigma
        if n in ("w_gate", "w_up", "w_down"):
            return (jnp.swapaxes(w, 1, 2), sig) if pkg == "jax" else (w.transpose(1, 2), sig)
        w2 = w.reshape(sig.shape[-1], -1).T
        return (w2[None], sig[None])
    items = {n: item(n) for n in sorted(blk) if f"{scope}/{n}" in stats}
    shape = items[name][0].shape[1:]
    names = [n for n, (w3, _) in items.items() if w3.shape[1:] == shape]
    cat = jnp.concatenate if pkg == "jax" else torch.cat
    return names, cat([items[n][0] for n in names]), cat([items[n][1] for n in names])


def _period_stats(moe_runs, method, period):
    """Each package's Σ of one period's block, captured as its solver did:
    the embedded calibration tokens through the earlier periods' quantized
    blocks."""
    jp, params, tp, tparams, calib, _ = moe_runs["setup"]
    r = moe_runs[method]
    b = jp.cfg.pattern[0]
    jx = [jm._embed_tokens(jp, params, jnp.asarray(c["tokens"])) for c in calib]
    tx = [tm._embed_tokens(tp, tparams, torch.from_numpy(c["tokens"]).long()) for c in calib]
    japply = lambda blk, x: jm._block_apply(jp.cfg, jp.heads, b, blk, x, mode="train",
                                            pos_ids=jnp.arange(x.shape[1]))[0]
    tapply = lambda blk, x: tsolver._apply_block(tp, b, blk, x)
    for i in range(period):
        jx = [japply(r["jq"]["dec"][i]["b0"], x) for x in jx]
        tx = [tapply(r["tq"]["dec"][i]["b0"], x) for x in tx]
    jst, tst, scope = {}, {}, f"dec.p{period}.b0"
    with jcommon.capture_gram_stats(jst), jcommon.capture_scope(scope):
        for x in jx:
            japply(jax.tree.map(lambda a: a[period], params["dec"]["b0"]), x)
    with tcommon.capture_gram_stats(tst), tcommon.capture_scope(scope):
        for x in tx:
            tapply(tm.period_slice(tparams["dec"], period)["b0"], x)
    return jst, tst, scope


def _tie_rows(moe_runs, method, period, name, jc, tc, iterations=3):
    """The rows (expert, row) where the two packages' codes of ``name``
    differ; each must start at a verified rounding tie.

    The group's solve is rerun in both packages on their own Σ, one to
    ``iterations`` iterations (rows are independent in the CD).  At the
    first iteration and column where a row parts, its β is recomputed in
    float64 from the port's state (the columns before it from this
    iteration, those after from the previous one; the two packages agree on
    both there), and must lie within the fp32 rounding bound of a rounding
    midpoint of its grid."""
    jp, params, tp, tparams, _, _ = moe_runs["setup"]
    jst, tst, scope = _period_stats(moe_runs, method, period)
    jblk = jax.tree.map(lambda a: a[period], params["dec"]["b0"])
    tblk = tm.period_slice(tparams["dec"], period)["b0"]
    names, jw3, jsig3 = _group("jax", jblk, jst, scope, name)
    _, tw3, tsig3 = _group("torch", tblk, tst, scope, name)
    g0 = sum(jblk[n].shape[0] if n.startswith("w_") else 1 for n in names[: names.index(name)])
    jspec, tspec = JSpec(bits=4), TSpec(bits=4)
    from repro.quant import compute_grid as jgrid

    jg, tg = jax.vmap(lambda wi: jgrid(wi, jspec))(jw3), tgrid(tw3.float(), tspec)
    jruns = [np.asarray(jquantease.quantease_quantize(jw3, jsig3, jspec, iterations=i, grid=jg)[0])
             for i in range(1, iterations + 1)]
    truns = [_np(tquantease.quantease_quantize(tw3, tsig3, tspec, iterations=i, grid=tg)[0])
             for i in range(1, iterations + 1)]
    scale, zero = _np(tg.scale)[..., 0], _np(tg.zero)[..., 0]  # per channel
    to_codes = lambda w, g: np.round(w / scale[g][:, None] + zero[g][:, None])
    rows = set()
    for e, r in zip(*np.nonzero((jc != tc).any(-1))):
        g = g0 + int(e)
        # The reruns reproduce the whole-model solves in this row.
        assert np.array_equal(to_codes(truns[-1][g], g)[r], tc[e, r]), (name, e, r)
        assert np.array_equal(to_codes(jruns[-1][g], g)[r], jc[e, r]), (name, e, r)
        it = next(i for i in range(iterations) if not np.array_equal(truns[i][g, r], jruns[i][g, r]))
        prev = truns[it - 1][g, r] if it else _np(tw3[g, r])
        j = int(np.argmax(truns[it][g, r] != jruns[it][g, r]))
        gap, tol = midpoint_gap(_np(tw3[g, r]), _np(tsig3[g]), scale[g, r], zero[g, r],
                                truns[it][g, r], prev, j)
        assert gap <= tol, (name, e, r, it, j, gap, tol)
        rows.add((int(e), int(r)))
    return rows


@pytest.mark.parametrize("method", SOLVER_METHODS)
def test_solver_expert_artifact_matches(moe_runs, method):
    """Every expert's zero points and COO planes equal; scales within two
    ulp; codes equal outside verified tie rows (QuantEase), at most 1 % of
    rows; the restacked leaf has lead axes (layers, experts)."""
    r = moe_runs[method]
    n = n_rows = 0
    ties = set()
    for period, (jper, tper) in enumerate(zip(r["jq"]["dec"], r["tq"]["dec"])):
        for name in ("w_gate", "w_up", "w_down", "wq", "wo"):
            jqt, tqt = jper["b0"][name], tper["b0"][name]
            assert (tqt.bits, tqt.packed, tqt.shape) == (jqt.bits, jqt.packed, tuple(jqt.shape))
            fields = ["zero"] + (["outlier_idx", "outlier_values"] if method == "qe_outlier" else [])
            for f in fields:
                np.testing.assert_array_equal(_np(getattr(tqt, f)), np.asarray(getattr(jqt, f)),
                                              err_msg=f"{name}.{f}")
            np.testing.assert_allclose(_np(tqt.scale), np.asarray(jqt.scale), rtol=JIT_ULP, atol=0)
            jc = np.asarray(jqt.unpacked_codes()).reshape(-1, *tqt.shape[-2:])
            tc = _np(tqt.unpacked_codes()).reshape(jc.shape)
            n_rows += jc.shape[0] * jc.shape[1]
            if not np.array_equal(jc, tc):
                assert method == "quantease", (name, "codes")
                ties |= {(period, name, *k) for k in _tie_rows(moe_runs, method, period, name,
                                                              jc, tc)}
            n += 1
    assert n == 10 and len(ties) <= 0.01 * n_rows, ties
    wg = r["tserve"]["dec"]["b0"]["w_gate"]
    assert tuple(wg.codes.shape[:2]) == (2, 4)
    assert wg.codes.shape == tuple(np.asarray(r["jserve"]["dec"]["b0"]["w_gate"].codes).shape)


@pytest.mark.parametrize("method", SOLVER_METHODS)
def test_quantized_moe_forward_matches(moe_runs, method):
    """The reference's restacked artifact, carried across, through each
    package's forward: the port's expert GEMMs
    (``ops.dequant_matmul_experts``, the plain version on the CPU) against
    the reference's vmapped ``dequant_matmul_ref``."""
    r = moe_runs[method]
    jp, _, tp, _, _, evals = moe_runs["setup"]
    carried = interop.params_from_jax(jax.tree.map(np.asarray, r["jserve"]), device=CPU)
    for toks in evals:
        jh = np.asarray(jscorer._hidden_states(jp, r["jserve"], jnp.asarray(toks)))
        th = _np(tm.hidden_states(tp, carried, torch.from_numpy(toks).long()))
        np.testing.assert_allclose(th, jh, rtol=0, atol=1e-5 * np.abs(jh).max())


@pytest.mark.parametrize("kind", ["deny", "permanent"])
def test_expert_gemms_pass_the_dispatch_fault_site(kind):
    """Each expert's GEMM passes ``kernel.dispatch`` as a dense quantized
    linear does: a ``deny`` at the third expert answers it with the plain
    version (on the CPU; on the card it raises), a ``permanent`` raises
    there, and the trail names that hit."""
    from repro_torch.faults import FaultPlan, FaultSpec, PermanentFault, fault_plan
    from repro_torch.kernels import ops, ref

    r = np.random.default_rng(3)
    E, C, q, p = 4, 6, 24, 32
    xs = torch.from_numpy(r.standard_normal((E, C, p)).astype(np.float32))
    codes = torch.from_numpy(r.integers(0, 16, (E, q, p)).astype(np.uint8))
    scale = torch.from_numpy(r.uniform(0.01, 0.02, (E, q, 1)).astype(np.float32))
    zero = torch.full((E, q, 1), 8.0)
    plan = FaultPlan([FaultSpec(site="kernel.dispatch", kind=kind, at=(2,))])
    with fault_plan(plan):
        if kind == "permanent":
            with pytest.raises(PermanentFault):
                ops.dequant_matmul_experts(xs, codes, scale, zero, out_dtype=torch.float32)
        else:
            y = ops.dequant_matmul_experts(xs, codes, scale, zero, out_dtype=torch.float32)
            for e in range(E):
                torch.testing.assert_close(y[e], ref.dequant_matmul_ref(
                    xs[e], codes[e], scale[e], zero[e], out_dtype=torch.float32), rtol=0, atol=0)
    assert plan.fired == [("kernel.dispatch", 2, kind)]


def test_quantease_beats_rtn_on_experts(moe_runs):
    mean = lambda rep: float(np.mean([v for k, v in rep.items() if ".e" in k]))
    assert mean(moe_runs["quantease"]["trep"]) < mean(moe_runs["rtn"]["trep"])


def test_reference_artifact_carried_across_scores_alike(moe_runs):
    """The reference's restacked QuantEase artifact, carried into the port
    with interop, gives the port's perplexity within 1e-5."""
    r = moe_runs["quantease"]
    jp, _, tp, _, _, evals = moe_runs["setup"]
    carried = interop.params_from_jax(jax.tree.map(np.asarray, r["jserve"]), device=CPU)
    assert isinstance(carried["dec"]["b0"]["w_down"], QuantizedTensor)
    batches = lambda i: {"tokens": evals[i % 2]}
    jppl = jscorer.perplexity_on_stream(jp, r["jserve"], batches, n_batches=2)
    tppl = tscorer.perplexity_on_stream(tp, carried, batches, n_batches=2, device=CPU)
    assert tppl["ppl"] == pytest.approx(jppl["ppl"], rel=1e-5)


def test_expert_zero_points_are_checked(moe_runs):
    """An expert grid with a zero point off the integers is refused where an
    artifact enters the port, as every grid is."""
    tq = moe_runs["rtn"]["tq"]
    jp, params, tp, tparams, _, _ = moe_runs["setup"]
    bad = [{"b0": dict(per["b0"])} for per in tq["dec"]]
    wg = bad[1]["b0"]["w_gate"]
    zero = wg.zero.clone()
    zero[2, 0] += 0.5
    bad[1]["b0"]["w_gate"] = dataclasses.replace(wg, zero=zero)
    with pytest.raises(ValueError, match="zero points must be integers"):
        tqparams.quantize_params_for_serving(tp, tparams, bad, device=CPU)
    jq = moe_runs["rtn"]["jq"]
    jwg = jax.tree.map(np.asarray, jq["dec"][1]["b0"]["w_gate"])
    jzero = np.array(jwg.zero)
    jzero[3, 0] = 16.0  # outside [0, 15] at 4 bits
    with pytest.raises(ValueError, match="zero points must be integers"):
        interop.qtensor_from_jax(dataclasses.replace(jwg, zero=jzero), device=CPU)


def test_rtn_serving_quantizes_each_expert_as_the_reference(moe_runs):
    _, params, tp, tparams, _, _ = moe_runs["setup"]
    served, label = tqparams.rtn_quantize_for_serving(tp, tparams, bits=4)
    assert label == "linear-packed"
    qt = served["dec"]["b0"]["w_up"]
    assert tuple(qt.codes.shape[:2]) == (2, 4) and qt.packed
    w = np.asarray(params["dec"]["b0"]["w_up"])  # (periods, E, d, f)
    for i, e in ((0, 0), (1, 3)):
        jqt = jquantize(jnp.asarray(w[i, e].T), JSpec(bits=4))
        tqt = qt.map_arrays(lambda a: a[i, e])
        np.testing.assert_array_equal(_np(tqt.unpacked_codes()), np.asarray(jqt.codes))
        np.testing.assert_allclose(_np(tqt.scale), np.asarray(jqt.scale), rtol=JIT_ULP, atol=0)
        np.testing.assert_array_equal(_np(tqt.zero), np.asarray(jqt.zero))


def test_tuner_leaf_keys_and_sizes(moe_runs):
    jp, params, tp, tparams, _, _ = moe_runs["setup"]
    for k in ("dec.p0.b0/w_gate.e3", "dec.p1.b0/w_down.e12", "dec.p0.b0/wq", "x.e1y"):
        assert tsens._leaf_key(k) == jsens._leaf_key(k)
    assert tsens._leaf_key("dec.p0.b0/w_gate.e3") == "dec.p0.b0/w_gate"
    sizes = tsens._leaf_sizes(tp, tparams)
    assert sizes == jsens._leaf_sizes(jp, params)
    assert sizes["dec.p0.b0/w_gate"] == 4 * 64 * 128
    # The probes fold each leaf's experts into one stat.
    stats = tsens.probe_layer_stats(tp, tparams, moe_runs["setup"][4], bits_candidates=(4,),
                                    device=CPU)
    assert set(stats) == set(sizes)
    rep = moe_runs["rtn"]["trep"]
    want = np.mean([rep[f"dec.p0.b0/w_down.e{e}"] for e in range(4)])
    assert stats["dec.p0.b0/w_down"].err[4] == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# Checkpoints of MoE and learned-position params, both ways
# ---------------------------------------------------------------------------


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return _np(t.view(torch.int16)) if t.dtype == torch.bfloat16 else _np(t)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "opt_125m"])
def test_dense_checkpoints_cross_packages(tmp_path, arch):
    jp = jplan(reduce_cfg(jget(arch)), 1)
    tp = tm.make_plan(reduce_cfg(tget(arch)))
    params = jinit(jp, jax.random.PRNGKey(3))
    assert ("pos_emb" in params) == (arch == "opt_125m")
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, params)
    out, _ = tckpt.load_checkpoint(str(tmp_path / "j"), tm.empty_params(tp, device=CPU))
    j_leaves, t_leaves = jax.tree.leaves(params), tree_leaves(out)
    assert len(j_leaves) == len(t_leaves)
    for j, t in zip(j_leaves, t_leaves):
        np.testing.assert_array_equal(_tbits(t), _bits(j).view(np.int16)
                                      if _bits(j).dtype == np.uint16 else _bits(j))
    tckpt.save_checkpoint(str(tmp_path / "t"), 1, out)
    back, _ = jckpt.load_checkpoint(str(tmp_path / "t"), params)
    for j, b in zip(j_leaves, jax.tree.leaves(back)):
        np.testing.assert_array_equal(_bits(b), _bits(j))


def test_quantized_expert_checkpoints_cross_packages(tmp_path, moe_runs):
    r = moe_runs["qe_outlier"]
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, r["jserve"])
    out, _ = tckpt.load_checkpoint(str(tmp_path / "j"), r["tserve"])
    for j, t in zip(jax.tree.leaves(r["jserve"]), tree_leaves(out)):
        np.testing.assert_array_equal(_np(t), np.asarray(j))
    tckpt.save_checkpoint(str(tmp_path / "t"), 1, r["tserve"])
    back, _ = jckpt.load_checkpoint(str(tmp_path / "t"), r["jserve"])
    for t, b in zip(tree_leaves(r["tserve"]), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), _np(t))


# ---------------------------------------------------------------------------
# The command line on the new architectures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "opt_125m"])
def test_clis_run_the_new_archs(tmp_path, capsys, arch):
    """``launch.train`` then ``launch.quantize`` (RTN) and ``launch.serve``
    (paged: the arch probe takes MoE and learned positions) on the reduced
    config, on the CPU: every step finite, every request complete."""
    from repro_torch.launch import quantize as lquantize
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain

    common = ["--arch", arch, "--reduce", "--device", CPU]
    out = ltrain.main([*common, "--steps", "2", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path / "t")])
    assert np.isfinite(out["final_loss"])
    lquantize.main([*common, "--ckpt-dir", str(tmp_path / "t"), "--method", "rtn", "--bits", "4",
                    "--out-dir", str(tmp_path / "q")])
    res = lserve.main([*common, "--ckpt-dir", str(tmp_path / "q"), "--requests", "2",
                       "--max-new", "3"])
    assert res["engine"] == "paged"
    assert [r.status for r in res["requests"]] == ["completed"] * 2
    assert all(len(r.output) == 3 for r in res["requests"])
