"""The port's AWQ, AWQ+QuantEase and SpQR baselines, the solver's
``awq``/``awq_qe``/``spqr`` methods and ``LayerSpec`` against the
reference, on the same numpy inputs.

* ``awq_quantize``/``awq_then_quantease``: the chosen α (and β) equal,
  unless the two smallest candidate errors lie within ``ALPHA_GAP`` (1e-4
  relative) of each other; the candidate errors at rtol 1e-5; Ŵ within
  1e-5 × max |W| (AWQ, where a flipped rounding would move an entry by a
  grid step) and atol 2e-4 (AWQ+QuantEase, the CD engines' tolerance).  Ŵ
  is not bit for bit: the scales s = s_X^α go through ``pow``, ``log`` and
  ``exp``, whose fp32 results differ by an ulp between XLA and PyTorch.
* ``spqr_quantize``: the outlier mask equal outside entries whose saliency
  lies within 1e-5 relative of the s-th largest (the port breaks ties
  toward the lower index, as ``jax.lax.top_k``; on this problem there are
  none); Ŵ at GPTQ's tie rule (``tests/test_torch_gptq.py``).
* The reference's properties on the port (``tests/test_core.py``): AWQ ≤
  RTN, qe_outlier < SpQR at equal budget, AWQ+QuantEase ≤ 1.02 × QuantEase
  on a layer with per-channel activation-scale structure.
* The solver on a reduced fp32 Phi-3 layer: per-layer reports at rtol
  1e-3, the emitted codes equal in at least 98 % of rows (a rounding tie
  in a CD or GPTQ sweep flips the rest of its row; one row of 64 in wd
  under AWQ+QuantEase), scales at rtol 1e-5, zero points integers in [0, 2^bits − 1] (the dequant-GEMM's
  precondition) for each of the three methods.
* ``LayerSpec``: the resolution cases of ``tests/test_tune.py`` and the
  mixed-precision fake-quant run of ``tests/test_solver_serve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import awq as jawq
from repro.core import solver as jsolver
from repro.core import spqr as jspqr
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.quant import GridSpec as JSpec
from repro.quant import unpack_codes as junpack
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.core import awq as tawq
from repro_torch.core import gptq as tgptq
from repro_torch.core import outlier as tout
from repro_torch.core import quantease as tqe
from repro_torch.core import solver as tsolver
from repro_torch.core import spqr as tspqr
from repro_torch.core.solver import LayerSpec, PTQConfig
from repro_torch.data import pipeline as tpipe
from repro_torch.models import model as tmodel
from repro_torch.quant import GridSpec, compute_grid, quantize_dequantize
from repro_torch.serve.qparams import quantize_params_for_serving
from tests.conftest import reduce_cfg
from tests.test_torch_gptq import _check
from tests._torch_cpu import one_torch_thread  # noqa: F401

ALPHA_GAP = 1e-4
SPEC3 = GridSpec(bits=3)


def _problem(seed=42, q=96, p=128, n=512):
    r = np.random.default_rng(seed)
    x = r.standard_normal((p, n)).astype(np.float32)
    w = r.standard_normal((q, p)).astype(np.float32)
    w[r.random((q, p)) < 0.003] *= 10.0
    return w, x @ x.T


@pytest.fixture(scope="module")
def prob():
    return _problem()


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _err(w, w_hat, sigma):
    w, sigma = _t(w, sigma)
    return float(tqe.relative_error(w, torch.as_tensor(np.asarray(w_hat)), sigma))


def _ref_errors(w, sigma, spec, cands, search_beta):
    """The reference's candidate errors, by its own ``_candidate_error``."""
    sx = jnp.sqrt(jnp.clip(jnp.diag(sigma), 1e-12, None))
    sx = sx / jnp.exp(jnp.mean(jnp.log(sx)))
    sw = jnp.mean(jnp.abs(w), axis=0)
    sw = sw / jnp.exp(jnp.mean(jnp.log(jnp.clip(sw, 1e-12, None))))
    out = []
    for a, b in cands:
        s = jnp.clip(sx ** a * sw ** (-b), 1e-6, 1e6)
        out.append(float(jawq._candidate_error(w, sigma, spec, s)[0]))
    return np.array(out)


def _same_choice(t_errs, j_errs):
    """True where the argmins must agree: the two smallest errors are not
    within ALPHA_GAP of each other."""
    np.testing.assert_allclose(t_errs, j_errs, rtol=1e-5)
    lo = np.sort(j_errs)[:2]
    if lo[1] - lo[0] <= ALPHA_GAP * lo[0]:
        return False
    assert int(np.argmin(t_errs)) == int(np.argmin(j_errs))
    return True


@pytest.mark.parametrize("search_beta", [False, True])
def test_awq_matches_reference(prob, search_beta):
    w, sigma = prob
    cands, errs, _, _ = tawq.awq_search(*_t(w, sigma), SPEC3, search_beta=search_beta)
    n = 20
    ja = np.linspace(0.0, 1.0, n).astype(np.float32)
    np.testing.assert_array_equal(cands[:, 0].unique().numpy(), ja)  # jnp.linspace's points
    j_errs = _ref_errors(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3), cands.numpy(), search_beta)
    same = _same_choice(errs.numpy(), j_errs)
    j = np.asarray(jawq.awq_quantize(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3),
                                     search_beta=search_beta))
    t = tawq.awq_quantize(*_t(w, sigma), SPEC3, search_beta=search_beta).numpy()
    if same:
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(w).max())


def test_awq_then_quantease_matches_reference(prob):
    w, sigma = prob
    cands, errs, _, _ = tawq.awq_search(*_t(w, sigma), SPEC3)
    j_errs = _ref_errors(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3), cands.numpy(), False)
    same = _same_choice(errs.numpy(), j_errs)
    j = np.asarray(jawq.awq_then_quantease(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3),
                                           iterations=5))
    t = tawq.awq_then_quantease(*_t(w, sigma), SPEC3, iterations=5).numpy()
    if same:
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


def test_spqr_matches_reference(prob, monkeypatch):
    w, sigma = prob
    s = int(0.01 * w.size)
    jw, jmask = jspqr.spqr_quantize(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3), s=s)
    seen = []
    orig = tgptq._quant_dequant_cols

    def record(wc, scale, zero, n_levels):
        seen.append((wc / scale).clone())
        return orig(wc, scale, zero, n_levels)

    monkeypatch.setattr(tgptq, "_quant_dequant_cols", record)
    tw, tmask = tspqr.spqr_quantize(*_t(w, sigma), SPEC3, s=s)
    monkeypatch.undo()
    assert int(tmask.sum()) == s
    w_rtn = quantize_dequantize(*_t(w), compute_grid(*_t(w), SPEC3))
    omega = tgptq.obs_sensitivity(*_t(w, sigma), w_rtn).numpy()
    thr = np.sort(omega.ravel())[-s]
    near = np.abs(omega - thr) <= 1e-5 * thr
    np.testing.assert_array_equal(tmask.numpy()[~near], np.asarray(jmask)[~near])
    if np.array_equal(tmask.numpy(), np.asarray(jmask)):
        from repro_torch.quant import compute_grid_excluding_outliers

        grid = compute_grid_excluding_outliers(*_t(w), SPEC3, tmask)
        pre = torch.stack(seen, -1).numpy()
        _check(w, np.asarray(jw), tw.numpy(), pre, grid, keep=tmask.numpy())


def test_top_s_ties_go_to_the_lower_index():
    a = torch.tensor([[1.0, 3.0, 3.0], [2.0, 3.0, 0.5]])
    m = tspqr.top_s_lowest_index(a, 2)
    j = np.zeros(6, bool)
    j[np.asarray(jax.lax.top_k(jnp.asarray(a.numpy()).reshape(-1), 2)[1])] = True
    np.testing.assert_array_equal(m.numpy().ravel(), j)


# ---------------------------------------------------------------------------
# The reference's properties on the port
# ---------------------------------------------------------------------------


def test_awq_no_worse_than_rtn(prob):
    w, sigma = _t(*prob)
    e_rtn = _err(*prob[:1], quantize_dequantize(w, compute_grid(w, SPEC3)), prob[1])
    assert _err(prob[0], tawq.awq_quantize(w, sigma, SPEC3), prob[1]) <= e_rtn + 1e-6


def test_qe_outliers_beat_spqr(prob):
    w, sigma = _t(*prob)
    s = int(0.01 * w.numel())
    e_spqr = _err(prob[0], tspqr.spqr_quantize(w, sigma, SPEC3, s=s)[0], prob[1])
    e_qe = _err(prob[0], tout.outlier_quantease(w, sigma, SPEC3, s=s, iterations=12).w_eff, prob[1])
    assert e_qe < e_spqr


def test_awq_plus_quantease_improves():
    rng = np.random.default_rng(1)
    q, p = 64, 96
    x = rng.standard_normal((p, 384)).astype(np.float32) * (rng.random(p)[:, None] * 3 + 0.2)
    w = rng.standard_normal((q, p)).astype(np.float32)
    sigma = x @ x.T
    e_qe = _err(w, tqe.quantease_quantize(*_t(w, sigma), SPEC3, iterations=12)[0], sigma)
    e_combo = _err(w, tawq.awq_then_quantease(*_t(w, sigma), SPEC3, iterations=12), sigma)
    assert e_combo <= e_qe * 1.02


# ---------------------------------------------------------------------------
# The solver's per-layer methods on a reduced Phi-3 layer
# ---------------------------------------------------------------------------

METHODS = ("awq", "awq_qe", "spqr")


@pytest.fixture(scope="module")
def solver_runs():
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b"), n_periods=1), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b"), n_periods=1), dtype=torch.float32)
    jp, tp = jplan(jcfg, 1), tmodel.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(3))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    calib_fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=tcfg.vocab, seed=0), tcfg, 2, 64,
                                      split="calib")
    calib = [calib_fn(i) for i in range(2)]
    runs = {}
    for method in METHODS:
        kw = dict(method=method, iterations=3, emit="qt")
        jq, jrep = jsolver.ptq_quantize_model(
            jp, params, [{"tokens": jnp.asarray(b["tokens"])} for b in calib],
            jsolver.PTQConfig(spec=JSpec(bits=3), **kw))
        tq, trep = tsolver.ptq_quantize_model(
            tp, tparams, calib, PTQConfig(spec=GridSpec(bits=3), **kw), device="cpu")
        runs[method] = (jq["dec"][0]["b0"], jrep, tq["dec"][0]["b0"], trep)
    return runs, tp, tparams, calib


@pytest.mark.parametrize("method", METHODS)
def test_solver_reports_match(solver_runs, method):
    _, jrep, _, trep = solver_runs[0][method]
    assert list(trep) == list(jrep) and len(trep) == 7
    for k, v in jrep.items():
        assert trep[k] == pytest.approx(v, rel=1e-3), k


@pytest.mark.parametrize("method", METHODS)
def test_solver_codes_match_and_zero_points_integral(solver_runs, method):
    """The re-derived grid (Ŵ's own range, the reference's lossy emit) and
    the codes on it agree; every zero point is an integer in [0, 7]."""
    jblk, _, tblk, _ = solver_runs[0][method]
    for name, tqt in tblk.items():
        if not hasattr(tqt, "codes"):
            continue
        jqt = jblk[name]
        z = tqt.zero.numpy()
        assert np.all(z == np.round(z)) and z.min() >= 0 and z.max() <= 7, name
        np.testing.assert_allclose(tqt.scale.numpy(), np.asarray(jqt.scale), rtol=1e-5)
        jc = np.asarray(junpack(jqt.codes, 3, jqt.shape[-1]) if jqt.packed else jqt.codes)
        tc = tqt.unpacked_codes().numpy()
        assert (jc != tc).any(-1).mean() <= 0.02, name


def test_solver_artifact_serves(solver_runs):
    """Each method's artifact restacks for serving (zero points checked there)."""
    runs, tp, tparams, calib = solver_runs
    for method in METHODS:
        qp, _ = tsolver.ptq_quantize_model(
            tp, tparams, calib[:1], PTQConfig(method=method, spec=GridSpec(bits=4), iterations=2,
                                              emit="qt"), device="cpu")
        served = quantize_params_for_serving(tp, tparams, qp["dec"], device="cpu")
        assert served["dec"]["b0"]["wq"].packed


# ---------------------------------------------------------------------------
# LayerSpec: resolution and mixed precision
# ---------------------------------------------------------------------------


def test_for_layer_resolution_order():
    base = PTQConfig(
        method="quantease", spec=GridSpec(bits=4, group_size=16),
        layer_specs={"dec.p0.b0/wq": LayerSpec(bits=2), "wq": LayerSpec(bits=3, method="rtn")},
    )
    exact = base.for_layer("dec.p0.b0/wq")
    assert exact.spec.bits == 2 and exact.method == "quantease"
    assert exact.spec.group_size == 16  # inherited, not clobbered
    bare = base.for_layer("dec.p2.b0/wq")
    assert bare.spec.bits == 3 and bare.method == "rtn"
    none = base.for_layer("dec.p0.b0/wk")
    assert none.spec.bits == 4 and none.layer_specs is None


def test_for_layer_explicit_none_group_size():
    base = PTQConfig(spec=GridSpec(bits=4, group_size=16),
                     layer_specs={"wq": LayerSpec(group_size=None)})
    assert base.for_layer("dec.p0.b0/wq").spec.group_size is None


def test_group_key_splits_mixed_groups():
    a = PTQConfig(spec=GridSpec(bits=4), layer_specs={"wq": LayerSpec(bits=2)})
    assert a.for_layer("x/wq")._group_key() != a.for_layer("x/wk")._group_key()
    assert a.for_layer("x/wk")._group_key() == a.for_layer("x/wv")._group_key()


@pytest.fixture(scope="module")
def small_model():
    cfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b")), dtype=torch.float32)
    plan = tmodel.make_plan(cfg)
    params = tmodel.init_params(plan, 0, device="cpu")
    rng = np.random.default_rng(1)
    calib = [{"tokens": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}]
    return plan, params, calib


def test_mixed_precision_fake_quant_end_to_end(small_model):
    """Bare-name layer_specs: every wq at 2 bits, every wd at 8; the model
    still runs, and the 2-bit wq is worse than the 8-bit wd on average."""
    plan, params, calib = small_model
    cfg = PTQConfig(method="quantease", spec=GridSpec(bits=4), iterations=4,
                    layer_specs={"wq": LayerSpec(bits=2), "wd": LayerSpec(bits=8)})
    qp, rep = tsolver.ptq_quantize_model(plan, params, calib, cfg, device="cpu")
    wq_err = np.mean([v for k, v in rep.items() if k.endswith("/wq")])
    wd_err = np.mean([v for k, v in rep.items() if k.endswith("/wd")])
    assert wq_err > wd_err
    tokens = torch.as_tensor(calib[0]["tokens"]).long()
    assert bool(torch.isfinite(tmodel.train_loss(plan, qp, {"tokens": tokens})))


def test_layer_spec_matches_reference_grouping(small_model):
    """A per-layer method override splits the group: wq by RTN, the rest by
    QuantEase, and the layer's report equals a plain RTN run's."""
    plan, params, calib = small_model
    mixed = PTQConfig(method="quantease", spec=GridSpec(bits=4), iterations=2,
                      layer_specs={"dec.p0.b0/wq": LayerSpec(method="rtn")})
    _, rep = tsolver.ptq_quantize_model(plan, params, calib, mixed, device="cpu")
    _, rtn = tsolver.ptq_quantize_model(plan, params, calib, PTQConfig(method="rtn"), device="cpu")
    assert rep["dec.p0.b0/wq"] == rtn["dec.p0.b0/wq"]
    assert rep["dec.p0.b0/wk"] != rtn["dec.p0.b0/wk"]


def test_mixed_precision_qt_stack_refused_with_a_pointer(small_model):
    plan, params, calib = small_model
    cfg = PTQConfig(method="rtn", spec=GridSpec(bits=4), emit="qt",
                    layer_specs={"dec.p1.b0/wq": LayerSpec(bits=3)})
    qp, _ = tsolver.ptq_quantize_model(plan, params, calib, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        quantize_params_for_serving(plan, params, qp["dec"], device="cpu")
