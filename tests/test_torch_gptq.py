"""The port's GPTQ baseline against the reference's, on the same inputs.

``gptq_quantize`` in five cases (2-D, batched G = 3, ``act_order``,
``keep_mask``, an explicit grouped grid): codes equal except in rows whose
first differing column starts at a verified rounding tie (the port's
pre-rounding value w/s lies within 1e-5 relative of a midpoint k + ½:
``torch.linalg.inv`` and XLA's inverse differ at ~1e-6 relative, so such a
value may round either way and the rest of its row follows); values within
1e-5 × max |W| elsewhere.  ``obs_sensitivity`` at rtol 1e-5.  The
reference's properties (a GPTQ warm start only improves QuantEase; kept
entries stay unrounded and lower the error) on the port.  Whole-model PTQ
with ``method="gptq"`` and with ``init_from_gptq=True`` on one reduced fp32
Phi-3 layer: emitted codes equal outside rows that start at a verified tie
(there within max(1e-5, p·κ·ε) of a midpoint, the fp32 error bound of
inverting the damped p × p Σ of condition number κ: see the section's
note), per-layer errors rtol 1e-4 on every layer
whose codes all agree, zero points integers in [0, 2^bits − 1].
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import gptq as jgptq
from repro.core import solver as jsolver
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.quant import GridSpec as JSpec
from repro.quant import compute_grid as jcompute_grid
from repro.quant import quantize_dequantize as jqd
from repro.quant import unpack_codes as junpack
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.core import gptq as tgptq
from repro_torch.core import quantease as tqe
from repro_torch.core import solver as tsolver
from repro_torch.data import pipeline as tpipe
from repro_torch.models import model as tmodel
from repro_torch.models.common import capture_gram_stats
from repro_torch.quant import Grid, GridSpec, compute_grid, quantize_codes, quantize_dequantize
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401

TIE_RTOL = 1e-5
VAL_ATOL = 1e-5  # × max |W|
SPEC3 = GridSpec(bits=3)


def _problem(seed, q=96, p=128, n=512):
    r = np.random.default_rng(seed)
    x = r.standard_normal((p, n)).astype(np.float32)
    w = r.standard_normal((q, p)).astype(np.float32)
    w[r.random((q, p)) < 0.003] *= 10.0
    return w, x @ x.T


def _err(w, w_hat, sigma):
    w, w_hat, sigma = (torch.as_tensor(np.asarray(a)) for a in (w, w_hat, sigma))
    return float(tqe.relative_error(w, w_hat, sigma))


def _run_port(w, sigma, spec, **kw):
    """The port's GPTQ, recording each column's pre-rounding value w/s in
    processing order (``_quant_dequant_cols`` sees every column once)."""
    seen = []
    orig = tgptq._quant_dequant_cols

    def record(wc, scale, zero, n_levels):
        seen.append((wc / scale).clone())
        return orig(wc, scale, zero, n_levels)

    tgptq._quant_dequant_cols = record
    try:
        out = tgptq.gptq_quantize(torch.from_numpy(w), torch.from_numpy(sigma), spec, **kw)
    finally:
        tgptq._quant_dequant_cols = orig
    return out.numpy(), torch.stack(seen, -1).numpy()  # (…, q, p_pad) pre-rounding values


def _check(w, j_out, t_out, pre, grid, *, perm=None, keep=None):
    """Codes equal outside verified tie rows; values within VAL_ATOL × max|W|."""
    w3, j3, t3 = (a.reshape(-1, *a.shape[-2:]) for a in (w, j_out, t_out))
    pre = pre.reshape(-1, *pre.shape[-2:])
    codes = lambda a: quantize_codes(torch.tensor(a), grid).numpy().reshape(w3.shape)
    cj, ct = codes(j3), codes(t3)
    differ = cj != ct
    if keep is not None:
        differ &= ~keep.reshape(differ.shape)
    ok_rows = np.ones(differ.shape[:2], bool)
    for g, r in zip(*np.nonzero(differ.any(-1))):
        order = np.arange(w3.shape[-1]) if perm is None else perm.reshape(-1, w3.shape[-1])[g]
        j = int(np.argmax(differ[g, r][order]))  # first differing column, processing order
        v = float(pre[g, r, j])
        tie = abs(v - (np.floor(v) + 0.5)) <= TIE_RTOL * max(1.0, abs(v))
        assert tie, f"row {(g, r)} first differs at column {order[j]}, w/s = {v}: no tie"
        ok_rows[g, r] = False
    assert ok_rows.mean() >= 0.95, f"{(~ok_rows).sum()} tie rows"
    tol = VAL_ATOL * np.abs(w).max()
    np.testing.assert_allclose(t3[ok_rows], j3[ok_rows], rtol=0, atol=tol)


@pytest.fixture(scope="module")
def prob():
    return _problem(42)


def _jgrid(w, spec):
    """The reference's grid of ``w``, as the port's Grid."""
    g = jax.vmap(lambda x: jcompute_grid(x, spec))(jnp.asarray(w).reshape(-1, *w.shape[-2:]))
    scale, zero = (torch.from_numpy(np.array(a).reshape(*w.shape[:-1], -1)) for a in (g.scale, g.zero))
    return Grid(GridSpec(bits=spec.bits, group_size=spec.group_size), scale, zero)


def test_gptq_2d(prob):
    w, sigma = prob
    j = np.asarray(jgptq.gptq_quantize(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3)))
    t, pre = _run_port(w, sigma, SPEC3)
    _check(w, j, t, pre, _jgrid(w, JSpec(bits=3)))


def test_gptq_batched():
    ws, sigs = zip(*(_problem(s, q=40, p=200) for s in (1, 2, 3)))  # p pads to 256
    w, sigma = np.stack(ws), np.stack(sigs)
    j = np.asarray(jgptq.gptq_quantize(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=4)))
    t, pre = _run_port(w, sigma, GridSpec(bits=4))
    _check(w, j, t, pre, _jgrid(w, JSpec(bits=4)))


def test_gptq_act_order(prob):
    w, sigma = prob
    j = np.asarray(jgptq.gptq_quantize(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3),
                                       act_order=True, block_size=32))
    t, pre = _run_port(w, sigma, SPEC3, act_order=True, block_size=32)
    sig_d = tgptq.damp_sigma(torch.from_numpy(sigma), 0.01)
    perm = torch.argsort(-torch.diagonal(sig_d), stable=True).numpy()
    _check(w, j, t, pre, _jgrid(w, JSpec(bits=3)), perm=perm)


def test_gptq_keep_mask(prob):
    w, sigma = prob
    mask = np.zeros(w.shape, bool)
    mask[::7, ::11] = True
    j = np.asarray(jgptq.gptq_quantize(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3),
                                       keep_mask=jnp.asarray(mask)))
    t, pre = _run_port(w, sigma, SPEC3, keep_mask=torch.from_numpy(mask))
    _check(w, j, t, pre, _jgrid(w, JSpec(bits=3)), keep=mask)


def test_gptq_explicit_grid(prob):
    w, sigma = prob
    jspec = JSpec(bits=4, group_size=32)
    jg = jcompute_grid(jnp.asarray(0.9 * w), jspec)  # a grid narrower than w's range
    j = np.asarray(jgptq.gptq_quantize(jnp.asarray(w), jnp.asarray(sigma), jspec, grid=jg))
    grid = _jgrid(0.9 * w, jspec)
    t, pre = _run_port(w, sigma, grid.spec, grid=grid)
    _check(w, j, t, pre, grid)


def test_obs_sensitivity(prob):
    w, sigma = prob
    w_rtn = np.asarray(jqd(jnp.asarray(w), jcompute_grid(jnp.asarray(w), JSpec(bits=3))))
    j = np.asarray(jgptq.obs_sensitivity(jnp.asarray(w), jnp.asarray(sigma), jnp.asarray(w_rtn)))
    t = tgptq.obs_sensitivity(torch.from_numpy(w), torch.from_numpy(sigma), torch.tensor(w_rtn))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5)


def test_gptq_init_improves(prob):
    """The reference's property: QuantEase from GPTQ only improves on it."""
    w, sigma = (torch.from_numpy(a) for a in prob)
    w_g = tgptq.gptq_quantize(w, sigma, SPEC3)
    w_qg, _ = tqe.quantease_quantize(w, sigma, SPEC3, iterations=10, w_init=w_g,
                                     unquantized_heuristic=False)
    assert _err(w, w_qg, sigma) <= _err(w, w_g, sigma) + 1e-7


def test_gptq_keep_mask_property(prob):
    """The reference's property: kept entries stay unrounded (they absorb OBS
    corrections) and pinning them lowers the error."""
    w, sigma = (torch.from_numpy(a) for a in prob)
    mask = torch.zeros(w.shape, dtype=torch.bool)
    mask[::7, ::11] = True
    w_hat = tgptq.gptq_quantize(w, sigma, SPEC3, keep_mask=mask)
    snapped = quantize_dequantize(w_hat, compute_grid(w, SPEC3))
    off_grid = (w_hat[mask] - snapped[mask]).abs() > 1e-6
    assert off_grid.float().mean() > 0.5
    assert _err(w, w_hat, sigma) < _err(w, tgptq.gptq_quantize(w, sigma, SPEC3), sigma)


def test_gptq_refuses_keep_mask_when_batched(prob):
    w, sigma = (torch.from_numpy(a) for a in prob)
    with pytest.raises(ValueError, match="keep_mask"):
        tgptq.gptq_quantize(w[None], sigma[None], SPEC3, keep_mask=torch.zeros(1, *w.shape, dtype=bool))


# ---------------------------------------------------------------------------
# Whole-model PTQ: method="gptq" and the QuantEase warm start
# ---------------------------------------------------------------------------
#
# One decoder layer: each package captures its own Σ (they agree to ~3e-7
# relative), and wo's Σ on this GQA config is near-singular (condition
# ~4e5; damped, ~1.5e3), so the two GPTQs' fp32 inverses move wo's
# pre-rounding values by ~3e-4 of a grid step (p·κ·ε bounds it).  A value
# that close to a midpoint may round either way; a second layer would then
# see other inputs, so the comparison stops after one.


@pytest.fixture(scope="module")
def ptq_runs():
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b"), n_periods=1), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b"), n_periods=1), dtype=torch.float32)
    jp, tp = jplan(jcfg, 1), tmodel.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(3))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    calib_fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=tcfg.vocab, seed=0), tcfg, 2, 64,
                                      split="calib")
    calib = [calib_fn(i) for i in range(2)]
    runs = {}
    for label, kw in (("gptq", dict(method="gptq")),
                      ("qe_init", dict(method="quantease", iterations=3, init_from_gptq=True))):
        jq, jrep = jsolver.ptq_quantize_model(
            jp, params, [{"tokens": jnp.asarray(b["tokens"])} for b in calib],
            jsolver.PTQConfig(spec=JSpec(bits=3), emit="qt", **kw))
        tq, trep = tsolver.ptq_quantize_model(
            tp, tparams, calib, tsolver.PTQConfig(spec=GridSpec(bits=3), emit="qt", **kw),
            device="cpu")
        runs[label] = (jq["dec"][0]["b0"], jrep, tq["dec"][0]["b0"], trep)
    # The Σ the port's solver captured for each linear of the layer.
    stats = {}
    blk = tmodel.period_slice(tparams["dec"], 0)["b0"]
    with capture_gram_stats(stats):
        for b in calib:
            x = tmodel._embed_tokens(tp, tparams, torch.as_tensor(b["tokens"]).long())
            tmodel._block_apply(tcfg, tp.heads, tcfg.pattern[0], blk, x, mode="train",
                                pos_ids=torch.arange(64))
    w2d = {k: blk[k].reshape(stats[k].p, -1).T.contiguous() for k in stats}
    return runs, {k: st.sigma for k, st in stats.items()}, w2d


def _codes(j_qt, t_qt):
    jc = np.asarray(junpack(j_qt.codes, 3, j_qt.shape[-1]) if j_qt.packed else j_qt.codes)
    return jc, t_qt.unpacked_codes().numpy()


def _tie_rows(w, sigma, jc, tc, grid):
    """Rows whose codes differ; each must first differ (column order) at a
    verified tie: the port's pre-rounding value within max(1e-5, p·κ·ε) of
    a midpoint, p·κ·ε the fp32 error bound of inverting the damped p × p Σ
    of condition number κ."""
    sig_d = tgptq.damp_sigma(sigma, 0.01).double()
    kappa = float(torch.linalg.cond(sig_d))
    tol = max(TIE_RTOL, sig_d.shape[-1] * kappa * float(torch.finfo(torch.float32).eps))
    pre = _run_port(w.numpy(), sigma.numpy(), grid.spec, grid=grid)[1][0]  # (q, p_pad)
    rows = np.nonzero((jc != tc).any(-1))[0]
    for r in rows:
        j = int(np.argmax(jc[r] != tc[r]))
        v = float(pre[r, j])
        assert abs(v - (np.floor(v) + 0.5)) <= tol * max(1.0, abs(v)), (r, j, v, tol)
    return set(rows.tolist())


@pytest.mark.parametrize("label", ["gptq", "qe_init"])
def test_ptq_codes_match_and_zero_points_integral(ptq_runs, label):
    """Codes equal outside verified tie rows (QuantEase's warm start: only in
    rows where GPTQ's codes tie); scales equal; zero points integral in range."""
    runs, sigmas, w2d = ptq_runs
    jblk, _, tblk, _ = runs[label]
    n = 0
    for name in sorted(sigmas):
        jqt, tqt = jblk[name], tblk[name]
        np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
        z = tqt.zero.numpy()
        assert np.all(z == np.round(z)) and z.min() >= 0 and z.max() <= 7
        grid = Grid(GridSpec(bits=3), tqt.scale, tqt.zero)
        gj, gt = _codes(runs["gptq"][0][name], runs["gptq"][2][name])
        ties = _tie_rows(w2d[name], sigmas[name], gj, gt, grid)
        jc, tc = _codes(jqt, tqt)
        differ = set(np.nonzero((jc != tc).any(-1))[0].tolist())
        assert differ <= ties and len(differ) <= 0.02 * jc.shape[0], (name, differ, ties)
        n += 1
    assert n == 7


@pytest.mark.parametrize("label", ["gptq", "qe_init"])
def test_ptq_layer_errors_match(ptq_runs, label):
    """rtol 1e-4 on every layer whose codes all agree."""
    runs, _, _ = ptq_runs
    jblk, jrep, tblk, trep = runs[label]
    assert list(trep) == list(jrep)
    n = 0
    for k, v in jrep.items():
        jc, tc = _codes(jblk[k.rsplit("/", 1)[1]], tblk[k.rsplit("/", 1)[1]])
        if np.array_equal(jc, tc):
            assert trep[k] == pytest.approx(v, rel=1e-4), k
            n += 1
    assert n >= 5


def test_gptq_warm_start_no_worse_than_gptq(ptq_runs):
    """QuantEase started from GPTQ ends at or below GPTQ's mean layer error."""
    runs = ptq_runs[0]
    mean = lambda rep: float(np.mean(list(rep.values())))
    assert mean(runs["qe_init"][3]) <= mean(runs["gptq"][3])
