"""Port parity for outlier-aware QuantEase (Algorithm 3).

The same numpy inputs, made from a seed, go through the JAX package and the
port on the CPU.  Tolerances, with their reasons:

* grids, top-s masks, codes, COO indices and fp16 values: exact (integer or
  selection math on identical fp32 inputs);
* ``power_lambda_max``: rel 1e-5 (fp32 matvecs summed in another order);
* the plain kernel-4 version against ``repro.kernels.ref`` and the Pallas
  kernel in interpret mode: atol 1e-5, as tests/test_outlier_fused.py holds
  the kernel to its oracle;
* ``outlier_quantease`` against the reference's XLA engine: atol 2e-4 on Ŵ
  and Ĥ, the reference suite's own tolerance for fp reassociation; the
  objective history at rtol 1e-4;
* the reduced Phi-3 slice: per-layer errors and perplexity at rel 1e-3;
* grids made inside the reference's jitted engine: rel 2.4e-7 (two ulp),
  since XLA compiles the division by the level count as a product with its
  reciprocal, while the port (and the reference outside ``jit``) divides.

On these inputs no top-s selection is near a tie (the test data is generic
Gaussian with a few 10× entries), so Ĥ's support agrees exactly.  Where a
support could flip on a near-tie (two |candidates| within fp32 rounding),
the entries would differ by a whole outlier value; the objective check
(rtol 1e-4) is the comparison that stays meaningful then.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import outlier as jout
from repro.core.quantease import relative_error as jrel_err
from repro.core import solver as jsolver
from repro.data import pipeline as jpipe
from repro.eval import scorer as jscorer
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.quant import GridSpec as JSpec
from repro.quant import QuantizedTensor as JQT
from repro.quant import compute_grid as jgrid
from repro.quant import compute_grid_excluding_outliers as jgrid_excl
from repro.quant import dequantize_tensor as jdequant
from repro.serve import qparams as jqparams
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.core import outlier as tout
from repro_torch.core import solver as tsolver
from repro_torch.core.calib import damp_sigma
from repro_torch.core.quantease import relative_error as trel_err
from repro_torch.data import pipeline as tpipe
from repro_torch.eval import scorer as tscorer
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.quant import Grid as TGrid
from repro_torch.quant import GridSpec as TSpec
from repro_torch.quant import QuantizedTensor as TQT
from repro_torch.quant import compute_grid_excluding_outliers as tgrid_excl
from repro_torch.quant import dequantize_tensor as tdequant
from repro_torch.serve import qparams as tqparams
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401


def _problem(seed, q, p, n, G=None):
    """W with a few 10× entries (outlier candidates) and Σ = XXᵀ."""
    r = np.random.default_rng(seed)
    lead = () if G is None else (G,)
    x = r.standard_normal((*lead, p, n)).astype(np.float32)
    w = r.standard_normal((*lead, q, p)).astype(np.float32)
    w[r.random(w.shape) < 0.003] *= 10.0
    return w, (x @ np.swapaxes(x, -1, -2)).astype(np.float32)


JIT_ULP = 2.4e-7  # two fp32 ulp: the reference's jitted grid divides by multiplying


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# Grid, selection and the power iteration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("group_size", [None, 32, 48])
def test_grid_excluding_outliers_matches_jax(symmetric, group_size):
    w, _ = _problem(0, 40, 100, 8)  # p = 100: group 48 leaves a ragged tail
    mask = np.array(jout.top_s_mask(jnp.asarray(w), 80))
    mask[:, -1] = True  # the ragged tail's edge column is an outlier in every row
    spec = dict(bits=3, symmetric=symmetric, group_size=group_size)
    jg = jgrid_excl(jnp.asarray(w), JSpec(**spec), jnp.asarray(mask))
    tg = tgrid_excl(torch.from_numpy(w), TSpec(**spec), torch.from_numpy(mask))
    np.testing.assert_array_equal(_np(tg.scale), np.asarray(jg.scale))
    np.testing.assert_array_equal(_np(tg.zero), np.asarray(jg.zero))
    # Shrinking the range over the non-outliers never widens it.
    assert (_np(tg.scale) <= np.asarray(jgrid(jnp.asarray(w), JSpec(**spec)).scale)).all()


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_power_lambda_max_matches_jax(tol):
    _, sig = _problem(1, 8, 96, 200, G=3)
    sig[1] *= 1e-3  # matrices of different scale stop at different steps
    t = tout.power_lambda_max(torch.from_numpy(sig), iters=40, tol=tol)
    for g in range(3):
        j = float(jout.power_lambda_max(jnp.asarray(sig[g]), iters=40, tol=tol))
        assert float(t[g]) == pytest.approx(j, rel=1e-5)
        assert float(tout.power_lambda_max(torch.from_numpy(sig[g]), iters=40, tol=tol)) == \
            pytest.approx(j, rel=1e-5)
    # The top eigenvalue itself, with the default 64 steps.
    lam = np.linalg.eigvalsh(sig[0].astype(np.float64))[-1]
    assert float(tout.power_lambda_max(torch.from_numpy(sig[0]))) == pytest.approx(lam, rel=1e-3)


def test_projections_match_jax():
    w, _ = _problem(2, 48, 64, 8)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    np.testing.assert_array_equal(_np(tout.top_s_mask(tw, 50)), np.asarray(jout.top_s_mask(jw, 50)))
    np.testing.assert_array_equal(_np(tout._project_s(tw, 50)), np.asarray(jout._project_s(jw, 50)))
    np.testing.assert_array_equal(_np(tout._project_columns(tw, 3)),
                                  np.asarray(jout._project_columns(jw, 3)))
    # Batched: each matrix keeps its own top s.
    w3 = np.stack([w, -2 * w[::-1]])
    m3 = _np(tout.top_s_mask(torch.from_numpy(w3), 50))
    for g in range(2):
        np.testing.assert_array_equal(m3[g], np.asarray(jout.top_s_mask(jnp.asarray(w3[g]), 50)))


# ---------------------------------------------------------------------------
# Kernel 4's plain version
# ---------------------------------------------------------------------------


def _iter_inputs(seed, q, p):
    """An outlier-iteration input in the reference's (q, p) layout."""
    r = np.random.default_rng(seed)
    w, sig = _problem(seed, q, p, 2 * p)
    sk = np.asarray(damp_sigma(torch.from_numpy(sig), 0.01))
    st = (sk / np.diag(sk)[None, :] - np.eye(p, dtype=np.float32)).astype(np.float32)
    g = jgrid(jnp.asarray(w), JSpec(bits=3))
    sc, zc = (np.asarray(a) for a in g.per_column(p))
    dprev = (0.01 * r.standard_normal((q, p))).astype(np.float32)
    dh = np.where(r.random((q, p)) < 0.02, r.standard_normal((q, p)), 0.0).astype(np.float32)
    return dict(base=w, st=st, w=w, sc=sc, zc=zc, dprev=dprev, dh=dh)


def _port_iter(a, bsz, cdt=torch.float32, via_ops=False):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x.T))
    sig_t = t(a["st"])
    fn = tops.quantease_outlier_iteration if via_ops else tref.quantease_outlier_iteration_ref
    outs = fn(t(a["base"]), sig_t, sig_t.to(cdt), t(a["w"]), t(a["sc"]), t(a["zc"]),
              t(a["dprev"]), t(a["dh"]), n_levels=8, quantize=True, bsz=bsz)
    return [o.T.numpy() for o in outs]


@pytest.mark.parametrize("q,p,bsz", [(32, 64, 32), (40, 96, 48), (24, 128, 128)])
def test_outlier_iteration_plain_matches_jax_ref_and_pallas(q, p, bsz):
    a = _iter_inputs(q + p, q, p)
    args = [jnp.asarray(a[k]) for k in ("base", "st", "w", "sc", "zc", "dprev", "dh")]
    kw = dict(n_levels=8, quantize=True, bsz=bsz)
    j_ref = jref.quantease_outlier_iteration_ref(*args, **kw)
    j_pallas = jops.quantease_outlier_iteration(*args, interpret=True, **kw)
    port = _port_iter(a, bsz, via_ops=True)  # CPU tensors: ops routes to the plain version
    for name, t, r, pl in zip(("w_new", "base_new", "delta_pure", "r"), port, j_ref, j_pallas):
        np.testing.assert_allclose(t, np.asarray(r), rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(t, np.asarray(pl), rtol=0, atol=1e-5, err_msg=name)


def test_outlier_iteration_plain_bf16_matches_pallas():
    """bf16 operands in the correction and the suffix product (fp32
    accumulation): the port rounds the same operands as the Pallas kernel.
    atol 1e-3: a δŴ an fp32 ulp apart in the two versions can round to
    neighbouring bf16 values, which moves a sum by up to 2⁻⁷·|δŴ|·|Σ̃|
    (|δŴ| ≲ 1, |Σ̃| ≲ 0.2 here)."""
    a = _iter_inputs(5, 32, 64)
    args = [jnp.asarray(a[k]) for k in ("base", "st", "w", "sc", "zc", "dprev", "dh")]
    j = jops.quantease_outlier_iteration(*args, n_levels=8, quantize=True, bsz=32,
                                         matmul_dtype="bfloat16", interpret=True)
    port = _port_iter(a, 32, cdt=torch.bfloat16)
    for name, t, pl in zip(("w_new", "base_new", "delta_pure", "r"), port, j):
        np.testing.assert_allclose(t, np.asarray(pl), rtol=0, atol=1e-3, err_msg=name)


def test_outlier_iteration_batched_dispatch():
    """ops on CPU tensors (G, p_pad, q) equals the per-matrix iterations."""
    ins = [_iter_inputs(s, 24, 64) for s in (11, 12)]
    t = lambda k: torch.stack([torch.from_numpy(np.ascontiguousarray(a[k].T)) for a in ins])
    sig_t = t("st")
    outs = tops.quantease_outlier_iteration(
        t("base"), sig_t, sig_t, t("w"), t("sc"), t("zc"), t("dprev"), t("dh"),
        n_levels=8, quantize=True, bsz=32)
    for g, a in enumerate(ins):
        for o, single in zip(outs, _port_iter(a, 32)):
            np.testing.assert_allclose(o[g].T.numpy(), single, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _solve_both(w, sig, s, **kw):
    j = jout.outlier_quantease(jnp.asarray(w), jnp.asarray(sig), JSpec(bits=3), s=s,
                               use_kernel="xla", **kw)
    t = tout.outlier_quantease(torch.from_numpy(w), torch.from_numpy(sig), TSpec(bits=3), s=s, **kw)
    return j, t


@pytest.mark.parametrize("structured", [False, True])
@pytest.mark.parametrize("G,q,p,bsz", [(None, 96, 128, 128), (2, 48, 100, 128), (3, 40, 100, 32)])
def test_outlier_quantease_matches_jax(structured, G, q, p, bsz):
    """Unstructured and column outliers; one matrix, a batch whose p = 100
    pads to a block of 104, and one whose p pads to 4 blocks of 32."""
    w, sig = _problem(q + p, q, p, 3 * p, G=G)
    s = int((0.03 if structured else 0.01) * q * p)
    j, t = _solve_both(w, sig, s, iterations=6, structured=structured, cd_block_size=bsz)
    np.testing.assert_allclose(_np(t.w_hat), np.asarray(j.w_hat), rtol=0, atol=2e-4)
    np.testing.assert_allclose(_np(t.h), np.asarray(j.h), rtol=0, atol=2e-4)
    np.testing.assert_allclose(_np(t.grid.scale), np.asarray(j.grid.scale), rtol=JIT_ULP, atol=0)
    np.testing.assert_array_equal(_np(t.grid.zero), np.asarray(j.grid.zero))
    nnz = (_np(t.h) != 0).reshape(-1 if G is None else G, q * p).sum(-1)
    if structured:
        cols = (np.abs(_np(t.h)).sum(-2) != 0).reshape(-1, p).sum(-1)
        assert (cols <= max(s // q, 1)).all()
    else:
        assert (nnz <= s).all()
    assert t.objective is None


def test_objective_history_matches_jax():
    w, sig = _problem(4, 96, 128, 512)
    s = int(0.01 * w.size)
    j, t = _solve_both(w, sig, s, iterations=5, track_objective=True)
    assert t.objective.shape == (5,)
    np.testing.assert_allclose(_np(t.objective), np.asarray(j.objective), rtol=1e-4)
    # Block CD with an IHT step descends (Lemma 3).
    assert float(t.objective[-1]) < float(t.objective[0])


def test_bf16_operands_match_jax_quality():
    """bf16 Σ̃ operands keep the solution at the fp32 level in both packages
    (the reference suite's bf16 contract: within 5 % of the fp32 error)."""
    w, sig = _problem(6, 96, 128, 512)
    s = int(0.01 * w.size)
    errs = {}
    for dt in ("float32", "bfloat16"):
        j, t = _solve_both(w, sig, s, iterations=6, matmul_dtype=dt)
        errs[dt] = float(trel_err(torch.from_numpy(w), t.w_eff, torch.from_numpy(sig)))
        assert errs[dt] == pytest.approx(float(jrel_err(jnp.asarray(w), j.w_eff, jnp.asarray(sig))),
                                         rel=1e-3)
    assert errs["bfloat16"] <= errs["float32"] * 1.05 + 1e-6


def test_engine_options_refused():
    w, sig = _problem(7, 16, 32, 64)
    args = (torch.from_numpy(w), torch.from_numpy(sig), TSpec(bits=3))
    with pytest.raises(ValueError, match="engine"):
        tout.outlier_quantease(*args, s=5, engine="pre-fused")
    with pytest.raises(ValueError):
        tout.outlier_quantease(*args, s=0)
    with pytest.raises(ValueError):
        tout.outlier_quantease(*args, s=5, matmul_dtype="float16")
    with pytest.raises(ValueError):
        tout.outlier_quantease(*args, s=5, use_kernel="cuda")  # CPU tensors


# ---------------------------------------------------------------------------
# Artifact: emit, dequantize, apply_linear, bits/weight
# ---------------------------------------------------------------------------


def _jqt_to_port(jqt):
    return interop.qtensor_from_jax(jax.tree.map(np.asarray, jqt), device="cpu")


@pytest.mark.parametrize("structured", [False, True])
def test_emit_leaf_matches_jax(structured):
    """``_emit_leaf`` on the same (Ŵ, Ĥ): fake weights and the qt artifact
    (codes, COO indices and fp16 values) are equal in both packages."""
    w, sig = _problem(8, 48, 64, 200)
    s = int(0.03 * w.size)
    j, t = _solve_both(w, sig, s, iterations=3, structured=structured)
    like = np.zeros((64, 48), np.float32)
    method = "qe_outlier_struct" if structured else "qe_outlier"
    for emit in ("fake", "qt"):
        jc = jsolver.PTQConfig(method=method, spec=JSpec(bits=3), emit=emit, outlier_frac=0.03)
        tc = tsolver.PTQConfig(method=method, spec=TSpec(bits=3), emit=emit, outlier_frac=0.03)
        jl = jsolver._emit_leaf(j.w_hat, j.h, jnp.asarray(like), jc, j.grid)
        grid = TGrid(TSpec(bits=3), torch.from_numpy(np.asarray(j.grid.scale)),
                     torch.from_numpy(np.asarray(j.grid.zero)))
        tl = tsolver._emit_leaf(torch.from_numpy(np.asarray(j.w_hat)),
                                torch.from_numpy(np.asarray(j.h)), torch.from_numpy(like), tc, grid)
        if emit == "fake":
            np.testing.assert_array_equal(_np(tl), np.asarray(jl))
            continue
        for f in ("codes", "scale", "zero", "outlier_idx", "outlier_values"):
            np.testing.assert_array_equal(_np(getattr(tl, f)), np.asarray(getattr(jl, f)), err_msg=f)
        assert tl.bits_per_weight() == pytest.approx(jl.bits_per_weight(), rel=1e-12)
        np.testing.assert_array_equal(_np(tdequant(tl)), np.asarray(jdequant(jl)))


def test_column_planes_dequantize_and_apply_like_jax():
    """Structured column planes (set semantics) and COO (add semantics, with
    a repeated index) in dequantize_tensor and apply_linear."""
    r = np.random.default_rng(9)
    q, p, m = 24, 40, 6
    codes = r.integers(0, 8, (q, p)).astype(np.uint8)
    scale = (r.random((q, 1)) * 0.1 + 0.01).astype(np.float32)
    zero = r.integers(0, 8, (q, 1)).astype(np.float32)
    col_idx = np.array([3, 17, 31], np.int32)
    col_vals = r.standard_normal((q, 3)).astype(np.float32)
    idx = np.array([5, 5, 100, q * p - 1], np.int32)
    vals = r.standard_normal(4).astype(np.float16)
    jqt = JQT(codes=jnp.asarray(codes), scale=jnp.asarray(scale), zero=jnp.asarray(zero), bits=3,
              outlier_values=jnp.asarray(vals), outlier_idx=jnp.asarray(idx),
              outlier_col_idx=jnp.asarray(col_idx), outlier_col_vals=jnp.asarray(col_vals))
    tqt = _jqt_to_port(jqt)
    np.testing.assert_allclose(_np(tdequant(tqt)), np.asarray(jdequant(jqt)), rtol=0, atol=1e-7)
    assert tqt.bits_per_weight() == pytest.approx(jqt.bits_per_weight(), rel=1e-12)
    x = r.standard_normal((2, m, p)).astype(np.float32)
    jy = jcommon.apply_linear(jqt, jnp.asarray(x))
    ty = tcommon.apply_linear(tqt, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The slice: reduced Phi-3 through PTQ → restack → perplexity
# ---------------------------------------------------------------------------

SLICE_METHODS = ("quantease", "qe_outlier", "qe_outlier_struct")


class _SliceRuns(dict):
    """Each method's slice run in both packages, computed on first use (once
    per module), so the first test of a method pays for its runs alone."""

    def __init__(self):
        super().__init__()
        jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b")), dtype=jnp.float32)
        tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b")), dtype=torch.float32)
        jp, tp = jplan(jcfg, 1), tmodel.make_plan(tcfg)
        params = jinit(jp, jax.random.PRNGKey(2))
        tparams = interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
        data = tpipe.DataConfig(vocab=tcfg.vocab, seed=0)
        calib_fn, _ = tpipe.make_batch_fn(data, tcfg, 2, 64, split="calib")
        jeval, _ = jpipe.make_batch_fn(jpipe.DataConfig(vocab=jcfg.vocab, seed=0), jcfg, 2, 64, split="eval")
        teval, _ = tpipe.make_batch_fn(data, tcfg, 2, 64, split="eval")
        self._setup = (jp, tp, params, tparams, [calib_fn(i) for i in range(2)], jeval, teval)
        self["plans"] = (jp, tp, teval)

    def __missing__(self, method):
        jp, tp, params, tparams, calib, jeval, teval = self._setup
        kw = dict(method=method, iterations=5, emit="qt", outlier_frac=0.02)
        jq, jrep = jsolver.ptq_quantize_model(
            jp, params, [{"tokens": jnp.asarray(b["tokens"])} for b in calib],
            jsolver.PTQConfig(spec=JSpec(bits=3), **kw))
        tq, trep = tsolver.ptq_quantize_model(tp, tparams, calib,
                                              tsolver.PTQConfig(spec=TSpec(bits=3), **kw), device="cpu")
        jserve = jqparams.quantize_params_for_serving(jp, params, jq["dec"])
        tserve = tqparams.quantize_params_for_serving(tp, tparams, tq["dec"], device="cpu")
        self[method] = dict(
            jq=jq, tq=tq, jrep=jrep, trep=trep, jserve=jserve, tserve=tserve,
            jppl=jscorer.perplexity_on_stream(jp, jserve, jeval, n_batches=2),
            tppl=tscorer.perplexity_on_stream(tp, tserve, teval, n_batches=2, device="cpu"),
        )
        return self[method]


@pytest.fixture(scope="module")
def outlier_runs():
    return _SliceRuns()


@pytest.mark.parametrize("method", SLICE_METHODS)
def test_slice_layer_errors_match(outlier_runs, method):
    r = outlier_runs[method]
    assert list(r["trep"]) == list(r["jrep"])
    for k, v in r["jrep"].items():
        assert r["trep"][k] == pytest.approx(v, rel=1e-3), k


@pytest.mark.parametrize("method", ["qe_outlier", "qe_outlier_struct"])
def test_slice_artifact_matches_jax(outlier_runs, method):
    """Codes, COO indices and fp16 values of every quantized linear are equal;
    scales and the restacked serving artifact's dequantized weights agree to
    the jitted reference grid's ulp."""
    r = outlier_runs[method]
    n_qt = 0
    for jper, tper in zip(r["jq"]["dec"], r["tq"]["dec"]):
        for name, jqt in jper["b0"].items():
            if not hasattr(jqt, "codes"):
                continue
            tqt = tper["b0"][name]
            n_qt += 1
            assert (tqt.bits, tqt.packed, tqt.shape) == (jqt.bits, jqt.packed, tuple(jqt.shape))
            for f in ("codes", "zero", "outlier_idx", "outlier_values"):
                np.testing.assert_array_equal(_np(getattr(tqt, f)), np.asarray(getattr(jqt, f)),
                                              err_msg=f"{name}.{f}")
            np.testing.assert_allclose(_np(tqt.scale), np.asarray(jqt.scale), rtol=JIT_ULP, atol=0)
    assert n_qt == 14
    wq_j, wq_t = r["jserve"]["dec"]["b0"]["wq"], r["tserve"]["dec"]["b0"]["wq"]
    assert tuple(wq_t.outlier_idx.shape) == tuple(wq_j.outlier_idx.shape)
    for i in range(2):
        jd = np.asarray(jdequant(jax.tree.map(lambda a: a[i], wq_j)))
        np.testing.assert_allclose(_np(tdequant(wq_t.map_arrays(lambda a: a[i]))), jd,
                                   rtol=JIT_ULP, atol=JIT_ULP * np.abs(jd).max())


@pytest.mark.parametrize("method", SLICE_METHODS)
def test_slice_perplexity_matches(outlier_runs, method):
    r = outlier_runs[method]
    assert r["tppl"]["n_tokens"] == r["jppl"]["n_tokens"]
    assert r["tppl"]["ppl"] == pytest.approx(r["jppl"]["ppl"], rel=1e-3)


def test_slice_outliers_beat_plain_quantease(outlier_runs):
    mean = lambda rep: float(np.mean(list(rep.values())))
    assert mean(outlier_runs["qe_outlier"]["trep"]) < mean(outlier_runs["quantease"]["trep"])


def test_jax_artifact_carried_across_gives_the_same_forward(outlier_runs):
    """The JAX-emitted, restacked qe_outlier artifact, carried into the port
    with interop, scores like the JAX model on it (same weights, so only fp
    summation order differs: rel 1e-5)."""
    r = outlier_runs["qe_outlier"]
    jp, tp, teval = outlier_runs["plans"]
    carried = interop.params_from_jax(jax.tree.map(np.asarray, r["jserve"]), device="cpu")
    wq = carried["dec"]["b0"]["wq"]
    assert wq.outlier_values.dtype == torch.float16 and wq.outlier_idx.dtype == torch.int32
    ppl = tscorer.perplexity_on_stream(tp, carried, teval, n_batches=2, device="cpu")
    assert ppl["ppl"] == pytest.approx(r["jppl"]["ppl"], rel=1e-5)
