"""Port parity for core/quantease.py: the fused engine and Algorithm 1.

Inputs come from numpy (``layer_problem``'s construction) and go through
``repro.core.quantease`` (XLA fused engine) and ``repro_torch`` (plain
path).  Iterates agree within atol 2e-4 (fp reassociation, absorbed by the
grid snap), as tests/test_fused_engine.py holds the reference's engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantease as jqe
from repro.quant import GridSpec as JSpec
from repro.quant import compute_grid as jgrid
from repro_torch.core import quantease as tqe
from repro_torch.core.calib import CalibStats, damp_sigma, gram
from repro_torch.quant import GridSpec as TSpec
from repro_torch.quant import compute_grid as tgrid
from tests._torch_cpu import one_torch_thread  # noqa: F401

ATOL = 2e-4


def _problem(seed, q=96, p=128, n=512):
    r = np.random.default_rng(seed)
    x = r.standard_normal((p, n)).astype(np.float32)
    w = r.standard_normal((q, p)).astype(np.float32)
    w[r.random((q, p)) < 0.003] *= 10.0
    return w, (x @ x.T).astype(np.float32), x


def _jax(w, sigma, bits, **kw):
    out, hist = jqe.quantease_quantize(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=bits),
                                       use_kernel="xla", **kw)
    return np.asarray(out), None if hist is None else np.asarray(hist)


def _torch(w, sigma, bits, **kw):
    out, hist = tqe.quantease_quantize(torch.from_numpy(w), torch.from_numpy(sigma),
                                       TSpec(bits=bits), **kw)
    return out.numpy(), None if hist is None else hist.numpy()


@pytest.mark.parametrize("heuristic", [True, False])
@pytest.mark.parametrize("bits,bsz", [(3, 256), (4, 48)])
def test_single_layer_matches_jax(heuristic, bits, bsz):
    w, sigma, _ = _problem(1)
    kw = dict(iterations=4, block_size=bsz, unquantized_heuristic=heuristic)
    np.testing.assert_allclose(_torch(w, sigma, bits, **kw)[0], _jax(w, sigma, bits, **kw)[0],
                               rtol=0, atol=ATOL)


def test_batched_with_grid_and_w_init_matches_jax():
    probs = [_problem(10 + g, q=48, p=64, n=256) for g in range(3)]
    w3 = np.stack([p[0] for p in probs])
    s3 = np.stack([p[1] for p in probs])
    init = (0.9 * w3).astype(np.float32)
    jg = jax.vmap(lambda wi: jgrid(wi, JSpec(bits=3)))(jnp.asarray(w3))
    tg = tgrid(torch.from_numpy(w3), TSpec(bits=3))
    np.testing.assert_array_equal(tg.scale.numpy(), np.asarray(jg.scale))
    kw = dict(iterations=3, block_size=32)
    jo, _ = jqe.quantease_quantize(jnp.asarray(w3), jnp.asarray(s3), JSpec(bits=3),
                                   w_init=jnp.asarray(init), grid=jg, use_kernel="xla", **kw)
    to, _ = tqe.quantease_quantize(torch.from_numpy(w3), torch.from_numpy(s3), TSpec(bits=3),
                                   w_init=torch.from_numpy(init), grid=tg, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)


def test_bf16_corrections_match_jax():
    w, sigma, _ = _problem(2, q=64, p=96)
    kw = dict(iterations=3, block_size=32, matmul_dtype="bfloat16")
    t_out = _torch(w, sigma, 3, **kw)[0]
    j_out = _jax(w, sigma, 3, **kw)[0]
    # bf16 rounding of the correction operands can flip a rounding tie;
    # a flip cascades along its row, so hold the rows, not every entry.
    rows_ok = np.all(np.abs(t_out - j_out) <= ATOL, axis=1).mean()
    assert rows_ok >= 0.95


def test_reference_matches_jax_and_fused():
    w, sigma, _ = _problem(3, q=32, p=48, n=128)
    jr = np.asarray(jqe.quantease_reference(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3)))
    tr = tqe.quantease_reference(torch.from_numpy(w), torch.from_numpy(sigma), TSpec(bits=3)).numpy()
    np.testing.assert_allclose(tr, jr, rtol=0, atol=ATOL)
    tf = _torch(w, sigma, 3, iterations=3, block_size=16, unquantized_heuristic=False)[0]
    np.testing.assert_allclose(tf, tr, rtol=0, atol=ATOL)


def test_objective_history_and_lemma2():
    """History matches the reference, and from the first quantized iterate
    on the objective never rises on quantized iterations (Lemma 2)."""
    w, sigma, _ = _problem(4)
    kw = dict(iterations=6, unquantized_heuristic=False, track_objective=True, block_size=64)
    t_w, t_hist = _torch(w, sigma, 3, **kw)
    _, j_hist = _jax(w, sigma, 3, **kw)
    np.testing.assert_allclose(t_hist, j_hist, rtol=1e-5)
    assert np.all(np.diff(t_hist) <= 1e-6 * t_hist[:-1])
    f = tqe.layer_objective(torch.from_numpy(w), torch.from_numpy(t_w),
                            damp_sigma(torch.from_numpy(sigma))).item()
    assert f == pytest.approx(float(t_hist[-1]), rel=1e-5)


def test_relative_error_and_calib_match_jax():
    from repro.core import calib as jcalib

    w, sigma, x = _problem(5, q=16, p=32, n=64)
    w_hat = np.round(w * 4) / 4
    je = float(jqe.relative_error(jnp.asarray(w), jnp.asarray(w_hat), jnp.asarray(sigma)))
    te = tqe.relative_error(torch.from_numpy(w), torch.from_numpy(w_hat), torch.from_numpy(sigma)).item()
    assert te == pytest.approx(je, rel=1e-5)
    np.testing.assert_allclose(gram(torch.from_numpy(x)).numpy(), np.asarray(jcalib.gram(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(damp_sigma(torch.from_numpy(sigma)).numpy(),
                               np.asarray(jcalib.damp_sigma(jnp.asarray(sigma))), rtol=1e-6)
    st = CalibStats.zeros(32, device="cpu").update_tokens(torch.from_numpy(x.T.reshape(2, 32, 32)))
    js = jcalib.CalibStats.zeros(32).update_tokens(jnp.asarray(x.T.reshape(2, 32, 32)))
    np.testing.assert_allclose(st.sigma.numpy(), np.asarray(js.sigma), rtol=1e-5, atol=1e-3)
    assert st.n == js.n == 64


def test_config_and_engine_options():
    w, sigma, _ = _problem(6, q=8, p=16, n=32)
    assert tqe.QuantEaseConfig().solve_kwargs()["block_size"] == 256
    with pytest.raises(ValueError, match="engine"):
        _torch(w, sigma, 3, iterations=1, engine="pre-fused")
    with pytest.raises(ValueError):
        _torch(w, sigma, 3, iterations=1, use_kernel="cuda")
    a = _torch(w, sigma, 3, iterations=2, use_kernel="auto")[0]
    b = _torch(w, sigma, 3, iterations=2, use_kernel="torch")[0]
    np.testing.assert_array_equal(a, b)
