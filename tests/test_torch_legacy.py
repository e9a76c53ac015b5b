"""The port's legacy CD engines against the reference's, and against the
port's fused engines, on the same numpy inputs.

``engine="legacy"`` of ``quantease_quantize`` (full P̂ recompute, a
full-width correction per block, then kernel 1's sweep) and of
``outlier_quantease`` (one QuantEase iteration, then the IHT step; its
range-shrunk grid's scales at two ulp, since the reference's jitted grid
multiplies by 1/n where the port divides), at the reference's tolerances (``tests/test_fused_engine.py``,
``tests/test_outlier_fused.py``): iterates within atol 2e-4, objective
histories at rtol 1e-5 (QuantEase) and 1e-4 (Algorithm 3), the fused
outlier engine's error within 1.01× the legacy one's.  On the CPU the
sweep is the plain version; the card's run is in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import outlier as jout
from repro.core import quantease as jqe
from repro.quant import GridSpec as JSpec
from repro_torch.core import outlier as tout
from repro_torch.core import quantease as tqe
from repro_torch.kernels import ops
from repro_torch.quant import GridSpec
from tests._torch_cpu import one_torch_thread  # noqa: F401

ATOL = 2e-4
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


@pytest.mark.parametrize("heuristic", [False, True])
@pytest.mark.parametrize("bsz", [32, 128])
def test_legacy_matches_reference_legacy(prob, bsz, heuristic):
    w, sigma = prob
    kw = dict(iterations=4, block_size=bsz, unquantized_heuristic=heuristic, engine="legacy")
    j = np.asarray(jqe.quantease_quantize(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3), **kw)[0])
    t = tqe.quantease_quantize(*_t(w, sigma), SPEC3, **kw)[0].numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


@pytest.mark.parametrize("heuristic", [False, True])
@pytest.mark.parametrize("bsz", [32, 128])
def test_legacy_matches_fused(prob, bsz, heuristic):
    """The reference's equivalence on the port: both schedules apply the
    updates in the same order."""
    kw = dict(iterations=4, block_size=bsz, unquantized_heuristic=heuristic)
    leg = tqe.quantease_quantize(*_t(*prob), SPEC3, engine="legacy", **kw)[0]
    fus = tqe.quantease_quantize(*_t(*prob), SPEC3, engine="fused", **kw)[0]
    np.testing.assert_allclose(leg.numpy(), fus.numpy(), rtol=0, atol=ATOL)


def test_legacy_objective_matches_fused_and_reference(prob):
    kw = dict(iterations=5, unquantized_heuristic=False, track_objective=True)
    _, leg = tqe.quantease_quantize(*_t(*prob), SPEC3, engine="legacy", **kw)
    _, fus = tqe.quantease_quantize(*_t(*prob), SPEC3, engine="fused", **kw)
    _, ref = jqe.quantease_quantize(*map(jnp.asarray, prob), JSpec(bits=3), engine="legacy", **kw)
    np.testing.assert_allclose(leg.numpy(), fus.numpy(), rtol=1e-5)
    np.testing.assert_allclose(leg.numpy(), np.asarray(ref), rtol=1e-5)


def test_legacy_sweeps_each_block_once_per_iteration(prob, monkeypatch):
    """Kernel 1's entry point runs once per column block and iteration, on
    the batched (G, B, q) operands, with a correction product in between."""
    calls = []
    orig = ops.quantease_block_sweep

    def spy(beta0_t, sig_t, *a, **kw):
        calls.append((tuple(beta0_t.shape), tuple(sig_t.shape)))
        return orig(beta0_t, sig_t, *a, **kw)

    monkeypatch.setattr(ops, "quantease_block_sweep", spy)
    w, sigma = prob
    w3, s3 = np.stack([w, 0.5 * w]), np.stack([sigma, sigma])
    tqe.quantease_quantize(*_t(w3, s3), SPEC3, iterations=3, block_size=32, engine="legacy")
    assert calls == [((2, 32, 96), (2, 32, 32))] * (3 * 128 // 32)


def test_legacy_batched_equals_per_layer():
    ws, sigs = zip(*(_problem(s, q=40, p=100) for s in (1, 2, 3)))  # p pads to 128
    kw = dict(iterations=3, block_size=64, engine="legacy")
    batched = tqe.quantease_quantize(*_t(np.stack(ws), np.stack(sigs)), SPEC3, **kw)[0]
    for g in range(3):
        one = tqe.quantease_quantize(*_t(ws[g], sigs[g]), SPEC3, **kw)[0]
        np.testing.assert_allclose(batched[g].numpy(), one.numpy(), rtol=0, atol=ATOL)


def test_legacy_plain_and_routed_sweeps_agree(prob):
    """``use_kernel="torch"`` (the plain sweep) and ``"auto"`` (routed by
    device: on the CPU the same plain sweep) give the same iterates."""
    kw = dict(iterations=2, block_size=64, engine="legacy")
    a = tqe.quantease_quantize(*_t(*prob), SPEC3, use_kernel="auto", **kw)[0]
    b = tqe.quantease_quantize(*_t(*prob), SPEC3, use_kernel="torch", **kw)[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError):
        tqe.quantease_quantize(*_t(*prob), SPEC3, use_kernel="cuda", **kw)


# ---------------------------------------------------------------------------
# Algorithm 3, legacy schedule
# ---------------------------------------------------------------------------


def _outlier_both(w, sigma, engine="legacy", **kw):
    j = jout.outlier_quantease(jnp.asarray(w), jnp.asarray(sigma), JSpec(bits=3), engine=engine,
                               use_kernel="xla", **kw)
    t = tout.outlier_quantease(*_t(w, sigma), SPEC3, engine=engine, **kw)
    return j, t


def _rel(w, w_eff, sigma):
    return float(tqe.relative_error(*_t(w), w_eff, *_t(sigma)))


@pytest.mark.parametrize("structured", [False, True])
def test_outlier_legacy_matches_reference_legacy(prob, structured):
    w, sigma = prob
    s = int((0.02 if structured else 0.01) * w.size)
    j, t = _outlier_both(w, sigma, s=s, iterations=8, structured=structured)
    np.testing.assert_allclose(t.w_hat.numpy(), np.asarray(j.w_hat), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.h.numpy(), np.asarray(j.h), rtol=0, atol=ATOL)
    # The reference's jitted grid divides as a multiply by 1/n: two ulp.
    np.testing.assert_allclose(t.grid.scale.numpy(), np.asarray(j.grid.scale), rtol=2.4e-7)


@pytest.mark.parametrize("structured", [False, True])
def test_outlier_fused_matches_legacy(prob, structured):
    """The reference's equivalence on the port: the fused engine's error is
    within 1.01× the legacy one's, the budget holds, the iterates agree."""
    w, sigma = prob
    q = w.shape[0]
    s = int((0.02 if structured else 0.01) * w.size)
    kw = dict(s=s, iterations=8 if not structured else 6, structured=structured)
    rl = tout.outlier_quantease(*_t(w, sigma), SPEC3, engine="legacy", **kw)
    rf = tout.outlier_quantease(*_t(w, sigma), SPEC3, engine="fused", **kw)
    assert _rel(w, rf.w_eff, sigma) <= _rel(w, rl.w_eff, sigma) * 1.01 + 1e-7
    if structured:
        assert len(np.nonzero(rf.h.abs().sum(0).numpy())[0]) <= max(s // q, 1)
    else:
        assert int((rf.h != 0).sum()) <= s
    np.testing.assert_allclose(rl.w_hat.numpy(), rf.w_hat.numpy(), rtol=0, atol=ATOL)


def test_outlier_legacy_padding_non_multiple_block():
    r = np.random.default_rng(3)
    q, p = 48, 100  # pads to 128
    w = r.standard_normal((q, p)).astype(np.float32)
    x = r.standard_normal((p, 300)).astype(np.float32)
    j, t = _outlier_both(w, x @ x.T, s=50, iterations=5)
    rf = tout.outlier_quantease(*_t(w, x @ x.T), SPEC3, s=50, iterations=5, engine="fused")
    np.testing.assert_allclose(t.w_hat.numpy(), np.asarray(j.w_hat), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.w_hat.numpy(), rf.w_hat.numpy(), rtol=0, atol=ATOL)
    assert t.h.shape == (q, p) and int((t.h != 0).sum()) <= 50


def test_outlier_legacy_objective_matches_fused_and_reference(prob):
    w, sigma = prob
    kw = dict(s=int(0.01 * w.size), iterations=5, track_objective=True)
    j, t = _outlier_both(w, sigma, **kw)
    rf = tout.outlier_quantease(*_t(w, sigma), SPEC3, engine="fused", **kw)
    assert t.objective.shape == (5,)
    np.testing.assert_allclose(t.objective.numpy(), np.asarray(j.objective), rtol=1e-4)
    np.testing.assert_allclose(t.objective.numpy(), rf.objective.numpy(), rtol=1e-4)


def test_outlier_legacy_batched_equals_per_layer():
    ws, sigs = zip(*(_problem(s, q=32, p=64) for s in (4, 5)))
    kw = dict(s=40, iterations=4, engine="legacy")
    batched = tout.outlier_quantease(*_t(np.stack(ws), np.stack(sigs)), SPEC3, **kw)
    for g in range(2):
        one = tout.outlier_quantease(*_t(ws[g], sigs[g]), SPEC3, **kw)
        np.testing.assert_allclose(batched.w_hat[g].numpy(), one.w_hat.numpy(), rtol=0, atol=ATOL)
        np.testing.assert_allclose(batched.h[g].numpy(), one.h.numpy(), rtol=0, atol=ATOL)
