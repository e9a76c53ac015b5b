"""The block sweep's planner and its panelled summation order, held on the CPU.

* :func:`repro_torch.kernels.quantease_cd.plan_sweep` (pure: shapes, the
  card's SM count and the CTAs per SM of each instance in, ``(panel, rows)``
  out) at Phi-3-mini's six path shapes (three solver groups, QuantEase's
  B = 256 and qe_outlier's B = 128): the plan the kernel takes, panels that cover the block, CTAs that
  cover every row in the fewest rounds of resident CTAs; overrides the
  kernel cannot take refused;
* the order in which the kernel sums each β (panel by panel: the panel's own
  terms eagerly, column by column, then the panel's terms added into every
  later column), emulated in torch, against the JAX reference's oracle and
  its Pallas kernel in interpret mode at atol 2e-4, as
  ``tests/test_torch_kernels.py`` holds the plain sweep.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.quantease_cd import quantease_block_sweep_pallas
from repro.quant import GridSpec, compute_grid, quantize_dequantize
from repro_torch.kernels import quantease_cd as qcd
from tests._hypothesis_compat import given, settings, st
from tests._torch_cpu import one_torch_thread  # noqa: F401

N_SM = 132  # the H100's SMs
# CTAs of the 32- and 64-row sweep resident per H100 SM at B = 256 and 128
# (the occupancy calculator, which chip_smoke.py phase 3 prints).
H100_CTAS = {256: (3, 1), 128: (3, 2)}
ATOL_CD = 2e-4
# (G, q) of Phi-3-mini's solver groups: attention, MLP up, MLP down.
PATH_GROUPS = ((4, 3072), (2, 8192), (1, 3072))
# The plans the H100 measured fastest there (chip_smoke.py phase 3).
PATH_PLANS = {(2, 8192, 128): (16, 64)}


def _rounds(G, q, rows, n_sm, ctas):
    return math.ceil(qcd.sweep_ctas(G, q, rows) / (n_sm * ctas[qcd.SWEEP_ROWS.index(rows)]))


@pytest.mark.parametrize("bsz", [256, 128])  # QuantEase's block, qe_outlier's
@pytest.mark.parametrize("G,q", PATH_GROUPS)
def test_plan_at_the_path_shapes(G, q, bsz):
    ctas = H100_CTAS[bsz]
    plan = qcd.plan_sweep(G, q, bsz, N_SM, *ctas)
    assert qcd.check_sweep_plan(plan) == plan
    assert plan == PATH_PLANS.get((G, q, bsz), (16, 32))
    panel, rows = plan
    panels = qcd.sweep_panels(bsz, panel)
    assert panels[0][0] == 0 and panels[-1][1] == bsz
    assert all(a[1] == b[0] and a[1] - a[0] == panel for a, b in zip(panels, panels[1:]))
    assert qcd.sweep_ctas(G, q, rows) * rows >= G * q
    rounds = {r: _rounds(G, q, r, N_SM, ctas) for r in qcd.SWEEP_ROWS}
    assert rounds[rows] == min(rounds.values())


@pytest.mark.parametrize("bsz,panel,want", [(40, 16, [(0, 16), (16, 32), (32, 40)]),
                                            (48, 16, [(0, 16), (16, 32), (32, 48)]),
                                            (5, 16, [(0, 5)]), (256, 16, None)])
def test_panels_cover_the_block(bsz, panel, want):
    panels = qcd.sweep_panels(bsz, panel)
    if want is not None:
        assert panels == want
    assert sum(hi - lo for lo, hi in panels) == bsz
    assert all(0 < hi - lo <= panel for lo, hi in panels)


@settings(max_examples=60, deadline=None)
@given(G=st.integers(1, 8), q=st.integers(1, 9000), bsz=st.integers(1, 256),
       n_sm=st.integers(1, 160), ctas=st.tuples(st.integers(1, 8), st.integers(1, 8)))
def test_plan_is_valid_for_any_shape(G, q, bsz, n_sm, ctas):
    panel, rows = qcd.check_sweep_plan(qcd.plan_sweep(G, q, bsz, n_sm, *ctas))
    assert panel == qcd.SWEEP_PANEL and rows in qcd.SWEEP_ROWS
    assert qcd.SWEEP_THREADS % rows == 0  # SWEEP_THREADS // rows lanes share a row
    rounds = {r: _rounds(G, q, r, n_sm, ctas) for r in qcd.SWEEP_ROWS}
    assert rounds[rows] == min(rounds.values())


@pytest.mark.parametrize("args", [(0, 3072, 256, 132, 3, 1), (1, 3072, 256, 132, 0, 1),
                                  (1, 3072, 256, 132, 3, 0), (1, 3072, 0, 132, 3, 1)])
def test_plan_of_an_empty_shape_or_card_is_refused(args):
    with pytest.raises(ValueError):
        qcd.plan_sweep(*args)


@pytest.mark.parametrize("plan", [(8, 32), (32, 32), (16, 16), (16, 8), (16, 32, 8), (16,),
                                  (16.0, 32), (16, True), "16x32", 32, None])
def test_plan_the_kernel_cannot_take_is_refused(plan):
    with pytest.raises(ValueError):
        qcd.check_sweep_plan(plan)


def test_plan_override_accepted_as_given():
    assert qcd.check_sweep_plan([16, 32]) == (16, 32)
    assert qcd.check_sweep_plan((16, 64)) == (16, 64)


# ---------------------------------------------------------------------------
# The kernel's summation order, emulated, against the JAX reference
# ---------------------------------------------------------------------------


def _sweep_inputs(seed, q, bsz, bits=3):
    """A mid-solve block: Σ̃ from a damped Gram, grid, β0 (as
    tests/test_torch_kernels.py)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((bsz, 2 * bsz)).astype(np.float32)
    sigma = x @ x.T
    sigma += 0.01 * np.mean(np.diag(sigma)) * np.eye(bsz, dtype=np.float32)
    sig_norm = (sigma / np.diag(sigma)[None, :]).astype(np.float32)
    sig_tilde = (sig_norm - np.eye(bsz, dtype=np.float32)).astype(np.float32)
    w = r.standard_normal((q, bsz)).astype(np.float32)
    grid = compute_grid(jnp.asarray(w), GridSpec(bits=bits))
    scale, zero = (np.array(a) for a in grid.per_column(bsz))
    w_hat = np.array(quantize_dequantize(jnp.asarray(w), grid))
    beta0 = (w @ sig_norm - w_hat @ sig_tilde).astype(np.float32)
    return (beta0, sig_tilde, w_hat, scale, zero), 1 << bits


def _panelled_sweep(beta0_t, sig_t, w_old_t, scale_t, zero_t, *, n_levels, quantize, panel):
    """The sweep as ``qe_block_sweep_kernel`` sums it, transposed ``(B, q)``:
    per panel, each column's β = β0 + (earlier panels' sum + the panel's
    earlier columns' terms, added eagerly as each Δ is known); then the
    panel's terms added into every later column's sum in ascending j.  Each
    β is one sum over ascending j whatever the panel (the kernel fuses each
    step into one FMA)."""
    bsz = beta0_t.shape[0]
    acc = torch.zeros_like(beta0_t)
    new_t, delta_t = torch.empty_like(beta0_t), torch.empty_like(beta0_t)
    for lo, hi in qcd.sweep_panels(bsz, panel):
        bet = acc[lo:hi].clone()
        for i in range(lo, hi):
            beta = beta0_t[i] + bet[i - lo]
            if quantize:
                s = torch.clamp_min(scale_t[i], 1e-12)
                codes = torch.clamp(torch.round(beta / s) + zero_t[i], 0, n_levels - 1)
                new = (codes - zero_t[i]) * s
            else:
                new = beta
            new_t[i], delta_t[i] = new, w_old_t[i] - new
            bet[i - lo + 1:] += sig_t[i + 1:hi, i:i + 1] * delta_t[i]
        for j in range(lo, hi):
            acc[hi:] += sig_t[hi:, j:j + 1] * delta_t[j]
    return new_t, delta_t


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("bsz", [40, 48, 128, 256])
def test_panelled_order_matches_jax_ref_and_pallas(bsz, quantize):
    """B = 40 leaves a short last panel of 8 columns.  One panel of the whole
    block is the unpanelled order: the panels leave every sum as it was."""
    q = 24
    args, n_levels = _sweep_inputs(bsz + q, q, bsz)
    kw = dict(n_levels=n_levels, quantize=quantize)
    jn, jd = jref.quantease_block_sweep_ref(*map(jnp.asarray, args), **kw)
    pn, pd = quantease_block_sweep_pallas(*map(jnp.asarray, args), interpret=True, **kw)
    beta0, sig, w, scale, zero = args
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    # Σ̃ᵀ, row i = Σ̃_blk[:, i], as the kernel takes it.
    targs = (t(beta0), t(sig), t(w), t(scale), t(zero))
    tn, td = _panelled_sweep(*targs, **kw, panel=qcd.SWEEP_PANEL)
    for tv, j, pl in ((tn, jn, pn), (td, jd, pd)):
        np.testing.assert_allclose(tv.T.numpy(), np.asarray(j), rtol=0, atol=ATOL_CD)
        np.testing.assert_allclose(tv.T.numpy(), np.asarray(pl), rtol=0, atol=ATOL_CD)
    un, ud = _panelled_sweep(*targs, **kw, panel=bsz)
    assert torch.equal(tn, un) and torch.equal(td, ud)
