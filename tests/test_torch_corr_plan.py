"""The correction SGEMM's planner, held on the CPU.

* :func:`repro_torch.kernels.quantease_cd.plan_corr` (pure: shapes, the
  card's SM count and the CTAs of a tile resident per SM in, ``(tile_rows,
  splits)`` out): the 128-row tile at Phi-3-mini's solver shapes, with a
  wave of CTAs filled and a bounded idle tail; the 64-row tile for blocks of
  fewer than 128 rows; split slices that cover ``[0, p_pad)`` in whole
  k-steps, none shorter than ``MIN_K_CHUNK``; overrides the kernel cannot
  take refused;
* the split-K order the kernels sum in (each slice's fp32 partial, added in
  split order, then the base) emulated in torch for whole iterations of
  kernels 2 and 4, against the JAX reference's Pallas kernel (interpret
  mode) and oracle at atol 2e-4 and 1e-5, as ``tests/test_torch_kernels.py``
  and ``tests/test_torch_outlier.py`` hold the plain versions.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.quantease_cd import quantease_fused_iteration_pallas
from repro.quant import GridSpec, compute_grid, quantize_dequantize
from repro_torch.kernels import quantease_cd as qcd
from repro_torch.kernels import ref as tref
from tests._hypothesis_compat import given, settings, st
from tests._torch_cpu import one_torch_thread  # noqa: F401

N_SM = 132  # the H100's SMs
# (G, q, p) of Phi-3-mini's solver groups: attention, MLP up, MLP down.
PATH_GROUPS = ((4, 3072, 3072), (2, 8192, 3072), (1, 3072, 8192))
IDLE_MAX = 0.25  # the share of the last wave a path plan may leave idle


def _waves(G, q, bsz, plan, ctas_per_sm):
    ctas = qcd.corr_ctas(G, q, bsz, *plan)
    return ctas / (N_SM * ctas_per_sm)


@pytest.mark.parametrize("ctas_per_sm", [1, 2])
@pytest.mark.parametrize("bsz", [256, 128])  # QuantEase's block, qe_outlier's
@pytest.mark.parametrize("G,q,p", PATH_GROUPS)
def test_plan_fills_a_wave_at_the_path_shapes(G, q, p, bsz, ctas_per_sm):
    plan = qcd.plan_corr(G, q, bsz, p, N_SM, ctas_per_sm)
    assert plan[0] == 128
    waves = _waves(G, q, bsz, plan, ctas_per_sm)
    assert waves >= 1 - IDLE_MAX
    assert math.ceil(waves) - waves <= IDLE_MAX
    lo, hi = qcd.corr_slices(p, plan[1])[0]
    assert plan[1] == 1 or hi - lo >= qcd.MIN_K_CHUNK


@pytest.mark.parametrize("bsz", [1, 16, 32, 40, 64, 96, 127, 128, 200, 256])
def test_plan_tile_by_block_rows(bsz):
    tile, _ = qcd.plan_corr(2, 3072, bsz, 3072, N_SM, 2)
    assert tile == (64 if bsz < 128 else 128) == qcd.corr_tile_rows(bsz)


@pytest.mark.parametrize("p_pad", [16, 96, 105, 160, 3072, 8192])
def test_split_slices_cover_k_in_whole_steps(p_pad):
    steps = -(-p_pad // qcd.K_STEP)
    for splits in range(1, steps + 1):
        try:
            sl = qcd.corr_slices(p_pad, splits)
        except ValueError:
            chunk = -(-steps // splits)
            assert (splits - 1) * chunk * qcd.K_STEP >= p_pad  # refused only for an empty slice
            continue
        assert len(sl) == splits and sl[0][0] == 0 and sl[-1][1] == p_pad
        assert all(a[1] == b[0] for a, b in zip(sl, sl[1:]))
        assert all(lo % qcd.K_STEP == 0 and hi > lo for lo, hi in sl)


@settings(max_examples=60, deadline=None)
@given(G=st.integers(1, 8), q=st.integers(1, 9000), nb=st.integers(1, 64),
       bsz=st.integers(1, 256), n_sm=st.integers(1, 160), cps=st.integers(1, 4))
def test_plan_is_valid_and_no_slower_than_one_split(G, q, nb, bsz, n_sm, cps):
    """Any shape the wrappers accept: a plan the kernel takes, slices of at
    least MIN_K_CHUNK, and a modeled time (waves x k-steps) no worse than
    the unsplit launch's."""
    p_pad = nb * bsz
    tile, splits = qcd.check_corr_plan(qcd.plan_corr(G, q, bsz, p_pad, n_sm, cps), p_pad)
    assert tile == qcd.corr_tile_rows(bsz)
    lo, hi = qcd.corr_slices(p_pad, splits)[0]
    assert splits == 1 or hi - lo >= qcd.MIN_K_CHUNK
    steps = -(-p_pad // qcd.K_STEP)
    cost = lambda s: math.ceil(qcd.corr_ctas(G, q, bsz, tile, s) / (n_sm * cps)) * -(-steps // s)
    assert cost(splits) <= cost(1)


@pytest.mark.parametrize("plan", [(96, 1), (128, 0), (128, -1), (64, 2.0), (128, 33), (128,), "128x1"])
def test_plan_override_the_kernel_cannot_take_is_refused(plan):
    with pytest.raises(ValueError):
        qcd.check_corr_plan(plan, 512)  # 32 k-steps: 33 splits leave one empty


def test_plan_override_accepted_as_given():
    assert qcd.check_corr_plan((64, 32), 512) == (64, 32)
    assert qcd.check_corr_plan([128, 3], 512) == (128, 3)


# ---------------------------------------------------------------------------
# The kernels' split-K order, emulated, against the JAX reference
# ---------------------------------------------------------------------------


def _state(seed, q, p, bits=3):
    r = np.random.default_rng(seed)
    x = r.standard_normal((p, 2 * p)).astype(np.float32)
    sigma = x @ x.T
    sigma += 0.01 * np.mean(np.diag(sigma)) * np.eye(p, dtype=np.float32)
    sig_norm = (sigma / np.diag(sigma)[None, :]).astype(np.float32)
    sig_tilde = (sig_norm - np.eye(p, dtype=np.float32)).astype(np.float32)
    w = r.standard_normal((q, p)).astype(np.float32)
    grid = compute_grid(jnp.asarray(w), GridSpec(bits=bits))
    scale, zero = (np.array(a) for a in grid.per_column(p))
    w_hat = np.array(quantize_dequantize(jnp.asarray(w), grid))
    base = (w @ sig_norm - w_hat @ sig_tilde).astype(np.float32)
    delta = (0.01 * r.standard_normal((q, p))).astype(np.float32)
    dh = np.where(r.random((q, p)) < 0.02, 0.05 * r.standard_normal((q, p)), 0.0).astype(np.float32)
    return dict(base=base, sig_tilde=sig_tilde, w_hat=w_hat, scale=scale, zero=zero,
                delta=delta, dh=dh, n_levels=1 << bits)


def _split_k_iteration(s, bsz, splits, cdt, outlier):
    """One iteration of kernel 2 (or 4) as the kernels sum it: per block,
    each slice's fp32 partial of Σ̃ᵀ[blk, lo:hi] @ Δ[lo:hi], added in split
    order, then to the base (− dĤ_prev); the sweep; the published Δ; for
    kernel 4 the exact residual.  Transposed (p, q) layout."""
    t = lambda k: torch.from_numpy(np.ascontiguousarray(s[k].T))
    base, sig_t, w, scale, zero, acc = (t(k) for k in ("base", "sig_tilde", "w_hat", "scale", "zero", "delta"))
    dh = t("dh") if outlier else torch.zeros_like(base)
    p_pad = base.shape[0]
    a_all = sig_t.to(cdt).float()
    w_new, base_new, dpure = (torch.empty_like(base) for _ in range(3))
    for col0 in range(0, p_pad, bsz):
        sl = slice(col0, col0 + bsz)
        d_op = acc.to(cdt).float()
        part = [a_all[sl, lo:hi] @ d_op[lo:hi] for lo, hi in qcd.corr_slices(p_pad, splits)]
        total = part[0]
        for x in part[1:]:
            total = total + x
        beta0 = (base[sl] - dh[sl] if outlier else base[sl]) + total
        new, d = tref.quantease_block_sweep_t_ref(beta0, sig_t[sl, sl], w[sl], scale[sl], zero[sl],
                                                   n_levels=s["n_levels"], quantize=True)
        w_new[sl], base_new[sl], dpure[sl] = new, beta0, d
        acc[sl] = d - dh[sl]
    if not outlier:
        return w_new, base_new, acc
    blk = torch.arange(p_pad) // bsz
    r = base_new + torch.where(blk[None, :] >= blk[:, None], a_all, 0.0) @ dpure.to(cdt).float()
    return w_new, base_new, dpure, r


@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_split_k_fused_iteration_matches_pallas(matmul_dtype, splits):
    q, p, bsz = 96, 256, 128
    s = _state(7, q, p)
    names = ("base", "sig_tilde", "w_hat", "scale", "zero", "delta")
    j_out = quantease_fused_iteration_pallas(
        *(jnp.asarray(s[k]) for k in names), n_levels=s["n_levels"], quantize=True, bsz=bsz,
        matmul_dtype=matmul_dtype, interpret=True,
    )
    cdt = torch.bfloat16 if matmul_dtype == "bfloat16" else torch.float32
    for t, j in zip(_split_k_iteration(s, bsz, splits, cdt, outlier=False), j_out):
        np.testing.assert_allclose(t.T.numpy(), np.asarray(j), rtol=0, atol=2e-4)


@pytest.mark.parametrize("splits", [1, 2, 6])
def test_split_k_outlier_iteration_matches_jax_ref(splits):
    q, p, bsz = 40, 96, 48
    s = _state(q + p, q, p)
    names = ("base", "sig_tilde", "w_hat", "scale", "zero", "delta", "dh")
    j_out = jref.quantease_outlier_iteration_ref(*(jnp.asarray(s[k]) for k in names),
                                                 n_levels=s["n_levels"], quantize=True, bsz=bsz)
    for name, t, j in zip(("w_new", "base_new", "delta_pure", "r"),
                          _split_k_iteration(s, bsz, splits, torch.float32, outlier=True), j_out):
        np.testing.assert_allclose(t.T.numpy(), np.asarray(j), rtol=0, atol=1e-5, err_msg=name)
