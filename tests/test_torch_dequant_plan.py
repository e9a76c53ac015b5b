"""The dequant-GEMM's tensor-core design, held on the CPU.

* the planner (``repro_torch.kernels.dequant_matmul.plan_dequant_matmul``):
  variant by dtype and group size, the split and the k slices it implies;
* the factored arithmetic the tensor-core variants compute — bf16 x times
  the exact bf16 integer ``c − z``, fp32 sums per group (flushed every 128
  k), then the group's scale — emulated in torch and held against the JAX
  reference's oracle and its Pallas kernel (interpret mode) within 1e-5 of
  max |y|;
* the precondition that makes it exact: every grid the port and the
  reference make has integer zero points in ``[0, 2^bits − 1]``, and the
  two places an artifact enters the port refuse any other.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dequant_matmul import dequant_matmul_pallas
from repro.quant import GridSpec as JSpec
from repro.quant import compute_grid as jcompute_grid
from repro.quant import compute_grid_excluding_outliers as jcompute_grid_ex
from repro_torch import interop
from repro_torch.kernels import dequant_matmul as dq
from repro_torch.quant import (
    GridSpec,
    QuantizedTensor,
    compute_grid,
    compute_grid_excluding_outliers,
    quantize_codes,
)
from repro_torch.serve.qparams import quantize_params_for_serving
from tests._hypothesis_compat import given, settings, st
from tests._torch_cpu import one_torch_thread  # noqa: F401

N_SM = 132  # the H100's SMs
PATH_SHAPES = ((3072, 3072), (8192, 3072), (3072, 8192))  # (q, p) of Phi-3-mini's linears


# ---------------------------------------------------------------------------
# (a) the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 8, 64, 65, 128, 2048])
@pytest.mark.parametrize("group_size", [None, 16, 48, 100, 128, 256])
def test_plan_variant_by_dtype_and_group_size(m, group_size):
    q, p = 3072, 3072
    assert dq.plan_dequant_matmul(m, q, p, group_size, torch.float32, N_SM) == ("simt", 1)
    variant, split = dq.plan_dequant_matmul(m, q, p, group_size, torch.bfloat16, N_SM)
    if group_size is not None and group_size % 16:
        assert (variant, split) == ("simt", 1)
    elif m <= dq.SMALL_M_MAX and (group_size is None or group_size % 128 == 0):
        assert variant == "tc_small"
    else:
        assert variant == "tc_large"
    assert 1 <= split <= math.ceil(p / dq.SPLIT_QUANTUM)


@pytest.mark.parametrize("q,p", PATH_SHAPES)
def test_decode_grid_fills_the_card(q, p):
    """At the decode batch the grid holds at least two CTAs per SM."""
    variant, split = dq.plan_dequant_matmul(8, q, p, None, torch.bfloat16, N_SM)
    assert variant == "tc_small" and split > 1
    assert dq.grid_ctas(variant, 8, q, split) >= 2 * N_SM


@pytest.mark.parametrize("q,p", PATH_SHAPES)
@pytest.mark.parametrize("m", [128, 2048])
def test_large_m_plans(q, p, m):
    """The prefill chunk splits k over a few CTAs per tile; m = 2048 does not."""
    variant, split = dq.plan_dequant_matmul(m, q, p, None, torch.bfloat16, N_SM)
    assert variant == "tc_large"
    assert (split > 1) == (m == 128)


@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 4096), q=st.integers(1, 16384), p=st.integers(2, 16384),
       variant=st.sampled_from(["tc_small", "tc_large"]), n_sm=st.sampled_from([1, 16, 132]))
def test_split_slices_cover_k_exactly(m, q, p, variant, n_sm):
    split = dq.split_for(variant, m, q, p, n_sm)
    assert 1 <= split <= math.ceil(p / dq.SPLIT_QUANTUM)
    slices = dq.split_slices(p, split)
    assert slices[0][0] == 0 and slices[-1][1] == p
    for (lo, hi), (lo2, _) in zip(slices, slices[1:]):
        assert hi == lo2
    for lo, hi in slices:
        assert lo < hi and lo % dq.SPLIT_QUANTUM == 0


# ---------------------------------------------------------------------------
# (b) the factored arithmetic against the reference
# ---------------------------------------------------------------------------


def factored_emulation(x_bf16, codes, scale, zero, group_size):
    """What the tensor-core variants compute: per group, bf16 (c − z) (exact
    integers), fp32 sums of the exact products flushed every 128 k, each
    flush scaled by the group's s into an fp32 total."""
    m, p = x_bf16.shape
    gsz = group_size or p
    xf = x_bf16.to(torch.float32)
    y = torch.zeros(m, codes.shape[0], dtype=torch.float32)
    for g in range(scale.shape[1]):
        cz = (codes[:, g * gsz:(g + 1) * gsz].to(torch.float32) - zero[:, g:g + 1])
        assert torch.equal(cz.to(torch.bfloat16).to(torch.float32), cz)  # exact in bf16
        for k0 in range(0, cz.shape[1], 128):
            k1 = min(k0 + 128, cz.shape[1])
            acc = xf[:, g * gsz + k0:g * gsz + k1] @ cz[:, k0:k1].T
            y = y + acc * scale[:, g]
    return y


def _problem(seed, m, q, p, n_groups):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((m, p)).astype(np.float32)).to(torch.bfloat16)
    codes = r.integers(0, 16, (q, p)).astype(np.uint8)
    scale = (r.random((q, n_groups)) * 0.1 + 0.01).astype(np.float32)
    zero = r.integers(0, 16, (q, n_groups)).astype(np.float32)
    return x, codes, scale, zero


@pytest.mark.parametrize("p,group_size", [(384, None), (384, 128), (384, 256), (70, 16), (70, None)])
def test_factored_sum_matches_reference_and_pallas(p, group_size):
    m, q = 5, 24
    n_groups = 1 if group_size is None else -(-p // group_size)
    x, codes, scale, zero = _problem(p + n_groups, m, q, p, n_groups)
    y = factored_emulation(x, torch.from_numpy(codes), torch.from_numpy(scale),
                           torch.from_numpy(zero), group_size).numpy()
    xf = x.to(torch.float32).numpy()  # the bf16 values, as the reference sees them
    y_ref = np.asarray(jref.dequant_matmul_ref(jnp.asarray(xf), jnp.asarray(codes), jnp.asarray(scale),
                                               jnp.asarray(zero), group_size=group_size))
    # The Pallas kernel takes uniform groups only: pad k with zero x columns
    # (and zero codes) up to whole groups, which adds nothing to any sum.
    p_pad = p if group_size is None else n_groups * group_size
    xp = np.pad(xf, ((0, 0), (0, p_pad - p)))
    cp = np.pad(codes, ((0, 0), (0, p_pad - p)))
    y_pl = np.asarray(dequant_matmul_pallas(jnp.asarray(xp), jnp.asarray(cp), jnp.asarray(scale),
                                            jnp.asarray(zero), out_dtype=jnp.float32, interpret=True))
    scale_y = float(np.abs(y_ref).max())
    for other in (y_ref, y_pl):
        assert float(np.abs(y - other).max()) <= 1e-5 * scale_y


# ---------------------------------------------------------------------------
# (c) the zero-point precondition at the artifact's entry points
# ---------------------------------------------------------------------------

ROW_KINDS = ("positive", "negative", "zero", "symmetric")


def _rows(kinds, p, magnitude, seed):
    r = np.random.default_rng(seed)
    rows = []
    for kind in kinds:
        v = (r.random(p) + 1e-3) * magnitude
        if kind == "negative":
            v = -v
        elif kind == "zero":
            v = np.zeros(p)
        elif kind == "symmetric":
            v = np.concatenate([v[: p // 2], -v[: p // 2]])
        rows.append(v)
    return np.stack(rows).astype(np.float32)


def _serve(qt):
    return quantize_params_for_serving(None, {"embed": torch.zeros(1)}, [{"wq": qt}], device="cpu")


def _as_reference_qt(codes, scale, zero, bits, group_size):
    return types.SimpleNamespace(codes=codes, scale=scale, zero=zero, bits=bits,
                                 group_size=group_size, packed=False)


@settings(max_examples=40, deadline=None)
@given(kinds=st.lists(st.sampled_from(ROW_KINDS), min_size=1, max_size=6),
       bits=st.sampled_from([2, 3, 4, 8]), symmetric=st.booleans(),
       group_size=st.sampled_from([None, 16, 24]), exponent=st.integers(-8, 3),
       seed=st.integers(0, 2**16))
def test_every_grid_passes_the_precondition(kinds, bits, symmetric, group_size, exponent, seed):
    p = 48
    w = _rows(kinds, p, 10.0 ** exponent, seed)
    mask = np.random.default_rng(seed + 1).random(w.shape) < 0.05
    spec = GridSpec(bits=bits, symmetric=symmetric, group_size=group_size)
    jspec = JSpec(bits=bits, symmetric=symmetric, group_size=group_size)
    tw = torch.from_numpy(w)
    for grid in (compute_grid(tw, spec), compute_grid_excluding_outliers(tw, spec, torch.from_numpy(mask))):
        codes = quantize_codes(tw, grid)
        _serve(QuantizedTensor(codes=codes, scale=grid.scale, zero=grid.zero, bits=bits,
                               group_size=group_size))
    for jgrid in (jcompute_grid(jnp.asarray(w), jspec), jcompute_grid_ex(jnp.asarray(w), jspec, jnp.asarray(mask))):
        qt = interop.qtensor_from_jax(_as_reference_qt(
            np.zeros(w.shape, np.uint8), np.asarray(jgrid.scale), np.asarray(jgrid.zero), bits, group_size),
            device="cpu")
        assert torch.equal(qt.zero, torch.from_numpy(np.array(jgrid.zero)))


@pytest.mark.parametrize("bad", [2.5, -1.0, 16.0, float("nan")])
def test_non_integral_or_out_of_range_zero_is_refused(bad):
    codes = torch.zeros(4, 32, dtype=torch.uint8)
    scale = torch.full((4, 1), 0.1)
    zero = torch.tensor([[3.0], [bad], [0.0], [15.0]])
    with pytest.raises(ValueError, match="zero points"):
        _serve(QuantizedTensor(codes=codes, scale=scale, zero=zero, bits=4))
    with pytest.raises(ValueError, match="zero points"):
        interop.qtensor_from_jax(_as_reference_qt(codes.numpy(), scale.numpy(), zero.numpy(), 4, None),
                                 device="cpu")
    _serve(QuantizedTensor(codes=codes, scale=scale, zero=zero.nan_to_num(0.0).round().clamp(0, 15), bits=4))
