"""Port parity for the dense decoder: the reference's params carried across
with ``repro_torch.interop`` give the same hidden states and loss (fp32,
rtol 1e-4: attention and norms reassociate), and a quantized linear applies
the same function."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.eval import scorer as jscorer
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.models import model as jmodel
from repro.models.common import apply_linear as japply
from repro.quant import GridSpec as JSpec
from repro.quant import pack_codes as jpack
from repro.quant import quantize_tensor as jquantize_tensor
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.models import model as tmodel
from repro_torch.models.common import apply_linear as tapply
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401


def _pair(dtype_j=jnp.float32, dtype_t=torch.float32, **over):
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b"), **over), dtype=dtype_j)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b"), **over), dtype=dtype_t)
    jp = jplan(jcfg, 1)
    params = jinit(jp, jax.random.PRNGKey(0))
    # Non-trivial norm scales so the (1 + scale) convention is exercised.
    params["final_norm"]["scale"] = params["final_norm"]["scale"] + 0.01
    for ln in ("ln", "ln2"):
        params["dec"]["b0"][ln]["scale"] = params["dec"]["b0"][ln]["scale"] - 0.02
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    return jp, params, tmodel.make_plan(tcfg), tparams


def _tokens(vocab, seed=0, shape=(2, 48)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_plan_and_param_shapes_match():
    jp, params, tp, tparams = _pair()
    assert (tp.heads.kv_pad, tp.heads.g_pad) == (jp.heads.kv_pad, jp.heads.g_pad)
    jshapes = jax.tree.map(lambda a: tuple(a.shape), params)
    tshapes = tmodel.tree_map(lambda a: tuple(a.shape), tmodel.init_params(tp, 0, device="cpu"))
    assert tshapes == jshapes


@pytest.mark.parametrize("n_kv", [2, 4])
def test_hidden_states_and_loss_match(n_kv):
    jp, params, tp, tparams = _pair(n_kv_heads=n_kv)
    toks = _tokens(jp.cfg.vocab)
    jh = np.asarray(jscorer._hidden_states(jp, params, jnp.asarray(toks)))
    th = tmodel.hidden_states(tp, tparams, torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(th, jh, rtol=1e-4, atol=1e-5)
    jl = float(jmodel.train_loss(jp, params, {"tokens": jnp.asarray(toks)}))
    tl = float(tmodel.train_loss(tp, tparams, {"tokens": toks}))
    assert tl == pytest.approx(jl, rel=1e-4)


def test_bf16_params_carry_bit_for_bit():
    jp, params, tp, tparams = _pair(dtype_j=jnp.bfloat16, dtype_t=torch.bfloat16)
    jw = np.asarray(params["dec"]["b0"]["wq"])
    tw = tparams["dec"]["b0"]["wq"]
    assert tw.dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.view(torch.int16).numpy(), jw.view(np.int16))
    loss = float(tmodel.train_loss(tp, tparams, {"tokens": _tokens(jp.cfg.vocab)}))
    assert np.isfinite(loss)


@pytest.mark.parametrize("group_size", [None, 32])
@pytest.mark.parametrize("packed", [False, True])
def test_apply_linear_on_quantized_tensor(group_size, packed):
    r = np.random.default_rng(1)
    w = r.standard_normal((64, 48)).astype(np.float32)  # (out, in)
    x = r.standard_normal((2, 5, 48)).astype(np.float32)
    qt = jquantize_tensor(jnp.asarray(w), JSpec(bits=4, group_size=group_size))
    if packed:
        qt = dataclasses.replace(qt, codes=jpack(qt.codes, 4), packed=True)
    jy = np.asarray(japply(qt, jnp.asarray(x)))
    ty = tapply(interop.qtensor_from_jax(jax.tree.map(np.asarray, qt), device="cpu"), torch.from_numpy(x)).numpy()
    assert ty.shape == jy.shape == (2, 5, 64)
    np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-5)


def test_init_params_seeded_and_scaled():
    tp = tmodel.make_plan(reduce_cfg(tget("phi3_mini_3_8b")))
    a = tmodel.init_params(tp, 3, device="cpu")
    b = tmodel.init_params(tp, 3, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert a["embed"].dtype == torch.bfloat16
    std = a["dec"]["b0"]["wq"].float().std().item()
    assert 0.015 < std < 0.025
    assert float(a["dec"]["b0"]["ln"]["scale"].abs().max()) == 0.0
