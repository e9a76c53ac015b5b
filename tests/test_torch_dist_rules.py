"""The port's sharding rules, logical axes and the small names of the
data-parallel slice, held against the JAX package (no process group).

* ``make_rules`` / ``Rules.spec``: entry for entry the reference's, for
  every config and every leaf's logical axes, on the meshes
  ``{data 16, model 16}``, ``{pod 2, data 16, model 16}``, ``{data 4}`` and
  ``{data 1, model 1}``, with ``fsdp`` true and false (both packages read
  only the mesh's axis sizes: a stub whose ``.shape`` is a dict);
* ``param_axes`` / ``param_shapes`` and ``moment_axes`` (fp32 and 8-bit
  moments): the reference's trees, exactly;
* ``Rules.placements``, ``logical_constraint``, ``make_data_mesh`` without
  a process group;
* ``rtn_quantize`` (exact), ``kernels.ref.gram_ref`` (1e-6 relative) and
  ``capture_linear_inputs`` (fp32 1e-5 of max |x|) against the reference.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import list_configs
from repro.core import rtn_quantize as jrtn
from repro.dist import sharding as jsharding
from repro.kernels import ref as jref
from repro.models import common as jcommon
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.models import model as jmodel
from repro.quant import GridSpec as JSpec
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.core import rtn_quantize as trtn
from repro_torch.dist import sharding as tsharding
from repro_torch.kernels import ref as tref
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.quant import GridSpec as TSpec
from repro_torch.train import optimizer as topt
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests.conftest import reduce_cfg

CONFIGS = list_configs() + ["opt_125m", "opt_350m", "opt_1_3b", "opt_6_7b", "opt_66b"]
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}, {"data": 4},
          {"data": 1, "model": 1})


def _is_axes(x):
    return isinstance(x, tuple)


def _rules_args(plan):
    cfg = plan.cfg
    return dict(n_heads=plan.heads.h_pad, n_kv_heads=plan.heads.n_kv, head_dim=cfg.hd,
                d_ff=cfg.d_ff, n_experts=cfg.n_experts, vocab=plan.vocab_pad,
                d_model=cfg.d_model, moe_ff=cfg.moe_ff, ssm_heads=cfg.ssm_nheads)


@pytest.mark.parametrize("name", CONFIGS)
def test_rules_spec_match_the_reference(name):
    """Sizes from the reference's plan on each mesh's model axis (its head
    padding), given to both packages."""
    leaves = None
    for shape in MESHES:
        jp = jplan(jget(name), shape.get("model", 1))
        axes = jax.tree.leaves(jmodel.param_axes(jp), is_leaf=_is_axes)
        leaves = sorted(set(axes) | {("batch", None), ("seq_sp",), ("cache_seq", "kv_heads")},
                        key=str)
        for fsdp in (False, True):
            kw = dict(_rules_args(jp), fsdp=fsdp)
            jr = jsharding.make_rules(types.SimpleNamespace(shape=shape), **kw)
            tr = tsharding.make_rules(shape, **kw)
            assert tr.table == jr.table, (shape, fsdp)
            for ax in leaves:
                assert tr.spec(ax) == tuple(jr.spec(ax)), (shape, fsdp, ax)
    assert leaves


def test_placements_and_shard_dims():
    from torch.distributed.tensor import Replicate, Shard

    r = tsharding.make_rules({"pod": 2, "data": 4, "model": 2}, n_heads=8, d_model=64, fsdp=True)
    assert r.placements(("batch", None)) == (Shard(0), Shard(0), Replicate())
    assert r.placements(("layers", "heads", None, "embed")) == (Replicate(), Shard(3), Shard(1))
    assert r.placements(("embed", "embed")) == (Replicate(), Shard(0), Replicate())
    assert r.shard_dim(("layers", "heads", None, "embed")) == 3
    assert r.shard_dim(("layers", "heads")) is None and r.shard_dim(("batch",)) == 0
    assert tsharding.mesh_axis_size({"pod": 2, "data": 4}, ("pod", "data", "model")) == 8


@pytest.mark.parametrize("name", CONFIGS)
def test_param_axes_shapes_and_moment_axes_match_the_reference(name):
    jp, tp = jplan(jget(name), 1), tmodel.make_plan(tget(name))
    jaxes, taxes = jmodel.param_axes(jp), tmodel.param_axes(tp)
    assert taxes == jaxes
    jshapes = jmodel.param_shapes(jp)
    tshapes = tmodel.param_shapes(tp)
    assert jax.tree.structure(jshapes) == jax.tree.structure(
        tmodel.tree_map(lambda t: 0, tshapes))
    for j, t in zip(jax.tree.leaves(jshapes), jax.tree.leaves(tmodel.tree_map(lambda t: t, tshapes),
                                                             is_leaf=torch.is_tensor)):
        assert tuple(t.shape) == tuple(j.shape) and t.device.type == "meta"
        assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype, j.dtype)
    for moments in ("fp32", "int8"):
        jm = jopt.moment_axes(jshapes, jaxes, jopt.AdamWConfig(moments=moments))
        tm = topt.moment_axes(tshapes, taxes, topt.AdamWConfig(moments=moments))
        assert tm == jm, moments


def test_logical_constraint_and_the_data_mesh_without_a_group():
    x = torch.ones(3, 4)
    assert tsharding.logical_constraint(x, ("batch", None)) is x
    with tsharding.axis_rules(tsharding.make_rules({"data": 2})) as rules:
        assert tsharding.current_rules() is rules
        assert tsharding.logical_constraint(x, ("batch", None)) is x
    assert tsharding.current_rules() is None
    # Under explicit collectives a rank's tensor already is its shard, on a
    # "model" axis too; the tensor-parallel forward needs the axis' process
    # group, which a {name: size} mapping has not.
    with tsharding.axis_rules(tsharding.make_rules({"data": 2, "model": 2})):
        assert tsharding.logical_constraint(x, ("batch", "heads")) is x
        with pytest.raises(ValueError, match="DeviceMesh"):
            tsharding.model_axis()
    assert tsharding.model_axis() is None
    assert make_data_mesh(device="cpu") is None and make_data_mesh(1, device="cpu") is None


@pytest.mark.parametrize("bits", [3, 4])
def test_rtn_quantize_matches_the_reference(bits):
    w = np.random.default_rng(bits).standard_normal((24, 40)).astype(np.float32)
    want = np.asarray(jrtn(jnp.asarray(w), JSpec(bits=bits, group_size=8)))
    got = trtn(torch.from_numpy(w), TSpec(bits=bits, group_size=8)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gram_ref_matches_the_reference():
    x = np.random.default_rng(5).standard_normal((32, 100)).astype(np.float32)
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jref.gram_ref(jnp.asarray(x).astype(dt_j)))
        got = tref.gram_ref(torch.from_numpy(x).to(dt_t)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_capture_linear_inputs_matches_the_reference():
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b")), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b")), dtype=torch.float32)
    jp, tp = jplan(jcfg, 1), tmodel.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(2))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    jblk = jax.tree.map(lambda a: a[0], params["dec"]["b0"])
    tblk = tmodel.period_slice(tparams["dec"], 0)["b0"]
    jrec, trec = {}, {}
    with jcommon.capture_linear_inputs(jrec), jcommon.capture_scope("dec.p0.b0"):
        jmodel._block_apply(jcfg, jp.heads, jcfg.pattern[0], jblk, jnp.asarray(x), mode="train",
                            pos_ids=jnp.arange(16))
    with tcommon.capture_linear_inputs(trec), tcommon.capture_scope("dec.p0.b0"):
        tmodel._block_apply(tcfg, tp.heads, tcfg.pattern[0], tblk, torch.from_numpy(x),
                            mode="train", pos_ids=torch.arange(16))
    assert sorted(trec) == sorted(jrec) and len(trec) == 7
    for k in jrec:
        assert len(trec[k]) == len(jrec[k]) == 1
        want = np.asarray(jrec[k][0])
        got = trec[k][0].numpy()
        assert got.shape == want.shape == (32, got.shape[-1])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
