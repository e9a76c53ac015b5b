"""MoE dispatch groups (``make_plan(dispatch_groups=)``), held against the
JAX package.

* ``models.moe.moe_apply(dispatch_groups=g)`` at g ∈ {1, 2, 4}, and on a
  token count g does not divide (g falls back to 1), against the
  reference's ``moe_apply(dispatch_groups=g)`` at fp32: the output within
  1e-5 of max |y|, the router probabilities within 1e-6; with one expert
  no token picks the others overflow their per-(group, expert) capacity
  and drop copies, so the groups change the output.  The (E, g·C) slot
  table equals the reference's per-group tables exactly, and each expert's
  recorded calibration Σ (``capture_gram_stats``) the reference's within
  1e-6 of its max |Σ|: an empty slot records its group's token 0.
* A batch split over a "data" axis (a ``BatchShard`` per rank, in one
  process): where g is a multiple of the axis each rank dispatches its own
  groups with no gather of the routes; where it is not, the ranks' top-k
  ids are gathered and every rank keeps the slots of its copies.  Either
  way the ranks' outputs, side by side, are the whole batch's.
* ``prefill``, ``decode_step``, the paged prefill and decode (OLMoE) and
  ``train_loss`` on ``make_plan(cfg, dispatch_groups=2)`` of reduced fp32
  OLMoE and Jamba (one period: attention, Mamba and MoE blocks) against
  the reference's plan with the same groups: logits within 1e-5 of max
  |logit| for OLMoE and 1e-4 for Jamba (``tests/test_torch_mamba.py``'s
  bound), losses within 1e-5 relative.
* A data 2 × model 2 gloo group (``tests/_torch_dist.py``:
  ``moe_groups_rank``) trains reduced OLMoE two steps at two microbatches
  with ``Trainer(dispatch_groups=g)``, g = 2 (each data rank's block of a
  microbatch is one group) and g = 1, against the reference's
  ``make_train_step`` on ``make_plan(cfg, 2, dispatch_groups=g)``:
  ``tests/test_torch_tp_train.py``'s tolerances (losses and gradient
  norms 1e-5 relative, step-1 gradients 1e-5 of each leaf's max |g|).  No
  all-gather of the routes runs at g = 2; at g = 1 it does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch_fn as jmake_batch_fn
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import interop
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests._torch_dist import moe_groups_rank, start_group
from tests.test_torch_moe import _both, _capture, _moe_inputs, _np
from tests.test_torch_tp_families import _family_cfgs

Y_RTOL = 1e-5  # × max |y|: moe_apply at fp32
LOGIT_RTOL = {"olmoe_1b_7b": 1e-5, "jamba_1_5_large": 1e-4}  # × max |logit|
LOSS_RTOL = 1e-5  # each loss and gradient norm, relative
GRAD_RTOL = 1e-5  # × the leaf's max |g|: the step-1 gradients
KW = dict(n_experts=4, top_k=2, act="silu", gated=True, norm_topk=True)
OPT = dict(lr=1e-3, total_steps=2, warmup_steps=1)
TC = dict(steps=2, batch=4, seq=32, ckpt_every=2, log_every=1, n_microbatches=2)
TRAIN_GROUPS = (2, 1)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dead_expert", [None, 3])
@pytest.mark.parametrize("g,shape", [(1, (2, 24)), (2, (2, 24)), (4, (2, 24)), (4, (3, 10)),
                                     (2, (3, 5))])
def test_moe_apply_groups_match(g, shape, dead_expert):
    """(3, 10): 30 tokens, which 4 does not divide; (3, 5): 15, which 2 does
    not: both fall back to one group."""
    p, x = _moe_inputs(5, B=shape[0], S=shape[1], dead_expert=dead_expert)
    jp, jx, tp, tx = _both(p, x)
    jy, jprobs = jmoe.moe_apply(jp, jx, **KW, return_aux=True, dispatch_groups=g)
    ty, tprobs = tmoe.moe_apply(tp, tx, **KW, return_aux=True, dispatch_groups=g)
    jy = np.asarray(jy)
    np.testing.assert_allclose(_np(ty), jy, rtol=0, atol=Y_RTOL * np.abs(jy).max())
    np.testing.assert_allclose(_np(tprobs), np.asarray(jprobs), rtol=0, atol=1e-6)
    n = shape[0] * shape[1]
    if n % g:
        one = _np(tmoe.moe_apply(tp, tx, **KW)[0])
        assert one.tobytes() == _np(ty).tobytes()
    elif dead_expert is not None and g > 1:
        # Per-group capacity drops other copies than the whole batch's.
        assert not np.allclose(_np(tmoe.moe_apply(tp, tx, **KW)[0]), jy, rtol=0,
                               atol=Y_RTOL * np.abs(jy).max())


@pytest.mark.parametrize("g", [1, 2, 4])
def test_group_tables_are_the_references(g):
    """The (E, g·C) table: expert e's slots of group i at ``e·g·C + i·C``,
    each group's copies ranked by expert on their own, as the reference's
    per-group ``_dispatch_table``; a copy's slot in that layout."""
    E, C, per = 4, 6, 20
    ids = np.random.default_rng(g).integers(0, E, g * per).astype(np.int32)
    copy, slot = tmoe._group_tables(torch.from_numpy(ids).long(), g, E, C)
    copy, slot = _np(copy).reshape(E, g, C), _np(slot)
    for i in range(g):
        jcopy, jslot = jmoe._dispatch_table(jnp.asarray(ids[i * per:(i + 1) * per]), E, C)
        jcopy, jslot = np.asarray(jcopy).reshape(E, C), np.asarray(jslot)
        np.testing.assert_array_equal(copy[:, i], np.where(jcopy >= 0, jcopy + i * per, -1))
        s = slot[i * per:(i + 1) * per]
        kept = jslot < E * C
        np.testing.assert_array_equal(s[~kept], E * g * C)
        e, c = jslot[kept] // C, jslot[kept] % C
        np.testing.assert_array_equal(s[kept], e * g * C + i * C + c)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("dead_expert", [None, 3])
def test_expert_sigma_per_group_matches(g, dead_expert):
    p, x = _moe_inputs(6, dead_expert=dead_expert)
    jp, jx, tp, tx = _both(p, x)
    jst = _capture("jax", jp, jx, **KW, dispatch_groups=g)
    tst = _capture("torch", tp, tx, **KW, dispatch_groups=g)
    assert sorted(tst) == sorted(jst) == ["blk/w_down", "blk/w_gate", "blk/w_up"]
    for k in jst:
        js, ts = np.asarray(jst[k].sigma), _np(tst[k].sigma)
        assert ts.shape == js.shape and tst[k].n == jst[k].n
        for e in range(4):
            np.testing.assert_allclose(ts[e], js[e], rtol=0, atol=1e-6 * np.abs(js[e]).max())
    if dead_expert is not None:
        # Every slot of the dead expert is empty: C copies of each group's token 0.
        n = x.shape[0] * x.shape[1]
        cap = max(int(n // g * 2 / 4 * 1.25), 8)
        firsts = x.reshape(n, -1)[:: n // g].astype(np.float64)
        want = cap * firsts.T @ firsts
        np.testing.assert_allclose(_np(tst["blk/w_gate"].sigma[3]), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("g,d", [(2, 2), (4, 2), (1, 2), (3, 2), (6, 3)])
def test_batch_shards_route_their_groups(g, d):
    """``d`` data ranks in one process, each holding its block of the rows:
    the ranks' outputs side by side equal the whole batch's at ``g``; the
    routes are gathered only where ``g`` is not a multiple of ``d`` (g = 3
    at 2 ranks: 48 tokens in groups of 16 that straddle the ranks)."""
    p, x = _moe_inputs(7, B=6, S=8, dead_expert=3)
    tp, tx = {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)
    whole = _np(tmoe.moe_apply(tp, tx, **KW, dispatch_groups=g)[0])
    blocks = tx.chunk(d, 0)
    ids = [tmoe._route(tp["router"], b.reshape(-1, b.shape[-1]), 2, True)[2].reshape(-1)
           for b in blocks]
    gathers = []

    def gather(t):
        gathers.append(t.shape)
        return torch.cat(ids)

    parts = [_np(tmoe.moe_apply(tp, b, **KW, dispatch_groups=g,
                                batch=tmoe.BatchShard(r, d, gather=gather, psum=None))[0])
             for r, b in enumerate(blocks)]
    np.testing.assert_allclose(np.concatenate(parts), whole, rtol=0,
                               atol=Y_RTOL * np.abs(whole).max())
    assert bool(gathers) == (g % d != 0)


# ---------------------------------------------------------------------------
# The model on a grouped plan
# ---------------------------------------------------------------------------


def _grouped_pair(arch, groups=2, seed=0):
    over = {"n_periods": 1} if arch == "jamba_1_5_large" else {}
    jcfg, tcfg = _family_cfgs(arch, **over)
    jp = jmodel.make_plan(jcfg, 1, dispatch_groups=groups)
    tp = tmodel.make_plan(tcfg, dispatch_groups=groups)
    params = jmodel.init_params(jp, jax.random.PRNGKey(seed))
    return jp, params, tp, interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _close(t, j, rtol, what):
    t, j = np.asarray(t, np.float32), np.asarray(j, np.float32)
    assert t.shape == j.shape, what
    err = float(np.abs(t - j).max()) / float(np.abs(j).max())
    assert err <= rtol, (what, err)


def test_make_plan_takes_dispatch_groups():
    cfg = _family_cfgs("olmoe_1b_7b")[1]
    assert tmodel.make_plan(cfg).dispatch_groups == 1
    plan = tmodel.make_plan(cfg, 2, "int8", None, 4)
    assert (plan.axis_n, plan.kv_cache_dtype, plan.dispatch_groups) == (2, "int8", 4)
    assert dataclasses.replace(plan, cfg=cfg).dispatch_groups == 4
    with pytest.raises(ValueError, match="dispatch_groups"):
        tmodel.make_plan(cfg, dispatch_groups=0)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "jamba_1_5_large"])
def test_grouped_plan_loss_prefill_and_decode_match(arch):
    jp, params, tp, tparams = _grouped_pair(arch)
    rtol = LOGIT_RTOL[arch]
    r = np.random.default_rng(8)
    toks = r.integers(0, jp.cfg.vocab, (4, 24)).astype(np.int32)
    jl = float(jmodel.train_loss(jp, params, {"tokens": jnp.asarray(toks)}))
    tl = float(tmodel.train_loss(tp, tparams, {"tokens": toks}))
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    jlog, jc = jmodel.prefill(jp, params, {"tokens": jnp.asarray(toks[:2])},
                              jmodel.init_cache(jp, 2, 64))
    tlog, tc = tmodel.prefill(tp, tparams, {"tokens": toks[:2]},
                              tmodel.init_cache(tp, 2, 64, device="cpu"))
    _close(tlog, jlog, rtol, "prefill")
    for step in range(3):
        nxt = r.integers(0, jp.cfg.vocab, (2, 1)).astype(np.int32)
        jlog, jc = jmodel.decode_step(jp, params, jnp.asarray(nxt), jc, 24 + step)
        tlog, tc = tmodel.decode_step(tp, tparams, nxt, tc, 24 + step)
        _close(tlog, jlog, rtol, f"decode {step}")


def test_grouped_plan_paged_prefill_and_decode_match():
    jp, params, tp, tparams = _grouped_pair("olmoe_1b_7b")
    psz, rows = 8, np.array([[3, 5, 1, 7], [2, 4, 6, 0]], np.int32)
    jc, tc = jmodel.init_paged_cache(jp, 8, psz), tmodel.init_paged_cache(tp, 8, psz, device="cpu")
    r = np.random.default_rng(9)
    prompts = [r.integers(0, jp.cfg.vocab, n).astype(np.int32) for n in (21, 13)]
    for row, prompt in enumerate(prompts):
        buf = np.zeros((1, 24), np.int32)
        buf[0, : len(prompt)] = prompt
        pt = rows[row : row + 1]
        jc = jmodel.paged_prefill_chunk(jp, params, jnp.asarray(buf), jc, jnp.asarray(pt), 0)
        tc = tmodel.paged_prefill_chunk(tp, tparams, buf, tc, pt, 0)
    pos = np.array([21, 13], np.int32)
    for step in range(3):
        p = pos + step
        wp = np.array([rows[b, p[b] // psz] for b in range(2)], np.int32)
        toks = r.integers(0, jp.cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jmodel.paged_decode_step(jp, params, jnp.asarray(toks), jc, jnp.asarray(p),
                                          jnp.asarray(rows), jnp.asarray(wp))
        tl, tc = tmodel.paged_decode_step(tp, tparams, toks, tc, p, rows, wp)
        _close(tl, jl, LOGIT_RTOL["olmoe_1b_7b"], f"paged decode {step}")


# ---------------------------------------------------------------------------
# Data 2 × model 2 training with dispatch groups
# ---------------------------------------------------------------------------


def _train_case(g):
    jcfg, tcfg = _family_cfgs("olmoe_1b_7b")
    plan = tmodel.make_plan(tcfg, 2)
    params = tmodel.tree_map(lambda t: t.numpy(), tmodel.init_params(plan, 0, device="cpu"))
    return dict(jcfg=jcfg, cfg=tcfg, params=params, fsdp=False, moments="fp32", resume=None,
                opt=OPT, tc=TC, dispatch_groups=g)


def _sent(case):
    keep = ("cfg", "params", "fsdp", "moments", "resume", "opt", "tc", "dispatch_groups")
    return {k: case[k] for k in keep}


def _reference(case):
    """The reference's plan padded for 2 with the case's groups on one
    device: the step-1 loss and gradients (the mean over the microbatches),
    then ``TC["steps"]`` steps of its ``make_train_step``."""
    jcfg, n_mb = case["jcfg"], TC["n_microbatches"]
    jp = jmodel.make_plan(jcfg, 2, dispatch_groups=case["dispatch_groups"])
    params = jax.tree.map(jnp.asarray, case["params"])
    ocfg = jopt.AdamWConfig(moments="fp32", **OPT)
    batch_fn, _ = jmake_batch_fn(JDataConfig(vocab=jcfg.vocab, seed=0), jcfg, TC["batch"],
                                 TC["seq"])
    batches = [{k: jnp.asarray(v) for k, v in batch_fn(s).items()} for s in range(TC["steps"])]
    value_and_grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.train_loss(jp, p, b)))
    mbs = [{k: v.reshape(n_mb, -1, *v.shape[1:])[i] for k, v in batches[0].items()}
           for i in range(n_mb)]
    outs = [value_and_grad(params, mb) for mb in mbs]
    loss1 = sum(o[0] for o in outs) / n_mb
    g1 = jax.tree.map(lambda *gs: sum(gs) / n_mb, *[o[1] for o in outs])
    step = jax.jit(jmake_train_step(jp, ocfg, n_mb))
    opt = jopt.adamw_init(params, ocfg)
    log = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        log.append((float(m["loss"]), float(m["grad_norm"])))
    return dict(loss1=float(loss1), grads=[np.asarray(g) for g in jax.tree.leaves(g1)],
                losses=[x[0] for x in log], grad_norms=[x[1] for x in log])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_groups")
    cases = {f"g{g}": _train_case(g) for g in TRAIN_GROUPS}
    group = start_group(moe_groups_rank, 4, tmp, {k: _sent(c) for k, c in cases.items()},
                        str(tmp))
    try:
        refs = {k: _reference(c) for k, c in cases.items()}
        yield refs, group.result()
    finally:
        group.close()


@pytest.mark.parametrize("g", TRAIN_GROUPS)
def test_data_model_training_with_dispatch_groups(trained, g):
    refs, got = trained
    label = f"g{g}"
    ref = refs[label]
    for rank, out in enumerate(o[label] for o in got):
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["grad_norms"], ref["grad_norms"], rtol=LOSS_RTOL)
        assert out["loss1"] == pytest.approx(ref["loss1"], rel=LOSS_RTOL)
        for i, (a, b) in enumerate(zip(out["grads"], ref["grads"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_RTOL * np.abs(b).max() + 1e-30,
                                       err_msg=f"rank {rank} leaf {i}")
        assert out["losses"] == got[0][label]["losses"], "the ranks' losses differ"
        # The routes are gathered over "data" only where the groups straddle the ranks.
        assert (out["id_gathers"] == 0) == (g % 2 == 0), out["id_gathers"]
