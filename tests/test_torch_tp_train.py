"""Training on a "model" axis, held against the JAX package.

Three groups of gloo ranks (``tests/_torch_dist.py``: ``tp_train_rank``,
all started once for the module, beside the reference's work here) run
``Trainer(mesh=)`` three steps on reduced fp32 models, from the same whole
initial params of the padded plan (``make_plan(cfg, axis_n)``) the
reference starts from, carried across by ``interop.params_from_jax``:

* a ("model",) axis of 2: Phi-3 (GQA, 2 microbatches), OPT (biases,
  learned positions), Gemma 2 (tied embedding, softcaps, a 16-token
  window), an OLMoE- and a Mixtral-like decoder (4 experts: expert-parallel)
  and Mamba-2 with two B/C groups (16 SSD heads: head-parallel);
* a ("model",) axis of 3: the same, where the plan pads (GQA duplicated,
  MHA zero-padded, the vocabulary 256 → 258), Phi-3's and OPT's k/v are
  projected whole on every rank, OLMoE's layer is whole, the Mixtral-like
  per-expert ffn of 192 is ffn-parallel and Mamba-2 has 24 heads of 8 in
  two groups (``d_model=96``; rank 1's heads straddle the groups);
* a ("data", "model") mesh of 2 × 2: Phi-3 with ``fsdp`` false (and 2
  microbatches) and true, with fp32 and with 8-bit moments, and Jamba's
  blocks 0 and 1 (attention, Mamba and MoE; 2 microbatches: each data
  rank holds its block of each, and the MoE layer routes the whole
  microbatch as one dispatch group, as the reference's step does).

Held against the reference's ``make_train_step(make_plan(cfg, axis_n))``
on one device: each step's loss and gradient norm within 1e-5 relative;
the step-1 gradient of every leaf, gathered, within 1e-5 of the leaf's max
|g| (a missing or doubled sum over the axis shows there); the final params
off the reference's by at most UPDATE_RTOL of how far it moved them
(measured: losses 2.6e-7, gradient norms 9.1e-7, step-1 gradients 5.1e-6
of max |g| (Jamba), final params 4.8e-5 of the movement with fp32 moments
and 1.7e-4 with 8-bit ones: AdamW's m/√v amplifies the gradients'
reduction order where they are small).  The
ranks' losses are the same bits, and so is every leaf a rank holds whole
on "model" before each step and after the run.  The checkpoint the ranks
write is read bit for bit by ``repro.dist.checkpoint.load_checkpoint`` and
by the port's loader on the padded plan (the one-rank ``Trainer`` where
the axis pads nothing); ``restore`` gives each rank back its blocks; a run
stopped and resumed on the ranks ends with the uninterrupted run's bits.
Each collective of ``dist.collectives`` is held forward and backward on 2
and 3 ranks against one-rank autograd, and under ``torch.no_grad()`` to
the bits of the plain calls.  Without ranks: the training rules equal the
reference trainer's table at every architecture and axis but for the two
entries the port passes on purpose (``ROADMAP.md`` §3), a tree's layout
over both axes, and the encoder-decoder and prefix families' trainers
built on a model axis (their parity: ``tests/test_torch_tp_encdec.py``).
"""

import concurrent.futures
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch_fn as jmake_batch_fn
from repro.dist import checkpoint as jckpt
from repro.dist.sharding import make_rules as jmake_rules
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config as tget
from repro_torch.dist import checkpoint as tckpt
from repro_torch.dist import sharding as tsharding
from repro_torch.models import model as tmodel
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
from repro_torch.train.optimizer import adamw_init, moment_axes
from repro_torch.train.trainer import train_rules
from repro_torch.tree import tree_flatten, tree_leaves
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests._torch_dist import collective_inputs, start_group, tp_train_rank, tree_bits
from tests.conftest import reduce_cfg
from tests.test_torch_tp_families import MAMBA3_G2, _family_cfgs

LOSS_RTOL = 1e-5  # each step's loss and gradient norm, relative
GRAD_RTOL = 1e-5  # × the leaf's max |g|: the step-1 gradients
UPDATE_RTOL = 1e-3  # × how far the reference moved the params
OPT = dict(lr=1e-3, total_steps=3, warmup_steps=1)
TC = dict(steps=3, batch=4, seq=32, ckpt_every=3, log_every=1)
AXES = (1, 2, 3, 4, 16)

# group: (mesh dims, ranks, cases); a case: (label, arch, config overrides,
# fsdp, moments, microbatches, steps after which a second run resumes)
GROUPS = {
    "model2": (("model",), 2, [
        ("phi3", "phi3_mini_3_8b", {}, False, "fp32", 2, None),
        ("opt", "opt_125m", {"n_kv_heads": 4}, False, "fp32", 1, None),
        ("gemma2", "gemma2_27b", {}, False, "fp32", 1, None),
        ("olmoe", "olmoe_1b_7b", {}, False, "fp32", 1, None),
        ("mixtral", "mixtral_8x22b", {}, False, "fp32", 1, None),
        ("mamba_g2", "mamba2_2_7b", {"ssm_ngroups": 2}, False, "fp32", 1, None),
    ]),
    "model3": (("model",), 3, [
        ("phi3", "phi3_mini_3_8b", {}, False, "fp32", 1, 2),
        ("opt", "opt_125m", {"n_kv_heads": 4}, False, "fp32", 1, None),
        ("gemma2", "gemma2_27b", {}, False, "fp32", 1, None),
        ("olmoe_whole", "olmoe_1b_7b", {}, False, "fp32", 1, None),
        ("mixtral_ffn", "mixtral_8x22b", {"moe_d_ff": 192}, False, "fp32", 1, None),
        ("mamba_g2", "mamba2_2_7b", MAMBA3_G2, False, "fp32", 1, None),
    ]),
    "data2_model2": (("data", "model"), 4, [
        ("phi3", "phi3_mini_3_8b", {}, False, "fp32", 2, None),
        ("phi3_fsdp", "phi3_mini_3_8b", {}, True, "fp32", 1, 2),
        ("phi3_fsdp_int8", "phi3_mini_3_8b", {}, True, "int8", 1, None),
        ("jamba", "jamba_1_5_large", {"n_periods": 1, "blocks": (0, 1)}, False, "fp32", 2, None),
    ]),
}


def _model_n(group: str) -> int:
    dims, world, _ = GROUPS[group]
    return world // 2 if len(dims) == 2 else world


def _case(group, label, arch, over, fsdp, moments, n_mb, resume):
    """One case: both packages' configs, the whole initial params of the
    padded plan (the port's seeded init, as numpy), and what a rank needs."""
    over = dict(over)
    blocks = over.pop("blocks", None)
    jcfg, tcfg = _family_cfgs(arch, blocks=blocks, **over)
    plan = tmodel.make_plan(tcfg, _model_n(group))
    params = tmodel.tree_map(lambda t: t.numpy(), tmodel.init_params(plan, 0, device="cpu"))
    return dict(jcfg=jcfg, cfg=tcfg, params=params, fsdp=fsdp, moments=moments, resume=resume,
                opt=OPT, tc=dict(TC, n_microbatches=n_mb),
                ref_key=(arch, tuple(sorted(over.items())), blocks, _model_n(group), moments, n_mb))


def _sent(case):
    """What a rank needs (torch and numpy only: a rank loads no JAX)."""
    return {k: case[k] for k in ("cfg", "params", "fsdp", "moments", "resume", "opt", "tc")}


def _reference(case):
    """The reference's padded plan on one device: the step-1 loss and
    gradients (``value_and_grad`` of ``train_loss``, the mean over the
    microbatches), then ``TC["steps"]`` steps of its ``make_train_step`` on
    the seeded batches."""
    jcfg, n_mb = case["jcfg"], case["tc"]["n_microbatches"]
    jp = jmodel.make_plan(jcfg, case["ref_key"][3])
    params = jax.tree.map(jnp.asarray, case["params"])
    ocfg = jopt.AdamWConfig(moments=case["moments"], **OPT)
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
                losses=[x[0] for x in log], grad_norms=[x[1] for x in log],
                params=[np.asarray(p) for p in jax.tree.leaves(params)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group's ranks start first; the reference's runs (one a distinct
    padded plan, moments and microbatch count) compile and run on three
    threads meanwhile."""
    tmp = tmp_path_factory.mktemp("tp_train")
    cases = {g: {c[0]: _case(g, *c) for c in spec[2]} for g, spec in GROUPS.items()}
    groups = {}
    try:
        for g, (dims, world, _) in GROUPS.items():
            groups[g] = start_group(tp_train_rank, world, tmp, {k: _sent(c) for k, c in
                                                                cases[g].items()},
                                    str(tmp / g), dims)
        firsts = {}
        for g in cases:
            for c in cases[g].values():
                firsts.setdefault(c["ref_key"], c)
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            refs = dict(zip(firsts, pool.map(_reference, firsts.values())))
        yield dict(cases=cases, refs=refs, groups=groups, tmp=tmp)
    finally:
        for grp in groups.values():
            grp.close()


def _got(runs, group):
    return runs["groups"][group].result()


def _labels():
    return [(g, c[0]) for g, spec in GROUPS.items() for c in spec[2]]


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def _one_rank_collectives(world: int) -> dict:
    """What each collective must give on each rank, by autograd on one
    process over every rank's inputs: ``{name: [(forward, grad) a rank]}``."""
    ins = [{k: torch.from_numpy(v) for k, v in collective_inputs(world, r).items()}
           for r in range(world)]
    x = ins[0]["x"].repeat(1, world).requires_grad_(True)
    sum(((x * a["w"]).sum() for a in ins), torch.zeros(())).backward()
    copy = [(x.detach().numpy(), x.grad.numpy())] * world
    ws = torch.stack([a["w"] for a in ins]).requires_grad_(True)
    (ws.sum(0) * ins[0]["v"]).sum().backward()
    reduce = [(ws.sum(0).detach().numpy(), ws.grad[r].numpy()) for r in range(world)]
    parts = torch.stack([a["part"] for a in ins]).requires_grad_(True)
    whole = torch.cat(list(parts), -1)
    (whole * ins[0]["v"]).sum().backward()
    gather = [(whole.detach().numpy(), parts.grad[r].numpy()) for r in range(world)]
    parts.grad = None
    whole = torch.cat(list(parts), 1)
    sum(((whole * a["w"]).sum() for a in ins), torch.zeros(())).backward()
    gather_grad = [(whole.detach().numpy(), parts.grad[r].numpy()) for r in range(world)]
    top = torch.stack([a["w"] for a in ins]).amax(0).numpy()
    return {"copy_to": copy, "reduce_from": reduce, "gather_from": gather,
            "gather_dim_grad": gather_grad, "max_over": [(top, False)] * world}


@pytest.mark.parametrize("name", ["copy_to", "reduce_from", "gather_from", "gather_dim_grad",
                                  "max_over"])
@pytest.mark.parametrize("group", ["model2", "model3"])
def test_collectives_match_one_rank_autograd(runs, group, name):
    got = _got(runs, group)
    want = _one_rank_collectives(len(got))[name]
    for rank, out in enumerate(o["collectives"][name] for o in got):
        fwd, grad = want[rank]
        np.testing.assert_allclose(out[0], fwd, rtol=1e-6, atol=1e-6, err_msg=f"rank {rank}")
        if name == "max_over":
            assert out[1] is False
        else:
            np.testing.assert_allclose(out[1], grad, rtol=1e-6, atol=1e-6, err_msg=f"rank {rank}")


@pytest.mark.parametrize("group", ["model2", "model3"])
def test_collectives_under_no_grad_are_the_plain_calls(runs, group):
    for out in _got(runs, group):
        assert out["collectives"]["no_grad_bits"] == dict.fromkeys(
            ("copy_to", "reduce_from", "gather_from"), True)


# ---------------------------------------------------------------------------
# Training against the reference's padded plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group,label", _labels())
def test_tp_losses_and_grad_norms_match_the_padded_reference(runs, group, label):
    ref = runs["refs"][runs["cases"][group][label]["ref_key"]]
    got = [o[label] for o in _got(runs, group)]
    r0 = got[0]
    assert len(r0["losses"]) == TC["steps"]
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(r0[key], ref[key], rtol=LOSS_RTOL, atol=0, err_msg=key)
    np.testing.assert_allclose(r0["loss1"], ref["loss1"], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(r0["losses"][0], ref["loss1"], rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("group,label", _labels())
def test_tp_step_one_gradients_match_leaf_by_leaf(runs, group, label):
    ref = runs["refs"][runs["cases"][group][label]["ref_key"]]
    grads = _got(runs, group)[0][label]["grads"]
    assert len(grads) == len(ref["grads"])
    for i, (g, want) in enumerate(zip(grads, ref["grads"])):
        assert g.shape == want.shape, i
        np.testing.assert_allclose(g, want, rtol=0, atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("group,label", _labels())
def test_tp_final_params_within_the_update_tolerance(runs, group, label):
    case = runs["cases"][group][label]
    ref = runs["refs"][case["ref_key"]]
    got = _got(runs, group)[0][label]["params"]
    init = tree_leaves(case["params"])
    assert len(got) == len(ref["params"]) == len(init)
    off = np.sqrt(sum(np.sum((a - b) ** 2, dtype=np.float64) for a, b in zip(got, ref["params"])))
    moved = np.sqrt(sum(np.sum((b - c) ** 2, dtype=np.float64)
                        for b, c in zip(ref["params"], init)))
    assert moved > 0 and off <= UPDATE_RTOL * moved, (off, moved, off / moved)


@pytest.mark.parametrize("group,label", _labels())
def test_tp_ranks_agree_bit_for_bit(runs, group, label):
    """Every rank logs the same losses and gradient norms and gathers the
    same whole state; the ranks of one data coordinate hold the same bits
    of every leaf whole on "model" before each step and after the run."""
    got = [o[label] for o in _got(runs, group)]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"] and r["grad_norms"] == got[0]["grad_norms"]
        assert r["loss1"] == got[0]["loss1"] and r["whole"] == got[0]["whole"]
    peers = {}
    for r in got:
        assert len(r["peers"]) == TC["steps"] + 1
        peers.setdefault(r["coord"][:-1], []).append(r["peers"])
    for coord, runs_ in peers.items():
        assert len(runs_) == _model_n(group) and all(p == runs_[0] for p in runs_), coord
    # The model axis cuts every case; FSDP cuts on "data" too.
    case = runs["cases"][group][label]
    assert got[0]["sharded"]["model"]
    assert bool(got[0]["sharded"].get("data")) == case["fsdp"]


def _padded_template(case, model_n):
    plan = tmodel.make_plan(case["cfg"], model_n)
    params = tmodel.empty_params(plan, device="cpu")
    return {"params": params, "opt": adamw_init(params, AdamWConfig(moments=case["moments"]))}


@pytest.mark.parametrize("group,label", _labels())
def test_tp_checkpoint_reads_in_both_packages(runs, group, label):
    """The checkpoint holds the run's whole padded-plan state: the
    reference's loader and the port's read the bits the ranks gathered; where
    the axis pads nothing the one-rank ``Trainer`` restores them too."""
    case, n = runs["cases"][group][label], _model_n(group)
    d = str(runs["tmp"] / group / label)
    whole = _got(runs, group)[0][label]["whole"]
    assert tckpt.latest_step(d) == TC["steps"]
    state, manifest = tckpt.load_checkpoint(d, _padded_template(case, n))
    assert manifest["step"] == TC["steps"] and tree_bits(state) == whole
    jparams = jax.tree.map(jnp.asarray, case["params"])
    like = {"params": jparams, "opt": jopt.adamw_init(jparams, jopt.AdamWConfig(
        moments=case["moments"]))}
    jstate, _ = jckpt.load_checkpoint(d, like)
    assert b"".join(np.ascontiguousarray(x).tobytes() for x in jax.tree.leaves(jstate)) == whole
    shapes = lambda plan: [tuple(t.shape) for t in tree_leaves(tmodel.param_shapes(plan))]
    pads = shapes(tmodel.make_plan(case["cfg"], n)) != shapes(tmodel.make_plan(case["cfg"]))
    assert pads == (group == "model3")
    if not pads:
        tr = Trainer(case["cfg"], AdamWConfig(moments=case["moments"], **OPT),
                     TrainerConfig(ckpt_dir=d, **case["tc"]), device="cpu")
        assert tr.restore() == TC["steps"]
        assert tree_bits({"params": tr.params, "opt": tr.opt_state}) == whole


@pytest.mark.parametrize("group", list(GROUPS))
def test_tp_restore_and_resume_are_bit_for_bit(runs, group):
    got = _got(runs, group)
    for label, case in runs["cases"][group].items():
        for rank, o in enumerate(got):
            assert o[label]["restored"], (label, rank)
            if case["resume"]:
                assert o[label]["resumed"], (label, rank)


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("axis_n", AXES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_rules_are_the_reference_trainers_but_two_entries(arch, axis_n, fsdp):
    """``train_rules`` against the reference trainer's ``make_rules`` call
    (``src/repro/train/trainer.py``: padded heads, kv heads, ffn, experts,
    padded vocabulary, d_model, fsdp) on a data 2 × model ``axis_n`` mesh:
    equal but where the port passes the per-expert ffn and the SSD heads."""
    jp, tp = jmodel.make_plan(jget(arch), axis_n), tmodel.make_plan(tget(arch), axis_n)
    sizes = {"data": 2, "model": axis_n}
    cfg = jp.cfg
    want = jmake_rules(types.SimpleNamespace(shape=sizes), n_heads=jp.heads.h_pad,
                       n_kv_heads=jp.heads.n_kv, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
                       vocab=jp.vocab_pad, d_model=cfg.d_model, fsdp=fsdp).table
    got = train_rules(tp, sizes, fsdp).table
    assert sorted(got) == sorted(want)
    fits = lambda n: n > 0 and n % axis_n == 0
    expected = set()
    if cfg.moe_ff and not fits(cfg.n_experts) and not fits(cfg.moe_ff):
        assert (want["expert_ffn"], got["expert_ffn"]) == ("model", None)
        expected.add("expert_ffn")
    if fits(cfg.ssm_nheads):
        assert (want["ssm_heads"], got["ssm_heads"]) == (None, "model")
        expected.add("ssm_heads")
    assert {k for k in got if got[k] != want[k]} == expected


def test_tree_shards_lay_a_leaf_out_on_both_axes():
    """With ``fsdp`` on a data 2 × model 2 mesh ``wq`` (embed, heads, ·, ·)
    is cut on "data" at dim 1 (behind "layers") and on "model" at dim 2;
    the moments follow their params, an 8-bit moment's row grid drops the
    last dim; ``cuts`` lists the data dim first."""
    cfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b")), dtype=torch.float32)
    plan = tmodel.make_plan(cfg, 2)
    sizes = {"data": 2, "model": 2}
    rules = train_rules(plan, sizes, fsdp=True)
    axes = tmodel.param_axes(plan)
    shards = rules.tree_shards(axes)
    flat = tree_flatten(axes, is_leaf=lambda x: isinstance(x, tuple))[0]
    leaf = {tuple(a): i for i, a in enumerate(flat)}
    i = leaf[("layers", "embed", "heads", None, None)]
    assert (shards.dims[i], shards.model_dims[i]) == (1, 2)
    i = leaf[("vocab", "embed")]
    assert (shards.dims[i], shards.model_dims[i]) == (1, 0)
    assert [a for a, _ in shards.cuts()] == ["data", "model"]
    opt = rules.tree_shards(moment_axes(tmodel.param_shapes(plan), axes,
                                        AdamWConfig(moments="int8")))
    assert len(opt.dims) == len(opt.model_dims) > len(shards.dims)
    one = tsharding.make_rules({"data": 2}, d_model=cfg.d_model, fsdp=True).tree_shards(axes)
    assert one.model_dims is None and [a for a, _ in one.cuts()] == ["data"]


@pytest.mark.parametrize("arch", ["whisper_large_v3", "llava_next_34b"])
def test_trainer_refuses_encdec_and_prefix_families_on_a_model_axis(arch):
    """The encoder-decoder and prefix families refused ``Trainer(mesh=)``
    with a model axis until ROADMAP item 8.1.4 lifted it: on a stub
    ("data", "model") mesh of 1 × 2 the trainer builds, pads the plan for
    the axis and holds its rank's shard of every leaf, the encoder's and
    the cross-attention's heads cut and ``prefix_ln``/``enc_pos_emb`` whole
    (their training on ranks: ``tests/test_torch_tp_encdec.py``)."""
    cfg = dataclasses.replace(reduce_cfg(tget(arch)), dtype=torch.float32)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2),
                                 get_local_rank=lambda axis: 1 if axis == "model" else 0,
                                 get_group=lambda axis: None)
    tr = Trainer(cfg, AdamWConfig(), TrainerConfig(steps=1, batch=1, seq=8), mesh=mesh,
                 device="cpu")
    assert tr.plan.axis_n == 2 and tr.shards.model_dims is not None
    whole = tmodel.param_shapes(tr.plan)
    stack = "enc" if cfg.family == "encdec" else "dec"
    assert tr.params[stack]["b0"]["wq"].shape[2] == whole[stack]["b0"]["wq"].shape[2] // 2
    for key in ("enc_pos_emb", "prefix_ln"):
        if key in whole:
            got = tree_leaves(tr.params[key])
            assert [t.shape for t in got] == [t.shape for t in tree_leaves(whole[key])]
    if cfg.family == "encdec":
        assert tr.params["dec"]["b0"]["wo_c"].shape[1] == whole["dec"]["b0"]["wo_c"].shape[1] // 2
    assert tr.params["embed"].shape[0] == tr.plan.vocab_pad // 2
