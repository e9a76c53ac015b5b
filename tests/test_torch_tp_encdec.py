"""The encoder-decoder (Whisper) and prefix (LLaVA) families on a "model"
axis, held against the JAX package.

Reduced models (``tests.test_torch_tp._cfgs``: ``reduce_cfg`` with
``head_dim=24`` and ``d_ff=192``, so 2 and 3 ranks split them; 2 encoder
and 2 decoder periods, equal, as the reference's encoder scan needs: ROADMAP
§3), the reference's padded plan (``make_plan(cfg, axis_n)``) on one device
against the port's ranks (``tests/_torch_dist.py``: one group a world size
for the serving cases, one a mesh for the training cases, all started once
for the module, beside the reference's work here):

* Serving on 2 and 3 ranks: Whisper as reduced (GQA 4/2: at 3 the kv slots
  are duplicated to 6 and ``wk``/``wv`` are cut on ``head_dim``, their
  outputs gathered), Whisper MHA (``n_kv_heads=4``: at 3 zero-padded to 6
  slots), Whisper at bf16, LLaVA (the same plans; at 3 the vocabulary pads
  256 → 258), dense, and Whisper's and LLaVA's packed 4-bit per-channel
  artifacts of the reference's quantizer restacked as the reference does
  (a dense encoder); each rank's shard (``shard_tree`` under
  ``serving_rules``) prefills the same tokens with their frames or patches:
  prefill logits within 1e-5 of max |logit| at fp32 (2e-2 at bf16); one
  decode step from the reference prefill's cache, sharded by
  ``cache_axes``, within the same bound (1e-4 where a written bf16 entry
  rounds apart, ``tests.test_torch_tp._decode_rtol``); each rank's cross
  caches ``ck``/``cv`` its slots of the reference's, within one bf16 ulp of
  max |·| at fp32 (the reference rounds them to bf16 too); three greedy
  steps from the rank's own prefill, logits within 1e-4 of each step's max
  |logit| (2e-2 at bf16) and tokens equal up to the first top-2 margin
  under twice that; each rank's storage exactly its shard; its local
  artifact saved and loaded by ``dist.checkpoint`` bit for bit; one decode
  step's collectives counted: the embedding's all-reduce, one a layer for
  ``wo``, ``wo_c`` and ``wd``, the logits' gather, and at 3 the gathers of
  the self-attention k/v.
* A Whisper artifact whose ``"enc"`` is quantized too (the port's restack
  with ``solver_qt_enc``, which the reference cannot run) is held to the
  same bounds against the port's own one-rank padded plan, which
  ``tests/test_torch_encdec.py`` holds to the reference.
* Training by ``Trainer(mesh=)``: a ("model",) axis of 2 (Whisper with 2
  microbatches, LLaVA), of 3 (Whisper, stopped and resumed; Whisper MHA;
  LLaVA) and a ("data", "model") mesh of 2 × 2 (Whisper with 2
  microbatches, LLaVA with ``fsdp``), from the whole params the reference
  starts from, against its ``make_train_step``: losses and gradient norms
  within 1e-5 relative, the step-1 gradient of every leaf (the encoder's,
  ``enc_pos_emb``'s, the cross-attention's and ``prefix_ln``'s included),
  gathered, within 1e-5 of its max |g|, the final params within 1e-3 of how
  far the reference moved them, the ranks' losses and the leaves they hold
  whole the same bits, restore and resume bit for bit
  (``tests/test_torch_tp_train.py``'s rules).
* Without ranks: the full-width shards of both models at 2 (every leaf's
  local shape on the meta device), each data coordinate's rows of the
  frames and patches going with its tokens, and the reference-restacked
  artifact's axes.
"""

import concurrent.futures
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.dist import sharding as tsharding
from repro_torch.models import model as tmodel
from repro_torch.quant import QuantizedTensor
from repro_torch.serve import qparams as tqparams
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
from repro_torch.train.trainer import train_rules
from repro_torch.tree import tree_leaves
from tests import test_torch_tp_train as tt
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests._torch_dist import start_group, tp_rank, tp_serve, tp_train_rank
from tests.test_torch_tp import (BF16, BF16_RTOL, ENGINE_RTOL, FP32_RTOL, _agree, _cfgs,
                                 _decode_rtol, _expected_bytes, _rtn_artifact)

CACHE_TOL = 2.0 ** -8  # one bf16 ulp of max |·|: the bf16 cross caches of an fp32 model
GREEDY = 3  # greedy decode steps after the prefill
WHISPER, LLAVA = "whisper_large_v3", "llava_next_34b"

# (label, arch, config overrides, dtype, artifact): "dense", "rtn4" (the
# reference's RTN of the decoder, its encoder dense), "rtn4_enc" (both
# stacks; the port's one-rank run is the baseline)
SERVE_CASES = [
    ("whisper", WHISPER, {}, None, "dense"),
    ("whisper_rtn4", WHISPER, {}, None, "rtn4"),
    ("whisper_mha", WHISPER, {"n_kv_heads": 4}, None, "dense"),
    ("whisper_bf16", WHISPER, {}, BF16, "dense"),
    ("whisper_qenc", WHISPER, {}, None, "rtn4_enc"),
    ("llava", LLAVA, {}, None, "dense"),
    ("llava_rtn4", LLAVA, {}, None, "rtn4"),
]

# group: (mesh dims, ranks, cases); a case: (label, arch, config overrides,
# fsdp, moments, microbatches, steps after which a second run resumes)
TRAIN_GROUPS = {
    "model2": (("model",), 2, [
        ("whisper", WHISPER, {}, False, "fp32", 2, None),
        ("llava", LLAVA, {}, False, "fp32", 1, None),
    ]),
    "model3": (("model",), 3, [
        ("whisper", WHISPER, {}, False, "fp32", 1, 2),
        ("whisper_mha", WHISPER, {"n_kv_heads": 4}, False, "fp32", 1, None),
        ("llava", LLAVA, {}, False, "fp32", 1, None),
    ]),
    "data2_model2": (("data", "model"), 4, [
        ("whisper", WHISPER, {}, False, "fp32", 2, None),
        ("llava_fsdp", LLAVA, {}, True, "fp32", 1, None),
    ]),
}


# ---------------------------------------------------------------------------
# Serving cases
# ---------------------------------------------------------------------------


def _inputs(cfg, rng, B: int) -> dict:
    """The frames or patches of ``B`` sequences, seeded."""
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)}
    return {"patches": rng.standard_normal((B, cfg.n_prefix, cfg.d_model)).astype(np.float32)}


def _to_port(tree):
    return interop.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _serve_case(label, arch, over, dtype, kind, world, seed):
    """One case: the reference's padded plan, its params (norms moved off
    their init, so the (1 + scale) and LayerNorm conventions show) or
    artifact, its prefill over the case's tokens and inputs, and what a
    rank needs in port tensors.  The ``rtn4_enc`` case's cache is the
    port's own one-rank prefill's."""
    jcfg, tcfg = _cfgs(arch, **({"dtype": dtype} if dtype else {}), **over)
    jp = jmodel.make_plan(jcfg, world)
    params = jmodel.init_params(jp, jax.random.PRNGKey(seed))
    for k in ("final_norm", "enc_final_norm", "prefix_ln"):
        if k in params:
            params[k] = jax.tree.map(lambda a: a + 0.01, params[k])
    stacks = {"dense": (), "rtn4": ("dec",), "rtn4_enc": ("dec", "enc")}[kind]
    art = _rtn_artifact(jp, params, stacks=stacks) if stacks else params
    rng = np.random.default_rng(300 + seed)
    tokens = rng.integers(0, jcfg.vocab, (2, 6)).astype(np.int32)
    inputs = _inputs(jcfg, rng, 2)
    case = dict(label=label, kind=kind, jp=jp, jparams=art, cfg=tcfg, params=_to_port(art),
                quantized=kind != "dense", tokens=tokens, inputs=inputs,
                next=rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32), cap=32,
                greedy=GREEDY, prompts=[], max_new=0, engines={})
    if kind == "rtn4_enc":
        plan = tmodel.make_plan(tcfg, world)
        cache = tmodel.init_cache(plan, 2, case["cap"], device="cpu")
        tmodel.prefill(plan, case["params"], dict(inputs, tokens=tokens), cache)
        case["cache"] = cache
    else:
        jbatch = {k: jnp.asarray(v) for k, v in dict(inputs, tokens=tokens).items()}
        logits, jcache = jmodel.prefill(jp, art, jbatch, jmodel.init_cache(jp, 2, case["cap"]))
        case.update(jcache=jcache, prefill=np.asarray(logits.astype(jnp.float32)),
                    cache=_to_port(jcache))
    return case


def _reference(case):
    """What :func:`tests._torch_dist.tp_serve` returns, from the reference's
    padded plan on one device (the decode step and the greedy run from its
    prefill's cache), or for the ``rtn4_enc`` case from the port's own
    one-rank padded plan."""
    if case["kind"] == "rtn4_enc":
        plan = tmodel.make_plan(case["cfg"], case["jp"].axis_n)
        return tp_serve(plan, case["params"], case, tmodel.tree_map(torch.clone, case["cache"]))
    jp, params, tokens = case["jp"], case["jparams"], case["tokens"]
    pos = tokens.shape[1] + jp.cfg.n_prefix
    cache = case["jcache"]
    l2, c2 = jmodel.decode_step(jp, params, jnp.asarray(case["next"]), cache, pos)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    wrote = [(f32(c["k"][i, :, pos]), f32(c["v"][i, :, pos]))
             for c in (c2[k] for k in sorted(c2)) for i in range(c["k"].shape[0])]
    cross = [(f32(c["ck"]), f32(c["cv"])) for c in (cache[k] for k in sorted(cache)) if "ck" in c]
    logits = case["prefill"]
    trace, tok = [logits], np.argmax(logits, -1)
    out = [tok]
    for j in range(GREEDY):
        lj, cache = jmodel.decode_step(jp, params, jnp.asarray(tok[:, None], jnp.int32), cache,
                                       pos + j)
        lj = f32(lj)
        tok = np.argmax(lj, -1)
        trace.append(lj)
        out.append(tok)
    rows = range(len(tok))
    greedy = ({b: [int(t[b]) for t in out] for b in rows}, {b: [l[b] for l in trace] for b in rows})
    return {"prefill": logits, "decode": f32(l2), "wrote": wrote, "cross": cross,
            "greedy": greedy}


def _sent(case):
    """What a rank needs (torch and numpy only: a rank loads no JAX)."""
    keep = ("cfg", "params", "quantized", "tokens", "inputs", "cache", "next", "cap", "greedy",
            "prompts", "max_new", "engines")
    return {k: case[k] for k in keep}


@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    """Per world size, one thread makes the cases, starts the group and
    runs the baselines while the ranks work."""
    tmp = tmp_path_factory.mktemp("tp_encdec")
    groups = {}

    def world(w):
        cases = {c[0]: _serve_case(*c, world=w, seed=i) for i, c in enumerate(SERVE_CASES)}
        groups[w] = start_group(tp_rank, w, tmp, {k: _sent(c) for k, c in cases.items()},
                                str(tmp / f"ckpt{w}"))
        return cases, {k: _reference(c) for k, c in cases.items()}

    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            done = dict(zip((2, 3), pool.map(world, (2, 3))))
        yield {w: (d[0], d[1], groups[w]) for w, d in done.items()}
    finally:
        for g in groups.values():
            g.close()


@pytest.fixture
def served(serve_runs, world):
    cases, want, group = serve_runs[world]
    return cases, want, group.result()


def _rtol(case):
    return BF16_RTOL if case["cfg"].dtype == torch.bfloat16 else FP32_RTOL


def _slots(world, rank, whole):
    """Rank ``rank``'s kv slots of a whole (…, KVp, hd) cache."""
    n = whole.shape[-2] // world
    return whole[..., rank * n:(rank + 1) * n, :]


SERVE_LABELS = [c[0] for c in SERVE_CASES]


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("label", SERVE_LABELS)
def test_tp_prefill_and_decode_match_the_padded_plan(served, world, label):
    cases, want, got = served
    case, ref = cases[label], want[label]
    wrote = [tuple(np.concatenate([o[label]["wrote"][i][j] for o in got], 1) for j in (0, 1))
             for i in range(len(ref["wrote"]))]
    rtol = {"prefill": _rtol(case), "decode": _decode_rtol(case, ref["wrote"], wrote)}
    for rank, out in enumerate(o[label] for o in got):
        for key in ("prefill", "decode"):
            assert out[key].shape == ref[key].shape == (2, -(-256 // world) * world)
            np.testing.assert_allclose(out[key], ref[key], rtol=0,
                                       atol=rtol[key] * np.abs(ref[key]).max(),
                                       err_msg=f"rank {rank} {key}")
            assert out[key].tobytes() == got[0][label][key].tobytes(), "ranks' logits differ"


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("label", SERVE_LABELS)
def test_tp_greedy_run_matches_the_padded_plan(served, world, label):
    cases, want, got = served
    bf16 = cases[label]["cfg"].dtype == torch.bfloat16
    for out in (o[label] for o in got):
        assert out["greedy"][0] == got[0][label]["greedy"][0], "ranks' tokens differ"
        compared = _agree(want[label]["greedy"], out["greedy"], BF16_RTOL if bf16 else ENGINE_RTOL)
        assert compared >= (1 if bf16 else 2)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("label", [c[0] for c in SERVE_CASES if c[1] == WHISPER])
def test_tp_cross_caches_are_the_ranks_slots(served, world, label):
    """``ck``/``cv`` of each rank: its kv slots of the baseline's, shaped
    (periods, B, n_frames, kv_pad / world, hd); at 3 the MHA case's padded
    slots (rank 2's last two) hold zeros."""
    cases, want, got = served
    case = cases[label]
    plan = tmodel.make_plan(case["cfg"], world)
    tol = BF16_RTOL if case["cfg"].dtype == torch.bfloat16 else CACHE_TOL
    assert want[label]["cross"]
    for rank, out in enumerate(o[label] for o in got):
        for (ck, cv), (wk, wv) in zip(out["cross"], want[label]["cross"]):
            for a, w in ((ck, wk), (cv, wv)):
                assert a.shape == (case["cfg"].n_periods, 2, case["cfg"].n_frames,
                                   plan.heads.kv_pad // world, plan.heads.head_dim)
                mine = _slots(world, rank, w)
                np.testing.assert_allclose(a, mine, rtol=0, atol=tol * np.abs(w).max(),
                                           err_msg=f"rank {rank}")
    if plan.heads.kv_pad > plan.heads.n_kv and plan.heads.dup == 1:
        pad = plan.heads.kv_pad - plan.heads.n_kv
        for j in (0, 1):
            whole = np.concatenate([o[label]["cross"][0][j] for o in got], -2)
            assert not whole[..., -pad:, :].any() and whole[..., :-pad, :].all(axis=-1).any()


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("label", SERVE_LABELS)
def test_tp_each_rank_stores_its_shard_and_round_trips_it(served, world, label):
    cases, _, got = served
    case = cases[label]
    for rank, out in enumerate(o[label] for o in got):
        assert out["bytes"] == _expected_bytes(case, world, rank), rank
        assert out["ckpt"], rank
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(case["params"]))
    held = sum(got[0][label]["bytes"].values())
    assert held < 0.75 * whole


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("label", SERVE_LABELS)
def test_tp_decode_step_collectives(served, world, label):
    """One decode step: the embedding's all-reduce, then per decoder layer
    one for ``wo``, one for ``wo_c`` (Whisper) and one for ``wd``; the
    logits' all-gather, and at 3 (k/v cut on ``head_dim`` or on rows inside
    a head, or padded slots) two a layer for the self-attention k/v."""
    cases, _, got = served
    cfg = cases[label]["cfg"]
    layers = cfg.n_periods * len(cfg.pattern)
    cross = int(any(b.cross for b in cfg.pattern))
    want = {"all_reduce": 1 + layers * (2 + cross),
            "all_gather": 1 + (2 * layers if world == 3 else 0)}
    for rank, out in enumerate(o[label] for o in got):
        assert out["comm"]["decode"] == want, (rank, out["comm"]["decode"])


def test_tp_padded_plans_are_what_the_cases_say(serve_runs):
    for world, (cases, _, _) in serve_runs.items():
        for label, case in cases.items():
            plan = tmodel.make_plan(case["cfg"], world)
            hp = plan.heads
            assert plan.vocab_pad == (256 if world == 2 else 258)
            if world == 2:
                assert (hp.dup, hp.kv_pad) == (1, hp.n_kv)
            else:
                assert hp.kv_pad == 6 and hp.dup == (3 if hp.n_kv == 2 else 1)
            enc = case["params"].get("enc")
            if enc is not None:
                q = [isinstance(v, QuantizedTensor) for blk in enc.values() for v in blk.values()]
                assert any(q) == (case["kind"] == "rtn4_enc")


# ---------------------------------------------------------------------------
# Training cases
# ---------------------------------------------------------------------------


def _model_n(group: str) -> int:
    dims, world, _ = TRAIN_GROUPS[group]
    return world // 2 if len(dims) == 2 else world


def _train_case(group, label, arch, over, fsdp, moments, n_mb, resume):
    """One case as ``tests/test_torch_tp_train.py`` makes it: both
    packages' configs, the port's seeded whole params of the padded plan
    (numpy), what a rank needs, and the key of its reference run."""
    jcfg, tcfg = _cfgs(arch, **over)
    plan = tmodel.make_plan(tcfg, _model_n(group))
    params = tmodel.tree_map(lambda t: t.numpy(), tmodel.init_params(plan, 0, device="cpu"))
    return dict(jcfg=jcfg, cfg=tcfg, params=params, fsdp=fsdp, moments=moments, resume=resume,
                opt=tt.OPT, tc=dict(tt.TC, n_microbatches=n_mb),
                ref_key=(arch, tuple(sorted(over.items())), None, _model_n(group), moments, n_mb))


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_encdec_train")
    cases = {g: {c[0]: _train_case(g, *c) for c in spec[2]} for g, spec in TRAIN_GROUPS.items()}
    groups = {}
    try:
        for g, (dims, world, _) in TRAIN_GROUPS.items():
            groups[g] = start_group(tp_train_rank, world, tmp, {k: tt._sent(c) for k, c in
                                                                cases[g].items()},
                                    str(tmp / g), dims)
        firsts = {}
        for g in cases:
            for c in cases[g].values():
                firsts.setdefault(c["ref_key"], c)
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            refs = dict(zip(firsts, pool.map(tt._reference, firsts.values())))
        yield dict(cases=cases, refs=refs, groups=groups)
    finally:
        for grp in groups.values():
            grp.close()


def _trained(runs, group):
    return runs["groups"][group].result()


TRAIN_LABELS = [(g, c[0]) for g, spec in TRAIN_GROUPS.items() for c in spec[2]]


@pytest.mark.parametrize("group,label", TRAIN_LABELS)
def test_tp_train_losses_match_the_padded_reference(train_runs, group, label):
    ref = train_runs["refs"][train_runs["cases"][group][label]["ref_key"]]
    r0 = _trained(train_runs, group)[0][label]
    assert len(r0["losses"]) == tt.TC["steps"]
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(r0[key], ref[key], rtol=tt.LOSS_RTOL, atol=0, err_msg=key)
    np.testing.assert_allclose(r0["loss1"], ref["loss1"], rtol=tt.LOSS_RTOL, atol=0)


@pytest.mark.parametrize("group,label", TRAIN_LABELS)
def test_tp_train_step_one_gradients_of_every_leaf(train_runs, group, label):
    """Every leaf's step-1 gradient, gathered from the ranks, against the
    reference's; the encoder's, ``enc_pos_emb``'s, the cross-attention's and
    ``prefix_ln``'s are among them and must not be zero (a missing sum
    over the axis of the encoder's output shows there)."""
    case = train_runs["cases"][group][label]
    ref = train_runs["refs"][case["ref_key"]]
    grads = _trained(train_runs, group)[0][label]["grads"]
    paths = _leaf_paths(case["params"])
    assert len(grads) == len(ref["grads"]) == len(paths)
    for path, g, want in zip(paths, grads, ref["grads"]):
        assert g.shape == want.shape, path
        np.testing.assert_allclose(g, want, rtol=0, atol=tt.GRAD_RTOL * np.abs(want).max(),
                                   err_msg=path)
    named = dict(zip(paths, ref["grads"]))
    family = ["enc.b0.wq", "enc.b0.wd", "enc_pos_emb", "dec.b0.wk_c", "dec.b0.wq_c",
              "enc_final_norm.scale"] if case["cfg"].family == "encdec" else ["prefix_ln.scale"]
    for path in family:
        assert np.abs(named[path]).max() > 0, path


def _leaf_paths(tree) -> list:
    """Dotted paths of a tree's leaves in :func:`repro_torch.tree.tree_flatten` order."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else k)
        else:
            out.append(path)

    walk(tree, "")
    assert len(out) == len(tree_leaves(tree))
    return out


@pytest.mark.parametrize("group,label", TRAIN_LABELS)
def test_tp_train_final_params_within_the_update_tolerance(train_runs, group, label):
    case = train_runs["cases"][group][label]
    ref = train_runs["refs"][case["ref_key"]]
    got = _trained(train_runs, group)[0][label]["params"]
    init = tree_leaves(case["params"])
    off = np.sqrt(sum(np.sum((a - b) ** 2, dtype=np.float64) for a, b in zip(got, ref["params"])))
    moved = np.sqrt(sum(np.sum((b - c) ** 2, dtype=np.float64)
                        for b, c in zip(ref["params"], init)))
    assert moved > 0 and off <= tt.UPDATE_RTOL * moved, (off, moved, off / moved)


@pytest.mark.parametrize("group,label", TRAIN_LABELS)
def test_tp_train_ranks_agree_and_restore(train_runs, group, label):
    """The ranks log the same losses and gradient norms and gather the same
    state; the ranks of one data coordinate hold the same bits of every
    leaf whole on "model" before each step and after the run; ``restore``
    gives each rank its blocks back, and a resumed run ends on the
    uninterrupted one's bits."""
    case = train_runs["cases"][group][label]
    got = [o[label] for o in _trained(train_runs, group)]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"] and r["grad_norms"] == got[0]["grad_norms"]
        assert r["whole"] == got[0]["whole"]
    peers = {}
    for r in got:
        assert r["restored"] and (r["resumed"] if case["resume"] else True)
        peers.setdefault(r["coord"][:-1], []).append(r["peers"])
    for coord, runs_ in peers.items():
        assert len(runs_) == _model_n(group) and all(p == runs_[0] for p in runs_), coord
    assert got[0]["sharded"]["model"]
    assert bool(got[0]["sharded"].get("data")) == case["fsdp"]


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


# The leaves each family adds, and the dimension (behind "layers") a model
# axis of 2 cuts at full width: Whisper's 20 heads (MHA, kv 20) and 5,120
# ffn units, LLaVA's 56 heads (kv 8) and 20,480 ffn units halve.
FULL_WIDTH_CUTS = {
    WHISPER: {"enc.b0.wq": 2, "enc.b0.wk": 2, "enc.b0.wo": 1, "enc.b0.wg": 2, "enc.b0.wd": 1,
              "dec.b0.wq_c": 2, "dec.b0.wk_c": 2, "dec.b0.wv_c": 2, "dec.b0.wo_c": 1,
              "enc_pos_emb": None, "enc_final_norm.scale": None, "pos_emb": None,
              "embed": 0, "lm_head": 1},
    LLAVA: {"prefix_ln.scale": None, "dec.b0.wq": 2, "dec.b0.wk": 2, "dec.b0.wd": 1,
            "embed": 0, "lm_head": 1},
}


@pytest.mark.parametrize("rules_of", ["serving", "training"])
@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_full_width_shards_on_the_meta_device(arch, rules_of):
    """Both models at full width on a ("model",) axis of 2: ``shard_tree``
    of the meta params under the serving and the training rules halves
    every leaf the reference's logical axes put on "model" and keeps the
    rest whole; the family's own leaves are cut as ``FULL_WIDTH_CUTS``
    says (Whisper's vocabulary of 51,866 splits in 25,933 a rank)."""
    plan = tmodel.make_plan(tget(arch), 2)
    rules = (tqparams.serving_rules if rules_of == "serving" else train_rules)(plan, {"model": 2})
    whole = tmodel.param_shapes(plan)
    local = tsharding.shard_tree(whole, tmodel.param_axes(plan), rules, rank=1)
    paths = _leaf_paths(whole)
    cut = {}
    for path, w, l in zip(paths, tree_leaves(whole), tree_leaves(local)):
        dims = [d for d in range(w.dim()) if w.shape[d] != l.shape[d]]
        assert len(dims) <= 1 and all(w.shape[d] == 2 * l.shape[d] for d in dims), path
        cut[path] = dims[0] if dims else None
    for path, d in FULL_WIDTH_CUTS[arch].items():
        assert cut[path] == d, (path, cut[path])
    assert local["embed"].shape[0] == plan.vocab_pad // 2


def test_reference_restacked_artifact_keeps_its_encoder_axes_dense():
    """An artifact restacked as the reference restacks it (its ``"enc"``
    dense) is laid out by ``qt_param_axes(plan, params)``: dense axes in
    ``"enc"``, quantized ones in ``"dec"``; without ``params`` every
    quantizable leaf takes the quantized layout (the reference's table)."""
    cfg = dataclasses.replace(_cfgs(WHISPER)[1], dtype=torch.float32)
    plan = tmodel.make_plan(cfg, 2)
    params = tmodel.init_params(plan, 0, device="cpu")
    art, _ = tqparams.rtn_quantize_for_serving(plan, params, bits=4)
    axes = tqparams.qt_param_axes(plan, art)
    assert axes["enc"]["b0"]["wq"] == ("layers", "embed", "heads", None, None)
    assert axes["dec"]["b0"]["wq_c"]["codes"] == ("layers", "heads_fused", "embed")
    assert tqparams.qt_param_axes(plan)["enc"]["b0"]["wq"]["codes"] == ("layers", "heads_fused",
                                                                        "embed")
    rules = tqparams.serving_rules(plan, {"model": 2})
    local = tsharding.shard_tree(art, axes, rules, rank=0)
    assert local["enc"]["b0"]["wq"].shape[2] == plan.heads.kv_pad // 2
    assert local["dec"]["b0"]["wq_c"].codes.shape[-2] == art["dec"]["b0"]["wq_c"].codes.shape[-2] // 2


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_data_coordinates_take_the_frames_and_patches_of_their_tokens(arch):
    """``Trainer._put_batch`` on a ("data", "model") mesh of 2 × 2, two
    microbatches: each data coordinate's rows of ``frames``/``patches`` are
    those of the global batch that go with its rows of ``tokens``."""
    cfg = dataclasses.replace(_cfgs(arch)[1], dtype=torch.float32)
    key = "frames" if cfg.family == "encdec" else "patches"
    for coord in (0, 1):
        mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2),
                                     get_local_rank=lambda axis, c=coord: c if axis == "data" else 0,
                                     get_group=lambda axis: None)
        tr = Trainer(cfg, AdamWConfig(), TrainerConfig(steps=1, batch=8, seq=8, n_microbatches=2),
                     mesh=mesh, device="cpu")
        whole = tr.batch_fn(0)
        mine = tr._put_batch(whole)
        # Microbatch i holds global rows [4i, 4i + 4); coordinate c its block of two.
        rows = [4 * i + 2 * coord + j for i in range(2) for j in range(2)]
        assert whole[key].shape[0] == whole["tokens"].shape[0] == 8
        for k in ("tokens", key):
            assert np.array_equal(np.asarray(mine[k]), np.asarray(whole[k])[rows]), (coord, k)
