"""Tensor-parallel serving of the mixture-of-experts and Mamba-2 families on
a "model" axis, held against the JAX package.

On 2 and 3 gloo ranks (``tests/_torch_dist.py``: one group a world size,
both started once for the module, beside the reference's work here) each
rank's shard (``dist.sharding.shard_tree`` under
``serve.qparams.serving_rules``) of reduced models, dense or as a packed
4-bit per-channel artifact made from the reference's quantizer (and a
``qe_outlier`` artifact of the reference's solver for Mamba-2), carried
across by ``interop``, serves:

* an OLMoE-like and a Mixtral-like MoE decoder (GQA; Mixtral's window cut
  to 16), Mamba-2 with one B/C group and with two, and Jamba (attention,
  Mamba and MoE blocks);
* on 2 ranks the experts (4) and the SSD heads (16) split: expert-parallel
  MoE and head-parallel Mamba (two groups: each rank's heads read their
  own group);
* on 3 ranks the per-expert ffn of 192 splits (ffn-parallel), the default
  128 does not and neither do the 4 experts (the layer is whole: no
  collective), a Mamba of 16 heads of 12 keeps its heads whole while a
  quantized ``wz``/``wx`` splits its 192 fused rows inside a head (the
  rank's rows are gathered whole), and 24 heads of 8 in two groups split 8
  a rank (rank 1's heads straddle the groups).

Each case holds: prefill and decode logits within 1e-5 of max |logit| of
the reference's padded plan on one device at fp32 (2e-2 at bf16); the
engines' recorded logits within 1e-4 of each step's max |logit| and the
tokens equal up to the first top-2 margin under twice that (a request of
a Mamba model may part only where the contiguous engine's admission
rounded its state to the other neighbouring bf16 value, verified against
the port's one-rank run, which is held to the reference); each rank's
storage exactly its shard; every rank's router top-k ids those of rank 0,
bit for bit; and the decode step's collectives counted: one all-reduce an
MoE layer split over the axis (none for a whole one), two a head-parallel
Mamba layer (the gated norm's sum of squares, ``out_proj``), and for a
gathered one the two gathers and ``out_proj``'s all-reduce.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver as jsolver
from repro.models import model as jmodel
from repro.quant import GridSpec as JSpec
from repro.serve import qparams as jqparams
from repro.serve.engine import PagedServingEngine as JPagedEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.models import model as tmodel
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests._torch_dist import start_group, tp_rank, tp_serve
from tests.test_torch_tp import (BF16, BF16_RTOL, ENGINE_KW, _agree, _cfgs, _decode_rtol,
                                 _expected_bytes, _rtol)

# At bf16 the port on one rank parts from the reference by a bf16 rounding
# a Mamba layer (tests/test_torch_mamba.py), which a whole reduced Jamba
# period (seven Mamba layers) carries past 2e-2 of max |logit|: that case
# holds the ranks against the port's own padded plan on one rank, and the
# other bf16 Jamba case serves the period's blocks 0 and 1, as the card does.
ONE_RANK_REF = {"jamba_period_bf16"}
MAMBA3 = dict(d_model=96, ssm_headdim=12)  # 16 heads, 192 channels: the fused rows split 3 ways
MAMBA3_G2 = dict(d_model=96, ssm_headdim=8, ssm_ngroups=2)  # 24 heads in 2 groups, 8 a rank
# (label, arch, config overrides, dtype, artifact, engines)
CASES = {
    2: [
        ("olmoe", "olmoe_1b_7b", {}, None, "dense", ("paged", "contiguous")),
        ("olmoe_rtn4", "olmoe_1b_7b", {}, None, "rtn4", ("paged",)),
        ("mixtral", "mixtral_8x22b", {}, None, "dense", ("paged",)),
        ("mamba", "mamba2_2_7b", {}, None, "rtn4", ("contiguous",)),
        ("mamba_g2", "mamba2_2_7b", {"ssm_ngroups": 2}, None, "dense", ("contiguous",)),
        ("mamba_outlier", "mamba2_2_7b", {}, None, "qe_outlier", ()),
        ("jamba", "jamba_1_5_large", {"n_periods": 1}, None, "dense", ("contiguous",)),
        ("jamba_rtn4", "jamba_1_5_large", {"n_periods": 1}, None, "rtn4", ()),
        ("jamba_bf16", "jamba_1_5_large", {"n_periods": 1, "blocks": (0, 1)}, BF16, "dense", ()),
        ("jamba_period_bf16", "jamba_1_5_large", {"n_periods": 1}, BF16, "dense", ()),
    ],
    3: [
        ("mixtral_ffn", "mixtral_8x22b", {"moe_d_ff": 192}, None, "dense", ("paged",)),
        ("mixtral_ffn_rtn4", "mixtral_8x22b", {"moe_d_ff": 192}, None, "rtn4", ()),
        ("olmoe_whole", "olmoe_1b_7b", {}, None, "dense", ("paged",)),
        ("mamba_gather", "mamba2_2_7b", MAMBA3, None, "rtn4", ("contiguous",)),
        ("mamba_whole", "mamba2_2_7b", MAMBA3, None, "dense", ()),
        ("mamba_g2", "mamba2_2_7b", MAMBA3_G2, None, "dense", ("contiguous",)),
        ("jamba", "jamba_1_5_large", {"n_periods": 1}, None, "dense", ("contiguous",)),
        ("olmoe_bf16", "olmoe_1b_7b", {"moe_d_ff": 192}, BF16, "dense", ()),
    ],
}


def _rtn_artifact(jp, params):
    """A packed 4-bit per-channel serving artifact of every quantizable
    ``dec`` leaf, from the reference's ``quantize_tensor`` and
    ``pack_codes``: codes ``(periods, out, in)``, and an expert matrix
    quantized expert by expert, ``(periods, experts, out, in)``, as the
    reference's solver artifact restacks it."""
    from repro.core.solver import _MOE_NAMES, QUANTIZABLE
    from repro.quant import quantize_tensor
    from repro.quant.pack import pack_codes

    def one(wi):  # (out, in)
        qt = quantize_tensor(jnp.asarray(wi), JSpec(bits=4))
        return dataclasses.replace(qt, codes=pack_codes(qt.codes, 4), packed=True)

    stack = lambda qts: jax.tree.map(lambda *ls: jnp.stack(ls), *qts)

    def qt_of(name, leaf):
        w = np.asarray(leaf, np.float32)
        if name in _MOE_NAMES:  # (periods, E, d_in, out)
            return stack([stack([one(we.T) for we in wp]) for wp in w])
        out_f, d_in = jqparams._linear_meta(jp, name)[:2]
        return stack([one(wi.T) for wi in w.reshape(w.shape[0], d_in, out_f)])

    out = dict(params)
    out["dec"] = {k: {n: qt_of(n, v) if n in QUANTIZABLE else v for n, v in blk.items()}
                  for k, blk in params["dec"].items()}
    return out


def _artifact(kind, jp, params):
    if kind == "dense":
        return params
    if kind == "rtn4":
        return _rtn_artifact(jp, params)
    r = np.random.default_rng(0)
    calib = [{"tokens": jnp.asarray(r.integers(0, jp.cfg.vocab, (2, 16)), jnp.int32)}]
    cfg = jsolver.PTQConfig(method="qe_outlier", spec=JSpec(bits=4), iterations=2,
                            outlier_frac=0.05, emit="qt")
    q, _ = jsolver.ptq_quantize_model(jp, params, calib, cfg)
    return jqparams.quantize_params_for_serving(jp, params, q["dec"])


def _family_cfgs(arch, dtype=None, blocks=None, **over):
    """``tests.test_torch_tp._cfgs`` (at ``dtype`` where given), the period
    cut to ``blocks`` in each package's own pattern where given."""
    cfgs = _cfgs(arch, **({"dtype": dtype} if dtype else {}), **over)
    if blocks is None:
        return cfgs
    return tuple(dataclasses.replace(c, pattern=tuple(c.pattern[i] for i in blocks)) for c in cfgs)


def _case(label, arch, over, dtype, kind, engines, world, seed):
    """One case: the reference's padded plan, its params or artifact, its
    prefill (whose cache every decode step starts from), and what a rank
    needs in port tensors.  Prompts are longer than the convolution's
    k − 1 = 3."""
    jcfg, tcfg = _family_cfgs(arch, dtype, **over)
    jp = jmodel.make_plan(jcfg, world)
    art = _artifact(kind, jp, jmodel.init_params(jp, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(200 + seed)
    tokens = rng.integers(0, jcfg.vocab, (2, 13)).astype(np.int32)
    cache = jmodel.init_cache(jp, 2, 32)
    logits, cache = jmodel.prefill(jp, art, {"tokens": jnp.asarray(tokens)}, cache)
    to_port = lambda tree: interop.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    return dict(
        label=label, jp=jp, jparams=art, jcache=cache,
        prefill=np.asarray(logits.astype(jnp.float32)),
        cfg=tcfg, params=to_port(art), quantized=kind != "dense", tokens=tokens,
        cache=to_port(cache), next=rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32),
        cap=32, prompts=[rng.integers(0, jcfg.vocab, n).astype(np.int32) for n in (5, 19, 11)],
        max_new=5, engines={e: ENGINE_KW[e] for e in engines},
    )


def _reference(case):
    """The reference's padded plan on one device: the decode step from the
    prefill's cache and each engine, as ``tests._torch_dist.tp_serve`` runs
    the port.  For a case of ``ONE_RANK_REF``, and a Mamba model on the
    contiguous engine, also the port's own padded plan on one rank
    (``"one_rank"``)."""
    jp, params, tokens = case["jp"], case["jparams"], case["tokens"]
    l2, cache = jmodel.decode_step(jp, params, jnp.asarray(case["next"]), case["jcache"],
                                   tokens.shape[1])
    attn = [cache[k] for k in sorted(cache) if hasattr(cache[k], "get") and "k" in cache[k]]
    wrote = [(np.asarray(c["k"][i, :, tokens.shape[1]].astype(jnp.float32)),
              np.asarray(c["v"][i, :, tokens.shape[1]].astype(jnp.float32)))
             for c in attn for i in range(c["k"].shape[0])]
    out = {"prefill": case["prefill"], "decode": np.asarray(l2.astype(jnp.float32)),
           "wrote": wrote}
    for name, kw in case["engines"].items():
        if name == "contiguous":
            eng = JEngine(jp, params, record_logits=True, **kw)
        else:
            eng = JPagedEngine(jp, params, record_logits=True, **kw)
        for i, p in enumerate(case["prompts"]):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=case["max_new"]))
        eng.run()
        out[name] = ({r.rid: r.output for r in eng.finished}, eng.logit_trace)
    mamba_engine = "contiguous" in case["engines"] and _has_mamba(case["cfg"])
    if case["label"] in ONE_RANK_REF or mamba_engine:
        plan = tmodel.make_plan(case["cfg"], case["jp"].axis_n)
        engines = {"contiguous": case["engines"]["contiguous"]} if mamba_engine else {}
        with torch.no_grad():
            out["one_rank"] = tp_serve(plan, case["params"], dict(case, engines=engines),
                                       tmodel.tree_map(torch.clone, case["cache"]))
    return out


def _has_mamba(cfg) -> bool:
    return any(b.kind == "mamba" for b in cfg.pattern)


def _admission_flips(one: dict, ranks: list) -> set:
    """The requests whose bf16 Mamba convolution state, as the contiguous
    engine's admission stored it (``tests._torch_dist.tp_serve``), differs
    on a rank from the port's one-rank run, each differing entry verified
    to be the neighbouring bf16 value (a rounding boundary the two runs'
    fp32 states, one ulp apart, fall on either side of).  A rank holding
    its SSD heads compares with its heads of the one-rank state."""
    flips = set()
    for rid, leaves in one.items():
        for key, whole in leaves.items():
            for rank, got in enumerate(r[rid][key] for r in ranks):
                want = whole
                if got.shape != whole.shape:  # (periods, k - 1, heads, hd): the rank's heads
                    nh = got.shape[2]
                    want = whole[:, :, rank * nh : (rank + 1) * nh]
                diff = got.astype(np.int32) - want.astype(np.int32)
                if diff.any():
                    assert np.abs(diff).max() == 1 and ((got ^ want) >= 0)[diff != 0].all(), \
                        (rid, key, rank)
                    flips.add(rid)
    return flips


def _sent(case):
    """What a rank needs (torch and numpy only: a rank loads no JAX)."""
    keep = ("cfg", "params", "quantized", "tokens", "cache", "next", "cap", "prompts",
            "max_new", "engines")
    return {k: case[k] for k in keep}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per world size, one thread makes the cases, starts the group and
    runs the reference's padded plan on one device while the ranks work."""
    tmp = tmp_path_factory.mktemp("tp_families")
    groups = {}

    def world(w):
        cases = {c[0]: _case(*c, world=w, seed=i) for i, c in enumerate(CASES[w])}
        groups[w] = start_group(tp_rank, w, tmp, {k: _sent(c) for k, c in cases.items()})
        return cases, {k: _reference(c) for k, c in cases.items()}

    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            done = dict(zip((2, 3), pool.map(world, (2, 3))))
        yield {w: (d[0], d[1], groups[w]) for w, d in done.items()}
    finally:
        for g in groups.values():
            g.close()


@pytest.fixture
def tp(runs, world):
    cases, want, group = runs[world]
    return cases, want, group.result()


def _labels(kind=None):
    return [(w, c[0]) for w in CASES for c in CASES[w]
            if kind is None or kind(c)]


@pytest.mark.parametrize("world,label", _labels(lambda c: c[0] not in ONE_RANK_REF))
def test_tp_family_logits_match_the_padded_reference(tp, world, label):
    cases, want, got = tp
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


@pytest.mark.parametrize("world,label", _labels(lambda c: c[0] in ONE_RANK_REF))
def test_tp_family_bf16_period_matches_the_one_rank_port(tp, world, label):
    """The ranks' bf16 logits within 2e-2 of max |logit| of the port's own
    padded plan on one rank, whose logits lie past that bound from the
    reference's (the drift of ``ONE_RANK_REF``'s comment)."""
    cases, want, got = tp
    one, ref = want[label]["one_rank"], want[label]
    drift = np.abs(one["prefill"] - ref["prefill"]).max() / np.abs(ref["prefill"]).max()
    assert drift > BF16_RTOL
    for rank, out in enumerate(o[label] for o in got):
        for key in ("prefill", "decode"):
            np.testing.assert_allclose(out[key], one[key], rtol=0,
                                       atol=BF16_RTOL * np.abs(one[key]).max(),
                                       err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("world,label,engine",
                         [(w, c[0], e) for w in CASES for c in CASES[w] for e in c[5]])
def test_tp_family_engines_match_the_padded_reference(tp, world, label, engine):
    """Each request's recorded logits and tokens as ``_agree`` holds them; a
    request that parts is allowed only where its admitted Mamba state
    flipped a bf16 rounding (:func:`_admission_flips`), and the port's
    one-rank run is held to the reference on every request."""
    cases, want, got = tp
    ref, flips = want[label][engine], set()
    if f"{engine}_admitted" in want[label].get("one_rank", {}):
        one = want[label]["one_rank"]
        assert _agree(ref, one[engine]) >= len(cases[label]["prompts"])
        flips = _admission_flips(one[f"{engine}_admitted"],
                                 [o[label][f"{engine}_admitted"] for o in got])
    only = lambda run, rid: tuple({rid: d[rid]} for d in run)
    for out in (o[label] for o in got):
        assert out[engine][0] == got[0][label][engine][0], "ranks' tokens differ"
        compared, parted = 0, []
        for rid in ref[0]:
            try:
                compared += _agree(only(ref, rid), only(out[engine], rid))
            except AssertionError:
                parted.append(rid)
        assert set(parted) <= flips, (parted, flips)
        assert compared >= len(cases[label]["prompts"])


@pytest.mark.parametrize("world,label", _labels())
def test_tp_family_rank_stores_exactly_its_shard(tp, world, label):
    cases, _, got = tp
    case = cases[label]
    for rank, out in enumerate(o[label] for o in got):
        assert out["bytes"] == _expected_bytes(case, world, rank), rank
    from repro_torch.tree import tree_leaves

    whole = sum(t.numel() * t.element_size() for t in tree_leaves(case["params"]))
    assert sum(got[0][label]["bytes"].values()) < whole


@pytest.mark.parametrize("world,label", _labels(lambda c: c[1] != "mamba2_2_7b"))
def test_tp_family_routers_agree_bit_for_bit(tp, world, label):
    """Every rank routes alike: the router runs on the replicated
    activations, and its top-k ids are rank 0's on every call."""
    _, _, got = tp
    n, digest = got[0][label]["routes"]
    assert n > 0
    assert all(o[label]["routes"] == (n, digest) for o in got)


def _layouts(cfg, world: int, quantized: bool) -> dict:
    """What splits over ``world`` ranks, from the sizes alone."""
    fits = lambda n: n > 0 and n % world == 0
    ssm = cfg.ssm_nheads
    return dict(
        moe="experts" if fits(cfg.n_experts) else "ffn" if fits(cfg.moe_ff) else "whole",
        mamba="heads" if fits(ssm) else (
            "gather" if quantized and fits(ssm * cfg.ssm_headdim) else "whole"),
        ffn=fits(cfg.d_ff))


def _decode_collectives(cfg, world: int, quantized: bool) -> tuple:
    """(all-reduces, all-gathers) of one decode step: the embedding's sum and
    the logits' gather (the vocabulary always splits: 256 or 258); an
    attention layer's ``wo`` and, on 3 ranks (kv 2 heads of 24 cut on the
    head dim or inside a head), the k and v gathers; a split dense MLP's
    ``wd``; a split MoE layer's one all-reduce; a head-parallel Mamba
    layer's two, a gathered one's ``out_proj`` and two gathers."""
    lay = _layouts(cfg, world, quantized)
    reduces, gathers = 1, 1
    for b in cfg.pattern * cfg.n_periods:
        if b.kind == "attn":
            reduces += 1
            gathers += 2 if world == 3 else 0
        elif lay["mamba"] == "heads":
            reduces += 2
        elif lay["mamba"] == "gather":
            reduces, gathers = reduces + 1, gathers + 2
        if b.mlp == "dense" and lay["ffn"]:
            reduces += 1
        if b.mlp == "moe" and lay["moe"] != "whole":
            reduces += 1
    return reduces, gathers


@pytest.mark.parametrize("world,label", _labels())
def test_tp_family_decode_collectives(tp, world, label):
    cases, _, got = tp
    case = cases[label]
    want = _decode_collectives(case["cfg"], world, case["quantized"])
    for o in got:
        dec = o[label]["comm"]["decode"]
        assert (dec["all_reduce"], dec["all_gather"]) == want, (label, dec)


def test_the_cases_cover_every_layout():
    """Expert-parallel, ffn-parallel and whole MoE layers; head-parallel,
    gathered and whole Mamba layers; Mamba with two groups on both axes."""
    seen = {(w, k, v) for w in CASES for c in CASES[w]
            for cfg in [_family_cfgs(c[1], **c[2])[1]]
            for k, v in _layouts(cfg, w, c[4] != "dense").items() if k != "ffn"
            and (cfg.n_experts if k == "moe" else any(b.kind == "mamba" for b in cfg.pattern))}
    assert {(2, "moe", "experts"), (3, "moe", "ffn"), (3, "moe", "whole"), (2, "mamba", "heads"),
            (3, "mamba", "heads"), (3, "mamba", "gather"), (3, "mamba", "whole")} <= seen
    assert tmodel.make_plan(_family_cfgs("mamba2_2_7b", **MAMBA3_G2)[1], 3).cfg.ssm_nheads == 24
