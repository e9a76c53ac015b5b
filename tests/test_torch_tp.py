"""Tensor-parallel serving on a "model" axis, held against the JAX package.

* The plan and the layout tables (``make_head_plan``, ``make_plan``,
  ``param_shapes``, ``param_axes``, ``qt_param_shapes``, ``qt_param_axes``,
  ``cache_axes``, ``qt_rules_extra``) equal the reference's, leaf for leaf,
  for every architecture at ``axis_n`` 1, 2, 3, 4 and 16.
* A padded plan on one rank (no mesh) is a model of its own: reduced GQA
  (4 heads, 2 kv) and MHA (4/4) models padded for an axis of 3 (dup 3, or 2
  zero slots; vocabulary 256 → 258) give the reference's padded-plan
  prefill and decode logits within 1e-5 of max |logit| at fp32.
* On 2 and 3 gloo ranks (``tests/_torch_dist.py``: one group a world size,
  both started once for the module, beside the reference's work here), each
  rank's shard (``dist.sharding.shard_tree`` under
  ``serve.qparams.serving_rules``) of dense params, a packed 4-bit
  per-channel artifact, a grouped artifact and a ``qe_outlier`` artifact,
  all made by the reference and carried across by ``interop``, serves:
  prefill and decode logits within 1e-5 of max |logit| of the reference's
  padded plan on one device at fp32 (2e-2 at bf16); the paged and
  contiguous engines' recorded logits within 1e-4 of each step's max
  |logit| and their greedy tokens equal up to the first step where a top-2
  margin falls below twice that (``tests/test_torch_paged_engine.py``'s
  rule); each rank's storage, leaf by leaf, exactly its shard (a sharded
  leaf 1/n of the whole, a replicated one whole, a COO plane the entries it
  owns padded per period to the period with the most).  At 2 nothing is
  padded; at 3 GQA duplicates, MHA zero-pads, and the vocabulary pads to
  258.
* ``serve.qparams.serving_rules`` is the reference dry-run's table
  (``launch.specs._rules_for``) at every architecture and axis but for the
  two entries it departs in on purpose (``ROADMAP.md`` §3): ``expert_ffn``
  stays whole where neither the experts nor the per-expert ffn divide the
  axis, and ``ssm_heads`` splits where the SSD heads divide it.
* A model axis takes speculation and deadlines (ROADMAP item 8.1.5; their
  parity on ranks: ``tests/test_torch_tp_spec.py``).  The
  mixture-of-experts and Mamba-2 families serve on the axis:
  ``tests/test_torch_tp_families.py``; the encoder-decoder and
  prefix families serve and train on it: ``tests/test_torch_tp_encdec.py``
  (here, their caches take the rank's kv slots); every token-only family
  trains on it: ``tests/test_torch_tp_train.py``.
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
from repro.core import solver as jsolver
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro.quant import GridSpec as JSpec
from repro.serve import qparams as jqparams
from repro.serve.engine import PagedServingEngine as JPagedEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.dist import sharding as tsharding
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.serve import qparams as tqparams
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests._torch_dist import start_group, tp_rank, tp_serve
from tests.conftest import reduce_cfg

AXES = (1, 2, 3, 4, 16)
FP32_RTOL = 1e-5  # × max |logit|: prefill and decode at fp32
BF16_RTOL = 2e-2  # × max |logit|: prefill and decode at bf16
ENGINE_RTOL = 1e-4  # × each step's max |logit|: the engines' recorded logits
# Reduced widths every axis divides: head_dim 24 and d_ff 192 split over 2
# and 3 ranks (the 3-rank GQA wk/wv then shard on head_dim, their fused
# quantized rows inside a head: the gathers run).
OVER = dict(head_dim=24, d_ff=192)


# ---------------------------------------------------------------------------
# The plan and the layout tables
# ---------------------------------------------------------------------------


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _same_tree(t, j, path=""):
    """The port's shape/axes tree against the reference's, leaf for leaf."""
    if isinstance(t, tqparams.QTShape):
        assert (t.bits, t.group_size, t.packed) == (j.bits, j.group_size, j.packed), path
        for f in ("codes", "scale", "zero"):
            shape, dt = getattr(t, f)
            want = getattr(j, f)
            assert shape == tuple(want.shape) and _dtype_name(dt) == str(want.dtype), (path, f)
        return
    if isinstance(t, dict):
        jd = j if isinstance(j, dict) else {f: getattr(j, f) for f in t}
        assert sorted(t) == sorted(jd), path
        for k in t:
            _same_tree(t[k], jd[k], f"{path}.{k}")
        return
    if isinstance(t, tuple) and len(t) == 2 and isinstance(t[1], torch.dtype):
        assert t[0] == tuple(j.shape) and _dtype_name(t[1]) == str(j.dtype), path
        return
    assert t == j, (path, t, j)


@pytest.mark.parametrize("axis_n", AXES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_and_layout_tables_match_the_reference(arch, axis_n):
    jp, tp = jmodel.make_plan(jget(arch), axis_n), tmodel.make_plan(tget(arch), axis_n)
    assert (tp.axis_n, tp.vocab_pad, tp.kv_cache_dtype) == (jp.axis_n, jp.vocab_pad,
                                                             jp.kv_cache_dtype)
    assert dataclasses.asdict(tp.heads) == dataclasses.asdict(jp.heads)
    assert tmodel.param_axes(tp) == jmodel.param_axes(jp)
    shapes = tmodel.tree_map(lambda t: (tuple(t.shape), t.dtype), tmodel.param_shapes(tp),
                             is_leaf=torch.is_tensor)
    _same_tree(shapes, jmodel.param_shapes(jp))
    _same_tree(tqparams.qt_param_shapes(tp), jqparams.qt_param_shapes(jp))
    _same_tree(tqparams.qt_param_axes(tp), jqparams.qt_param_axes(jp))
    _same_tree(tmodel.cache_axes(tp), jmodel.cache_axes(jp))
    assert tqparams.qt_rules_extra(tp, axis_n) == jqparams.qt_rules_extra(jp, axis_n)


@pytest.mark.parametrize("axis_n", AXES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_rules_are_the_references_but_two_entries(arch, axis_n):
    """The port's serving table against ``launch.specs._rules_for`` on a
    ("model",) mesh of ``axis_n``: equal but where the port passes the
    per-expert ffn and the SSD heads (the reference passes 0 for both)."""
    from repro.launch.specs import _rules_for

    jp, tp = jmodel.make_plan(jget(arch), axis_n), tmodel.make_plan(tget(arch), axis_n)
    want = _rules_for(jp, types.SimpleNamespace(shape={"model": axis_n}), fsdp=False).table
    got = tqparams.serving_rules(tp, {"model": axis_n}).table
    assert sorted(got) == sorted(want)
    cfg = tp.cfg
    fits = lambda n: n > 0 and n % axis_n == 0
    differ = {k for k in got if got[k] != want[k]}
    expected = set()
    if cfg.moe_ff and not fits(cfg.n_experts) and not fits(cfg.moe_ff):
        # The reference's 0 reads as "fits".
        assert (want["expert_ffn"], got["expert_ffn"]) == ("model", None)
        expected.add("expert_ffn")
    if fits(cfg.ssm_nheads):  # the reference's 0 never splits
        assert (want["ssm_heads"], got["ssm_heads"]) == (None, "model")
        expected.add("ssm_heads")
    assert differ == expected, (differ, expected)


@pytest.mark.parametrize("args", [(32, 8, 160, 16), (40, 40, 128, 16), (56, 8, 128, 16),
                                  (20, 20, 64, 16), (32, 8, 128, 1), (4, 2, 24, 3),
                                  (4, 4, 24, 3), (0, 0, 64, 4)])
def test_head_plan_matches_the_reference(args):
    got = tcommon.make_head_plan(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcommon.make_head_plan(*args))
    assert got.h_pad == jcommon.make_head_plan(*args).h_pad


# ---------------------------------------------------------------------------
# Cases: the reference's padded plan on one device, the port's ranks
# ---------------------------------------------------------------------------


def _cfgs(arch, dtype=("float32", jnp.float32, torch.float32), **over):
    kw = dict(OVER, **over)
    jcfg = dataclasses.replace(reduce_cfg(jget(arch), **kw), dtype=dtype[1])
    tcfg = dataclasses.replace(reduce_cfg(tget(arch), **kw), dtype=dtype[2])
    windowed = lambda c: dataclasses.replace(c, pattern=tuple(
        dataclasses.replace(b, window=16 if b.window else None) for b in c.pattern))
    return windowed(jcfg), windowed(tcfg)


BF16 = ("bfloat16", jnp.bfloat16, torch.bfloat16)
# (label, arch, config overrides, dtype, artifact, engines)
CASES = [
    ("gqa", "phi3_mini_3_8b", {}, None, "dense", ("paged", "contiguous")),
    ("gqa_rtn4", "phi3_mini_3_8b", {}, None, "rtn4", ("paged_int8",)),
    ("gqa_group", "phi3_mini_3_8b", {}, None, "group16", ("paged",)),
    ("gqa_outlier", "phi3_mini_3_8b", {}, None, "qe_outlier", ("paged",)),
    ("mha_bias", "qwen15_32b", {"n_kv_heads": 4}, None, "dense", ("contiguous",)),
    ("mha_rtn4", "qwen15_32b", {"n_kv_heads": 4}, None, "rtn4", ()),
    ("gemma2", "gemma2_27b", {}, None, "dense", ("paged",)),
    ("opt", "opt_125m", {"n_kv_heads": 4}, None, "dense", ("contiguous",)),
    ("stablelm", "stablelm_12b", {}, None, "dense", ()),
    ("gqa_bf16", "phi3_mini_3_8b", {}, BF16, "dense", ()),
]
ENGINE_KW = {"paged": dict(max_batch=2, max_seq=64, page_size=8, prefill_chunk=16, n_pages=9),
             "paged_int8": dict(max_batch=2, max_seq=64, page_size=8, prefill_chunk=16),
             "contiguous": dict(max_batch=2, max_seq=64, prefill_pad=8)}


def _rtn_artifact(jp, params, group_size=None, outlier_frac=0.0, stacks=("dec",)):
    """The reference's ``rtn_quantize_for_serving`` loop (its
    ``quantize_tensor``, COO planes of the largest residuals and
    ``pack_codes``) with an optional group size, without its layout
    prepack: a packed 4-bit serving artifact of per-channel or grouped
    grids, of the ``stacks`` named (the reference's quantizes ``"dec"``;
    an encoder-decoder model's ``"enc"`` may be added)."""
    from repro.core.solver import QUANTIZABLE
    from repro.quant import quantize_tensor
    from repro.quant.pack import pack_codes

    def qt_of(name, leaf):
        out_f, d_in = jqparams._linear_meta(jp, name)[:2]
        w = np.asarray(leaf, np.float32).reshape(leaf.shape[0], d_in, out_f).transpose(0, 2, 1)
        qts = []
        for wi in w:
            qt = quantize_tensor(jnp.asarray(wi), JSpec(bits=4, group_size=group_size))
            if outlier_frac:
                resid = wi - np.asarray(qt.dequantize())
                idx = np.argsort(np.abs(resid).ravel())[-int(outlier_frac * resid.size):]
                qt = dataclasses.replace(
                    qt, outlier_values=jnp.asarray(resid.ravel()[idx], jnp.float16),
                    outlier_idx=jnp.asarray(idx.astype(np.int32)))
            qts.append(dataclasses.replace(qt, codes=pack_codes(qt.codes, 4), packed=True))
        return jax.tree.map(lambda *ls: jnp.stack(ls), *qts)

    out = dict(params)
    for stack in stacks:
        out[stack] = {k: {n: qt_of(n, v) if n in QUANTIZABLE else v for n, v in blk.items()}
                      for k, blk in params[stack].items()}
    return out


def _artifact(kind, jp, params, world):
    if kind == "dense":
        return params
    if kind == "rtn4":
        return _rtn_artifact(jp, params)
    if kind == "group16":
        return _rtn_artifact(jp, params, group_size=16)
    if world == 2:  # the same COO planes from round-to-nearest residuals
        return _rtn_artifact(jp, params, outlier_frac=0.05)
    r = np.random.default_rng(0)
    calib = [{"tokens": jnp.asarray(r.integers(0, jp.cfg.vocab, (2, 16)), jnp.int32)}]
    cfg = jsolver.PTQConfig(method="qe_outlier", spec=JSpec(bits=4), iterations=2,
                            outlier_frac=0.05, emit="qt")
    q, _ = jsolver.ptq_quantize_model(jp, params, calib, cfg)
    return jqparams.quantize_params_for_serving(jp, params, q["dec"])


def _case(label, arch, over, dtype, kind, engines, world, seed):
    """One case: the reference's padded plan, its params or artifact, and
    its prefill (whose cache every decode step starts from, so a bf16 cache
    entry one fp32 ulp apart cannot flip), with what a rank needs in
    port tensors."""
    jcfg, tcfg = _cfgs(arch, **({"dtype": dtype} if dtype else {}), **over)
    jp = jmodel.make_plan(jcfg, world)
    art = _artifact(kind, jp, jmodel.init_params(jp, jax.random.PRNGKey(seed)), world)
    rng = np.random.default_rng(100 + seed)
    tokens = rng.integers(0, jcfg.vocab, (2, 13)).astype(np.int32)
    cache = jmodel.init_cache(jp, 2, 32)
    logits, cache = jmodel.prefill(jp, art, {"tokens": jnp.asarray(tokens)}, cache)
    to_port = lambda tree: interop.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    return dict(
        label=label, jp=jp, jparams=art, kind=kind, jcache=cache,
        prefill=np.asarray(logits.astype(jnp.float32)),
        cfg=tcfg, params=to_port(art), quantized=kind != "dense", tokens=tokens,
        cache=to_port(cache), next=rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32),
        cap=32, prompts=[rng.integers(0, jcfg.vocab, n).astype(np.int32) for n in (5, 19, 11)],
        max_new=5, engines={e: ENGINE_KW[e] for e in engines},
    )


def _reference(case):
    """The reference's padded plan on one device: the decode step from the
    prefill's cache and each engine, as :func:`tests._torch_dist.tp_serve`
    runs the port."""
    jp, params, tokens = case["jp"], case["jparams"], case["tokens"]
    l2, cache = jmodel.decode_step(jp, params, jnp.asarray(case["next"]), case["jcache"],
                                   tokens.shape[1])
    wrote = [(np.asarray(c["k"][i, :, tokens.shape[1]].astype(jnp.float32)),
              np.asarray(c["v"][i, :, tokens.shape[1]].astype(jnp.float32)))
             for c in (cache[k] for k in sorted(cache)) for i in range(c["k"].shape[0])]
    out = {"prefill": case["prefill"], "decode": np.asarray(l2.astype(jnp.float32)),
           "wrote": wrote}
    for name, kw in case["engines"].items():
        if name == "contiguous":
            eng = JEngine(jp, params, record_logits=True, **kw)
        else:
            kv = "int8" if name == "paged_int8" else "bf16"
            eng = JPagedEngine(dataclasses.replace(jp, kv_cache_dtype=kv), params,
                               record_logits=True, **kw)
        for i, p in enumerate(case["prompts"]):
            eng.submit(JRequest(rid=i, prompt=p, max_new_tokens=case["max_new"]))
        eng.run()
        out[name] = ({r.rid: r.output for r in eng.finished}, eng.logit_trace)
    return out


def _sent(case):
    """What a rank needs (torch and numpy only: a rank loads no JAX)."""
    keep = ("cfg", "params", "quantized", "tokens", "cache", "next", "cap", "prompts",
            "max_new", "engines")
    return {k: case[k] for k in keep}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Per world size, one thread makes the cases, starts the group and
    runs the reference's padded plan on one device while the ranks work
    (the two threads' JAX compiles overlap)."""
    tmp = tmp_path_factory.mktemp("tp")
    groups = {}

    def world(w):
        cases = {c[0]: _case(*c, world=w, seed=i) for i, c in enumerate(CASES)}
        groups[w] = start_group(tp_rank, w, tmp, {k: _sent(c) for k, c in cases.items()})
        return cases, {k: _reference(c) for k, c in cases.items()}

    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            done = dict(zip((2, 3), pool.map(world, (2, 3))))
        yield ({w: d[0] for w, d in done.items()}, {w: d[1] for w, d in done.items()}, groups)
    finally:
        for g in groups.values():
            g.close()


@pytest.fixture(scope="module")
def tp2(tp_runs):
    cases, want, groups = tp_runs
    return cases[2], want[2], groups[2].result()


@pytest.fixture(scope="module")
def tp3(tp_runs):
    cases, want, groups = tp_runs
    return cases[3], want[3], groups[3].result()


@pytest.fixture
def tp(request, world):
    return request.getfixturevalue(f"tp{world}")


def _agree(want, got, rtol=ENGINE_RTOL):
    """Recorded logits within ``rtol`` of the step's max |logit| on every
    step both runs took with the same history; tokens equal while both
    top-2 margins exceed twice that."""
    (jo, jt), (to, tt) = want, got
    assert sorted(jo) == sorted(to)
    compared = 0
    for rid in jo:
        for j, (la, lb) in enumerate(zip(jt[rid], tt[rid])):
            tol = rtol * float(np.abs(la).max())
            np.testing.assert_allclose(lb, la, rtol=0, atol=tol)
            compared += 1
            if min(np.diff(np.sort(l)[-2:])[0] for l in (la, lb)) < 2 * tol:
                break
            assert jo[rid][j] == to[rid][j], (rid, j)
    return compared


def _rtol(case):
    return BF16_RTOL if case["cfg"].dtype == torch.bfloat16 else FP32_RTOL


def _decode_rtol(case, ref_wrote, got_wrote) -> float:
    """The decode step's bound.  It writes the new token's k and v into the
    bf16 cache and attends them: where an fp32 model's entry rounds to
    another bf16 value than the reference's (the partial sums' fp32
    difference at a rounding boundary) the logits move by ~1e-5 of their
    max, the engines' case (``ENGINE_RTOL``); with every entry equal,
    ``_rtol``."""
    same = all(np.array_equal(r, g) for rw, gw in zip(ref_wrote, got_wrote)
               for r, g in zip(rw, gw))
    return _rtol(case) if same or case["cfg"].dtype == torch.bfloat16 else ENGINE_RTOL


# ---------------------------------------------------------------------------
# The padded plan on one rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", ["gqa", "mha_bias", "gqa_outlier", "gemma2", "opt"])
def test_padded_plan_on_one_rank_is_the_references(tp_runs, label):
    cases, want, _ = tp_runs
    case, ref = cases[3][label], want[3][label]
    plan = tmodel.make_plan(case["cfg"], 3)
    hp = plan.heads
    assert plan.vocab_pad == 258 and hp.kv_pad == 6 and (hp.dup == 3) == (hp.n_kv == 2)
    got = tp_serve(plan, case["params"], case, tmodel.tree_map(torch.clone, case["cache"]))
    rtol = {"prefill": FP32_RTOL, "decode": _decode_rtol(case, ref["wrote"], got["wrote"])}
    for key in ("prefill", "decode"):
        assert got[key].shape == ref[key].shape == (2, 258)
        np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                   atol=rtol[key] * np.abs(ref[key]).max(), err_msg=key)
    for name in case["engines"]:
        assert _agree(ref[name], got[name]) >= len(case["prompts"])


# ---------------------------------------------------------------------------
# Tensor parallelism on gloo ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_tp_logits_match_the_padded_reference(tp, world, label):
    cases, want, got = tp
    case, ref = cases[label], want[label]
    # The ranks' written slots, side by side: the whole kv_pad of each entry.
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
@pytest.mark.parametrize("label,engine", [(c[0], e) for c in CASES for e in c[5]])
def test_tp_engines_match_the_padded_reference(tp, world, label, engine):
    cases, want, got = tp
    for out in (o[label] for o in got):
        assert out[engine][0] == got[0][label][engine][0], "ranks' tokens differ"
        assert _agree(want[label][engine], out[engine]) >= len(cases[label]["prompts"])


def _expected_bytes(case, world, rank):
    """Each leaf's bytes on ``rank``: from the whole artifact and the rules'
    layout, by the rule of the module docstring (numpy on the whole planes
    for the COO entries a rank owns)."""
    plan = tmodel.make_plan(case["cfg"], world)
    rules = tqparams.serving_rules(plan, {"model": world})
    axes = (tqparams.qt_param_axes(plan, case["params"]) if case["quantized"]
            else tmodel.param_axes(plan))
    out = {}

    def walk(node, ax, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], ax[k], f"{path}.{k}" if path else k)
            return
        if not isinstance(ax, dict):  # dense
            n = node.numel() * node.element_size()
            out[path] = n // world if rules.shard_dim(ax, "model") is not None else n
            return
        dim = rules.shard_dim(ax["codes"], "model")
        q, p = node.shape[-2:]
        for f in ("codes", "scale", "zero"):
            t = getattr(node, f)
            n = t.numel() * t.element_size()
            whole = dim is None or (f != "codes" and dim == t.dim() - 1 and not node.group_size)
            out[f"{path}.{f}"] = n if whole else n // world
        if node.outlier_idx is not None:
            idx = node.outlier_idx.numpy().reshape(-1, node.outlier_idx.shape[-1]).astype(np.int64)
            row, col = idx // p, idx % p
            if dim is None:
                count = idx.shape[-1]
            elif dim == node.codes.dim() - 2:
                ql = q // world
                count = int(((row >= rank * ql) & (row < (rank + 1) * ql)).sum(1).max())
            else:
                pl = p // world
                count = int(((col >= rank * pl) & (col < (rank + 1) * pl)).sum(1).max())
            lead = idx.shape[0]
            out[f"{path}.outlier_idx"] = lead * count * 4
            out[f"{path}.outlier_values"] = lead * count * 2

    walk(case["params"], axes, "")
    return out


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_each_rank_stores_exactly_its_shard(tp, world, label):
    cases, _, got = tp
    case = cases[label]
    for rank, out in enumerate(o[label] for o in got):
        assert out["bytes"] == _expected_bytes(case, world, rank), rank
    from repro_torch.tree import tree_leaves

    whole = sum(t.numel() * t.element_size() for t in tree_leaves(case["params"]))
    assert sum(got[0][label]["bytes"].values()) < whole


@pytest.mark.parametrize("world", [2, 3])
def test_tp_collectives_and_padding(tp, world):
    """One all-reduce a sublayer (two a layer) and the embedding's, plus the
    logits' all-gathers; at 3 the GQA k/v gathers too.  The padded plans of
    the cases are what the module docstring says."""
    cases, _, got = tp
    for label, case in cases.items():
        plan = tmodel.make_plan(case["cfg"], world)
        hp = plan.heads
        if world == 2:
            assert (hp.dup, hp.kv_pad, plan.vocab_pad) == (1, hp.n_kv, 256)
        else:
            assert hp.kv_pad == 6 and plan.vocab_pad == 258
            assert hp.dup == (3 if hp.n_kv == 2 else 1)
        calls = [[o[label]["comm"][k][:2] for k in ("all_reduce", "all_gather")] for o in got]
        assert all(c == calls[0] for c in calls), (label, calls)  # one SPMD program
        (reduces, _), (gathers, _) = calls[0]
        assert reduces > 0 and gathers > 0, label


# ---------------------------------------------------------------------------
# Shards and refusals without ranks
# ---------------------------------------------------------------------------


def _stub_mesh(n=2, rank=0):
    """A one-dim ("model",) mesh stub: sizes and a coordinate, no group."""
    return types.SimpleNamespace(mesh_dim_names=("model",), shape=(n,),
                                 get_local_rank=lambda axis: rank,
                                 get_group=lambda axis: None)


def test_shard_tree_refuses_what_cannot_split():
    from repro_torch.quant import GridSpec, QuantizedTensor, pack_codes, quantize_tensor

    qt = quantize_tensor(torch.randn(8, 6), GridSpec(bits=4))
    packed = dataclasses.replace(qt, codes=pack_codes(qt.codes, 4), packed=True)
    rules = tsharding.make_rules({"model": 2}, d_ff=6)  # 3 columns a rank: inside a byte
    row = {"codes": (None, "ffn"), "scale": (None, None), "zero": (None, None)}
    with pytest.raises(ValueError, match="w.wd: 4-bit packed codes"):
        tsharding.shard_tree({"w": {"wd": packed}}, {"w": {"wd": row}}, rules, rank=0)
    grouped = quantize_tensor(torch.randn(8, 24), GridSpec(bits=4, group_size=16))
    with pytest.raises(ValueError, match="wd: group_size 16 does not give each of 3 ranks"):
        tsharding.shard_tree({"wd": grouped}, {"wd": row},
                             tsharding.make_rules({"model": 3}, d_ff=24), rank=1)
    with pytest.raises(TypeError, match="qt_param_axes"):
        tsharding.shard_tree({"wd": qt}, {"wd": (None, "ffn")}, rules, rank=0)
    assert isinstance(qt, QuantizedTensor)


def test_shard_tree_coo_planes_rebase():
    """COO entries go to the rank owning each, re-based; the rank's planes
    rebuild its block of the dense matrix exactly."""
    from repro_torch.quant import GridSpec, dequantize_tensor, quantize_tensor

    r = torch.Generator().manual_seed(0)
    w = torch.randn(2, 6, 8, generator=r)
    base = quantize_tensor(w, GridSpec(bits=4))
    idx = torch.stack([torch.randperm(48, generator=r)[:7] for _ in range(2)]).to(torch.int32)
    vals = torch.randn(2, 7, generator=r).to(torch.float16)
    qt = dataclasses.replace(base, outlier_idx=idx, outlier_values=vals)
    whole = dequantize_tensor(qt)
    for axes, dim in (({"codes": (None, "ffn", None), "scale": (None, "ffn", None),
                        "zero": (None, "ffn", None)}, 1),
                      ({"codes": (None, None, "ffn"), "scale": (None, None, None),
                        "zero": (None, None, None)}, 2)):
        rules = tsharding.make_rules({"model": 2}, d_ff=8 if dim == 2 else 6)
        for rank in range(2):
            part = tsharding.shard_tree({"w": qt}, {"w": axes}, rules, rank=rank)["w"]
            size = whole.shape[dim] // 2
            want = whole.narrow(dim, rank * size, size)
            assert torch.equal(dequantize_tensor(part), want), (dim, rank)


@pytest.mark.parametrize("arch,item", [("whisper_large_v3", "8.1.4"),
                                       ("llava_next_34b", "8.1.4")])
def test_families_outside_the_slice_refuse_a_model_axis(arch, item):
    """The encoder-decoder and prefix families refused a model axis until
    ROADMAP item ``item`` lifted it: under the stub mesh's serving rules
    ``init_cache`` now gives ``k``/``v`` and Whisper's ``ck``/``cv`` the
    rank's kv slots (``cache_axes`` puts them on "heads"), as ``shard_tree``
    cuts the whole plan's cache (their parity on ranks:
    ``tests/test_torch_tp_encdec.py``)."""
    assert item == "8.1.4"
    cfg = dataclasses.replace(reduce_cfg(tget(arch)), dtype=torch.float32)
    plan = tmodel.make_plan(cfg, 2)
    rules = tqparams.serving_rules(plan, _stub_mesh(rank=1))
    whole = tmodel.init_cache(plan, 1, 16, device="cpu")
    with tsharding.axis_rules(rules):
        local = tmodel.init_cache(plan, 1, 16, device="cpu")
    cut = tsharding.shard_tree(whole, tmodel.cache_axes(plan), rules, rank=1)
    names = ("k", "v", "ck", "cv") if cfg.family == "encdec" else ("k", "v")
    for blk in local:
        assert sorted(local[blk]) == sorted(names)
        for k in names:
            assert local[blk][k].shape == cut[blk][k].shape
            assert local[blk][k].shape[3] == plan.heads.kv_pad // 2 == whole[blk][k].shape[3] // 2
    if cfg.family == "encdec":
        assert local["b0"]["ck"].shape[2] == cfg.n_frames


def test_speculation_deadlines_training_and_plan_refuse_a_model_axis(monkeypatch):
    """Speculation and deadlines on a model axis (ROADMAP item 8.1.5) are
    accepted: a spec engine builds, and a deadline request enters either
    engine, timestamped by the agreed clock (rank 0's reading, here the stub
    mesh's broadcast standing in for the collective; on gloo ranks:
    ``tests/test_torch_tp_spec.py``).  A plan padded for no axis still
    refuses the axis' rules."""
    from repro_torch.dist import collectives
    from repro_torch.serve import AgreedClock, PagedServingEngine, Request, ServingEngine
    from repro_torch.serve.spec import SpecConfig, truncate_draft

    monkeypatch.setattr(collectives, "broadcast_from", lambda value, mesh, axis: value)
    cfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b")), dtype=torch.float32)
    plan = tmodel.make_plan(cfg, 2)
    params = tmodel.init_params(plan, 0, device="cpu")
    with tsharding.axis_rules(tqparams.serving_rules(plan, _stub_mesh())):
        spec = SpecConfig(*truncate_draft(plan, params, 1), gamma=2)
        eng = PagedServingEngine(plan, params, max_batch=1, max_seq=32, spec=spec, device="cpu")
        assert eng.spec_mgr is not None
        for cls in (PagedServingEngine, ServingEngine):
            eng = cls(plan, params, max_batch=1, max_seq=32, clock=lambda: 7.0, device="cpu")
            assert isinstance(eng.clock, AgreedClock)
            req = Request(rid=0, prompt=np.ones(3, np.int32), max_new_tokens=2, deadline_ms=50.0)
            eng.submit(req)
            assert req.status == "queued" and req.submit_t == 7.0 and req.deadline_at() == 7.0 + 50.0 / 1e3
        with pytest.raises(ValueError, match="axis_n=2"):
            tmodel.init_cache(tmodel.make_plan(cfg), 1, 16, device="cpu")
