"""The port's configs and its model on every ported architecture, against
the reference.

* Every config the port registers equals the reference's field for field
  (``dtype`` aside), ``list_configs`` agrees (every architecture of the
  reference is ported), and the model takes cross-attention, the
  encoder-decoder family and a prefix.
* Reduced (``reduce_cfg``) fp32 models of each new architecture, the
  reference's params carried across with ``repro_torch.interop``: the
  train loss (MoE router loss included) and hidden states within 1e-5
  relative; prefill, decode, paged-prefill and paged-decode logits within
  1e-5 of max |logit|.  Windowed models are cut to a 16-token window so
  the ring buffer and the paged window mask are exercised.
* Both serving engines give the reference's greedy tokens on a reduced OPT
  and a reduced OLMoE (logits within 1e-4 of each step's max |logit|,
  tokens equal while the top-2 margins exceed twice that: the rule of
  ``tests/test_torch_paged_engine.py``, whose bf16 KV pages flip an entry
  by an ulp now and then).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.eval import scorer as jscorer
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.models import model as jm
from repro.serve.engine import PagedServingEngine as JPagedEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.models import model as tm
from repro_torch.serve import PagedServingEngine, Request, ServingEngine
from repro_torch.serve.kv_cache import NULL_PAGE
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401

NEW_ARCHS = ("qwen15_32b", "stablelm_12b", "gemma2_27b", "opt_125m", "olmoe_1b_7b",
             "mixtral_8x22b")
OPT = ("opt_125m", "opt_350m", "opt_1_3b", "opt_6_7b", "opt_66b")
TOL = 1e-5


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


def _same_fields(tcfg, jcfg) -> bool:
    a, b = _fields(tcfg), _fields(jcfg)
    for k in ("pattern", "enc_pattern"):  # each package's own BlockDef
        a[k] = [dataclasses.asdict(x) for x in a[k]]
        b[k] = [dataclasses.asdict(x) for x in b[k]]
    return a == b


@pytest.mark.parametrize("name", tbase.ARCH_IDS + OPT)
def test_config_equals_reference(name):
    tcfg, jcfg = tbase.get_config(name), jbase.get_config(name)
    assert _same_fields(tcfg, jcfg)
    assert tcfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    assert (tcfg.hd, tcfg.n_layers, tcfg.moe_ff) == (jcfg.hd, jcfg.n_layers, jcfg.moe_ff)


def test_list_configs_agrees_and_the_rest_is_refused():
    """Every architecture of the reference is ported: ``ARCH_IDS`` and
    ``list_configs()`` equal the reference's, nothing is left to refuse
    (``NOT_PORTED`` is empty), and the model takes cross-attention, the
    encoder-decoder family and a prefix."""
    jbase.get_config("opt_125m")  # the reference lists the OPT family once imported
    ref = set(jbase.list_configs())
    port = tbase.list_configs()
    assert port == sorted(port)
    assert tbase.ARCH_IDS == jbase.ARCH_IDS and tbase.NOT_PORTED == ()
    assert set(port) == ref
    whisper = tbase.get_config("whisper_large_v3")
    assert whisper.family == "encdec" and whisper.pattern[0].cross
    assert tbase.get_config("llava_next_34b").n_prefix == 2880
    phi3 = tbase.get_config("phi3_mini_3_8b")
    enc = dict(family="encdec", enc_pattern=(tbase.BlockDef(causal=False),), n_enc_periods=1)
    for cfg in (dataclasses.replace(phi3, pattern=(tbase.BlockDef(cross=True),), **enc),
                dataclasses.replace(phi3, **enc), dataclasses.replace(phi3, n_prefix=16)):
        assert tm.make_plan(cfg).cfg == cfg
    # Cross-attention outside an encoder-decoder model has nothing to attend.
    with pytest.raises(ValueError, match="cross-attention needs"):
        tm.make_plan(dataclasses.replace(phi3, pattern=(tbase.BlockDef(cross=True),)))


# ---------------------------------------------------------------------------
# The forward paths, reduced fp32, against the reference
# ---------------------------------------------------------------------------


def _reduced(cfg, dtype):
    cfg = reduce_cfg(cfg)
    pattern = tuple(dataclasses.replace(b, window=16 if b.window else None) for b in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pattern, dtype=dtype)


def _pair(arch, seed=0, kv="bf16"):
    jp = jplan(_reduced(jbase.get_config(arch), jnp.float32), 1, kv_cache_dtype=kv)
    tp = tm.make_plan(_reduced(tbase.get_config(arch), torch.float32), kv_cache_dtype=kv)
    params = jinit(jp, jax.random.PRNGKey(seed))
    # Non-trivial norms so the (1 + scale) and LayerNorm conventions show.
    params["final_norm"] = jax.tree.map(lambda a: a + 0.01, params["final_norm"])
    return jp, params, tp, interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _close(t, j, what):
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape, what
    err = float(np.abs(t - j).max()) / float(np.abs(j).max())
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_loss_and_hidden_states_match(arch):
    jp, params, tp, tparams = _pair(arch)
    assert tm.tree_map(lambda a: tuple(a.shape), tm.init_params(tp, 0, device="cpu")) == \
        jax.tree.map(lambda a: tuple(a.shape), params)
    toks = np.random.default_rng(1).integers(0, jp.cfg.vocab, (2, 40)).astype(np.int32)
    jl = float(jm.train_loss(jp, params, {"tokens": jnp.asarray(toks)}))
    tl = float(tm.train_loss(tp, tparams, {"tokens": toks}))
    assert tl == pytest.approx(jl, rel=TOL)
    _close(tm.hidden_states(tp, tparams, torch.from_numpy(toks).long()),
           jscorer._hidden_states(jp, params, jnp.asarray(toks)), "hidden")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode_logits_match(arch):
    jp, params, tp, tparams = _pair(arch)
    r = np.random.default_rng(2)
    toks = r.integers(0, jp.cfg.vocab, (2, 24)).astype(np.int32)
    jl, jc = jm.prefill(jp, params, {"tokens": jnp.asarray(toks)}, jm.init_cache(jp, 2, 64))
    tl, tc = tm.prefill(tp, tparams, {"tokens": toks}, tm.init_cache(tp, 2, 64, device="cpu"))
    _close(tl, jl, "prefill")
    pos = np.array([24, 13], np.int32)
    for step in range(3):
        nxt = r.integers(0, jp.cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, params, jnp.asarray(nxt), jc, jnp.asarray(pos + step))
        tl, tc = tm.decode_step(tp, tparams, nxt, tc, pos + step)
        _close(tl, jl, f"decode {step}")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_paged_prefill_and_decode_logits_match(arch):
    """One sequence prefilled in two chunks (the second padded past its
    table), one in a single chunk, then three batched decode steps with a
    lane left inactive."""
    jp, params, tp, tparams = _pair(arch)
    psz, P = 8, 12
    jc, tc = jm.init_paged_cache(jp, P, psz), tm.init_paged_cache(tp, P, psz, device="cpu")
    r = np.random.default_rng(3)
    rows = np.array([[3, 5, 1, 7], [2, 9, 0, 0], [0, 0, 0, 0]], np.int32)
    prompt0 = r.integers(0, jp.cfg.vocab, 29).astype(np.int32)
    prompt1 = r.integers(0, jp.cfg.vocab, 11).astype(np.int32)
    for row, chunks in ((0, [(0, prompt0[:16]), (16, prompt0[16:])]), (1, [(0, prompt1)])):
        for off, part in chunks:
            buf = np.zeros((1, 24), np.int32)
            buf[0, : len(part)] = part
            pt = rows[row : row + 1]
            jc = jm.paged_prefill_chunk(jp, params, jnp.asarray(buf), jc, jnp.asarray(pt), off)
            tc = tm.paged_prefill_chunk(tp, tparams, buf, tc, pt, off)
    pos = np.array([29, 11, 0], np.int32)
    for step in range(3):
        p = pos + np.array([step, step, 0], np.int32)
        wp = np.array([rows[0, p[0] // psz], rows[1, p[1] // psz], NULL_PAGE], np.int32)
        toks = r.integers(0, jp.cfg.vocab, (3, 1)).astype(np.int32)
        jl, jc = jm.paged_decode_step(jp, params, jnp.asarray(toks), jc, jnp.asarray(p),
                                      jnp.asarray(rows), jnp.asarray(wp))
        tl, tc = tm.paged_decode_step(tp, tparams, toks, tc, p, rows, wp)
        _close(tl[:2], np.asarray(jl)[:2], f"paged decode {step}")


def _short_opt():
    """A reduced fp32 OPT whose learned positions end at 32."""
    cfg = dataclasses.replace(_reduced(tbase.get_config("opt_125m"), torch.float32), max_seq=32)
    tp = tm.make_plan(cfg)
    return tp, tm.init_params(tp, 0, device="cpu")


@pytest.mark.parametrize("what", ["train", "prefill", "contiguous engine", "paged engine"])
def test_learned_positions_refuse_sequences_past_max_seq(what):
    """A training sequence or a prefill longer than the learned position
    table, or an engine whose max_seq passes it, is refused (the
    reference's slice raises there too, and its decode gather reads NaN)."""
    tp, params = _short_opt()
    toks = np.zeros((1, 33), np.int32)
    with pytest.raises(ValueError, match="max_seq 32"):
        if what == "train":
            tm.train_loss(tp, params, {"tokens": toks})
        elif what == "prefill":
            tm.prefill(tp, params, {"tokens": toks}, tm.init_cache(tp, 1, 40, device="cpu"))
        elif what == "contiguous engine":
            ServingEngine(tp, params, max_batch=1, max_seq=33, device="cpu")
        else:
            PagedServingEngine(tp, params, max_batch=1, max_seq=33, page_size=8, device="cpu")
    tm.train_loss(tp, params, {"tokens": toks[:, :32]})  # the whole table is usable


def test_pad_lanes_past_max_seq_get_no_position():
    """Positions past the learned table (pad lanes of a chunk or a verify)
    add no positional term; positions inside it add their row."""
    tp, params = _short_opt()
    toks = torch.tensor([[5, 6, 7, 8]])
    pos = torch.tensor([0, 31, 32, 40])
    x = tm._embed(tp, params, toks, pos)
    tok = params["embed"][toks]
    torch.testing.assert_close(x[0, :2], tok[0, :2] + params["pos_emb"][pos[:2]], rtol=0, atol=0)
    torch.testing.assert_close(x[0, 2:], tok[0, 2:], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Both serving engines against the reference's
# ---------------------------------------------------------------------------


def _agree(outs, traces, rtol=1e-4):
    (jo, to), (jt, tt) = outs, traces
    assert sorted(jo) == sorted(to)
    compared = 0
    for rid in jo:
        for j, (la, lb) in enumerate(zip(jt[rid], tt[rid])):
            tol = rtol * float(np.abs(la).max())
            np.testing.assert_allclose(lb, la, rtol=0, atol=tol)
            compared += 1
            if min(np.diff(np.sort(l)[-2:])[0] for l in (la, lb)) < 2 * tol:
                break  # a near-tie: the streams may part here
            assert jo[rid][j] == to[rid][j]
    return compared


@pytest.mark.parametrize("engine", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", ["opt_125m", "olmoe_1b_7b"])
def test_engines_give_the_reference_tokens(arch, engine):
    jp, params, tp, tparams = _pair(arch, seed=4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jp.cfg.vocab, n).astype(np.int32) for n in (6, 21, 35)]
    if engine == "paged":
        kw = dict(max_batch=2, max_seq=96, page_size=8, prefill_chunk=16, record_logits=True)
        jeng, teng = JPagedEngine(jp, params, **kw), PagedServingEngine(tp, tparams, device="cpu",
                                                                         **kw)
    else:
        kw = dict(max_batch=2, max_seq=96, prefill_pad=8, record_logits=True)
        jeng, teng = JEngine(jp, params, **kw), ServingEngine(tp, tparams, device="cpu", **kw)
    for eng, req in ((jeng, JRequest), (teng, Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=p, max_new_tokens=5))
        eng.run()
    outs = [{r.rid: r.output for r in e.finished} for e in (jeng, teng)]
    assert _agree(outs, [e.logit_trace for e in (jeng, teng)]) >= len(prompts)
