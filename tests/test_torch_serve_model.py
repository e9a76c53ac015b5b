"""Port parity for the serving slice's model side: int4 KV packing, the KV
quantizers, the paged-attention plain version, flash attention with a query
offset, the four serving forward functions, the page pool and fault plans.

The same numpy inputs go to the JAX package and to the port.  Tolerances:
integer results (packed bytes, codes, page ids, fault schedules) exactly;
KV scales bit for bit where both packages quantize the same values; fp32
attention at rtol 1e-5 (the two sum in other orders); the Pallas kernel in
interpret mode at atol 2e-2 (it keeps p in fp32 where the plain version
rounds it to bf16, as the reference's own test allows); logits of the
reduced fp32 model at rtol 1e-4, as ``tests/test_torch_model.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.faults import FaultPlan as JFaultPlan
from repro.faults import FaultSpec as JFaultSpec
from repro.faults import TransientFault as JTransientFault
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.models import model as jm
from repro.models.common import flash_attention as jflash
from repro.quant.pack import kv_pack_int4 as jpack4
from repro.serve.kv_cache import PagePool as JPagePool
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.faults import FaultPlan, FaultSpec, TransientFault, fault_plan, fault_point
from repro_torch.kernels import ops, ref
from repro_torch.models import model as tm
from repro_torch.models.common import decode_attention, flash_attention
from repro_torch.quant import kv_pack_int4, kv_unpack_int4
from repro_torch.serve.kv_cache import NULL_PAGE, PagePool, page_nbytes
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401


def _t(a):
    return interop.tensor_from_numpy(np.asarray(a), device="cpu")


def _np(t):
    return t.to(torch.float32).numpy() if t.is_floating_point() else t.numpy()


# ---------------------------------------------------------------------------
# int4 KV packing and the KV quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hd", [8, 24, 96])
def test_kv_pack_int4_matches_jax(hd):
    codes = np.random.default_rng(hd).integers(-8, 8, (3, 5, 2, hd)).astype(np.int8)
    packed = kv_pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpack4(jnp.asarray(codes))))
    assert packed.dtype == torch.uint8 and packed.shape[-1] == hd // 2
    np.testing.assert_array_equal(kv_unpack_int4(packed).numpy(), codes)
    with pytest.raises(ValueError):
        kv_pack_int4(torch.zeros(2, 7, dtype=torch.int8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_kv_quantizers_match_jax(kind, dtype):
    r = np.random.default_rng(7)
    x = (r.standard_normal((4, 9, 3, 24)) * r.uniform(0.01, 3.0, (4, 9, 3, 1))).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = _t(np.asarray(xj))
    jq = jm._kv_quantize4 if kind == "int4" else jm._kv_quantize
    tq = tm._kv_quantize4 if kind == "int4" else tm._kv_quantize
    (jc, js), (tc, ts) = jq(xj), tq(xt)
    assert tc.dtype == (torch.uint8 if kind == "int4" else torch.int8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---------------------------------------------------------------------------
# Paged attention: the plain version against the reference's two
# ---------------------------------------------------------------------------


def _paged_inputs(seed, *, kind, B=3, KVp=2, G=2, hd=16, psz=8, P=9, npg=4, q_dtype=np.float32):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, KVp, G, hd)).astype(np.float32)
    ks = vs = None
    if kind == "bf16":
        kp = r.standard_normal((P, psz, KVp, hd)).astype(np.float32)
        vp = r.standard_normal((P, psz, KVp, hd)).astype(np.float32)
    else:
        lim = 127 if kind == "int8" else 7
        kp = r.integers(-lim, lim + 1, (P, psz, KVp, hd)).astype(np.int8)
        vp = r.integers(-lim, lim + 1, (P, psz, KVp, hd)).astype(np.int8)
        ks = (r.random((P, psz, KVp, 1)) * 0.02 + 1e-3).astype(np.float32)
        vs = (r.random((P, psz, KVp, 1)) * 0.02 + 1e-3).astype(np.float32)
    pt = r.integers(0, P, (B, npg)).astype(np.int32)
    ln = r.integers(1, npg * psz + 1, (B,)).astype(np.int32)
    ln[0] = 1  # edge cases: a single token, and an exact multiple of the page
    if B > 1:
        ln[1] = 2 * psz
    jq = jnp.asarray(q).astype(jnp.dtype(q_dtype))
    if kind == "bf16":
        jkp, jvp = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    elif kind == "int8":
        jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    else:
        jkp, jvp = jpack4(jnp.asarray(kp)), jpack4(jnp.asarray(vp))
    j = dict(q=jq, k_pages=jkp, v_pages=jvp, page_table=jnp.asarray(pt), lengths=jnp.asarray(ln),
             k_scale_pages=None if ks is None else jnp.asarray(ks),
             v_scale_pages=None if vs is None else jnp.asarray(vs))
    t = {k: None if v is None else _t(np.asarray(v)) for k, v in j.items()}
    return j, t


def _call(fn, d, **kw):
    return fn(d["q"], d["k_pages"], d["v_pages"], d["page_table"], d["lengths"],
              k_scale_pages=d["k_scale_pages"], v_scale_pages=d["v_scale_pages"], **kw)


_OPTIONS = [(None, None), (9, None), (None, 30.0), (13, 5.0)]


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("window,cap", _OPTIONS)
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_paged_attention_ref_matches_jax_ref(kind, window, cap, G):
    seed = 100 * ["bf16", "int8", "int4"].index(kind) + 10 * _OPTIONS.index((window, cap)) + G
    j, t = _paged_inputs(seed, kind=kind, G=G)
    jo = np.asarray(_call(jref.paged_attention_ref, j, window=window, attn_softcap=cap))
    to = _call(ref.paged_attention_ref, t, window=window, attn_softcap=cap)
    assert to.dtype == torch.float32 and to.shape == t["q"].shape
    np.testing.assert_allclose(to.numpy(), jo, rtol=1e-5, atol=1e-6)
    # ops dispatch sends CPU tensors to the plain version, bit for bit.
    od = _call(ops.paged_attention, t, window=window, attn_softcap=cap)
    assert torch.equal(od, to)


@pytest.mark.parametrize("window,cap", _OPTIONS)
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_paged_attention_ref_matches_pallas_interpret(kind, window, cap):
    j, t = _paged_inputs(11, kind=kind, q_dtype=jnp.bfloat16)
    jo = np.asarray(_call(paged_attention_pallas, j, window=window, attn_softcap=cap,
                          interpret=True), np.float32)
    to = _call(ref.paged_attention_ref, t, window=window, attn_softcap=cap)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(to), jo, atol=2e-2)


def test_paged_ref_bit_identical_to_contiguous_read():
    """A paged read over the same KV values is bit-identical to the
    contiguous decode_attention read (the engines' token identity rests on
    it)."""
    _, t = _paged_inputs(5, kind="bf16", q_dtype=jnp.bfloat16)
    q, kp, vp, pt, ln = (t[k] for k in ("q", "k_pages", "v_pages", "page_table", "lengths"))
    B, KVp, G, hd = q.shape
    S = pt.shape[1] * kp.shape[1]
    kc = kp[pt.long()].reshape(B, S, KVp, hd)
    vc = vp[pt.long()].reshape(B, S, KVp, hd)
    o_pg = ref.paged_attention_ref(q, kp, vp, pt, ln)
    o_ct = decode_attention(q[:, None], kc, vc, ln)[:, 0]
    assert torch.equal(o_pg, o_ct)


def test_paged_dispatch_guards():
    _, t = _paged_inputs(3, kind="int8")
    args = [t[k] for k in ("q", "k_pages", "v_pages", "page_table", "lengths")]
    with pytest.raises(ValueError):
        ops.paged_attention(*args)  # int8 pages need scale planes
    with pytest.raises(ValueError):
        ops.paged_attention(*args, k_scale_pages=t["k_scale_pages"])  # both or none
    _, t4 = _paged_inputs(3, kind="int4")
    with pytest.raises(ValueError):
        ops.paged_attention(*[t4[k] for k in ("q", "k_pages", "v_pages", "page_table", "lengths")])
    out = ops.paged_attention(*args, k_scale_pages=t["k_scale_pages"],
                              v_scale_pages=t["v_scale_pages"])
    assert out.shape == args[0].shape
    with pytest.raises(ValueError, match="span devices"):
        ops.paged_attention(*args[:4], args[4].to("meta"), k_scale_pages=t["k_scale_pages"],
                            v_scale_pages=t["v_scale_pages"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 300])
def test_flash_attention_q_offset_matches_jax(dtype, window):
    """Chunked prefill attends a 128-query chunk at offset 1408 over 1536
    keys: the reference walks two kv chunks of 1024 with an online softmax,
    the port takes them at once.  fp32: rtol 1e-5.  bf16: within 1 % of
    max |o|, because the reference rounds p to bf16 against each kv chunk's
    running max and the port against the row's max (0.45 % observed without
    a window; with the window the reference visits one band and they agree
    exactly)."""
    r = np.random.default_rng(1)
    Sk, Sq, off = 1536, 128, 1408
    q = r.standard_normal((1, Sq, 2, 2, 16)).astype(np.float32)
    k = r.standard_normal((1, Sk, 2, 16)).astype(np.float32)
    v = r.standard_normal((1, Sk, 2, 16)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jo = np.asarray(jflash(jq, jk, jv, causal=True, window=window, q_offset=off), np.float32)
    to = _np(flash_attention(_t(np.asarray(jq)), _t(np.asarray(jk)), _t(np.asarray(jv)),
                             causal=True, window=window, q_offset=off))
    if dtype == "float32":
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-2 * np.abs(jo).max())


# ---------------------------------------------------------------------------
# The serving forward functions on a reduced fp32 Phi-3
# ---------------------------------------------------------------------------


def _pair(kv):
    over = dict(d_model=96, head_dim=24, d_ff=192)
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b"), **over), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b"), **over), dtype=torch.float32)
    jp, tp = jplan(jcfg, 1, kv_cache_dtype=kv), tm.make_plan(tcfg, kv_cache_dtype=kv)
    params = jinit(jp, jax.random.PRNGKey(0))
    return jp, params, tp, interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _assert_cache_close(jc, tc):
    """bf16 K/V bytes and int8/int4 codes: equal in all but 0.1 % of entries,
    and elsewhere within one bf16 ulp plus 1e-6 (an fp32 sum that rounds the
    other way; near-zero entries come from cancelling sums of O(0.1) terms)
    or one code step; scales at rtol 1e-6."""
    for blk, leaves in jc.items():
        for name, ja in leaves.items():
            a, b = np.asarray(ja.astype(jnp.float32)), _np(tc[blk][name])
            if name in ("ks", "vs"):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
                continue
            if ja.dtype == jnp.uint8:
                a = np.asarray(jnp.concatenate([(ja & 0xF), (ja >> 4)], -1), np.float32)
                b = np.concatenate([b.astype(np.int64) & 0xF, b.astype(np.int64) >> 4], -1)
            tol = 1 if ja.dtype in (jnp.int8, jnp.uint8) else 2 ** -7 * np.abs(a) + 1e-6
            assert np.all(np.abs(a - b) <= tol), (blk, name)
            assert np.mean(a != b) <= 1e-3, (blk, name)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_and_decode_step_match_jax(kv):
    jp, params, tp, tparams = _pair(kv)
    r = np.random.default_rng(2)
    toks = r.integers(0, 256, (2, 24)).astype(np.int32)
    jl, jc = jm.prefill(jp, params, {"tokens": jnp.asarray(toks)}, jm.init_cache(jp, 2, 64))
    tl, tc = tm.prefill(tp, tparams, {"tokens": toks}, tm.init_cache(tp, 2, 64, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    _assert_cache_close(jc, tc)
    pos = np.array([23, 11], np.int32)  # per-slot positions
    for step in range(3):
        nxt = r.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, params, jnp.asarray(nxt), jc, jnp.asarray(pos + step))
        tl, tc = tm.decode_step(tp, tparams, nxt, tc, pos + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-5)
    _assert_cache_close(jc, tc)


@pytest.mark.parametrize("kv", ["bf16", "int8", "int4"])
def test_paged_prefill_chunk_and_decode_step_match_jax(kv):
    """Two sequences: one prefilled in two chunks (the second padded past
    its table, so pad positions go to the null page), one in a single
    chunk; then three batched decode steps with a lane left inactive."""
    jp, params, tp, tparams = _pair(kv)
    psz, P = 8, 12
    jc, tc = jm.init_paged_cache(jp, P, psz), tm.init_paged_cache(tp, P, psz, device="cpu")
    r = np.random.default_rng(3)
    rows = np.array([[3, 5, 1, 7], [2, 9, 0, 0], [0, 0, 0, 0]], np.int32)
    prompt0 = r.integers(0, 256, 29).astype(np.int32)
    prompt1 = r.integers(0, 256, 11).astype(np.int32)
    for row, chunks in ((0, [(0, prompt0[:16]), (16, prompt0[16:])]), (1, [(0, prompt1)])):
        for off, part in chunks:
            buf = np.zeros((1, 24), np.int32)
            buf[0, : len(part)] = part
            pt = rows[row : row + 1]
            jc = jm.paged_prefill_chunk(jp, params, jnp.asarray(buf), jc, jnp.asarray(pt), off)
            tc = tm.paged_prefill_chunk(tp, tparams, buf, tc, pt, off)
    _assert_cache_close(jc, tc)
    pos = np.array([28, 10, 0], np.int32)
    for step in range(3):
        p = pos + np.array([step, step, 0], np.int32)
        wp = np.array([rows[0, p[0] // psz], rows[1, p[1] // psz], NULL_PAGE], np.int32)
        toks = r.integers(0, 256, (3, 1)).astype(np.int32)
        jl, jc = jm.paged_decode_step(jp, params, jnp.asarray(toks), jc, jnp.asarray(p),
                                      jnp.asarray(rows), jnp.asarray(wp))
        tl, tc = tm.paged_decode_step(tp, tparams, toks, tc, p, rows, wp)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=1e-4, atol=1e-5)
    _assert_cache_close(jc, tc)


def test_cache_shapes_match_jax_and_refusals():
    for kv in ("bf16", "int8", "int4"):
        jp, _, tp, _ = _pair(kv)
        jshape = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), jm.paged_cache_shapes(jp, 6, 8))
        tshape = tm.tree_map(lambda sd: (tuple(sd[0]), str(sd[1]).replace("torch.", "")),
                             tm.paged_cache_shapes(tp, 6, 8), is_leaf=lambda x: isinstance(x, tuple))
        assert tshape == jshape
        if kv == "int4":
            with pytest.raises(ValueError, match="paged"):
                tm.init_cache(tp, 2, 16, device="cpu")
            continue
        jshape = jax.tree.map(lambda s: tuple(s.shape), jm.cache_shapes(jp, 3, 40))
        tshape = {b: {k: tuple(s) for k, (s, _) in v.items()} for b, v in tm.cache_shapes(tp, 3, 40).items()}
        assert tshape == jshape
    cross = dataclasses.replace(tp.cfg, pattern=(dataclasses.replace(tp.cfg.pattern[0], cross=True),))
    with pytest.raises(ValueError, match="self-attention"):
        tm.paged_cache_shapes(dataclasses.replace(tp, cfg=cross), 6, 8)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        tm.make_plan(tp.cfg, kv_cache_dtype="fp8")


def test_page_nbytes_prices_int4_at_half_a_byte():
    assert page_nbytes(16, 32, 96, 2, "bf16") == 2 * 16 * 32 * 96 * 2 * 2
    assert page_nbytes(16, 32, 96, 2, "int4") < page_nbytes(16, 32, 96, 2, "int8")


# ---------------------------------------------------------------------------
# Page pool and fault plans: the same calls give the same results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_pool_matches_jax_pool(seed):
    """A seeded random sequence of alloc, release, incref, register,
    match_full and match_partial calls (with token prefixes drawn from a
    small alphabet, so hits, COW sources and evictions all happen) gives the
    same page ids, counts and prefix-cache state in both pools."""
    r = np.random.default_rng(seed)
    psz = 4
    pools = (PagePool(9, psz), JPagePool(9, psz))
    held: list[int] = []
    for _ in range(400):
        op = r.integers(0, 6)
        toks = tuple(int(t) for t in r.integers(0, 2, psz * int(r.integers(1, 4)) + int(r.integers(0, psz))))
        if op == 0:
            n = int(r.integers(1, 3))
            got = [p.alloc(n) for p in pools]
            assert got[0] == got[1]
            held += got[0] or []
        elif op == 1 and held:
            pid = held.pop(int(r.integers(0, len(held))))
            for p in pools:
                p.release(pid)
        elif op == 2 and held:
            pid = held[int(r.integers(0, len(held)))]
            key = toks[: len(toks) // psz * psz]
            for p in pools:
                p.register(pid, key)
        elif op == 3:
            got = [p.match_full(toks) for p in pools]
            assert got[0] == got[1]
            held += got[0][0]
            assert pools[0].match_partial(toks, got[0][1]) == pools[1].match_partial(toks, got[1][1])
        elif op == 4 and held:
            pid = held[int(r.integers(0, len(held)))]
            for p in pools:
                p.incref(pid)
            held.append(pid)
        a, b = pools
        assert (a.free, a.ref, a.cached_free, a.key_of, a.n_evictions, a.n_free) == (
            b.free, b.ref, b.cached_free, b.key_of, b.n_evictions, b.n_free)


def test_page_pool_alloc_denied_by_fault_plan():
    pool = PagePool(4, 8)
    with fault_plan(FaultPlan([FaultSpec(site="pool.alloc", kind="deny", at=(0,))])):
        assert pool.alloc(1) is None
        assert pool.alloc(1) == [3]
    assert pool.n_free == 2


def test_fault_plan_schedule_matches_jax():
    specs = [
        dict(site="engine.step", kind="transient", at=(0, 3), window=(7, 9)),
        dict(site="pool.alloc", kind="deny", p=0.3, max_fires=5),
        dict(site="engine.step", kind="deny", p=0.2),
    ]

    def drive(plan, transient):
        out = []
        for n in range(60):
            site = ("engine.step", "pool.alloc")[n % 2]
            try:
                out.append(plan.check(site))
            except transient:
                out.append("transient")
        return out, plan.fired

    ours = drive(FaultPlan([FaultSpec(**s) for s in specs], seed=42), TransientFault)
    theirs = drive(JFaultPlan([JFaultSpec(**s) for s in specs], seed=42), JTransientFault)
    assert ours == theirs and ours[1]
    with pytest.raises(ValueError):
        FaultSpec(site="no.such.site", kind="transient")
    with pytest.raises(ValueError):
        FaultSpec(site="engine.step", kind="flaky")
    assert fault_point("engine.step") == "ok"  # no active plan
