"""Kernel 5's planner and its split summation order, held on the CPU.

* :func:`repro_torch.kernels.paged_attention.plan_paged` (pure: shapes, the
  card's SM count and the CTAs per SM of the instance in, pages per
  partition out) at ``chip_smoke.py``'s five shapes with the H100's CTAs
  per SM: the plan the H100 measured fastest or near it, partitions that
  cover the table, as many full-length partitions as one round of resident
  CTAs holds (at least two where one round is not full), one partition (no
  combine) where one round is full already or a window spans under two
  partitions; overrides the kernel cannot take refused;
* the order in which the kernel sums (partitions of whole pages, tiles of
  ``TILE[kind]`` positions from each partition's first attended position,
  an online softmax per partition, the partitions combined in ascending
  order), emulated in torch, against the JAX reference's oracle at fp32
  (rtol 1e-5, as ``tests/test_torch_serve_model.py`` holds the plain
  version) and its Pallas kernel in interpret mode at bf16 (atol 2e-2: the
  kernels keep p in fp32 where the plain versions round it);
* the kernel's 1/sqrt(hd) pre-scale, float(q) * (float)(1/sqrt(hd)) rounded
  once to q's dtype, equal bit for bit to the reference's
  ``(q * (1.0 / math.sqrt(hd))).to(q.dtype)``.
"""

import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro.quant.pack import kv_pack_int4 as jpack4
from repro_torch.kernels import paged_attention as pa
from repro_torch.quant import kv_unpack_int4
from tests._hypothesis_compat import given, settings, st

N_SM = 132  # the H100's SMs
PAGE = 16
# CTAs of kernel 5 resident per H100 SM, per (kind, G, hd), bf16 q (the
# occupancy calculator, as chip_smoke.py phase 3 prints it).
H100_CTAS = {("bf16", 1, 96): 2, ("int8", 1, 96): 4, ("int4", 1, 96): 3,
             ("bf16", 4, 128): 1, ("int8", 4, 128): 2, ("int4", 4, 128): 2}
# chip_smoke.py's shapes (B, KVp, G, hd, table pages, window) and the pages
# per partition the planner takes there: the fastest the H100 measured
# among partitions of 1-256 pages, or within 11 % of it (serving int8: 48
# pages, 32 measured 10 % faster; serving and single int4: within 4 %).
# "longctx" is the shape of chip_smoke.py's long-context serving run.
SHAPES = {"serving": (8, 32, 1, 96, 96, None), "long": (32, 32, 1, 96, 256, None),
          "gqa": (8, 8, 4, 128, 96, 256), "single": (1, 32, 1, 96, 256, None),
          "longctx": (8, 32, 1, 96, 256, None)}
PLANS = {("serving", "bf16"): 48, ("serving", "int8"): 48, ("serving", "int4"): 48,
         ("long", "bf16"): 256, ("long", "int8"): 256, ("long", "int4"): 256,
         ("gqa", "bf16"): 96, ("gqa", "int8"): 96, ("gqa", "int4"): 96,
         ("single", "bf16"): 32, ("single", "int8"): 16, ("single", "int4"): 22,
         ("longctx", "bf16"): 128, ("longctx", "int8"): 128, ("longctx", "int4"): 128}


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plan_at_the_smoke_shapes(shape, kind):
    B, KVp, G, hd, n_pgs, window = SHAPES[shape]
    slots = N_SM * H100_CTAS[(kind, G, hd)]
    plan = pa.plan_paged(B, KVp, G, hd, n_pgs, PAGE, kind, N_SM, H100_CTAS[(kind, G, hd)], window)
    assert pa.check_paged_plan(plan) == plan == PLANS[(shape, kind)]
    n_split = pa.paged_splits(n_pgs, plan)
    assert (n_split - 1) * plan < n_pgs <= n_split * plan  # the partitions cover the table
    ctas, group = B * KVp * n_split, B * KVp
    if n_split == 1:  # one round full already, or a window under two partitions: no combine
        assert group >= slots or window is not None
    elif slots >= 2 * group:  # as many full-length partitions as one round holds
        assert slots - group < ctas <= slots
    else:  # two partitions where one round holds fewer: one group past it at most
        assert n_split == 2 and ctas < slots + group


@settings(max_examples=60, deadline=None)
@given(B=st.integers(1, 64), KVp=st.integers(1, 64), G=st.integers(1, 8), n_pgs=st.integers(0, 2048),
       psz=st.sampled_from([1, 8, 16, 32]), kind=st.sampled_from(list(pa.TILE)),
       cps=st.integers(1, 16), window=st.one_of(st.none(), st.integers(0, 8192)))
def test_plan_is_valid_for_any_shape(B, KVp, G, n_pgs, psz, kind, cps, window):
    part = pa.check_paged_plan(pa.plan_paged(B, KVp, G, 96, n_pgs, psz, kind, N_SM, cps, window))
    n_split = pa.paged_splits(n_pgs, part)
    assert n_split == max(1, -(-n_pgs // part)) and (n_split - 1) * part < max(n_pgs, 1)
    if n_split > 1 and part < pa.MAX_PART_PAGES:  # no whole group of CTAs left for a second round
        assert B * KVp * (n_split - 1) < N_SM * cps


@pytest.mark.parametrize("args", [(0, 32, 1, 96, 96, 16, "bf16", 132, 4), (8, 32, 1, 96, 96, 16, "fp8", 132, 4),
                                  (8, 32, 1, 96, 96, 0, "bf16", 132, 4), (8, 32, 1, 96, -1, 16, "bf16", 132, 4),
                                  (8, 32, 1, 96, 96, 16, "bf16", 0, 4), (8, 32, 1, 96, 96, 16, "bf16", 132, 0)])
def test_plan_of_an_empty_shape_or_card_is_refused(args):
    with pytest.raises(ValueError):
        pa.plan_paged(*args)
    with pytest.raises(ValueError):
        pa.plan_paged(8, 32, 1, 96, 96, 16, "bf16", 132, 4, -1)


@pytest.mark.parametrize("plan", [0, 257, -1, 6.0, 2.5, True, False, "6", (6,), (6, 1), [3], None])
def test_plan_the_kernel_cannot_take_is_refused(plan):
    with pytest.raises(ValueError):
        pa.check_paged_plan(plan)


def test_plan_override_accepted_as_given():
    assert pa.check_paged_plan(3) == 3 and pa.paged_splits(6, 3) == 2
    assert pa.paged_splits(6, 4) == 2  # a short last partition
    assert pa.check_paged_plan(1) == 1 and pa.paged_splits(6, 1) == 6
    assert pa.paged_splits(6, 7) == 1  # a partition longer than the table
    assert pa.check_paged_plan(256) == 256 and pa.paged_splits(0, 256) == 1  # an empty table


# ---------------------------------------------------------------------------
# The kernel's summation order, emulated, against the JAX reference
# ---------------------------------------------------------------------------


def _prescale(q):
    """The kernel's pre-scale: the fp32 product with 1/sqrt(hd) rounded to
    fp32, rounded once to q's dtype."""
    s = np.float32(1.0 / math.sqrt(q.shape[-1]))
    return torch.from_numpy(q.float().numpy() * s).to(q.dtype)


def _split_order(q, kp, vp, pt, ln, *, kind, plan, window=None, attn_softcap=None, ks=None, vs=None):
    """Kernel 5 as it sums: per (sequence, kv head) and partition of whole
    pages, tiles of TILE[kind] positions from the partition's first attended
    position, an online softmax in fp32 (scores, then the k scale, then the
    softcap; p times the v scale into P.V), then the partitions combined in
    ascending order (one partition: acc / l directly)."""
    B, KVp, G, hd = q.shape
    psz, n_pgs, T = kp.shape[1], pt.shape[1], pa.TILE[kind]
    part, n_split = plan, pa.paged_splits(n_pgs, plan)
    unpack = (lambda p: kv_unpack_int4(p).float()) if kind == "int4" else (lambda p: p.float())
    kf, vf = unpack(kp), unpack(vp)
    qs = _prescale(q).float()
    out = torch.zeros(B, KVp, G, hd)
    for b in range(B):
        n = int(ln[b])
        hi, lo = min(n, n_pgs * psz), (max(0, n - window) if window is not None else 0)
        for h in range(KVp):
            states = []
            for s in range(n_split):
                a0, a1 = max(lo, s * part * psz), min(hi, min((s + 1) * part, n_pgs) * psz)
                if a1 <= a0:
                    states.append(None)
                    continue
                m, l, acc = torch.full((G,), -math.inf), torch.zeros(G), torch.zeros(G, hd)
                for t0 in range(a0, a1, T):
                    pos = torch.arange(t0, min(t0 + T, a1))
                    page, slot = pt[b, pos // psz].long(), pos % psz
                    sc = qs[b, h] @ kf[page, slot, h].T
                    if ks is not None:
                        sc = sc * ks[page, slot, h, 0]
                    if attn_softcap is not None:
                        sc = torch.tanh(sc / attn_softcap) * attn_softcap
                    m_new = torch.maximum(m, sc.max(-1).values)
                    corr, p = torch.exp(m - m_new), torch.exp(sc - m_new[:, None])
                    l = l * corr + p.sum(-1)
                    pw = p * vs[page, slot, h, 0] if vs is not None else p
                    acc, m = acc * corr[:, None] + pw @ vf[page, slot, h], m_new
                states.append((m, l, acc))
            if n_split == 1:
                if states[0] is not None:
                    m, l, acc = states[0]
                    out[b, h] = acc / torch.clamp_min(l, 1e-30)[:, None]
                continue
            live = [st_ for st_ in states if st_ is not None]
            if not live:
                continue
            M = torch.stack([st_[0] for st_ in live]).max(0).values
            L, A = torch.zeros(G), torch.zeros(G, hd)
            for m, l, acc in live:
                f = torch.exp(m - M)
                L, A = L + l * f, A + acc * f[:, None]
            out[b, h] = A / torch.clamp_min(L, 1e-30)[:, None]
    return out.to(q.dtype)


def _inputs(seed, *, kind, G, q_dtype, window):
    """Pages of ``kind`` for 5 sequences over a table of two partitions of
    two tiles each; lengths 1, exactly a partition, one past a partition,
    and two near the table's end (where a window of 9 or 13 starts inside a
    partition's second tile)."""
    r = np.random.default_rng(seed)
    T, B, KVp, hd = pa.TILE[kind], 5, 2, 16
    part = 2 * T // PAGE
    npg = 2 * part
    lengths = np.array([1, part * PAGE, part * PAGE + 1, 2 * part * PAGE - 3, 2 * part * PAGE], np.int32)
    P = 1 + B * npg
    q = r.standard_normal((B, KVp, G, hd)).astype(np.float32)
    ks = vs = None
    if kind == "bf16":
        kp, vp = (r.standard_normal((P, PAGE, KVp, hd)).astype(np.float32) for _ in range(2))
    else:
        lim = 127 if kind == "int8" else 7
        kp, vp = (r.integers(-lim, lim + 1, (P, PAGE, KVp, hd)).astype(np.int8) for _ in range(2))
        ks, vs = ((r.random((P, PAGE, KVp, 1)) * 0.02 + 1e-3).astype(np.float32) for _ in range(2))
    pt = r.permutation(np.arange(1, P))[: B * npg].reshape(B, npg).astype(np.int32)
    jq = jnp.asarray(q).astype(q_dtype)
    if kind == "bf16":
        jkp, jvp = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    elif kind == "int8":
        jkp, jvp = jnp.asarray(kp), jnp.asarray(vp)
    else:
        jkp, jvp = jpack4(jnp.asarray(kp)), jpack4(jnp.asarray(vp))
    j = dict(q=jq, k_pages=jkp, v_pages=jvp, page_table=jnp.asarray(pt), lengths=jnp.asarray(lengths),
             k_scale_pages=None if ks is None else jnp.asarray(ks),
             v_scale_pages=None if vs is None else jnp.asarray(vs))
    t = {k: None if v is None else torch.from_numpy(np.array(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                                                             else v)) for k, v in j.items()}
    for k in ("q", "k_pages", "v_pages"):
        if j[k].dtype == jnp.bfloat16:
            t[k] = t[k].to(torch.bfloat16)
    return j, t, npg, part


def _call(fn, d, **kw):
    return fn(d["q"], d["k_pages"], d["v_pages"], d["page_table"], d["lengths"],
              k_scale_pages=d["k_scale_pages"], v_scale_pages=d["v_scale_pages"], **kw)


_OPTIONS = [(None, None), (9, None), (None, 30.0), (13, 5.0)]  # tests/test_torch_serve_model.py's


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window,cap", _OPTIONS)
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_split_order_matches_jax_ref(kind, window, cap, G):
    """fp32 q: every plan from one partition to one page per partition
    agrees with the reference's oracle at rtol 1e-5."""
    j, t, npg, part = _inputs(10 * G + len(kind), kind=kind, G=G, q_dtype=jnp.float32, window=window)
    want = np.asarray(_call(jref.paged_attention_ref, j, window=window, attn_softcap=cap))
    for plan in [npg, part, part + 1, 1]:
        got = _split_order(t["q"], t["k_pages"], t["v_pages"], t["page_table"], t["lengths"], kind=kind,
                           plan=plan, window=window, attn_softcap=cap, ks=t["k_scale_pages"],
                           vs=t["v_scale_pages"])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6, err_msg=str(plan))


@pytest.mark.parametrize("window,cap", _OPTIONS)
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_split_order_matches_pallas_interpret(kind, window, cap):
    """bf16 q: the planned-size split and one partition agree with the
    reference's Pallas kernel (interpret mode) at atol 2e-2."""
    j, t, npg, part = _inputs(3 + len(kind), kind=kind, G=1, q_dtype=jnp.bfloat16, window=window)
    want = np.asarray(_call(paged_attention_pallas, j, window=window, attn_softcap=cap, interpret=True),
                      np.float32)
    for plan in [npg, part]:
        got = _split_order(t["q"], t["k_pages"], t["v_pages"], t["page_table"], t["lengths"], kind=kind,
                           plan=plan, window=window, attn_softcap=cap, ks=t["k_scale_pages"],
                           vs=t["v_scale_pages"])
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, err_msg=str(plan))


@pytest.mark.parametrize("hd", [16, 96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prescale_in_kernel_equals_the_reference(dtype, hd):
    """The kernel takes 1/sqrt(hd) as a C float (ctypes rounds the Python
    float to nearest, as PyTorch does for a scalar multiplying a bf16 or
    fp32 tensor) and rounds the fp32 product once to q's dtype."""
    r = np.random.default_rng(hd)
    mags = np.exp(r.uniform(-30, 30, (64, hd)))  # wide range, subnormal products included
    q = torch.from_numpy((r.standard_normal((64, hd)) * mags).astype(np.float32)).to(dtype)
    assert ctypes.c_float(1.0 / math.sqrt(hd)).value == float(np.float32(1.0 / math.sqrt(hd)))
    assert torch.equal(_prescale(q), (q * (1.0 / math.sqrt(hd))).to(q.dtype))
