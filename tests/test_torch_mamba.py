"""The port's Mamba-2 (SSD) blocks and the hybrid Jamba against the reference.

Reduced (``reduce_cfg``) Mamba-2 and Jamba, the reference's params carried
across with ``repro_torch.interop``, numpy-seeded inputs.  Tolerances:

* fp32 modules (``_ssd_chunked`` at G = 1 and G = 2, ``_dw_conv``,
  ``mamba_apply`` with its state, three ``mamba_decode`` steps): within
  1e-5 of each output's max |·|; whole fp32 models (train loss, prefill and
  decode logits): 1e-4 of max |logit|, gradients 1e-4 of each leaf's max
  |g| (measured: 4e-7 for the modules, 3.5e-6 for Jamba's decode logits,
  5.4e-6 for its gradients);
* bf16 ``mamba_apply`` / ``mamba_decode``: outputs and the fp32 SSM state
  within 2e-2 of max |·| (measured 0.72 % and 0.86 %: the SiLU and the
  gate round differently in bf16; the convolution buffers are equal);
* the solver on both reduced models (QuantEase, 4 bits, ``emit="qt"``):
  report keys equal (``wz``, ``wx``, ``wbc``, ``out_proj`` and the
  attention, MLP and expert leaves; never ``wdt``), errors within 1e-4
  relative, zero points equal and integers in [0, 15], codes equal
  outside rows that start at a verified rounding tie;
* the contiguous engines' tokens and logits (1e-4 of max |logit|, tokens
  under the top-2 margin rule of ``tests/test_torch_configs.py``) on
  prompts of 5, 17 and 26 tokens, a slot reused;
* the pad-and-replay admission of both packages' contiguous engine,
  pinned (``ROADMAP.md`` §3), bit for bit at bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import quantease as jquantease
from repro.core import solver as jsolver
from repro.dist import checkpoint as jckpt
from repro.models import common as jcommon
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.models import mamba2 as jmamba
from repro.models import model as jm
from repro.quant import GridSpec as JSpec
from repro.quant import compute_grid as jgrid
from repro.quant import quantize_tensor as jquantize
from repro.serve import qparams as jqparams
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro.tune import sensitivity as jsens
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.core import quantease as tquantease
from repro_torch.core import solver as tsolver
from repro_torch.dist import checkpoint as tckpt
from repro_torch.models import common as tcommon
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model as tm
from repro_torch.quant import GridSpec as TSpec
from repro_torch.quant import QuantizedTensor
from repro_torch.quant import compute_grid as tgrid
from repro_torch.serve import PagedServingEngine, Request, ServingEngine
from repro_torch.serve import qparams as tqparams
from repro_torch.serve.spec import SpecConfig
from repro_torch.tree import tree_leaves
from repro_torch.tune import sensitivity as tsens
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests.test_torch_configs import _agree
from tests.test_torch_cuda import midpoint_gap

CPU = "cpu"
ARCHS = ("mamba2_2_7b", "jamba_1_5_large")
MOD_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_TOL = 2e-2
CACHE = ("conv_x", "conv_bc", "ssm")


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel(t, j):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    return float(np.abs(t - j).max()) / max(float(np.abs(j).max()), 1e-30)


def _cfgs(arch, dtype="f32", **over):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return (dataclasses.replace(reduce_cfg(jget(arch), **over), dtype=jd),
            dataclasses.replace(reduce_cfg(tget(arch), **over), dtype=td))


def _pair(arch, seed=0, dtype="f32", **over):
    jcfg, tcfg = _cfgs(arch, dtype, **over)
    jp, tp = jplan(jcfg, 1), tm.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(seed))
    return jp, params, tp, interop.params_from_jax(jax.tree.map(np.asarray, params), device=CPU)


# ---------------------------------------------------------------------------
# The SSD block and its pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches(G):
    """L = 45 is not a multiple of the chunk (16), and the scan starts from
    a non-zero state."""
    r = np.random.default_rng(G)
    B, L, nh, hd, N = 2, 45, 8, 4, 6
    x = r.standard_normal((B, L, nh, hd)).astype(np.float32)
    dt = r.uniform(0.01, 0.2, (B, L, nh)).astype(np.float32)
    a = -r.uniform(1.0, 4.0, nh).astype(np.float32)
    b, c = (r.standard_normal((B, L, G, N)).astype(np.float32) for _ in range(2))
    h0 = r.standard_normal((B, nh, hd, N)).astype(np.float32)
    jy, jh = jmamba._ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), chunk=16,
                                 h0=jnp.asarray(h0))
    ty, th = tmamba._ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), chunk=16,
                                 h0=torch.from_numpy(h0))
    assert _rel(ty, jy) <= MOD_TOL and _rel(th, jh) <= MOD_TOL


def test_ssd_backward_is_finite_above_the_diagonal():
    """exp(seg) overflows above the diagonal; the mask inside the exp keeps
    the gradient finite (a mask after it would give 0·inf = NaN)."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((1, 32, 2, 4)).astype(np.float32)).requires_grad_()
    dt = torch.full((1, 32, 2), 20.0, requires_grad=True)  # large decay: exp(+seg) = inf
    a = torch.tensor([-5.0, -3.0])
    b, c = (torch.from_numpy(r.standard_normal((1, 32, 1, 3)).astype(np.float32)) for _ in range(2))
    y, _ = tmamba._ssd_chunked(x, dt, a, b, c, chunk=32)
    y.sum().backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(dt.grad).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dw_conv_matches(dtype):
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 30, 8, 4)).astype(np.float32)
    w = (r.uniform(-1, 1, (8, 4, 4)) / 2).astype(np.float32)
    b = (0.1 * r.standard_normal((8, 4))).astype(np.float32)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jo = jmamba._dw_conv(*(jnp.asarray(a, jd) for a in (x, w, b)))
    to = tmamba._dw_conv(*(torch.from_numpy(a).to(td) for a in (x, w, b)))
    assert _rel(to, jo) <= MOD_TOL


def _block(pkg, params, tparams, b=0):
    if pkg == "jax":
        return jax.tree.map(lambda a: a[0], params["dec"][f"b{b}"])
    return tm.period_slice(tparams["dec"], 0)[f"b{b}"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba_apply_and_decode_match(dtype):
    """``mamba_apply`` over 37 positions (chunk 16) with its returned state,
    then three ``mamba_decode`` steps from it."""
    jp, params, tp, tparams = _pair("mamba2_2_7b", seed=3, dtype=dtype)
    tol = MOD_TOL if dtype == "f32" else BF16_TOL
    jb, tb = _block("jax", params, tparams), _block("torch", params, tparams)
    jd, td = jp.cfg.dtype, tp.cfg.dtype
    x = np.random.default_rng(4).standard_normal((2, 37, jp.cfg.d_model)).astype(np.float32)
    jo, jc = jmamba.mamba_apply(jb, jnp.asarray(x, jd), jp.cfg, chunk=16, return_cache=True)
    to, tc = tmamba.mamba_apply(tb, torch.from_numpy(x).to(td), tp.cfg, chunk=16,
                                return_cache=True)
    assert _rel(to, jo) <= tol
    carried = interop.params_from_jax(jax.tree.map(np.asarray, jc), device=CPU)
    assert sorted(carried) == sorted(tc) == sorted(CACHE)
    for k in CACHE:
        assert tc[k].dtype == carried[k].dtype and tc[k].shape == carried[k].shape, k
        assert _rel(tc[k], carried[k]) <= tol, k
    assert tc["ssm"].dtype == torch.float32
    for step in range(3):
        xs = np.random.default_rng(10 + step).standard_normal((2, 1, jp.cfg.d_model))
        jo, jc = jmamba.mamba_decode(jb, jnp.asarray(xs, jd), jp.cfg, jc)
        to, tc = tmamba.mamba_decode(tb, torch.from_numpy(xs.astype(np.float32)).to(td), tp.cfg, tc)
        assert _rel(to, jo) <= tol, step
        for k in CACHE:
            assert _rel(tc[k], getattr(jc, k)) <= tol, (step, k)


# ---------------------------------------------------------------------------
# Whole models: params, loss, gradients, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_shapes_and_fp32_dynamics(arch):
    jp, params, tp, tparams = _pair(arch, dtype="bf16")
    tinit = tm.init_params(tp, 0, device=CPU)
    assert [(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in tree_leaves(tinit)] == \
        [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(params)]
    blk = "b0" if arch == "mamba2_2_7b" else "b1"
    for name in ("a_log", "dt_bias"):
        assert tinit["dec"][blk][name].dtype == torch.float32
        assert tm.empty_params(tp, device=CPU)["dec"][blk][name].dtype == torch.float32
    assert tinit["dec"][blk]["wz"].dtype == torch.bfloat16
    # The reference's init distributions: A = -exp(a_log) in [-16, -1],
    # softplus(dt_bias) in [1e-3, 0.1], conv taps in ±1/√k.
    a = torch.exp(tinit["dec"][blk]["a_log"])
    dt = torch.nn.functional.softplus(tinit["dec"][blk]["dt_bias"])
    assert a.min() >= 1.0 and a.max() <= 16.0 and dt.min() >= 1e-3 * 0.999 and dt.max() <= 0.1 * 1.001
    assert tinit["dec"][blk]["conv_x_w"].float().abs().max() <= 0.5
    assert tp.cfg.param_count() == jp.cfg.param_count()
    assert tp.cfg.active_param_count() == jp.cfg.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match(arch):
    from repro_torch.train.train_step import loss_and_grads

    jp, params, tp, tparams = _pair(arch)
    toks = np.random.default_rng(1).integers(0, jp.cfg.vocab, (2, 40)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jm.train_loss(jp, p, {"tokens": jnp.asarray(toks)}))(params)
    tl, tg = loss_and_grads(tp, tparams, {"tokens": toks})
    assert float(tl) == pytest.approx(float(jl), rel=MODEL_TOL)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        assert t.dtype == tree_leaves(tparams)[i].dtype
        assert torch.isfinite(t).all(), i
        if np.abs(np.asarray(j)).max() > 0:
            assert _rel(t, j) <= MODEL_TOL, i


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match(arch):
    """Prefill of 24 tokens, then three decode steps at per-slot positions;
    the caches agree too (an fp32 model's convolution buffers turn fp32 in
    both packages)."""
    jp, params, tp, tparams = _pair(arch)
    r = np.random.default_rng(2)
    toks = r.integers(0, jp.cfg.vocab, (2, 24)).astype(np.int32)
    jl, jc = jm.prefill(jp, params, {"tokens": jnp.asarray(toks)}, jm.init_cache(jp, 2, 64))
    tl, tc = tm.prefill(tp, tparams, {"tokens": toks}, tm.init_cache(tp, 2, 64, device=CPU))
    assert _rel(tl, jl) <= MODEL_TOL
    pos = np.array([24, 13], np.int32)
    for step in range(3):
        nxt = r.integers(0, jp.cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, params, jnp.asarray(nxt), jc, jnp.asarray(pos + step))
        tl, tc = tm.decode_step(tp, tparams, nxt, tc, pos + step)
        assert _rel(tl, jl) <= MODEL_TOL, step
    mb = "b0" if arch == "mamba2_2_7b" else "b1"
    carried = interop.params_from_jax(jax.tree.map(np.asarray, jc[mb]), device=CPU)
    for k in CACHE:
        assert tc[mb][k].dtype == carried[k].dtype == torch.float32, k
        assert _rel(tc[mb][k], carried[k]) <= MODEL_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_and_paged_refusal(arch):
    jcfg, tcfg = _cfgs(arch, "bf16")
    jp, tp = jplan(jcfg, 1), tm.make_plan(tcfg)
    jsh = jm.cache_shapes(jp, 3, 64)
    tsh = tm.cache_shapes(tp, 3, 64)
    for blk, leaves in tsh.items():
        want = {k: getattr(jsh[blk], k) for k in CACHE} if "ssm" in leaves else jsh[blk]
        assert {k: (shape, str(dt).split(".")[-1]) for k, (shape, dt) in leaves.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}, blk
    for fn in (lambda: jm.paged_cache_shapes(jp, 8, 16), lambda: tm.paged_cache_shapes(tp, 8, 16)):
        with pytest.raises(ValueError, match="self-attention decoder stacks only"):
            fn()


# ---------------------------------------------------------------------------
# The solver, the serving restack and the quantized forward
# ---------------------------------------------------------------------------


class _Runs(dict):
    """Each config's QuantEase PTQ in both packages, computed on first use
    (once per module).  Jamba is cut to one period (its eight blocks)."""

    def __missing__(self, arch):
        over = {"n_periods": 1} if arch == "jamba_1_5_large" else {}
        jp, params, tp, tparams = _pair(arch, seed=5, **over)
        r = np.random.default_rng(7)
        calib = [{"tokens": r.integers(0, 256, (2, 32)).astype(np.int32)} for _ in range(2)]
        kw = dict(method="quantease", iterations=3, emit="qt")
        jq, jrep = jsolver.ptq_quantize_model(
            jp, params, [{"tokens": jnp.asarray(b["tokens"])} for b in calib],
            jsolver.PTQConfig(spec=JSpec(bits=4), **kw))
        tq, trep = tsolver.ptq_quantize_model(tp, tparams, calib,
                                              tsolver.PTQConfig(spec=TSpec(bits=4), **kw),
                                              device=CPU)
        jserve = jqparams.quantize_params_for_serving(jp, params, jq["dec"])
        tserve = tqparams.quantize_params_for_serving(tp, tparams, tq["dec"], device=CPU)
        self[arch] = dict(jp=jp, params=params, tp=tp, tparams=tparams, calib=calib, jq=jq,
                          tq=tq, jrep=jrep, trep=trep, jserve=jserve, tserve=tserve)
        return self[arch]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


SIG_AGREE = 1e-5  # Σ of one block in the two runs, relative to max |Σ|


def _block_stats(r):
    """Each package's Σ of every block, captured as its solver did (the
    calibration tokens through its own quantized blocks before it), in
    order: ``[(period, bi, scope, jblk, tblk, jst, tst, sig_rel)]``, where
    ``sig_rel`` is the largest relative difference of the two runs' Σ."""
    if "blocks" in r:
        return r["blocks"]
    jp, tp, params, tparams = r["jp"], r["tp"], r["params"], r["tparams"]
    jx = [jm._embed_tokens(jp, params, jnp.asarray(c["tokens"])) for c in r["calib"]]
    tx = [tm._embed_tokens(tp, tparams, torch.from_numpy(c["tokens"]).long()) for c in r["calib"]]
    japply = lambda b, blk, x: jm._block_apply(jp.cfg, jp.heads, b, blk, x, mode="train",
                                               pos_ids=jnp.arange(x.shape[1]))[0]
    tapply = lambda b, blk, x: tsolver._apply_block(tp, b, blk, x)
    out = []
    for period in range(jp.cfg.n_periods):
        for bi, b in enumerate(jp.cfg.pattern):
            jst, tst, scope = {}, {}, f"dec.p{period}.b{bi}"
            jblk = jax.tree.map(lambda a: a[period], params["dec"][f"b{bi}"])
            tblk = tm.period_slice(tparams["dec"], period)[f"b{bi}"]
            with jcommon.capture_gram_stats(jst), jcommon.capture_scope(scope):
                for x in jx:
                    japply(b, jblk, x)
            with tcommon.capture_gram_stats(tst), tcommon.capture_scope(scope):
                for x in tx:
                    tapply(b, tblk, x)
            sig_rel = max(_rel(tst[k].sigma, jst[k].sigma) for k in jst)
            out.append((period, bi, scope, jblk, tblk, jst, tst, sig_rel))
            jx = [japply(b, r["jq"]["dec"][period][f"b{bi}"], x) for x in jx]
            tx = [tapply(b, r["tq"]["dec"][period][f"b{bi}"], x) for x in tx]
    r["blocks"] = out
    return out


def _group(pkg, blk, stats, scope, name):
    """The solver's group of ``name`` as ``(names, w3, Σ3)``: every captured
    quantizable leaf of the block with the same solver shape, sorted."""
    def item(n):
        w, sig = blk[n], stats[f"{scope}/{n}"].sigma
        if n in ("w_gate", "w_up", "w_down"):
            return (jnp.swapaxes(w, 1, 2), sig) if pkg == "jax" else (w.transpose(1, 2), sig)
        return w.reshape(sig.shape[-1], -1).T[None], sig[None]
    items = {n: item(n) for n in sorted(blk)
             if n in tsolver.QUANTIZABLE and f"{scope}/{n}" in stats}
    shape = items[name][0].shape[1:]
    names = [n for n, (w3, _) in items.items() if w3.shape[1:] == shape]
    cat = jnp.concatenate if pkg == "jax" else torch.cat
    return names, cat([items[n][0] for n in names]), cat([items[n][1] for n in names])


def _tie_rows(blks, stats, scope, name, jc, tc, iterations=3):
    """The rows where the two codes of ``name`` differ, each verified to
    start at a rounding tie: the group's solve is rerun in both packages
    (``blks``, ``stats``: each one's block and Σ) one to ``iterations``
    iterations, and at the first iteration and column where a row parts its
    β (float64, from the port's state) must lie within the fp32 rounding
    bound of a midpoint of its grid (``tests/test_torch_moe.py`` does the
    same for the experts)."""
    names, jw3, jsig3 = _group("jax", blks[0], stats[0], scope, name)
    _, tw3, tsig3 = _group("torch", blks[1], stats[1], scope, name)
    g0 = sum(blks[0][n].shape[0] if n.startswith("w_") else 1 for n in names[: names.index(name)])
    spec_j, spec_t = JSpec(bits=4), TSpec(bits=4)
    jg, tg = jax.vmap(lambda wi: jgrid(wi, spec_j))(jw3), tgrid(tw3.float(), spec_t)
    jruns = [np.asarray(jquantease.quantease_quantize(jw3, jsig3, spec_j, iterations=i, grid=jg)[0])
             for i in range(1, iterations + 1)]
    truns = [_np(tquantease.quantease_quantize(tw3, tsig3, spec_t, iterations=i, grid=tg)[0])
             for i in range(1, iterations + 1)]
    scale, zero = _np(tg.scale)[..., 0], _np(tg.zero)[..., 0]
    rows = set()
    for e, row in zip(*np.nonzero((jc != tc).any(-1))):
        g = g0 + int(e)
        it = next(i for i in range(iterations)
                  if not np.array_equal(truns[i][g, row], jruns[i][g, row]))
        prev = truns[it - 1][g, row] if it else _np(tw3[g, row])
        j = int(np.argmax(truns[it][g, row] != jruns[it][g, row]))
        gap, tol = midpoint_gap(_np(tw3[g, row]), _np(tsig3[g]), scale[g, row], zero[g, row],
                                truns[it][g, row], prev, j, sig_rel=_rel(tsig3[g], jsig3[g]))
        assert gap <= tol, (name, e, row, it, j, gap, tol)
        rows.add((int(e), int(row)))
    return rows


def _codes(qt):
    return _np(qt.unpacked_codes()) if isinstance(qt, QuantizedTensor) else \
        np.asarray(qt.unpacked_codes())


def _held_blocks(runs, arch):
    """Each block's leaves held against the reference's: ``[(scope,
    {name: (jqt, tqt, tie rows)})]``.  While a block's Σ agree in the two
    runs (``SIG_AGREE``), the whole-model runs' leaves are compared.  Once
    they part, which happens only downstream of a verified tie flip and an
    MoE router (a flipped code moves a token across a top-k boundary, and
    that token's whole row of the next blocks' Σ with it), the port's
    solver is held on the reference's own Σ instead: the block is solved
    again by ``core.solver._quantize_block`` on Σ carried across."""
    r = runs[arch]
    if "held" in r:
        return r["held"]
    from repro_torch.core.calib import CalibStats

    cfg = tsolver.PTQConfig(spec=TSpec(bits=4), method="quantease", iterations=3, emit="qt")
    held, ties_before, moe_before = [], False, False
    for period, bi, scope, jblk, tblk, jst, tst, sig_rel in _block_stats(r):
        jq = r["jq"]["dec"][period][f"b{bi}"]
        if sig_rel <= SIG_AGREE:
            tq, stats, report = r["tq"]["dec"][period][f"b{bi}"], (jst, tst), r["trep"]
        else:
            assert ties_before and moe_before, (scope, sig_rel)
            carried = {k: CalibStats(sigma=torch.from_numpy(np.array(v.sigma)), n=int(v.n))
                       for k, v in jst.items()}
            report = {}
            tq = tsolver._quantize_block(tblk, carried, scope, cfg, report)
            stats = (jst, carried)
        leaves = {}
        for name in sorted(jq):
            if name not in tsolver.QUANTIZABLE:
                continue
            jc = np.asarray(jq[name].unpacked_codes()).reshape(-1, *tq[name].shape[-2:])
            tc = _codes(tq[name]).reshape(jc.shape)
            rows = set() if np.array_equal(jc, tc) else _tie_rows((jblk, tblk), stats, scope,
                                                                  name, jc, tc)
            leaves[name] = (jq[name], tq[name], rows, report)
            ties_before |= bool(rows)
        moe_before |= r["jp"].cfg.pattern[bi].mlp == "moe"
        held.append((scope, sig_rel, leaves))
    r["held"] = held
    return held


@pytest.mark.parametrize("arch", ARCHS)
def test_solver_report_keys_and_errors_match(runs, arch):
    """Report keys equal (never ``wdt``); each error within 1e-4 relative of
    the reference's where the codes agree (the port's on the reference's Σ
    past a cascade: :func:`_held_blocks`)."""
    r = runs[arch]
    assert set(r["trep"]) == set(r["jrep"])
    names = {k.rsplit("/", 1)[1].split(".e")[0] for k in r["trep"]}
    assert {"wz", "wx", "wbc", "out_proj"} <= names and "wdt" not in names
    if arch == "jamba_1_5_large":
        assert {"wq", "wo", "wg", "wd", "w_gate", "w_down"} <= names
        assert "dec.p0.b1/w_gate.e3" in r["trep"]
    compared = 0
    for scope, _, leaves in _held_blocks(runs, arch):
        for name, (_, _, rows, report) in leaves.items():
            keys = [k for k in r["jrep"] if k == f"{scope}/{name}" or
                    k.startswith(f"{scope}/{name}.e")]
            assert keys and all(k in report for k in keys), (scope, name)
            if rows:
                continue
            for k in keys:
                assert report[k] == pytest.approx(r["jrep"][k], rel=1e-4), k
                compared += 1
    assert compared >= 0.9 * len(r["jrep"])


@pytest.mark.parametrize("arch", ARCHS)
def test_solver_artifact_matches(runs, arch):
    """Zero points equal, integers in [0, 15]; scales within two fp32 ulp;
    codes equal outside verified tie rows (at most 1 % of rows), block by
    block as :func:`_held_blocks` holds them; ``wdt``, ``a_log`` and
    ``dt_bias`` stay dense, the last two fp32."""
    r = runs[arch]
    n_rows, ties = 0, set()
    for scope, _, leaves in _held_blocks(runs, arch):
        for name, (jqt, tqt, rows, _) in leaves.items():
            assert (tqt.bits, tqt.packed, tqt.shape) == (jqt.bits, jqt.packed, tuple(jqt.shape))
            np.testing.assert_array_equal(_np(tqt.zero), np.asarray(jqt.zero), err_msg=name)
            z = _np(tqt.zero)
            assert np.array_equal(z, np.round(z)) and z.min() >= 0 and z.max() <= 15
            np.testing.assert_allclose(_np(tqt.scale), np.asarray(jqt.scale), rtol=2.4e-7, atol=0)
            n_rows += int(np.prod(tqt.shape[:-1]))
            ties |= {(scope, name, *k) for k in rows}
    assert len(ties) <= 0.01 * n_rows, ties
    for tper in r["tq"]["dec"]:
        for tb in tper.values():
            if "wdt" in tb:
                assert not isinstance(tb["wdt"], QuantizedTensor)
                assert tb["a_log"].dtype == tb["dt_bias"].dtype == torch.float32
    mb = "b0" if arch == "mamba2_2_7b" else "b1"
    out_proj = r["tserve"]["dec"][mb]["out_proj"]
    cfg = r["tp"].cfg
    assert out_proj.shape[-2:] == (cfg.d_model, cfg.ssm_nheads * cfg.ssm_headdim)
    assert r["tserve"]["dec"][mb]["a_log"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_forward_matches(runs, arch):
    """The reference's restacked artifact, carried across: the hidden states
    of both packages' quantized forwards, and the port's own artifact's
    logits at 1e-4 of the reference's artifact's (equal codes)."""
    from repro.eval import scorer as jscorer

    r = runs[arch]
    carried = interop.params_from_jax(jax.tree.map(np.asarray, r["jserve"]), device=CPU)
    toks = np.random.default_rng(9).integers(0, 256, (2, 32)).astype(np.int32)
    jh = jscorer._hidden_states(r["jp"], r["jserve"], jnp.asarray(toks))
    th = tm.hidden_states(r["tp"], carried, torch.from_numpy(toks).long())
    assert _rel(th, jh) <= MODEL_TOL


def test_rtn_serving_quantizes_the_mamba_leaves(runs):
    """``rtn_quantize_for_serving`` quantizes wz, wx, wbc and out_proj as the
    reference's ``quantize_tensor`` on the solver's (out, d_in) matrix, and
    keeps wdt, the convolution weights and the fp32 dynamics dense."""
    r = runs["mamba2_2_7b"]
    served, label = tqparams.rtn_quantize_for_serving(r["tp"], r["tparams"], bits=4)
    assert label == "linear-packed"
    blk, dense = served["dec"]["b0"], r["params"]["dec"]["b0"]
    for name in ("wdt", "conv_x_w", "conv_bc_w", "d_skip", "norm_scale", "a_log", "dt_bias"):
        assert isinstance(blk[name], torch.Tensor), name
    assert blk["a_log"].dtype == blk["dt_bias"].dtype == torch.float32
    for name in ("wz", "wx", "wbc", "out_proj"):
        w = np.asarray(dense[name])[1]
        p = w.shape[0] * (w.shape[1] if name == "out_proj" else 1)
        jqt = jquantize(jnp.asarray(w.reshape(p, -1).T), JSpec(bits=4))
        tqt = blk[name].map_arrays(lambda a: a[1])
        np.testing.assert_array_equal(_np(tqt.unpacked_codes()), np.asarray(jqt.codes))
        np.testing.assert_array_equal(_np(tqt.zero), np.asarray(jqt.zero))
    # The reference's RTN artifact of the same params has the same shapes.
    jserved, _ = jqparams.rtn_quantize_for_serving(r["jp"], r["params"], bits=4)
    for name in ("wz", "wx", "wbc", "out_proj"):
        assert tuple(served["dec"]["b0"][name].codes.shape) == \
            tuple(np.asarray(jserved["dec"]["b0"][name].codes).shape), name


def test_tuner_leaf_sizes_cover_the_mamba_leaves(runs):
    r = runs["jamba_1_5_large"]
    sizes = tsens._leaf_sizes(r["tp"], r["tparams"])
    assert sizes == jsens._leaf_sizes(r["jp"], r["params"])
    cfg = r["tp"].cfg
    assert sizes["dec.p0.b1/wz"] == cfg.d_model * cfg.d_inner
    assert sizes["dec.p0.b1/out_proj"] == cfg.d_inner * cfg.d_model
    assert "dec.p0.b1/wdt" not in sizes


# ---------------------------------------------------------------------------
# Checkpoints: the fp32 leaves round-trip dtype-exact
# ---------------------------------------------------------------------------


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_packages_with_fp32_leaves(tmp_path, arch):
    jcfg, tcfg = _cfgs(arch, "bf16")
    jp, tp = jplan(jcfg, 1), tm.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(3))
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, params)
    out, _ = tckpt.load_checkpoint(str(tmp_path / "j"), tm.empty_params(tp, device=CPU))
    mb = "b0" if arch == "mamba2_2_7b" else "b1"
    assert out["dec"][mb]["a_log"].dtype == torch.float32
    assert out["dec"][mb]["wz"].dtype == torch.bfloat16
    tckpt.save_checkpoint(str(tmp_path / "t"), 1, out)
    back, _ = jckpt.load_checkpoint(str(tmp_path / "t"), params)
    for j, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert j.dtype == b.dtype
        np.testing.assert_array_equal(_bits(b), _bits(j))


def test_adamw_keeps_the_fp32_leaves():
    """One AdamW step on a bf16 Mamba-2: the fp32 dynamics stay fp32, the
    bf16 weights bf16."""
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    _, tcfg = _cfgs("mamba2_2_7b", "bf16")
    tp = tm.make_plan(tcfg)
    params = tm.init_params(tp, 0, device=CPU)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(tp, opt)
    toks = np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)
    new, state, m = step(params, adamw_init(params, opt), {"tokens": toks})
    assert np.isfinite(float(m["loss"]))
    for a, b in zip(tree_leaves(params), tree_leaves(new)):
        assert a.dtype == b.dtype
    assert new["dec"]["b0"]["a_log"].dtype == torch.float32
    assert not torch.equal(new["dec"]["b0"]["a_log"], params["dec"]["b0"]["a_log"])


# ---------------------------------------------------------------------------
# The contiguous engine, its pad-and-replay admission, and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_engine_gives_the_reference_tokens(arch):
    """Prompts of 5, 17 and 26 tokens on two slots (the third reuses a
    slot, whose state admission overwrites whole)."""
    jp, params, tp, tparams = _pair(arch, seed=4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jp.cfg.vocab, n).astype(np.int32) for n in (5, 17, 26)]
    kw = dict(max_batch=2, max_seq=96, prefill_pad=8, record_logits=True)
    jeng, teng = JEngine(jp, params, **kw), ServingEngine(tp, tparams, device=CPU, **kw)
    for eng, req in ((jeng, JRequest), (teng, Request)):
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, prompt=p, max_new_tokens=5))
        eng.run()
    outs = [{r.rid: r.output for r in e.finished} for e in (jeng, teng)]
    assert _agree(outs, [e.logit_trace for e in (jeng, teng)], rtol=MODEL_TOL) >= len(prompts)


PIN_PROMPT_LEN = 5


def _pin_setup():
    """The seeded case of ``ROADMAP.md`` §3: reduced bf16 Mamba-2, params
    from PRNGKey(1), a 5-token prompt from default_rng(0)."""
    jp, params, tp, tparams = _pair("mamba2_2_7b", seed=1, dtype="bf16")
    prompt = np.random.default_rng(0).integers(0, jp.cfg.vocab, PIN_PROMPT_LEN).astype(np.int32)
    return jp, params, tp, tparams, prompt


def _exact(pkg, plan, params, prompt, n):
    """Greedy tokens of an exact prefill over the prompt, then decode steps."""
    if pkg == "jax":
        l, c = jm.prefill(plan, params, {"tokens": jnp.asarray(prompt[None])}, jm.init_cache(plan, 1, 64))
        step = lambda t, c, pos: jm.decode_step(plan, params, jnp.asarray([[t]], jnp.int32), c, pos)
    else:
        l, c = tm.prefill(plan, params, {"tokens": prompt[None]}, tm.init_cache(plan, 1, 64, device=CPU))
        step = lambda t, c, pos: tm.decode_step(plan, params, np.array([[t]], np.int32), c, pos)
    out = [int(np.argmax(_np(l)[0]))]
    for i in range(n - 1):
        l, c = step(out[-1], c, len(prompt) + i)
        out.append(int(np.argmax(_np(l)[0])))
    return out


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_engine_pad_and_replay_admission_is_pinned(pkg):
    """Both packages' contiguous engine right-pads a prompt with token 0 to
    its ``prefill_pad`` bucket, then replays the last prompt token as the
    first decode.  For a Mamba block both enter the recurrent state: after
    admission a slot's state equals a prefill over the padded prompt, and
    the engine's greedy tokens part from an exact prefill + decode_step's.
    The port copies this on purpose (``ROADMAP.md`` §3); the two packages'
    engines give the same tokens, bit for bit at bf16."""
    jp, params, tp, tparams, prompt = _pin_setup()
    plan, p = (jp, params) if pkg == "jax" else (tp, tparams)
    exact = _exact(pkg, plan, p, prompt, 5)
    streams = {}
    for pad in (32, 1):
        kw = dict(max_batch=1, max_seq=64, prefill_pad=pad)
        eng = JEngine(plan, p, **kw) if pkg == "jax" else ServingEngine(plan, p, device=CPU, **kw)
        eng.submit((JRequest if pkg == "jax" else Request)(rid=0, prompt=prompt, max_new_tokens=5))
        eng._admit()
        padded = np.zeros((1, pad * -(-PIN_PROMPT_LEN // pad)), np.int32)
        padded[0, :PIN_PROMPT_LEN] = prompt
        if pkg == "jax":
            _, want = jm.prefill(plan, p, {"tokens": jnp.asarray(padded)}, jm.init_cache(plan, 1, 64))
            for k in CACHE:
                np.testing.assert_array_equal(_bits(getattr(eng.cache["b0"], k)),
                                              _bits(getattr(want["b0"], k)))
        else:
            _, want = tm.prefill(plan, p, {"tokens": padded}, tm.init_cache(plan, 1, 64, device=CPU))
            for k in CACHE:
                assert torch.equal(eng.cache["b0"][k], want["b0"][k]), k
        eng.run()
        streams[pad] = eng.finished[0].output
    # The replayed token enters the state a second time: even without pads
    # (prefill_pad=1) the first token parts from the exact stream's.
    assert streams[1][0] != exact[0] and streams[32][0] != exact[0]
    assert streams[32] != streams[1]
    if pkg == "torch":
        # The reference's streams, computed live, equal the port's.
        jp_, jparams = jp, params
        for pad, stream in streams.items():
            jeng = JEngine(jp_, jparams, max_batch=1, max_seq=64, prefill_pad=pad)
            jeng.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=5))
            jeng.run()
            assert jeng.finished[0].output == stream, pad
        assert _exact("jax", jp_, jparams, prompt, 5) == exact


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_and_speculation_refuse(arch):
    jp, params, tp, tparams = _pair(arch, dtype="bf16")
    for make in (lambda: PagedServingEngine(tp, tparams, max_batch=2, max_seq=64, device=CPU),
                 lambda: PagedServingEngine(tp, tparams, max_batch=2, max_seq=64, device=CPU,
                                            spec=SpecConfig(draft_plan=tp, draft_params=tparams))):
        with pytest.raises(ValueError, match="self-attention decoder stacks only"):
            make()
    from repro.serve.engine import PagedServingEngine as JPaged

    with pytest.raises(ValueError, match="self-attention decoder stacks only"):
        JPaged(jp, params, max_batch=2, max_seq=64)


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_clis_run_the_ssm_archs(tmp_path, capsys, arch):
    """``launch.train``, ``launch.quantize`` (QuantEase), ``launch.eval``
    (``--no-parity``: its parity runs the paged engine) and ``launch.serve``:
    ``--engine paged`` prints the reference's WARNING and serves on the
    contiguous engine, ``--strict-engine`` exits, ``--speculate`` exits."""
    from repro_torch.launch import eval as leval
    from repro_torch.launch import quantize as lquantize
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain

    common = ["--arch", arch, "--reduce", "--device", CPU]
    out = ltrain.main([*common, "--steps", "2", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path / "t")])
    assert np.isfinite(out["final_loss"])
    lquantize.main([*common, "--ckpt-dir", str(tmp_path / "t"), "--method", "quantease",
                    "--bits", "4", "--iterations", "2", "--calib-batches", "1",
                    "--out-dir", str(tmp_path / "q")])
    doc = leval.main([*common, "--ckpt-dir", str(tmp_path / "t"), "--smoke", "--no-parity",
                      "--out", str(tmp_path / "eval.json")])
    assert all(np.isfinite(c["ppl"]) for c in doc["grid"]) and np.isfinite(doc["dense"]["ppl"])
    capsys.readouterr()
    res = lserve.main([*common, "--ckpt-dir", str(tmp_path / "q"), "--requests", "2",
                       "--max-new", "3", "--engine", "paged"])
    err = capsys.readouterr().err
    assert "WARNING: paged engine unavailable" in err and "FALLING BACK" in err
    assert res["engine"] == "contiguous"
    assert [r.status for r in res["requests"]] == ["completed"] * 2
    for extra in (["--strict-engine"], ["--speculate", "--engine", "contiguous"]):
        with pytest.raises(SystemExit):
            lserve.main([*common, "--ckpt-dir", str(tmp_path / "q"), "--requests", "1",
                         "--max-new", "2", *(extra if "--engine" in extra else
                                             ["--engine", "paged", *extra])])
