"""The port's encoder-decoder family (Whisper) and prefix family (LLaVA)
against the reference.

Reduced (``reduce_cfg``: 2 encoder and 2 decoder periods, 32 frames, 8
patches) Whisper-large-v3 and LLaVA-NeXT-34B, the reference's params carried
across with ``repro_torch.interop``, inputs from both packages'
``make_batch_fn`` (numpy-seeded, equal bit for bit).  Tolerances:

* fp32 models: the train loss and every gradient (encoder leaves included)
  within 1e-4 of max |g| (measured 9.5e-7); prefill logits and three
  decode steps within 1e-5 of max |logit| (measured 3.2e-7); the caches
  ``k``/``v`` and Whisper's cross caches ``ck``/``cv`` are bf16 in both
  packages whatever the model's dtype, so an fp32 value that differs by
  fp32 rounding may round to the neighbouring bf16: within one bf16 ulp of
  max |·| (measured 1.6e-3), and the decode steps run from the reference's
  prefill cache carried across;
* bf16 models: logits and caches within 2e-2 of max |·| (measured 0.43 %
  for the prefill logits, 0.59 % for the decode steps' and 0.70 % for the
  caches: bf16 roundings of XLA and PyTorch part by an ulp here and there
  and the layers carry them);
* the solver (RTN and QuantEase at 4 bits, qe_outlier at 3 bits with 1 %
  outliers; 3 CD iterations; ``emit="qt"``): report keys equal and in the
  same order (``enc.*`` first, the cross leaves ``*_c``), errors within
  1e-4 relative (measured 4.4e-6), zero points equal, scales within two
  fp32 ulp, codes equal outside rows that start at a verified rounding tie;
* quantized forwards (``emit="fake"``, the restacked ``emit="qt"``
  artifact): logits within 1e-4 of max |logit|.

The two defects of the reference that this family meets are pinned
(``ROADMAP.md`` §3): its encoder scan takes the decoder's period count,
and its restack leaves the solver's per-period ``"enc"`` list unstacked.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.configs import get_config as jget
from repro.core import quantease as jquantease
from repro.core import solver as jsolver
from repro.data import pipeline as jpipe
from repro.dist import checkpoint as jckpt
from repro.eval import scorer as jscorer
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.models import model as jm
from repro.quant import GridSpec as JSpec
from repro.quant import compute_grid as jgrid
from repro.serve import qparams as jqparams
from repro.serve.engine import PagedServingEngine as JPagedEngine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServingEngine as JEngine
from repro.tune import sensitivity as jsens
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.core import quantease as tquantease
from repro_torch.core import solver as tsolver
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import checkpoint as tckpt
from repro_torch.eval import scorer as tscorer
from repro_torch.launch import common as lcommon
from repro_torch.models import model as tm
from repro_torch.quant import GridSpec as TSpec
from repro_torch.quant import QuantizedTensor
from repro_torch.quant import compute_grid as tgrid
from repro_torch.quant import dequantize_tensor
from repro_torch.serve import PagedServingEngine, ServingEngine
from repro_torch.serve import qparams as tqparams
from repro_torch.tree import tree_leaves
from repro_torch.tune import sensitivity as tsens
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests.test_torch_cuda import midpoint_gap

CPU = "cpu"
ARCHS = ("whisper_large_v3", "llava_next_34b")
FAMILY = {"whisper_large_v3": "encoder-decoder", "llava_next_34b": "prefix"}
FP32_TOL = 1e-5  # prefill / decode logits and caches, of max |·|
BF16_TOL = 2e-2
CACHE_TOL = 2.0 ** -8  # one bf16 ulp of max |·|: the bf16 KV caches of an fp32 model
MODEL_TOL = 1e-4  # train loss, gradients, quantized forwards
ERR_REL = 1e-4  # the solver's per-layer errors
SEQ = 16
METHODS = {"rtn": 4, "quantease": 4, "qe_outlier": 3}  # qe_outlier on Whisper, as on the card
ITERATIONS = 3
CALIB_B = 4  # one calibration batch of 4 x 16 tokens (the CLI test's shapes too)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _rel(t, j):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    return float(np.abs(t - j).max()) / max(float(np.abs(j).max()), 1e-30)


def _cfgs(arch, dtype="f32", **over):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    return (dataclasses.replace(reduce_cfg(jget(arch), **over), dtype=jd),
            dataclasses.replace(reduce_cfg(tget(arch), **over), dtype=td))


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=5, dtype="f32", **over):
    """Both packages' reduced model, the reference's params carried across;
    one per arguments (no test changes them)."""
    jcfg, tcfg = _cfgs(arch, dtype, **over)
    jp, tp = jplan(jcfg, 1), tm.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(seed))
    # Non-trivial norms so the LayerNorm / (1 + scale) conventions show.
    for k in ("final_norm", "enc_final_norm", "prefix_ln"):
        if k in params:
            params[k] = jax.tree.map(lambda a: a + 0.01, params[k])
    return jp, params, tp, interop.params_from_jax(jax.tree.map(np.asarray, params), device=CPU)


def _batches(cfg, n, B=2, S=SEQ, split="calib"):
    fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=cfg.vocab, seed=0), cfg, B, S, split=split)
    return [fn(i) for i in range(n)]


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# Configs, batches, parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "calib", "eval"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_fn_draws_frames_and_patches_bit_for_bit(arch, split):
    """Frames, then patches, from the batch's generator right after the
    tokens: the port's batches equal the reference's bit for bit."""
    jcfg, tcfg = _cfgs(arch)
    for step in (0, 3):
        jb = jpipe.make_batch_fn(jpipe.DataConfig(vocab=256, seed=7), jcfg, 3, 12, split=split)[0](step)
        tb = tpipe.make_batch_fn(tpipe.DataConfig(vocab=256, seed=7), tcfg, 3, 12, split=split)[0](step)
        extra = "frames" if arch == "whisper_large_v3" else "patches"
        assert sorted(tb) == sorted(jb) == sorted(["tokens", extra])
        for k in jb:
            assert tb[k].dtype == np.asarray(jb[k]).dtype and np.array_equal(tb[k], np.asarray(jb[k]))
        n = tcfg.n_frames if extra == "frames" else tcfg.n_prefix
        assert tb[extra].shape == (3, n, tcfg.d_model) and tb[extra].dtype == np.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_params_have_the_reference_shapes_and_init_scale(arch):
    """The tree equals the reference's (``enc``, ``enc_pos_emb``,
    ``enc_final_norm``, ``prefix_ln``, the cross leaves); "small_normal"
    counts the encoder's layers: 0.02/√(2·(2 + 2)) on reduced Whisper."""
    jp, params, tp, _ = _pair(arch, dtype="bf16")
    tinit = tm.init_params(tp, 0, device=CPU)
    assert tm.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]), tinit) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params)
    assert tp.cfg.param_count() == jp.cfg.param_count()
    layers = tp.cfg.n_layers + tp.cfg.n_enc_periods * len(tp.cfg.enc_pattern)
    want = 0.02 / np.sqrt(2 * layers)
    for tree in (tinit, params):
        got = float(np.std(_np(tree["dec"]["b0"]["wd"])))
        assert got == pytest.approx(want, rel=0.05), (got, want)
    if arch == "whisper_large_v3":
        blk = tinit["dec"]["b0"]
        assert {"ln_c", "wq_c", "wk_c", "wv_c", "wo_c"} <= set(blk)
        assert "wq_c" not in tinit["enc"]["b0"]


@pytest.mark.parametrize("over", [dict(qkv_bias=True), dict(post_norms=True),
                                  dict(qkv_bias=True, post_norms=True)])
def test_cross_leaves_carry_no_bias_and_no_second_post_norm(over):
    """A cross block's ``_c`` projections have no q/k/v bias, and its
    post-norm stays the self-attention's one, as the reference's
    ``_attn_defs(suffix="_c")``."""
    jcfg, tcfg = _cfgs("whisper_large_v3", "bf16", **over)
    jp, tp = jplan(jcfg, 1), tm.make_plan(tcfg)
    jsh = jax.tree.map(lambda s: tuple(s.shape), jm.param_shapes(jp))
    tsh = tm.tree_map(lambda a: tuple(a.shape), tm.empty_params(tp, device="meta"))
    assert tsh == jsh
    blk = tsh["dec"]["b0"]
    assert not {"bq_c", "bk_c", "bv_c", "post_ln_c"} & set(blk)
    assert ("bq" in blk) == bool(over.get("qkv_bias")) and ("post_ln" in blk) == bool(
        over.get("post_norms"))


def test_every_architecture_of_the_reference_is_ported():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.base.NOT_PORTED == ()
    for arch in ARCHS:
        tcfg, jcfg = tget(arch), jget(arch)
        assert (tcfg.family, tcfg.n_frames, tcfg.n_prefix, tcfg.n_enc_periods) == \
            (jcfg.family, jcfg.n_frames, jcfg.n_prefix, jcfg.n_enc_periods)
        assert tcfg.param_count() == jcfg.param_count()


# ---------------------------------------------------------------------------
# The forward paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match(arch):
    """The loss (the prefix masked out of it) and every gradient, the
    encoder's leaves, ``enc_pos_emb`` and ``prefix_ln`` included."""
    from repro_torch.train.train_step import loss_and_grads

    jp, params, tp, tparams = _pair(arch)
    batch = _batches(tp.cfg, 1, split="train")[0]
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jm.train_loss(jp, p, b)))(params, _j(batch))
    tl, tg = loss_and_grads(tp, tparams, batch)
    assert float(tl) == pytest.approx(float(jl), rel=MODEL_TOL)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        assert torch.isfinite(t).all(), i
        if np.abs(np.asarray(j)).max() > 0:
            assert _rel(t, j) <= MODEL_TOL, i
    named = {"whisper_large_v3": ("enc", "enc_pos_emb"), "llava_next_34b": ("prefix_ln",)}[arch]
    for k in named:
        assert any(float(g.abs().max()) > 0 for g in tree_leaves(tg[k])), k


def _caches_agree(tc, jc, arch, tol):
    """The port's cache against the reference's: bf16 in both packages,
    whatever the model's dtype, so an fp32 value that differs by fp32
    rounding may land on the neighbouring bf16 (one bf16 ulp of max
    |·|)."""
    carried = interop.params_from_jax(jax.tree.map(np.asarray, jc), device=CPU)
    leaves = ("k", "v", "ck", "cv") if arch == "whisper_large_v3" else ("k", "v")
    assert set(tc["b0"]) == set(leaves)
    for k in leaves:
        assert tc["b0"][k].dtype == carried["b0"][k].dtype == torch.bfloat16, k
        assert _rel(tc["b0"][k], carried["b0"][k]) <= max(tol, CACHE_TOL), k
    return carried


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, dtype):
    """Prefill of 16 tokens (after LLaVA's 8 patches; with Whisper's 32
    frames), then three decode steps at per-slot positions.  The caches
    ``k``/``v`` and Whisper's ``ck``/``cv`` agree after the prefill and
    after the steps; the decode steps run from the reference's prefill
    cache carried across, so each step's logits are held on one state."""
    tol = FP32_TOL if dtype == "f32" else BF16_TOL
    jp, params, tp, tparams = _pair(arch, dtype=dtype)
    batch = _batches(tp.cfg, 1)[0]
    jl, jc = jm.prefill(jp, params, _j(batch), jm.init_cache(jp, 2, 64))
    tl, tc = tm.prefill(tp, tparams, batch, tm.init_cache(tp, 2, 64, device=CPU))
    assert _rel(tl, jl) <= tol
    tc = _caches_agree(tc, jc, arch, tol)
    npre = tp.cfg.n_prefix
    pos = np.array([SEQ + npre, SEQ + npre - 5], np.int32)
    r = np.random.default_rng(2)
    for step in range(3):
        nxt = r.integers(0, 256, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, params, jnp.asarray(nxt), jc, jnp.asarray(pos + step))
        tl, tc = tm.decode_step(tp, tparams, nxt, tc, pos + step)
        assert _rel(tl, jl) <= tol, step
    _caches_agree(tc, jc, arch, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_in_the_port(arch):
    """The reference's own check (``tests/test_models.py::
    test_decode_matches_prefill``, 0.05 of max |logit|) on the port's bf16
    model: one decode step after a 40-token prefill against a prefill over
    the 41 tokens; LLaVA's decode position continues after its patches."""
    _, tcfg = _cfgs(arch, "bf16")
    tp = tm.make_plan(tcfg)
    params = tm.init_params(tp, 1, device=CPU)
    toks = np.random.default_rng(0).integers(0, 256, (2, 41)).astype(np.int32)
    batch = _batches(tcfg, 1, S=40)[0]
    _, cache = tm.prefill(tp, params, dict(batch, tokens=toks[:, :40]),
                          tm.init_cache(tp, 2, 128, device=CPU))
    dec, _ = tm.decode_step(tp, params, toks[:, 40:], cache, 40 + tcfg.n_prefix)
    ref, _ = tm.prefill(tp, params, dict(batch, tokens=toks), tm.init_cache(tp, 2, 128, device=CPU))
    assert float((dec - ref).abs().max()) / float(ref.abs().max()) < 0.05


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_encoder_depth_unlike_the_decoders_is_pinned(pkg):
    """Defect 1 (``ROADMAP.md`` §3): the reference's ``_empty_caches``
    sizes the encoder's scan by ``cfg.n_periods``, so a Whisper with 1
    encoder and 2 decoder periods raises in ``prefill`` and ``train_loss``.
    The port takes each stack's period count from its leaves: the same
    model runs, and its encoder output equals the reference's encoder stack
    scanned with a carry of the right length."""
    jp, params, tp, tparams = _pair("whisper_large_v3", n_enc_periods=1)
    batch = _batches(tp.cfg, 1)[0]
    if pkg == "jax":
        with pytest.raises(ValueError, match="scan got values with different leading axis sizes"):
            jm.prefill(jp, params, _j(batch), jm.init_cache(jp, 2, 32))
        with pytest.raises(ValueError, match="scan got values with different leading axis sizes"):
            jm.train_loss(jp, params, _j(batch))
        return
    logits, _ = tm.prefill(tp, tparams, batch, tm.init_cache(tp, 2, 32, device=CPU))
    assert torch.isfinite(logits).all() and torch.isfinite(tm.train_loss(tp, tparams, batch))
    x = jnp.asarray(batch["frames"]) + params["enc_pos_emb"][None]
    jx, _, _ = jm._run_stack(jp, params["enc"], jp.cfg.enc_pattern, x, mode="train",
                             pos_ids=jnp.arange(x.shape[1]),
                             caches={"b0": jnp.zeros((1, 0), jnp.float32)})
    jenc = jm.apply_norm(params["enc_final_norm"], jx, jp.cfg.norm)
    assert _rel(tm.encoder(tp, tparams, batch, CPU), jenc) <= FP32_TOL


# ---------------------------------------------------------------------------
# The solver, encoder first
# ---------------------------------------------------------------------------


class _Runs(dict):
    """Each (arch, method)'s PTQ in both packages (``emit="qt"``), computed
    on first use; the group solves' (W, Σ) of both packages are recorded
    for the tie check."""

    def __missing__(self, key):
        arch, method = key
        if arch not in self:
            jp, params, tp, tparams = _pair(arch)
            self[arch] = dict(jp=jp, params=params, tp=tp, tparams=tparams,
                              calib=_batches(tp.cfg, 1, B=CALIB_B))
        base = self[arch]
        jp, params, tp, tparams, calib = (base[k] for k in ("jp", "params", "tp", "tparams", "calib"))
        bits = METHODS[method]
        kw = dict(method=method, iterations=ITERATIONS, emit="qt", outlier_frac=0.01)
        jgroups, tgroups, jprog, tprog = [], [], [], []
        jsolve, tsolve = jsolver._solve_group, tsolver._solve_group

        def jrec(w3, sig3, cfg, mesh):
            jgroups.append((np.asarray(w3), np.asarray(sig3)))
            return jsolve(w3, sig3, cfg, mesh)

        def trec(w3, sig3, cfg, mesh=None):
            tgroups.append((w3.clone(), sig3.clone()))
            return tsolve(w3, sig3, cfg, mesh)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jsolver, "_solve_group", jrec)
            mp.setattr(tsolver, "_solve_group", trec)
            jq, jrep = jsolver.ptq_quantize_model(
                jp, params, [_j(b) for b in calib], jsolver.PTQConfig(spec=JSpec(bits=bits), **kw),
                progress_cb=jprog.append)
            tq, trep = tsolver.ptq_quantize_model(
                tp, tparams, calib, tsolver.PTQConfig(spec=TSpec(bits=bits), **kw),
                progress_cb=tprog.append, device=CPU)
        self[key] = dict(base, bits=bits, jq=jq, jrep=jrep, tq=tq, trep=trep, jgroups=jgroups,
                         tgroups=tgroups, jprog=jprog, tprog=tprog)
        return self[key]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


RUN_IDS = [(a, m) for a in ARCHS for m in METHODS if a == "whisper_large_v3" or m != "qe_outlier"]


def _matrix(stack_leaf, period, name, pkg):
    """One period's dense leaf as the solver's (out, d_in) matrix."""
    w = stack_leaf[period]
    if pkg == "jax":
        w = np.asarray(w, np.float32)
        return (w.reshape(-1, w.shape[-1]) if name in ("wo", "wo_c") else w.reshape(w.shape[0], -1)).T
    w = w.float()
    return (w.reshape(-1, w.shape[-1]) if name in ("wo", "wo_c") else w.reshape(w.shape[0], -1)).T


def _find(groups, w):
    for w3, sig3 in groups:
        for g in range(w3.shape[0]):
            if np.array_equal(_np(w3[g]), w):
                return w3, sig3, g
    raise AssertionError("no recorded solve of this matrix")


def _tie_rows(r, stack, period, name, rows):
    """Each row of ``rows`` (where the two packages' QuantEase codes of
    ``stack.p{period}/name`` differ) must start at a verified rounding tie:
    the group's solve is rerun in both packages from 1 to 3 iterations on
    each one's recorded (W, Σ), and where the row first parts, its β
    (float64, from the port's state) lies within the fp32 rounding bound of
    a midpoint of its grid (``tests/test_torch_mamba.py`` does the same)."""
    assert r["jrep"] and r["bits"] == 4
    w = _matrix(r["params"][stack]["b0"][name], period, name, "jax")
    jw3, jsig3, g = _find(r["jgroups"], w)
    tw3, tsig3, tg_ = _find(r["tgroups"], w)
    assert g == tg_
    spec_j, spec_t = JSpec(bits=4), TSpec(bits=4)
    jgr = jax.vmap(lambda wi: jgrid(wi, spec_j))(jnp.asarray(jw3))
    tgr = tgrid(tw3.float(), spec_t)
    jruns = [np.asarray(jquantease.quantease_quantize(jnp.asarray(jw3), jnp.asarray(jsig3), spec_j,
                                                      iterations=i, grid=jgr)[0])
             for i in range(1, ITERATIONS + 1)]
    truns = [_np(tquantease.quantease_quantize(tw3, tsig3, spec_t, iterations=i, grid=tgr)[0])
             for i in range(1, ITERATIONS + 1)]
    scale, zero = _np(tgr.scale)[..., 0], _np(tgr.zero)[..., 0]
    for row in rows:
        it = next(i for i in range(ITERATIONS)
                  if not np.array_equal(truns[i][g, row], jruns[i][g, row]))
        prev = truns[it - 1][g, row] if it else _np(tw3[g, row])
        j = int(np.argmax(truns[it][g, row] != jruns[it][g, row]))
        gap, tol = midpoint_gap(_np(tw3[g, row]), _np(tsig3[g]), scale[g, row], zero[g, row],
                                truns[it][g, row], prev, j, sig_rel=_rel(tsig3[g], jsig3[g]))
        assert gap <= tol, (stack, period, name, row, it, j, gap, tol)


def _leaves(r):
    """``[(stack, period, block, name, jqt, tqt)]`` of every quantized leaf."""
    out = []
    for stack in ("enc", "dec"):
        for period, (jper, tper) in enumerate(zip(r["jq"].get(stack, []), r["tq"].get(stack, []))):
            for blk in tper:
                for name in sorted(tper[blk]):
                    if name in tsolver.QUANTIZABLE:
                        out.append((stack, period, blk, name, jper[blk][name], tper[blk][name]))
    return out


def _differing_rows(jqt, tqt):
    jc = np.asarray(jqt.unpacked_codes())
    tc = _np(tqt.unpacked_codes()).astype(jc.dtype)
    return set(np.nonzero((jc != tc).any(-1))[0].tolist())


@pytest.mark.parametrize("arch,method", RUN_IDS)
def test_solver_report_keys_and_errors_match(runs, arch, method):
    """Keys equal and in the reference's order: the encoder's (``enc.p*``)
    first, then the decoder's with Whisper's cross leaves; errors within
    1e-4 relative where the codes agree."""
    r = runs[arch, method]
    assert list(r["trep"]) == list(r["jrep"])
    names = {k.rsplit("/", 1)[1] for k in r["trep"]}
    if arch == "whisper_large_v3":
        assert list(r["trep"])[0].startswith("enc.p0.b0/")
        assert sum(k.startswith("enc.") for k in r["trep"]) == 2 * 6
        assert {"wq_c", "wk_c", "wv_c", "wo_c"} <= names
        assert not any(k.startswith("enc.") and k.endswith("_c") for k in r["trep"])
    else:
        assert all(k.startswith("dec.") for k in r["trep"]) and "wu" in names
    differ = {f"{s}.p{p}.{b}/{n}" for s, p, b, n, jqt, tqt in _leaves(r) if _differing_rows(jqt, tqt)}
    for k, v in r["jrep"].items():
        if k not in differ:
            assert r["trep"][k] == pytest.approx(v, rel=ERR_REL), k
    assert len(differ) <= 0.1 * len(r["jrep"])


@pytest.mark.parametrize("arch,method", RUN_IDS)
def test_solver_artifact_matches(runs, arch, method):
    """Zero points equal, integers in the grid; scales within two fp32
    ulp; outlier planes equal; codes equal outside rows that start at a
    verified rounding tie (QuantEase; RTN's and qe_outlier's codes must
    equal outright)."""
    r = runs[arch, method]
    hi = 2 ** r["bits"] - 1
    n_rows, ties = 0, 0
    for stack, period, blk, name, jqt, tqt in _leaves(r):
        assert (tqt.bits, tqt.packed, tqt.shape) == (jqt.bits, jqt.packed, tuple(jqt.shape))
        z = _np(tqt.zero)
        np.testing.assert_array_equal(z, np.asarray(jqt.zero), err_msg=name)
        assert np.array_equal(z, np.round(z)) and z.min() >= 0 and z.max() <= hi
        np.testing.assert_allclose(_np(tqt.scale), np.asarray(jqt.scale), rtol=2.4e-7, atol=0)
        if method == "qe_outlier":
            np.testing.assert_array_equal(_np(tqt.outlier_idx), np.asarray(jqt.outlier_idx))
            # fp16 values within one fp16 ulp: Σ of the encoder's first block
            # differs by 1.7e-7 relative between the packages (fp32
            # LayerNorm), and 12 of enc.p0 wg's 81 values round to the
            # neighbouring fp16 (measured); the others are equal.
            jv = np.asarray(jqt.outlier_values)
            ulp = np.spacing(np.abs(jv)).astype(np.float32)
            assert np.all(np.abs(_np(tqt.outlier_values) - jv.astype(np.float32)) <= ulp), name
        rows = _differing_rows(jqt, tqt)
        n_rows += tqt.shape[0]
        if rows:
            assert method == "quantease", (stack, period, name, rows)
            _tie_rows(r, stack, period, name, rows)
            ties += len(rows)
    assert ties <= 0.01 * n_rows


def test_progress_records_run_the_encoder_first(runs):
    """One record a block in each package, the encoder's (``"stack":
    "enc"``) first, with the reference's counts and per-layer errors."""
    r = runs["whisper_large_v3", "quantease"]
    key = lambda rec: (rec["stack"], rec["period"], rec["block"], rec["done_blocks"],
                       rec["total_blocks"], rec["n_linears"], sorted(rec["layer_errors"]))
    assert [key(x) for x in r["tprog"]] == [key(x) for x in r["jprog"]]
    assert [x["stack"] for x in r["tprog"]] == ["enc", "enc", "dec", "dec"]
    assert [x["n_linears"] for x in r["tprog"]] == [6, 6, 10, 10]


def _self_stacked(jp, params, jq):
    """The reference's restack of ``"dec"``, with the test stacking
    ``"enc"`` itself (the reference's own restack leaves it a list)."""
    serve = jqparams.quantize_params_for_serving(jp, params, jq["dec"])
    if "enc" in jq:
        enc = {}
        for blk in jq["enc"][0]:
            enc[blk] = {}
            for name in jq["enc"][0][blk]:
                leaves = [per[blk][name] for per in jq["enc"]]
                if isinstance(leaves[0], jqparams.QuantizedTensor):
                    leaves = jqparams.harmonize_qt_stack(leaves)
                enc[blk][name] = jax.tree.map(lambda *ls: jnp.stack(ls), *leaves)
        serve["enc"] = enc
    return serve


@pytest.mark.parametrize("arch,method", RUN_IDS)
def test_qt_artifact_forward_matches(runs, arch, method):
    """The port's restack (both stacks: ``solver_qt_enc``) against the
    reference's artifact restacked by the test: prefill and one decode
    step.  The reference's artifact carried across gives its logits within
    1e-4 of max |logit| in the port; so does the port's own artifact, whose
    codes equal the reference's outside verified ties."""
    r = runs[arch, method]
    jp, tp = r["jp"], r["tp"]
    jserve = _self_stacked(jp, r["params"], r["jq"])
    tserve = tqparams.quantize_params_for_serving(tp, r["tparams"], r["tq"]["dec"],
                                                  solver_qt_enc=r["tq"].get("enc"), device=CPU)
    if arch == "whisper_large_v3":
        assert isinstance(tserve["enc"]["b0"]["wq"], QuantizedTensor)
        assert tserve["enc"]["b0"]["wq"].codes.shape[0] == tp.cfg.n_enc_periods
    carried = interop.params_from_jax(jax.tree.map(np.asarray, jserve), device=CPU)
    batch = _batches(tp.cfg, 1, split="eval")[0]
    nxt = np.array([[3], [7]], np.int32)
    pos = SEQ + tp.cfg.n_prefix
    jl, jc = jm.prefill(jp, jserve, _j(batch), jm.init_cache(jp, 2, 64))
    jd, _ = jm.decode_step(jp, jserve, jnp.asarray(nxt), jc, jnp.int32(pos))
    ties = any(_differing_rows(a, b) for *_, a, b in _leaves(r))
    for tree in (carried, tserve):
        tl, tc = tm.prefill(tp, tree, batch, tm.init_cache(tp, 2, 64, device=CPU))
        td, _ = tm.decode_step(tp, tree, nxt, tc, pos)
        if tree is tserve and ties:
            assert torch.isfinite(td).all()
            continue
        assert _rel(tl, jl) <= MODEL_TOL and _rel(td, jd) <= MODEL_TOL


def _dequantized(jp, jserve):
    """The reference's restacked artifact with every QuantizedTensor
    dequantized into its dense leaf's layout (the reference's own
    ``dequantize``), for its dense forward."""
    dense = jm.param_shapes(jp)
    out = dict(jserve)
    for stack in ("dec", "enc"):
        if stack not in jserve:
            continue
        out[stack] = {}
        for blk, leaves in jserve[stack].items():
            out[stack][blk] = {}
            for name, leaf in leaves.items():
                if isinstance(leaf, jqparams.QuantizedTensor):
                    like = dense[stack][blk][name]
                    w = jnp.stack([jax.tree.map(lambda a: a[i], leaf).dequantize()
                                   for i in range(like.shape[0])])  # (periods, out, d_in)
                    leaf = jnp.swapaxes(w, 1, 2).reshape(like.shape).astype(like.dtype)
                out[stack][blk][name] = leaf
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_fake_emit_forward_matches(runs, arch):
    """``emit="fake"`` (QuantEase, 4 bits) writes the dequantized codes of
    ``emit="qt"`` into both stacks, bit for bit, and the fake-quantized
    model's train loss and prefill logits equal the reference's forward
    over its own quantized weights (dequantized by the reference) within
    1e-4."""
    r = runs[arch, "quantease"]
    jp, tp = r["jp"], r["tp"]
    tf, _ = tsolver.ptq_quantize_model(
        tp, r["tparams"], r["calib"],
        tsolver.PTQConfig(spec=TSpec(bits=4), method="quantease", iterations=ITERATIONS,
                          emit="fake"), device=CPU)
    tserve = tqparams.quantize_params_for_serving(tp, r["tparams"], r["tq"]["dec"],
                                                  solver_qt_enc=r["tq"].get("enc"), device=CPU)
    for stack in ("enc", "dec") if arch == "whisper_large_v3" else ("dec",):
        for name, leaf in tserve[stack]["b0"].items():
            if isinstance(leaf, QuantizedTensor):
                w = torch.stack([dequantize_tensor(leaf.map_arrays(lambda a: a[i]))
                                 for i in range(leaf.codes.shape[0])])
                want = w.transpose(1, 2).reshape(tf[stack]["b0"][name].shape)
                assert torch.equal(tf[stack]["b0"][name], want), (stack, name)
    if any(_differing_rows(a, b) for *_, a, b in _leaves(r)):
        return  # a verified tie: the two packages' weights part there
    jf = _dequantized(jp, _self_stacked(jp, r["params"], r["jq"]))
    batch = _batches(tp.cfg, 1, split="eval")[0]
    jl = float(jm.train_loss(jp, jf, _j(batch)))
    assert float(tm.train_loss(tp, tf, batch)) == pytest.approx(jl, rel=MODEL_TOL)
    jlog, _ = jm.prefill(jp, jf, _j(batch), jm.init_cache(jp, 2, 64))
    tlog, _ = tm.prefill(tp, tf, batch, tm.init_cache(tp, 2, 64, device=CPU))
    assert _rel(tlog, jlog) <= MODEL_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_restack_without_the_encoder_list_equals_the_reference(runs, arch):
    """Without ``solver_qt_enc`` the port's ``quantize_params_for_serving``
    gives the reference's result leaf for leaf: ``"dec"`` restacked, every
    other leaf (Whisper's dense encoder too) the params' own."""
    r = runs[arch, "rtn"]
    jserve = jqparams.quantize_params_for_serving(r["jp"], r["params"], r["jq"]["dec"])
    tserve = tqparams.quantize_params_for_serving(r["tp"], r["tparams"], r["tq"]["dec"],
                                                  device=CPU)
    assert sorted(tserve) == sorted(jserve)
    for k in tserve:
        if k == "dec":
            continue
        for t, j in zip(tree_leaves(tserve[k]), jax.tree.leaves(jserve[k])):
            np.testing.assert_array_equal(_bits(_np(t)), _bits(np.asarray(j, np.float32)))
    for blk in tserve["dec"]:
        for name, t in tserve["dec"][blk].items():
            j = jserve["dec"][blk][name]
            if isinstance(t, QuantizedTensor):
                assert (t.bits, t.packed, t.shape) == (j.bits, j.packed, tuple(j.shape))
                np.testing.assert_array_equal(_np(t.zero), np.asarray(j.zero))
                if not _differing_rows(j, t):
                    np.testing.assert_array_equal(_np(t.codes), np.asarray(j.codes, np.float32))
            else:
                for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
                    np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_restacked_encoder_list_is_pinned(runs, pkg):
    """Defect 2 (``ROADMAP.md`` §3): the reference's restack of the
    solver's ``emit="qt"`` output leaves its ``"enc"`` a per-period list,
    and its prefill then raises; given the dense params instead (as its
    eval harness and tuner give them) the encoder stays unquantized.  The
    port restacks ``"enc"`` when ``solver_qt_enc`` is given, and the
    artifact runs."""
    r = runs["whisper_large_v3", "rtn"]
    batch = _batches(r["tp"].cfg, 1)[0]
    if pkg == "jax":
        jp, jq = r["jp"], r["jq"]
        serve = jqparams.quantize_params_for_serving(jp, jq, jq["dec"])
        assert isinstance(serve["enc"], list)
        with pytest.raises(ValueError, match="scan got values with different leading axis sizes"):
            jm.prefill(jp, serve, _j(batch), jm.init_cache(jp, 2, 64))
        dense = jqparams.quantize_params_for_serving(jp, r["params"], jq["dec"])
        assert not isinstance(dense["enc"]["b0"]["wq"], jqparams.QuantizedTensor)
        return
    tp, tq = r["tp"], r["tq"]
    serve = tqparams.quantize_params_for_serving(tp, tq, tq["dec"], solver_qt_enc=tq["enc"],
                                                 device=CPU)
    assert isinstance(serve["enc"]["b0"]["wd"], QuantizedTensor)
    logits, _ = tm.prefill(tp, serve, batch, tm.init_cache(tp, 2, 64, device=CPU))
    assert torch.isfinite(logits).all()


def test_prepack_rtn_and_tuner_sizes_walk_the_reference_stacks(runs):
    """``prepack_params_for_serving`` walks ``"enc"`` as the reference's does
    (``backend="tpu"``: the same tile decisions and codes);
    ``rtn_quantize_for_serving`` quantizes the ``"dec"`` leaves alone (the
    cross leaves included, ``wo_c`` over its head input); the tuner's leaf
    sizes cover both stacks."""
    r = runs["whisper_large_v3", "quantease"]
    jp, tp = r["jp"], r["tp"]
    jserve = _self_stacked(jp, r["params"], r["jq"])
    tserve = tqparams.quantize_params_for_serving(tp, r["tparams"], r["tq"]["dec"],
                                                  solver_qt_enc=r["tq"]["enc"], device=CPU)
    jpk, jdec = jqparams.prepack_params_for_serving(jp, jserve, backend="tpu")
    tpk, tdec = tqparams.prepack_params_for_serving(tp, tserve, backend="tpu")
    assert tdec == jdec
    for name in ("wq", "wd"):
        t, j = tpk["enc"]["b0"][name], jpk["enc"]["b0"][name]
        assert (t.pack_layout, t.pack_tile) == (j.pack_layout, j.pack_tile)
        if not _differing_rows(r["jq"]["enc"][0]["b0"][name], r["tq"]["enc"][0]["b0"][name]):
            np.testing.assert_array_equal(_np(t.codes[0]), np.asarray(j.codes[0], np.float32))
    jrtn, jlabel = jqparams.rtn_quantize_for_serving(jp, r["params"], bits=4)
    trtn, tlabel = tqparams.rtn_quantize_for_serving(tp, r["tparams"], bits=4)
    assert tlabel == "linear-packed"
    assert not isinstance(trtn["enc"]["b0"]["wq"], QuantizedTensor)
    for name in ("wq_c", "wk_c", "wo_c", "wd"):
        t, j = trtn["dec"]["b0"][name], jrtn["dec"]["b0"][name]
        np.testing.assert_array_equal(_np(t.unpacked_codes()), np.asarray(j.unpacked_codes()))
        np.testing.assert_array_equal(_np(t.zero), np.asarray(j.zero))
    sizes = tsens._leaf_sizes(tp, r["tparams"])
    assert sizes == jsens._leaf_sizes(jp, r["params"])
    assert sizes["enc.p1.b0/wq"] == tp.cfg.d_model * tp.cfg.n_heads * tp.cfg.hd
    assert "dec.p0.b0/wo_c" in sizes


# ---------------------------------------------------------------------------
# Checkpoints and the command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_packages(tmp_path, arch):
    """A bf16 checkpoint with the encoder's and the prefix's leaves, written
    by either package, loads in the other bit for bit."""
    jp, params, tp, _ = _pair(arch, dtype="bf16")
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, params)
    out, _ = tckpt.load_checkpoint(str(tmp_path / "j"), tm.empty_params(tp, device=CPU))
    tckpt.save_checkpoint(str(tmp_path / "t"), 1, out)
    back, _ = jckpt.load_checkpoint(str(tmp_path / "t"), params)
    for j, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert j.dtype == b.dtype
        np.testing.assert_array_equal(_bits(b), _bits(j))


def test_quantized_checkpoint_with_the_encoder_round_trips(runs, tmp_path):
    """A restacked Whisper artifact (QuantizedTensor leaves in both stacks)
    saved with its ``meta["qt_layout"]`` loads back through
    ``launch.common.load_params`` leaf for leaf."""
    r = runs["whisper_large_v3", "qe_outlier"]
    tp = r["tp"]
    serve = tqparams.quantize_params_for_serving(tp, r["tparams"], r["tq"]["dec"],
                                                 solver_qt_enc=r["tq"]["enc"], device=CPU)
    layout = lcommon.qt_layout(serve)
    assert "enc/b0/wq" in layout and "b0/wq_c" in layout
    tckpt.save_checkpoint(str(tmp_path), 2, {"params": serve}, meta={"qt_layout": layout})
    back, _ = lcommon.load_params(str(tmp_path), tp, torch.device(CPU))
    a, b = tree_leaves(serve), tree_leaves(back)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert isinstance(back["enc"]["b0"]["wo"], QuantizedTensor)


# ---------------------------------------------------------------------------
# Where the reference cannot go: the port refuses with a plain message
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_scorer_engines_and_paged_cache_refuse(arch):
    """The scorer, both engines and the paged cache refuse both families
    with a ``ValueError`` naming the family, beside the reference's own
    failures: its scorer and paged cache raise, and its contiguous engine
    fails on the missing frames or patches at the first admission."""
    jp, params, tp, tparams = _pair(arch, dtype="bf16")
    family = FAMILY[arch]
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="token-only decoder models only"):
        jscorer.token_scores(jp, params, jnp.asarray(toks))
    with pytest.raises(ValueError, match=f"{family} family"):
        tscorer.token_scores(tp, tparams, toks, device=CPU)
    with pytest.raises(ValueError, match=f"{family} family"):
        tm.hidden_states(tp, tparams, torch.zeros(1, 8, dtype=torch.long))
    with pytest.raises(ValueError, match="paged KV serving"):
        jm.init_paged_cache(jp, 8, 16)
    with pytest.raises(ValueError, match="paged KV serving"):
        tm.init_paged_cache(tp, 8, 16, device=CPU)
    with pytest.raises(ValueError, match="paged KV serving"):
        JPagedEngine(jp, params, max_batch=2, max_seq=64)
    for make in (lambda: ServingEngine(tp, tparams, max_batch=2, max_seq=64, device=CPU),
                 lambda: PagedServingEngine(tp, tparams, max_batch=2, max_seq=64, device=CPU)):
        with pytest.raises(ValueError, match=f"{family} family"):
            make()
    eng = JEngine(jp, params, max_batch=2, max_seq=64)
    eng.submit(JRequest(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=2))
    with pytest.raises(KeyError, match="frames" if arch == "whisper_large_v3" else "patches"):
        eng.run()
