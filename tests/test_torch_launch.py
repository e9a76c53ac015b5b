"""The port's command-line path, ``repro_torch.launch.{train,quantize,eval,
serve}`` with ``--device cpu``, against the reference's CLIs, and the
pieces it runs on: the progress trail, the fault sites ``data.fetch`` and
``kernel.dispatch``, and the tile-native weight layout.

The CLIs run on the reference's ``--reduce`` config of Phi-3-mini in fp32
(``get_config`` is pointed at it in both packages), so the two packages'
forward passes agree to fp32 rounding.  Tolerances: per-layer reports of
the two quantize CLIs on one checkpoint within 1e-3 relative (4 bits, 3 CD
iterations); the two serve CLIs' greedy tokens equal; packed bytes,
permutations and layout labels exact; logits of a tile artifact and its
linear twin bit for bit.
"""

import contextlib
import dataclasses
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.data import pipeline as jpipe
from repro.dist import checkpoint as jckpt
from repro.eval import harness as jharness
from repro.faults import FaultPlan as JPlan
from repro.faults import FaultSpec as JSpecF
from repro.faults import PermanentFault as JPermanent
from repro.faults import fault_plan as jfault_plan
from repro.kernels import ops as jops
from repro.quant import pack as jpack
from repro.serve import qparams as jqparams
from repro_torch import interop
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import checkpoint as tckpt
from repro_torch.faults import FaultPlan, FaultSpec, PermanentFault, fault_plan
from repro_torch.kernels import ops, ref
from repro_torch.launch import eval as teval
from repro_torch.launch import quantize as tquantize
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.progress import append_record, load_progress
from repro_torch.models import model as tmodel
from repro_torch.quant import pack as tpack
from repro_torch.serve import qparams as tqparams
from tests._torch_cpu import one_torch_thread  # noqa: F401

ARCH = "phi3_mini_3_8b"


@contextlib.contextmanager
def fp32_configs():
    """Both packages' ``get_config`` give the fp32 variant of the arch."""
    jget, tget = jconfigs.get_config, tconfigs.get_config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfigs, "get_config", lambda n: dataclasses.replace(jget(n), dtype=jnp.float32))
        mp.setattr(tconfigs, "get_config", lambda n: dataclasses.replace(tget(n), dtype=torch.float32))
        yield


def _port(cli, *argv):
    with fp32_configs():
        return cli.main([*argv, "--device", "cpu"])


def _reference(module, *argv):
    with fp32_configs(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [module.__name__, *argv])
        module.main()


def _quant_args(ckpt_dir, out_dir, *extra):
    return ("--arch", ARCH, "--reduce", "--ckpt-dir", ckpt_dir, "--out-dir", out_dir,
            "--method", "quantease", "--bits", "4", "--iterations", "3",
            "--calib-batches", "2", "--seq", "32", *extra)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint trained by the port's CLI (--reduce, 4 steps)."""
    d = str(tmp_path_factory.mktemp("train"))
    out = _port(ttrain, "--arch", ARCH, "--reduce", "--steps", "4", "--batch", "2", "--seq", "32",
                "--ckpt-dir", d)
    return d, out


@pytest.fixture(scope="module")
def quantized_both(trained, tmp_path_factory):
    d = trained[0]
    tdir, jdir = (str(tmp_path_factory.mktemp(n)) for n in ("tq", "jq"))
    trep = _port(tquantize, *_quant_args(d, tdir))["report"]
    from repro.launch import quantize as jquantize

    _reference(jquantize, *_quant_args(d, jdir))
    return tdir, jdir, trep


def _artifact_bytes(out_dir):
    d = [p for p in os.listdir(out_dir) if p.startswith("step_")]
    assert len(d) == 1
    step = os.path.join(out_dir, d[0])
    return {n: open(os.path.join(step, n), "rb").read()
            for n in sorted(os.listdir(step)) if n.endswith(".bin")}


# ---------------------------------------------------------------------------
# train and quantize, across the two packages
# ---------------------------------------------------------------------------


def test_train_cli_writes_four_checkpoints(trained):
    d, out = trained
    assert tckpt.list_steps(d) == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for m in out["log"]) and out["recoveries"] == 0


def test_both_quantize_clis_agree_on_the_port_checkpoint(quantized_both):
    """The reference's CLI reads the port's training checkpoint, and the two
    reports agree per layer within 1e-3."""
    tdir, jdir, trep = quantized_both
    jman = json.load(open(os.path.join(jdir, "step_4", "manifest.json")))
    tman = json.load(open(os.path.join(tdir, "step_4", "manifest.json")))
    jrep = jman["meta"]["report"]
    assert list(trep) == list(jrep) == list(tman["meta"]["report"]) and len(trep) == 14
    for k, v in jrep.items():
        assert trep[k] == pytest.approx(v, rel=1e-3), k
    assert tman["meta"]["method"] == "quantease" and tman["meta"]["bits"] == 4
    assert [r["dtype"] for r in tman["leaves"]] == [r["dtype"] for r in jman["leaves"]]
    assert len(load_progress(os.path.join(tdir, "progress.jsonl"))) == 2  # one record a block


def test_quantize_cli_report_equals_the_solver(trained, quantized_both, tmp_path):
    """The CLI's report is ``ptq_quantize_model`` on the same loaded params
    and calibration batches."""
    from repro_torch.core.solver import PTQConfig, ptq_quantize_model
    from repro_torch.launch.common import load_params, model_config
    from repro_torch.quant import GridSpec

    with fp32_configs():
        cfg = model_config(ARCH, True)
    plan = tmodel.make_plan(cfg)
    params, _ = load_params(trained[0], plan, "cpu")
    fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=cfg.vocab, seed=0), cfg, 4, 32, "calib")
    _, rep = ptq_quantize_model(plan, params, [fn(0), fn(1)],
                                PTQConfig(spec=GridSpec(bits=4), iterations=3), device="cpu")
    assert rep == quantized_both[2]


# ---------------------------------------------------------------------------
# The reference's chaos drills on the port's quantize CLI
# ---------------------------------------------------------------------------


def test_quantize_fault_then_resume_bit_identical(trained, quantized_both, tmp_path):
    d = trained[0]
    ref_bytes = _artifact_bytes(quantized_both[0])  # the fault-free run, same flags
    out_dir = str(tmp_path / "chaotic")
    fp = json.dumps({"faults": [{"site": "data.fetch", "kind": "permanent", "at": [1]}]})
    with pytest.raises(PermanentFault):
        _port(tquantize, *_quant_args(d, out_dir, "--fault-plan", fp))
    assert not os.path.exists(os.path.join(out_dir, "step_4"))
    _port(tquantize, *_quant_args(d, out_dir, "--resume"))
    assert _artifact_bytes(out_dir) == ref_bytes


def test_quantize_transient_fetch_fault_recovers_in_run(trained, quantized_both, tmp_path,
                                                        capsys):
    d = trained[0]
    fp = json.dumps({"faults": [{"site": "data.fetch", "kind": "transient", "at": [1]}]})
    _port(tquantize, *_quant_args(d, str(tmp_path / "retried"), "--fault-plan", fp))
    assert "recovered from 1 transient fault" in capsys.readouterr().out
    assert _artifact_bytes(str(tmp_path / "retried")) == _artifact_bytes(quantized_both[0])


def test_quantize_corrupt_source_falls_back_to_last_good(trained, tmp_path, capsys):
    import shutil

    work = str(tmp_path / "ckpts")
    shutil.copytree(trained[0], work)
    src, dst = os.path.join(work, "step_4"), os.path.join(work, "step_9")
    shutil.copytree(src, dst)
    man = json.load(open(os.path.join(dst, "manifest.json")))
    man["step"] = 9
    json.dump(man, open(os.path.join(dst, "manifest.json"), "w"))
    shard = os.path.join(dst, "leaf_0.bin")
    raw = bytearray(open(shard, "rb").read())
    raw[0] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    assert tckpt.latest_step(work) == 9
    _port(tquantize, *_quant_args(work, str(tmp_path / "out")))
    captured = capsys.readouterr()
    assert "skipped damaged checkpoint step_9" in captured.err
    assert "loaded checkpoint step 4" in captured.out


def test_quantize_resume_reports_a_torn_trail(trained, tmp_path, capsys):
    out_dir = str(tmp_path / "q")
    os.makedirs(out_dir)
    rec = {"stack": "dec", "period": 0, "block": 0, "done_blocks": 1, "total_blocks": 2,
           "mean_rel_error": 0.5}
    with open(os.path.join(out_dir, "progress.jsonl"), "w") as f:
        f.write(json.dumps(rec) + "\n" + json.dumps(rec)[:7])
    _port(tquantize, *_quant_args(trained[0], out_dir, "--resume", "--method", "spqr"))
    assert "previous run: 1/2 blocks (dec.p0.b0), mean_err=0.5" in capsys.readouterr().out
    assert [r["done_blocks"] for r in load_progress(os.path.join(out_dir, "progress.jsonl"))] == [1, 2]


def test_quantize_shard_on_one_device_takes_the_local_path(trained, tmp_path, capsys):
    _port(tquantize, *_quant_args(trained[0], str(tmp_path / "q"), "--shard",
                                  "--stream-calib", "1"))
    assert "--shard: 1 device(s) — single-device fallback" in capsys.readouterr().out


def test_quantize_refuses_a_multi_device_shard(trained, tmp_path, monkeypatch):
    monkeypatch.setattr(tquantize, "_shard_devices", lambda dev: 4)
    with pytest.raises(SystemExit, match="queue 1 item 8"):
        _port(tquantize, *_quant_args(trained[0], str(tmp_path / "q"), "--shard"))


def test_load_progress_tolerates_truncation(tmp_path):
    assert tquantize.load_progress is load_progress and tquantize.append_record is append_record
    p = tmp_path / "progress.jsonl"
    assert load_progress(str(p)) == []
    p.write_text("")
    assert load_progress(str(p)) == []
    rec1, rec2 = {"done_blocks": 1, "total_blocks": 4}, {"done_blocks": 2, "total_blocks": 4}
    p.write_text(json.dumps(rec1) + "\n" + json.dumps(rec2) + "\n")
    assert load_progress(str(p)) == [rec1, rec2]
    p.write_text(json.dumps(rec1) + "\n" + json.dumps(rec2)[:9])
    assert load_progress(str(p)) == [rec1]
    p.write_text('{"bad": \n' + json.dumps(rec2) + "\n")
    with pytest.raises(ValueError):
        load_progress(str(p))
    p.write_text("")
    append_record(str(p), rec1)
    append_record(str(p), rec2)
    assert load_progress(str(p)) == [rec1, rec2]


# ---------------------------------------------------------------------------
# serve and eval
# ---------------------------------------------------------------------------

_REQ = re.compile(r"^req\d+ \[\w+\]: prompt\[\d+\] -> \[.*\]$", re.M)


def test_serve_cli_tokens_equal_the_reference_on_its_checkpoint(quantized_both, capsys):
    """The port serves the reference quantize CLI's checkpoint: every
    request completes with --max-new tokens, and the greedy tokens equal
    the reference's serve CLI's on the same requests."""
    from repro.launch import serve as jserve

    jdir = quantized_both[1]
    args = ("--arch", ARCH, "--reduce", "--ckpt-dir", jdir, "--requests", "3", "--max-new", "4")
    capsys.readouterr()
    _reference(jserve, *args)
    jlines = _REQ.findall(capsys.readouterr().out)
    out = _port(tserve, *args)
    tlines = _REQ.findall(capsys.readouterr().out)
    assert len(tlines) == 3 and tlines == jlines
    assert all(r.status == "completed" and len(r.output) == 4 for r in out["requests"])
    contig = _port(tserve, *args, "--engine", "contiguous")
    assert [r.output for r in contig["requests"]] == [r.output for r in out["requests"]]


def test_serve_cli_refusals(quantized_both, capsys):
    d = quantized_both[0]
    base = ("--arch", ARCH, "--reduce", "--ckpt-dir", d, "--requests", "1", "--max-new", "2")
    with pytest.raises(SystemExit, match="--speculate requires the paged engine"):
        _port(tserve, *base, "--speculate", "--engine", "contiguous")
    with pytest.raises(SystemExit, match="must be < the target's 2 periods"):
        _port(tserve, *base, "--speculate", "--draft-layers", "2")
    with pytest.raises(SystemExit):
        _port(tserve, *base, "--speculate", "--gamma", "0")
    with pytest.raises(SystemExit, match="requires --engine paged"):
        _port(tserve, *base, "--kv-dtype", "int4", "--engine", "contiguous")
    with pytest.raises(SystemExit):
        _port(tserve, *base[:-1], "0")  # --max-new 0
    out = _port(tserve, *base, "--kv-dtype", "int4")
    assert out["requests"][0].status == "completed"
    if not torch.cuda.is_available():
        with fp32_configs(), pytest.raises(SystemExit, match="CUDA is not available"):
            tserve.main(list(base))  # --device defaults to cuda


@pytest.mark.parametrize("draft", [(), ("--draft-layers", "1"), ("--draft-bits", "3"),
                                   ("--draft-checkpoint", "TRAIN", "--draft-layers", "1")])
def test_serve_cli_speculation_matches_the_reference(trained, quantized_both, capsys, draft):
    """``--speculate`` with each draft source serves the reference quantize
    CLI's checkpoint: the greedy tokens and the speculative report line's
    counts equal the reference's serve CLI's on the same requests, and the
    tokens equal a plain serve's."""
    from repro.launch import serve as jserve

    draft = tuple(trained[0] if a == "TRAIN" else a for a in draft)
    args = ("--arch", ARCH, "--reduce", "--ckpt-dir", quantized_both[1], "--requests", "3",
            "--max-new", "6", "--speculate", "--gamma", "3", *draft)
    capsys.readouterr()
    _reference(jserve, *args)
    jout = capsys.readouterr().out
    out = _port(tserve, *args)
    tout = capsys.readouterr().out
    report = re.compile(r"^speculative: .*$", re.M)
    assert _REQ.findall(tout) == _REQ.findall(jout) and len(_REQ.findall(tout)) == 3
    assert report.findall(tout) == report.findall(jout) and out["spec"]["draft_tokens"] > 0
    plain = _port(tserve, *args[:10])
    assert [r.output for r in plain["requests"]] == [r.output for r in out["requests"]]


def test_eval_cli_smoke_doc_has_the_reference_keys(trained, tmp_path):
    out = str(tmp_path / "eval.json")
    doc = _port(teval, "--arch", ARCH, "--reduce", "--ckpt-dir", trained[0], "--smoke",
                "--seq", "32", "--out", out)
    assert json.load(open(out)) == json.loads(json.dumps(doc))
    ref_keys = {"schema", "smoke", "jax", "backend", "arch", "data", "iterations", "emit",
                "dense", "grid", "parity"}  # repro/launch/eval.py's document
    assert set(doc) == ref_keys - {"jax"} | {"torch"} and doc["backend"] == "cpu"
    assert set(doc["data"]) == {"vocab", "seq", "eval_split", "calib_split", "entropy_floor_ppl"}
    assert [(r["method"], r["bits"]) for r in doc["grid"]] == [("rtn", 4), ("quantease", 3)]
    assert all(jharness._GRID_KEYS <= set(r) for r in doc["grid"])
    assert set(jharness.validate_doc(doc)) <= {"parity: paged != contiguous bitwise"}


# ---------------------------------------------------------------------------
# The fault sites data.fetch and kernel.dispatch
# ---------------------------------------------------------------------------


def test_data_fetch_fault_site_fires_as_in_the_reference():
    """Same plan, same calls: a permanent fault at the second fetch raises
    in both packages, and the fired trails agree."""
    spec = dict(site="data.fetch", kind="permanent", at=(1,))
    cfg = tconfigs.get_config(ARCH)
    tfn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=64), cfg, 2, 8, "calib")
    jfn, _ = jpipe.make_batch_fn(jpipe.DataConfig(vocab=64), jconfigs.get_config(ARCH), 2, 8, "calib")
    tplan, jplan = FaultPlan([FaultSpec(**spec)]), JPlan([JSpecF(**spec)])
    with fault_plan(tplan):
        np.testing.assert_array_equal(tfn(0)["tokens"], jfn(0)["tokens"])
        with pytest.raises(PermanentFault):
            tfn(1)
    with jfault_plan(jplan):
        jfn(0)
        with pytest.raises(JPermanent):
            jfn(1)
    assert tplan.fired == jplan.fired == [("data.fetch", 1, "permanent")]


def _gemm_operands():
    r = np.random.default_rng(0)
    x = r.standard_normal((5, 64)).astype(np.float32)
    codes = r.integers(0, 16, (24, 64)).astype(np.uint8)
    scale = (r.random((24, 1)) * 0.1 + 0.01).astype(np.float32)
    zero = np.full((24, 1), 8.0, np.float32)
    return x, codes, scale, zero


def test_kernel_dispatch_deny_routes_one_call_to_the_plain_version():
    """Under a plan, ``deny`` at kernel.dispatch answers that call with the
    plain version in both packages (the same value), and the trail records
    it; ``permanent`` raises in both."""
    x, codes, scale, zero = _gemm_operands()
    t = [torch.from_numpy(a) for a in (x, codes, scale, zero)]
    for kind, exc_t, exc_j in (("deny", None, None), ("permanent", PermanentFault, JPermanent)):
        spec = dict(site="kernel.dispatch", kind=kind, at=(1,))
        tplan, jplan = FaultPlan([FaultSpec(**spec)]), JPlan([JSpecF(**spec)])
        outs = []
        for plan, ctx, call, exc in (
            (tplan, fault_plan, lambda: ops.dequant_matmul(*t, out_dtype=torch.float32), exc_t),
            (jplan, jfault_plan, lambda: jops.dequant_matmul(*map(jnp.asarray, (x, codes, scale, zero)),
                                                             out_dtype=jnp.float32), exc_j),
        ):
            with ctx(plan):
                first = np.asarray(call())
                if exc is None:
                    outs.append((first, np.asarray(call())))
                else:
                    with pytest.raises(exc):
                        call()
        assert tplan.fired == jplan.fired == [("kernel.dispatch", 1, kind)]
        if kind == "deny":
            (t0, t1), (j0, j1) = outs
            np.testing.assert_array_equal(t0, t1)
            np.testing.assert_allclose(t1, j1, rtol=1e-5, atol=1e-5)


def test_kernel_dispatch_site_in_paged_attention():
    r = np.random.default_rng(1)
    q = r.standard_normal((2, 1, 2, 16)).astype(np.float32)
    kp = r.standard_normal((4, 8, 1, 16)).astype(np.float32)
    vp = r.standard_normal((4, 8, 1, 16)).astype(np.float32)
    table = np.array([[0, 1], [2, 3]], np.int32)
    lens = np.array([11, 16], np.int32)
    spec = dict(site="kernel.dispatch", kind="deny", at=(0,))
    tplan, jplan = FaultPlan([FaultSpec(**spec)]), JPlan([JSpecF(**spec)])
    with fault_plan(tplan):
        got = ops.paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, table, lens)))
    with jfault_plan(jplan):
        want = jops.paged_attention(*map(jnp.asarray, (q, kp, vp, table, lens)))
    assert tplan.fired == jplan.fired == [("kernel.dispatch", 0, "deny")]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        got.numpy(), ref.paged_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, table, lens))).numpy())


# ---------------------------------------------------------------------------
# The tile-native layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,p,tk", [(4, 256, 128), (4, 200, 64), (2, 96, 32), (3, 128, 64),
                                       (8, 64, 32), (4, 48, 512)])
def test_prepack_matches_the_reference_bit_for_bit(bits, p, tk):
    r = np.random.default_rng(bits * p)
    codes = r.integers(0, 1 << bits, (2, 6, p)).astype(np.uint8)
    np.testing.assert_array_equal(tpack.tile_native_perm(p, bits, tk), jpack.tile_native_perm(p, bits, tk))
    tp = tpack.prepack_codes(torch.from_numpy(codes), bits, tk)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jpack.prepack_codes(jnp.asarray(codes), bits, tk)))
    np.testing.assert_array_equal(tpack.unprepack_codes(tp, bits, p, tk).numpy(), codes)


@pytest.mark.parametrize("bits,gsz", [(4, None), (3, 32)])
def test_quantize_tensor_matches_the_reference(bits, gsz):
    from repro.quant import GridSpec as JSpec
    from repro.quant import quantize_tensor as jquantize_tensor
    from repro_torch.quant import GridSpec, check_zero_points, quantize_tensor

    w = np.random.default_rng(bits).standard_normal((24, 96)).astype(np.float32)
    t = quantize_tensor(torch.from_numpy(w), GridSpec(bits=bits, group_size=gsz))
    j = jquantize_tensor(jnp.asarray(w), JSpec(bits=bits, group_size=gsz))
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(t.zero.numpy(), np.asarray(j.zero))
    check_zero_points(t)


@pytest.mark.parametrize("p,gsz", [(3072, None), (8192, None), (3072, 128), (200, None), (384, 256),
                                   (100, 48)])
def test_select_tile_k_matches_the_reference(p, gsz):
    from repro.kernels.dequant_matmul import select_tile_k

    assert tpack.select_tile_k(p, gsz) == select_tile_k(p, gsz)


@pytest.fixture(scope="module")
def artifacts():
    """The reference's 4-bit RTN serving artifact of a reduced fp32 Phi-3,
    linear and prepacked for its TPU."""
    from repro.core.solver import PTQConfig, ptq_quantize_model
    from repro.models import init_params, make_plan
    from repro.quant import GridSpec

    with fp32_configs():
        cfg = ttrain.reduced(jconfigs.get_config(ARCH))
    plan = make_plan(cfg, 1)
    params = init_params(plan, jax.random.PRNGKey(5))
    calib = [{"tokens": jnp.asarray(np.random.default_rng(2).integers(0, cfg.vocab, (2, 16)), jnp.int32)}]
    qp, _ = ptq_quantize_model(plan, params, calib, PTQConfig(method="rtn", emit="qt"))
    linear = jqparams.quantize_params_for_serving(plan, params, qp["dec"])
    tile, decisions = jqparams.prepack_params_for_serving(plan, linear, backend="tpu")
    return cfg, linear, tile, decisions


def test_prepack_params_for_tpu_matches_the_reference(artifacts):
    _, linear, tile, jdec = artifacts
    tlinear = interop.params_from_jax(jax.tree.map(np.asarray, linear), device="cpu")
    ttile, tdec = tqparams.prepack_params_for_serving(None, tlinear, backend="tpu")
    assert tdec == jdec and any(v.startswith("tile") for v in tdec.values())
    for key, blk in tile["dec"].items():
        for name, jqt in blk.items():
            if hasattr(jqt, "codes"):
                tqt = ttile["dec"][key][name]
                assert (tqt.pack_layout, tqt.pack_tile) == (jqt.pack_layout, jqt.pack_tile)
                np.testing.assert_array_equal(tqt.codes.numpy(), np.asarray(jqt.codes))
    _, cuda_dec = tqparams.prepack_params_for_serving(None, tlinear, backend="cuda")
    assert set(cuda_dec.values()) == {"linear-packed"}


def _logits(cfg, params):
    tcfg = dataclasses.replace(ttrain.reduced(tconfigs.get_config(ARCH)), dtype=torch.float32)
    plan = tmodel.make_plan(tcfg)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (2, 12))).long()
    return tmodel.hidden_states(plan, params, tokens)


def test_reference_tile_artifact_serves_as_its_linear_twin(artifacts, tmp_path):
    """Through interop and through a checkpoint, the reference's tile bytes
    enter the port un-prepacked: the codes and the forward pass equal the
    linear twin's bit for bit."""
    cfg, linear, tile, _ = artifacts
    tlin = interop.params_from_jax(jax.tree.map(np.asarray, linear), device="cpu")
    ttile = interop.params_from_jax(jax.tree.map(np.asarray, tile), device="cpu")
    qt = ttile["dec"]["b0"]["wg"]
    assert qt.pack_layout == "linear" and qt.pack_tile is None
    np.testing.assert_array_equal(qt.codes.numpy(), tlin["dec"]["b0"]["wg"].codes.numpy())
    np.testing.assert_array_equal(_logits(cfg, ttile).numpy(), _logits(cfg, tlin).numpy())
    jckpt.save_checkpoint(str(tmp_path), 1, {"params": tile})
    like, _ = tqparams.prepack_params_for_serving(None, tlin, backend="tpu")
    loaded, _ = tckpt.load_checkpoint(str(tmp_path), {"params": like})
    got = loaded["params"]["dec"]["b0"]["wg"]
    assert got.pack_layout == "linear"
    np.testing.assert_array_equal(got.codes.numpy(), tlin["dec"]["b0"]["wg"].codes.numpy())
    np.testing.assert_array_equal(_logits(cfg, loaded["params"]).numpy(), _logits(cfg, tlin).numpy())
