"""The port's main path as a whole, against the reference on one input.

Reduced Phi-3 (fp32), the same params (carried across with
``repro_torch.interop``) and the same calibration tokens go through
``ptq_quantize_model`` (QuantEase, 5 iterations, ``emit="qt"``) →
``quantize_params_for_serving`` → ``perplexity_on_stream`` in both
packages.  Tolerances: per-layer relative errors and perplexity within 1e-3
relative; emitted codes equal on ≥ 99% of entries (a rounding tie may flip).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import solver as jsolver
from repro.data import pipeline as jpipe
from repro.eval import scorer as jscorer
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.quant import GridSpec as JSpec
from repro.quant import unpack_codes as junpack
from repro.serve import qparams as jqparams
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.core import solver as tsolver
from repro_torch.data import pipeline as tpipe
from repro_torch.eval import scorer as tscorer
from repro_torch.models import model as tmodel
from repro_torch.quant import GridSpec as TSpec
from repro_torch.serve import qparams as tqparams
from tests.conftest import reduce_cfg

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def slice_runs():
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b")), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b")), dtype=torch.float32)
    jp, tp = jplan(jcfg, 1), tmodel.make_plan(tcfg)
    params = jinit(jp, jax.random.PRNGKey(1))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    calib_fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=tcfg.vocab, seed=0), tcfg, 2, 64, split="calib")
    calib = [calib_fn(i) for i in range(2)]
    runs = {}
    for method in ("rtn", "quantease"):
        jq, jrep = jsolver.ptq_quantize_model(
            jp, params, [{"tokens": jnp.asarray(b["tokens"])} for b in calib],
            jsolver.PTQConfig(method=method, spec=JSpec(bits=4), iterations=5, emit="qt"),
        )
        records = []
        tq, trep = tsolver.ptq_quantize_model(
            tp, tparams, calib,
            tsolver.PTQConfig(method=method, spec=TSpec(bits=4), iterations=5, emit="qt"),
            progress_cb=records.append, device="cpu",
        )
        jserve = jqparams.quantize_params_for_serving(jp, params, jq["dec"])
        tserve = tqparams.quantize_params_for_serving(tp, tparams, tq["dec"], device="cpu")
        jeval, _ = jpipe.make_batch_fn(jpipe.DataConfig(vocab=jcfg.vocab, seed=0), jcfg, 2, 64, split="eval")
        teval, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=tcfg.vocab, seed=0), tcfg, 2, 64, split="eval")
        runs[method] = dict(
            jq=jq, tq=tq, jrep=jrep, trep=trep, records=records,
            jppl=jscorer.perplexity_on_stream(jp, jserve, jeval, n_batches=2),
            tppl=tscorer.perplexity_on_stream(tp, tserve, teval, n_batches=2, device="cpu"),
        )
    return runs


@pytest.mark.parametrize("method", ["rtn", "quantease"])
def test_layer_errors_match(slice_runs, method):
    r = slice_runs[method]
    assert list(r["trep"]) == list(r["jrep"])
    for k, v in r["jrep"].items():
        assert r["trep"][k] == pytest.approx(v, rel=1e-3), k


def test_quantease_beats_rtn(slice_runs):
    mean = lambda rep: float(np.mean(list(rep.values())))
    assert mean(slice_runs["quantease"]["trep"]) < mean(slice_runs["rtn"]["trep"])


@pytest.mark.parametrize("method", ["rtn", "quantease"])
def test_emitted_codes_match(slice_runs, method):
    r = slice_runs[method]
    n_eq = n_all = 0
    for jper, tper in zip(r["jq"]["dec"], r["tq"]["dec"]):
        for name, jqt in jper["b0"].items():
            if not hasattr(jqt, "codes"):
                continue
            tqt = tper["b0"][name]
            assert (tqt.packed, tqt.bits, tqt.shape) == (jqt.packed, jqt.bits, tuple(jqt.shape))
            np.testing.assert_array_equal(tqt.scale.numpy(), np.asarray(jqt.scale))
            jc = np.asarray(junpack(jqt.codes, 4, jqt.shape[-1]))
            tc = tqt.unpacked_codes().numpy()
            n_eq += int((jc == tc).sum())
            n_all += jc.size
    assert n_eq / n_all >= 0.99


@pytest.mark.parametrize("method", ["rtn", "quantease"])
def test_perplexity_matches(slice_runs, method):
    r = slice_runs[method]
    assert r["tppl"]["n_tokens"] == r["jppl"]["n_tokens"]
    assert r["tppl"]["ppl"] == pytest.approx(r["jppl"]["ppl"], rel=1e-3)


def test_progress_records_carry_reference_keys(slice_runs):
    recs = slice_runs["quantease"]["records"]
    assert [(r["period"], r["done_blocks"]) for r in recs] == [(0, 1), (1, 2)]
    assert set(recs[0]) == {
        "stack", "period", "block", "done_blocks", "total_blocks", "n_linears",
        "mean_rel_error", "layer_errors", "seconds",
    }
    assert recs[0]["n_linears"] == 7


def test_port_imports_no_jax_and_no_reference():
    """Importing every module of the port (Algorithm 3's ``core.outlier``,
    the serving engines, the fault plans, the eval tasks and harness, GPTQ,
    the trainer and the checkpoints, AWQ, SpQR, the launchers, speculative
    serving and the tuner among them), and chip_smoke, loads neither jax nor
    the reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "need = ['repro_torch.core.outlier', 'repro_torch.kernels.quantease_cd', 'repro_torch.core.solver',\n"
        "        'repro_torch.serve.engine', 'repro_torch.serve.kv_cache', 'repro_torch.faults',\n"
        "        'repro_torch.kernels.paged_attention', 'repro_torch.eval.tasks',\n"
        "        'repro_torch.eval.harness', 'repro_torch.core.gptq', 'repro_torch.train.optimizer',\n"
        "        'repro_torch.train.train_step', 'repro_torch.train.trainer',\n"
        "        'repro_torch.dist.checkpoint', 'repro_torch.dist.elastic',\n"
        "        'repro_torch.configs.bench_opt_s', 'repro_torch.core.awq', 'repro_torch.core.spqr',\n"
        "        'repro_torch.launch.progress', 'repro_torch.launch.train',\n"
        "        'repro_torch.launch.quantize', 'repro_torch.launch.eval',\n"
        "        'repro_torch.launch.serve', 'repro_torch.serve.spec', 'repro_torch.serve.qparams',\n"
        "        'repro_torch.tune', 'repro_torch.tune.sensitivity', 'repro_torch.tune.allocate',\n"
        "        'repro_torch.tune.search', 'repro_torch.launch.tune']\n"
        "bad += [m + ' not loaded' for m in need if m not in sys.modules]\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 44 and bad == "[]", out.stdout


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.device import resolve_device

    plan = tmodel.make_plan(reduce_cfg(tget("phi3_mini_3_8b")))
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodel.init_params(plan, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.params_from_jax({"w": np.zeros((2, 2), np.float32)})
    params = tmodel.init_params(plan, 0, device="cpu")
    calib_fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=256, seed=0), plan.cfg, 1, 8, split="calib")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsolver.ptq_quantize_model(plan, params, [calib_fn(0)], tsolver.PTQConfig(iterations=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        tqparams.quantize_params_for_serving(plan, params, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        tscorer.perplexity_on_stream(plan, params, calib_fn, n_batches=1)
    from repro_torch.core.calib import CalibStats
    from repro_torch.eval import harness as tharness
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig

    with pytest.raises(RuntimeError, match="CUDA"):
        tscorer.next_token_logits(plan, params, np.arange(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        tharness.eval_model(plan, params, calib_fn, budget=tharness.EvalBudget.smoke())
    with pytest.raises(RuntimeError, match="CUDA"):
        tharness.run_grid(plan, params, [calib_fn(0)], calib_fn, [])
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(plan.cfg, AdamWConfig(), TrainerConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        CalibStats.zeros(8)
    assert CalibStats.zeros(8, device="cpu").sigma.device.type == "cpu"


def test_entry_points_refuse_params_on_another_device():
    """Params that live elsewhere than the asked-for device are refused, not
    run where they happen to lie."""
    plan = tmodel.make_plan(reduce_cfg(tget("phi3_mini_3_8b")))
    params = tmodel.tree_map(lambda a: a.to("meta"), tmodel.init_params(plan, 0, device="cpu"))
    calib_fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=256, seed=0), plan.cfg, 1, 8, split="calib")
    with pytest.raises(ValueError, match="live on meta"):
        tsolver.ptq_quantize_model(plan, params, [calib_fn(0)], tsolver.PTQConfig(iterations=1),
                                   device="cpu")
    with pytest.raises(ValueError, match="live on meta"):
        tqparams.quantize_params_for_serving(plan, params, [], device="cpu")
    with pytest.raises(ValueError, match="live on meta"):
        tscorer.perplexity_on_stream(plan, params, calib_fn, n_batches=1, device="cpu")
