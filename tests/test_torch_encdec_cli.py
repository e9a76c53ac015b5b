"""The command line on the encoder-decoder family (Whisper) and the
prefix family (LLaVA), the port's against the reference's.

* ``launch.train --reduce`` (the port's), then both packages'
  ``launch.quantize`` (QuantEase, 4 bits, 3 CD iterations) on its
  checkpoint, in fp32 as ``tests/test_torch_launch.py`` runs them: the
  per-layer reports within 1e-3 relative wherever the two artifacts agree;
  a layer whose artifacts part does so at rounding ties, each differing
  weight one step of its row's grid from the reference's, in at most 1 %
  of the rows (measured: 4 entries of LLaVA's ``dec.p1`` ``wk``);
* ``launch.serve`` and ``launch.eval`` exit naming the family, where the
  reference's CLIs fail further in.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.configs import get_config as jget
from repro_torch.configs import get_config as tget
from repro_torch.dist import checkpoint as tckpt
from repro_torch.launch import common as lcommon
from repro_torch.models import model as tm
from repro_torch.quant import GridSpec as TSpec
from repro_torch.quant import compute_grid as tgrid
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests.test_torch_encdec import ARCHS, CPU, FAMILY, ITERATIONS, SEQ, _matrix


@pytest.mark.parametrize("arch", ARCHS)
def test_reduce_flag_is_the_references(arch):
    """``launch.train.reduced`` (the CLIs' ``--reduce``) equals the
    reference's field for field."""
    from repro.launch.train import reduced as jreduced
    from repro_torch.launch.train import reduced as treduced

    a, b = dataclasses.asdict(treduced(tget(arch))), dataclasses.asdict(jreduced(jget(arch)))
    a.pop("dtype"), b.pop("dtype")
    assert a == b


@pytest.fixture
def fp32_configs():
    """Both packages' CLIs on the fp32 variant of the arch (as
    ``tests/test_torch_launch.py`` runs them)."""
    jgetc, tgetc = jconfigs.get_config, tconfigs.get_config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfigs, "get_config", lambda n: dataclasses.replace(jgetc(n), dtype=jnp.float32))
        mp.setattr(tconfigs, "get_config", lambda n: dataclasses.replace(tgetc(n), dtype=torch.float32))
        yield


@pytest.mark.parametrize("arch", ARCHS)
def test_train_and_quantize_clis_agree_with_the_reference(tmp_path, arch, fp32_configs):
    """``launch.train --reduce`` (the port's), then both packages'
    ``launch.quantize`` (QuantEase, 4 bits) on its checkpoint: calibration
    batches carry frames or patches, and the reports agree per layer within
    1e-3 (``tests/test_torch_launch.py``'s tolerance) wherever the two
    written artifacts agree.  A layer whose artifacts part does so at
    rounding ties (verified on this file's solver runs): there every
    differing weight is one step of its row's grid away from the
    reference's, in at most 1 % of all rows (measured: 4 entries of
    LLaVA's ``dec.p1`` ``wk``)."""
    from repro.launch import quantize as jquantize
    from repro_torch.launch import quantize as tquantize
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.train import reduced as treduced

    ck = str(tmp_path / "train")
    out = ttrain.main(["--arch", arch, "--reduce", "--steps", "2", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", ck, "--device", CPU])
    assert all(np.isfinite(m["loss"]) for m in out["log"])
    args = ["--arch", arch, "--reduce", "--ckpt-dir", ck, "--method", "quantease", "--bits", "4",
            "--iterations", str(ITERATIONS), "--calib-batches", "1", "--seq", str(SEQ)]
    trep = tquantize.main([*args, "--out-dir", str(tmp_path / "tq"), "--device", CPU])["report"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["quantize", *args, "--out-dir", str(tmp_path / "jq")])
        jquantize.main()
    jman = json.load(open(os.path.join(tmp_path / "jq", "step_2", "manifest.json")))
    jrep = jman["meta"]["report"]
    assert list(trep) == list(jrep)
    assert any(k.startswith("enc.") for k in trep) == (arch == "whisper_large_v3")
    tp = tm.make_plan(dataclasses.replace(treduced(tget(arch)), dtype=torch.float32))
    load = lambda d, like: tckpt.load_checkpoint(str(d), like)[0]["params"]
    src = load(ck, lcommon.train_template(tp, torch.device(CPU)))
    outs = [load(tmp_path / d, {"params": tm.empty_params(tp, device=CPU)}) for d in ("tq", "jq")]
    parted_rows, n_rows = 0, 0
    for k in trep:
        scope, name = k.split("/")
        stack, period, blk = scope.split(".")
        period = int(period[1:])
        w0 = _matrix(src[stack][blk][name], period, name, "torch")
        wt, wj = (_matrix(o[stack][blk][name], period, name, "torch") for o in outs)
        n_rows += w0.shape[0]
        if torch.equal(wt, wj):
            assert trep[k] == pytest.approx(jrep[k], rel=1e-3), k
            continue
        step = tgrid(w0[None], TSpec(bits=4)).scale[0]  # (rows, 1)
        rows = (wt != wj).any(-1)
        torch.testing.assert_close((wt - wj).abs()[wt != wj],
                                   step.expand_as(wt)[wt != wj], rtol=1e-5, atol=0)
        parted_rows += int(rows.sum())
    assert parted_rows <= 0.01 * n_rows, (parted_rows, n_rows)




@pytest.mark.parametrize("cli", ["serve", "eval"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_and_eval_clis_refuse(tmp_path, capsys, arch, cli, fp32_configs):
    """``launch.serve`` and ``launch.eval`` exit naming the family; the
    reference's CLIs fail further in (the contiguous engine's admission,
    the scorer)."""
    import importlib

    tmod = importlib.import_module(f"repro_torch.launch.{cli}")
    jmod = importlib.import_module(f"repro.launch.{cli}")
    common = ["--arch", arch, "--reduce", "--ckpt-dir", str(tmp_path / "none")]
    extra = ["--requests", "1", "--max-new", "2"] if cli == "serve" else \
        ["--smoke", "--out", str(tmp_path / "e.json")]
    with pytest.raises(SystemExit, match=f"{FAMILY[arch]} family"):
        tmod.main([*common, *extra, "--device", CPU])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [cli, *common, *extra])
        if cli == "serve":  # the contiguous engine's admission passes tokens alone
            missing = "frames" if arch == "whisper_large_v3" else "patches"
            with pytest.raises(KeyError, match=missing):
                jmod.main()
        else:
            with pytest.raises(ValueError, match="token-only decoder models only"):
                jmod.main()
