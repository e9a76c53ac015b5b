"""The port's data-parallel and FSDP trainer on 2 gloo ranks, held against
the JAX package's trainer and the port's one-rank trainer.

One process group of 2 ranks (``tests/_torch_dist.py``) runs
``Trainer(mesh=<data mesh>)`` five steps on a reduced fp32 Phi-3 with
``fsdp`` false (plain data parallelism) and true, and true with 8-bit
moments, from the reference's initial params:

* every step's loss and logged gradient norm within 1e-5 relative of the
  reference's ``Trainer(mesh=None)`` and of the port's one-rank trainer
  (the norm is the averaged gradient's: a sum over ranks would double it,
  where AdamW's update and the losses would not move), and the final
  params the ranks gather off the one-rank trainer's by at most UPDATE_RTOL
  of how far that trainer moved them (Euclidean norms over the whole tree;
  measured 2.7e-5 with fp32 moments, 1.8e-4 with 8-bit ones: AdamW's
  m/√v amplifies the gradients' reduction order where they are small);
* the FSDP checkpoint, written whole by rank 0, restores each rank's blocks
  bit for bit, and the one-rank trainer and
  ``repro.dist.checkpoint.load_checkpoint`` read from it the whole state
  the ranks gathered, bit for bit;
* on a one-rank mesh (rank 0) every run is the local trainer, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.dist import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.dist import checkpoint as tckpt
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
from repro_torch.tree import tree_leaves
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests._torch_dist import start_group, train_rank, tree_bits
from tests.conftest import reduce_cfg

LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-3
RUNS = ((False, "fp32"), (True, "fp32"), (True, "int8"))
OPT = dict(lr=1e-3, total_steps=5, warmup_steps=1)
TC = dict(steps=5, batch=4, seq=32, ckpt_every=5, log_every=1)


def _logged(log):
    return dict(losses=[float(m["loss"]) for m in log],
                grad_norms=[float(m["grad_norm"]) for m in log])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b")), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b")), dtype=torch.float32)
    tmp = tmp_path_factory.mktemp("dist_train")
    jts = {moments: JTrainer(jcfg, jopt.AdamWConfig(moments=moments, **OPT),
                             JTrainerConfig(ckpt_dir=str(tmp / f"j_{moments}"), **TC))
           for moments in ("fp32", "int8")}
    params = jax.tree.map(np.asarray, jts["fp32"].params)
    # The ranks run while this process runs the reference and the local trainer.
    case = dict(cfg=tcfg, opt=OPT, tc=TC, params=params, runs=RUNS)
    group = start_group(train_rank, 2, tmp, case, str(tmp / "ranks"))
    ref = {moments: _logged(jt.run()["log"]) for moments, jt in jts.items()}
    local = {}
    for moments in ("fp32", "int8"):
        tr = Trainer(tcfg, AdamWConfig(moments=moments, **OPT),
                     TrainerConfig(ckpt_dir=str(tmp / f"t_{moments}"), **TC),
                     params=interop.params_from_jax(params, device="cpu"), device="cpu")
        local[moments] = dict(_logged(tr.run()["log"]),
                              params=[t.numpy() for t in tree_leaves(tr.params)])
    ranks = group.result()
    init = [t.numpy() for t in tree_leaves(interop.params_from_jax(params, device="cpu"))]
    return dict(ref=ref, local=local, ranks=ranks, tmp=tmp, tcfg=tcfg, jcfg=jcfg, init=init)


@pytest.mark.parametrize("fsdp,moments", RUNS)
def test_data_parallel_losses_match(runs, fsdp, moments):
    r0, r1 = (r[(fsdp, moments)] for r in runs["ranks"])
    assert r0["losses"] == r1["losses"] and r0["grad_norms"] == r1["grad_norms"]
    assert len(r0["losses"]) == TC["steps"]
    # FSDP splits every "embed" dimension (d_model 64 over 2 ranks); plain
    # data parallelism splits nothing.
    assert bool(r0["sharded"]) == fsdp
    for other in (runs["ref"][moments], runs["local"][moments]):
        for key in ("losses", "grad_norms"):
            np.testing.assert_allclose(r0[key], other[key], rtol=LOSS_RTOL, atol=0, err_msg=key)
    local = runs["local"][moments]["params"]
    assert len(r0["params"]) == len(local) == len(runs["init"])
    off = np.sqrt(sum(np.sum((a - b) ** 2, dtype=np.float64) for a, b in zip(r0["params"], local)))
    moved = np.sqrt(sum(np.sum((b - c) ** 2, dtype=np.float64) for b, c in zip(local, runs["init"])))
    assert moved > 0 and off <= UPDATE_RTOL * moved, (off, moved)
    assert r0["restored"] and r1["restored"]


def test_one_rank_mesh_is_the_local_trainer(runs):
    assert runs["ranks"][0]["one_rank_bitwise"] == [True] * len(RUNS)


def test_fsdp_checkpoint_loads_in_both_packages(runs):
    """The checkpoint of the FSDP fp32 run holds the run's whole final state:
    the one-rank trainer restores exactly the bits the ranks gathered, and
    the reference's loader reads the same bits."""
    d = str(runs["tmp"] / "ranks" / "True_fp32")
    assert tckpt.latest_step(d) == TC["steps"]
    tr = Trainer(runs["tcfg"], AdamWConfig(**OPT), TrainerConfig(ckpt_dir=d, **TC), device="cpu")
    assert tr.restore() == TC["steps"]
    state = {"params": tr.params, "opt": tr.opt_state}
    assert tree_bits(state) == runs["ranks"][0][(True, "fp32")]["whole"]
    jt = JTrainer(runs["jcfg"], jopt.AdamWConfig(**OPT), JTrainerConfig(ckpt_dir=d, **TC))
    jstate, manifest = jckpt.load_checkpoint(d, {"params": jt.params, "opt": jt.opt_state})
    assert manifest["step"] == TC["steps"]
    got = tree_leaves(state)
    assert len(jax.tree.leaves(jstate)) == len(got)
    for a, b in zip(jax.tree.leaves(jstate), got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
