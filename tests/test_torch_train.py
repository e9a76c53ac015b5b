"""The port's training path against the reference's, on the same inputs.

Reduced ``bench_opt_s`` (fp32 unless a test says otherwise), params and
optimizer state carried across with ``repro_torch.interop``.  Tolerances:
``lr_schedule`` and ``global_norm`` rtol 1e-6; one ``adamw_update`` from a
carried non-zero state, params rtol 1e-6 (atol 1e-7 × max |p|), fp32
moments rtol 1e-6 (atol 1e-6 × the leaf's max |m|: b1·m + (1−b1)·g may
fuse differently), int8 codes equal or one code apart where the encoded
value lies within 1e-4 of a rounding midpoint; ``loss_and_grads`` and a
whole train step against ``jax.value_and_grad`` / the reference's
``make_train_step`` at 1 and 2 microbatches, rtol 1e-4 (grads atol 1e-4 ×
the leaf's max |g|; the stepped params atol 2 % of lr); five ``Trainer`` steps from carried params, losses
within 1e-3 relative.  Checkpoints: round trip, atomicity, recovery from a
fault and deterministic resume as the reference's tests, a seeded corrupt
shard caught by its CRC-32, and a checkpoint written by either package
loaded by the other bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as bench
from repro.dist import checkpoint as jckpt
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.models import train_loss as jtrain_loss
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jmake_step
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.dist import checkpoint as tckpt
from repro_torch.faults import FaultPlan, FaultSpec, fault_plan
from repro_torch.models import model as tmodel
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401

CPU = "cpu"


def _cfgs(**over):
    j = dataclasses.replace(reduce_cfg(bench.BENCH_CFG, **over), dtype=jnp.float32)
    t = dataclasses.replace(reduce_cfg(tget("bench_opt_s"), **over), dtype=torch.float32)
    return j, t


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(t_tree, j_tree, rtol, atol_frac=0.0):
    j_leaves = jax.tree.leaves(j_tree)
    t_leaves = tree_leaves(t_tree)
    assert len(j_leaves) == len(t_leaves)
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(t.detach().float().numpy(), j, rtol=rtol,
                                   atol=atol_frac * float(np.abs(j).max()))


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup", [0, 100])
def test_lr_schedule(warmup):
    cfg = dict(lr=2e-3, warmup_steps=warmup, total_steps=1600)
    for step in (0, 1, 7, 99, 100, 101, 800, 1599, 1600, 2000):
        j = float(jopt.lr_schedule(jopt.AdamWConfig(**cfg), jnp.asarray(step, jnp.int32)))
        t = float(topt.lr_schedule(topt.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32)))
        assert t == pytest.approx(j, rel=1e-6), step


def test_global_norm(rng):
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    j = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    t = float(topt.global_norm(interop.params_from_jax(tree, device=CPU)))
    assert t == pytest.approx(j, rel=1e-6)


def _q8_ties(t_enc, j_enc, value, signed):
    """Codes equal, or one apart where the encoded value (recomputed in
    float64 from ``value`` on the port's grid) lies within 1e-4 of a
    midpoint."""
    tq, jq = t_enc["q"].numpy().astype(int), np.asarray(j_enc["q"]).astype(int)
    differ = tq != jq
    if not differ.any():
        return 0
    assert np.abs(tq - jq).max() == 1
    scale = t_enc["scale"].double().numpy()
    if signed:
        r = value / scale + 128
    else:
        lx = np.log(value + topt._V_FLOOR)
        r = (lx - lx.min(-1, keepdims=True)) / scale
    frac = np.abs(r - np.floor(r) - 0.5)
    assert np.all(frac[differ] <= 1e-4), frac[differ]
    return int(differ.sum())


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_adamw_update_from_carried_state(rng, moments):
    params = {"w": rng.standard_normal((32, 64)).astype(np.float32),
              "b": rng.standard_normal(64).astype(np.float32),
              "n": {"k": rng.standard_normal((3, 8, 16)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p, s=s: np.random.default_rng(s).standard_normal(p.shape)
                          .astype(np.float32), params) for s in range(4)]
    cfg = dict(lr=1e-2, moments=moments, warmup_steps=2, total_steps=20)
    jcfg = jopt.AdamWConfig(**cfg)
    jp = jax.tree.map(jnp.asarray, params)
    state = jopt.adamw_init(jp, jcfg)
    for g in grads[:3]:  # a non-zero state, three steps in
        jp, state, _ = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), state, jcfg)
    tp = interop.params_from_jax(_np(jp), device=CPU)
    tstate = interop.opt_state_from_jax(_np(state), device=CPU)
    jp2, jstate2, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, grads[3]), state, jcfg)
    tp2, tstate2, tm = topt.adamw_update(
        tp, interop.params_from_jax(grads[3], device=CPU), tstate, topt.AdamWConfig(**cfg))
    _assert_tree_close(tp2, jp2, rtol=1e-6, atol_frac=1e-7)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tstate2["count"]) == int(jstate2["count"]) == 4
    for key in ("w", "b"):
        js, ts = jstate2["mu"][key], tstate2["mu"][key]
        if isinstance(js["m"], dict):
            # The new moments, from the carried state, in float64.
            clip = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-12))
            g = grads[3][key].astype(np.float64) * clip
            m_old = tstate["mu"][key]["m"]
            v_old = tstate["mu"][key]["v"]
            m = 0.9 * topt._decode(m_old, True).double().numpy() + 0.1 * g
            v = 0.95 * topt._decode(v_old, False).double().numpy() + 0.05 * g * g
            _q8_ties(ts["m"], js["m"], m, True)
            _q8_ties(ts["v"], js["v"], v, False)
            for enc in ("m", "v"):
                for f in ("scale", "zero"):
                    np.testing.assert_allclose(ts[enc][f].numpy(), np.asarray(js[enc][f]),
                                               rtol=1e-6)
        else:
            for mom in ("m", "v"):
                j = np.asarray(js[mom])
                np.testing.assert_allclose(ts[mom].numpy(), j, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(j).max()))


def test_adamw_int8_tracks_fp32(rng):
    """The reference's property on the port: 8-bit moments track fp32's
    update directions and never explode (log-domain v)."""
    params = {"w": torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal(64).astype(np.float32))}
    grads = {k: torch.from_numpy(np.random.default_rng(1).standard_normal(p.shape)
                                 .astype(np.float32)) for k, p in params.items()}
    outs = {}
    for moments in ("fp32", "int8"):
        cfg = topt.AdamWConfig(lr=1e-2, moments=moments, warmup_steps=0)
        state = topt.adamw_init(params, cfg)
        p = params
        for _ in range(5):
            p, state, _ = topt.adamw_update(p, grads, state, cfg)
        outs[moments] = p
    diff = float((outs["fp32"]["w"] - outs["int8"]["w"]).abs().max())
    step = float((outs["fp32"]["w"] - params["w"]).abs().max())
    upd_fp = (outs["fp32"]["w"] - params["w"]).ravel().numpy()
    upd_q8 = (outs["int8"]["w"] - params["w"]).ravel().numpy()
    assert float(np.corrcoef(upd_fp, upd_q8)[0, 1]) > 0.99
    assert diff < 0.6 * step


def test_adamw_rounds_bf16_params_once():
    """bf16 params update in fp32 and round back to bf16 once, as the
    reference's."""
    p = {"w": (torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7).to(torch.bfloat16)}
    g = {"w": torch.full((3, 4), 0.5, dtype=torch.bfloat16)}
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=0)
    tp, _, _ = topt.adamw_update(p, g, topt.adamw_init(p, cfg), cfg)
    jp, _, _ = jopt.adamw_update(
        {"w": jnp.asarray(p["w"].float().numpy()).astype(jnp.bfloat16)},
        {"w": jnp.full((3, 4), 0.5, jnp.bfloat16)},
        jopt.adamw_init({"w": jnp.zeros((3, 4), jnp.bfloat16)}, jopt.AdamWConfig(lr=1e-2, warmup_steps=0)),
        jopt.AdamWConfig(lr=1e-2, warmup_steps=0))
    assert tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(), np.asarray(jp["w"], np.float32))


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_setup():
    jcfg, tcfg = _cfgs()
    jp = jinit(jplan(jcfg, 1), jax.random.PRNGKey(5))
    r = np.random.default_rng(9)
    tokens = r.integers(0, jcfg.vocab, (4, 24)).astype(np.int32)
    return jcfg, tcfg, jp, tokens


@pytest.mark.parametrize("n_mb", [1, 2])
def test_loss_and_grads_match(step_setup, n_mb):
    jcfg, tcfg, jp, tokens = step_setup
    plan = jplan(jcfg, 1)
    vg = jax.value_and_grad(lambda p, b: jtrain_loss(plan, p, b))
    parts = np.split(tokens, n_mb)
    outs = [vg(jp, {"tokens": jnp.asarray(t)}) for t in parts]
    j_loss = sum(float(o[0]) for o in outs) / n_mb
    j_grads = jax.tree.map(lambda *g: sum(np.asarray(x, np.float32) for x in g) / n_mb,
                           *[o[1] for o in outs])
    t_loss, t_grads = loss_and_grads(tmodel.make_plan(tcfg),
                                     interop.params_from_jax(_np(jp), device=CPU),
                                     {"tokens": tokens}, n_mb)
    assert float(t_loss) == pytest.approx(j_loss, rel=1e-4)
    _assert_tree_close(t_grads, j_grads, rtol=1e-4, atol_frac=1e-4)


@pytest.mark.parametrize("n_mb", [1, 2])
def test_train_step_matches(step_setup, n_mb):
    jcfg, tcfg, jp, tokens = step_setup
    cfg = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jstep = jax.jit(jmake_step(jplan(jcfg, 1), jopt.AdamWConfig(**cfg), n_mb))
    jp2, _, jm = jstep(jp, jopt.adamw_init(jp, jopt.AdamWConfig(**cfg)), {"tokens": jnp.asarray(tokens)})
    tp = interop.params_from_jax(_np(jp), device=CPU)
    tstep = make_train_step(tmodel.make_plan(tcfg), topt.AdamWConfig(**cfg), n_mb)
    tp2, _, tm = tstep(tp, topt.adamw_init(tp, topt.AdamWConfig(**cfg)), {"tokens": tokens})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    # Adam's first step moves each entry by about lr·g/(|g| + ε): an entry
    # whose |g| lies near fp32 noise moves by a fraction of lr that the noise
    # decides, so the params compare at 2 % of lr.
    for t, j in zip(tree_leaves(tp2), jax.tree.leaves(jp2)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=0.02 * cfg["lr"])


def test_trainer_five_steps_match_reference(tmp_path):
    jcfg, tcfg = _cfgs(vocab=128)
    opt = dict(lr=1e-3, total_steps=5, warmup_steps=1)
    tc = dict(steps=5, batch=4, seq=32, ckpt_every=100, log_every=1)
    jt = JTrainer(jcfg, jopt.AdamWConfig(**opt), JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **tc))
    params = interop.params_from_jax(_np(jt.params), device=CPU)
    jlog = jt.run()["log"]
    tt = Trainer(tcfg, topt.AdamWConfig(**opt), TrainerConfig(ckpt_dir=str(tmp_path / "t"), **tc),
                 params=params, device=CPU)
    tlog = tt.run()["log"]
    assert [m["step"] for m in tlog] == [m["step"] for m in jlog] == list(range(5))
    for t, j in zip(tlog, jlog):
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-3), t["step"]


def test_trainer_leaves_no_tensor_in_reference_cycles(tmp_path):
    """A step's gradients and old state are freed by reference counting:
    none waits in a reference cycle for Python's cycle collector (on the
    card that made the training peak depend on when the collector ran)."""
    import gc

    _, tcfg = _cfgs()
    tr = Trainer(tcfg, topt.AdamWConfig(lr=1e-3, total_steps=3),
                 TrainerConfig(steps=3, batch=2, seq=16, ckpt_every=99, ckpt_dir=str(tmp_path)),
                 device=CPU)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        tr.run()
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not cyclic, f"{len(cyclic)} tensors were left in reference cycles"


def test_trainer_refuses_a_mesh():
    """Data meshes and "model" axes train (tests/test_torch_dist_train.py,
    tests/test_torch_tp_train.py, tests/test_torch_tp_encdec.py).  The
    encoder-decoder and prefix families refused a "model" axis larger than
    1 until ROADMAP item 8.1.4 lifted it: on stub ("data", "model") meshes
    of 1 × 2 and 4 × 16, with or without FSDP, their trainers now build on
    the plan padded for the axis, the encoder's and the decoder's heads cut
    on "model" (and, with FSDP, every "embed" dimension on "data").
    fsdp=True without a mesh is the local trainer, as in the reference.
    The name is kept from when every mesh was refused, so the test's
    record carries on."""
    import types

    _, tcfg = _cfgs()
    for arch in ("whisper_large_v3", "llava_next_34b"):
        cfg = dataclasses.replace(reduce_cfg(tget(arch)), dtype=torch.float32)
        for n_data, n_model in ((1, 2), (4, 16)):
            mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(n_data, n_model),
                                         get_local_rank=lambda axis: 0, get_group=lambda axis: None)
            for fsdp in (False, True):
                tr = Trainer(cfg, topt.AdamWConfig(), TrainerConfig(), mesh=mesh, fsdp=fsdp,
                             device=CPU)
                hp = tr.plan.heads
                assert tr.plan.axis_n == n_model and hp.kv_pad % n_model == 0
                stack = "enc" if cfg.family == "encdec" else "dec"
                wq = tr.params[stack]["b0"]["wq"]  # (layers, embed, heads, G, hd)
                d_local = cfg.d_model // n_data if fsdp and n_data > 1 else cfg.d_model
                assert wq.shape[1:3] == (d_local, hp.kv_pad // n_model), (arch, n_model, fsdp)
    assert Trainer(tcfg, topt.AdamWConfig(), TrainerConfig(), fsdp=True, device=CPU).shards is None


# ---------------------------------------------------------------------------
# Checkpoints (the reference's tests on the port) and the trainer loop
# ---------------------------------------------------------------------------


def _bits(t):
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


def _nbits(a):
    return np.asarray(a).reshape(-1).view(np.uint8)


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": (torch.arange(12, dtype=torch.float32).reshape(3, 4) / 3).to(torch.bfloat16),
        "n": {"b": torch.from_numpy(np.random.default_rng(0).standard_normal(5).astype(np.float32))},
        "c": torch.tensor([3], dtype=torch.int32),
        "q": torch.arange(6, dtype=torch.uint8),
    }
    tckpt.save_checkpoint(str(tmp_path), 7, tree, meta={"data_step": 9})
    out, manifest = tckpt.load_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 7 and manifest["meta"]["data_step"] == 9
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_atomicity(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.ones(2, 2)})
    os.makedirs(tmp_path / "step_2.tmp")  # a crashed half-write
    tckpt.cleanup_tmp(str(tmp_path))
    assert tckpt.latest_step(str(tmp_path)) == 1
    assert not (tmp_path / "step_2.tmp").exists()


def test_checkpoint_corrupt_shard_is_caught(tmp_path):
    tree = {"a": torch.arange(64, dtype=torch.float32), "b": torch.ones(3)}
    tckpt.save_checkpoint(str(tmp_path), 1, tree)
    plan = FaultPlan([FaultSpec("ckpt.write", "corrupt", at=(0,))], seed=3)
    with fault_plan(plan):
        tckpt.save_checkpoint(str(tmp_path), 2, tree)
    assert plan.fired == [("ckpt.write", 0, "corrupt")]
    with pytest.raises(tckpt.CheckpointCorrupt, match="checksum"):
        tckpt.load_checkpoint(str(tmp_path), tree, step=2)
    out, manifest, skipped = tckpt.load_last_good(str(tmp_path), tree)
    assert manifest["step"] == 1 and [s for s, _ in skipped] == [2]
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"].numpy())


def test_trainer_recovers_from_failure(tmp_path):
    _, tcfg = _cfgs(vocab=128)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    t = Trainer(tcfg, topt.AdamWConfig(lr=1e-3, total_steps=30),
                TrainerConfig(steps=30, batch=4, seq=32, ckpt_every=10, ckpt_dir=str(tmp_path),
                              log_every=10), device=CPU)
    died = []

    def fault(step):
        if step == 15 and not died:
            died.append(1)
            raise RuntimeError("boom")

    out = t.run(fault_hook=fault)
    assert out["recoveries"] == 1
    assert out["log"][-1]["loss"] < out["log"][0]["loss"]


def test_trainer_deterministic_resume(tmp_path):
    """Stop at 20 of 40, resume in a fresh Trainer → the same final params
    as an uninterrupted run (exact-step data replay)."""
    _, tcfg = _cfgs(vocab=64, n_periods=1)
    opt = topt.AdamWConfig(lr=1e-3, total_steps=40)

    def mk(steps, d):
        return Trainer(tcfg, opt, TrainerConfig(steps=steps, batch=4, seq=16, ckpt_every=20,
                                                ckpt_dir=d, log_every=40), device=CPU)

    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    t_full = mk(40, d1)
    t_full.run()
    mk(20, d2).run()
    t_resume = mk(40, d2)  # picks up at step 20 from d2
    t_resume.run()
    for a, b in zip(tree_leaves(t_full.params), tree_leaves(t_resume.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _mixed_tree(r):
    return {
        "w": jnp.asarray(r.standard_normal((4, 6)).astype(np.float32)).astype(jnp.bfloat16),
        "x": {"y": jnp.asarray(r.standard_normal(5).astype(np.float32)),
              "q": jnp.asarray(r.integers(0, 255, (2, 3)).astype(np.uint8))},
        "count": jnp.asarray(7, jnp.int32),
    }


def test_reference_checkpoint_loads_in_port(tmp_path, rng):
    tree = _mixed_tree(rng)
    jckpt.save_checkpoint(str(tmp_path), 3, tree, meta={"data_step": 4})
    like = interop.params_from_jax(_np(tree), device=CPU)
    out, manifest = tckpt.load_checkpoint(str(tmp_path), like)
    assert manifest["meta"] == {"data_step": 4}
    for j, t in zip(jax.tree.leaves(tree), tree_leaves(out)):
        assert tuple(t.shape) == j.shape
        np.testing.assert_array_equal(_bits(t), _bits(interop.tensor_from_numpy(np.asarray(j), CPU)))


def test_port_checkpoint_loads_in_reference(tmp_path, rng):
    tree = _mixed_tree(rng)
    tckpt.save_checkpoint(str(tmp_path), 3, interop.params_from_jax(_np(tree), device=CPU),
                          meta={"data_step": 4})
    out, _ = jckpt.load_checkpoint(str(tmp_path), tree)
    for j, o in zip(jax.tree.leaves(tree), jax.tree.leaves(out)):
        assert o.dtype == j.dtype
        np.testing.assert_array_equal(_nbits(o), _nbits(j))


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_trainer_state_crosses_packages(tmp_path, moments):
    """A reference Trainer's checkpoint (bf16 params, AdamW state) restores
    into the port's Trainer bit for bit, and the port's save loads back into
    the reference's."""
    jcfg, tcfg = _cfgs(vocab=64, n_periods=1)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    opt = dict(lr=1e-3, total_steps=4, moments=moments)
    tc = dict(steps=2, batch=2, seq=16, ckpt_every=2, log_every=2)
    jt = JTrainer(jcfg, jopt.AdamWConfig(**opt), JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **tc))
    jt.run()
    tt = Trainer(tcfg, topt.AdamWConfig(**opt), TrainerConfig(ckpt_dir=str(tmp_path / "j"), **tc),
                 device=CPU)
    assert tt.restore() == 2 and tt.data_step == 2
    j_state = {"params": jt.params, "opt": jt.opt_state}
    t_state = {"params": tt.params, "opt": tt.opt_state}
    j_leaves, t_leaves = jax.tree.leaves(j_state), tree_leaves(t_state)
    assert len(j_leaves) == len(t_leaves)
    for j, t in zip(j_leaves, t_leaves):
        np.testing.assert_array_equal(_bits(t), _bits(interop.tensor_from_numpy(np.asarray(j), CPU)))
    tt.tcfg.ckpt_dir = str(tmp_path / "t")
    tt.save(2)
    back, manifest = jckpt.load_checkpoint(str(tmp_path / "t"), j_state)
    assert manifest["meta"] == {"data_step": 2}
    for j, b in zip(j_leaves, jax.tree.leaves(back)):
        np.testing.assert_array_equal(_nbits(b), _nbits(j))
