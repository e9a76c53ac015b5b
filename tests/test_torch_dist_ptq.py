"""The port's data-parallel PTQ on gloo ranks, held against the JAX package.

One process group of 2 ranks and one of 3 (``tests/_torch_dist.py``: spawned,
a ``file://`` store, one torch thread a rank) run every case of this file;
the checks compare their results with ``repro`` on the CPU:

* ``sharded_gram`` / ``CalibStats.update_tokens(mesh=)`` on row (sequence)
  counts neither 2 nor 3 divides, against ``repro.core.calib.sharded_gram(x,
  None)`` within 1e-6 × max |Σ|, every rank the same bits; and against the
  reference's own 2-device ``sharded_gram`` on two forged JAX devices;
* the row-sharded solve (``quantease``, its q padded; ``gptq``; ``rtn``)
  against the reference's unsharded solve on the same Σ (the reference's
  ``_shard_rows`` fails under jax 0.9.0, ROADMAP §3): codes equal outside
  rows that start at a verified rounding tie, Ŵ within the port's ``ATOL``s
  elsewhere, every rank's gathered block the same bits; ``qe_outlier``
  under the mesh the port's local solve, bit for bit;
* ``qgather`` on 2 ranks against the reference's ``_gather_int8`` on one
  device: codes equal, values within one ulp of the leaf's dtype;
* ``ptq_quantize_model(mesh=)`` on a reduced fp32 Phi-3 (QuantEase at 4
  bits, 3 sequences a batch over 2 ranks): the report within 1e-4 of the
  reference's unsharded one, progress records from rank 0 only, both ranks
  the same bits; with a one-rank mesh the local output, bit for bit;
* ``elastic_mesh`` at 3 ranks.
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
from repro.core import calib as jcalib
from repro.core import quantease as jqe
from repro.core import solver as jsolver
from repro.dist import qgather as jqgather
from repro.dist.sharding import make_rules as jmake_rules
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro.quant import GridSpec as JSpec
from repro.quant import compute_grid as jgrid
from repro_torch.configs import get_config as tget
from repro_torch.core import quantease as tqe
from repro_torch.data import pipeline as tpipe
from repro_torch.quant import GridSpec as TSpec
from repro_torch.quant import compute_grid as tgrid
from tests._torch_cpu import one_torch_thread  # noqa: F401
from tests._torch_dist import ptq_rank, start_group
from tests.conftest import reduce_cfg
from tests.test_torch_cuda import midpoint_gap
from tests.test_torch_gptq import _check as gptq_check
from tests.test_torch_gptq import _run_port as gptq_run_port

ROOT = os.path.join(os.path.dirname(__file__), "..")
BITS, ITERATIONS = 3, 4
QE_ATOL = 2e-4  # tests/test_torch_quantease.py
GRAM_RTOL = 1e-6  # × max |Σ|
REPORT_ATOL = 1e-4  # tests/test_solver_stream.py's sharded-engine bound
QG_AXES = {"a": ("embed", "ffn"), "b": ("ffn", "embed"), "c": ("heads", None, "embed"),
           "n": (None,), "bf16": ("embed", None)}


def _case():
    r = np.random.default_rng(7)
    q, p = 13, 24  # q divisible by neither 2 nor 3: the pad runs
    x = r.standard_normal((6, 40, p)).astype(np.float32)
    w3 = r.standard_normal((2, q, p)).astype(np.float32)
    w3[r.random(w3.shape) < 0.01] *= 8.0
    s3 = np.stack([np.einsum("bsp,bsf->pf", x[:3], x[:3]), np.einsum("bsp,bsf->pf", x, x)])
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b")), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b")), dtype=torch.float32)
    jparams = jinit(jplan(jcfg, 1), jax.random.PRNGKey(3))
    calib_fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=tcfg.vocab, seed=0), tcfg, 3, 32,
                                      split="calib")
    return dict(
        gram_x=r.standard_normal((67, p)).astype(np.float32), tokens_x=x[:5],
        w3=w3, s3=s3.astype(np.float32), bits=BITS, iterations=ITERATIONS,
        qg_d=8, qg_axes=QG_AXES,
        qg_leaves={"a": r.standard_normal((8, 6)).astype(np.float32),
                   "b": r.standard_normal((6, 8)).astype(np.float32),
                   "c": r.standard_normal((4, 3, 8)).astype(np.float32),
                   "n": r.standard_normal(5).astype(np.float32)},
        qg_bf16=r.standard_normal((8, 5)).astype(np.float32),
        cfg=tcfg, jcfg=jcfg, params=jax.tree.map(np.asarray, jparams),
        calib=[calib_fn(i) for i in range(2)],
    )


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The case, the two groups started at once, and the reference's
    unsharded PTQ of the reduced model, run here while the ranks work."""
    case = _case()
    sent = {k: v for k, v in case.items() if k != "jcfg"}
    tmp = tmp_path_factory.mktemp("dist_ptq")
    groups = {n: start_group(ptq_rank, n, tmp, sent) for n in (2, 3)}
    try:
        _, case["report"] = jsolver.ptq_quantize_model(
            jplan(case["jcfg"], 1), jax.tree.map(jnp.asarray, case["params"]),
            [{"tokens": jnp.asarray(b["tokens"])} for b in case["calib"]],
            jsolver.PTQConfig(method="quantease", spec=JSpec(bits=4), iterations=ITERATIONS))
        yield case, groups
    finally:
        for g in groups.values():  # a group no test read is still collected
            g.close()


# One fixture per group: a rank that fails errors only the tests that read
# its group.
@pytest.fixture(scope="module")
def runs2(started):
    case, groups = started
    return case, {2: groups[2].result()}


@pytest.fixture(scope="module")
def runs3(started):
    case, groups = started
    return case, {3: groups[3].result()}


@pytest.fixture
def runs(request, world):
    return request.getfixturevalue(f"runs{world}")


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_gram_matches_the_reference(runs, world):
    case, out = runs
    x, xs = case["gram_x"], case["tokens_x"]
    want = np.asarray(jcalib.sharded_gram(jnp.asarray(x), None))
    want_tok = np.asarray(jcalib.CalibStats.zeros(x.shape[-1]).update_tokens(jnp.asarray(xs)).sigma)
    for key, ref in (("gram", want), ("update_tokens", want_tok)):
        got = [o[key] for o in out[world]]
        assert all(g.tobytes() == got[0].tobytes() for g in got), key
        np.testing.assert_allclose(got[0], ref, rtol=0, atol=GRAM_RTOL * np.abs(ref).max())


def test_sharded_gram_matches_the_references_two_device_gram(runs2, tmp_path):
    """The reference's own shard_map + psum on two forged JAX devices."""
    case, out = runs2
    np.save(tmp_path / "x.npy", case["gram_x"])
    code = (
        "import os; os.environ['XLA_FLAGS']='--xla_force_host_platform_device_count=2'\n"
        "import sys, numpy as np, jax, jax.numpy as jnp\n"
        "from repro.core.calib import sharded_gram\n"
        "from repro.launch.mesh import make_data_mesh\n"
        f"x = jnp.asarray(np.load({str(tmp_path / 'x.npy')!r}))\n"
        "mesh = make_data_mesh(2); assert mesh is not None\n"
        f"np.save({str(tmp_path / 'g.npy')!r}, np.asarray(sharded_gram(x, mesh)))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(tmp_path / "g.npy")
    np.testing.assert_allclose(out[2][0]["gram"], want, rtol=0,
                               atol=GRAM_RTOL * np.abs(want).max())


def _jax_solve(case, method, iterations=ITERATIONS):
    cfg = jsolver.PTQConfig(method=method, spec=JSpec(bits=BITS), iterations=iterations)
    return np.asarray(jsolver._solve_group(jnp.asarray(case["w3"]), jnp.asarray(case["s3"]),
                                           cfg, None)[0])


def _rank_blocks(w3, grid, world):
    """Each rank's padded row block, as the port's ``_shard_rows`` cuts it."""
    q = w3.shape[1]
    per = -(-q // world)
    pad = per * world - q
    w = np.pad(w3, ((0, 0), (0, pad), (0, 0)))
    sc = np.pad(grid.scale.numpy(), ((0, 0), (0, pad), (0, 0)), constant_values=1.0)
    ze = np.pad(grid.zero.numpy(), ((0, 0), (0, pad), (0, 0)))
    return [(slice(r * per, (r + 1) * per), w[:, r * per:(r + 1) * per],
             dataclasses.replace(grid, scale=torch.from_numpy(sc[:, r * per:(r + 1) * per]),
                                 zero=torch.from_numpy(ze[:, r * per:(r + 1) * per])))
            for r in range(world)]


def _qe_tie_rows(case, got, want, grid, world):
    """QuantEase rows whose codes differ; each must start at a verified
    rounding tie.  Both solves rerun one to ``ITERATIONS`` iterations (the
    port's on the rank's own padded row block, as the sharded solve ran
    it); at the first iteration and column where a row parts, its β from
    the port's iterates must lie within the fp32 bound of a midpoint
    (:func:`tests.test_torch_cuda.midpoint_gap`)."""
    w3, s3 = case["w3"], case["s3"]
    scale, zero = grid.scale.numpy()[..., 0], grid.zero.numpy()[..., 0]
    codes = lambda w: np.round(w / scale[..., None] + zero[..., None])
    rows = set(zip(*np.nonzero((codes(got) != codes(want)).any(-1))))
    if not rows:
        return rows
    kw = tqe.QuantEaseConfig(iterations=1).solve_kwargs()
    jg = jax.vmap(lambda wi: jgrid(wi, JSpec(bits=BITS)))(jnp.asarray(w3))
    jruns = [np.asarray(jqe.quantease_quantize(jnp.asarray(w3), jnp.asarray(s3), JSpec(bits=BITS),
                                               grid=jg, **dict(kw, iterations=i))[0])
             for i in range(1, ITERATIONS + 1)]
    truns = [np.zeros_like(w3) for _ in range(ITERATIONS)]
    for rows_r, w_r, g_r in _rank_blocks(w3, grid, world):
        for i in range(ITERATIONS):
            o = tqe.quantease_quantize(torch.from_numpy(w_r), torch.from_numpy(s3), TSpec(bits=BITS),
                                       grid=g_r, **dict(kw, iterations=i + 1))[0].numpy()
            keep = min(rows_r.stop, w3.shape[1]) - rows_r.start
            truns[i][:, rows_r.start:rows_r.start + keep] = o[:, :keep]
    for g, r in rows:
        assert np.array_equal(truns[-1][g, r], got[g, r]), (g, r)
        it = next(i for i in range(ITERATIONS)
                  if not np.allclose(truns[i][g, r], jruns[i][g, r], rtol=0, atol=1e-5))
        prev = truns[it - 1][g, r] if it else w3[g, r]
        j = int(np.argmax(np.abs(truns[it][g, r] - jruns[it][g, r]) > 1e-5))
        gap, tol = midpoint_gap(w3[g, r], s3[g], scale[g, r], zero[g, r], truns[it][g, r], prev, j)
        assert gap <= tol, (g, r, it, j, gap, tol)
    return rows


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("method", ["quantease", "gptq", "rtn"])
def test_row_sharded_solve_matches_the_unsharded_reference(runs, world, method):
    case, out = runs
    got = [o[method] for o in out[world]]
    assert all(g.tobytes() == got[0].tobytes() for g in got), "ranks differ"
    got = got[0]
    want = _jax_solve(case, method)
    w3 = case["w3"]
    grid = tgrid(torch.from_numpy(w3), TSpec(bits=BITS))
    if method == "rtn":
        np.testing.assert_array_equal(got, want)
    elif method == "gptq":
        pre = np.zeros_like(w3)
        for rows_r, w_r, g_r in _rank_blocks(w3, grid, world):
            _, pre_r = gptq_run_port(w_r, case["s3"], TSpec(bits=BITS), grid=g_r)
            keep = min(rows_r.stop, w3.shape[1]) - rows_r.start
            pre[:, rows_r.start:rows_r.start + keep] = pre_r[:, :keep, :w3.shape[-1]]
        gptq_check(w3, want, got, pre, grid)
    else:
        ties = _qe_tie_rows(case, got, want, grid, world)
        ok = np.ones(got.shape[:2], bool)
        for g, r in ties:
            ok[g, r] = False
        assert ok.mean() >= 0.9, ties
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=QE_ATOL)


@pytest.mark.parametrize("world", [2, 3])
def test_qe_outlier_under_a_mesh_is_the_local_solve(runs, world):
    assert all(o["qe_outlier_bitwise"] for o in runs[1][world])


def test_qgather_matches_the_reference(runs2):
    """Codes equal the reference's (its arithmetic: max |x| / 127 + 1e-12,
    round, clip); values within one ulp of the leaf's dtype of the
    reference's ``_gather_int8`` on one device (its constraints the
    identity there)."""
    case, out = runs2
    mesh = jax.make_mesh((1,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    rules = jmake_rules(mesh, d_model=case["qg_d"], fsdp=True)
    leaves = {k: jnp.asarray(v) for k, v in case["qg_leaves"].items()}
    leaves["bf16"] = jnp.asarray(case["qg_bf16"]).astype(jnp.bfloat16)
    want = jqgather.make_period_transform(QG_AXES, rules, jmake_rules(mesh))(leaves)
    for o in out[2]:
        assert o["qgather_dtypes"] == {"a": "torch.float32", "b": "torch.float32",
                                       "c": "torch.float32", "n": "torch.float32",
                                       "bf16": "torch.bfloat16"}
        for k, w in want.items():
            w = np.asarray(w.astype(jnp.float32))
            ulp = np.spacing(np.abs(w).astype(np.float32))
            if k == "bf16":
                ulp = ulp * 2.0 ** 16
            assert np.all(np.abs(o["qgather"][k] - w) <= ulp), k
    for k, leaf in leaves.items():
        if leaf.ndim < 2:
            continue
        x32 = leaf.astype(jnp.float32)
        scale = jnp.max(jnp.abs(x32), axis=tuple(range(1, leaf.ndim)), keepdims=True) / 127.0 + 1e-12
        jcodes = np.asarray(jnp.clip(jnp.round(x32 / scale), -127, 127).astype(jnp.int8))
        parts = [o["qgather_codes"][k] for o in out[2]]
        dim = parts[0][2]
        tcodes = parts[0][0] if dim is None else np.concatenate([c for c, _, _ in parts], dim)
        np.testing.assert_array_equal(tcodes, jcodes, err_msg=k)


def test_sharded_ptq_report_matches_the_unsharded_reference(runs2):
    case, out = runs2
    want = case["report"]
    r0, r1 = out[2]
    assert list(r0["report"]) == list(want) and r0["report"] == r1["report"]
    for k, v in want.items():
        assert abs(r0["report"][k] - float(v)) < REPORT_ATOL, k
    n_blocks = case["cfg"].n_periods * len(case["cfg"].pattern)
    assert len(r0["records"]) == n_blocks and r1["records"] == []
    assert r0["ptq_bits"] == r1["ptq_bits"]
    assert r0["one_rank_bitwise"] is True


def test_elastic_mesh_at_three_ranks(runs3):
    for rank, o in enumerate(runs3[1][3]):
        shape, names, ranks, coord, refused = o["elastic"]
        assert shape == (1, 2) and names == ("data", "model") and ranks == [[0, 1]]
        assert coord == ([0, rank] if rank < 2 else None)
        assert refused == "3 device(s) cannot host model_axis=4"
