"""The port's zero-shot tasks, eval harness and parity bridge against the
reference's, on the same inputs.

A reduced fp32 Phi-3 (params carried across with ``repro_torch.interop``)
and the synthetic corpus' eval stream.  Tolerances: ``next_token_logits``
within 1e-4 of max |logit|; ``build_choice_items`` equal; cloze hit counts
equal, a gold rank differing only where the gold logit lies within 1e-5
relative of another logit; ``continuation_choice`` picks equal, margin
1e-4 relative; ``eval_model`` under ``EvalBudget.smoke()`` 1e-4 relative,
metric by metric; ``run_grid`` (rtn@4, gptq@4, quantease@3 at 2
iterations) perplexity and mean layer error 1e-4 relative, row by row;
``engine_parity`` / ``quantized_parity`` on the port's engines within the
document's ``tol``, paged against contiguous within 2 % of max |logit|;
the reference's ``validate_doc`` tests on the port's copy.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import pipeline as jpipe
from repro.eval import harness as jharness
from repro.eval import scorer as jscorer
from repro.eval import tasks as jtasks
from repro.models import init_params as jinit
from repro.models import make_plan as jplan
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.data import pipeline as tpipe
from repro_torch.eval import harness as tharness
from repro_torch.eval import scorer as tscorer
from repro_torch.eval import tasks as ttasks
from repro_torch.eval.harness import EvalBudget, validate_doc
from repro_torch.models import model as tmodel
from tests.conftest import reduce_cfg
from tests._torch_cpu import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = "cpu"


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(reduce_cfg(jget("phi3_mini_3_8b")), dtype=jnp.float32)
    tcfg = dataclasses.replace(reduce_cfg(tget("phi3_mini_3_8b")), dtype=torch.float32)
    jp, tp = jplan(jcfg, 1), tmodel.make_plan(tcfg)
    jparams = jinit(jp, jax.random.PRNGKey(0))
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, jparams), device=CPU)
    j_eval, _ = jpipe.make_batch_fn(jpipe.DataConfig(vocab=jcfg.vocab), jcfg, 2, 48, split="eval")
    t_eval, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=tcfg.vocab), tcfg, 2, 48, split="eval")
    calib_fn, _ = tpipe.make_batch_fn(tpipe.DataConfig(vocab=tcfg.vocab), tcfg, 2, 48, split="calib")
    calib = [calib_fn(0)]
    return dict(jp=jp, tp=tp, jparams=jparams, tparams=tparams, j_eval=j_eval, t_eval=t_eval,
                t_calib=calib, j_calib=[{"tokens": jnp.asarray(b["tokens"])} for b in calib])


def _prompts(seed, lens):
    r = np.random.default_rng(seed)
    return [r.integers(0, 250, n).astype(np.int32) for n in lens]


def test_next_token_logits_match(setup):
    s = setup
    for prompt in _prompts(1, (5, 13, 29)):
        j = jscorer.next_token_logits(s["jp"], s["jparams"], prompt)
        t = tscorer.next_token_logits(s["tp"], s["tparams"], prompt, device=CPU)
        assert t.dtype == np.float32 and t.shape == j.shape
        assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max()


def test_build_choice_items_equal(setup):
    kw = dict(n_items=6, n_choices=4, prompt_len=16, cont_len=8, step0=2, seed=5)
    jt, jg = jtasks.build_choice_items(setup["j_eval"], **kw)
    tt, tg = ttasks.build_choice_items(setup["t_eval"], **kw)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tg, jg)
    assert tt.dtype == jt.dtype and tg.dtype == jg.dtype


def _port_logits(s, tokens):
    """(B, S-1, V) fp32 logits of the port's teacher-forced pass."""
    with torch.no_grad():
        x = tmodel.hidden_states(s["tp"], s["tparams"], torch.as_tensor(tokens).long())[:, :-1]
        return tmodel._head_logits(x, tmodel._logit_head(s["tp"], s["tparams"])).numpy()


def test_cloze_hits_match(setup):
    s = setup
    j = jtasks.cloze_accuracy(s["jp"], s["jparams"], s["j_eval"], n_batches=2, ks=(1, 5))
    t = ttasks.cloze_accuracy(s["tp"], s["tparams"], s["t_eval"], n_batches=2, ks=(1, 5),
                              device=CPU)
    assert t == j
    for step in range(2):
        tokens = s["t_eval"](step)["tokens"]
        _, jr = jscorer.make_scorer(s["jp"])(s["jparams"], jnp.asarray(tokens))
        _, tr = tscorer.make_scorer(s["tp"], device=CPU)(s["tparams"], tokens)
        jr, tr = np.asarray(jr), tr.numpy()
        if np.array_equal(jr, tr):
            continue
        logits = _port_logits(s, tokens)
        for b, i in zip(*np.nonzero(jr != tr)):
            row, gold = logits[b, i], logits[b, i, tokens[b, i + 1]]
            others = np.delete(row, tokens[b, i + 1])
            assert np.abs(others - gold).min() <= 1e-5 * abs(gold), (b, i)


def test_continuation_choice_matches(setup):
    s = setup
    kw = dict(n_items=8, prompt_len=16, cont_len=8, step0=1)
    j = jtasks.continuation_choice(s["jp"], s["jparams"], s["j_eval"], **kw)
    t = ttasks.continuation_choice(s["tp"], s["tparams"], s["t_eval"], device=CPU, **kw)
    assert t["acc"] == j["acc"] and t["n_items"] == j["n_items"]
    assert t["margin"] == pytest.approx(j["margin"], rel=1e-4)
    # The picks themselves, item by item.
    tokens, _ = ttasks.build_choice_items(s["t_eval"], n_items=8, prompt_len=16, cont_len=8,
                                          step0=1)
    flat = tokens.reshape(-1, tokens.shape[-1])
    jl = np.asarray(jscorer.make_scorer(s["jp"])(s["jparams"], jnp.asarray(flat))[0])
    tl = tscorer.make_scorer(s["tp"], device=CPU)(s["tparams"], flat)[0].numpy()
    pick = lambda lp: lp[:, 15:23].sum(-1).reshape(8, 4).argmax(-1)
    np.testing.assert_array_equal(pick(tl), pick(jl))


def test_eval_model_smoke_matches(setup):
    s = setup
    j = jharness.eval_model(s["jp"], s["jparams"], s["j_eval"], budget=jharness.EvalBudget.smoke())
    t = tharness.eval_model(s["tp"], s["tparams"], s["t_eval"], budget=EvalBudget.smoke(),
                            device=CPU)
    assert set(t) == set(j)
    for k, v in j.items():
        assert t[k] == pytest.approx(v, rel=1e-4), k


def test_run_grid_smoke_matches(setup):
    s = setup
    cells = [{"method": "rtn", "bits": 4}, {"method": "gptq", "bits": 4},
             {"method": "quantease", "bits": 3, "iterations": 2}]
    j = jharness.run_grid(s["jp"], s["jparams"], s["j_calib"], s["j_eval"], cells,
                          iterations=2, budget=jharness.EvalBudget.smoke())
    seen = []
    t = tharness.run_grid(s["tp"], s["tparams"], s["t_calib"], s["t_eval"], cells,
                          iterations=2, budget=EvalBudget.smoke(), progress_cb=seen.append,
                          device=CPU)
    assert [r["cell"] for r in seen] == ["dense", "rtn@4", "gptq@4", "quantease@3"]
    assert t["dense"]["ppl"] == pytest.approx(j["dense"]["ppl"], rel=1e-4)
    assert len(t["grid"]) == len(j["grid"]) == 3
    for tr, jr in zip(t["grid"], j["grid"]):
        assert set(tr) == set(jr)
        assert (tr["method"], tr["bits"]) == (jr["method"], jr["bits"])
        assert tr["ppl"] == pytest.approx(jr["ppl"], rel=1e-4), tr["method"]
        assert tr["mean_layer_err"] == pytest.approx(jr["mean_layer_err"], rel=1e-4), tr["method"]


def test_engine_parity_dense(setup):
    s = setup
    par = tharness.engine_parity(s["tp"], s["tparams"], _prompts(2, (5, 17, 26)), max_seq=64,
                                 page_size=8, prefill_chunk=8, device=CPU)
    assert par["n_prompts"] == 3
    assert par["max_abs_diff_contiguous"] <= par["tol"]
    assert par["max_abs_diff_paged"] <= par["tol"]
    # The paged engine prefills in chunks over bf16 pages and decodes through
    # the paged attention, the contiguous one prefills over the whole prompt:
    # close (2 % of max |logit|, the serving checks' tolerance), not bitwise.
    assert par["max_abs_diff_paged_contiguous"] <= 2e-2 * par["max_abs_logit"]


def test_quantized_parity(setup):
    s = setup
    par = tharness.quantized_parity(s["tp"], s["tparams"], s["t_calib"], _prompts(3, (7, 19)),
                                    iterations=2, max_seq=64, page_size=8, prefill_chunk=8,
                                    device=CPU)
    assert par["cell"] == "quantease@4"
    assert par["max_abs_diff_contiguous"] <= par["tol"]
    assert par["max_abs_diff_paged"] <= par["tol"]
    doc = {"schema": 1, "smoke": True, "dense": {"ppl": 1.0}, "parity": par,
           "grid": [{k: 0 for k in jharness._GRID_KEYS}]}
    assert par["max_abs_diff_paged_contiguous"] <= 2e-2 * par["max_abs_logit"]
    assert set(validate_doc(doc)) <= {"parity: paged != contiguous bitwise"}
    # Through the reference's tile prepack (its TPU bytes), un-prepacked
    # again before serving: the same parity, with the layouts recorded.
    tile = tharness.quantized_parity(s["tp"], s["tparams"], s["t_calib"], _prompts(3, (7, 19)),
                                     iterations=2, max_seq=64, page_size=8, prefill_chunk=8,
                                     prepack_backend="tpu", device=CPU)
    assert tile["pack_layouts"] and all(lb.startswith("tile") for lb in tile["pack_layouts"])
    for k in ("max_abs_diff_contiguous", "max_abs_diff_paged", "max_abs_diff_paged_contiguous"):
        assert tile[k] == par[k]


# ---------------------------------------------------------------------------
# Schema validation: the reference's tests on the port's copy
# ---------------------------------------------------------------------------


def _min_doc(smoke=True):
    row = {
        "method": "rtn", "bits": 4, "outlier_frac": None, "group_size": None,
        "mean_layer_err": 0.01, "ppl": 10.0, "nll": 2.3, "top1": 0.5,
        "top5": 0.9, "choice_acc": 0.5, "choice_margin": 1.0,
    }
    return {
        "schema": 1, "smoke": smoke, "dense": {"ppl": 9.0},
        "grid": [row],
        "parity": {
            "n_prompts": 3, "max_abs_diff_contiguous": 0.001,
            "max_abs_diff_paged": 0.001, "paged_bitwise_contiguous": True,
            "tol": 0.05,
        },
    }


def test_validate_doc_accepts_minimal_smoke():
    assert validate_doc(_min_doc()) == []


def test_validate_doc_flags_problems():
    doc = _min_doc()
    doc["schema"] = 99
    del doc["grid"][0]["ppl"]
    doc["parity"]["max_abs_diff_paged"] = 1.0
    probs = validate_doc(doc)
    assert any("schema" in p for p in probs)
    assert any("grid[0]" in p for p in probs)
    assert any("paged diff" in p for p in probs)


def test_validate_doc_full_run_orderings():
    doc = _min_doc(smoke=False)

    def row(method, bits, ppl):
        r = dict(doc["grid"][0])
        r.update(method=method, bits=bits, ppl=ppl)
        return r

    doc["grid"] = [
        row("rtn", 4, 10.2), row("gptq", 4, 10.1), row("quantease", 4, 10.0),
        row("rtn", 3, 14.0), row("gptq", 3, 12.0), row("quantease", 3, 11.0),
        row("qe_outlier", 3, 10.5),
    ]
    assert validate_doc(doc) == []
    doc["grid"][5]["ppl"] = 13.0  # quantease@3 > gptq@3 → ordering violated
    assert any("ordering violated at 3 bits" in p for p in validate_doc(doc))
    doc["grid"][5]["ppl"] = 11.0
    doc["grid"][6]["ppl"] = 11.5  # outlier not better than plain
    assert any("outlier" in p for p in validate_doc(doc))


@pytest.mark.parametrize("name", ["BENCH_eval.json", "BENCH_port_eval.json"])
def test_validate_doc_agrees_with_reference_on_committed_docs(name):
    path = os.path.join(ROOT, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} is not committed")
    with open(path) as f:
        doc = json.load(f)
    assert validate_doc(doc) == jharness.validate_doc(doc)
