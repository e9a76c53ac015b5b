"""Eval grid harness: method × bits × outlier sweep, parity bridge, schema.

Drives the paper's table shape end to end: quantize the model with each
(method, bits[, outlier budget]) cell through the whole-model PTQ entry point
(:mod:`repro_torch.core.solver`), restack the ``emit="qt"`` artifact into
the serving layout (:mod:`repro_torch.serve.qparams`) and score perplexity
and task accuracy on the ``split="eval"`` stream: the QuantizedTensor bytes
the serving engines execute.  :func:`validate_doc` is the schema guard, with
the reference's keys and checks; on full (non-smoke) documents it also
asserts the paper's orderings: QuantEase ≤ GPTQ ≤ RTN perplexity at 3 and 4
bits, outlier-aware 3-bit < plain 3-bit.

The **parity bridge** (:func:`engine_parity`) ties the scorer to serving:
for each prompt it compares the scorer's prefill-path next-token logits
with both engines' first decode logits on the same params.  The engines'
first decode replays the last prompt token through the decode path, whose
KV bytes differ from the prefill path's by about one bf16 ulp, so scorer
and engines agree to ~1e-2 absolute on O(10) logits (``tol`` 0.05).
Beside the reference's keys the port records the paged-vs-contiguous
difference itself and the contiguous run's max |logit|: on the card the
paged engine's attention kernel keeps p in fp32 where the contiguous path
rounds it to bf16, so the two are close, not bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.eval.scorer import make_scorer, next_token_logits, perplexity_on_stream
from repro_torch.eval.tasks import continuation_choice

__all__ = [
    "EVAL_SCHEMA",
    "EvalBudget",
    "eval_model",
    "run_grid",
    "engine_parity",
    "quantized_parity",
    "validate_doc",
]

EVAL_SCHEMA = 1

_GRID_KEYS = {
    "method", "bits", "outlier_frac", "group_size", "mean_layer_err",
    "ppl", "nll", "top1", "top5", "choice_acc", "choice_margin",
}
_PARITY_KEYS = {
    "n_prompts", "max_abs_diff_contiguous", "max_abs_diff_paged",
    "paged_bitwise_contiguous", "tol",
}


@dataclasses.dataclass(frozen=True)
class EvalBudget:
    """How much eval to run per cell (smoke shrinks everything)."""

    n_ppl_batches: int = 4
    n_choice_items: int = 32
    choice_prompt_len: int = 32
    choice_cont_len: int = 8
    chunk: int = 128

    @classmethod
    def smoke(cls) -> "EvalBudget":
        return cls(
            n_ppl_batches=1, n_choice_items=8,
            choice_prompt_len=8, choice_cont_len=4, chunk=32,
        )


def eval_model(plan, params, batch_fn, *, budget: EvalBudget, scorer=None,
               device="cuda") -> dict:
    """All metrics for one parameter tree on the eval stream.

    Top-1/top-5 come from the perplexity pass itself (the scorer emits gold
    ranks beside log-probabilities); the choice items read the eval steps
    after it."""
    scorer = scorer if scorer is not None else make_scorer(plan, chunk=budget.chunk, device=device)
    out = perplexity_on_stream(
        plan, params, batch_fn, n_batches=budget.n_ppl_batches, scorer=scorer, device=device
    )
    choice = continuation_choice(
        plan, params, batch_fn,
        n_items=budget.n_choice_items,
        prompt_len=budget.choice_prompt_len,
        cont_len=budget.choice_cont_len,
        step0=budget.n_ppl_batches,  # fresh eval steps, still split="eval"
        scorer=scorer,
        device=device,
    )
    out["choice_acc"] = choice["acc"]
    out["choice_margin"] = choice["margin"]
    return out


def _quantize_cell(plan, params, calib, cell: dict, *, iterations: int, emit: str,
                   device="cuda"):
    """One PTQ run for a grid cell; returns (scored params, mean layer error)."""
    from repro_torch.core.solver import PTQConfig, ptq_quantize_model
    from repro_torch.quant import GridSpec

    frac = cell.get("outlier_frac")
    cfg = PTQConfig(
        method=cell["method"],
        spec=GridSpec(bits=cell["bits"], group_size=cell.get("group_size")),
        iterations=cell.get("iterations", iterations),
        outlier_frac=0.01 if frac is None else frac,
        emit=emit,
    )
    qp, rep = ptq_quantize_model(plan, params, calib, cfg, device=device)
    if emit == "qt":
        from repro_torch.serve.qparams import quantize_params_for_serving

        qp = quantize_params_for_serving(plan, params, qp["dec"], device=device)
    return qp, float(np.mean(list(rep.values())))


def _rounded(metrics: dict) -> dict:
    return {k: (round(v, 6) if isinstance(v, float) else v) for k, v in metrics.items()}


def run_grid(
    plan,
    params,
    calib: list,
    batch_fn,
    cells: list,
    *,
    iterations: int = 20,
    emit: str = "qt",
    budget: Optional[EvalBudget] = None,
    progress_cb=None,
    device="cuda",
) -> dict:
    """Evaluate the dense params and every quantized cell; returns the doc
    body ``{"dense": {...}, "grid": [row, ...]}``.

    ``cells``: list of ``{"method", "bits"[, "outlier_frac", "group_size",
    "iterations"]}``.  ``emit="qt"`` (default) scores the restacked
    QuantizedTensor serving artifact, ``emit="fake"`` the dequantized
    weights.  The params must live on ``device`` (default ``"cuda"``).
    """
    budget = budget or EvalBudget()
    scorer = make_scorer(plan, chunk=budget.chunk, device=device)
    dense = _rounded(eval_model(plan, params, batch_fn, budget=budget, scorer=scorer,
                                device=device))
    if progress_cb:
        progress_cb({"cell": "dense", **dense})
    rows = []
    for cell in cells:
        qp, err = _quantize_cell(plan, params, calib, cell, iterations=iterations, emit=emit,
                                 device=device)
        row = {
            "method": cell["method"],
            "bits": cell["bits"],
            "outlier_frac": cell.get("outlier_frac"),
            "group_size": cell.get("group_size"),
            "mean_layer_err": round(err, 6),
        }
        row.update(_rounded(eval_model(plan, qp, batch_fn, budget=budget, scorer=scorer,
                                       device=device)))
        rows.append(row)
        if progress_cb:
            progress_cb({"cell": f"{cell['method']}@{cell['bits']}", **row})
    return {"dense": dense, "grid": rows}


def engine_parity(
    plan,
    params,
    prompts: list,
    *,
    max_seq: int = 128,
    page_size: int = 16,
    prefill_chunk: int = 32,
    max_batch: int = 4,
    device="cuda",
) -> dict:
    """Scorer-vs-serving logit parity on the same params.

    For each prompt: the scorer's prefill-path next-token logits
    (:func:`~repro_torch.eval.scorer.next_token_logits`) against both
    engines' first decode logits (``record_logits=True``).  Returns the
    reference's keys (max abs differences, whether paged matched contiguous
    bitwise, ``tol``) and, beside them, ``max_abs_diff_paged_contiguous``
    and ``max_abs_logit`` (of the contiguous engine's first logits)."""
    from repro_torch.serve.engine import PagedServingEngine, Request, ServingEngine

    ref = {i: next_token_logits(plan, params, p, device=device) for i, p in enumerate(prompts)}

    def first_logits(eng):
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=1))
        eng.run()
        return {rid: tr[0] for rid, tr in eng.logit_trace.items()}

    contig = first_logits(
        ServingEngine(plan, params, max_batch=max_batch, max_seq=max_seq,
                      prefill_pad=prefill_chunk, record_logits=True, device=device)
    )
    paged = first_logits(
        PagedServingEngine(plan, params, max_batch=max_batch, max_seq=max_seq,
                           page_size=page_size, prefill_chunk=prefill_chunk,
                           record_logits=True, device=device)
    )
    ids = range(len(prompts))
    d_contig = max(float(np.abs(ref[i] - contig[i]).max()) for i in ids)
    d_paged = max(float(np.abs(ref[i] - paged[i]).max()) for i in ids)
    d_pc = max(float(np.abs(paged[i] - contig[i]).max()) for i in ids)
    bitwise = all(np.array_equal(contig[i], paged[i]) for i in ids)
    return {
        "n_prompts": len(prompts),
        "max_abs_diff_contiguous": round(d_contig, 6),
        "max_abs_diff_paged": round(d_paged, 6),
        "paged_bitwise_contiguous": bool(bitwise),
        "tol": 0.05,
        "max_abs_diff_paged_contiguous": round(d_pc, 6),
        "max_abs_logit": round(max(float(np.abs(contig[i]).max()) for i in ids), 6),
    }


def quantized_parity(
    plan, params, calib, prompts, *, cell=None, iterations: int = 6,
    prepack_backend=None, device="cuda", **kw
) -> dict:
    """Quantize one grid cell (default: quantease 4-bit, ``emit="qt"``) and
    run :func:`engine_parity` on the resulting serving artifact, so the
    quality numbers describe the bytes serving executes.

    ``prepack_backend`` pushes the artifact through
    :func:`repro_torch.serve.qparams.prepack_params_for_serving` for that
    backend first and records the layouts chosen (``pack_layouts``); with
    ``"tpu"`` the leaves are prepacked tile-native, the reference's bytes,
    and un-prepacked again (an exact permutation) before the engines run
    them, so the parity holds on the bytes the reference would serve."""
    cell = cell or {"method": "quantease", "bits": 4}
    qp, _ = _quantize_cell(plan, params, calib, cell, iterations=iterations, emit="qt",
                           device=device)
    out = {}
    if prepack_backend is not None:
        from repro_torch.quant import as_linear_layout
        from repro_torch.serve.qparams import prepack_params_for_serving

        qp, decisions = prepack_params_for_serving(plan, qp, backend=prepack_backend)
        out["pack_layouts"] = sorted(set(decisions.values()))
        qp = as_linear_layout(qp)
    out.update(engine_parity(plan, qp, prompts, device=device, **kw))
    out["cell"] = f"{cell['method']}@{cell['bits']}"
    return out


def _ppl(doc, method, bits):
    for row in doc.get("grid", []):
        if row.get("method") == method and row.get("bits") == bits:
            return row.get("ppl")
    return None


def validate_doc(doc: dict) -> list:
    """Schema (and, for full runs, ordering) problems; empty ⇒ valid."""
    probs = []
    if doc.get("schema") != EVAL_SCHEMA:
        probs.append(f"schema != {EVAL_SCHEMA}")
    if not isinstance(doc.get("dense"), dict) or "ppl" not in doc.get("dense", {}):
        probs.append("dense: missing/incomplete")
    rows = doc.get("grid")
    if not isinstance(rows, list) or not rows:
        probs.append("grid: missing/empty")
        return probs
    for i, row in enumerate(rows):
        missing = _GRID_KEYS - set(row)
        if missing:
            probs.append(f"grid[{i}]: missing keys {sorted(missing)}")
    par = doc.get("parity")
    if not isinstance(par, dict) or _PARITY_KEYS - set(par):
        probs.append("parity: missing/incomplete")
    else:
        if par["max_abs_diff_contiguous"] > par["tol"]:
            probs.append("parity: contiguous diff exceeds tol")
        if par["max_abs_diff_paged"] > par["tol"]:
            probs.append("parity: paged diff exceeds tol")
        if not par["paged_bitwise_contiguous"]:
            probs.append("parity: paged != contiguous bitwise")
    if not doc.get("smoke"):
        # Full runs must reproduce the paper's orderings.
        for bits in (3, 4):
            qe, g, r = (_ppl(doc, m, bits) for m in ("quantease", "gptq", "rtn"))
            if None in (qe, g, r):
                probs.append(f"grid: missing method row at {bits} bits")
            elif not (qe <= g <= r):
                probs.append(
                    f"ordering violated at {bits} bits: "
                    f"quantease={qe} gptq={g} rtn={r}"
                )
        qe3, out3 = _ppl(doc, "quantease", 3), _ppl(doc, "qe_outlier", 3)
        if out3 is None:
            probs.append("grid: missing qe_outlier 3-bit row")
        elif qe3 is not None and not (out3 < qe3):
            probs.append(f"outlier 3-bit ({out3}) not better than plain ({qe3})")
    return probs
