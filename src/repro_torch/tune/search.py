"""The tuning loop: probe → allocate → quantize → score.

Candidate per-layer allocations (:mod:`.allocate`, fed by the probes of
:mod:`.sensitivity`) are quantized by the whole-model PTQ driver with
``PTQConfig.layer_specs`` overrides, restacked into the serving layout
(``serve.qparams.quantize_params_for_serving``: mixed bits harmonized), and
scored by the eval scorer's perplexity on the eval stream, through the
dequant-GEMM on the card.  The uniform allocation at the budget's width is
always candidate 0, so the winner is never worse than uniform quantization
at the same average bits.

Evaluation resumes per candidate: ``prior_results`` are the candidates a
previous run finished, ``result_cb`` persists each new one as it lands
(``launch/tune.py`` writes ``progress.jsonl`` records and wraps the loop in
``dist.elastic.RetryingRunner``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.tune.allocate import AllocConfig, Allocation, allocate, allocation_layer_specs
from repro_torch.tune.sensitivity import probe_layer_stats

__all__ = ["TuneConfig", "tune_model", "build_candidates", "quantize_candidate",
           "evaluate_candidate"]


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    budget_avg_bits: float = 3.0
    bits_candidates: tuple = (2, 3, 4, 8)
    outlier_frac_candidates: tuple = ()  # e.g. (0.01,)
    policies: tuple = ("sensitivity", "error")
    method: str = "quantease"  # the candidates' CD method
    iterations: int = 10  # the candidates' CD iterations
    awq_prepass: bool = False  # AWQ's scaling first (awq_qe)
    group_size: Optional[int] = None
    percdamp: float = 0.01
    n_ppl_batches: int = 2  # eval batches scored per candidate
    chunk: int = 64  # scorer head chunk
    probe_outlier_iterations: int = 4

    def uniform_bits(self) -> int:
        """The widest candidate within the budget: the uniform baseline at
        the same average bits."""
        fits = [b for b in self.bits_candidates if b <= self.budget_avg_bits + 1e-9]
        if not fits:
            raise ValueError(f"budget {self.budget_avg_bits} below every candidate width")
        return max(fits)


def build_candidates(stats: dict, tcfg: TuneConfig) -> list:
    """The candidates in a fixed order (the index is the resume position);
    candidate 0 is the uniform baseline."""
    cands = [{"label": f"uniform@{tcfg.uniform_bits()}b", "kind": "uniform",
              "bits": tcfg.uniform_bits()}]
    for policy in tcfg.policies:
        acfg = AllocConfig(budget_avg_bits=tcfg.budget_avg_bits,
                           bits_candidates=tcfg.bits_candidates,
                           outlier_frac_candidates=tcfg.outlier_frac_candidates, policy=policy)
        cands.append({"label": f"greedy-{policy}", "kind": "mixed",
                      "allocation": allocate(stats, acfg)})
    return cands


def quantize_candidate(plan, params, calib, cand: dict, tcfg: TuneConfig, *, device="cuda"):
    """PTQ of one candidate → ``(serving params, layer error report)``."""
    from repro_torch.core.solver import PTQConfig, ptq_quantize_model
    from repro_torch.quant import GridSpec
    from repro_torch.serve.qparams import quantize_params_for_serving

    method = "awq_qe" if tcfg.awq_prepass else tcfg.method
    bits = cand["bits"] if cand["kind"] == "uniform" else tcfg.uniform_bits()
    specs = (None if cand["kind"] == "uniform"
             else allocation_layer_specs(cand["allocation"], base_method=method))
    cfg = PTQConfig(method=method, spec=GridSpec(bits=bits, group_size=tcfg.group_size),
                    iterations=tcfg.iterations, percdamp=tcfg.percdamp, emit="qt",
                    layer_specs=specs)
    qp, rep = ptq_quantize_model(plan, params, calib, cfg, device=device)
    return quantize_params_for_serving(plan, params, qp["dec"], device=device), rep


def _candidate_avg_bits(cand: dict) -> float:
    return float(cand["bits"]) if cand["kind"] == "uniform" else cand["allocation"].avg_bits


def evaluate_candidate(plan, params, calib, batch_fn, cand: dict, tcfg: TuneConfig, *,
                       scorer=None, device="cuda") -> dict:
    """Quantize one candidate and score its serving artifact's perplexity."""
    from repro_torch.eval.scorer import make_scorer, perplexity_on_stream

    qp, rep = quantize_candidate(plan, params, calib, cand, tcfg, device=device)
    scorer = scorer if scorer is not None else make_scorer(plan, chunk=tcfg.chunk, device=device)
    out = perplexity_on_stream(plan, qp, batch_fn, n_batches=tcfg.n_ppl_batches, scorer=scorer,
                               device=device)
    res = {
        "label": cand["label"],
        "kind": cand["kind"],
        "avg_bits": round(_candidate_avg_bits(cand), 4),
        "ppl": float(out["ppl"]),
        "nll": float(out["nll"]),
        "mean_layer_err": float(np.mean(list(rep.values()))),
    }
    if cand["kind"] == "mixed":
        alloc: Allocation = cand["allocation"]
        hist: dict[int, int] = {}
        for b in alloc.bits.values():
            hist[b] = hist.get(b, 0) + 1
        res["bits_histogram"] = {str(k): v for k, v in sorted(hist.items())}
        res["n_outlier_layers"] = len(alloc.outlier_frac)
        res["n_upgrades"] = alloc.n_upgrades
    return res


def tune_model(plan, params, calib: list, batch_fn, tcfg: TuneConfig, *,
               stats: Optional[dict] = None, prior_results: Optional[list] = None,
               result_cb: Optional[Callable[[dict], None]] = None,
               runner_factory: Optional[Callable] = None,
               progress_cb: Optional[Callable[[dict], None]] = None, device="cuda") -> dict:
    """The whole loop; returns the tuning document (the reference's
    ``bench_tune`` schema).

    ``stats``: probe stats computed before (skips the probes);
    ``prior_results``: candidates a previous run finished, evaluation goes
    on after them; ``result_cb`` fires once per newly evaluated candidate;
    ``runner_factory(step_fn, restore_fn)`` may wrap the candidate loop in a
    crash-recovery runner (``dist.elastic.RetryingRunner``'s signature)."""
    from repro_torch.eval.scorer import make_scorer

    if stats is None:
        stats = probe_layer_stats(
            plan, params, calib, bits_candidates=tcfg.bits_candidates,
            outlier_cells=tuple((tcfg.bits_candidates[0], f) for f in tcfg.outlier_frac_candidates),
            outlier_iterations=tcfg.probe_outlier_iterations, progress_cb=progress_cb,
            device=device)
    cands = build_candidates(stats, tcfg)
    results = list(prior_results or [])
    start = len(results)
    scorer = make_scorer(plan, chunk=tcfg.chunk, device=device)

    def step_fn(state, i):
        res = evaluate_candidate(plan, params, calib, batch_fn, cands[i], tcfg, scorer=scorer,
                                 device=device)
        state.append(res)
        if result_cb:
            result_cb(res)
        if progress_cb:
            progress_cb({"candidate": res["label"], "ppl": res["ppl"]})
        return state

    if runner_factory is not None:
        # A crash mid-candidate persisted nothing of it: retry it.
        runner = runner_factory(step_fn, lambda: (results, len(results)))
        results, _ = runner.run(results, start, len(cands) - start)
    else:
        for i in range(start, len(cands)):
            results = step_fn(results, i)

    uniform = next(r for r in results if r["kind"] == "uniform")
    best = min(results, key=lambda r: (r["ppl"], r["label"]))
    return {
        "budget_avg_bits": tcfg.budget_avg_bits,
        "bits_candidates": list(tcfg.bits_candidates),
        "outlier_frac_candidates": list(tcfg.outlier_frac_candidates),
        "method": "awq_qe" if tcfg.awq_prepass else tcfg.method,
        "iterations": tcfg.iterations,
        "n_layers": len(stats),
        "candidates": results,
        "uniform": uniform,
        "best": best,
    }
