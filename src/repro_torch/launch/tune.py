"""Tuning launcher: a budgeted mixed-precision search over a checkpoint (the
port's ``repro.launch.tune``).

Drives :func:`repro_torch.tune.tune_model`: probe per-layer sensitivity
(errors at every candidate width and λ_max(Σ)), build the greedy budgeted
allocations beside the uniform baseline at the same average bits, quantize
every candidate with per-layer ``layer_specs``, and score each one's
restacked serving artifact on the eval split.  The winner (lowest
perplexity; never worse than uniform, candidate 0) is quantized once more
and saved as a checkpoint of serving params, its QuantizedTensor layout in
``meta["qt_layout"]`` (``launch.serve`` reads it), beside ``tune.json``.

Resume: each finished candidate appends a ``{"candidate": ...}`` record to
``<out-dir>/progress.jsonl`` (probe passes log ``{"probe": ...}`` records);
``--resume`` replays the candidate records as prior results and goes on
with the next candidate (the probes rerun: they are RTN passes).  A torn
last line is tolerated.  In process, ``dist.elastic.RetryingRunner`` wraps
the candidate loop: a failed candidate rolls back to the persisted results
and is retried.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3_mini_3_8b --reduce \\
        --steps 20 --device cpu --ckpt-dir /tmp/rt_train
    PYTHONPATH=src python -m repro_torch.launch.tune --arch phi3_mini_3_8b --reduce \\
        --ckpt-dir /tmp/rt_train --budget-avg-bits 3 --bits-candidates 2,3,4 \\
        --iterations 4 --device cpu --out-dir /tmp/rt_tune
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.launch.common import add_device_flag, device_of, fault_plan_of

__all__ = ["main"]


def main(argv=None) -> dict:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description="Accuracy-driven per-layer mixed-precision tuning.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true",
                    help="CPU-sized config (same reduction as launch/train.py)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "repro_torch_train"))
    ap.add_argument("--out-dir", default=os.path.join(tmp, "repro_torch_tune"))
    ap.add_argument("--budget-avg-bits", type=float, default=3.0,
                    help="storage budget in average bits per weight (COO outliers at 48 bits)")
    ap.add_argument("--bits-candidates", default="2,3,4,8",
                    help="comma-separated ascending per-layer widths")
    ap.add_argument("--outlier-fracs", default="",
                    help="comma-separated COO outlier fractions offered as upgrades "
                         "(empty: bits only)")
    ap.add_argument("--policies", default="sensitivity,error",
                    help="allocation policies raced as greedy candidates")
    ap.add_argument("--method", default="quantease", help="the candidates' CD method")
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--awq-prepass", action="store_true",
                    help="AWQ's scaling before CD (awq_qe)")
    ap.add_argument("--group-size", type=int, default=0)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ppl-batches", type=int, default=2,
                    help="eval-split batches per candidate (the objective)")
    ap.add_argument("--data-seed", type=int, default=0,
                    help="corpus seed: must match the training corpus")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <out-dir>/progress.jsonl candidate records")
    ap.add_argument("--fault-plan", default="",
                    help="fault-injection plan: path to a JSON spec or an inline JSON string")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)
    with fault_plan_of(args.fault_plan):
        return _run(args, dev)


def _run(args, dev) -> dict:
    from repro_torch.data.pipeline import DataConfig, make_batch_fn
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist.elastic import RetryingRunner
    from repro_torch.launch.common import load_params, model_config, qt_layout
    from repro_torch.launch.progress import append_record, load_progress
    from repro_torch.models import make_plan
    from repro_torch.tune import (
        TuneConfig,
        build_candidates,
        probe_layer_stats,
        quantize_candidate,
        tune_model,
    )

    cfg = model_config(args.arch, args.reduce)
    plan = make_plan(cfg)
    tcfg = TuneConfig(
        budget_avg_bits=args.budget_avg_bits,
        bits_candidates=tuple(int(b) for b in args.bits_candidates.split(",")),
        outlier_frac_candidates=tuple(float(f) for f in args.outlier_fracs.split(",") if f),
        policies=tuple(p for p in args.policies.split(",") if p),
        method=args.method,
        iterations=args.iterations,
        awq_prepass=args.awq_prepass,
        group_size=args.group_size or None,
        n_ppl_batches=args.ppl_batches,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    progress_path = os.path.join(args.out_dir, "progress.jsonl")
    prior_results = []
    if args.resume:
        prior_results = [r["candidate"] for r in load_progress(progress_path) if "candidate" in r]
        print(f"resume: {len(prior_results)} candidate(s) already evaluated")
    elif os.path.exists(progress_path):
        os.remove(progress_path)

    params, manifest = load_params(args.ckpt_dir, plan, dev)
    print(f"loaded checkpoint step {manifest['step']}")

    dcfg = DataConfig(vocab=cfg.vocab, seed=args.data_seed)
    calib_fn, _ = make_batch_fn(dcfg, cfg, batch=4, seq=args.seq, split="calib")
    eval_fn, _ = make_batch_fn(dcfg, cfg, batch=4, seq=args.seq, split="eval")
    # Batch i is a pure function of (seed, "calib", i): after a transient
    # storage fault the fetch restarts and reproduces the same batches.
    fetcher = RetryingRunner(lambda acc, i: acc + [calib_fn(i)], lambda: ([], 0), max_retries=5)
    calib, _ = fetcher.run([], 0, args.calib_batches)
    if fetcher.recoveries:
        print(f"calibration fetch recovered from {fetcher.recoveries} transient fault(s)")

    def progress(rec: dict):
        if "probe" in rec:
            print(f"[probe] {rec['probe']}: {rec['layers']} layers")
            append_record(progress_path, rec)
        else:
            print(f"[candidate] {rec['candidate']}: ppl={rec['ppl']:.4f}")

    doc = tune_model(
        plan, params, calib, eval_fn, tcfg, prior_results=prior_results,
        result_cb=lambda res: append_record(progress_path, {"candidate": res}),
        runner_factory=lambda step, restore: RetryingRunner(step, restore),
        progress_cb=progress, device=dev,
    )

    # The winner once more, for the saved artifact.  Candidates are a pure
    # function of (stats, tcfg): uniform rebuilds from its bits, a mixed
    # winner reruns the (deterministic) probes and allocation.
    win_label = doc["best"]["label"]
    if doc["best"]["kind"] == "uniform":
        cand = {"label": win_label, "kind": "uniform", "bits": tcfg.uniform_bits()}
    else:
        stats = probe_layer_stats(
            plan, params, calib, bits_candidates=tcfg.bits_candidates,
            outlier_cells=tuple((tcfg.bits_candidates[0], f) for f in tcfg.outlier_frac_candidates),
            outlier_iterations=tcfg.probe_outlier_iterations, device=dev)
        cand = next(c for c in build_candidates(stats, tcfg) if c["label"] == win_label)
    qp, report = quantize_candidate(plan, params, calib, cand, tcfg, device=dev)
    ckpt.save_checkpoint(
        args.out_dir, manifest["step"], {"params": qp},
        meta={"tuned": True, "label": win_label, "avg_bits": doc["best"]["avg_bits"],
              "report": {k: float(v) for k, v in report.items()}, "qt_layout": qt_layout(qp)},
    )
    alloc_doc = dict(doc)
    if cand["kind"] == "mixed":
        alloc = cand["allocation"]
        alloc_doc["winner_allocation"] = {"bits": alloc.bits, "outlier_frac": alloc.outlier_frac,
                                          "trace": alloc.trace}
    with open(os.path.join(args.out_dir, "tune.json"), "w") as f:
        json.dump(alloc_doc, f, indent=1)
    print(json.dumps({"best": doc["best"], "uniform_ppl": doc["uniform"]["ppl"],
                      "out_dir": args.out_dir}, indent=1))
    return alloc_doc


if __name__ == "__main__":
    main()
