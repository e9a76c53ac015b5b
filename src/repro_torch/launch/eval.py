"""Eval launcher: score a (quantized) model end to end — the paper's tables
(the port's ``repro.launch.eval``).

Loads a checkpoint, sweeps a method × bits (× outlier budget) grid through
the whole-model PTQ solver (each cell quantized in process and scored as
its serving artifact), and measures on the ``split="eval"`` stream:
perplexity, cloze top-1/top-5, multi-choice accuracy, and the
scorer-against-serving-engine logit parity on a quantized artifact.

    PYTHONPATH=src python -m repro_torch.launch.eval --arch phi3_mini_3_8b \
        --reduce --ckpt-dir /tmp/rt_train --bits 4 3 --methods rtn gptq quantease \
        --outlier-bits 3 --device cpu --out /tmp/rt_eval.json

``--smoke`` shrinks the grid and budgets to seconds (same schema).  The
document records ``"torch"`` and ``"backend"`` where the reference's
records its JAX version and backend.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.launch.common import add_device_flag, device_of

__all__ = ["main"]


def main(argv=None) -> dict:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(
        description="End-to-end quantized-model evaluation (ppl + tasks + parity).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true",
                    help="CPU-sized config (same reduction as launch/train.py)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "repro_torch_train"))
    ap.add_argument("--out", default=os.path.join(tmp, "repro_torch_eval", "eval.json"))
    ap.add_argument("--methods", nargs="+", default=["rtn", "gptq", "quantease"])
    ap.add_argument("--bits", type=int, nargs="+", default=[4, 3])
    ap.add_argument("--outlier-bits", type=int, default=0, metavar="B",
                    help="add a qe_outlier cell at B bits (0 = off)")
    ap.add_argument("--outlier-frac", type=float, default=0.01)
    ap.add_argument("--group-size", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-seed", type=int, default=0,
                    help="corpus seed: must match the training corpus (TrainerConfig.seed, 0)")
    ap.add_argument("--emit", choices=["qt", "fake"], default="qt",
                    help="score the QuantizedTensor serving artifact (qt) or the dequantized tree")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the serving-engine logit parity check")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale budgets, 2-cell grid (schema unchanged)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)

    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, make_batch_fn
    from repro_torch.eval import EVAL_SCHEMA, quantized_parity, run_grid, validate_doc
    from repro_torch.eval.harness import EvalBudget
    from repro_torch.launch.common import load_params, model_config
    from repro_torch.models import init_params, make_plan
    from repro_torch.models.model import check_token_only

    cfg = model_config(args.arch, args.reduce)
    plan = make_plan(cfg)
    try:
        check_token_only(cfg, "launch.eval")
    except ValueError as e:
        raise SystemExit(str(e)) from None
    try:
        params, manifest = load_params(args.ckpt_dir, plan, dev)
        print(f"loaded checkpoint step {manifest['step']}")
    except FileNotFoundError:
        print("no checkpoint found — evaluating random init (smoke/demo only)")
        params = init_params(plan, 0, device=dev)

    dc = DataConfig(vocab=cfg.vocab, seed=args.data_seed)
    calib_fn, _ = make_batch_fn(dc, cfg, batch=4, seq=args.seq, split="calib")
    eval_fn, corpus = make_batch_fn(dc, cfg, batch=4, seq=args.seq, split="eval")
    calib = [calib_fn(i) for i in range(1 if args.smoke else args.calib_batches)]

    if args.smoke:
        cells = [{"method": "rtn", "bits": 4}, {"method": "quantease", "bits": 3, "iterations": 2}]
        budget = EvalBudget.smoke()
    else:
        cells = [{"method": m, "bits": b, "group_size": args.group_size or None}
                 for b in args.bits for m in args.methods]
        if args.outlier_bits:
            cells.append({"method": "qe_outlier", "bits": args.outlier_bits,
                          "outlier_frac": args.outlier_frac})
        budget = EvalBudget(n_ppl_batches=args.eval_batches)

    def progress(rec):
        print(f"[{rec['cell']}] ppl={rec.get('ppl', 0):.4f} "
              f"top1={rec.get('top1', 0):.3f} choice={rec.get('choice_acc', 0):.3f}")

    iterations = 2 if args.smoke else args.iterations
    doc = {
        "schema": EVAL_SCHEMA,
        "smoke": bool(args.smoke),
        "torch": torch.__version__,
        "backend": dev.type,
        "arch": args.arch,
        "data": {
            "vocab": cfg.vocab, "seq": args.seq, "eval_split": "eval", "calib_split": "calib",
            "entropy_floor_ppl": round(float(np.exp(corpus.entropy_floor())), 4),
        },
        "iterations": iterations,
        "emit": args.emit,
    }
    doc.update(run_grid(plan, params, calib, eval_fn, cells, iterations=iterations,
                        emit=args.emit, budget=budget, progress_cb=progress, device=dev))
    if args.no_parity:
        doc["parity"] = None
    else:
        rng = np.random.default_rng(11)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (5, 13, 29)]
        doc["parity"] = quantized_parity(plan, params, calib, prompts,
                                         iterations=2 if args.smoke else 6, device=dev)
        print(f"parity: {doc['parity']}")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")
    # Validated whatever --no-parity says: a full doc without parity (or
    # with broken orderings) warns here.
    if not doc["smoke"]:
        for p in validate_doc(doc):
            print(f"WARNING: {p}")
    return doc


if __name__ == "__main__":
    main()
