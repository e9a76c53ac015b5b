"""PTQ launcher: quantize a trained checkpoint with any of the paper's
methods (the port's ``repro.launch.quantize``).

    PYTHONPATH=src python -m repro_torch.launch.quantize --arch phi3_mini_3_8b \
        --reduce --ckpt-dir /tmp/rt_train --method quantease --bits 3 \
        --device cpu --out-dir /tmp/rt_quant

* ``--stream-calib N`` — feed the capture pass at most N sequences at a
  time (0 = a whole calibration batch).
* ``--resume`` — report a previous run's ``progress.jsonl`` (tolerating a
  torn last line), then restart from scratch: calibration batch ``i`` is a
  pure function of ``(seed, "calib", i)`` and the solve has no RNG, so the
  restart writes the same bytes as an uninterrupted run.
* ``--fault-plan`` — a seeded fault-injection plan (path or inline JSON);
  transient faults in the calibration fetch are retried
  (``RetryingRunner``), a damaged newest source step falls back to the last
  good one with a warning.
* ``--shard`` — shard Σ accumulation and the CD solve over every rank of
  a launcher (``torchrun``'s ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): each
  rank joins the process group (NCCL on ``cuda:LOCAL_RANK``, gloo for
  ``--device cpu``) and a data mesh over all of them is passed to
  ``ptq_quantize_model``.  Rank 0 alone prints, writes the checkpoint,
  ``progress.jsonl`` and the report.  Without a launcher, or with one
  rank, the path is the local one, as the reference's on one device::

      torchrun --nproc-per-node 2 -m repro_torch.launch.quantize --arch phi3_mini_3_8b \
          --reduce --ckpt-dir /tmp/rt_train --device cpu --shard --out-dir /tmp/rt_quant

Writes ``{"params": ...}`` (the dequantized weights, ``emit="fake"``) as a
checkpoint at the source's step with the reference's ``meta``, one
progress line and ``progress.jsonl`` record per block, and a JSON report.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from repro_torch.launch.common import add_device_flag, device_of, fault_plan_of
from repro_torch.launch.progress import append_record, load_progress

__all__ = ["main", "load_progress", "append_record"]

METHODS = ["rtn", "gptq", "awq", "quantease", "awq_qe", "spqr", "qe_outlier", "qe_outlier_struct"]


def main(argv=None) -> dict:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser(description="Whole-model PTQ with the port's QuantEase engine.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true",
                    help="CPU-sized config (same reduction as launch/train.py)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "repro_torch_train"))
    ap.add_argument("--out-dir", default=os.path.join(tmp, "repro_torch_quant"))
    ap.add_argument("--method", default="quantease", choices=METHODS)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--iterations", type=int, default=25)
    ap.add_argument("--outlier-frac", type=float, default=0.01)
    ap.add_argument("--group-size", type=int, default=0)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-seed", type=int, default=0,
                    help="corpus seed: must match the training corpus (TrainerConfig.seed, 0)")
    ap.add_argument("--shard", action="store_true",
                    help="the reference's mesh; one device takes the local path")
    ap.add_argument("--stream-calib", type=int, default=0, metavar="N",
                    help="capture-pass chunk size in sequences (0 = whole batch)")
    ap.add_argument("--resume", action="store_true",
                    help="report a previous run's block progress before starting")
    ap.add_argument("--fault-plan", default="",
                    help="fault-injection plan: path to a JSON spec or an inline JSON string")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)
    joined = args.shard and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if joined:
        dev = _join_group(dev)
    try:
        with fault_plan_of(args.fault_plan):
            return _run(args, dev, joined)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _join_group(dev):
    """Join the launcher's process group (``env://``): NCCL with this rank
    on ``cuda:LOCAL_RANK``, gloo on the CPU.  Returns the rank's device."""
    import torch
    import torch.distributed as dist

    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return dev


def _run(args, dev, joined: bool) -> dict:
    import numpy as np
    import torch.distributed as dist

    from repro_torch.core.solver import PTQConfig, ptq_quantize_model
    from repro_torch.data.pipeline import DataConfig, make_batch_fn
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.dist.elastic import RetryingRunner
    from repro_torch.launch.common import model_config, train_template
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import make_plan
    from repro_torch.quant import GridSpec

    cfg = model_config(args.arch, args.reduce)
    plan = make_plan(cfg)
    mesh = make_data_mesh(device=dev.type) if joined else None
    lead = not joined or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    progress_path = os.path.join(args.out_dir, "progress.jsonl")
    if args.resume:
        lines = load_progress(progress_path)
        if lines:
            last = lines[-1]
            say(f"previous run: {last['done_blocks']}/{last['total_blocks']} blocks "
                  f"({last['stack']}.p{last['period']}.b{last['block']}), "
                  f"mean_err={last['mean_rel_error']:.4g} — restarting from scratch")
        else:
            say("previous run: no complete progress records — cold start")
    # Each run owns its progress file, so records never interleave across runs.
    if lead and os.path.exists(progress_path):
        os.remove(progress_path)

    state, manifest, skipped = ckpt.load_last_good(args.ckpt_dir, train_template(plan, dev))
    for step, reason in skipped:
        say(f"WARNING: skipped damaged checkpoint step_{step}: {reason.splitlines()[0]}",
            file=sys.stderr)
    params = state["params"]
    del state
    say(f"loaded checkpoint step {manifest['step']}")
    if args.shard:
        n = dist.get_world_size() if joined else 1
        say(f"--shard: {n} device(s)" + (" — single-device fallback" if mesh is None else ""))

    batch_fn, _ = make_batch_fn(DataConfig(vocab=cfg.vocab, seed=args.data_seed), cfg,
                                batch=4, seq=args.seq, split="calib")
    # Batch i is a pure function of (seed, "calib", i): after a transient
    # storage fault the fetch restarts from an empty list and reproduces
    # the same calibration set.
    fetcher = RetryingRunner(lambda acc, i: acc + [batch_fn(i)], lambda: ([], 0), max_retries=5)
    calib, _ = fetcher.run([], 0, args.calib_batches)
    if fetcher.recoveries:
        say(f"calibration fetch recovered from {fetcher.recoveries} transient fault(s)")
    pcfg = PTQConfig(
        method=args.method,
        spec=GridSpec(bits=args.bits, group_size=args.group_size or None),
        iterations=args.iterations,
        outlier_frac=args.outlier_frac,
        stream_chunk=args.stream_calib,
        shard=args.shard,
    )
    if lead:
        os.makedirs(args.out_dir, exist_ok=True)

    def progress(rec: dict):
        print(f"[{rec['stack']} p{rec['period']} b{rec['block']} "
              f"{rec['done_blocks']}/{rec['total_blocks']}] "
              f"{rec['n_linears']} linears  mean_err={rec['mean_rel_error']:.4g}  "
              f"{rec['seconds']}s")
        append_record(progress_path, rec)

    qparams, report = ptq_quantize_model(plan, params, calib, pcfg, progress_cb=progress,
                                         mesh=mesh, device=dev)
    if lead:
        ckpt.save_checkpoint(
            args.out_dir, manifest["step"], {"params": qparams},
            meta={"method": args.method, "bits": args.bits,
                  "report": {k: float(v) for k, v in report.items()}},
        )
    errs = np.array(list(report.values()))
    summary = {
        "layers": len(report),
        "mean_rel_error": float(errs.mean()),
        "max_rel_error": float(errs.max()),
        "out_dir": args.out_dir,
    }
    say(json.dumps(summary, indent=1))
    return dict(summary, report=report)


if __name__ == "__main__":
    main()
