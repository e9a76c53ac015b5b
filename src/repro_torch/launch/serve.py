"""Serving launcher: load a (quantized) checkpoint and serve batched
requests (the port's ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3_mini_3_8b \
        --reduce --ckpt-dir /tmp/rt_quant --requests 8 --engine paged --device cpu

``--engine paged`` (the default) serves from the paged-KV engine (shared
page pool, chunked prefill, prefix caching, SLO-aware scheduling);
``--engine contiguous`` keeps the per-slot ``max_seq`` reservation.
``--kv-dtype int4`` needs the paged engine.  SLO knobs: ``--deadline-ms``,
``--priority``, ``--scheduler``; ``--fault-plan`` activates seeded fault
injection.  Speculative decoding (``--speculate``, ``--draft-*``) is not
ported yet (ROADMAP queue 1 item 5): those flags exit with a message.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.launch.common import add_device_flag, device_of, fault_plan_of, load_params

__all__ = ["main", "load_params"]

_SPEC_REFUSAL = ("speculative decoding (serve/spec.py: the draft stack, batched verify) is not "
                 "ported yet (ROADMAP queue 1 item 5)")


def _positive_int(name):
    """argparse type: strictly positive integer with a pointed error."""
    def parse(s):
        try:
            v = int(s)
        except ValueError:
            raise argparse.ArgumentTypeError(f"{name} expects a positive integer, got {s!r}")
        if v <= 0:
            raise argparse.ArgumentTypeError(
                f"{name} must be >= 1, got {v} — 0 or negative would serve nothing "
                "(use a positive count)")
        return v
    return parse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Serve batched requests from a checkpoint.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--quantized", action="store_true",
                    help="checkpoint holds fake-quant/dense params either way; informational")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=_positive_int("--max-new"), default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--engine", choices=["paged", "contiguous"], default="paged")
    ap.add_argument("--strict-engine", action="store_true",
                    help="hard-error instead of falling back to the contiguous engine when "
                         "--engine paged is unavailable for the arch")
    ap.add_argument("--page-size", type=_positive_int("--page-size"), default=16)
    ap.add_argument("--n-pages", type=int, default=0,
                    help="KV pool size in pages (0 = ample: no preemption)")
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--kv-dtype", choices=["bf16", "int8", "int4"], default="bf16",
                    help="KV cache storage; int4 packs two codes a byte and is paged-engine only")
    ap.add_argument("--scheduler", choices=["slo", "fifo"], default="slo")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request SLO deadline in ms (0 = none)")
    ap.add_argument("--priority", type=int, default=0, help="request priority (higher = sooner)")
    ap.add_argument("--fault-plan", default="",
                    help="fault-injection plan: path to a JSON spec or an inline JSON string")
    ap.add_argument("--speculate", action="store_true", help="not ported: exits")
    ap.add_argument("--gamma", type=_positive_int("--gamma"), default=4, help="not ported")
    ap.add_argument("--draft-layers", type=_positive_int("--draft-layers"), default=None,
                    help="not ported: exits")
    ap.add_argument("--draft-bits", type=_positive_int("--draft-bits"), default=None,
                    help="not ported: exits")
    ap.add_argument("--draft-checkpoint", default="", help="not ported: exits")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.speculate or args.draft_layers or args.draft_bits or args.draft_checkpoint:
        raise SystemExit(f"--speculate/--draft-*: {_SPEC_REFUSAL}")
    dev = device_of(args)
    with fault_plan_of(args.fault_plan):
        return _run(args, dev)


def _run(args, dev) -> dict:
    import numpy as np

    from repro_torch.launch.common import model_config
    from repro_torch.models import init_params, make_plan, paged_cache_shapes
    from repro_torch.serve.engine import PagedServingEngine, Request, ServingEngine
    from repro_torch.serve.qparams import prepack_params_for_serving

    cfg = model_config(args.arch, args.reduce)
    plan = make_plan(cfg, kv_cache_dtype=args.kv_dtype)
    try:
        params, manifest = load_params(args.ckpt_dir, plan, dev)
        print(f"loaded step {manifest['step']}")
    except FileNotFoundError:
        print("no checkpoint found — serving random init (demo)")
        params = init_params(plan, 0, device=dev)

    params, layouts = prepack_params_for_serving(plan, params, backend=dev.type)
    if layouts:
        labels = sorted(set(layouts.values()))
        print(f"weight pack layout ({dev.type}): " + ", ".join(
            f"{lb} ×{sum(1 for v in layouts.values() if v == lb)}" for lb in labels))
    else:
        print("weight pack layout: linear (no packed 4-bit weight leaves)")

    if args.kv_dtype == "int4" and args.engine != "paged":
        raise SystemExit(
            "--kv-dtype int4 requires --engine paged: int4 KV lives in packed pages "
            "(quant/pack.kv_pack_int4); the contiguous engine supports bf16/int8 only")
    if args.engine == "paged":
        try:  # probe the arch only: config errors must still surface
            paged_cache_shapes(plan, 2, args.page_size)
        except (ValueError, NotImplementedError) as e:
            if args.kv_dtype == "int4":
                raise SystemExit(f"--kv-dtype int4 unavailable for {args.arch}: {e}")
            if args.strict_engine:
                raise SystemExit(f"--strict-engine: paged engine unavailable for arch "
                                 f"{args.arch!r} ({e}) and fallback is disabled")
            print(f"WARNING: paged engine unavailable for arch {args.arch!r} ({e}) — FALLING "
                  "BACK to the contiguous engine: no paged KV pool, no prefix cache, no SLO "
                  "preemption (pass --strict-engine to make this a hard error)", file=sys.stderr)
            args.engine = "contiguous"
    if args.engine == "paged":
        eng = PagedServingEngine(
            plan, params, max_batch=args.max_batch, max_seq=512, page_size=args.page_size,
            n_pages=args.n_pages or None, prefill_chunk=args.prefill_chunk,
            scheduler=args.scheduler, device=dev,
        )
    else:
        eng = ServingEngine(plan, params, max_batch=args.max_batch, max_seq=512, device=dev)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(4, 32)).astype(np.int32)
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new,
                           deadline_ms=args.deadline_ms or None, priority=args.priority))
    finished = sorted(eng.run(), key=lambda r: r.rid)
    for r in finished:
        print(f"req{r.rid} [{r.status}]: prompt[{len(r.prompt)}] -> {r.output}")
    if args.engine == "paged":
        print(f"{len(finished)} requests, {eng.n_decode_steps} decode steps, "
              f"{eng.n_prefill_chunks} prefill chunks "
              f"({eng.n_prefix_hit_tokens} prefix-cached tokens, "
              f"{eng.n_preemptions} preemptions, {eng.n_shed} shed, "
              f"{eng.n_deadline_missed} deadline-missed)")
    else:
        print(f"{len(finished)} requests, {eng.n_decode_steps} decode steps, "
              f"{eng.n_prefills} prefills")
    return {"engine": args.engine, "requests": finished, "n_decode_steps": eng.n_decode_steps,
            "layouts": layouts}


if __name__ == "__main__":
    main()
