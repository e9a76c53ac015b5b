"""Serving launcher: load a (quantized) checkpoint and serve batched
requests (the port's ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3_mini_3_8b \
        --reduce --ckpt-dir /tmp/rt_quant --requests 8 --engine paged --device cpu

``--engine paged`` (the default) serves from the paged-KV engine (shared
page pool, chunked prefill, prefix caching, SLO-aware scheduling);
``--engine contiguous`` keeps the per-slot ``max_seq`` reservation.
``--kv-dtype int4`` needs the paged engine.  SLO knobs: ``--deadline-ms``,
``--priority``, ``--scheduler``; ``--fault-plan`` activates seeded fault
injection.

Speculative decoding (paged engine): ``--speculate`` turns on
self-speculative greedy decode, a draft stack proposing ``--gamma`` tokens a
round into draft-owned pages of the same pool and one target forward
verifying them.  The draft is ``--draft-layers K`` (the served stack's first
K periods), ``--draft-bits B`` (round-to-nearest of the loaded checkpoint:
``serve.qparams.rtn_quantize_for_serving``; a quantized checkpoint is
dequantized first), ``--draft-checkpoint DIR``, or a combination (bits or
checkpoint, then truncated by ``--draft-layers``); ``--speculate`` alone
truncates at half depth.  ``--record-logits`` keeps each step's logits in the
returned result (``"logit_trace"``), for callers that compare runs.
Checkpoints of quantized serving params (``launch.tune``'s output) load as
they are.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.launch.common import add_device_flag, device_of, fault_plan_of, load_params

__all__ = ["main", "load_params"]


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
    ap.add_argument("--speculate", action="store_true",
                    help="self-speculative greedy decode (paged engine only)")
    ap.add_argument("--gamma", type=_positive_int("--gamma"), default=4,
                    help="draft tokens proposed per speculative round")
    ap.add_argument("--draft-layers", type=_positive_int("--draft-layers"), default=None,
                    help="truncated self-draft: the served stack's first K periods")
    ap.add_argument("--draft-bits", type=_positive_int("--draft-bits"), default=None,
                    help="round-to-nearest the loaded checkpoint to this many bits as the draft")
    ap.add_argument("--draft-checkpoint", default="",
                    help="the draft from a separate checkpoint dir (same arch)")
    ap.add_argument("--record-logits", action="store_true",
                    help="return each step's logits (result['logit_trace'])")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)
    with fault_plan_of(args.fault_plan):
        return _run(args, dev)


def _run(args, dev) -> dict:
    import numpy as np

    from repro_torch.launch.common import model_config
    from repro_torch.models import init_params, make_plan, paged_cache_shapes
    from repro_torch.models.model import check_token_only
    from repro_torch.serve.engine import PagedServingEngine, Request, ServingEngine
    from repro_torch.serve.qparams import prepack_params_for_serving

    cfg = model_config(args.arch, args.reduce)
    plan = make_plan(cfg, kv_cache_dtype=args.kv_dtype)
    try:
        check_token_only(cfg, "launch.serve")
    except ValueError as e:
        raise SystemExit(str(e)) from None
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
    if args.speculate and args.engine != "paged":
        # No silent downgrade: draft pages live in the paged pool.
        raise SystemExit(
            "--speculate requires the paged engine (draft tokens decode into draft-owned "
            f"pages of the shared pool); it is unavailable with --engine {args.engine} for "
            f"arch {args.arch!r}")
    spec = _spec_config(args, cfg, plan, params, dev) if args.speculate else None
    if args.engine == "paged":
        eng = PagedServingEngine(
            plan, params, max_batch=args.max_batch, max_seq=512, page_size=args.page_size,
            n_pages=args.n_pages or None, prefill_chunk=args.prefill_chunk,
            scheduler=args.scheduler, spec=spec, record_logits=args.record_logits, device=dev,
        )
    else:
        eng = ServingEngine(plan, params, max_batch=args.max_batch, max_seq=512,
                            record_logits=args.record_logits, device=dev)
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
        if args.speculate:
            acc = eng.acceptance_rate()
            print(f"speculative: {eng.n_spec_rounds} rounds, {eng.n_draft_accepted}/"
                  f"{eng.n_draft_tokens} draft tokens accepted (rate "
                  f"{'-' if acc is None else format(acc, '.3f')}, γ={args.gamma})")
    else:
        print(f"{len(finished)} requests, {eng.n_decode_steps} decode steps, "
              f"{eng.n_prefills} prefills")
    out = {"engine": args.engine, "requests": finished, "n_decode_steps": eng.n_decode_steps,
           "layouts": layouts, "logit_trace": eng.logit_trace}
    if spec is not None:
        out["spec"] = {"rounds": eng.n_spec_rounds, "draft_tokens": eng.n_draft_tokens,
                       "accepted": eng.n_draft_accepted, "acceptance_rate": eng.acceptance_rate(),
                       "propose_calls": eng.spec_mgr.n_propose_calls,
                       "draft_periods": spec.draft_plan.cfg.n_periods}
    return out


def _spec_config(args, cfg, plan, params, dev):
    """The ``SpecConfig`` of ``--speculate`` and the ``--draft-*`` flags."""
    from repro_torch.serve.qparams import rtn_quantize_for_serving
    from repro_torch.serve.spec import SpecConfig, truncate_draft

    draft_plan, draft_params = plan, params
    if args.draft_checkpoint:
        draft_params, d_manifest = load_params(args.draft_checkpoint, plan, dev)
        print(f"draft checkpoint: step {d_manifest['step']}")
    if args.draft_bits:
        draft_params, d_layout = rtn_quantize_for_serving(plan, draft_params, bits=args.draft_bits)
        print(f"draft: {args.draft_bits}-bit RTN [{d_layout}]")
    k = args.draft_layers
    if k is None and not args.draft_bits and not args.draft_checkpoint:
        k = max(1, cfg.n_periods // 2)
        print(f"--speculate with no draft source: truncated self-draft at {k}/{cfg.n_periods} "
              "periods")
    if k is not None:
        if k >= cfg.n_periods:
            raise SystemExit(
                f"--draft-layers {k} must be < the target's {cfg.n_periods} periods — a "
                "full-depth draft is the target itself and speculation would only add overhead")
        draft_plan, draft_params = truncate_draft(draft_plan, draft_params, k)
    return SpecConfig(draft_plan=draft_plan, draft_params=draft_params, gamma=args.gamma)


if __name__ == "__main__":
    main()
