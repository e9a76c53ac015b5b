"""Training launcher (the port's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3_mini_3_8b \
        --reduce --steps 20 --device cpu --ckpt-dir /tmp/rt_train

Trains on the synthetic corpus with AdamW and writes a checkpoint every
``max(steps // 4, 1)`` steps (each step directory is kept), in the
reference's format.  ``--reduce`` is the reference's CPU-sized config.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.launch.common import add_device_flag, device_of

__all__ = ["reduced", "main"]


def reduced(cfg):
    """The reference's CPU-sized reduction of a config
    (``repro.launch.train.reduced``)."""
    kw = dict(
        d_model=128,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32,
        d_ff=0 if cfg.d_ff == 0 else 256,
        vocab=256,
        n_periods=2,
        max_seq=1024,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2),
        moe_d_ff=256 if cfg.n_experts else 0,
        ssm_state=16,
        ssm_headdim=16,
        n_enc_periods=2 if cfg.n_enc_periods else 0,
        n_frames=64 if cfg.family == "encdec" else 1500,
        n_prefix=16 if cfg.n_prefix else 0,
    )
    return dataclasses.replace(cfg, **kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Train a model of the port on the synthetic corpus.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduce", action="store_true", help="CPU-sized config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--moments", default="fp32", choices=["fp32", "int8"])
    ap.add_argument("--microbatches", type=int, default=1)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = device_of(args)

    from repro_torch.launch.common import model_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(
        model_config(args.arch, args.reduce),
        AdamWConfig(lr=args.lr, total_steps=args.steps, moments=args.moments),
        TrainerConfig(steps=args.steps, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(args.steps // 4, 1), n_microbatches=args.microbatches),
        device=dev,
    )
    out = trainer.run()
    loss = out["final_loss"]
    print(f"final loss: {'n/a' if loss is None else f'{loss:.4f}'}  "
          f"recoveries: {out['recoveries']}")
    for m in out["log"]:
        print(m)
    return out


if __name__ == "__main__":
    main()
