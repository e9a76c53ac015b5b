"""What the launchers share: the device flag, the fault plan, the model
config and the checkpoint templates."""

from __future__ import annotations

import contextlib

import torch

from repro_torch.device import resolve_device

__all__ = ["add_device_flag", "device_of", "fault_plan_of", "model_config", "load_params",
           "train_template"]


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (the plain PyTorch path)")


def device_of(args) -> torch.device:
    """``resolve_device(args.device)``; no CUDA for ``cuda`` exits the CLI."""
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None


@contextlib.contextmanager
def fault_plan_of(spec: str):
    """Activate ``--fault-plan`` (a path or inline JSON) for the block."""
    from repro_torch.faults import FaultPlan, fault_plan

    plan = FaultPlan.from_spec(spec) if spec else None
    if plan is not None:
        print(f"fault plan active: seed={plan.seed}, {len(plan.specs)} spec(s)")
    with fault_plan(plan):
        yield plan


def model_config(arch: str, reduce: bool):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import reduced

    cfg = get_config(arch)
    return reduced(cfg) if reduce else cfg


def train_template(plan, device) -> dict:
    """The tree of a training checkpoint, ``{"params", "opt"}``: params on
    ``device``, the AdamW state (fp32 moments) on the meta device, so it is
    checked against the manifest and not kept."""
    from repro_torch.models import empty_params
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    return {"params": empty_params(plan, device=device),
            "opt": adamw_init(empty_params(plan, device="meta"), AdamWConfig())}


def load_params(ckpt_dir: str, plan, device):
    """The params of the newest checkpoint in ``ckpt_dir``: a params-only
    one (quantize/eval output), or a training one (params and optimizer
    state).  Returns ``(params, manifest)``; raises ``FileNotFoundError``
    when there is none."""
    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.models import empty_params

    try:
        state, manifest = ckpt.load_checkpoint(ckpt_dir, {"params": empty_params(plan, device=device)})
    except ValueError:
        state, manifest = ckpt.load_checkpoint(ckpt_dir, train_template(plan, device))
    return state["params"], manifest
