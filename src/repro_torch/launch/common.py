"""What the launchers share: the device flag, the fault plan, the model
config and the checkpoint templates.

A checkpoint of quantized serving params (``launch.tune``'s output) records
each QuantizedTensor leaf's static fields in its ``meta["qt_layout"]``
(:func:`qt_layout`), since the manifest records only array shapes and
dtypes; :func:`load_params` builds its template from them."""

from __future__ import annotations

import contextlib

import torch

from repro_torch.device import resolve_device

__all__ = ["add_device_flag", "device_of", "fault_plan_of", "model_config", "load_params",
           "train_template", "qt_layout"]


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


def qt_layout(params) -> dict:
    """``{"<block>/<name>": fields}`` for every QuantizedTensor ``dec`` leaf,
    ``{"enc/<block>/<name>": fields}`` for an encoder's: its static fields
    and the names of its array fields that are set (the ``meta["qt_layout"]``
    of a quantized checkpoint)."""
    import dataclasses

    from repro_torch.quant import QuantizedTensor

    out = {}
    for stack, prefix in (("dec", ""), ("enc", "enc/")):
        for key, blk in params.get(stack, {}).items():
            for name, leaf in blk.items():
                if isinstance(leaf, QuantizedTensor):
                    static = {f.name: getattr(leaf, f.name) for f in dataclasses.fields(leaf)
                              if f.metadata.get("static")}
                    out[f"{prefix}{key}/{name}"] = dict(static, arrays=[
                        f.name for f in dataclasses.fields(leaf)
                        if not f.metadata.get("static") and getattr(leaf, f.name) is not None])
    return out


def _quantized_template(plan, device, manifest: dict) -> dict:
    """A ``{"params": ...}`` template for a checkpoint whose meta has a
    ``qt_layout``: the dense params with those leaves made QuantizedTensors,
    each array an empty tensor of the manifest's shape and dtype."""
    import numpy as np

    from repro_torch.models import empty_params
    from repro_torch.quant import QuantizedTensor
    from repro_torch.tree import tree_flatten, tree_unflatten

    marker = object()
    params = empty_params(plan, device="meta")
    for path, fields in manifest["meta"]["qt_layout"].items():
        stack, key, name = path.split("/") if path.count("/") == 2 else ("dec", *path.split("/"))
        static = {k: v for k, v in fields.items() if k != "arrays"}
        params[stack][key][name] = QuantizedTensor(
            codes=marker, scale=marker, zero=marker, **static,
            **{f: marker for f in fields["arrays"] if f not in ("codes", "scale", "zero")})
    leaves, treedef = tree_flatten({"params": params})
    recs = manifest["leaves"]
    if len(recs) != len(leaves):
        raise ValueError(f"checkpoint has {len(recs)} leaves, its qt_layout template {len(leaves)}")

    def dtype(name):
        return torch.bfloat16 if name == "bfloat16" else torch.from_numpy(np.empty(0, name)).dtype

    def empty(leaf, rec):
        if leaf is marker:
            return torch.empty(rec["shape"], dtype=dtype(rec["dtype"]), device=device)
        return torch.empty_like(leaf, device=device)

    return tree_unflatten(treedef, [empty(l, r) for l, r in zip(leaves, recs)])


def load_params(ckpt_dir: str, plan, device):
    """The params of the newest checkpoint in ``ckpt_dir``: quantized serving
    params (a ``qt_layout`` in its meta: ``launch.tune``'s output), a
    params-only one (quantize/eval output), or a training one (params and
    optimizer state).  Returns ``(params, manifest)``; raises
    ``FileNotFoundError`` when there is none."""
    import json
    import os

    from repro_torch.dist import checkpoint as ckpt
    from repro_torch.models import empty_params

    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    with open(os.path.join(ckpt_dir, f"step_{step}", "manifest.json")) as f:
        manifest = json.load(f)
    if "qt_layout" in manifest["meta"]:
        like = _quantized_template(plan, device, manifest)
        state, manifest = ckpt.load_checkpoint(ckpt_dir, like, step=step)
        return state["params"], manifest
    try:
        state, manifest = ckpt.load_checkpoint(ckpt_dir, {"params": empty_params(plan, device=device)})
    except ValueError:
        state, manifest = ckpt.load_checkpoint(ckpt_dir, train_template(plan, device))
    return state["params"], manifest
