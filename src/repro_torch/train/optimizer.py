"""AdamW with optional 8-bit moments (the port's copy of
``repro.train.optimizer``).

The 8-bit moment states reuse the uniform affine grids of the PTQ core, one
grid per last-axis row, so the uint8 moment arrays are exactly param-shaped.
Leaves with ndim < 2 (norm scales, biases) stay fp32.

State per leaf: ``{"m": m, "v": v}``; each moment is an fp32 tensor or
``{"q": uint8 (param shape), "scale": fp32 (..., 1), "zero": fp32 (..., 1)}``.
The whole state is ``{"mu": <tree of leaf states>, "count": int32 scalar}``,
the reference's structure, so :mod:`repro_torch.dist.checkpoint` writes it
leaf for leaf as the reference does.  The update runs in fp32 and casts the
new params back to their dtype, as the reference does.

Data- and tensor-parallel / FSDP: ``shards`` (a
:class:`repro_torch.dist.sharding.TreeShards` of the params) says which
leaves each rank holds a block of, over the data dim and the "model" dim.
The update is elementwise, so a rank updates its block; the two reductions
over whole leaves are made global: the gradient norm (a leaf's squared sum
all-reduced over each dim that cuts it, the data dim first; a leaf whole
on a dim counted once) and an 8-bit moment's row grid where the rows' last
axis is a cut one (its row minimum and maximum all-reduced over that dim).
With one rank the result is the local update's, bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist.collectives import all_reduce
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "lr_schedule",
    "global_norm",
    "moment_axes",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moments: str = "fp32"  # "fp32" | "int8"
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


_V_FLOOR = 1e-16


def _q8_encode(x: torch.Tensor, signed: bool, row_reduce=None) -> dict:
    """Row-wise (last-axis) 8-bit encoding of an fp32 moment.

    m (signed): linear, symmetric around 0 (zero point 128).
    v (unsigned): affine in the log domain, which keeps ~1 % relative
    precision across a heavy-tailed row and never decodes to zero (a linear
    grid would round small entries to 0 and blow up m/(√v+ε)).
    ``row_reduce(t, op)`` ("max" or "min"), where the rows are split over
    ranks, makes each row statistic the whole row's.
    """
    red = row_reduce or (lambda t, op: t)
    if signed:
        scale = torch.clamp_min(red(x.abs().amax(-1, keepdim=True), "max") / 127.0, 1e-20)
        q = torch.clamp(torch.round(x / scale) + 128, 0, 255).to(torch.uint8)
        return {"q": q, "scale": scale, "zero": torch.full_like(scale, 128.0)}
    lx = torch.log(x + _V_FLOOR)
    lo = red(lx.amin(-1, keepdim=True), "min")
    hi = red(lx.amax(-1, keepdim=True), "max")
    scale = torch.clamp_min((hi - lo) / 255.0, 1e-12)
    q = torch.clamp(torch.round((lx - lo) / scale), 0, 255).to(torch.uint8)
    return {"q": q, "scale": scale, "zero": -lo / scale}


def _decode(m, signed: bool = True) -> torch.Tensor:
    if isinstance(m, dict):
        vals = (m["q"].to(torch.float32) - m["zero"]) * m["scale"]
        return vals if signed else torch.exp(vals) - _V_FLOOR
    return m


def _use_int8(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments on each param's device, and ``count`` 0 (int32)."""
    leaves, treedef = tree_flatten(params)

    def leaf_state(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.moments == "int8" and _use_int8(p):
            return {"m": _q8_encode(z, True), "v": _q8_encode(z, False)}
        return {"m": z, "v": z.clone()}

    mu = tree_unflatten(treedef, [leaf_state(p) for p in leaves])
    dev = leaves[0].device if leaves else None
    return {"mu": mu, "count": torch.zeros((), dtype=torch.int32, device=dev)}


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``; fp32, as the
    reference's (``step`` an int or a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree, shards=None) -> torch.Tensor:
    """√(Σ g²) over every leaf, in fp32, summed in the reference's leaf order;
    with ``shards``, a sharded leaf's squared sum is taken over the ranks of
    each dim that cuts it."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)]
    for axis, dims in shards.cuts() if shards else ():
        split = [i for i, d in enumerate(dims) if d is not None]
        if split:
            part = all_reduce(torch.stack([sq[i] for i in split]), shards.mesh, axis)
            for j, i in enumerate(split):
                sq[i] = part[j]
    return torch.sqrt(sum(sq))


def _row_reduce(shards, i: int, ndim: int):
    """The row-statistic reduction of leaf ``i``: over the ranks of the dim
    that cuts its last axis, else None."""
    axes = [axis for axis, dims in (shards.cuts() if shards else ()) if dims[i] == ndim - 1]
    if not axes:
        return None
    return lambda t, op: all_reduce(t, shards.mesh, axes[0], op)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *, shards=None):
    """One AdamW step.  Returns ``(new_params, new_state, {"grad_norm", "lr"})``;
    the inputs are not modified.  ``shards``: the params' layout over a data
    mesh (each rank passes its blocks; see the module docstring)."""
    count = state["count"] + 1
    lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads, shards)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12), 1.0)
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, c)
    bc2 = 1 - torch.pow(cfg.b2, c)

    def leaf(i, p, g, s):
        g = g.to(torch.float32) * clip
        m = cfg.b1 * _decode(s["m"], True) + (1 - cfg.b1) * g
        v = torch.clamp_min(cfg.b2 * _decode(s["v"], False) + (1 - cfg.b2) * g * g, 0.0)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0
        p32 = p.to(torch.float32)
        new_p = p32 - lr * (upd + decay * p32)
        if cfg.moments == "int8" and _use_int8(p):
            red = _row_reduce(shards, i, p.dim())
            new_s = {"m": _q8_encode(m, True, red), "v": _q8_encode(v, False, red)}
        else:
            new_s = {"m": m, "v": v}
        return new_p.to(p.dtype), new_s

    is_state = lambda x: isinstance(x, dict) and set(x) == {"m", "v"}
    flat_p, treedef = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_s = tree_flatten(state["mu"], is_leaf=is_state)[0]
    out = [leaf(i, p, g, s)
           for i, (p, g, s) in enumerate(zip(flat_p, flat_g, flat_s, strict=True))]
    new_params = tree_unflatten(treedef, [o[0] for o in out])
    new_mu = tree_unflatten(treedef, [o[1] for o in out])
    return new_params, {"mu": new_mu, "count": count}, {"grad_norm": gnorm, "lr": lr}



def moment_axes(params_shapes, param_axes_tree, cfg: AdamWConfig) -> dict:
    """The logical-axes tree of :func:`adamw_init`'s state (the reference's):
    a moment's axes are its param's; an 8-bit moment's ``q`` has them, its
    ``scale`` and ``zero`` drop the last (one per row); ``count`` has none.
    ``params_shapes``: tensors (meta ones will do) giving each leaf's rank."""
    flat_s, treedef = tree_flatten(params_shapes)
    flat_ax = tree_flatten(param_axes_tree, is_leaf=lambda x: isinstance(x, tuple))[0]

    def leaf(t, ax):
        ax = tuple(ax)
        if cfg.moments == "int8" and t.dim() >= 2:
            enc = {"q": ax, "scale": (*ax[:-1], None), "zero": (*ax[:-1], None)}
            return {"m": enc, "v": enc}
        return {"m": ax, "v": ax}

    return {"mu": tree_unflatten(treedef, [leaf(t, a) for t, a in zip(flat_s, flat_ax)]),
            "count": ()}
