"""Train step: loss and gradients by ``torch.autograd``, microbatch
accumulation, AdamW (the port's copy of ``repro.train.train_step``).

Microbatching splits the global batch (B, ...) into ``n_microbatches``
sequential slices whose gradients accumulate in fp32 and are then divided
by their count, as the reference's scan does; the optimizer update runs
once per step on that mean gradient.
"""

from __future__ import annotations

import torch

from repro_torch.models.model import train_loss
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["make_train_step", "loss_and_grads"]


def _split_mb(batch: dict, n_mb: int) -> list:
    def r(x):
        x = torch.as_tensor(x)
        return x.reshape(n_mb, x.shape[0] // n_mb, *x.shape[1:])

    parts = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_mb)]


def _value_and_grad(plan, params, batch):
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = train_loss(plan, tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def loss_and_grads(plan, params, batch: dict, n_microbatches: int = 1):
    """``(loss, grads)`` of ``train_loss`` at ``params`` (grads in the params'
    dtypes at one microbatch; the fp32 mean of the microbatches' gradients,
    and the mean loss, otherwise)."""
    if n_microbatches == 1:
        return _value_and_grad(plan, params, batch)
    tot, g_acc = None, None
    for mb in _split_mb(batch, n_microbatches):
        loss, grads = _value_and_grad(plan, params, mb)
        g = [x.to(torch.float32) for x in tree_flatten(grads)[0]]
        tot = loss if tot is None else tot + loss
        g_acc = g if g_acc is None else [a + b for a, b in zip(g_acc, g)]
    treedef = tree_flatten(params)[1]
    return tot / n_microbatches, tree_unflatten(treedef, [a / n_microbatches for a in g_acc])


def make_train_step(plan, opt_cfg: AdamWConfig, n_microbatches: int = 1):
    """Returns ``train_step(params, opt_state, batch) → (params', state',
    metrics)``; metrics hold ``loss``, ``grad_norm`` and ``lr`` as tensors."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(plan, params, batch, n_microbatches)
        new_params, new_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return new_params, new_state, dict(metrics, loss=loss)

    return train_step
