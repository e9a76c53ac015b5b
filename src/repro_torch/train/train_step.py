"""Train step: loss and gradients by ``torch.autograd``, microbatch
accumulation, AdamW (the port's copy of ``repro.train.train_step``).

Microbatching splits the global batch (B, ...) into ``n_microbatches``
sequential slices whose gradients accumulate in fp32 and are then divided
by their count, as the reference's scan does; the optimizer update runs
once per step on that mean gradient.

Data parallelism (``grad_shardings``, a
:class:`repro_torch.dist.sharding.TreeShards` of the params over a data
mesh): each rank passes its block of the batch and its blocks of the
params.  A sharded leaf is all-gathered inside autograd, so its gradient
arrives as its reduce-scattered shard (summed over ranks); the replicated
leaves' gradients are all-reduced; every gradient and the loss are then
divided by the rank count, the mean over the global batch where the ranks
hold equal token counts.  With one rank this is the local step, bit for
bit.

Tensor parallelism (a "model" dim beside the data dim, the rules installed
by the caller with :func:`repro_torch.dist.sharding.axis_rules`): each rank
passes its shards of the params on "model" and the batch block of its data
coordinate.  ``train_loss`` runs the model axis' collectives in its
forward and backward passes, so every rank of one data coordinate gets the
same loss and, for each leaf, the gradient of its own shard (whole where
it holds the leaf whole); the mean above runs over the data dim alone.
"""

from __future__ import annotations

import torch

from repro_torch.dist.collectives import all_reduce, axis_size, gather_dim_grad
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


def _value_and_grad(plan, params, batch, shards=None):
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        full = leaves if shards is None else [
            t if d is None else gather_dim_grad(t, d, shards.mesh, shards.axis)
            for t, d in zip(leaves, shards.dims, strict=True)]
        loss = train_loss(plan, tree_unflatten(treedef, full), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def _data_parallel_mean(loss, grads, shards):
    """Sum the replicated leaves' gradients and the loss over the data ranks
    (the sharded leaves' arrive summed), then divide all by their count."""
    n = axis_size(shards.mesh, shards.axis)
    if n == 1:
        return loss, grads
    flat, treedef = tree_flatten(grads)
    for g, d in zip(flat, shards.dims, strict=True):
        if d is None:
            all_reduce(g, shards.mesh, shards.axis)
    loss = all_reduce(loss.clone(), shards.mesh, shards.axis)
    return loss / n, tree_unflatten(treedef, [g / n for g in flat])


def loss_and_grads(plan, params, batch: dict, n_microbatches: int = 1, shards=None):
    """``(loss, grads)`` of ``train_loss`` at ``params`` (grads in the params'
    dtypes at one microbatch; the fp32 mean of the microbatches' gradients,
    and the mean loss, otherwise).  ``shards``: the params' layout over a
    data mesh; ``params`` and ``batch`` are then this rank's blocks and the
    result is the mean over every data rank's batch (module docstring)."""
    if n_microbatches == 1:
        loss, grads = _value_and_grad(plan, params, batch, shards)
    else:
        tot, g_acc = None, None
        for mb in _split_mb(batch, n_microbatches):
            loss, grads = _value_and_grad(plan, params, mb, shards)
            g = [x.to(torch.float32) for x in tree_flatten(grads)[0]]
            tot = loss if tot is None else tot + loss
            g_acc = g if g_acc is None else [a + b for a, b in zip(g_acc, g)]
        treedef = tree_flatten(params)[1]
        loss, grads = tot / n_microbatches, tree_unflatten(treedef,
                                                           [a / n_microbatches for a in g_acc])
    if shards is None:
        return loss, grads
    return _data_parallel_mean(loss, grads, shards)


def make_train_step(plan, opt_cfg: AdamWConfig, n_microbatches: int = 1, grad_shardings=None):
    """Returns ``train_step(params, opt_state, batch) → (params', state',
    metrics)``; metrics hold ``loss``, ``grad_norm`` and ``lr`` as tensors.
    ``grad_shardings``: the params' :class:`~repro_torch.dist.sharding.TreeShards`
    over a data (and model) mesh (see the module docstring)."""

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(plan, params, batch, n_microbatches, grad_shardings)
        new_params, new_state, metrics = adamw_update(params, grads, opt_state, opt_cfg,
                                                      shards=grad_shardings)
        return new_params, new_state, dict(metrics, loss=loss)

    return train_step
