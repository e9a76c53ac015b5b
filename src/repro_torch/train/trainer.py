"""Trainer: the train loop with atomic checkpoints and crash recovery (the
port's copy of ``repro.train.trainer``).

Wires together the sharding rules (:mod:`repro_torch.dist.sharding`), the
synthetic data pipeline, :func:`make_train_step`, checkpoints
(:mod:`repro_torch.dist.checkpoint`) and
:class:`~repro_torch.dist.elastic.RetryingRunner`.  A run resumes from the
newest checkpoint in ``ckpt_dir``; the data step is saved with it, so a
resumed run replays exactly the batches an uninterrupted one would.

``mesh``: a DeviceMesh with a "data" dim, a "model" dim, or both
("data", "model"), over the ranks (one rank a device; every rank builds the
same Trainer).  The plan is padded for the "model" axis
(``make_plan(cfg, axis_n)``, the reference's), and params and moments are
laid out by :func:`train_rules` and ``moment_axes``: with ``fsdp`` each
leaf with an "embed" dimension is split over "data" on it (where
``d_model`` divides), and the heads, kv heads, ffn, experts (or each
expert's ffn), SSD heads and vocabulary split over "model" where they
divide it; everything else is whole.  Each rank takes the contiguous block
of each microbatch of every seeded global batch that its data coordinate
owns (the reference's ``_put_batch``; the ranks of one data coordinate take
the same rows) and the step averages over the data ranks
(:mod:`repro_torch.train.train_step`), inside the rules, so the model
axis' collectives run in the forward and backward passes.  ``save`` writes
the whole padded-plan state from rank (0, 0) in the reference's format, so
either package's loader reads it; ``restore`` loads on every rank and
re-shards.  Every family trains on a "model" axis: an encoder-decoder
model's batch carries its ``frames`` and a prefix model's its ``patches``,
whose rows go with their tokens to each data coordinate.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, make_batch_fn
from repro_torch.device import require_on_device, resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.collectives import axis_rank, axis_size, gather_dim, shard_dim
from repro_torch.dist.elastic import RetryingRunner
from repro_torch.dist.sharding import axis_rules, axis_sizes, make_rules
from repro_torch.models.model import init_params, make_plan, param_axes, param_shapes
from repro_torch.train.optimizer import AdamWConfig, adamw_init, moment_axes
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = ["TrainerConfig", "Trainer", "train_rules"]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 200
    batch: int = 8
    seq: int = 128
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    n_microbatches: int = 1
    seed: int = 0
    log_every: int = 10


def train_rules(plan, mesh, fsdp: bool = False):
    """The training rules of ``mesh`` for ``plan``: the reference trainer's
    ``make_rules`` arguments (``src/repro/train/trainer.py``), plus the
    per-expert ffn (``moe_ff``) and the SSD head count (``ssm_heads``), as
    ``serve.qparams.serving_rules`` passes them (``ROADMAP.md`` §3): so
    ``expert_ffn`` stays whole where neither the experts nor the per-expert
    ffn divide the "model" axis, and ``ssm_heads`` splits where the SSD
    heads divide it."""
    cfg, hp = plan.cfg, plan.heads
    return make_rules(mesh, n_heads=hp.h_pad, n_kv_heads=hp.n_kv, d_ff=cfg.d_ff,
                      n_experts=cfg.n_experts, vocab=plan.vocab_pad, d_model=cfg.d_model,
                      moe_ff=cfg.moe_ff, ssm_heads=cfg.ssm_nheads, fsdp=fsdp)


class Trainer:
    """``params=`` starts from given whole weights of the (padded) plan on
    ``device`` instead of the seeded init; ``device`` (this rank's) defaults
    to ``"cuda"``.  ``dispatch_groups`` goes into the plan
    (``make_plan(..., dispatch_groups=)``): every MoE layer routes each
    microbatch within that many token groups, a data rank's own where it is
    a multiple of the "data" axis (no gather of the routes)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        tcfg: TrainerConfig,
        mesh=None,
        fsdp: bool = False,
        *,
        params=None,
        device="cuda",
        dispatch_groups: int = 1,
    ):
        model_n = axis_sizes(mesh).get("model", 1)
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.plan = make_plan(model_cfg, model_n, dispatch_groups=dispatch_groups)
        self.n_data = axis_size(mesh)
        if tcfg.batch % (self.n_data * tcfg.n_microbatches):
            raise ValueError(f"batch {tcfg.batch} does not split into {tcfg.n_microbatches} "
                             f"microbatches over {self.n_data} data ranks")
        self.rules = self.shards = self.opt_shards = None
        if mesh is not None:
            self.rules = train_rules(self.plan, mesh, fsdp)
            axes = param_axes(self.plan)
            self.shards = self.rules.tree_shards(axes)
            self.opt_shards = self.rules.tree_shards(
                moment_axes(param_shapes(self.plan), axes, opt_cfg))
        self.batch_fn, self.corpus = make_batch_fn(
            DataConfig(vocab=model_cfg.vocab, seed=tcfg.seed), model_cfg, tcfg.batch, tcfg.seq
        )
        if params is None:
            params = init_params(self.plan, tcfg.seed, device=self.device)
        else:
            require_on_device(params["embed"], self.device)
        self.params = self._shard(params, self.shards)
        self.opt_state = adamw_init(self.params, opt_cfg)
        step_fn = make_train_step(self.plan, opt_cfg, tcfg.n_microbatches,
                                  grad_shardings=self.shards)

        def train_step(params, opt_state, batch):
            with axis_rules(self.rules):
                return step_fn(params, opt_state, batch)

        self.train_step = train_step
        self.data_step = 0
        self.metrics_log: list[dict] = []

    def _shard(self, tree, shards):
        """This rank's blocks of a whole tree laid out by ``shards``: cut on
        "model", then on "data"."""
        if shards is None:
            return tree
        flat, treedef = tree_flatten(tree)
        for axis, dims in reversed(shards.cuts()):
            flat = [t if d is None else shard_dim(t, d, self.mesh, axis)
                    for t, d in zip(flat, dims, strict=True)]
        return tree_unflatten(treedef, flat)

    def _whole(self, tree, shards):
        """The whole tensors of a tree laid out by ``shards``: gathered over
        "data", then over "model" (every rank must call it)."""
        if shards is None:
            return tree
        flat, treedef = tree_flatten(tree)
        for axis, dims in shards.cuts():
            flat = [t if d is None else gather_dim(t, d, self.mesh, axis)
                    for t, d in zip(flat, dims, strict=True)]
        return tree_unflatten(treedef, flat)

    def _put_batch(self, batch: dict) -> dict:
        """The rows of a global batch that this rank's data coordinate owns:
        its contiguous block of each microbatch (the reference's microbatch
        i is the global rows ``[i·B/m, (i+1)·B/m)``), in microbatch order;
        with one microbatch, its block of the batch."""
        if self.mesh is None:
            return batch
        m = self.tcfg.n_microbatches
        per, lo = self.tcfg.batch // (m * self.n_data), axis_rank(self.mesh, "data")
        rows = [i * (self.tcfg.batch // m) + (lo * per) + j for i in range(m) for j in range(per)]
        return {k: v[rows] for k, v in batch.items()}

    def save(self, step: int):
        """Write the whole state from rank (0, 0) of the mesh (every rank
        must call it)."""
        state = {"params": self._whole(self.params, self.shards),
                 "opt": self._whole(self.opt_state, self.opt_shards)}
        if self.mesh is None or all(axis_rank(self.mesh, a) == 0
                                    for a in self.mesh.mesh_dim_names):
            ckpt.save_checkpoint(self.tcfg.ckpt_dir, step, state,
                                 meta={"data_step": self.data_step})
        if self.mesh is not None:
            # A barrier over each mesh dim in turn: no rank passes the last
            # before rank (0, 0) has written.
            for axis in self.mesh.mesh_dim_names:
                dist.barrier(group=self.mesh.get_group(axis))

    def restore(self) -> int:
        like = {"params": self._whole(self.params, self.shards),
                "opt": self._whole(self.opt_state, self.opt_shards)}
        state, manifest = ckpt.load_checkpoint(self.tcfg.ckpt_dir, like)
        self.params = self._shard(state["params"], self.shards)
        self.opt_state = self._shard(state["opt"], self.opt_shards)
        self.data_step = manifest["meta"]["data_step"]
        return manifest["step"]

    def run(self, fault_hook=None) -> dict:
        tcfg = self.tcfg
        ckpt.cleanup_tmp(tcfg.ckpt_dir)
        start = 0
        if ckpt.latest_step(tcfg.ckpt_dir) is not None:
            start = self.restore()

        def do_step(state, step):
            params, opt_state = state
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         self._put_batch(self.batch_fn(step)))
            self.params, self.opt_state = params, opt_state
            self.data_step = step + 1
            if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                self.metrics_log.append(m)
            if (step + 1) % tcfg.ckpt_every == 0:
                self.save(step + 1)
            return (params, opt_state)

        def restore_state():
            step = self.restore() if ckpt.latest_step(tcfg.ckpt_dir) is not None else 0
            return (self.params, self.opt_state), step

        runner = RetryingRunner(step_fn=do_step, restore_fn=restore_state, fault_hook=fault_hook)
        state, _ = runner.run((self.params, self.opt_state), start, tcfg.steps - start)
        self.params, self.opt_state = state
        return {
            "final_loss": self.metrics_log[-1]["loss"] if self.metrics_log else None,
            "recoveries": runner.recoveries,
            "log": self.metrics_log,
        }
