"""Trainer: the train loop with atomic checkpoints and crash recovery (the
port's copy of ``repro.train.trainer``, single device).

Wires together the synthetic data pipeline, :func:`make_train_step`,
checkpoints (:mod:`repro_torch.dist.checkpoint`) and
:class:`~repro_torch.dist.elastic.RetryingRunner`.  A run resumes from the
newest checkpoint in ``ckpt_dir``; the data step is saved with it, so a
resumed run replays exactly the batches an uninterrupted one would.  The
mesh and FSDP options of the reference raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, make_batch_fn
from repro_torch.device import require_on_device, resolve_device
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.elastic import RetryingRunner
from repro_torch.models.model import init_params, make_plan
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import make_train_step

__all__ = ["TrainerConfig", "Trainer"]


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


class Trainer:
    """``params=`` starts from given weights (on ``device``) instead of the
    seeded init; ``device`` defaults to ``"cuda"``."""

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
    ):
        if mesh is not None or fsdp:
            raise NotImplementedError(
                "mesh=/fsdp=True: sharded training (the reference's dist/ sharding "
                "rules) is not ported yet; the port trains on one device"
            )
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.plan = make_plan(model_cfg)
        self.batch_fn, self.corpus = make_batch_fn(
            DataConfig(vocab=model_cfg.vocab, seed=tcfg.seed), model_cfg, tcfg.batch, tcfg.seq
        )
        if params is None:
            params = init_params(self.plan, tcfg.seed, device=self.device)
        else:
            require_on_device(params["embed"], self.device)
        self.params = params
        self.opt_state = adamw_init(params, opt_cfg)
        self.train_step = make_train_step(self.plan, opt_cfg, tcfg.n_microbatches)
        self.data_step = 0
        self.metrics_log: list[dict] = []

    def save(self, step: int):
        state = {"params": self.params, "opt": self.opt_state}
        ckpt.save_checkpoint(self.tcfg.ckpt_dir, step, state, meta={"data_step": self.data_step})

    def restore(self) -> int:
        like = {"params": self.params, "opt": self.opt_state}
        state, manifest = ckpt.load_checkpoint(self.tcfg.ckpt_dir, like)
        self.params, self.opt_state = state["params"], state["opt"]
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
            params, opt_state, metrics = self.train_step(params, opt_state, self.batch_fn(step))
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
