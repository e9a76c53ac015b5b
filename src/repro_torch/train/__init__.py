"""Training: AdamW (fp32 or 8-bit moments), the train step, the trainer loop."""

from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
    lr_schedule,
    moment_axes,
)
from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "lr_schedule",
    "moment_axes",
    "loss_and_grads",
    "make_train_step",
    "Trainer",
    "TrainerConfig",
]
