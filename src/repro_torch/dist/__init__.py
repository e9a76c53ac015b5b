"""Checkpoints and the retrying runner of the single-host trainer.

The mesh side of the reference's ``dist/`` (sharding rules, ``elastic_mesh``,
the row-sharded solve) is not ported yet.
"""

from repro_torch.dist.checkpoint import (
    CheckpointCorrupt,
    cleanup_tmp,
    latest_step,
    list_steps,
    load_checkpoint,
    load_last_good,
    save_checkpoint,
)
from repro_torch.dist.elastic import RetryingRunner

__all__ = [
    "CheckpointCorrupt",
    "cleanup_tmp",
    "latest_step",
    "list_steps",
    "load_checkpoint",
    "load_last_good",
    "save_checkpoint",
    "RetryingRunner",
]
