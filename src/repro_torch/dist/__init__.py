"""Distribution: sharding rules over a DeviceMesh, the collectives of the
data-parallel paths, the int8 FSDP gather, checkpoints, and elastic
execution (the retrying runner and degraded-capacity meshes)."""

from repro_torch.dist.checkpoint import (
    CheckpointCorrupt,
    cleanup_tmp,
    latest_step,
    list_steps,
    load_checkpoint,
    load_last_good,
    save_checkpoint,
)
from repro_torch.dist.elastic import RetryingRunner, elastic_mesh
from repro_torch.dist.qgather import make_period_transform
from repro_torch.dist.sharding import (
    Rules,
    TreeShards,
    axis_rules,
    current_rules,
    logical_constraint,
    make_rules,
    mesh_axis_size,
)

__all__ = [
    "CheckpointCorrupt",
    "cleanup_tmp",
    "latest_step",
    "list_steps",
    "load_checkpoint",
    "load_last_good",
    "save_checkpoint",
    "RetryingRunner",
    "elastic_mesh",
    "make_period_transform",
    "Rules",
    "TreeShards",
    "axis_rules",
    "current_rules",
    "logical_constraint",
    "make_rules",
    "mesh_axis_size",
]
