"""Logical-axis sharding rules, with divisibility fallbacks (the port's copy
of ``repro.dist.sharding``).

Model code names the dimensions of each parameter with logical axes
("embed", "heads", "ffn", ...; :func:`repro_torch.models.model.param_axes`).
This module owns the one mapping from those names to mesh axes:

* :func:`make_rules` builds a :class:`Rules` table for one mesh, checking
  the divisibility of every dimension it knows the size of and falling back
  to replication (or to another axis: ``head_dim`` when ``kv_heads`` does
  not divide the model axis) where a dimension does not fit.  It reads only
  the mesh's axis sizes, so it takes a
  :class:`torch.distributed.device_mesh.DeviceMesh` with named dims or a
  plain ``{name: size}`` mapping.
* :class:`Rules` resolves a logical-axes tuple to per-dimension entries (the
  reference's ``PartitionSpec``: a mesh axis, a tuple of them, or None) and
  to DTensor placements (``Shard(d)`` / ``Replicate()``, one per mesh dim).
  A mesh axis is used at most once per spec; a later use resolves to None.
* :meth:`Rules.tree_shards` gives a whole tree's layout over the data dim
  (:class:`TreeShards`: the dimension each flattened leaf is sharded on),
  what the data-parallel trainer, its train step and AdamW read.
* :func:`axis_rules` installs a Rules as the ambient table;
  :func:`logical_constraint` is the model-side entry point.  In the port a
  rank's tensor already is its data shard, so the constraint is the
  identity unless the mesh has a "model" axis larger than 1 (tensor
  parallelism, not ported).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Mapping
from typing import Optional, Union

__all__ = [
    "Rules",
    "make_rules",
    "axis_rules",
    "current_rules",
    "logical_constraint",
    "mesh_axis_size",
    "axis_sizes",
    "TreeShards",
    "TP_ROADMAP",
]

# A table value: one mesh axis, a tuple of mesh axes (batch over
# ("pod", "data")), or None (replicated).
_Entry = Union[str, tuple, None]

TP_ROADMAP = "tensor parallelism on a \"model\" axis is ROADMAP.md queue 1 item 8.1"


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh with named dims, a mapping, or
    any object whose ``.shape`` is such a mapping (the reference's stub)."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(getattr(mesh, "shape", None), Mapping):
        return dict(mesh.shape)
    raise TypeError(f"cannot read the axis sizes of {mesh!r}: give a DeviceMesh with "
                    "mesh_dim_names or a {name: size} mapping")


def mesh_axis_size(mesh, axes) -> int:
    """Product of the sizes of the named mesh axes (missing axes count 1)."""
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


@dataclasses.dataclass(frozen=True)
class TreeShards:
    """A tree's layout over the mesh dim ``axis``: ``dims[i]`` is the
    dimension leaf i (in :func:`repro_torch.tree.tree_flatten` order) is
    sharded on, in equal contiguous blocks in rank order, or None where
    every rank holds it whole."""

    mesh: object
    dims: tuple
    axis: str = "data"


@dataclasses.dataclass(frozen=True)
class Rules:
    """Resolved logical-axis → mesh-axis table for one mesh."""

    mesh: object
    table: dict

    def spec(self, axes: tuple) -> tuple:
        """A logical-axes tuple → one entry per dimension (a mesh axis, a
        tuple of mesh axes, or None).  Each mesh axis is used at most once:
        a later logical axis that maps to one already used resolves to None
        (replicated on that dimension)."""
        used: set = set()
        out = []
        for name in axes:
            entry: _Entry = self.table.get(name) if name is not None else None
            if entry is None:
                out.append(None)
                continue
            members = (entry,) if isinstance(entry, str) else tuple(entry)
            free = tuple(m for m in members if m not in used)
            used.update(free)
            if not free:
                out.append(None)
            elif len(free) == 1:
                out.append(free[0])
            else:
                out.append(free)
        return tuple(out)

    def placements(self, axes: tuple) -> tuple:
        """The DTensor placements of a leaf with logical ``axes`` on the
        rules' mesh: for each mesh dim, ``Shard(d)`` where the spec puts
        that mesh axis on tensor dimension d, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {}
        for d, entry in enumerate(self.spec(axes)):
            for m in ((entry,) if isinstance(entry, str) else entry or ()):
                dim_of[m] = d
        return tuple(Shard(dim_of[m]) if m in dim_of else Replicate()
                     for m in axis_sizes(self.mesh))

    def shard_dim(self, axes: tuple, mesh_axis: str = "data") -> Optional[int]:
        """The tensor dimension ``mesh_axis`` shards a leaf of logical
        ``axes`` on, or None where the leaf is replicated over it."""
        for d, entry in enumerate(self.spec(axes)):
            if entry == mesh_axis or (isinstance(entry, tuple) and mesh_axis in entry):
                return d
        return None

    def tree_shards(self, axes_tree, mesh_axis: str = "data") -> TreeShards:
        """The layout over ``mesh_axis`` of a tree whose leaves have the
        logical axes of ``axes_tree`` (tuples as leaves)."""
        from repro_torch.tree import tree_flatten

        flat = tree_flatten(axes_tree, is_leaf=lambda x: isinstance(x, tuple))[0]
        return TreeShards(self.mesh, tuple(self.shard_dim(tuple(a), mesh_axis) for a in flat),
                          mesh_axis)


def make_rules(
    mesh,
    *,
    n_heads: int = 0,
    n_kv_heads: int = 0,
    head_dim: int = 0,
    d_ff: int = 0,
    n_experts: int = 0,
    vocab: int = 0,
    d_model: int = 0,
    moe_ff: int = 0,
    ssm_heads: int = 0,
    fsdp: bool = False,
    seq_sharded_cache: bool = False,
    extra: Optional[dict] = None,
) -> Rules:
    """The rules table for ``mesh`` (the reference's, entry for entry).

    Sizes are the global dimension carried under each logical name; 0 means
    unknown and maps to replicated.  ``extra`` entries override or extend
    the base table verbatim.
    """
    sizes = axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    data_n = sizes.get("data", 1)

    def fits(n: int) -> bool:
        return n > 0 and n % model_n == 0

    kv_on_model = fits(n_kv_heads)
    experts_on_model = fits(n_experts)
    table: dict = {
        "batch": data_axes or None,
        "layers": None,
        "heads": "model" if fits(n_heads) else None,
        "kv_heads": "model" if kv_on_model else None,
        # Where the kv heads do not divide the model axis, shard head_dim.
        "head_dim": "model" if (not kv_on_model and fits(head_dim)) else None,
        "ffn": "model" if fits(d_ff) else None,
        "experts": "model" if experts_on_model else None,
        # Expert parallelism where the experts divide, else the per-expert ffn.
        "expert_ffn": None
        if experts_on_model
        else ("model" if (moe_ff == 0 or fits(moe_ff)) else None),
        "vocab": "model" if fits(vocab) else None,
        "ssm_heads": "model" if fits(ssm_heads) else None,
        # FSDP: parameters sharded over the data axis on their embed dim.
        "embed": ("data" if (fsdp and d_model and d_model % data_n == 0) else None),
        "seq_sp": "model",
        "cache_seq": "model" if seq_sharded_cache else None,
    }
    if extra:
        table.update(extra)
    return Rules(mesh=mesh, table=table)


# ---------------------------------------------------------------------------
# Ambient rules context
# ---------------------------------------------------------------------------

_state = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: Optional[Rules]):
    """Install ``rules`` as the ambient table (None: constraints no-op)."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def logical_constraint(x, axes: tuple):
    """The identity where no rules are active or the rules' mesh has no
    "model" axis larger than 1: each rank's tensor already is its data
    shard.  A larger "model" axis needs tensor parallelism, not ported."""
    rules = current_rules()
    if rules is None or axis_sizes(rules.mesh).get("model", 1) <= 1:
        return x
    raise NotImplementedError(f"a \"model\" axis larger than 1 ({TP_ROADMAP})")
