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
* :meth:`Rules.tree_shards` gives a whole tree's layout over the data and
  model dims (:class:`TreeShards`: the dimension each flattened leaf is
  sharded on over each), what the trainer, its train step and AdamW read.
* :func:`axis_rules` installs a Rules as the ambient table;
  :func:`logical_constraint` is the model-side entry point.  Under explicit
  collectives a rank's tensor already is its shard (its data block, or its
  model-axis slice), so the constraint is the identity.
* :func:`model_axis` reads the ambient rules' mesh for the
  tensor-parallel forward pass (None where its "model" axis is 1),
  :func:`data_axis` for the batch split over "data", and
  :func:`shard_tree` cuts a whole params tree (dense or a quantized
  serving artifact) into one rank's local tree under a Rules.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Mapping
from typing import Optional, Union

import torch

__all__ = [
    "Rules",
    "make_rules",
    "axis_rules",
    "current_rules",
    "logical_constraint",
    "mesh_axis_size",
    "axis_sizes",
    "TreeShards",
    "model_axis",
    "data_axis",
    "shard_tree",
]

# A table value: one mesh axis, a tuple of mesh axes (batch over
# ("pod", "data")), or None (replicated).
_Entry = Union[str, tuple, None]


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
    """A tree's layout over the mesh dim ``axis`` (the data dim) and the
    "model" dim: ``dims[i]`` and ``model_dims[i]`` are the dimensions leaf i
    (in :func:`repro_torch.tree.tree_flatten` order) is sharded on over
    each, in equal contiguous blocks in rank order, or None where every
    rank of that dim holds it whole.  ``model_dims`` is None where the mesh
    has no "model" dim larger than 1.  A leaf is cut on "model" first, then
    on the data dim, and gathered in the reverse order."""

    mesh: object
    dims: tuple
    axis: str = "data"
    model_dims: Optional[tuple] = None

    def cuts(self) -> list:
        """``[(mesh dim, dims)]`` of the dims larger than 1 the tree is laid
        out over, the data dim first."""
        sizes = axis_sizes(self.mesh)
        out = [(self.axis, self.dims)] if sizes.get(self.axis, 1) > 1 else []
        if self.model_dims is not None:
            out.append(("model", self.model_dims))
        return out


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
        """The layout over ``mesh_axis`` and "model" of a tree whose leaves
        have the logical axes of ``axes_tree`` (tuples as leaves)."""
        from repro_torch.tree import tree_flatten

        flat = tree_flatten(axes_tree, is_leaf=lambda x: isinstance(x, tuple))[0]
        flat = [tuple(a) for a in flat]
        model = None
        if axis_sizes(self.mesh).get("model", 1) > 1:
            model = tuple(self.shard_dim(a, "model") for a in flat)
        return TreeShards(self.mesh, tuple(self.shard_dim(a, mesh_axis) for a in flat), mesh_axis,
                          model)


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
    """The identity: under the port's explicit collectives a rank's tensor
    already is its shard (its data block, or its slice of a "model" axis).
    The reference's GSPMD constraints become the collectives of the
    tensor-parallel forward pass (:mod:`repro_torch.models.model`)."""
    return x


def model_axis():
    """The ambient rules' mesh where its "model" axis is larger than 1, else
    None (no rules active, or an axis of 1).  The mesh must be a DeviceMesh:
    its "model" process group carries the tensor-parallel collectives."""
    rules = current_rules()
    if rules is None:
        return None
    n = axis_sizes(rules.mesh).get("model", 1)
    if n <= 1:
        return None
    if not hasattr(rules.mesh, "get_group"):
        raise ValueError(f"a \"model\" axis of {n} runs on a DeviceMesh with named dims, "
                         f"whose process group carries the collectives; got {rules.mesh!r}")
    return rules.mesh


def data_axis():
    """The ambient rules' mesh where its "data" axis is larger than 1, else
    None.  The batch is then split over it (data-parallel training), and a
    layer that mixes tokens across the batch (the MoE layer's dispatch and
    router loss) reads the whole batch through that axis."""
    rules = current_rules()
    if rules is None or axis_sizes(rules.mesh).get("data", 1) <= 1:
        return None
    return rules.mesh


def _rows(t, lo: int, n: int, dim: int):
    """A copy of ``t``'s ``[lo, lo + n)`` along ``dim``, in storage of its own
    (a view would keep the whole tensor's bytes alive)."""
    return t.narrow(dim, lo, n).clone(memory_format=torch.contiguous_format)


def _split(size: int, n: int, path: str, what: str) -> int:
    if size % n:
        raise ValueError(f"{path}: {what} of {size} does not split over {n} ranks")
    return size // n


def _coo_part(idx, vals, p: int, owned, rebase):
    """The COO entries (flat ``row·p + col``) a rank owns, per leading slice
    (a period), in their order, as planes padded to the largest count with
    (index 0, value 0) entries, additive no-ops.  ``owned(row, col)``
    selects, ``rebase(row, col)`` gives the local flat index."""
    lead, s = idx.shape[:-1], idx.shape[-1]
    i2, v2 = idx.reshape(-1, s).long(), vals.reshape(-1, s)
    row, col = i2 // p, i2 % p
    mask = owned(row, col)
    new = torch.where(mask, rebase(row, col), torch.zeros_like(i2))
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    m = int(mask.sum(1).max()) if mask.numel() else 0
    keep = torch.gather(mask, 1, order)[:, :m]
    new = torch.gather(new, 1, order)[:, :m].where(keep, torch.zeros((), dtype=i2.dtype))
    v = torch.gather(v2, 1, order)[:, :m]
    v = v.where(keep, torch.zeros((), dtype=v.dtype))
    return new.to(idx.dtype).reshape(*lead, m).clone(), v.reshape(*lead, m).clone()


def _shard_qt(qt, axes: dict, rules: Rules, n: int, rank: int, mesh_axis: str, path: str):
    """One rank's QuantizedTensor: a leaf cut on a lead axis (an MoE
    matrix's experts) keeps its block of every plane; a column-parallel leaf
    (out rows on the axis) keeps its rows of codes, grid and outlier planes;
    a row-parallel leaf (in columns on the axis) keeps its columns of codes,
    its grid's groups (a per-channel grid whole) and its COO entries,
    re-based."""
    import dataclasses

    dim = rules.shard_dim(tuple(axes["codes"]), mesh_axis)
    if dim is None:
        return qt
    nd = qt.codes.dim()
    q, p = qt.shape[-2:]
    if dim < nd - 2:  # a lead axis (the experts): every plane keeps the rank's block of it
        el = _split(qt.codes.shape[dim], n, path, f"dimension {dim}")
        return dataclasses.replace(qt, **{
            f.name: _rows(getattr(qt, f.name), rank * el, el, dim)
            for f in dataclasses.fields(qt) if isinstance(getattr(qt, f.name), torch.Tensor)})
    if qt.pack_layout != "linear":
        raise ValueError(f"{path}: tile-native codes; shard the linear layout "
                         "(quant.as_linear_layout)")
    if dim == nd - 2:
        ql = _split(q, n, path, "the out rows")
        r0 = rank * ql
        kw = dict(codes=_rows(qt.codes, r0, ql, nd - 2), scale=_rows(qt.scale, r0, ql, nd - 2),
                  zero=_rows(qt.zero, r0, ql, nd - 2))
        owned = lambda row, col: (row >= r0) & (row < r0 + ql)
        rebase = lambda row, col: (row - r0) * p + col
        if qt.outlier_col_vals is not None:
            kw["outlier_col_vals"] = _rows(qt.outlier_col_vals, r0, ql, nd - 2)
    elif dim == nd - 1:
        pl = _split(p, n, path, "the in columns")
        c0 = rank * pl
        kw = {}
        if qt.packed:
            per_byte = {2: 4, 4: 2}.get(qt.bits)
            if per_byte is None or pl % per_byte:
                raise ValueError(f"{path}: {qt.bits}-bit packed codes of {p} columns cut at column "
                                 f"{pl} over {n} ranks, inside a byte")
            kw["codes"] = _rows(qt.codes, c0 // per_byte, pl // per_byte, nd - 1)
        else:
            kw["codes"] = _rows(qt.codes, c0, pl, nd - 1)
        if qt.group_size:
            if pl % qt.group_size:
                raise ValueError(f"{path}: group_size {qt.group_size} does not give each of {n} "
                                 f"ranks whole groups of its {pl} columns")
            g0, gl = c0 // qt.group_size, pl // qt.group_size
            kw["scale"] = _rows(qt.scale, g0, gl, nd - 1)
            kw["zero"] = _rows(qt.zero, g0, gl, nd - 1)
        if qt.outlier_col_idx is not None:
            raise ValueError(f"{path}: structured outlier columns of a row-parallel leaf do not "
                             "shard (a rank's columns differ in count from period to period)")
        owned = lambda row, col: (col >= c0) & (col < c0 + pl)
        rebase = lambda row, col: row * pl + col - c0
    else:
        raise ValueError(f"{path}: a QuantizedTensor shards on its out rows or in columns, "
                         f"not on dim {dim} of {nd}")
    if qt.outlier_idx is not None:
        kw["outlier_idx"], kw["outlier_values"] = _coo_part(qt.outlier_idx, qt.outlier_values,
                                                            p, owned, rebase)
    return dataclasses.replace(qt, **kw)


def shard_tree(tree, axes_tree, rules: Rules, *, rank: Optional[int] = None,
               mesh_axis: str = "model"):
    """This rank's local tree of a whole ``tree`` laid out by ``axes_tree``
    under ``rules``: each dimension the rules put on ``mesh_axis`` keeps the
    rank's contiguous block (a copy of its own), every other leaf stays
    whole (the same tensor).

    ``axes_tree`` is :func:`repro_torch.models.model.param_axes` for dense
    params, :func:`repro_torch.serve.qparams.qt_param_axes` for a serving
    artifact, whose QuantizedTensor leaves it describes by ``{"codes",
    "scale", "zero"}``.  Such a leaf shards as :func:`_shard_qt` says: an
    MoE matrix on its experts by its block of every plane, column-parallel
    leaves (out rows on "heads_fused", "kv_fused", "ffn",
    ...) by rows of codes, grid and outlier planes; row-parallel ones
    (``wo``, ``wd``: in columns on "heads_fused" or "ffn") by columns of
    codes, with a per-channel grid whole and a grouped one cut into whole
    groups (``ValueError`` naming the leaf where the groups, or packed
    4-bit bytes, would be cut), and the COO planes of a ``qe_outlier``
    artifact to the rank owning each entry, re-based to the local matrix
    and padded per period with (index 0, value 0) entries to the period
    with the most.  ``rank`` defaults to this process's coordinate on the
    rules' mesh."""
    from repro_torch.quant import QuantizedTensor

    n = mesh_axis_size(rules.mesh, mesh_axis)
    if rank is None:
        rank = rules.mesh.get_local_rank(mesh_axis) if n > 1 else 0

    def walk(node, axes, path):
        if isinstance(node, QuantizedTensor):
            if not isinstance(axes, dict):
                raise TypeError(f"{path}: a QuantizedTensor leaf needs the qt_param_axes layout "
                                f"{{codes, scale, zero}}, got {axes!r}")
            return _shard_qt(node, axes, rules, n, rank, mesh_axis, path)
        if isinstance(node, dict):
            if not isinstance(axes, dict) or set(axes) != set(node):
                raise ValueError(f"{path}: params and axes trees differ "
                                 f"({sorted(node)} against {axes!r})")
            return {k: walk(v, axes[k], f"{path}.{k}" if path else k) for k, v in node.items()}
        if not isinstance(axes, tuple) or len(axes) != node.dim():
            raise ValueError(f"{path}: axes {axes!r} for a tensor of shape {tuple(node.shape)}")
        dim = rules.shard_dim(axes, mesh_axis)
        if dim is None or n == 1:
            return node
        size = _split(node.shape[dim], n, path, f"dimension {dim}")
        return _rows(node, rank * size, size, dim)

    return walk(tree, axes_tree, "")
