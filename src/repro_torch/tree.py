"""Flatten and rebuild nested dicts/lists of tensors in the reference's leaf
order.

``jax.tree.flatten`` visits dict keys in sorted order, lists in order, and
treats ``None`` as an empty subtree.  The optimizer (leaf order of the
gradient norm's sum) and the checkpoints (``leaf_<i>.bin`` ↔ leaf i) need
exactly that order, so a state flattened here lines up leaf for leaf with
the reference's.  A dataclass registered with :func:`register_dataclass`
is a node whose children are its fields not marked ``static`` in their
metadata, in declaration order (a ``None`` field is an empty subtree), as
``jax.tree_util.register_dataclass`` makes it.
"""

from __future__ import annotations

import dataclasses

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "register_dataclass"]

_LEAF = object()
_DATA_FIELDS: dict[type, tuple[str, ...]] = {}


def register_dataclass(cls):
    """Make instances of the dataclass ``cls`` tree nodes (a decorator)."""
    _DATA_FIELDS[cls] = tuple(f.name for f in dataclasses.fields(cls)
                              if not f.metadata.get("static"))
    return cls


@dataclasses.dataclass(frozen=True)
class _Node:
    template: object  # the instance flattened: it carries the static fields
    children: tuple


def _walk(t, is_leaf, leaves):
    if t is None:
        return None
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        return _LEAF
    if type(t) in _DATA_FIELDS:
        return _Node(t, tuple(_walk(getattr(t, f), is_leaf, leaves) for f in _DATA_FIELDS[type(t)]))
    if isinstance(t, dict):
        d = {k: _walk(t[k], is_leaf, leaves) for k in sorted(t)}
        return {k: d[k] for k in t}  # keep the caller's key order
    if isinstance(t, (list, tuple)):
        return type(t)(_walk(v, is_leaf, leaves) for v in t)
    leaves.append(t)
    return _LEAF


def tree_flatten(tree, is_leaf=None) -> tuple[list, object]:
    """``(leaves, treedef)``; rebuild with :func:`tree_unflatten`.  Nodes for
    which ``is_leaf`` returns True are taken whole, as jax's ``is_leaf``.

    The walk is a module-level function, not a closure: a recursive closure
    is a reference cycle, and its ``leaves`` (gradients, a step's old
    params) would stay on the card until Python's cycle collector ran."""
    leaves = []
    return leaves, _walk(tree, is_leaf, leaves)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def _build(d, it):
    if d is None:
        return None
    if d is _LEAF:
        return next(it)
    if isinstance(d, _Node):
        fields = _DATA_FIELDS[type(d.template)]
        return dataclasses.replace(d.template, **{f: _build(c, it) for f, c in zip(fields, d.children)})
    if isinstance(d, dict):
        vals = {k: _build(d[k], it) for k in sorted(d)}
        return {k: vals[k] for k in d}
    return type(d)(_build(v, it) for v in d)


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`: ``leaves`` in the flatten order."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree holds")
    return out
