"""Atomic step-directory checkpoints with dtype-exact, checksummed round trips
(the port's copy of ``repro.dist.checkpoint``, in the same on-disk format).

Layout: ``<dir>/step_<N>/`` holds one raw-bytes blob per tree leaf, in the
reference's flatten order (sorted dict keys, :mod:`repro_torch.tree`), and
``manifest.json`` (step, user meta, each leaf's shape, dtype string and
CRC-32).  Writes go to ``step_<N>.tmp`` and are renamed into place only
after the manifest lands, so a half-written step is never taken for a
checkpoint; :func:`cleanup_tmp` sweeps orphans at restart.  A checkpoint
written by either package loads in the other, bit for bit.

Leaves are raw ``tobytes`` buffers.  bfloat16 leaves, which numpy has no
dtype for without ``ml_dtypes``, are written and read as their ``uint16``
bit patterns under the reference's dtype string ``"bfloat16"``.

A ``QuantizedTensor`` is stored as its array fields (the reference's
pytree order); its static fields (bits, layout) come from ``like`` at load,
since neither package's manifest records them: a tile-native file read
with a linear template is mis-read, in both.  A leaf that ``like`` gives
the reference's tile-native pack layout is un-prepacked to the linear
layout as it loads (an exact column permutation), since the port's
dequant-GEMM reads the linear layout.

Corruption: each leaf's CRC-32 is taken over the bytes the writer intended
(before any injected corruption) and checked on read; a mismatch raises
:class:`CheckpointCorrupt`.  :func:`load_last_good` walks the steps newest
first, skipping damaged ones.  Each shard write consults
``fault_point("ckpt.write")`` (``corrupt`` flips one seeded byte of the
shard on disk) and each shard read ``fault_point("ckpt.read")``.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.faults import active_plan, corrupt_bytes, fault_point
from repro_torch.quant.qtensor import as_linear_layout
from repro_torch.tree import tree_flatten, tree_unflatten

__all__ = [
    "CheckpointCorrupt",
    "save_checkpoint",
    "load_checkpoint",
    "load_last_good",
    "latest_step",
    "list_steps",
    "cleanup_tmp",
]

_MANIFEST = "manifest.json"


class CheckpointCorrupt(Exception):
    """A shard's bytes do not match its manifest checksum (or the step is
    otherwise unreadable in a way that indicates damage, not absence)."""


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}")


def _dtype_name(dtype) -> str:
    """The reference's dtype string of a torch or numpy dtype."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    if isinstance(dtype, torch.dtype):
        return str(torch.empty(0, dtype=dtype).numpy().dtype)
    return str(np.dtype(dtype))


def _leaf_bytes(leaf) -> tuple[bytes, list, str]:
    """One leaf (tensor, numpy array or scalar) → (raw bytes, shape, dtype string)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), list(t.shape), name
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _leaf_tensor(raw: bytes, rec: dict) -> torch.Tensor:
    if rec["dtype"] == "bfloat16":
        a = np.frombuffer(raw, dtype=np.uint16).reshape(rec["shape"])
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    a = np.frombuffer(raw, dtype=np.dtype(rec["dtype"])).reshape(rec["shape"])
    return torch.from_numpy(a.copy())


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, meta: Optional[dict] = None):
    """Write ``tree`` as ``step_<step>`` atomically (tmp dir + rename)."""
    leaves, _ = tree_flatten(tree)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    records = []
    for i, leaf in enumerate(leaves):
        data, shape, dtype = _leaf_bytes(leaf)
        # Checksum the intended bytes BEFORE any injected corruption: the
        # read side must be able to prove what landed on disk is wrong.
        crc = zlib.crc32(data)
        if fault_point("ckpt.write") == "corrupt":
            data = corrupt_bytes(active_plan(), data)
        with open(os.path.join(tmp, f"leaf_{i}.bin"), "wb") as f:
            f.write(data)
        records.append({"shape": shape, "dtype": dtype, "crc32": crc})
    manifest = {"step": step, "meta": meta or {}, "leaves": records}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    # Re-saving an existing step: move the old dir aside first, so a valid
    # old or new step_<N> exists at every moment; cleanup_tmp sweeps a
    # crash's leftovers.
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.replace(final, old)
    os.replace(tmp, final)
    shutil.rmtree(old, ignore_errors=True)


def load_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None):
    """Restore the tree saved at ``step`` (default: the latest).

    ``like`` supplies the tree structure; leaf dtypes and shapes come from
    the manifest and are checked against ``like``'s tensors.  Each restored
    leaf is a tensor on the device of ``like``'s leaf (the CPU where that
    leaf is not a tensor).  Shard bytes are verified against the manifest's
    CRC-32; a mismatch raises :class:`CheckpointCorrupt`.  Returns
    ``(tree, manifest)``.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    flat_like, treedef = tree_flatten(like)
    recs = manifest["leaves"]
    if len(recs) != len(flat_like):
        raise ValueError(f"checkpoint has {len(recs)} leaves, template has {len(flat_like)}")
    out = []
    for i, rec in enumerate(recs):
        like_leaf = flat_like[i]
        if hasattr(like_leaf, "shape") and tuple(like_leaf.shape) != tuple(rec["shape"]):
            raise ValueError(
                f"leaf {i}: checkpoint shape {rec['shape']} != template shape "
                f"{tuple(like_leaf.shape)}"
            )
        if hasattr(like_leaf, "dtype") and _dtype_name(like_leaf.dtype) != rec["dtype"]:
            raise ValueError(
                f"leaf {i}: checkpoint dtype {rec['dtype']} != template dtype "
                f"{_dtype_name(like_leaf.dtype)}"
            )
        fault_point("ckpt.read")
        with open(os.path.join(d, f"leaf_{i}.bin"), "rb") as f:
            raw = f.read()
        if "crc32" in rec and zlib.crc32(raw) != rec["crc32"]:
            raise CheckpointCorrupt(
                f"{d}/leaf_{i}.bin: content checksum mismatch "
                f"(crc32 {zlib.crc32(raw)} != manifest {rec['crc32']}): "
                "shard corrupted on disk"
            )
        t = _leaf_tensor(raw, rec)
        out.append(t.to(like_leaf.device) if isinstance(like_leaf, torch.Tensor) else t)
    return as_linear_layout(tree_unflatten(treedef, out)), manifest


def load_last_good(ckpt_dir: str, like: Any):
    """Restore the newest checkpoint that verifies, skipping damaged steps.

    Corrupt or unreadable steps (checksum mismatch, missing shard,
    undecodable manifest, template mismatch) are recorded and skipped.
    Returns ``(tree, manifest, skipped)`` with ``skipped`` a list of
    ``(step, reason)``.  Raises :class:`FileNotFoundError` when no step
    exists, :class:`CheckpointCorrupt` when none verifies.
    """
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    skipped: list[tuple] = []
    for step in reversed(steps):
        try:
            tree, manifest = load_checkpoint(ckpt_dir, like, step=step)
            return tree, manifest, skipped
        except (CheckpointCorrupt, ValueError, OSError, json.JSONDecodeError) as e:
            skipped.append((step, f"{type(e).__name__}: {e}"))
    raise CheckpointCorrupt(
        f"{ckpt_dir}: no loadable checkpoint: all {len(steps)} step(s) "
        f"damaged: {[s for s, _ in skipped]}"
    )


def list_steps(ckpt_dir: str) -> list:
    """All complete checkpoint steps under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith((".tmp", ".old")):
            if os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    continue
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Highest complete checkpoint step under ``ckpt_dir`` (None if none)."""
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def cleanup_tmp(ckpt_dir: str):
    """Remove orphaned ``step_*.tmp``/``step_*.old`` dirs from crashed writers.

    A ``step_N.old`` whose ``step_N`` is missing means the crash hit between
    the two renames of :func:`save_checkpoint`: it is restored, not deleted
    (the .tmp replacement is unproven; the .old was a committed checkpoint).
    """
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if name.startswith("step_") and name.endswith(".tmp"):
            shutil.rmtree(path, ignore_errors=True)
        elif name.startswith("step_") and name.endswith(".old"):
            final = path[: -len(".old")]
            if not os.path.exists(final):
                os.replace(path, final)
            else:
                shutil.rmtree(path, ignore_errors=True)
