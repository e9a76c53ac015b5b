"""Carry the JAX package's state into the port.

The functions take plain numpy arrays (``np.asarray`` of each JAX leaf), so
this module needs neither JAX nor ``ml_dtypes``: a bfloat16 leaf arrives as
an array whose dtype is named ``bfloat16`` and is read through a ``uint16``
view, then reinterpreted as ``torch.bfloat16``.  Each function puts the tensors
on ``device`` (default ``"cuda"``; raises without CUDA unless ``"cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant import QuantizedTensor, as_linear_layout, check_zero_points

__all__ = ["tensor_from_numpy", "qtensor_from_jax", "params_from_jax", "opt_state_from_jax"]

_QT_FIELDS = ("codes", "scale", "zero", "outlier_values", "outlier_idx",
              "outlier_col_idx", "outlier_col_vals")


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array (numpy, or anything ``np.asarray`` accepts) → tensor on
    ``device``, bit for bit."""
    device = resolve_device(device)
    a = np.asarray(a).copy(order="C")  # a C-contiguous copy; a 0-d array stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _is_qtensor(x) -> bool:
    return all(hasattr(x, f) for f in ("codes", "scale", "zero", "bits", "packed"))


def qtensor_from_jax(qt, device="cuda") -> QuantizedTensor:
    """A reference ``QuantizedTensor`` (read by attribute) → the port's, in
    the linear pack layout (a tile-native leaf is un-prepacked here, once:
    an exact column permutation).

    Raises ``ValueError`` if a zero point is not an integer in
    ``[0, 2^bits − 1]`` (the dequant-GEMM's precondition)."""
    device = resolve_device(device)
    arrays = {
        f: None if getattr(qt, f, None) is None else tensor_from_numpy(getattr(qt, f), device)
        for f in _QT_FIELDS
    }
    out = QuantizedTensor(
        bits=int(qt.bits), group_size=qt.group_size, packed=bool(qt.packed),
        pack_layout=getattr(qt, "pack_layout", "linear"), pack_tile=getattr(qt, "pack_tile", None),
        **arrays,
    )
    check_zero_points(out)
    return as_linear_layout(out)


_MAMBA_CACHE_FIELDS = ("conv_x", "conv_bc", "ssm")


def params_from_jax(tree, device="cuda"):
    """A reference param or cache tree (dicts, lists, arrays,
    QuantizedTensors, a Mamba block's ``MambaCache``) → the port's tree of
    tensors and QuantizedTensors on ``device``; a ``MambaCache`` (read by
    attribute) becomes the port's dict of its three leaves."""
    device = resolve_device(device)
    if _is_qtensor(tree):
        return qtensor_from_jax(tree, device)
    if all(hasattr(tree, f) for f in _MAMBA_CACHE_FIELDS):
        return {f: tensor_from_numpy(getattr(tree, f), device) for f in _MAMBA_CACHE_FIELDS}
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return tensor_from_numpy(tree, device)


def opt_state_from_jax(state, device="cuda") -> dict:
    """A reference AdamW state (``{"mu": ..., "count": ...}``, fp32 or int8
    moments, read as numpy) → the port's, on ``device``, bit for bit, so a
    step can be compared from a non-zero state."""
    if set(state) != {"mu", "count"}:
        raise ValueError(f"not an AdamW state: keys {sorted(state)}")
    return {"mu": params_from_jax(state["mu"], device),
            "count": tensor_from_numpy(state["count"], device)}
