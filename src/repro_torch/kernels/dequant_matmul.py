"""CUDA wrapper: the dequantizing serving GEMM (replaces
``dequant_matmul_pallas``).

``y = x @ ((codes − z)·s)ᵀ`` with fp32 accumulation, codes uint8 or packed
two per byte (linear layout), per-channel or grouped grids with any group
size.  See ``csrc/dequant_matmul.cu``.  Counts its launches in
``.launches``; CUDA tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["dequant_matmul_cuda"]

_FLOATS = (torch.float32, torch.bfloat16)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def dequant_matmul_cuda(
    x, codes, scale, zero, *, packed4: bool = False, out_dtype=torch.bfloat16, group_size=None
):
    """x: ``(m, p)`` fp32/bf16; codes ``(q, p)`` uint8 or ``(q, p/2)`` packed;
    scale/zero ``(q,)`` or ``(q, n_groups)`` fp32.  Returns ``(m, q)``."""
    dev = x.device
    _require(dev.type == "cuda", "dequant_matmul_cuda takes CUDA tensors")
    for name, t in (("codes", codes), ("scale", scale), ("zero", zero)):
        _require(t.device == dev, f"{name} is on {t.device}, expected {dev}")
    _require(x.dim() == 2 and x.dtype in _FLOATS and x.is_contiguous(),
             "x must be a contiguous (m, p) float32/bfloat16 tensor")
    _require(out_dtype in _FLOATS, f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    m, p = x.shape
    _require(codes.dim() == 2 and codes.dtype == torch.uint8 and codes.is_contiguous(),
             "codes must be a contiguous 2-D uint8 tensor")
    q = codes.shape[0]
    _require(codes.shape[1] * (2 if packed4 else 1) == p,
             f"codes {tuple(codes.shape)} do not cover p={p} (packed4={packed4})")
    if scale.dim() == 1:
        scale, zero = scale[:, None], zero[:, None]
    _require(scale.dtype == torch.float32 and zero.dtype == torch.float32,
             "scale and zero must be float32")
    _require(scale.shape == zero.shape and scale.shape[0] == q, "scale/zero must be (q, n_groups)")
    scale, zero = scale.contiguous(), zero.contiguous()
    n_groups = scale.shape[1]
    gsz = group_size or -(-p // n_groups)
    _require(-(-p // gsz) == n_groups, f"group_size={gsz} gives {-(-p // gsz)} groups, grid has {n_groups}")
    y = torch.empty(m, q, dtype=out_dtype, device=dev)
    lib = build.load("dequant_matmul")
    err = lib.dequant_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(), int(packed4),
        scale.data_ptr(), zero.data_ptr(), y.data_ptr(), int(out_dtype == torch.bfloat16),
        m, q, p, n_groups, gsz, torch.cuda.current_stream(dev).cuda_stream, dev.index,
    )
    build.check(err, "dequant_matmul")
    dequant_matmul_cuda.launches += 1
    return y


dequant_matmul_cuda.launches = 0
