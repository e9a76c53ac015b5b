"""CUDA wrapper: the dequantizing serving GEMM (replaces
``dequant_matmul_pallas``).

``y = x @ ((codes − z)·s)ᵀ`` with fp32 accumulation, codes uint8 or packed
two per byte (linear layout), per-channel or grouped grids with any group
size.  Three variants (see ``csrc/dequant_matmul.cu``), chosen by
:func:`plan_dequant_matmul` from the shapes and dtypes alone:

* ``tc_large``: bf16 ``x``, ``m > SMALL_M_MAX`` (and small m with a group
  size that is not a multiple of 128); 128 × 128 tiles on the tensor cores
  (``mma.sync`` bf16, fp32 sums), k split where the tiles do not fill the
  card;
* ``tc_small``: bf16 ``x``, ``m <= SMALL_M_MAX`` (decode); channels on the
  MMA's 16-row side, tokens on its 8-wide side, k split into slices whose
  fp32 partials a second kernel sums in a fixed order;
* ``simt``: fp32 ``x``, or a group size that is not a multiple of 16; the
  fp32 SIMT kernel.

The dispatch is explicit: a variant that fails to build or launch raises,
and nothing falls back.

**Precondition of the tensor-core variants**: every zero point is an
integer in ``[0, 2^bits − 1]``, so ``c − z`` is an exact bf16 integer and
the scale factors out of each group's sum.  Every grid the port or the
reference makes satisfies it; it is checked once on the host where an
artifact enters the port (``serve.qparams.quantize_params_for_serving``,
``interop.qtensor_from_jax``, through
:func:`repro_torch.quant.qtensor.check_zero_points`), not per call.

Counts its launches in ``.launches`` and per variant in
``.launches_by_variant``; CUDA tensors only.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

__all__ = ["VARIANTS", "SMALL_M_MAX", "plan_dequant_matmul", "split_for", "split_slices",
           "grid_ctas", "dequant_matmul_cuda"]

_FLOATS = (torch.float32, torch.bfloat16)
VARIANTS = ("simt", "tc_large", "tc_small")  # their codes in the C entry: 0, 1, 2
# Largest m the decode tile takes.  At m <= 64 one CTA holds every token (a
# warp's n8 tiles cover 64), so the packed codes are read once; at m = 128
# tc_large is the faster (chip_smoke.py phase 3 times both; PERF.md).
SMALL_M_MAX = 64
SPLIT_QUANTUM = 128  # split-K slices are multiples of this many k
LARGE_TILE = 128  # tc_large: 128 rows of x × 128 channels per CTA
SMALL_CHANNELS, SMALL_TOKENS = 64, 64  # tc_small: channels and tokens per CTA


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_slices(p: int, split: int) -> list:
    """The k ranges ``[lo, hi)`` of the ``split`` slices, as the kernels cut
    them: ``ceil(ceil(p/128)/split)·128`` k each, the last one short."""
    kps = _cdiv(_cdiv(p, SPLIT_QUANTUM), split) * SPLIT_QUANTUM
    return [(s * kps, min(p, (s + 1) * kps)) for s in range(split)]


def grid_ctas(variant: str, m: int, q: int, split: int) -> int:
    """CTAs a tensor-core variant launches for an ``(m, q)`` output (not the
    reduce)."""
    if variant == "tc_large":
        return _cdiv(m, LARGE_TILE) * _cdiv(q, LARGE_TILE) * split
    return _cdiv(q, SMALL_CHANNELS) * _cdiv(m, SMALL_TOKENS) * split


def split_for(variant: str, m: int, q: int, p: int, n_sm: int) -> int:
    """Slices of k for ``variant``, in 128-multiples with none empty.

    ``tc_small`` splits until the grid holds two CTAs per SM.  ``tc_large``
    (one CTA per SM) splits only to about three quarters of the SMs, since
    each slice adds ``m·q`` fp32 partials to write and read back: at m = 128
    that cuts Phi-3-mini's three shapes 5, 2 and 5 ways."""
    target = 2 * n_sm if variant == "tc_small" else 3 * n_sm // 4
    steps = _cdiv(p, SPLIT_QUANTUM)
    split = min(max(1, _cdiv(target, grid_ctas(variant, m, q, 1))), steps)
    return _cdiv(steps, _cdiv(steps, split))


@functools.lru_cache(maxsize=4096)
def plan_dequant_matmul(m: int, q: int, p: int, group_size, x_dtype, n_sm: int) -> tuple:
    """``(variant, split)`` for one call.  ``group_size`` is None for a
    per-channel grid (one group per row).

    fp32 ``x`` and group sizes that are not a multiple of 16 go to ``simt``.
    bf16 ``x`` goes to ``tc_small`` at ``m <= SMALL_M_MAX`` where its 128-k
    super-step lies inside one group (per-channel, or ``group_size % 128 ==
    0``), else to ``tc_large``; :func:`split_for` cuts k."""
    grouped = group_size is not None
    if x_dtype != torch.bfloat16 or (grouped and group_size % 16):
        return "simt", 1
    small = m <= SMALL_M_MAX and (not grouped or group_size % SPLIT_QUANTUM == 0)
    variant = "tc_small" if small else "tc_large"
    return variant, split_for(variant, m, q, p, n_sm)


def _require(cond: bool, msg: str, *args) -> None:
    """Raise ``ValueError(msg.format(*args))`` unless ``cond``; the message
    is formatted only on a refusal (a call's host time is what a decode step
    waits on)."""
    if not cond:
        raise ValueError(msg.format(*args))


def dequant_matmul_cuda(
    x, codes, scale, zero, *, packed4: bool = False, out_dtype=torch.bfloat16, group_size=None,
    plan=None,
):
    """x: ``(m, p)`` fp32/bf16; codes ``(q, p)`` uint8 or ``(q, p/2)`` packed;
    scale/zero ``(q,)`` or ``(q, n_groups)`` fp32, zero points integers in
    ``[0, 2^bits − 1]`` (see the module note).  Returns ``(m, q)``.

    ``plan``: ``(variant, split)`` instead of :func:`plan_dequant_matmul`'s
    choice (tests and ``chip_smoke.py`` pin a variant or a split with it); a
    variant that does not take these operands raises."""
    dev = x.device
    _require(dev.type == "cuda", "dequant_matmul_cuda takes CUDA tensors")
    for name, t in (("codes", codes), ("scale", scale), ("zero", zero)):
        _require(t.device == dev, "{} is on {}, expected {}", name, t.device, dev)
    _require(x.dim() == 2 and x.dtype in _FLOATS and x.is_contiguous(),
             "x must be a contiguous (m, p) float32/bfloat16 tensor")
    _require(out_dtype in _FLOATS, "out_dtype must be float32 or bfloat16, got {}", out_dtype)
    m, p = x.shape
    _require(codes.dim() == 2 and codes.dtype == torch.uint8 and codes.is_contiguous(),
             "codes must be a contiguous 2-D uint8 tensor")
    q = codes.shape[0]
    _require(codes.shape[1] * (2 if packed4 else 1) == p,
             "codes {} do not cover p={} (packed4={})", tuple(codes.shape), p, packed4)
    if scale.dim() == 1:
        scale, zero = scale[:, None], zero[:, None]
    _require(scale.dtype == torch.float32 and zero.dtype == torch.float32,
             "scale and zero must be float32")
    _require(scale.shape == zero.shape and scale.shape[0] == q, "scale/zero must be (q, n_groups)")
    scale, zero = scale.contiguous(), zero.contiguous()
    n_groups = scale.shape[1]
    gsz = group_size or -(-p // n_groups)
    _require(-(-p // gsz) == n_groups, "group_size={} gives {} groups, grid has {}",
             gsz, -(-p // gsz), n_groups)
    variant, split = plan or plan_dequant_matmul(
        m, q, p, gsz if n_groups > 1 else None, x.dtype, sm_count(dev.index))
    _require(variant in VARIANTS and split >= 1, "unknown plan {}", (variant, split))
    y = torch.empty(m, q, dtype=out_dtype, device=dev)
    ws = torch.empty(split * m * q, dtype=torch.float32, device=dev) if split > 1 else None
    err = build.load("dequant_matmul").dequant_matmul(
        x.data_ptr(), x.dtype == torch.bfloat16, codes.data_ptr(), packed4,
        scale.data_ptr(), zero.data_ptr(), y.data_ptr(), out_dtype == torch.bfloat16,
        m, q, p, n_groups, gsz, VARIANTS.index(variant), split, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream, dev.index,
    )
    build.check(err, f"dequant_matmul ({variant}, split {split})")
    dequant_matmul_cuda.launches += 1
    dequant_matmul_cuda.launches_by_variant[variant] += 1
    return y


dequant_matmul_cuda.launches = 0
dequant_matmul_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)
