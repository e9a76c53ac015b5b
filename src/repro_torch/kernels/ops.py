"""Dispatch for the port's kernels.

A tensor on the CPU goes to the plain PyTorch version in :mod:`.ref`; a
CUDA tensor goes to the hand-written kernel, which raises on what it does
not take.  There is no fallback from a CUDA tensor to the plain version.
The serving wrappers (:func:`dequant_matmul`, :func:`paged_attention`) arm
the ``kernel.dispatch`` fault site, as the reference does: a ``"deny"`` is
recorded in the plan's ``fired`` trail; on the CPU the call takes the
plain version, as the reference's denied call does, and on the card it
raises :class:`DispatchDenied` without launching.

:data:`KERNELS` names every ported kernel with its wrapper, its source and
the TPU kernel it replaces; :func:`launch_counts` reads the wrappers'
launch counters (the dequant-GEMM's wrapper also counts per variant in
``dequant_matmul_cuda.launches_by_variant``).
"""

from __future__ import annotations

import torch

from repro_torch.faults import PermanentFault, active_plan, fault_point
from repro_torch.kernels import ref
from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.quantease_cd import (
    block_sweep_cuda,
    fused_iteration_cuda,
    outlier_iteration_cuda,
)

__all__ = [
    "KERNELS",
    "DispatchDenied",
    "quantease_block_sweep",
    "quantease_fused_iteration",
    "quantease_outlier_iteration",
    "dequant_matmul",
    "dequant_matmul_experts",
    "paged_attention",
    "launch_counts",
    "reset_launch_counts",
]

# name → (wrapper, source in the repository, the Pallas kernel it replaces)
KERNELS = {
    "quantease_block_sweep": (
        block_sweep_cuda,
        "src/repro_torch/kernels/csrc/quantease_cd.cu",
        "src/repro/kernels/quantease_cd.py:98",
    ),
    "quantease_fused_iteration": (
        fused_iteration_cuda,
        "src/repro_torch/kernels/csrc/quantease_cd.cu",
        "src/repro/kernels/quantease_cd.py:222",
    ),
    "quantease_outlier_iteration": (
        outlier_iteration_cuda,
        "src/repro_torch/kernels/csrc/quantease_cd.cu",
        "src/repro/kernels/quantease_cd.py:452",
    ),
    "dequant_matmul": (
        dequant_matmul_cuda,
        "src/repro_torch/kernels/csrc/dequant_matmul.cu",
        "src/repro/kernels/dequant_matmul.py:103",
    ),
    "paged_attention": (
        paged_attention_cuda,
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:130",
    ),
}


def launch_counts() -> dict:
    return {name: w.launches for name, (w, _, _) in KERNELS.items()}


def reset_launch_counts() -> None:
    for w, _, _ in KERNELS.values():
        w.launches = 0
        for v in getattr(w, "launches_by_variant", {}):
            w.launches_by_variant[v] = 0


def _on_cpu(*tensors) -> bool:
    """True if every tensor is on the CPU, False if all are on CUDA."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        return False
    raise ValueError(f"kernel operands span devices {sorted(types)}; expected all cpu or all cuda")


class DispatchDenied(PermanentFault):
    """A ``"deny"`` at ``kernel.dispatch`` on card tensors: the port has no
    plain path on the card, so the denied call fails instead of degrading."""


def _serving_on_cpu(*tensors) -> bool:
    """:func:`_on_cpu` behind the ``kernel.dispatch`` fault site."""
    on_cpu = _on_cpu(*tensors)
    if fault_point("kernel.dispatch") == "deny" and not on_cpu:
        raise DispatchDenied("kernel.dispatch", active_plan().fired[-1][1])
    return on_cpu


def quantease_block_sweep(beta0_t, sig_t, w_old_t, scale_t, zero_t, *, n_levels, quantize):
    """Intra-block CD sweep in the transposed ``(…, B, q)`` layout; returns
    ``(w_new_t, delta_t)``."""
    if _on_cpu(beta0_t, sig_t, w_old_t, scale_t, zero_t):
        return ref.quantease_block_sweep_t_ref(
            beta0_t, sig_t, w_old_t, scale_t, zero_t, n_levels=n_levels, quantize=quantize
        )
    return block_sweep_cuda(
        beta0_t, sig_t, w_old_t, scale_t, zero_t, n_levels=n_levels, quantize=quantize
    )


def quantease_fused_iteration(
    base_t, sig_t, sig_corr, w_t, scale_t, zero_t, delta_prev_t, *, n_levels, quantize, bsz
):
    """One fused CD iteration in the transposed ``(…, p_pad, q)`` layout;
    returns ``(w_new_t, base_new_t, delta_new_t)``."""
    args = (base_t, sig_t, sig_corr, w_t, scale_t, zero_t, delta_prev_t)
    fn = ref.quantease_fused_iteration_ref if _on_cpu(*args) else fused_iteration_cuda
    return fn(*args, n_levels=n_levels, quantize=quantize, bsz=bsz)


def quantease_outlier_iteration(
    base_t, sig_t, sig_corr, w_t, scale_t, zero_t, delta_prev_t, dh_prev_t, *,
    n_levels, quantize, bsz,
):
    """One outlier-aware fused CD iteration in the transposed ``(…, p_pad, q)``
    layout; returns ``(w_new_t, base_new_t, delta_pure_t, r_t)``."""
    args = (base_t, sig_t, sig_corr, w_t, scale_t, zero_t, delta_prev_t, dh_prev_t)
    fn = ref.quantease_outlier_iteration_ref if _on_cpu(*args) else outlier_iteration_cuda
    return fn(*args, n_levels=n_levels, quantize=quantize, bsz=bsz)


def dequant_matmul(
    x, codes, scale, zero, *, packed4=False, out_dtype=torch.bfloat16, group_size=None
):
    """Serving GEMM ``y = x @ dequant(codes)ᵀ``; packed4 codes are in the
    linear layout."""
    if _serving_on_cpu(x, codes, scale, zero):
        if packed4:
            from repro_torch.quant.pack import unpack_codes

            codes = unpack_codes(codes, 4, codes.shape[-1] * 2)
        return ref.dequant_matmul_ref(
            x, codes, scale, zero, out_dtype=out_dtype, group_size=group_size
        )
    return dequant_matmul_cuda(
        x, codes, scale, zero, packed4=packed4, out_dtype=out_dtype, group_size=group_size
    )


def dequant_matmul_experts(
    xs, codes, scale, zero, *, packed4=False, out_dtype=torch.bfloat16, group_size=None
):
    """The MoE layer's expert GEMMs: ``xs`` ``(E, C, p)``, each expert's slots,
    times its quantized weight (codes ``(E, q, p)`` or ``(E, q, p/2)``
    packed, per-expert grids) → ``(E, C, q)``: :func:`dequant_matmul` once
    per expert on that expert's ``(C, p)`` slots, so on the card each expert
    is one counted launch of the kernel behind the ``kernel.dispatch`` fault
    site, and on the CPU the plain version the reference vmaps."""
    return torch.stack([
        dequant_matmul(xs[e], codes[e], scale[e], zero[e], packed4=packed4,
                       out_dtype=out_dtype, group_size=group_size)
        for e in range(xs.shape[0])])


def paged_attention(
    q, k_pages, v_pages, page_table, lengths, *,
    window=None, attn_softcap=None, k_scale_pages=None, v_scale_pages=None,
):
    """Paged decode attention (the serving hot path); returns (B, KVp, G, hd).

    Quantized pages must come with both scale planes, and uint8 pages are
    int4 packed fold-in-half: raw codes never enter the dots undecoded."""
    quantized = k_scale_pages is not None
    if (v_scale_pages is None) != (k_scale_pages is None):
        raise ValueError("k_scale_pages and v_scale_pages must be passed together")
    if k_pages.dtype == torch.int8 and not quantized:
        raise ValueError("int8 KV pages require scale planes (dequant-in-kernel)")
    if k_pages.dtype == torch.uint8 and not quantized:
        raise ValueError("int4-packed KV pages require scale planes (dequant-in-kernel)")
    args = (q, k_pages, v_pages, page_table, lengths)
    scales = (k_scale_pages, v_scale_pages) if quantized else ()
    fn = ref.paged_attention_ref if _serving_on_cpu(*args, *scales) else paged_attention_cuda
    return fn(*args, window=window, attn_softcap=attn_softcap,
              k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)
