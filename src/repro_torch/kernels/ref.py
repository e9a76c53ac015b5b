"""Plain PyTorch versions of every kernel in this package.

They are the semantics the CUDA kernels are held to on the card, and the
path a wrapper in :mod:`repro_torch.kernels.ops` takes for tensors that lie
on the CPU.  Each mirrors a function of the JAX reference:

* :func:`quantease_block_sweep_ref` — ``repro.kernels.ref.quantease_block_sweep_ref``
  (``(q, B)`` layout); :func:`quantease_block_sweep_t_ref` is the same sweep
  in the transposed ``(B, q)`` layout the kernels use;
* :func:`quantease_fused_iteration_ref` — one iteration of the fused engine,
  ``repro.core.quantease._fused_xla_iteration_step``, in the transposed
  ``(p_pad, q)`` layout;
* :func:`quantease_outlier_iteration_ref` — one iteration of the
  outlier-aware fused engine, ``repro.kernels.ref.quantease_outlier_iteration_ref``
  (and the Pallas ``_outlier_iter_kernel``), in the transposed layout;
* :func:`dequant_matmul_ref` — ``repro.kernels.ref.dequant_matmul_ref``;
* :func:`paged_attention_ref` — ``repro.kernels.ref.paged_attention_ref``;
* :func:`gram_ref` — ``repro.kernels.ref.gram_ref`` (Σ = XXᵀ).

Every function takes optional leading batch dims.
"""

from __future__ import annotations

import torch

__all__ = [
    "quantease_block_sweep_ref",
    "quantease_block_sweep_t_ref",
    "quantease_fused_iteration_ref",
    "quantease_outlier_iteration_ref",
    "dequant_matmul_ref",
    "paged_attention_ref",
    "gram_ref",
]


def _quant_cols(x, scale, zero, n_levels):
    codes = torch.clamp(torch.round(x / scale) + zero, 0, n_levels - 1)
    return (codes - zero) * scale


def quantease_block_sweep_t_ref(
    beta0_t: torch.Tensor,  # (..., B, q) f32
    sig_t: torch.Tensor,  # (..., B, B) f32 — row i = Σ̃_blk[:, i]
    w_old_t: torch.Tensor,  # (..., B, q) f32
    scale_t: torch.Tensor,  # (..., B, q) f32
    zero_t: torch.Tensor,  # (..., B, q) f32
    *,
    n_levels: int,
    quantize: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential CD sweep over the B columns of one block, transposed.

    For column i: β = β0[i] + Σ̃_blk[:, i] · Δ (rows ≥ i of Δ still zero),
    snap β to the grid when quantizing, Δ[i] = old − new.  Returns
    ``(Ŵ_new block, Δ block)``, both ``(..., B, q)``."""
    bsz = beta0_t.shape[-2]
    delta_t = torch.zeros_like(beta0_t)
    new_t = torch.empty_like(beta0_t)
    for i in range(bsz):
        beta = beta0_t[..., i, :] + (sig_t[..., i : i + 1, :] @ delta_t)[..., 0, :]
        if quantize:
            new = _quant_cols(beta, scale_t[..., i, :], zero_t[..., i, :], n_levels)
        else:
            new = beta
        new_t[..., i, :] = new
        delta_t[..., i, :] = w_old_t[..., i, :] - new
    return new_t, delta_t


def quantease_block_sweep_ref(
    beta0: torch.Tensor,  # (..., q, B) f32
    sig_blk: torch.Tensor,  # (..., B, B) f32 — Σ̃ block (zero diag)
    w_old_blk: torch.Tensor,  # (..., q, B)
    scale_blk: torch.Tensor,
    zero_blk: torch.Tensor,
    *,
    n_levels: int,
    quantize: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sweep in the reference's ``(q, B)`` layout."""
    t = lambda a: a.transpose(-1, -2)
    new_t, delta_t = quantease_block_sweep_t_ref(
        t(beta0), t(sig_blk), t(w_old_blk), t(scale_blk), t(zero_blk),
        n_levels=n_levels, quantize=quantize,
    )
    return t(new_t), t(delta_t)


def quantease_fused_iteration_ref(
    base_t: torch.Tensor,  # (..., p_pad, q) f32 — (P − P̂)ᵀ entering the iteration
    sig_t: torch.Tensor,  # (..., p_pad, p_pad) f32 — Σ̃ᵀ (row j = Σ̃[:, j])
    sig_corr: torch.Tensor,  # Σ̃ᵀ in the correction dtype (f32 or bf16)
    w_t: torch.Tensor,  # (..., p_pad, q) f32 — Ŵᵀ entering the iteration
    scale_t: torch.Tensor,
    zero_t: torch.Tensor,
    delta_prev_t: torch.Tensor,  # (..., p_pad, q) f32 — previous rolling Δᵀ
    *,
    n_levels: int,
    quantize: bool,
    bsz: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One whole CD iteration of the fused engine.

    Per block b, in order: ``corr = Σ̃ᵀ[blk, :] @ Δ_acc`` over the full width
    (rows < col0 of the rolling Δ hold this iteration's deltas, the rest the
    previous iteration's), with the operands cast to ``sig_corr.dtype`` and
    fp32 accumulation; ``β0 = base + corr`` is also the next base; then the
    intra-block sweep, whose Δ is published into the rolling buffer.
    Returns ``(w_new_t, base_new_t, delta_new_t)``.
    """
    p_pad = base_t.shape[-2]
    if p_pad % bsz:
        raise ValueError(f"p_pad={p_pad} is not a multiple of bsz={bsz}")
    cdt = sig_corr.dtype
    delta_acc = delta_prev_t.clone()
    w_new = torch.empty_like(w_t)
    base_new = torch.empty_like(base_t)
    for b in range(p_pad // bsz):
        sl = slice(b * bsz, (b + 1) * bsz)
        corr = sig_corr[..., sl, :].to(torch.float32) @ delta_acc.to(cdt).to(torch.float32)
        beta0 = base_t[..., sl, :] + corr
        new, d = quantease_block_sweep_t_ref(
            beta0, sig_t[..., sl, sl], w_t[..., sl, :], scale_t[..., sl, :],
            zero_t[..., sl, :], n_levels=n_levels, quantize=quantize,
        )
        w_new[..., sl, :] = new
        base_new[..., sl, :] = beta0
        delta_acc[..., sl, :] = d
    return w_new, base_new, delta_acc


def quantease_outlier_iteration_ref(
    base_t: torch.Tensor,  # (..., p_pad, q) f32 — base invariant entering the iteration
    sig_t: torch.Tensor,  # (..., p_pad, p_pad) f32 — Σ̃ᵀ (row j = Σ̃[:, j])
    sig_corr: torch.Tensor,  # Σ̃ᵀ in the matmul dtype (f32 or bf16)
    w_t: torch.Tensor,  # (..., p_pad, q) f32 — Ŵᵀ entering the iteration
    scale_t: torch.Tensor,
    zero_t: torch.Tensor,
    delta_prev_t: torch.Tensor,  # (..., p_pad, q) f32 — rolling Δᵀ (δŴ_prev − dĤ_prev)
    dh_prev_t: torch.Tensor,  # (..., p_pad, q) f32 — previous IHT step dĤᵀ
    *,
    n_levels: int,
    quantize: bool,
    bsz: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One outlier-aware fused CD iteration: the rolling-Δ sweep with the
    Ĥ step's target move applied lazily, then the exact residual.

    Per block b, in order: ``β0 = base − dĤ_prev + Σ̃ᵀ[blk, :] @ Δ_acc``
    (operands in ``sig_corr.dtype``, fp32 accumulation), stored as the next
    base; the intra-block sweep gives Ŵ_new and the pure δŴ; ``δŴ − dĤ_prev``
    is published into the rolling Δ for later blocks.  At the end
    ``R = base_out + (Σ̃ᵀ ⊙ M) @ δŴ`` with the block-suffix mask
    ``M[c, k] = block(k) ≥ block(c)``, in the same operand dtype:
    ``R = P − Ŵ_new Σ̃``.
    Returns ``(w_new_t, base_new_t, delta_pure_t, r_t)``.
    """
    p_pad = base_t.shape[-2]
    if p_pad % bsz:
        raise ValueError(f"p_pad={p_pad} is not a multiple of bsz={bsz}")
    cdt = sig_corr.dtype
    as_op = lambda a: a.to(cdt).to(torch.float32)
    delta_acc = delta_prev_t.clone()
    w_new = torch.empty_like(w_t)
    base_new = torch.empty_like(base_t)
    dpure = torch.empty_like(base_t)
    for b in range(p_pad // bsz):
        sl = slice(b * bsz, (b + 1) * bsz)
        corr = sig_corr[..., sl, :].to(torch.float32) @ as_op(delta_acc)
        beta0 = base_t[..., sl, :] - dh_prev_t[..., sl, :] + corr
        new, d = quantease_block_sweep_t_ref(
            beta0, sig_t[..., sl, sl], w_t[..., sl, :], scale_t[..., sl, :],
            zero_t[..., sl, :], n_levels=n_levels, quantize=quantize,
        )
        w_new[..., sl, :] = new
        base_new[..., sl, :] = beta0
        dpure[..., sl, :] = d
        delta_acc[..., sl, :] = d - dh_prev_t[..., sl, :]
    blk = torch.arange(p_pad, device=sig_corr.device) // bsz
    sig_suffix = torch.where(blk[None, :] >= blk[:, None], sig_corr.to(torch.float32), 0.0)
    r = base_new + sig_suffix @ as_op(dpure)
    return w_new, base_new, dpure, r


def dequant_matmul_ref(
    x: torch.Tensor,  # (m, p)
    codes: torch.Tensor,  # (q, p) uint8, unpacked
    scale: torch.Tensor,  # (q,) or (q, n_groups) f32
    zero: torch.Tensor,
    *,
    out_dtype=torch.float32,
    group_size=None,
) -> torch.Tensor:
    """y = x @ dequant(codes)ᵀ with fp32 accumulation.

    ``group_size`` is the grid's true group width (ragged tails allowed);
    when None it is inferred as ceil(p / n_groups)."""
    q, p = codes.shape
    if scale.ndim == 1:
        scale, zero = scale[:, None], zero[:, None]
    gsz = group_size or -(-p // scale.shape[1])
    idx = torch.arange(p, device=codes.device) // gsz
    w = (codes.to(torch.float32) - zero[:, idx]) * scale[:, idx]
    return (x.to(torch.float32) @ w.T).to(out_dtype)


def paged_attention_ref(
    q: torch.Tensor,  # (B, KVp, G, hd): one decode token per sequence
    k_pages: torch.Tensor,  # (n_pages, psz, KVp, hd) bf16/f32/int8, or (…, hd/2) uint8 int4
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # (B, n_pgs) int32; padded entries point at the null page
    lengths: torch.Tensor,  # (B,) int32: valid tokens per sequence
    *,
    window=None,
    attn_softcap=None,
    k_scale_pages=None,  # (n_pages, psz, KVp, 1) f32
    v_scale_pages=None,
) -> torch.Tensor:
    """Paged decode attention: gather each sequence's pages in position order
    (unpacking fold-in-half int4 pages to int8 codes) and run
    :func:`repro_torch.models.common.decode_attention`, so a paged read is
    bit-identical to the contiguous read of the same KV.  Returns
    (B, KVp, G, hd)."""
    from repro_torch.models.common import decode_attention
    from repro_torch.quant.pack import kv_unpack_int4

    B, KVp, G, hd = q.shape
    S = page_table.shape[1] * k_pages.shape[1]
    pt = page_table.long()
    k, v = k_pages[pt], v_pages[pt]
    if k_pages.dtype == torch.uint8:
        k, v = kv_unpack_int4(k), kv_unpack_int4(v)
    k, v = k.reshape(B, S, KVp, hd), v.reshape(B, S, KVp, hd)
    ks = vs = None
    if k_scale_pages is not None:
        ks = k_scale_pages[pt].reshape(B, S, KVp, 1)
        vs = v_scale_pages[pt].reshape(B, S, KVp, 1)
    return decode_attention(
        q[:, None], k, v, lengths, window=window, attn_softcap=attn_softcap,
        k_scale=ks, v_scale=vs,
    )[:, 0]


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """Σ = X Xᵀ, fp32 accumulation (X: (p, n), any float dtype)."""
    x = x.to(torch.float32)
    return x @ x.T
