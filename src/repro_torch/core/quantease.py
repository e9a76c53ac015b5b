"""QuantEase — cyclic coordinate descent layer-wise quantization.

Math (Lemma 1): with Σ = XXᵀ, the optimal quantized value of coordinate
(i, j), all others fixed, is ``q_i(β̃)`` with::

    β̃ = −[ Σ_{k≠j} Σ_{j,k} Ŵ_{i,k} − (WΣ)_{i,j} ] / Σ_{j,j}

* :func:`quantease_reference` — Algorithm 1 verbatim, column at a time with
  rank-1 maintenance of ŴΣ.  Slow; the oracle of the tests.
* :func:`quantease_quantize` with ``engine="fused"`` — the fused-iteration
  engine: ``base = P − P̂`` is kept incrementally through a rolling Δ buffer,
  so one full-width correction product per column block both applies this
  iteration's triangular prefix and amortises the previous iteration's Δ.
  On CUDA each iteration runs the hand-written kernels of
  :mod:`repro_torch.kernels.quantease_cd`; elsewhere the plain version.
  The state is carried transposed, ``(G, p_pad, q)``, the kernels' layout.
* ``engine="legacy"`` — the pre-fused schedule, the reference's benchmark
  baseline: each iteration recomputes P̂ = ŴΣ̃ in full, and each column
  block starts from β0 = (P − P̂)[:, blk] + Δ·Σ̃[:, blk] (full width, exact
  because Δ is zero on unprocessed columns) before the block sweep.  The
  two products are fp32 ``torch.matmul``; the sweep is kernel 1
  (:func:`repro_torch.kernels.ops.quantease_block_sweep`), one launch per
  block and iteration.

The paper's "every third iteration unquantized" heuristic and starting from
any Ŵ (``w_init``) are supported.  The objective history is opt-in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.calib import damp_sigma
from repro_torch.kernels import ops, ref
from repro_torch.quant.grid import Grid, GridSpec, compute_grid

__all__ = [
    "QuantEaseConfig",
    "quantease_quantize",
    "quantease_reference",
    "layer_objective",
    "relative_error",
]


@dataclasses.dataclass(frozen=True)
class QuantEaseConfig:
    """Hyper-parameters of the CD solver (paper defaults).

    ``use_kernel``: ``"auto"`` resolves to the CUDA kernels for CUDA tensors
    and to the plain PyTorch version otherwise; ``"cuda"`` insists on the
    kernels, ``"torch"`` takes the plain version on any device.
    ``matmul_dtype`` applies to the Σ̃ correction operands only (fp32
    accumulation; the β/quantize path is always fp32).
    """

    iterations: int = 25
    block_size: int = 256
    percdamp: float = 0.01
    unquantized_heuristic: bool = True
    use_kernel: str = "auto"
    matmul_dtype: str = "float32"
    track_objective: bool = False
    engine: str = "fused"

    def solve_kwargs(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def _iteration_step(use_kernel: str, device: torch.device,
                    plain=ref.quantease_fused_iteration_ref, routed=ops.quantease_fused_iteration):
    """The per-iteration function: ``plain`` when ``"torch"`` is asked for,
    else ``routed`` (from :mod:`..kernels.ops`), which routes by device."""
    if use_kernel not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown use_kernel {use_kernel!r}")
    if use_kernel == "cuda" and device.type != "cuda":
        raise ValueError("use_kernel='cuda' needs CUDA tensors")
    return plain if use_kernel == "torch" else routed


def _legacy_iteration(sweep, pmat_t, sig_t, w_t, scale_t, zero_t, *, n_levels, quantize, bsz):
    """One iteration of the legacy schedule in the transposed layout: the
    full P̂ recompute, then per block the full-width correction and the
    sweep.  Returns ``(Ŵᵀ, β0ᵀ, Δᵀ)``, β0 of each block as its sweep read
    it (the fused iteration's ``base_new``)."""
    base_t = pmat_t - sig_t @ w_t  # P − P̂, P̂ = ŴΣ̃ in full
    delta_t = torch.zeros_like(w_t)  # old − new; zero on unprocessed columns
    w_new = torch.empty_like(w_t)
    for col0 in range(0, w_t.shape[-2], bsz):
        sl = slice(col0, col0 + bsz)
        beta0_t = base_t[..., sl, :] + sig_t[..., sl, :] @ delta_t
        base_t[..., sl, :] = beta0_t  # this block's base is read no more
        # Fresh (…, B, q) copies: the kernel takes row operands of one
        # stride pattern, and a view of a single group keeps the state's.
        blk = lambda a: torch.empty_like(beta0_t).copy_(a[..., sl, :])
        new, delta = sweep(
            beta0_t, sig_t[..., sl, sl].contiguous(), blk(w_t), blk(scale_t), blk(zero_t),
            n_levels=n_levels, quantize=quantize,
        )
        w_new[..., sl, :] = new
        delta_t[..., sl, :] = delta
    return w_new, base_t, delta_t


def layer_objective(w, w_hat, sigma) -> torch.Tensor:
    """f(Ŵ) = Tr((W−Ŵ) Σ (W−Ŵ)ᵀ), per matrix over leading dims."""
    e = (w - w_hat).to(torch.float32)
    return ((e @ sigma.to(torch.float32)) * e).sum((-2, -1))


def relative_error(w, w_hat, sigma) -> torch.Tensor:
    """‖WX−ŴX‖²_F / ‖WX‖²_F (paper §3.4 / Fig. 2 metric), batched."""
    w = w.to(torch.float32)
    denom = ((w @ sigma.to(torch.float32)) * w).sum((-2, -1))
    return layer_objective(w, w_hat, sigma) / torch.clamp_min(denom, 1e-30)


def _prep(w, sigma, spec, percdamp, grid: Optional[Grid]):
    """Batched prep: w (G, q, p), sigma (G, p, p)."""
    p = w.shape[-1]
    w = w.to(torch.float32)
    sigma = damp_sigma(sigma.to(torch.float32), percdamp)
    if grid is None:
        grid = compute_grid(w, spec)
    scale_pc, zero_pc = grid.per_column(p)
    diag = torch.diagonal(sigma, dim1=-2, dim2=-1)
    sig_norm = sigma / diag[..., None, :]  # column-normalized, diag = 1
    sig_tilde = sig_norm - torch.eye(p, dtype=torch.float32, device=w.device)
    pmat = w @ sig_norm
    return w, sigma, scale_pc, zero_pc, sig_tilde, pmat


def _quantize_flags(iterations: int, unquantized_heuristic: bool) -> list:
    return [
        not (unquantized_heuristic and (it + 1) % 3 == 0 and it != iterations - 1)
        for it in range(iterations)
    ]


def _quant_cols(x, scale, zero, n_levels):
    codes = torch.clamp(torch.round(x / scale) + zero, 0, n_levels - 1)
    return (codes - zero) * scale


def quantease_reference(
    w, sigma, spec: GridSpec, *, iterations: int = 3, percdamp: float = 0.01,
    unquantized_heuristic: bool = False, w_init=None,
) -> torch.Tensor:
    """Algorithm 1 on one (q, p) layer, column at a time.  Slow; tests only."""
    q, p = w.shape
    w32, sigma, scale_pc, zero_pc, _, _ = _prep(w, sigma, spec, percdamp, None)
    w_hat = (w32 if w_init is None else w_init.to(torch.float32)).clone()
    wsig = w32 @ sigma
    what_sig = w_hat @ sigma
    diag = torch.diagonal(sigma)
    for quantize in _quantize_flags(iterations, unquantized_heuristic):
        for j in range(p):
            wcol = w_hat[:, j].clone()
            sjj = diag[j]
            beta = -(what_sig[:, j] - sjj * wcol - wsig[:, j]) / sjj
            new = _quant_cols(beta, scale_pc[:, j], zero_pc[:, j], spec.n_levels) if quantize else beta
            what_sig += torch.outer(new - wcol, sigma[j])
            w_hat[:, j] = new
    return w_hat


def quantease_quantize(
    w: torch.Tensor,
    sigma: torch.Tensor,
    spec: GridSpec,
    *,
    iterations: int = 25,
    block_size: int = 256,
    percdamp: float = 0.01,
    unquantized_heuristic: bool = True,
    w_init: Optional[torch.Tensor] = None,
    grid: Optional[Grid] = None,
    use_kernel: str = "auto",
    matmul_dtype: str = "float32",
    track_objective: bool = False,
    engine: str = "fused",
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Blocked Algorithm 2 with the fused engine (or, ``engine="legacy"``,
    the pre-fused schedule).  Returns (Ŵ fp32, objective history or None).

    ``w: (q, p)`` with ``sigma: (p, p)``, or batched ``w: (G, q, p)`` with
    ``sigma: (G, p, p)``, solving G independent layers at once; ``grid``
    (leaves ``(G, q, n_groups)``) and ``w_init`` batch alike.  The history,
    when ``track_objective``, is evaluated after each iteration against the
    damped Σ: shape ``(iterations,)`` or ``(G, iterations)``.
    """
    if engine not in ("fused", "legacy"):
        raise ValueError(f"unknown engine {engine!r}")
    if matmul_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}")
    if engine == "legacy":  # matmul_dtype applies to the fused engine only, as in the reference
        step = _iteration_step(use_kernel, w.device, plain=ref.quantease_block_sweep_t_ref,
                               routed=ops.quantease_block_sweep)
    else:
        step = _iteration_step(use_kernel, w.device)
    single = w.dim() == 2
    if single:
        w, sigma = w[None], sigma[None]
        w_init = None if w_init is None else w_init[None]
        grid = None if grid is None else Grid(grid.spec, grid.scale[None], grid.zero[None])

    q, p = w.shape[-2:]
    w32, sigma_d, scale_pc, zero_pc, sig_tilde, pmat = _prep(w, sigma, spec, percdamp, grid)
    w_hat = w32 if w_init is None else w_init.to(torch.float32)

    bsz = min(block_size, p)
    n_blocks = -(-p // bsz)
    pad = n_blocks * bsz - p
    if pad:
        # Padded columns: zero Σ̃ coupling, unit scale ⇒ they quantize to an
        # isolated 0 and never influence real columns.
        padc = lambda a, v=0.0: torch.nn.functional.pad(a, (0, pad), value=v)
        w32, w_hat, pmat = padc(w32), padc(w_hat), padc(pmat)
        scale_pc, zero_pc = padc(scale_pc, 1.0), padc(zero_pc)
        sig_tilde = torch.nn.functional.pad(sig_tilde, (0, pad, 0, pad))
        sigma_d = torch.nn.functional.pad(sigma_d, (0, pad, 0, pad))

    t = lambda a: a.transpose(-1, -2).contiguous()
    objs = []
    if engine == "legacy":
        pmat_t, sig_t = t(pmat), t(sig_tilde)
        del pmat, sig_tilde
        w_t, scale_t, zero_t = t(w_hat), t(scale_pc), t(zero_pc)
        for quantize in _quantize_flags(iterations, unquantized_heuristic):
            w_t = _legacy_iteration(step, pmat_t, sig_t, w_t, scale_t, zero_t,
                                    n_levels=spec.n_levels, quantize=quantize, bsz=bsz)[0]
            if track_objective:
                objs.append(layer_objective(w32, w_t.transpose(-1, -2), sigma_d))
    else:
        # Incremental-state init: base = P − Ŵ₀Σ̃ in fp32, rolling Δ = 0.
        base_t = t(pmat - w_hat @ sig_tilde)
        del pmat
        sig_t = t(sig_tilde)
        del sig_tilde
        sig_corr = sig_t if matmul_dtype == "float32" else sig_t.to(torch.bfloat16)
        w_t, scale_t, zero_t = t(w_hat), t(scale_pc), t(zero_pc)
        delta_t = torch.zeros_like(base_t)
        for quantize in _quantize_flags(iterations, unquantized_heuristic):
            w_t, base_t, delta_t = step(
                base_t, sig_t, sig_corr, w_t, scale_t, zero_t, delta_t,
                n_levels=spec.n_levels, quantize=quantize, bsz=bsz,
            )
            if track_objective:
                objs.append(layer_objective(w32, w_t.transpose(-1, -2), sigma_d))
    w_hat = w_t.transpose(-1, -2)[..., :p].contiguous()
    hist = torch.stack(objs, dim=-1) if track_objective else None
    if single:
        return w_hat[0], (hist[0] if hist is not None else None)
    return w_hat, hist
