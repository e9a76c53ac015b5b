"""Outlier-aware QuantEase (paper §4, Algorithm 3) — the fused engine.

Solves  min ‖WX − (Ŵ+Ĥ)X‖²  s.t.  Ŵ on-grid, ‖Ĥ‖₀ ≤ s
by block coordinate descent:

* Ŵ-block: one cyclic-CD sweep of QuantEase on the surrogate target
  ``W − Ĥ``;
* Ĥ-block: one iterative-hard-thresholding (IHT) step
  ``Ĥ ← P_s(Ĥ − η ∇_H g)`` with ``η = 1/(2 λ_max(Σ))`` (Lemma 3 descent).

With ``σ_norm = Σ/diag`` and ``Σ̃ = σ_norm − I`` the engine keeps the CD
engine's invariant ``base = P − ŴΣ̃`` (``P = (W−Ĥ)σ_norm``) incrementally,
in the transposed ``(G, p_pad, q)`` layout the kernels use:

* each outer iteration is one call of
  :func:`repro_torch.kernels.ops.quantease_outlier_iteration`: the
  rolling-Δ sweep, whose correction also applies the previous Ĥ step's
  target move lazily (``β0 = base − dĤ_prev + Σ̃ᵀ·Δ``, published rows
  ``δŴ − dĤ_prev``), and the exact post-sweep residual
  ``R = P − ŴΣ̃ = base + (Σ̃ ⊙ M)ᵀ·δŴ`` (block-suffix product);
* the IHT gradient is then free, ``∇_H g = −2 (R − Ŵ) ⊙ diag(Σ)``, and
  ``P_s`` is a top-k on the flattened state;
* on CUDA tensors the call runs the hand-written kernels
  (:mod:`repro_torch.kernels.quantease_cd`), on CPU tensors the plain
  version; the two apply updates in the same order.

Grid-range shrink (§4.3): the per-channel grids are computed once, from W
with the top-s magnitude entries (or the structured columns) excluded.
Structured variant: ``P_s`` keeps the ⌊s/q⌋ columns of largest ℓ2 norm.
Initialization: Ĥ = P_s(W), Ŵ = W − Ĥ.

Batched: ``w: (G, q, p)`` with ``sigma: (G, p, p)`` solves G independent
layers at once; the result's leaves and grid gain the leading G.

``engine="legacy"`` is the reference's pre-fused schedule, kept as the
benchmark baseline and for the equivalence tests: each outer iteration runs
one whole QuantEase iteration (the fused engine, so kernel 2 on the card)
on the target W − Ĥ from the current Ŵ, then the IHT step with the
gradient ``2 (Ŵ + Ĥ − W) Σ`` computed in full.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import quantease
from repro_torch.core.calib import damp_sigma
from repro_torch.kernels import ops, ref
from repro_torch.quant.grid import Grid, GridSpec, compute_grid_excluding_outliers

__all__ = [
    "OutlierResult",
    "outlier_quantease",
    "top_s_mask",
    "power_lambda_max",
]

_SWEEP_CHUNK = 8  # the block size is a multiple of this, as in the reference


@dataclasses.dataclass
class OutlierResult:
    w_hat: torch.Tensor  # (…, q, p) quantized part (on-grid, fp32)
    h: torch.Tensor  # (…, q, p) dense sparse correction (‖Ĥ‖₀ ≤ s per matrix)
    # Damped objective after each outer iteration, (…, iterations): opt-in.
    objective: Optional[torch.Tensor] = None
    # The range-shrunk grid the sweeps quantized onto (the emit reuses it).
    grid: Optional[Grid] = None

    @property
    def w_eff(self) -> torch.Tensor:
        return self.w_hat + self.h


def power_lambda_max(sigma: torch.Tensor, iters: int = 64, tol: float = 0.0) -> torch.Tensor:
    """Largest eigenvalue of PSD Σ ``(…, p, p)`` by power iteration
    (matrix-vector products only); returns ``(…)``.

    ``iters`` caps the count.  ``tol > 0`` stops a matrix early once its
    Rayleigh quotient is stable to that relative tolerance — optimistic,
    since a clustered top of the spectrum can plateau below λ_max and make
    the IHT step exceed the Lemma-3 bound; the default ``tol=0.0`` runs all
    ``iters``.  λ is read as ``v·(Σv)`` for the unit v entering each step,
    and one final quotient is taken on the last v.
    """
    p = sigma.shape[-1]
    lead = sigma.shape[:-2]
    mv = lambda v: (sigma @ v[..., None])[..., 0]
    v = torch.ones(*lead, p, dtype=torch.float32, device=sigma.device)
    v = v / torch.sqrt(torch.tensor(float(p), dtype=torch.float32, device=sigma.device))
    lam = torch.zeros(lead, dtype=torch.float32, device=sigma.device)
    lam_prev = torch.full_like(lam, 3.4e38)
    active = torch.ones(lead, dtype=torch.bool, device=sigma.device)
    for _ in range(iters):
        if tol > 0.0:
            active &= ~((lam - lam_prev).abs() <= tol * torch.clamp_min(lam.abs(), 1e-30))
            if not bool(active.any()):
                break
        sv = mv(v)
        lam_new = (v * sv).sum(-1)
        v_new = sv / torch.clamp_min(torch.linalg.vector_norm(sv, dim=-1, keepdim=True), 1e-30)
        v = torch.where(active[..., None], v_new, v)
        lam, lam_prev = torch.where(active, lam_new, lam), torch.where(active, lam, lam_prev)
    return (v * mv(v)).sum(-1)


def top_s_mask(a: torch.Tensor, s: int) -> torch.Tensor:
    """Boolean mask of the s largest |entries| of each matrix ``(…, q, p)``."""
    flat = a.abs().reshape(*a.shape[:-2], -1)
    idx = torch.topk(flat, s, dim=-1, sorted=False).indices
    mask = torch.zeros_like(flat, dtype=torch.bool).scatter(-1, idx, True)
    return mask.reshape(a.shape)


def _project_s(a: torch.Tensor, s: int) -> torch.Tensor:
    """P_s: keep the s largest-|value| entries of each matrix, zero the rest.
    The kept set does not depend on the layout, so it serves the transposed
    state as well."""
    flat = a.reshape(*a.shape[:-2], -1)
    idx = torch.topk(flat.abs(), s, dim=-1, sorted=False).indices
    return torch.zeros_like(flat).scatter(-1, idx, flat.gather(-1, idx)).reshape(a.shape)


def _keep_rows(a: torch.Tensor, n: int, norms: torch.Tensor) -> torch.Tensor:
    """Keep the n rows (second-to-last axis) of largest ``norms``."""
    idx = torch.topk(norms, n, dim=-1, sorted=False).indices
    mask = torch.zeros_like(norms, dtype=torch.bool).scatter(-1, idx, True)
    return torch.where(mask[..., None], a, 0.0)


def _project_columns(a: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Structured P_s: keep the n_cols columns of largest ℓ2 norm."""
    a_t = a.transpose(-1, -2)
    return _keep_rows(a_t, n_cols, torch.linalg.vector_norm(a_t, dim=-1)).transpose(-1, -2)


def outlier_quantease(
    w: torch.Tensor,
    sigma: torch.Tensor,
    spec: GridSpec,
    *,
    s: int,
    iterations: int = 25,
    structured: bool = False,
    percdamp: float = 0.01,
    cd_block_size: int = 128,
    use_kernel: str = "auto",
    matmul_dtype: str = "float32",
    track_objective: bool = False,
    engine: str = "fused",
    lam_iters: int = 64,
) -> OutlierResult:
    """Algorithm 3.  ``s`` is the outlier budget per matrix in entries; the
    structured variant keeps ⌊s/q⌋ columns (at least one).

    ``use_kernel`` and ``matmul_dtype`` follow
    :class:`repro_torch.core.quantease.QuantEaseConfig`: ``"auto"`` runs the
    CUDA kernels for CUDA tensors and the plain version otherwise;
    ``"bfloat16"`` rounds the Σ̃ correction and residual operands (fp32
    accumulation; β, the quantizer and the IHT step stay fp32).

    ``w: (q, p)`` with ``sigma: (p, p)``, or batched ``(G, q, p)`` with
    ``(G, p, p)``.
    """
    if engine not in ("fused", "legacy"):
        raise ValueError(f"unknown engine {engine!r}")
    if matmul_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown matmul_dtype {matmul_dtype!r}")
    single = w.dim() == 2
    if single:
        w, sigma = w[None], sigma[None]
    G, q, p = w.shape
    if not 1 <= s <= q * p:
        raise ValueError(f"outlier budget s={s} outside 1..{q * p}")
    step = quantease._iteration_step(
        use_kernel, w.device, plain=ref.quantease_outlier_iteration_ref,
        routed=ops.quantease_outlier_iteration,
    )
    w32 = w.to(torch.float32)
    sigma_d = damp_sigma(sigma.to(torch.float32), percdamp)
    eta = 1.0 / (2.0 * power_lambda_max(sigma_d, iters=lam_iters))

    n_cols = max(s // q, 1)
    # Range-shrunk grids over the non-outliers; the exclusion has the
    # structure of Ĥ (entries, or whole columns).
    if structured:
        norms = torch.linalg.vector_norm(w32, dim=-2)
        col_idx = torch.topk(norms, n_cols, dim=-1, sorted=False).indices
        excl = torch.zeros_like(norms, dtype=torch.bool).scatter(-1, col_idx, True)
        excl = excl[..., None, :].expand(G, q, p)
    else:
        excl = top_s_mask(w32, s)
    grid = compute_grid_excluding_outliers(w32, spec, excl)
    if engine == "legacy":
        w_hat, h, objs = _outlier_legacy(
            w32, sigma_d, spec, grid, excl, eta, s=s, iterations=iterations,
            structured=structured, cd_block_size=cd_block_size, use_kernel=use_kernel,
            track_objective=track_objective, n_cols=n_cols,
        )
        return _result(w_hat, h, objs, grid, single)

    bsz = max(_SWEEP_CHUNK, min(cd_block_size, p))
    bsz = -(-bsz // _SWEEP_CHUNK) * _SWEEP_CHUNK
    p_pad = -(-p // bsz) * bsz
    pad = p_pad - p
    scale_pc, zero_pc = grid.per_column(p)
    diag = torch.diagonal(sigma_d, dim1=-2, dim2=-1)
    sig_tilde = sigma_d / diag[..., None, :] - torch.eye(p, dtype=torch.float32, device=w.device)
    if track_objective:
        sigma_obj = torch.nn.functional.pad(sigma_d, (0, pad, 0, pad))
    del sigma_d
    if pad:
        # Padded columns: zero Σ̃ coupling, unit scale, zero diag ⇒ they
        # quantize to an isolated 0, their IHT candidates are exactly 0, and
        # they never influence real columns.
        padc = lambda a, v=0.0: torch.nn.functional.pad(a, (0, pad), value=v)
        sig_tilde = torch.nn.functional.pad(sig_tilde, (0, pad, 0, pad))
        diag, w32p, excl = padc(diag), padc(w32), padc(excl, False)
        scale_pc, zero_pc = padc(scale_pc, 1.0), padc(zero_pc)
    else:
        w32p = w32

    # Everything below is transposed: the state is (G, p_pad, q).
    t = lambda a: a.transpose(-1, -2).contiguous()
    sig_t = t(sig_tilde)
    del sig_tilde
    sig_corr = sig_t if matmul_dtype == "float32" else sig_t.to(torch.bfloat16)
    scale_t, zero_t = t(torch.clamp_min(scale_pc, 1e-12)), t(zero_pc)
    w_t, excl_t = t(w32p), t(excl)
    diag_t = diag[..., :, None]
    two_eta = (2.0 * eta)[:, None, None]

    def project_t(cand_t):
        if structured:  # columns of W are rows of the transposed state
            return _keep_rows(cand_t, n_cols, (cand_t * cand_t).sum(-1))
        return _project_s(cand_t, s)

    # Init: Ĥ = P_s(W), Ŵ = W − Ĥ.  Then base = P − Ŵ₀Σ̃ = Ŵ₀(σ_norm − Σ̃) = Ŵ₀.
    h_t = torch.where(excl_t, w_t, 0.0)
    w_hat_t = w_t - h_t
    base_t = w_hat_t
    delta_t = torch.zeros_like(w_t)
    dh_t = torch.zeros_like(w_t)
    objs = []
    for _ in range(iterations):
        new_t, base_out, dpure, r_t = step(
            base_t, sig_t, sig_corr, w_hat_t, scale_t, zero_t, delta_t, dh_t,
            n_levels=spec.n_levels, quantize=True, bsz=bsz,
        )
        # IHT step from the exact residual: ∇_H g = −2 (R − Ŵ) ⊙ diag(Σ).
        cand_t = h_t + two_eta * ((r_t - new_t) * diag_t)
        del r_t
        h_new = project_t(cand_t)
        del cand_t
        dh_t = h_new - h_t
        if track_objective:
            e_t = w_t - h_new - new_t
            objs.append((e_t * (sigma_obj @ e_t)).sum((-2, -1)))
        # The Ĥ step moves the target by −dĤσ_norm: its −dĤΣ̃ part rides the
        # rolling Δ (published as δŴ − dĤ next iteration), its −dĤ part is
        # taken when base is read (the −dĤ_prev in β0).
        w_hat_t, h_t, base_t, delta_t = new_t, h_new, base_out, dpure - dh_t
    unpad = lambda a_t: a_t.transpose(-1, -2)[..., :p].contiguous()
    return _result(unpad(w_hat_t), unpad(h_t), objs, grid, single)


def _result(w_hat, h, objs, grid, single) -> OutlierResult:
    res = OutlierResult(
        w_hat=w_hat, h=h, objective=torch.stack(objs, dim=-1) if objs else None, grid=grid,
    )
    if single:
        res = OutlierResult(
            w_hat=res.w_hat[0], h=res.h[0],
            objective=None if res.objective is None else res.objective[0], grid=grid[0],
        )
    return res


def _outlier_legacy(w32, sigma_d, spec, grid, excl, eta, *, s, iterations, structured,
                    cd_block_size, use_kernel, track_objective, n_cols):
    """The legacy schedule on ``(G, q, p)``; returns ``(Ŵ, Ĥ, objectives)``."""
    project = ((lambda a: _project_columns(a, n_cols)) if structured
               else (lambda a: _project_s(a, s)))
    # Init: Ĥ = P_s(W), Ŵ = W − Ĥ.
    h = torch.where(excl, w32, 0.0)
    w_hat = w32 - h
    eta = eta[:, None, None]
    objs = []
    for _ in range(iterations):
        # Ŵ-block: one QuantEase iteration on the target W − Ĥ (Σ already damped).
        w_hat, _ = quantease.quantease_quantize(
            w32 - h, sigma_d, spec, iterations=1, block_size=cd_block_size, percdamp=0.0,
            unquantized_heuristic=False, w_init=w_hat, grid=grid, use_kernel=use_kernel,
        )
        # Ĥ-block: IHT step, ∇_H g = 2 (Ŵ + Ĥ − W) Σ.
        grad = 2.0 * ((w_hat + h - w32) @ sigma_d)
        h = project(h - eta * grad)
        if track_objective:
            objs.append(quantease.layer_objective(w32, w_hat + h, sigma_d))
    return w_hat, h, objs
