"""Whole-model PTQ: the paper's pipeline over a decoder stack.

* Calibration batches run through the model block by block; each block's
  inputs are the outputs of the already-quantized prefix.
* Streaming Σ capture: every linear folds each batch into its fp32
  Σ = XXᵀ the moment it is computed (:func:`capture_gram_stats`).
* Batched solves: same-shape linears of a block (wq/wk/wv/wo; wg/wu; wd)
  are stacked and solved by one ``quantease_quantize`` call.
* Grids are computed once from the original weights and threaded through
  the solve and the emit, so emitted codes round-trip the solve exactly.
* Per-layer relative errors (the paper's Fig. 2 metric) are reported, with
  an optional per-block progress callback.  For the outlier-aware methods
  they are errors of the effective weights Ŵ + Ĥ.

Methods: ``rtn``, ``gptq``, ``quantease`` (optionally warm-started from
GPTQ, ``init_from_gptq``) and ``qe_outlier``/``qe_outlier_struct``
(Algorithm 3, unstructured and column outliers) solve each same-shape
group in one batched call; ``awq``, ``awq_qe`` (AWQ's scaling, then
QuantEase) and ``spqr`` solve layer by layer inside the same grouped
interface, as in the reference.  Those three return no grid: their Ŵ is
off any single uniform grid, so ``emit="qt"`` re-derives one from Ŵ (the
reference's lossy fallback, kept as it is so the artifact is the
reference's).

Mixed precision: :class:`LayerSpec` overrides in ``PTQConfig.layer_specs``
(keyed by layer path, ``"dec.p0.b1/wq"``, or bare leaf name) resolve per
layer through :meth:`PTQConfig.for_layer`, and same-shape groups split by
the effective per-layer config.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import quantease
from repro_torch.core.awq import awq_quantize, awq_then_quantease
from repro_torch.core.calib import CalibStats
from repro_torch.core.gptq import gptq_quantize
from repro_torch.core.outlier import outlier_quantease, power_lambda_max
from repro_torch.core.spqr import spqr_quantize
from repro_torch.core.quantease import relative_error
from repro_torch.device import require_on_device
from repro_torch.models import model as M
from repro_torch.models.common import capture_gram_stats, capture_scope
from repro_torch.quant import (
    GridSpec,
    QuantizedTensor,
    compute_grid,
    pack_codes,
    quantize_codes,
    quantize_dequantize,
)

__all__ = ["LayerSpec", "PTQConfig", "ptq_quantize_model", "QUANTIZABLE"]

QUANTIZABLE = {"wq", "wk", "wv", "wo", "wg", "wu", "wd"}
_METHODS = ("rtn", "gptq", "awq", "quantease", "awq_qe", "spqr", "qe_outlier",
            "qe_outlier_struct")
_PER_LAYER = ("awq", "awq_qe", "spqr")

# Tells "inherit the base config's" from an explicit ``None`` (one group
# spanning the row) for ``LayerSpec.group_size``.
_INHERIT = "__inherit__"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Per-layer override of the global :class:`PTQConfig`; a field left at
    its default inherits the base config's."""

    bits: Optional[int] = None
    group_size: object = _INHERIT
    outlier_frac: Optional[float] = None
    method: Optional[str] = None
    iterations: Optional[int] = None


@dataclasses.dataclass
class PTQConfig:
    method: str = "quantease"  # rtn|gptq|awq|quantease|awq_qe|spqr|qe_outlier|qe_outlier_struct
    spec: GridSpec = dataclasses.field(default_factory=lambda: GridSpec(bits=4))
    iterations: int = 25
    outlier_frac: float = 0.01  # outlier budget of the qe_outlier methods, per matrix
    percdamp: float = 0.01
    block_size: int = 128  # GPTQ's column block (lazy-batch width)
    emit: str = "fake"  # "fake" (dequantized, param dtype) | "qt" (QuantizedTensor)
    init_from_gptq: bool = False  # QuantEase warm start from GPTQ's Ŵ (paper §3.1)
    use_kernel: str = "auto"  # see QuantEaseConfig
    matmul_dtype: str = "float32"
    # Feed the capture pass and the recompute of each block's outputs at
    # most this many sequences at a time (0 = a whole calibration batch), so
    # transient activation memory is bounded whatever the calibration set's
    # size; Σ is the same sum in another order.
    stream_chunk: int = 0
    # Per-layer overrides keyed by layer path ("dec.p0.b1/wq") or bare leaf
    # name ("wq"); the exact path wins.
    layer_specs: Optional[dict] = None
    # The tuner's sensitivity signal: each progress record also carries the
    # block's per-layer λ_max(Σ) (power iteration) under "lambda_max".
    collect_sensitivity: bool = False

    def qe_config(self) -> quantease.QuantEaseConfig:
        """The CD-solver config this run resolves to.  As in the reference,
        the column block is QuantEaseConfig's default, B = 256
        (``block_size`` serves GPTQ only)."""
        return quantease.QuantEaseConfig(
            iterations=self.iterations,
            percdamp=self.percdamp,
            use_kernel=self.use_kernel,
            matmul_dtype=self.matmul_dtype,
        )

    def for_layer(self, key: str) -> "PTQConfig":
        """The effective config of one layer path: an exact-path entry of
        ``layer_specs``, else a bare-name one, else the base config.  The
        result has ``layer_specs=None``."""
        if not self.layer_specs:
            return self
        ov = self.layer_specs.get(key)
        if ov is None:
            ov = self.layer_specs.get(key.rsplit("/", 1)[-1])
        if ov is None:
            return dataclasses.replace(self, layer_specs=None)
        pick = lambda mine, base: base if mine is None else mine
        spec = dataclasses.replace(
            self.spec, bits=pick(ov.bits, self.spec.bits),
            group_size=self.spec.group_size if ov.group_size is _INHERIT else ov.group_size,
        )
        return dataclasses.replace(
            self, layer_specs=None, spec=spec, method=pick(ov.method, self.method),
            outlier_frac=pick(ov.outlier_frac, self.outlier_frac),
            iterations=pick(ov.iterations, self.iterations),
        )

    def _group_key(self) -> tuple:
        """Everything that changes a grouped solve."""
        return (self.method, self.spec, self.outlier_frac, self.iterations, self.init_from_gptq)


def _outlier_budget(cfg: PTQConfig, q: int, p: int) -> int:
    return max(int(cfg.outlier_frac * q * p), 1)


def _solve_one(w, sigma, cfg: PTQConfig):
    """One ``(q, p)`` layer of a per-layer method → Ŵ fp32."""
    if cfg.method == "awq":
        return awq_quantize(w, sigma, cfg.spec)
    if cfg.method == "awq_qe":
        return awq_then_quantease(w, sigma, cfg.spec, iterations=cfg.iterations,
                                  percdamp=cfg.percdamp)
    return spqr_quantize(w, sigma, cfg.spec, s=_outlier_budget(cfg, *w.shape),
                         percdamp=cfg.percdamp, block_size=cfg.block_size)[0]


def _solve_group(w3, sig3, cfg: PTQConfig):
    """(G, q, p) × (G, p, p) → (Ŵ (G, q, p), Ĥ (G, q, p) or None, batched
    grid the solve quantized onto, or None for the per-layer methods)."""
    if cfg.method in _PER_LAYER:
        return torch.stack([_solve_one(w, s, cfg) for w, s in zip(w3, sig3)]), None, None
    if cfg.method in ("qe_outlier", "qe_outlier_struct"):
        res = outlier_quantease(
            w3, sig3, cfg.spec, s=_outlier_budget(cfg, *w3.shape[-2:]),
            iterations=cfg.iterations, structured=cfg.method.endswith("struct"),
            percdamp=cfg.percdamp, use_kernel=cfg.use_kernel, matmul_dtype=cfg.matmul_dtype,
        )
        return res.w_hat, res.h, res.grid
    grid3 = compute_grid(w3, cfg.spec)
    if cfg.method == "rtn":
        return quantize_dequantize(w3, grid3), None, grid3
    w_gptq = None
    if cfg.method == "gptq" or cfg.init_from_gptq:
        w_gptq = gptq_quantize(w3, sig3, cfg.spec, percdamp=cfg.percdamp,
                               block_size=cfg.block_size, grid=grid3)
    if cfg.method == "gptq":
        return w_gptq, None, grid3
    w_hat, _ = quantease.quantease_quantize(
        w3, sig3, cfg.spec, w_init=w_gptq, grid=grid3, **cfg.qe_config().solve_kwargs()
    )
    return w_hat, None, grid3


def _to_2d(w: torch.Tensor, d_in: int) -> torch.Tensor:
    return w.reshape(d_in, -1).T.to(torch.float32)  # (out, in)


def _emit_leaf(w_hat, h, like, cfg: PTQConfig, grid):
    """One solved linear → its leaf: the dequantized effective weights
    (``emit="fake"``), or a QuantizedTensor whose codes are Ŵ on the grid
    the solve used and, with an Ĥ, whose COO planes hold Ĥ's top-s entries
    (flat int32 ``row·p + col``, fp16 values; §5.4's 48 bits an outlier).
    Without a grid (``awq``, ``awq_qe``, ``spqr``) one is re-derived from
    Ŵ, lossy where Ŵ does not reach its grid's extremes."""
    if cfg.emit == "fake":
        w_eff = w_hat if h is None else w_hat + h
        return w_eff.T.reshape(like.shape).to(like.dtype)
    if grid is None:
        grid = compute_grid(w_hat, cfg.spec)
    codes = quantize_codes(w_hat, grid)
    packed = cfg.spec.bits == 4 and codes.shape[-1] % 2 == 0
    if packed:
        codes = pack_codes(codes, 4)
    qt = QuantizedTensor(
        codes=codes, scale=grid.scale, zero=grid.zero, bits=cfg.spec.bits,
        group_size=cfg.spec.group_size, packed=packed,
    )
    if h is not None:
        # ‖Ĥ‖₀ ≤ s, so the top-s by |value| hold its support; ties (zeros,
        # when the structured Ĥ has fewer entries) go to the lower index,
        # in descending order, as the reference's top_k.
        flat = h.reshape(-1)
        idx = torch.sort(flat.abs(), descending=True, stable=True).indices[
            : _outlier_budget(cfg, *w_hat.shape)]
        qt = dataclasses.replace(
            qt, outlier_values=flat[idx].to(torch.float16), outlier_idx=idx.to(torch.int32),
        )
    return qt


def _quantize_block(p_blk: dict, stats: dict, scope: str, cfg: PTQConfig, report: dict,
                    sens: Optional[dict] = None) -> dict:
    """Quantize every captured linear of one block, grouped by shape and
    effective per-layer config (layers given other bits or another method
    never share a solve).  With ``cfg.collect_sensitivity``, ``sens`` gets
    each layer's λ_max(Σ) under its report key.

    Leaves are visited in sorted order, the order of the reference's
    param pytrees, so groups and report keys come out in the same order."""
    groups: dict[tuple, tuple] = {}
    for name in sorted(p_blk):
        key = f"{scope}/{name}"
        if name not in QUANTIZABLE or key not in stats:
            continue
        st: CalibStats = stats[key]
        w2 = _to_2d(p_blk[name], st.p)
        eff = cfg.for_layer(key)
        if eff.method not in _METHODS:
            raise ValueError(f"{key}: unknown method {eff.method!r} (have {_METHODS})")
        gk = (tuple(w2.shape), eff._group_key())
        groups.setdefault(gk, (eff, []))[1].append((name, key, w2, st.sigma))
    new = dict(p_blk)
    for eff, group in groups.values():
        w3 = torch.stack([it[2] for it in group])
        sig3 = torch.stack([it[3] for it in group])
        w_hat3, h3, grid3 = _solve_group(w3, sig3, eff)
        errs = relative_error(w3, w_hat3 if h3 is None else w_hat3 + h3, sig3).tolist()
        if cfg.collect_sensitivity and sens is not None:
            lam = power_lambda_max(sig3).tolist()
            for g, (_, key, _, _) in enumerate(group):
                sens[key] = float(lam[g])
        for g, (name, key, _, _) in enumerate(group):
            report[key] = float(errs[g])
            new[name] = _emit_leaf(w_hat3[g], None if h3 is None else h3[g], p_blk[name], eff,
                                   None if grid3 is None else grid3[g])
    return new


def _apply_block(plan, b, blk, x, chunk: int = 0) -> torch.Tensor:
    pos = torch.arange(x.shape[1], device=x.device)
    parts = x.split(chunk) if chunk else (x,)
    outs = [M._block_apply(plan.cfg, plan.heads, b, blk, xc, mode="train", pos_ids=pos)
            for xc in parts]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


@torch.no_grad()
def ptq_quantize_model(
    plan: M.ModelPlan,
    params: dict,
    calib_batches: list,
    cfg: PTQConfig,
    progress_cb: Optional[Callable[[dict], None]] = None,
    *,
    device="cuda",
):
    """Quantize the decoder stack.  Returns ``(new_params, report)``, report
    mapping layer path → relative reconstruction error.

    ``emit="fake"`` keeps the stacked layout with dequantized values;
    ``emit="qt"`` returns ``new_params["dec"]`` as a per-period list of
    blocks with QuantizedTensor leaves (restack it with
    :func:`repro_torch.serve.qparams.quantize_params_for_serving`).  The
    params must live on ``device`` (default ``"cuda"``).
    """
    if cfg.method not in _METHODS:
        raise ValueError(f"unknown method {cfg.method!r} (have {_METHODS})")
    if cfg.emit not in ("fake", "qt"):
        raise ValueError(f"unknown emit {cfg.emit!r}")
    dev = require_on_device(params["embed"], device)
    xs = [M._embed_tokens(plan, params, M.as_tokens(b["tokens"], dev)) for b in calib_batches]
    report: dict[str, float] = {}
    new_params = dict(params)
    new_params["dec"] = _quantize_stack(plan, params["dec"], xs, cfg, report, progress_cb)
    return new_params, report


def _quantize_period(plan, p_period: dict, period: int, xs: list, cfg: PTQConfig,
                     report: dict, progress_cb=None):
    """Quantize the blocks of one period in order, each on the outputs of
    the quantized blocks before it.  Returns ``(new_period, xs_out)``."""
    pattern = plan.cfg.pattern
    new_period = {}
    for i, b in enumerate(pattern):
        t0 = time.monotonic()
        scope = f"dec.p{period}.b{i}"
        stats: dict[str, CalibStats] = {}
        with capture_gram_stats(stats), capture_scope(scope):
            for x in xs:
                _apply_block(plan, b, p_period[f"b{i}"], x, cfg.stream_chunk)
        n_before = len(report)
        sens: dict[str, float] = {}
        new_blk = _quantize_block(p_period[f"b{i}"], stats, scope, cfg, report, sens)
        new_period[f"b{i}"] = new_blk
        # Recompute this block's outputs with its quantized weights.
        xs = [_apply_block(plan, b, new_blk, x, cfg.stream_chunk) for x in xs]
        if progress_cb is not None:
            new_keys = list(report)[n_before:]
            errs = [report[k] for k in new_keys]
            rec = {
                "stack": "dec",
                "period": period,
                "block": i,
                "done_blocks": period * len(pattern) + i + 1,
                "total_blocks": plan.cfg.n_periods * len(pattern),
                "n_linears": len(new_keys),
                "mean_rel_error": float(np.mean(errs)) if errs else 0.0,
                "layer_errors": {k: float(report[k]) for k in new_keys},
                "seconds": round(time.monotonic() - t0, 3),
            }
            if sens:
                rec["lambda_max"] = sens
            progress_cb(rec)
    return new_period, xs


def _quantize_stack(plan, stack, xs, cfg: PTQConfig, report: dict, progress_cb):
    quantized_periods = []
    stack_out = M.tree_map(torch.clone, stack) if cfg.emit == "fake" else None
    for period in range(plan.cfg.n_periods):
        p_period = M.period_slice(stack, period)
        new_period, xs = _quantize_period(plan, p_period, period, xs, cfg, report, progress_cb)
        quantized_periods.append(new_period)
        if cfg.emit == "fake":
            for key, blk in new_period.items():
                for name, leaf in blk.items():
                    if name in QUANTIZABLE:  # the norms (dicts) are unchanged
                        stack_out[key][name][period] = leaf.to(stack_out[key][name].dtype)
    return quantized_periods if cfg.emit == "qt" else stack_out
