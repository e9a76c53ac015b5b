"""Whole-model PTQ: the paper's pipeline over a decoder stack.

* Calibration batches run through the model block by block; each block's
  inputs are the outputs of the already-quantized prefix.
* Streaming Σ capture: every linear folds each batch into its fp32
  Σ = XXᵀ the moment it is computed (:func:`capture_gram_stats`).
* Batched solves: same-shape linears of a block (wq/wk/wv/wo; wg/wu; wd;
  a Mamba block's wz/wx, which share their input) are stacked and solved
  by one ``quantease_quantize`` call.  An MoE
  matrix adds its E experts to the group (each expert's own Σ, from the
  dispatch table), so OLMoE's w_gate and w_up form one group of 2E; its
  report has one key per expert, ``…/w_gate.e{i}``.
* Grids are computed once from the original weights and threaded through
  the solve and the emit, so emitted codes round-trip the solve exactly.
* An encoder-decoder model's encoder is quantized first, on the
  calibration frames; its quantized output, frozen, is what the decoder's
  cross-attention blocks see while the decoder is quantized.  A prefix
  model's calibration patches, normed, come before the tokens.
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

Sharded PTQ (``mesh=`` a data mesh, ``cfg.shard``), the reference's
semantics on one rank per device:

* Data: each calibration batch splits over "data" by whole sequences, in
  contiguous blocks of ``ceil(B / n)`` (as a batch-sharded JAX array lays
  them out; the last ranks' blocks may be short, never empty).  Each rank
  pushes its own sequences through every block, so the next block's inputs
  never leave the rank.  Each rank folds its rows into local Σ's; at the
  end of a block's capture pass one ``all_reduce`` per linear (in sorted
  key order) makes them global, the same bits on every rank.  An MoE
  block dispatches each rank's own sequences, so where its capacity drops
  tokens the per-expert Σ can differ from the whole batch's (as
  ``stream_chunk`` chunks do, in both packages).
* Rows: ``rtn``, ``gptq`` and ``quantease`` split each group's output rows
  over "data" (rows are independent in every column sweep): q pads to a
  multiple of the rank count with zero rows on a unit pad scale, each rank
  solves its block of rows on its own device (the CUDA kernels at q/n
  rows), and an all-gather hands every rank the whole group.
  ``qe_outlier``/``qe_outlier_struct`` (the top-s projection is global),
  ``awq``, ``awq_qe`` and ``spqr`` run whole on every rank, on the same
  global Σ.
* The progress records come out of rank 0 only; every rank returns the
  same params and report.  With one rank, or ``cfg.shard`` false, the path
  is the local one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import quantease
from repro_torch.core.awq import awq_quantize, awq_then_quantease
from repro_torch.core.calib import CalibStats, shard_axis
from repro_torch.core.gptq import gptq_quantize
from repro_torch.core.outlier import outlier_quantease, power_lambda_max
from repro_torch.core.spqr import spqr_quantize
from repro_torch.core.quantease import relative_error
from repro_torch.device import require_on_device
from repro_torch.dist.collectives import all_reduce, axis_rank, axis_size, block_bounds, gather_dim
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
from repro_torch.quant.grid import Grid

__all__ = ["LayerSpec", "PTQConfig", "ptq_quantize_model", "QUANTIZABLE"]

# Every linear the model routes through ``apply_linear`` but the Mamba
# block's Δ projection ``wdt`` (numerically critical, as in the reference),
# the MoE router, norms and biases.
QUANTIZABLE = {"wq", "wk", "wv", "wo", "wq_c", "wk_c", "wv_c", "wo_c", "wg", "wu", "wd", "wz",
               "wx", "wbc", "out_proj", "w_gate", "w_up", "w_down"}
_MOE_NAMES = {"w_gate", "w_up", "w_down"}
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
    # Shard Σ accumulation over the mesh's data dim and the CD solve over
    # output rows, when a mesh is passed to ptq_quantize_model.
    shard: bool = False

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


def _solve_group(w3, sig3, cfg: PTQConfig, mesh=None):
    """(G, q, p) × (G, p, p) → (Ŵ (G, q, p), Ĥ (G, q, p) or None, batched
    grid the solve quantized onto, or None for the per-layer methods).
    ``mesh``: a data mesh the batched methods (``rtn``, ``gptq``,
    ``quantease``) split the rows over; the others run whole."""
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
    if axis_size(mesh, shard_axis(mesh)) > 1:
        return _shard_rows(w3, sig3, grid3, cfg, mesh), None, grid3
    return _solve_batched(w3, sig3, grid3, cfg), None, grid3


def _solve_batched(w3, sig3, grid3: Grid, cfg: PTQConfig):
    """Ŵ of a batched method (``rtn``, ``gptq``, ``quantease``) on ``grid3``."""
    if cfg.method == "rtn":
        return quantize_dequantize(w3, grid3)
    w_gptq = None
    if cfg.method == "gptq" or cfg.init_from_gptq:
        w_gptq = gptq_quantize(w3, sig3, cfg.spec, percdamp=cfg.percdamp,
                               block_size=cfg.block_size, grid=grid3)
    if cfg.method == "gptq":
        return w_gptq
    w_hat, _ = quantease.quantease_quantize(
        w3, sig3, cfg.spec, w_init=w_gptq, grid=grid3, **cfg.qe_config().solve_kwargs()
    )
    return w_hat


def _shard_rows(w3, sig3, grid3: Grid, cfg: PTQConfig, mesh):
    """A batched solve split over the output rows q across the mesh's data
    dim.  Row i's update never reads row j, so the split is exact; each
    row's grid goes with it.  q pads to a multiple of the rank count with
    zero rows on a unit pad scale (quantized in isolation and stripped);
    each rank solves its contiguous block of rows, and an all-gather hands
    every rank all of them, in rank order."""
    axis = shard_axis(mesh)
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    q = w3.shape[1]
    per = -(-q // n)
    pad = per * n - q
    if pad:
        w3 = torch.nn.functional.pad(w3, (0, 0, 0, pad))
        grid3 = dataclasses.replace(
            grid3, scale=torch.nn.functional.pad(grid3.scale, (0, 0, 0, pad), value=1.0),
            zero=torch.nn.functional.pad(grid3.zero, (0, 0, 0, pad)))
    rows = slice(r * per, (r + 1) * per)
    mine = dataclasses.replace(grid3, scale=grid3.scale[:, rows].contiguous(),
                               zero=grid3.zero[:, rows].contiguous())
    w_hat = _solve_batched(w3[:, rows].contiguous(), sig3, mine, cfg)
    return gather_dim(w_hat, 1, mesh, axis)[:, :q]


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


def _expert_keys(name: str, key: str, n: int) -> list:
    """Report keys of a linear's ``n`` solver rows: the key itself, or one
    ``key.e{i}`` per expert of an MoE matrix."""
    return [f"{key}.e{e}" for e in range(n)] if name in _MOE_NAMES else [key]


def _quantize_block(p_blk: dict, stats: dict, scope: str, cfg: PTQConfig, report: dict,
                    sens: Optional[dict] = None, mesh=None) -> dict:
    """Quantize every captured linear of one block, grouped by shape and
    effective per-layer config (layers given other bits or another method
    never share a solve).  With ``cfg.collect_sensitivity``, ``sens`` gets
    each layer's λ_max(Σ) under its report key.

    Leaves are visited in sorted order, the order of the reference's
    param pytrees, so groups and report keys come out in the same order.
    An MoE matrix ``(E, d_in, d_out)`` with Σ ``(E, p, p)`` enters its group
    as E rows.  ``mesh``: the data mesh the batched solves split rows over."""
    groups: dict[tuple, tuple] = {}
    for name in sorted(p_blk):
        key = f"{scope}/{name}"
        if name not in QUANTIZABLE or key not in stats:
            continue
        st: CalibStats = stats[key]
        if name in _MOE_NAMES:  # (E, d_in, d_out) → (E, out, in)
            w3, sig3 = p_blk[name].transpose(1, 2).to(torch.float32), st.sigma
        else:
            w3, sig3 = _to_2d(p_blk[name], st.p)[None], st.sigma[None]
        eff = cfg.for_layer(key)
        if eff.method not in _METHODS:
            raise ValueError(f"{key}: unknown method {eff.method!r} (have {_METHODS})")
        gk = (tuple(w3.shape[1:]), eff._group_key())
        groups.setdefault(gk, (eff, []))[1].append((name, key, w3, sig3))
    new = dict(p_blk)
    for eff, group in groups.values():
        w3 = torch.cat([it[2] for it in group])
        sig3 = torch.cat([it[3] for it in group])
        w_hat3, h3, grid3 = _solve_group(w3, sig3, eff, mesh)
        errs = relative_error(w3, w_hat3 if h3 is None else w_hat3 + h3, sig3).tolist()
        lam = None
        if cfg.collect_sensitivity and sens is not None:
            lam = power_lambda_max(sig3).tolist()
        off = 0
        for name, key, w3_it, _ in group:
            n = w3_it.shape[0]
            for g, k in enumerate(_expert_keys(name, key, n), start=off):
                report[k] = float(errs[g])
                if lam is not None:
                    sens[k] = float(lam[g])
            leaves = [_emit_leaf(w_hat3[g], None if h3 is None else h3[g],
                                 p_blk[name][g - off] if name in _MOE_NAMES else p_blk[name], eff,
                                 None if grid3 is None else grid3[g])
                      for g in range(off, off + n)]
            new[name] = leaves[0] if name not in _MOE_NAMES else _stack_experts(leaves)
            off += n
    return new


def _stack_experts(leaves: list):
    """Per-expert leaves → one leaf with a leading expert axis (a dense
    tensor, or a QuantizedTensor whose arrays all gain the axis)."""
    first = leaves[0]
    if not isinstance(first, QuantizedTensor):
        return torch.stack(leaves)
    arrays = {f.name: torch.stack([getattr(l, f.name) for l in leaves])
              for f in dataclasses.fields(first) if isinstance(getattr(first, f.name), torch.Tensor)}
    return dataclasses.replace(first, **arrays)


def _apply_block(plan, b, blk, x, chunk: int = 0, enc_out=None) -> torch.Tensor:
    """One block over ``x`` in slices of at most ``chunk`` sequences (0: the
    whole batch), ``enc_out`` sliced beside it."""
    pos = torch.arange(x.shape[1], device=x.device)
    parts = x.split(chunk) if chunk else (x,)
    eo = enc_out.split(chunk) if chunk and enc_out is not None else (enc_out,) * len(parts)
    outs = [M._block_apply(plan.cfg, plan.heads, b, blk, xc, mode="train", pos_ids=pos,
                           enc_out=ec)
            for xc, ec in zip(parts, eo)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


@torch.no_grad()
def ptq_quantize_model(
    plan: M.ModelPlan,
    params: dict,
    calib_batches: list,
    cfg: PTQConfig,
    progress_cb: Optional[Callable[[dict], None]] = None,
    *,
    mesh=None,
    device="cuda",
):
    """Quantize the decoder stack, and first the encoder's of an
    encoder-decoder model.  Returns ``(new_params, report)``, report
    mapping layer path (``dec.p0.b0/wq``, ``enc.p0.b0/wq``) → relative
    reconstruction error.

    A calibration batch carries ``"tokens"``, and ``"frames"`` or
    ``"patches"`` for the encoder-decoder and prefix families.  The encoder
    is quantized block by block on the frames (plus ``enc_pos_emb``); its
    quantized output, ``enc_final_norm``-ed, is then frozen and the
    decoder's cross-attention blocks read it, split beside each batch by
    ``stream_chunk``.

    ``emit="fake"`` keeps the stacked layout with dequantized values;
    ``emit="qt"`` returns ``new_params["dec"]`` (and ``["enc"]``) as a
    per-period list of blocks with QuantizedTensor leaves (restack them
    with :func:`repro_torch.serve.qparams.quantize_params_for_serving`).
    The params must live on ``device`` (default ``"cuda"``).

    ``mesh`` (a data mesh, with ``cfg.shard``): every rank of it calls this
    with the same params and calibration batches; Σ accumulation splits the
    sequences and the batched solves split the rows over it (see the module
    docstring).  Only rank 0 calls ``progress_cb``.
    """
    if cfg.method not in _METHODS:
        raise ValueError(f"unknown method {cfg.method!r} (have {_METHODS})")
    if cfg.emit not in ("fake", "qt"):
        raise ValueError(f"unknown emit {cfg.emit!r}")
    dev = require_on_device(params["embed"], device)
    mcfg = plan.cfg
    mesh = mesh if cfg.shard and axis_size(mesh, shard_axis(mesh)) > 1 else None
    if mesh is not None:
        calib_batches = [_rank_block(b, mesh) for b in calib_batches]
        if axis_rank(mesh, shard_axis(mesh)) != 0:
            progress_cb = None
    xs = [M.decoder_inputs(plan, params, M.as_tokens(b["tokens"], dev), b) for b in calib_batches]
    report: dict[str, float] = {}
    new_params = dict(params)
    enc_outs = [None] * len(xs)
    if mcfg.family == "encdec":
        enc_in = [M.encoder_inputs(plan, params, b, dev) for b in calib_batches]
        new_params["enc"], enc_in = _quantize_stack(plan, params["enc"], enc_in, cfg, report,
                                                    progress_cb, stack="enc", mesh=mesh)
        enc_outs = [M.apply_norm(params["enc_final_norm"], e, mcfg.norm) for e in enc_in]
        del enc_in
    new_params["dec"], _ = _quantize_stack(plan, params["dec"], xs, cfg, report, progress_cb,
                                           enc_outs=enc_outs, mesh=mesh)
    return new_params, report


def _rank_block(batch: dict, mesh) -> dict:
    """This rank's contiguous block of a calibration batch's sequences."""
    axis = shard_axis(mesh)
    n_seq = len(batch["tokens"])
    lo, hi = block_bounds(n_seq, axis_size(mesh, axis), axis_rank(mesh, axis))
    if hi <= lo:
        raise ValueError(f"a calibration batch of {n_seq} sequences leaves rank "
                         f"{axis_rank(mesh, axis)} of {axis_size(mesh, axis)} none")
    return {k: v[lo:hi] for k, v in batch.items()}


def _quantize_period(plan, p_period: dict, period: int, xs: list, cfg: PTQConfig,
                     report: dict, progress_cb=None, *, stack: str = "dec", enc_outs=None,
                     mesh=None):
    """Quantize the blocks of one period of ``stack`` (``"dec"`` or
    ``"enc"``) in order, each on the outputs of the quantized blocks before
    it (a cross block also on ``enc_outs``, one per batch).  Under a data
    ``mesh`` ``xs`` are this rank's sequences and each Σ is reduced over
    the mesh after the capture pass.  Returns ``(new_period, xs_out)``."""
    mcfg = plan.cfg
    pattern, n_periods = M.stack_layout(mcfg, stack)
    enc_outs = enc_outs or [None] * len(xs)
    new_period = {}
    for i, b in enumerate(pattern):
        t0 = time.monotonic()
        scope = f"{stack}.p{period}.b{i}"
        stats: dict[str, CalibStats] = {}
        with capture_gram_stats(stats), capture_scope(scope):
            for x, eo in zip(xs, enc_outs):
                _apply_block(plan, b, p_period[f"b{i}"], x, cfg.stream_chunk, eo)
        if mesh is not None:
            for key in sorted(stats):
                all_reduce(stats[key].sigma, mesh, shard_axis(mesh))
        n_before = len(report)
        sens: dict[str, float] = {}
        new_blk = _quantize_block(p_period[f"b{i}"], stats, scope, cfg, report, sens, mesh)
        new_period[f"b{i}"] = new_blk
        # Recompute this block's outputs with its quantized weights.
        xs = [_apply_block(plan, b, new_blk, x, cfg.stream_chunk, eo)
              for x, eo in zip(xs, enc_outs)]
        if progress_cb is not None:
            new_keys = list(report)[n_before:]
            errs = [report[k] for k in new_keys]
            rec = {
                "stack": stack,
                "period": period,
                "block": i,
                "done_blocks": period * len(pattern) + i + 1,
                "total_blocks": n_periods * len(pattern),
                "n_linears": len(new_keys),
                "mean_rel_error": float(np.mean(errs)) if errs else 0.0,
                "layer_errors": {k: float(report[k]) for k in new_keys},
                "seconds": round(time.monotonic() - t0, 3),
            }
            if sens:
                rec["lambda_max"] = sens
            progress_cb(rec)
    return new_period, xs


def _quantize_stack(plan, params_stack, xs, cfg: PTQConfig, report: dict, progress_cb, *,
                    stack: str = "dec", enc_outs=None, mesh=None):
    """Quantize one stack period by period.  Returns ``(stack, xs_out)``:
    the stacked fake-quantized leaves, or with ``emit="qt"`` the per-period
    list; and the last block's outputs."""
    quantized_periods = []
    stack_out = M.tree_map(torch.clone, params_stack) if cfg.emit == "fake" else None
    for period in range(M.stack_layout(plan.cfg, stack)[1]):
        p_period = M.period_slice(params_stack, period)
        new_period, xs = _quantize_period(plan, p_period, period, xs, cfg, report, progress_cb,
                                          stack=stack, enc_outs=enc_outs, mesh=mesh)
        quantized_periods.append(new_period)
        if cfg.emit == "fake":
            for key, blk in new_period.items():
                for name, leaf in blk.items():
                    if name in QUANTIZABLE:  # the norms (dicts) are unchanged
                        stack_out[key][name][period] = leaf.to(stack_out[key][name].dtype)
    return (quantized_periods if cfg.emit == "qt" else stack_out), xs
