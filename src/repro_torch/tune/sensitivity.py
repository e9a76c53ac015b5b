"""Per-layer probes for the mixed-precision tuner.

For every quantizable layer the allocator (:mod:`.allocate`) needs its
relative reconstruction error at each candidate width, measured on the
calibration stream with the quantized prefix's error propagated as the real
solve sees it; its sensitivity weight, λ_max of its calibration Gram Σ
(``core.outlier.power_lambda_max``: how strongly weight error is amplified
into activation error); and its size in weights, the budget's denominator.

All three come from RTN passes of the whole-model PTQ driver, one per
candidate width (RTN runs no CD iteration and ranks layers as the full solve
does), with λ_max collected on the first (``PTQConfig.collect_sensitivity``).
The errors arrive unrounded through the solver's ``layer_errors`` progress
records.  Optional ``qe_outlier`` probes give the errors with an outlier
budget attached.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

__all__ = ["LayerStat", "probe_layer_stats"]

_EXPERT_RE = re.compile(r"\.e\d+$")


@dataclasses.dataclass
class LayerStat:
    """Probe summary of one quantizable leaf (a solver layer path)."""

    key: str  # "dec.p0.b0/wq": PTQConfig.layer_specs granularity
    n_weights: int  # q·p (×E for an MoE leaf: the budget counts every expert)
    lambda_max: float  # λ_max(Σ), power iteration; MoE: mean over the experts
    err: dict = dataclasses.field(default_factory=dict)
    # err[bits]          -> relative reconstruction error at that width
    # err[(bits, frac)]  -> with an outlier budget attached (optional probes)


def _leaf_key(report_key: str) -> str:
    """A report key's leaf path: per-expert keys (``…/w_gate.e3``) collapse
    onto their leaf."""
    return _EXPERT_RE.sub("", report_key)


def _leaf_sizes(plan, params) -> dict:
    """Weights per quantizable leaf path, from the dense stacked params (an
    MoE leaf counts all its experts), the decoder's and then an
    encoder-decoder model's encoder's."""
    from repro_torch.core.solver import QUANTIZABLE
    from repro_torch.models import model as M

    cfg = plan.cfg
    sizes = {}

    def walk(stack_name):
        pattern, n_periods = M.stack_layout(cfg, stack_name)
        for i, _ in enumerate(pattern):
            for name, leaf in params[stack_name][f"b{i}"].items():
                if name in QUANTIZABLE:
                    for period in range(n_periods):
                        sizes[f"{stack_name}.p{period}.b{i}/{name}"] = leaf.numel() // n_periods

    walk("dec")
    if "enc" in params and cfg.n_enc_periods:
        walk("enc")
    return sizes


def probe_layer_stats(plan, params, calib: list, *, bits_candidates: tuple = (2, 3, 4, 8),
                      outlier_cells: tuple = (), outlier_iterations: int = 4, progress_cb=None,
                      device="cuda") -> dict:
    """Run the probe passes; returns ``{leaf_key: LayerStat}``.

    ``outlier_cells``, ``((bits, frac), ...)``, adds ``qe_outlier`` probes
    (these run CD iterations: keep the list short).  The params must live on
    ``device`` (default ``"cuda"``)."""
    from repro_torch.core.solver import PTQConfig, ptq_quantize_model
    from repro_torch.quant import GridSpec

    stats: dict[str, LayerStat] = {}
    sizes = _leaf_sizes(plan, params)

    def fold(records: list, label):
        errs: dict[str, list] = {}
        lams: dict[str, list] = {}
        for rec in records:
            for k, v in rec.get("layer_errors", {}).items():
                errs.setdefault(_leaf_key(k), []).append(v)
            for k, v in rec.get("lambda_max", {}).items():
                lams.setdefault(_leaf_key(k), []).append(v)
        for k, vs in errs.items():
            if k not in stats:
                stats[k] = LayerStat(key=k, n_weights=sizes.get(k, 0), lambda_max=0.0)
            stats[k].err[label] = float(np.mean(vs))
        for k, vs in lams.items():
            if k in stats:
                stats[k].lambda_max = float(np.mean(vs))

    for j, bits in enumerate(bits_candidates):
        records: list = []
        cfg = PTQConfig(method="rtn", spec=GridSpec(bits=bits),
                        collect_sensitivity=(j == 0))  # λ_max does not depend on bits
        ptq_quantize_model(plan, params, calib, cfg, progress_cb=records.append, device=device)
        fold(records, bits)
        if progress_cb:
            progress_cb({"probe": f"rtn@{bits}", "layers": len(stats)})

    for bits, frac in outlier_cells:
        records = []
        cfg = PTQConfig(method="qe_outlier", spec=GridSpec(bits=bits), outlier_frac=frac,
                        iterations=outlier_iterations)
        ptq_quantize_model(plan, params, calib, cfg, progress_cb=records.append, device=device)
        fold(records, (bits, frac))
        if progress_cb:
            progress_cb({"probe": f"qe_outlier@{bits}/f{frac}", "layers": len(stats)})
    return stats
