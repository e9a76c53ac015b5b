"""Accuracy-driven per-layer mixed-precision tuning (the port of
``repro.tune``): given a storage budget in average bits per weight (COO
outliers at 48 bits each), which layers get 2 bits and which 8.

* :mod:`.sensitivity`: per-layer error tables and λ_max(Σ) from RTN probe
  passes of the whole-model PTQ driver;
* :mod:`.allocate`: a deterministic greedy descent in marginal error under
  the budget (prefix semantics: never over budget, monotone in it);
* :mod:`.search`: candidate allocations, the uniform one always among them,
  quantized with ``PTQConfig.layer_specs``, restacked into the serving
  layout (mixed bits through ``serve.qparams.harmonize_qt_stack``) and
  scored by the eval scorer's perplexity.

``repro_torch.launch.tune`` is the resumable command line.
"""

from repro_torch.tune.allocate import (
    AllocConfig,
    Allocation,
    allocate,
    allocation_layer_specs,
    upgrade_sequence,
)
from repro_torch.tune.search import (
    TuneConfig,
    build_candidates,
    evaluate_candidate,
    quantize_candidate,
    tune_model,
)
from repro_torch.tune.sensitivity import LayerStat, probe_layer_stats

__all__ = [
    "AllocConfig",
    "Allocation",
    "allocate",
    "allocation_layer_specs",
    "upgrade_sequence",
    "LayerStat",
    "probe_layer_stats",
    "TuneConfig",
    "build_candidates",
    "evaluate_candidate",
    "quantize_candidate",
    "tune_model",
]
