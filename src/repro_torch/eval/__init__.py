"""End-to-end evaluation: perplexity and synthetic task accuracy.

* :mod:`.scorer`: batched teacher-forced log-likelihood, chunked over the
  sequence, and the prefill-path next-token logits of the parity bridge;
* :mod:`.tasks`: cloze top-k and multi-choice continuation scoring;
* :mod:`.harness`: the method × bits × outlier grid, the scorer-vs-serving
  parity check and the document's schema guard.
"""

from repro_torch.eval.harness import (
    EVAL_SCHEMA,
    engine_parity,
    eval_model,
    quantized_parity,
    run_grid,
    validate_doc,
)
from repro_torch.eval.scorer import make_scorer, next_token_logits, perplexity_on_stream
from repro_torch.eval.tasks import cloze_accuracy, continuation_choice

__all__ = [
    "EVAL_SCHEMA",
    "make_scorer",
    "next_token_logits",
    "perplexity_on_stream",
    "cloze_accuracy",
    "continuation_choice",
    "eval_model",
    "run_grid",
    "engine_parity",
    "quantized_parity",
    "validate_doc",
]
