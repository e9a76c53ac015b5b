"""Teacher-forced scorer: full-model log-likelihood with bounded memory.

Scores token streams against any parameter tree the model accepts: dense,
fake-quant (``emit="fake"``), or the serving artifact itself, stacked
QuantizedTensor leaves from ``serve.qparams.quantize_params_for_serving``,
whose linears run through the dequantizing GEMM.  The head is evaluated in
sequence chunks, so logits never exist at (B, S, V).  Beside the scores,
:func:`next_token_logits` gives the prefill path's logits for one prompt:
the anchor of the scorer-vs-serving parity check
(:func:`repro_torch.eval.harness.engine_parity`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import require_on_device
from repro_torch.models import model as M
from repro_torch.models.common import softcap

__all__ = ["token_scores", "make_scorer", "next_token_logits", "perplexity_on_stream"]


@torch.no_grad()
def token_scores(plan, params, tokens, *, chunk: int = 128, device="cuda"):
    """Per-token scores ``(logprob, rank)``, both ``(B, S-1)``: position t
    scores token t+1; ``rank`` counts strictly larger logits (0 ⇒ greedy
    hit, ``rank < k`` ⇒ top-k hit).  The params must live on ``device``."""
    cfg = plan.cfg
    tokens = M.as_tokens(tokens, require_on_device(params["embed"], device))
    if tokens.shape[1] < 2:
        raise ValueError("token_scores needs sequences of at least 2 tokens")
    x = M.hidden_states(plan, params, tokens)[:, :-1]
    labels = tokens[:, 1:]
    head = M._logit_head(plan, params)
    lps, ranks = [], []
    for s0 in range(0, x.shape[1], chunk):
        logits = softcap(M._head_logits(x[:, s0 : s0 + chunk], head, M.tp_rules(plan)),
                         cfg.logit_softcap)
        vp = logits.shape[-1]
        if vp > cfg.vocab:
            logits = logits.masked_fill(torch.arange(vp, device=logits.device) >= cfg.vocab, -torch.inf)
        lse = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, labels[:, s0 : s0 + chunk, None])[..., 0]
        lps.append(gold - lse)
        ranks.append((logits > gold[..., None]).sum(-1).to(torch.int32))
    return torch.cat(lps, 1), torch.cat(ranks, 1)


def make_scorer(plan, *, chunk: int = 128, device="cuda"):
    """``(params, tokens) → (logprob, rank)`` closure for one chunk size."""

    def score(params, tokens):
        return token_scores(plan, params, tokens, chunk=chunk, device=device)

    return score


@torch.no_grad()
def next_token_logits(plan, params, prompt, *, device="cuda") -> np.ndarray:
    """Prefill-path logits predicting the token after ``prompt``, fp32 numpy.

    Runs :func:`repro_torch.models.model.prefill` on the unpadded prompt
    (batch 1, a cache sized to the prompt): the prefill path the serving
    engines execute.  The params must live on ``device``."""
    dev = require_on_device(params["embed"], device)
    prompt = np.asarray(prompt, np.int32)
    cache = M.init_cache(plan, 1, len(prompt), device=dev)
    logits, _ = M.prefill(plan, params, {"tokens": prompt[None]}, cache)
    return logits[0].to(torch.float32).cpu().numpy()


def perplexity_on_stream(plan, params, batch_fn, *, n_batches: int = 4, step0: int = 0,
                         chunk: int = 128, scorer=None, device="cuda") -> dict:
    """Mean NLL / perplexity / top-k hits over ``batch_fn(step0 + i)``; use a
    ``split="eval"`` stream, disjoint from calibration.  The params must
    live on ``device`` (default ``"cuda"``).  Returns
    ``{"nll", "ppl", "top1", "top5", "n_tokens"}``."""
    require_on_device(params["embed"], device)
    score = scorer if scorer is not None else make_scorer(plan, chunk=chunk, device=device)
    tot_lp, tot_t1, tot_t5, n_tok = 0.0, 0, 0, 0
    for i in range(n_batches):
        lp, rank = score(params, batch_fn(step0 + i)["tokens"])
        lp = lp.cpu().numpy().astype(np.float64)
        rank = rank.cpu().numpy()
        tot_lp += lp.sum()
        tot_t1 += int((rank < 1).sum())
        tot_t5 += int((rank < 5).sum())
        n_tok += lp.size
    nll = -tot_lp / max(n_tok, 1)
    return {
        "nll": float(nll),
        "ppl": float(np.exp(nll)),
        "top1": tot_t1 / max(n_tok, 1),
        "top5": tot_t5 / max(n_tok, 1),
        "n_tokens": n_tok,
    }
