"""Synthetic zero-shot-style tasks over the Markov corpus.

The paper's second metric family is zero-shot accuracy (LAMBADA, PIQA, …).
Offline, the two task shapes those benchmarks reduce to are built on the
synthetic corpus itself:

* **cloze / next-token top-k** (:func:`cloze_accuracy`): given the prefix,
  is the true next token among the model's top k?  The corpus' limited
  branching makes top-1/top-5 meaningful rather than saturated.
* **multi-choice continuation** (:func:`continuation_choice`): a prompt and
  N candidate continuations (the true one and N−1 lifted from other eval
  sequences at the same position); the model picks the candidate with the
  highest teacher-forced log-likelihood.

Both read the ``split="eval"`` stream and score through
:mod:`repro_torch.eval.scorer`, so every number belongs to the exact
parameter bytes evaluated (dense or QuantizedTensor).
"""

from __future__ import annotations

import numpy as np

from repro_torch.eval.scorer import make_scorer

__all__ = ["cloze_accuracy", "continuation_choice", "build_choice_items"]


def cloze_accuracy(
    plan, params, batch_fn, *, n_batches: int = 2, step0: int = 0,
    ks=(1, 5), chunk: int = 128, scorer=None, device="cuda",
) -> dict:
    """Top-k next-token accuracy over eval batches: ``{"top{k}": acc}``."""
    score = scorer if scorer is not None else make_scorer(plan, chunk=chunk, device=device)
    hits = {k: 0 for k in ks}
    n_tok = 0
    for i in range(n_batches):
        _, rank = score(params, batch_fn(step0 + i)["tokens"])
        rank = rank.cpu().numpy()
        for k in ks:
            hits[k] += int((rank < k).sum())
        n_tok += rank.size
    return {f"top{k}": hits[k] / max(n_tok, 1) for k in ks}


def build_choice_items(
    batch_fn, *, n_items: int, n_choices: int = 4, prompt_len: int = 32,
    cont_len: int = 8, step0: int = 0, seed: int = 0,
):
    """Assemble (n_items, n_choices, prompt_len + cont_len) token arrays.

    Item ``i`` uses eval-stream sequence ``i``'s prefix as the prompt; the
    true continuation is that sequence's actual next ``cont_len`` tokens,
    distractors are the same-position continuations of ``n_choices - 1``
    *other* sequences.  Returns ``(tokens, gold)`` with ``gold[i]`` the true
    choice index (position randomized per item).
    """
    rng = np.random.default_rng(seed)
    seqs = []
    step = step0
    while sum(s.shape[0] for s in seqs) < n_items + n_choices:
        b = np.asarray(batch_fn(step)["tokens"])
        if b.shape[1] < prompt_len + cont_len:
            raise ValueError(
                f"eval seq len {b.shape[1]} < prompt_len+cont_len "
                f"{prompt_len + cont_len}"
            )
        seqs.append(b)
        step += 1
    pool = np.concatenate(seqs, axis=0)
    L = prompt_len + cont_len
    tokens = np.zeros((n_items, n_choices, L), np.int32)
    gold = rng.integers(0, n_choices, n_items)
    n_pool = pool.shape[0]
    for i in range(n_items):
        prompt = pool[i, :prompt_len]
        # distractor sources: other pool rows, offset so none equals i
        others = [(i + 1 + j) % n_pool for j in range(n_choices - 1)]
        conts = []
        for c in range(n_choices):
            if c == gold[i]:
                conts.append(pool[i, prompt_len:L])
            else:
                src = others.pop()
                conts.append(pool[src, prompt_len:L])
        for c in range(n_choices):
            tokens[i, c, :prompt_len] = prompt
            tokens[i, c, prompt_len:] = conts[c]
    return tokens, gold


def continuation_choice(
    plan, params, batch_fn, *, n_items: int = 32, n_choices: int = 4,
    prompt_len: int = 32, cont_len: int = 8, step0: int = 0,
    chunk: int = 128, scorer=None, batch: int = 32, device="cuda",
) -> dict:
    """Multi-choice continuation accuracy: ``{"acc", "margin", "n_items"}``.

    ``margin`` is the mean (gold − best-distractor) total log-likelihood, a
    sharper quantization-degradation signal than the 0/1 accuracy.  The
    tail batch is padded with its last row, as the reference's, so every
    scorer call has one shape.
    """
    tokens, gold = build_choice_items(
        batch_fn, n_items=n_items, n_choices=n_choices,
        prompt_len=prompt_len, cont_len=cont_len, step0=step0,
    )
    flat = tokens.reshape(-1, tokens.shape[-1])
    score = scorer if scorer is not None else make_scorer(plan, chunk=chunk, device=device)
    lps = []
    for i in range(0, flat.shape[0], batch):
        rows = flat[i : i + batch]
        padded = rows
        if padded.shape[0] < batch:
            padded = np.concatenate([padded, np.repeat(padded[-1:], batch - padded.shape[0], 0)])
        lp, _ = score(params, padded)
        lps.append(lp.cpu().numpy()[: rows.shape[0]])
    lp = np.concatenate(lps, axis=0)  # (n_items*n_choices, L-1)
    # positions [prompt_len-1, prompt_len+cont_len-1) score the continuation
    cont_lp = lp[:, prompt_len - 1 : prompt_len + cont_len - 1].sum(-1)
    cont_lp = cont_lp.reshape(n_items, n_choices)
    pred = cont_lp.argmax(-1)
    acc = float((pred == gold).mean())
    gold_lp = cont_lp[np.arange(n_items), gold]
    masked = cont_lp.copy()
    masked[np.arange(n_items), gold] = -np.inf
    margin = float((gold_lp - masked.max(-1)).mean())
    return {"acc": acc, "margin": margin, "n_items": n_items}
