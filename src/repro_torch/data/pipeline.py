"""Deterministic synthetic corpus (the port's copy of ``repro.data.pipeline``).

A seeded order-1 Markov chain over the vocab with Zipfian marginals.  Batch
``i`` of a split is a pure function of ``(seed, split, i)``; the ``split``
salts keep the ``train`` / ``calib`` / ``eval`` streams disjoint.  The
sampling code is numpy and matches the reference token for token.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.faults import fault_point

__all__ = ["SyntheticCorpus", "DataConfig", "make_batch_fn", "SPLITS"]

SPLITS = {"train": None, "calib": 0xCA11B, "eval": 0xE7A1}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 256
    seed: int = 1234
    zipf_a: float = 1.2
    branching: int = 8  # plausible successors per token


class SyntheticCorpus:
    """Order-1 Markov chain with Zipf marginals and limited branching."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        marg = (np.arange(1, v + 1, dtype=np.float64)) ** (-cfg.zipf_a)
        marg /= marg.sum()
        succ = np.stack([rng.choice(v, cfg.branching, replace=False) for _ in range(v)])
        w = (np.arange(1, cfg.branching + 1)) ** (-1.0)
        w /= w.sum()
        self.succ = succ.astype(np.int32)
        self.w = w
        self.marg = marg

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        out[:, 0] = rng.choice(self.cfg.vocab, batch, p=self.marg)
        choices = rng.choice(self.cfg.branching, (batch, seq), p=self.w)
        for t in range(1, seq):
            out[:, t] = self.succ[out[:, t - 1], choices[:, t]]
        return out

    def entropy_floor(self) -> float:
        """Per-token entropy of the chain (nats), the least achievable CE."""
        return float(-(self.w * np.log(self.w)).sum())


def make_batch_fn(data_cfg: DataConfig, model_cfg, batch: int, seq: int, split: str = "train"):
    """Returns ``(batch(step) → {"tokens": (batch, seq) int32}, corpus)``.

    An encoder-decoder model's batch also carries ``"frames"`` (batch,
    n_frames, d) and a prefix model's ``"patches"`` (batch, n_prefix, d),
    fp32 standard normals drawn from the batch's generator right after the
    tokens, in that order, as the reference draws them (the stubs of the
    audio front end and the vision tower)."""
    if split not in SPLITS:
        raise ValueError(f"unknown split {split!r}; expected one of {sorted(SPLITS)}")
    salt = SPLITS[split]
    corpus = SyntheticCorpus(data_cfg)

    def get(step: int) -> dict:
        # Fault site "data.fetch": a transient fault models a flaky storage
        # read; batch ``step`` is a pure function of (seed, split, step), so
        # a retry reproduces it bit for bit.
        fault_point("data.fetch")
        key = (data_cfg.seed, step) if salt is None else (data_cfg.seed, salt, step)
        rng = np.random.default_rng(key)
        out = {"tokens": corpus.sample(rng, batch, seq)}
        if model_cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (batch, model_cfg.n_frames, model_cfg.d_model)).astype(np.float32)
        if model_cfg.n_prefix:
            out["patches"] = rng.standard_normal(
                (batch, model_cfg.n_prefix, model_cfg.d_model)).astype(np.float32)
        return out

    return get, corpus
