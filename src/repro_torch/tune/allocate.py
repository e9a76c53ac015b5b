"""Budgeted per-layer bit and outlier allocation: a greedy descent in
marginal error.

Given the probes' per-layer stats (:mod:`.sensitivity`) and a budget in
average bits per weight, choose one (bits, outlier_frac) per layer:

1. Every layer starts at the lowest candidate width.
2. Each layer offers chains of upgrades: the width ladder (2→3→4→8) and
   optional "attach an outlier budget" steps.  An upgrade's gain is the
   probed drop in error times the layer's weight (``error``: its size;
   ``sensitivity``: its size times λ_max(Σ)); its cost is the storage it
   adds, Δbits·n, or frac·48·n for COO outliers (a 16-bit value and a
   32-bit index, the paper's §5.4 accounting).
3. The upgrades merge into one priority sequence by gain per bit, a heap
   that keeps each chain's order, ties broken on (layer key, step), so the
   sequence is reproducible bit for bit.
4. The budget buys a prefix of that sequence: the walk stops at the first
   upgrade that no longer fits.

The sequence does not depend on the budget, so a larger budget buys a
longer prefix: the allocation never exceeds the budget, is deterministic,
and its total bits never fall as the budget grows.
"""

from __future__ import annotations

import dataclasses
import heapq

__all__ = ["AllocConfig", "Allocation", "upgrade_sequence", "allocate", "allocation_layer_specs"]

OUTLIER_BITS = 16 + 32  # fp16 value + int32 flat index per COO outlier


@dataclasses.dataclass(frozen=True)
class AllocConfig:
    budget_avg_bits: float = 3.0
    bits_candidates: tuple = (2, 3, 4, 8)  # ascending
    outlier_frac_candidates: tuple = ()  # e.g. (0.01,); each an upgrade step
    policy: str = "sensitivity"  # "sensitivity" | "error"

    def __post_init__(self):
        if tuple(sorted(self.bits_candidates)) != tuple(self.bits_candidates):
            raise ValueError("bits_candidates must be ascending")
        if not self.bits_candidates:
            raise ValueError("need at least one bits candidate")
        if self.policy not in ("sensitivity", "error"):
            raise ValueError(f"unknown policy {self.policy!r}")


@dataclasses.dataclass
class Allocation:
    """Per-layer choices and their accounting."""

    bits: dict  # key -> int
    outlier_frac: dict  # key -> float (only layers with a budget attached)
    avg_bits: float  # Σ(bits_l + 48·frac_l)·n_l / Σ n_l
    budget_avg_bits: float
    n_upgrades: int
    trace: list  # applied upgrade labels, in order
    total_bits: float = 0.0  # Σ assigned storage bits (weights + outliers)


def _weight(st, policy: str) -> float:
    w = float(st.n_weights)
    if policy == "sensitivity":
        w *= max(st.lambda_max, 0.0)
    return w


def _upgrade_chains(st, cfg: AllocConfig) -> dict:
    """One layer's two upgrade chains, entries ``(gain, cost_bits, label,
    target)``: the width ladder, applied in order, and the outlier steps,
    which add to any width (behind the ladder they would wait until every
    width upgrade fit)."""
    bits_chain, outl_chain = [], []
    bc = cfg.bits_candidates
    w = _weight(st, cfg.policy)
    for lo, hi in zip(bc[:-1], bc[1:]):
        if lo not in st.err or hi not in st.err:
            continue
        gain = max(float(st.err[lo]) - float(st.err[hi]), 0.0) * w
        bits_chain.append((gain, float(hi - lo) * st.n_weights, f"{st.key}:{lo}->{hi}b", ("bits", hi)))
    for frac in cfg.outlier_frac_candidates:
        # Probed at the lowest width, where outliers matter most.
        key = (bc[0], frac)
        if key not in st.err or bc[0] not in st.err:
            continue
        gain = max(float(st.err[bc[0]]) - float(st.err[key]), 0.0) * w
        outl_chain.append((gain, frac * OUTLIER_BITS * st.n_weights,
                           f"{st.key}:+outliers@{frac}", ("outlier", frac)))
    return {"bits": bits_chain, "outlier": outl_chain}


def upgrade_sequence(stats: dict, cfg: AllocConfig) -> list:
    """The budget-independent priority sequence over every layer: by gain
    per bit (descending), each chain in its order, ties on (key, step)."""
    chains = {(k, kind): chain for k in sorted(stats)
              for kind, chain in _upgrade_chains(stats[k], cfg).items()}
    heap = []  # (-density, chain_key, step_idx, gain, cost, label, target)

    def push(ck, idx):
        chain = chains[ck]
        if idx >= len(chain):
            return
        gain, cost, label, target = chain[idx]
        heapq.heappush(heap, (-(gain / cost if cost > 0 else 0.0), ck, idx, gain, cost, label, target))

    for ck in chains:
        push(ck, 0)
    seq = []
    while heap:
        _, ck, idx, gain, cost, label, target = heapq.heappop(heap)
        seq.append({"key": ck[0], "gain": gain, "cost": cost, "label": label, "target": target})
        push(ck, idx + 1)
    return seq


def allocate(stats: dict, cfg: AllocConfig) -> Allocation:
    """Spend ``cfg.budget_avg_bits`` over the layers (module docstring)."""
    total_n = sum(st.n_weights for st in stats.values())
    if total_n <= 0:
        raise ValueError("no layers to allocate (empty stats)")
    budget_bits = cfg.budget_avg_bits * total_n
    used = float(cfg.bits_candidates[0]) * total_n
    if used > budget_bits + 1e-9:
        raise ValueError(f"budget {cfg.budget_avg_bits} below the floor width "
                         f"{cfg.bits_candidates[0]}")
    bits = {k: cfg.bits_candidates[0] for k in stats}
    outl: dict[str, float] = {}
    trace = []
    for up in upgrade_sequence(stats, cfg):
        if used + up["cost"] > budget_bits + 1e-9:
            break  # a prefix: stop, never skip and go on
        used += up["cost"]
        kind, val = up["target"]
        if kind == "bits":
            bits[up["key"]] = val
        else:
            outl[up["key"]] = val
        trace.append(up["label"])
    return Allocation(bits=bits, outlier_frac=outl, avg_bits=used / total_n,
                      budget_avg_bits=cfg.budget_avg_bits, n_upgrades=len(trace), trace=trace,
                      total_bits=used)


def allocation_layer_specs(alloc: Allocation, *, base_method: str = "quantease",
                           outlier_method: str = "qe_outlier") -> dict:
    """An Allocation as ``PTQConfig.layer_specs`` overrides."""
    from repro_torch.core.solver import LayerSpec

    specs = {}
    for key, b in alloc.bits.items():
        frac = alloc.outlier_frac.get(key)
        specs[key] = (LayerSpec(bits=b, outlier_frac=frac, method=outlier_method) if frac
                      else LayerSpec(bits=b, method=base_method))
    return specs
