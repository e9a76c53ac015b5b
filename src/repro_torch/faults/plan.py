"""Fault plans: a pure function of ``(specs, seed)`` and per-site counters.

The same plan driven through the same workload fires the same faults at the
same invocations every time.  Sites (:data:`SITES`) are the reference's, so a
plan written for one package validates in the other; the port arms
``engine.step`` (top of both engines' ``step``, before any state changes, so
a transient fault is a pure no-op retry), ``pool.alloc``
(:meth:`repro_torch.serve.kv_cache.PagePool.alloc`, where ``deny`` fails the
allocation as if the pool were dry), and ``ckpt.write`` / ``ckpt.read``
(each shard of :mod:`repro_torch.dist.checkpoint`; ``corrupt`` flips one
seeded byte of the written shard, :func:`corrupt_bytes`), ``data.fetch``
(each batch of :func:`repro_torch.data.pipeline.make_batch_fn`) and
``kernel.dispatch`` (the serving wrappers of
:mod:`repro_torch.kernels.ops`, where ``deny`` on the CPU takes the plain
version, as every CPU call does, and on the card raises, since the port has
no plain path there).

Kinds: ``transient`` raises :class:`TransientFault` (the engines count and
retry the step), ``permanent`` raises :class:`PermanentFault`, and ``deny``
/ ``corrupt`` are returned to the caller as soft actions.  With no active
plan, :func:`fault_point` returns ``"ok"`` at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import Optional

import numpy as np

__all__ = [
    "SITES",
    "FaultError",
    "TransientFault",
    "PermanentFault",
    "FaultSpec",
    "FaultPlan",
    "fault_plan",
    "fault_point",
    "active_plan",
    "corrupt_bytes",
]

SITES = (
    "engine.step",
    "pool.alloc",
    "ckpt.read",
    "ckpt.write",
    "kernel.dispatch",
    "data.fetch",
)

_KINDS = ("transient", "permanent", "deny", "corrupt")


class FaultError(Exception):
    """Base class for injected faults; carries the site and invocation."""

    def __init__(self, site: str, invocation: int):
        self.site = site
        self.invocation = invocation
        super().__init__(f"injected fault at {site}#{invocation}")


class TransientFault(FaultError):
    """Recoverable: the consumer retries."""


class PermanentFault(FaultError):
    """Unrecoverable: never retried."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault at one site.

    Fires on the site's 0-based invocation ``n`` when ``n ∈ at``, or
    ``window[0] <= n < window[1]``, or a seeded Bernoulli draw with
    probability ``p`` succeeds.  ``max_fires`` caps the spec's fires (None:
    no cap).  The draw is taken on every invocation, so the schedule never
    depends on what other specs did.
    """

    site: str
    kind: str
    at: tuple = ()
    window: Optional[tuple] = None
    p: float = 0.0
    max_fires: Optional[int] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; expected one of {SITES}")
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected one of {_KINDS}")
        object.__setattr__(self, "at", tuple(int(a) for a in self.at))
        if self.window is not None:
            a, b = self.window
            object.__setattr__(self, "window", (int(a), int(b)))
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p={self.p} not a probability")


class FaultPlan:
    """A deterministic fault schedule over :data:`SITES`.

    ``check(site)`` advances the site's invocation counter and returns the
    action (``"ok"`` / ``"deny"`` / ``"corrupt"``) or raises.  The first
    matching spec wins, in construction order; ``fired`` records
    ``(site, invocation, kind)`` per fire.
    """

    def __init__(self, specs, seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self.counts: dict[str, int] = {s: 0 for s in SITES}
        self.fired: list[tuple] = []
        self._fires_left = [
            float("inf") if sp.max_fires is None else int(sp.max_fires) for sp in self.specs
        ]
        # One RNG stream per spec, keyed (seed, spec index), as the reference's.
        self._rngs = [np.random.default_rng((self.seed, i)) for i in range(len(self.specs))]
        # Seeded stream for payload corruption (the byte to flip), as the reference's.
        self._corrupt_rng = np.random.default_rng((self.seed, 0xC0FFEE))

    @classmethod
    def from_spec(cls, doc) -> "FaultPlan":
        """Build from a JSON document (a dict, a JSON string, or a path to
        one): ``{"seed": 0, "faults": [{"site": ..., "kind": ..., "at": [...],
        "window": [a, b], "p": 0.0, "max_fires": null}, ...]}``, the
        reference's format (the CLIs' ``--fault-plan``)."""
        if isinstance(doc, str):
            try:
                doc = json.loads(doc)
            except json.JSONDecodeError:
                with open(doc) as f:
                    doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"fault plan must be a JSON object, got {type(doc).__name__}")
        if set(doc) - {"seed", "faults"}:
            raise ValueError(f"unknown fault-plan key(s) {sorted(set(doc) - {'seed', 'faults'})}; "
                             'expected {"seed", "faults"}')
        keys = {"site", "kind", "at", "window", "p", "max_fires"}
        specs = []
        for i, d in enumerate(doc.get("faults", [])):
            if not isinstance(d, dict):
                raise ValueError(f"faults[{i}]: expected an object, got {type(d).__name__}")
            if set(d) - keys:
                raise ValueError(f"faults[{i}]: unknown key(s) {sorted(set(d) - keys)}")
            if {"site", "kind"} - set(d):
                raise ValueError(f"faults[{i}]: missing required key(s) "
                                 f"{sorted({'site', 'kind'} - set(d))}")
            try:
                specs.append(FaultSpec(
                    site=d["site"], kind=d["kind"], at=tuple(d.get("at", ())),
                    window=tuple(d["window"]) if d.get("window") else None,
                    p=float(d.get("p", 0.0)), max_fires=d.get("max_fires"),
                ))
            except ValueError as e:
                raise ValueError(f"faults[{i}]: {e}") from None
        return cls(specs, seed=int(doc.get("seed", 0)))

    def check(self, site: str) -> str:
        if site not in self.counts:
            raise ValueError(f"unknown fault site {site!r}; expected one of {SITES}")
        n = self.counts[site]
        self.counts[site] = n + 1
        for i, sp in enumerate(self.specs):
            if sp.site != site:
                continue
            fire = n in sp.at
            if sp.window is not None:
                fire = fire or (sp.window[0] <= n < sp.window[1])
            if sp.p > 0.0:
                fire = bool(self._rngs[i].random() < sp.p) or fire
            if not fire or self._fires_left[i] <= 0:
                continue
            self._fires_left[i] -= 1
            self.fired.append((site, n, sp.kind))
            if sp.kind == "transient":
                raise TransientFault(site, n)
            if sp.kind == "permanent":
                raise PermanentFault(site, n)
            return sp.kind
        return "ok"


    def corrupt_index(self, n: int) -> int:
        """Seeded byte index into an ``n``-byte payload (for ``corrupt``)."""
        return int(self._corrupt_rng.integers(0, max(n, 1)))


_ACTIVE: list[FaultPlan] = []


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def fault_plan(plan: Optional[FaultPlan]):
    """Activate ``plan`` for the block (the innermost plan wins); ``None``
    is a no-op."""
    if plan is None:
        yield None
        return
    _ACTIVE.append(plan)
    try:
        yield plan
    finally:
        _ACTIVE.pop()


def fault_point(site: str) -> str:
    """Consult the active plan, if any: the soft action, or a raise."""
    plan = active_plan()
    if plan is None:
        return "ok"
    return plan.check(site)


def corrupt_bytes(plan: FaultPlan, data: bytes) -> bytes:
    """Flip one seeded byte of ``data`` (XOR 0xFF, so the flip never
    round-trips to the original value): the shard corruption behind
    ``ckpt.write``'s ``corrupt`` action."""
    if not data:
        return data
    idx = plan.corrupt_index(len(data))
    out = bytearray(data)
    out[idx] ^= 0xFF
    return bytes(out)
