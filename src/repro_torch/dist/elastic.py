"""Elastic execution: the retry-from-checkpoint loop and degraded-capacity
meshes (the port's copy of ``repro.dist.elastic``).

:class:`RetryingRunner` rolls any recoverable exception inside a step back
to the last checkpoint through ``restore_fn`` and keeps going, up to a
total retry budget, sleeping a seeded, jittered exponential backoff between
recoveries.  :class:`repro_torch.faults.PermanentFault`, and any
caller-supplied types, are re-raised at once.  Determinism comes from the
caller's exact-step data replay (``data_step`` in the checkpoint meta).

:func:`elastic_mesh` builds the largest ("data", "model") mesh the live
ranks fill.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.faults import PermanentFault

__all__ = ["RetryingRunner", "elastic_mesh"]


class RetryingRunner:
    """Run ``step_fn(state, step)`` for a span of steps with crash recovery.

    ``restore_fn() -> (state, step)`` rebuilds state from the latest
    checkpoint and reports the step to resume at.  ``fault_hook(step)`` runs
    before each step and may raise to simulate a failure.

    Retry policy: up to ``max_retries`` recoveries across the run (a budget,
    not per step), with delay ``min(backoff_max_s, backoff_base_s ·
    backoff_mult^k)`` before the k-th, times a seeded uniform jitter in
    ``[1−jitter, 1+jitter]``.  ``sleep_fn`` is injectable; ``self.delays``
    keeps the slept values.  ``permanent`` lists extra exception types that
    are never retried.
    """

    def __init__(
        self,
        step_fn: Callable,
        restore_fn: Callable,
        fault_hook: Optional[Callable] = None,
        max_retries: int = 3,
        *,
        backoff_base_s: float = 0.01,
        backoff_mult: float = 2.0,
        backoff_max_s: float = 2.0,
        jitter: float = 0.5,
        permanent: tuple = (),
        sleep_fn: Callable[[float], None] = time.sleep,
        seed: int = 0,
    ):
        self.step_fn = step_fn
        self.restore_fn = restore_fn
        self.fault_hook = fault_hook
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_mult = backoff_mult
        self.backoff_max_s = backoff_max_s
        self.jitter = jitter
        self.permanent = tuple(permanent) + (PermanentFault,)
        self.sleep_fn = sleep_fn
        self.recoveries = 0
        self.delays: list[float] = []
        self._rng = np.random.default_rng(seed)

    def _backoff(self) -> float:
        delay = min(self.backoff_max_s, self.backoff_base_s * self.backoff_mult ** self.recoveries)
        if self.jitter:
            delay *= 1.0 + self.jitter * (2.0 * float(self._rng.random()) - 1.0)
        return delay

    def run(self, state, start: int, n_steps: int):
        step, end = start, start + n_steps
        while step < end:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                state = self.step_fn(state, step)
                step += 1
            except self.permanent:
                raise
            except Exception:
                if self.recoveries >= self.max_retries:
                    raise
                delay = self._backoff()
                self.delays.append(delay)
                self.sleep_fn(delay)
                self.recoveries += 1
                state, step = self.restore_fn()
        return state, step


def elastic_mesh(model_axis: int = 1, devices=None, *, device="cuda"):
    """Largest ("data", "model") mesh the live ranks support.

    ``devices``: the live ranks (default: every rank of the default process
    group).  After losing hosts the survivors may no longer fill the
    original mesh; the data axis shrinks to the largest multiple of
    ``model_axis`` that fits and the remainder is dropped, so training
    resumes at degraded capacity.  Every rank of the group must call it; a
    dropped rank gets the mesh without a coordinate on it.
    """
    devs = list(devices if devices is not None else range(dist.get_world_size()))
    if model_axis <= 0 or len(devs) < model_axis:
        raise ValueError(
            f"{len(devs)} device(s) cannot host model_axis={model_axis}"
        )
    from torch.distributed.device_mesh import DeviceMesh

    data = len(devs) // model_axis
    keep = torch.tensor(devs[: data * model_axis]).reshape(data, model_axis)
    return DeviceMesh(torch.device(device).type, keep, mesh_dim_names=("data", "model"))
