"""Seeded, deterministic fault injection (the port's copy of ``repro.faults``).

A :class:`FaultPlan` schedules transient or permanent errors and soft
denials at named sites; the serving engines consult ``engine.step``, the
page pool ``pool.alloc`` and the checkpoints ``ckpt.write``/``ckpt.read``,
so their failure paths are reproducible tests.
"""

from repro_torch.faults.plan import (
    SITES,
    FaultError,
    FaultPlan,
    FaultSpec,
    PermanentFault,
    TransientFault,
    active_plan,
    corrupt_bytes,
    fault_plan,
    fault_point,
)

__all__ = [
    "SITES",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "PermanentFault",
    "TransientFault",
    "active_plan",
    "corrupt_bytes",
    "fault_plan",
    "fault_point",
]
