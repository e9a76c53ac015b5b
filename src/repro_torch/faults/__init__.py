"""Seeded, deterministic fault injection (the port's copy of ``repro.faults``).

A :class:`FaultPlan` schedules transient or permanent errors and soft
denials at named sites; the serving engines consult ``engine.step`` and the
page pool ``pool.alloc``, so their failure paths are reproducible tests.
"""

from repro_torch.faults.plan import (
    SITES,
    FaultError,
    FaultPlan,
    FaultSpec,
    PermanentFault,
    TransientFault,
    active_plan,
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
    "fault_plan",
    "fault_point",
]
