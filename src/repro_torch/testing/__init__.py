"""Fault-injection primitives shared by the serving engine and the train
loop (``repro/testing``): pure host logic, cheap enough to stay on the
production paths (an un-armed injector is a dict lookup per tick)."""

from .faults import (
    FaultEvent,
    FaultSchedule,
    InjectedFault,
    StepFaultInjector,
    fault_step_from_env,
)

__all__ = [
    "FaultEvent",
    "FaultSchedule",
    "InjectedFault",
    "StepFaultInjector",
    "fault_step_from_env",
]
