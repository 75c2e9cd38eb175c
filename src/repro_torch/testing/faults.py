"""Fault-injection primitives shared by the train loop and serving engine.

The port's own copy of ``repro/testing/faults.py`` (pure host code).

Two shapes of injection exist in this repo and both are built from the
pieces here:

  * the TRAIN loop wants "raise once at step N" — :class:`StepFaultInjector`
    wraps the arm/fire-exactly-once bookkeeping, :func:`fault_step_from_env`
    keeps the historical ``FAULT_INJECT_STEP`` env interface, and
    :class:`InjectedFault` is the exception the loop's retry path catches;
  * the SERVING engine wants "at tick N, do X with these args" for several
    X — :class:`FaultSchedule` maps ticks to :class:`FaultEvent` lists and
    the engine-specific interpreter (``repro_torch.serving.faults``) gives each
    event kind its meaning.

Everything here is pure host logic (no torch): an un-armed injector costs a
``None`` check or an empty-dict lookup per step, so production code can
thread it unconditionally.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional


class InjectedFault(RuntimeError):
    """A deliberately injected failure — never raised by real faults, so
    retry paths can catch it precisely without masking genuine errors."""


def fault_step_from_env(
    explicit: Optional[int], env: str = "FAULT_INJECT_STEP"
) -> Optional[int]:
    """Resolve a fault step: an explicit config value wins, else ``env``.

    The env fallback is what lets operators arm a fault on a deployed
    binary without a config change — the interface the train-loop tests
    pin.
    """
    if explicit is not None:
        return int(explicit)
    raw = os.environ.get(env)
    return int(raw) if raw else None


class StepFaultInjector:
    """Raise :class:`InjectedFault` exactly once when ``step`` is reached.

    ``check(step)`` is called once per loop iteration; after firing the
    injector disarms itself, so the retry that resumes past the fault
    step does not re-trip it.  ``step=None`` never fires.
    """

    def __init__(self, step: Optional[int]):
        self.step = step
        self.fired = False

    @property
    def armed(self) -> bool:
        return self.step is not None and not self.fired

    def check(self, step: int) -> None:
        if self.armed and step == self.step:
            self.fired = True
            raise InjectedFault(f"injected fault at step {step}")


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault: fire ``kind`` at ``tick`` with ``kwargs``.

    ``kind`` is interpreted by whoever drains the schedule (the serving
    engine's injector defines ``exhaust_pool``/``nan_logits``/...); this
    module only carries the timetable.
    """

    tick: int
    kind: str
    kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)


class FaultSchedule:
    """A tick-indexed timetable of :class:`FaultEvent`\\ s.

    Built by chaining ``.at(tick, kind, **kwargs)``; the driven system
    calls ``pop(tick)`` once per tick and interprets whatever events come
    back.  Events fire exactly once (popping removes them) and ``fired``
    accumulates the history for test assertions.
    """

    def __init__(self) -> None:
        self._events: dict[int, list[FaultEvent]] = {}
        self.fired: list[FaultEvent] = []

    def at(self, tick: int, kind: str, **kwargs: Any) -> "FaultSchedule":
        self._events.setdefault(int(tick), []).append(
            FaultEvent(int(tick), str(kind), kwargs)
        )
        return self

    def pop(self, tick: int) -> list[FaultEvent]:
        events = self._events.pop(int(tick), [])
        self.fired.extend(events)
        return events

    @property
    def pending(self) -> int:
        return sum(len(v) for v in self._events.values())

    def __bool__(self) -> bool:
        return bool(self._events)
