"""Serving-engine fault injection: scheduled chaos for the paged engine
(``repro/serving/faults.py``).

A :class:`FaultInjector` is a :class:`repro_torch.testing.FaultSchedule`
plus an interpreter for serving-specific fault kinds.  Attach one through
``ServeConfig.fault_injector``; the engine calls :meth:`fire` at the start
of every tick and the injector applies whatever events are due.  Under
every injected fault the engine keeps serving, the allocator's invariants
hold, and every affected request ends with a typed ``done_reason``.

Fault kinds, the reference's eight:

``exhaust_pool``
    Reserve every free block under a sentinel owner: the admission gate
    back-pressures as if live traffic held the pool.  ``release_pool``
    hands it back.
``nan_logits``
    Overwrite one private read-window page of a decoding request
    (``rid=...``, default: the first poisonable active one) with NaN: the
    next decode step's sanity code is ``SANE_NAN`` and the engine evicts
    the victim with reason ``"nan"``.
``deadline_storm``
    Stamp ``deadline_ms`` (default 0: already expired) onto every live
    request: the next deadline pass evicts them all.
``kill_prefill``
    Evict a mid-prefill request (``rid=...``, default: the job FIFO's
    head) with reason ``"preempted"``: its job and pages go at once, and
    queued sharers of its unwritten pages demote to recompute.
``preempt``
    Spill a decoding request (``rid=...``, default: the lowest-priority,
    newest active one): it requeues and restores through the gate.
``degrade_device``
    Degrade the engine's device backend (``sim_faulty``): jump its fault
    clock (``clock=...``) and/or override readout knobs
    (``read_sigma_inflation=...``, ``comparator_offset=...``,
    ``drift_nu=...``).  A no-op on backends without the hook (plain sim).
``recover_device``
    Reset the backend's fault clock and drop the knob overrides (retired
    tiles stay retired: remapping is physical and one-way).

:meth:`FaultInjector.at` refuses an unknown kind when it is scheduled.
"""

from __future__ import annotations

import time
from typing import Any, Optional

from repro_torch.testing import FaultSchedule

# sentinel BlockAllocator owner for the pool-exhaustion fault; negative so
# it can never collide with a request id
POOL_HOG_OWNER = -1


class FaultInjector(FaultSchedule):
    """Tick-scheduled fault interpreter for :class:`ServingEngine`."""

    def __init__(self) -> None:
        super().__init__()
        self._hogging = False
        # (tick, kind, rid-or-None) of faults actually APPLIED, as distinct
        # from ``fired`` (scheduled events that came due)
        self.applied: list[tuple[int, str, Optional[int]]] = []

    @classmethod
    def kinds(cls) -> tuple[str, ...]:
        """Every registered fault kind (the ``_do_*`` method registry)."""
        return tuple(sorted(name[len("_do_"):] for name in dir(cls) if name.startswith("_do_")))

    def at(self, tick: int, kind: str, **kwargs: Any) -> "FaultInjector":
        """Schedule ``kind`` at ``tick``, validated here: an unknown kind
        raises at schedule time with the registered list."""
        if not hasattr(self, f"_do_{kind}"):
            raise ValueError(f"unknown fault kind {kind!r}; registered: {list(self.kinds())}")
        super().at(tick, kind, **kwargs)
        return self

    def fire(self, engine: Any, tick: int) -> None:
        for ev in self.pop(tick):
            getattr(self, f"_do_{ev.kind}")(engine, tick, **ev.kwargs)

    # -- fault kinds --------------------------------------------------------

    def _do_exhaust_pool(self, engine, tick: int) -> None:
        n = engine.blocks.available
        if self._hogging or n == 0:
            return
        engine.blocks.reserve(POOL_HOG_OWNER, n)
        self._hogging = True
        self.applied.append((tick, "exhaust_pool", None))

    def _do_release_pool(self, engine, tick: int) -> None:
        if not self._hogging:
            return
        engine.blocks.free(POOL_HOG_OWNER)
        self._hogging = False
        self.applied.append((tick, "release_pool", None))

    def _do_nan_logits(self, engine, tick: int, rid: Optional[int] = None) -> None:
        victims = [engine.sched.request(rid)] if rid is not None else engine.sched.active()
        for req in victims:
            if req.slot is not None and engine._poison_nan(req):
                self.applied.append((tick, "nan_logits", req.rid))
                return

    def _do_deadline_storm(self, engine, tick: int, deadline_ms: float = 0.0) -> None:
        now = time.perf_counter()
        for req in engine.sched.all_requests():
            if req.done_time is None:
                # the elapsed lifetime counts against the new limit, so
                # deadline_ms=0 expires everything at the next pass
                req.deadline_ms = (now - req.submit_time) * 1e3 + float(deadline_ms)
                self.applied.append((tick, "deadline_storm", req.rid))

    def _do_kill_prefill(self, engine, tick: int, rid: Optional[int] = None) -> None:
        if rid is None:
            if not engine._job_fifo:
                return
            rid = engine._job_fifo[0]
        engine._evict_request(engine.sched.request(rid), "preempted", time.perf_counter())
        self.applied.append((tick, "kill_prefill", rid))

    def _do_preempt(self, engine, tick: int, rid: Optional[int] = None) -> None:
        if rid is not None:
            victims = [engine.sched.request(rid)]
        else:
            victims = sorted(engine.sched.active(), key=lambda r: (r.priority, r.rid),
                             reverse=True)
        if victims and victims[0].slot is not None:
            engine._preempt(victims[0])
            self.applied.append((tick, "preempt", victims[0].rid))

    def _do_degrade_device(self, engine, tick: int, clock: Optional[int] = None,
                           **knobs: Any) -> None:
        bk = getattr(engine, "backend", None)
        if bk is None or not hasattr(bk, "degrade"):
            return  # plain sim backend: device faults don't apply
        bk.degrade(clock=clock, **knobs)
        self.applied.append((tick, "degrade_device", None))

    def _do_recover_device(self, engine, tick: int) -> None:
        bk = getattr(engine, "backend", None)
        if bk is None or not hasattr(bk, "recover"):
            return
        bk.recover()
        self.applied.append((tick, "recover_device", None))
