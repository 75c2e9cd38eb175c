"""Serving-engine fault injection: scheduled chaos for the paged engine
(``repro/serving/faults.py``).

A :class:`FaultInjector` is a :class:`repro_torch.testing.FaultSchedule`
plus an interpreter for serving-specific fault kinds.  Attach one through
``ServeConfig.fault_injector``; the engine calls :meth:`fire` at the start
of every tick and the injector applies whatever events are due.  Under
every injected fault the engine keeps serving, the allocator's invariants
hold, and every affected request ends with a typed ``done_reason``.

Fault kinds (the reference's whose machinery the port has):

``exhaust_pool``
    Reserve every free block under a sentinel owner: the admission gate
    back-pressures as if live traffic held the pool.  ``release_pool``
    hands it back.
``degrade_device``
    Degrade the engine's device backend (``sim_faulty``): jump its fault
    clock (``clock=...``) and/or override readout knobs
    (``read_sigma_inflation=...``, ``comparator_offset=...``,
    ``drift_nu=...``).  A no-op on backends without the hook (plain sim).
``recover_device``
    Reset the backend's fault clock and drop the knob overrides (retired
    tiles stay retired: remapping is physical and one-way).

The reference's ``nan_logits``, ``deadline_storm``, ``kill_prefill`` and
``preempt`` need its spill store, ``_kill_job`` and the deadline pass,
which the port does not have yet: like any kind without a ``_do_*``
interpreter here, :meth:`FaultInjector.at` refuses them when they are
scheduled.
"""

from __future__ import annotations

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
