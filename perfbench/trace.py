"""The traced stretch: a bounded run of ticks or steps under
``torch.profiler``, reduced in memory to device time by kernel name, the
device's busy time, and its idle gaps named by what the host was doing.
No trace file is written."""

from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _dev_type(e) -> str:
    return str(e.device_type()).rsplit(".", 1)[-1]


def _annotation(e) -> bool:
    """A ``record_function`` range mirrored onto the device's timeline,
    which is no device work."""
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None and _dev_type(e) != "CPU" else False


def short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name if cut < 0 else name[:cut])[:160]


class Stretch:
    """``with Stretch() as s:`` profiles its body; afterwards
    ``s.reduce()`` gives the reduction (:func:`reduce`)."""

    def __init__(self, cuda: bool = True):
        self._prof = None
        self.result = None
        self.cuda = cuda

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        self._wall = wall
        return False

    def reduce(self) -> dict:
        """The reduction of the stretch, made once it has closed (outside
        the measured window: reading the events takes seconds)."""
        if self.result is None:
            self.result = reduce(self._prof.profiler.kineto_results.events(), self._wall,
                                 "CUDA" if self.cuda else "CPU")
            self._prof = None
        return self.result


def reduce(events, wall_s: float, cpu_as_device: str = "CUDA") -> dict:
    """``kernels``: {name: device seconds}; ``busy_s``: seconds in which
    some device operation ran (their union); ``window_s``: the traced
    stretch on the host's clock; ``gaps``: the ten longest idle gaps
    between device operations as [host op running at the gap's start,
    seconds]."""
    dev, host = [], []
    for e in events:
        if _annotation(e):
            continue
        kind = _dev_type(e)
        if kind in ("CUDA", cpu_as_device):
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        if kind == "CPU" and e.duration_ns() > 0:
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    kernels: dict[str, float] = {}
    for s, t, name in dev:
        name = short(name)
        kernels[name] = kernels.get(name, 0.0) + (t - s) * 1e-9
    dev.sort()
    busy = 0
    gaps = []
    end = None
    for s, t, _ in dev:
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end))
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    gaps.sort(reverse=True)
    host.sort()
    named = []
    for dur, at in gaps[:10]:
        inner = "(none)"
        best = None
        for s, t, name in host:
            if s > at:
                break
            if t >= at and (best is None or s >= best):
                best, inner = s, name
        named.append([inner, dur * 1e-9])
    return {"kernels": kernels, "busy_s": busy * 1e-9, "window_s": wall_s, "gaps": named}


def kernel_s(result: dict, *names: str) -> float:
    """Device seconds of the kernels whose (demangled) names hold one of
    ``names``."""
    return sum(v for k, v in result["kernels"].items() if any(n in k for n in names))


def top_ops(result: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(result["kernels"].items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function(name):
        yield


def warm_profiler(cuda: bool) -> None:
    """Start and stop the profiler once on a trivial device op, so that
    its first start (CUPTI's set-up, seconds) falls in set-up and not in
    the window."""
    with Stretch(cuda) as st:
        torch.ones(1, device="cuda" if cuda else "cpu").add_(1)
    st.reduce()
