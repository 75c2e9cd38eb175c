"""Learning-rate schedules (``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

from repro_torch.core.physics import f32


def warmup_cosine(step: int, *, warmup: int = 100, total: int = 10_000, floor: float = 0.1) -> float:
    """Linear warmup, then cosine decay to ``floor`` of the peak: the scale
    multiplying ``AdamWConfig.lr``, computed in f32 on the host as the
    reference computes it on the device (the step is a host int here).

    Each step is taken in f64 with ``math`` and rounded to f32, never
    through a CPU torch op, whose f32 rounding varies between builds: for
    the arithmetic that is the f32 operation's own result; the cosine is
    the correctly rounded f32 cosine, which XLA's is not, so the two may
    differ by an ulp."""
    s = f32(float(step))
    if s < warmup:
        return f32(s / max(warmup, 1))
    prog = min(max(f32(f32(s - warmup) / max(total - warmup, 1)), 0.0), 1.0)
    cos = f32(math.cos(f32(f32(math.pi) * prog)))
    return f32(f32(floor) + f32(f32((1 - floor) * 0.5) * f32(1.0 + cos)))
