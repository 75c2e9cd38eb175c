"""Learning-rate schedules (``repro/optim/schedule.py``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step: int, *, warmup: int = 100, total: int = 10_000, floor: float = 0.1) -> float:
    """Linear warmup, then cosine decay to ``floor`` of the peak: the scale
    multiplying ``AdamWConfig.lr``, computed in f32 on the host as the
    reference computes it on the device (the step is a host int here)."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return float(torch.where(s < warmup, warm, cos))
