"""Analog-execution config and the matmul every projection routes through.

Counterpart of ``repro/core/analog.py``.  Only the ``digital`` mode is
ported so far: it is ``ModelConfig.analog``'s default and the only mode
the greedy serving path runs.  The ``analog_linear`` / ``analog_stochastic``
crossbar modes come with the paper's slice of the port; until then
:func:`analog_matmul` refuses them instead of silently computing the
digital product.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    mode: str = "digital"  # digital (ported) | analog_linear | analog_stochastic

    def with_mode(self, mode: str) -> "AnalogConfig":
        return dataclasses.replace(self, mode=mode)


DIGITAL = AnalogConfig(mode="digital")


def analog_matmul(cfg: AnalogConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Matmul under the configured execution mode.  x: (..., in), w: (in, out)."""
    if cfg.mode != "digital":
        raise NotImplementedError(
            f"analog mode {cfg.mode!r} is not ported yet; only 'digital' runs"
        )
    return x @ w.to(x.dtype)
