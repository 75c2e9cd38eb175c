"""Analog-execution config and the matmul every projection routes through
(``repro/core/analog.py``).

Three execution modes per matmul:

* ``digital``           — plain matmul (the serving path's default).
* ``analog_linear``     — crossbar MAC with conductance quantization and
                          thermal noise, linear readout.
* ``analog_stochastic`` — the full RACA path: crossbar MAC → thermal noise →
                          comparator → binary stochastic activation {0, 1}.

Both analog modes of :func:`analog_matmul` run ``kernels.ops.crossbar_mac``:
the hand-written CUDA kernel for CUDA tensors, its plain PyTorch version
for CPU tensors.  That is the reference's ``use_pallas="on"`` semantics
(what its TPU runs).  The reference's off-TPU branch (quantize with a
straight-through estimator, then threefry ``normal`` noise) is not
ported; ``use_pallas`` is kept as a field so configs read the same, and
is not consulted.

:func:`analog_dense` with a bias and a key in ``analog_stochastic`` mode
takes the reference's bias-folded branch, which never reaches the
crossbar kernel on either package: :func:`quantize_normalized`, ``z = x @
Wq + b``, then ``neurons.sigmoid_neuron_calibrated`` (the paper's FCNN
hidden layers; the hard draw is ``ops.sigmoid_sample``).

A projection runs digitally when its key is ``None``, as in the reference:
serving passes no keys, training passes one per projection.  The WTA
readouts (:func:`wta_head`, :func:`wta_router_topk`) draw from
``core.wta``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as R
from repro_torch.kernels import ops as KOPS
# the per-layer conductance-range scale s = max(max|W|, 1e-6) (the paper's
# G0/V_r calibration knob): weights map to devices as W/s
from repro_torch.kernels.ops import range_scale as dynamic_range  # noqa: F401
from . import crossbar, neurons, wta
from .physics import DeviceParams


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    mode: str = "digital"  # digital | analog_linear | analog_stochastic
    device: DeviceParams = dataclasses.field(default_factory=DeviceParams)
    beta: float = 1.0          # logistic slope the SNR is calibrated to
    hard: bool = True          # hard Bernoulli sample vs expectation (eval)
    quantize: bool = True      # conductance-level quantization of weights
    calibrated: bool = True    # calibrated P=sigmoid(beta z) vs physical ΣG
    use_pallas: str = "auto"   # the reference's dispatch knob; not consulted
    rows_per_tile: int = 256   # physical array height (cost model, kernels)
    wta_trials: int = 32       # decision trials for WTA readout heads
    wta_vth0: Optional[float] = None  # None => calibrated θ = σ² (temp 1)
    # analog_linear reads at normal voltage (high SNR): input-referred noise
    # std relative to the layer's dynamic range
    linear_sigma: float = 0.01

    def with_mode(self, mode: str) -> "AnalogConfig":
        return dataclasses.replace(self, mode=mode)

    @property
    def vth0(self) -> float:
        if self.wta_vth0 is not None:
            return self.wta_vth0
        return wta.calibrated_threshold(self.beta)


DIGITAL = AnalogConfig(mode="digital")


def analog_matmul(
    cfg: AnalogConfig, key, x: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """Matmul under the configured execution mode.  x: (..., in), w: (in,
    out); ``key`` is a threefry key (``repro_torch.random``) or ``None``.

    ``analog_stochastic`` returns binary activations sampled through the
    straight-through estimator (trainable); every mode returns x.dtype."""
    if cfg.mode == "digital" or key is None:
        return x @ w.to(x.dtype)
    if cfg.mode not in ("analog_linear", "analog_stochastic"):
        raise ValueError(f"unknown analog mode: {cfg.mode!r}")
    y = KOPS.crossbar_mac(
        x.to(torch.float32), w, key, cfg, binarize=cfg.mode == "analog_stochastic"
    )
    return y.to(x.dtype)


def quantize_normalized(w: torch.Tensor, cfg: AnalogConfig) -> torch.Tensor:
    """s · quantize(w / s), with s = max(max|W|, 1e-6) the layer's dynamic
    range, and a straight-through gradient: ``w + (wq − w).detach()``, as
    the reference's ``w + stop_gradient(wq − w)``.  XLA fuses ``s·q − w``
    into one FMA on the CPU, so the difference is rounded once here too
    (the forward then equals the reference's jitted one bit for bit)."""
    if not cfg.quantize:
        return w
    with torch.no_grad():
        s = dynamic_range(w)
        diff = R.fma32(s, crossbar.quantize_weights(w / s, cfg.device), -w)
    return w + diff


def analog_dense(cfg: AnalogConfig, key, x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense layer; the bias is realized digitally (a bias row in hardware).
    In ``analog_stochastic`` mode with a bias and a key the bias is folded
    into the pre-activation before the comparator (an always-on bias
    wordline): y = neuron(x @ quantize_normalized(W) + b)."""
    if cfg.mode == "analog_stochastic" and b is not None and key is not None:
        wq = quantize_normalized(w.to(torch.float32), cfg)
        y = neurons.sigmoid_neuron_calibrated(
            key, x.to(torch.float32) @ wq, beta=cfg.beta, hard=cfg.hard,
            bias=b.to(torch.float32),
        )
        return y.to(x.dtype)
    y = analog_matmul(cfg, key, x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def wta_head(cfg: AnalogConfig, key, z: torch.Tensor) -> wta.WTAResult:
    """WTA stochastic SoftMax readout over logits ``z`` (classifier head)."""
    if key is None:
        raise ValueError("the WTA head requires a PRNG key")
    return wta.wta_trials(
        key, z.to(torch.float32), n_trials=cfg.wta_trials, vth0=cfg.vth0, beta=cfg.beta
    )


def wta_router_topk(
    cfg: AnalogConfig, key, logits: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE router as a k-winner WTA circuit; digital top-k of the softmax
    when ``key`` is None or the mode is not ``analog_stochastic``."""
    if key is None or cfg.mode != "analog_stochastic":
        return wta.top_k(torch.softmax(logits, dim=-1), k)
    return wta.wta_topk(
        key, logits.to(torch.float32), k, n_trials=cfg.wta_trials, vth0=cfg.vth0, beta=cfg.beta
    )
