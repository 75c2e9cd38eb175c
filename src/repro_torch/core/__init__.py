"""RACA core: the paper's contribution as composable PyTorch modules
(``repro/core``).

Public API:
    physics      — Nyquist noise, SNR, calibration (Eq. 1-3, 13)
    crossbar     — weight→conductance mapping, analog MAC (Eq. 4-7, 9-12)
    neurons      — binary stochastic Sigmoid neurons + STE (Eq. 8, 13)
    wta          — WTA binary stochastic SoftMax neurons (Eq. 14)
    analog       — AnalogConfig + mode-dispatched dense/matmul/heads
    cost_model   — NeuroSim-style energy/area model (Table I)
"""

from . import analog, cost_model, crossbar, neurons, physics, wta
from .analog import DIGITAL, AnalogConfig, analog_dense, analog_matmul, wta_head
from .physics import DeviceParams, calibrate_v_read, effective_beta

__all__ = [
    "analog",
    "cost_model",
    "crossbar",
    "neurons",
    "physics",
    "wta",
    "AnalogConfig",
    "DIGITAL",
    "DeviceParams",
    "analog_dense",
    "analog_matmul",
    "wta_head",
    "calibrate_v_read",
    "effective_beta",
]
