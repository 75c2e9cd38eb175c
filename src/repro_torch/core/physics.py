"""Device physics of the RACA accelerator (``repro/core/physics.py``): the
constants, the ReRAM device parameters, the read-voltage calibration and
the tensor functions of Eq. 1-5 and 11-13.

Johnson-Nyquist thermal noise of the ReRAM devices is the entropy source
(paper §II, Eq. 1-3): i_RMS = sqrt(4 k T G Δf).  Device parameters are
Python floats; a tensor function multiplies its f32 tensor by them as the
reference does (a Python float times an f32 array is an f32 product of
the float rounded to f32).  A host-side scalar that must carry the
reference's f32 bits is computed with ``math`` in f64 and rounded through
:func:`f32`.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Optional, Sequence

import torch

from repro_torch import random as R

# Boltzmann constant [J/K].
BOLTZMANN_K = 1.380649e-23

# Probit->logit matching constant: logistic(z) ~= Phi(z / PROBIT_SCALE).
PROBIT_SCALE = 1.702


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32, as a Python float."""
    return struct.unpack("f", struct.pack("f", x))[0]


@dataclasses.dataclass(frozen=True)
class DeviceParams:
    """Physical parameters of the ReRAM array and its readout, in the
    low-SNR read regime (paper §II, §IV); field for field the reference's."""

    g_min: float = 1.0e-6        # [S] low conductance state (1 MΩ)
    g_max: float = 1.0e-4        # [S] high conductance state (10 kΩ)
    n_levels: int = 32           # programmable conductance levels
    sigma_program: float = 0.0   # programming noise, fraction of (g_max-g_min)
    temperature: float = 300.0   # [K]
    delta_f: float = 1.0e9       # [Hz] readout bandwidth
    v_read: float = 1.0e-3       # [V] V_r, read voltage amplitude (calibrated)
    w_max: float = 1.0           # algorithmic weight clip range
    w_min: float = -1.0

    @property
    def g0(self) -> float:
        """G0 = (Gmax - Gmin) / (Wmax - Wmin)   (Eq. 4)."""
        return (self.g_max - self.g_min) / (self.w_max - self.w_min)

    @property
    def g_ref(self) -> float:
        """G_ref = (Wmax·Gmin - Wmin·Gmax) / (Wmax - Wmin)   (Eq. 5)."""
        return (self.w_max * self.g_min - self.w_min * self.g_max) / (
            self.w_max - self.w_min
        )

    def replace(self, **kw) -> "DeviceParams":
        return dataclasses.replace(self, **kw)


def calibrate_v_read(
    dp: DeviceParams, n_rows: int, mean_abs_w: float = 0.0, beta: float = 1.0
) -> DeviceParams:
    """V_r such that the comparator fires with probability logistic(beta·z):
    V_r = beta·sigma_col / (1.702·G0), with sigma_col from the expected
    column conductance n_rows·2·G_ref (Eq. 13).  sigma_col is the
    correctly rounded f32 square root of the f32-rounded argument, as the
    reference's ``jnp.sqrt`` of a Python float gives it: the root is taken
    in f64 by ``math.sqrt`` and rounded to f32, which is exact for a square
    root (double rounding from f64 cannot differ), and not by
    ``torch.sqrt``, whose f32 root on some CPUs is not correctly rounded."""
    e_g = dp.g_ref + mean_abs_w * 0.0  # E[G] = G_ref for zero-mean weights
    sum_g = n_rows * (e_g + dp.g_ref)
    arg = 4.0 * BOLTZMANN_K * dp.temperature * dp.delta_f * sum_g
    sigma = f32(math.sqrt(f32(arg)))
    v_read = beta * sigma / (PROBIT_SCALE * dp.g0)
    return dp.replace(v_read=v_read)


def weight_to_conductance(w: torch.Tensor, dp: DeviceParams) -> torch.Tensor:
    """Map algorithmic weights onto device conductances (Eq. 4-5):
    G = G0·W + G_ref."""
    return dp.g0 * w + dp.g_ref


def weight_from_conductance(g: torch.Tensor, dp: DeviceParams) -> torch.Tensor:
    """Inverse of Eq. 4-5: W = (G - G_ref) / G0."""
    return (g - dp.g_ref) / dp.g0


def thermal_noise_rms(g: torch.Tensor, dp: DeviceParams) -> torch.Tensor:
    """RMS thermal-noise current of a device with conductance ``g`` (Eq. 1)."""
    return torch.sqrt(4.0 * BOLTZMANN_K * dp.temperature * g * dp.delta_f)


def column_noise_sigma(sum_g, dp: DeviceParams) -> torch.Tensor:
    """Std-dev of the summed column noise current: sigma² = 4 k T Δf · Σ_i
    G_i (Eq. 11, the denominator of Eq. 13); ``sum_g`` holds every device
    on the summing node, signal and reference columns."""
    return torch.sqrt(4.0 * BOLTZMANN_K * dp.temperature * dp.delta_f * sum_g)


def snr_db(p_signal: torch.Tensor, p_noise: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio in dB (Eq. 2)."""
    return 10.0 * torch.log10(p_signal / p_noise)


def column_snr_db(
    z: torch.Tensor, sum_g: torch.Tensor, dp: DeviceParams, r_load: float = 1.0
) -> torch.Tensor:
    """SNR of a column readout at pre-activation ``z`` (Eq. 2-3, 12): the
    signal current V_r·G0·z against the column noise, both into R."""
    i_sig = dp.v_read * dp.g0 * z
    p_signal = torch.square(i_sig) * r_load
    p_noise = torch.square(column_noise_sigma(sum_g, dp)) * r_load
    return snr_db(p_signal, p_noise)


def effective_beta(dp: DeviceParams, n_rows: int) -> float:
    """Inverse of :func:`calibrate_v_read`: the logistic slope realized by
    ``dp`` over ``n_rows`` rows (sigma_col the f32 root, as there)."""
    sum_g = n_rows * 2.0 * dp.g_ref
    sigma = f32(math.sqrt(f32(4.0 * BOLTZMANN_K * dp.temperature * dp.delta_f * sum_g)))
    return dp.v_read * dp.g0 * PROBIT_SCALE / sigma


def sample_noise_current(
    key, sum_g: torch.Tensor, dp: DeviceParams, shape: Optional[Sequence[int]] = None
) -> torch.Tensor:
    """Summed Gaussian thermal-noise current of columns (Eq. 11): jax's
    threefry ``normal(key, shape)`` times the columns' sigma."""
    sigma = column_noise_sigma(sum_g, dp)
    shape = tuple(sigma.shape) if shape is None else tuple(shape)
    return R.normal(key, shape, sigma.device) * sigma
