"""Device physics of the RACA accelerator (``repro/core/physics.py``), the
part the analog crossbar path reads: the constants, the ReRAM device
parameters and the read-voltage calibration.  Plain Python floats.

Johnson-Nyquist thermal noise of the ReRAM devices is the entropy source
(paper §II, Eq. 1-3): i_RMS = sqrt(4 k T G Δf).
"""

from __future__ import annotations

import dataclasses
import math
import struct

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
