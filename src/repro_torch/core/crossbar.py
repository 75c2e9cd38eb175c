"""ReRAM crossbar weight mapping and analog MAC simulation (paper §II-B),
the counterpart of ``repro/core/crossbar.py``.

Eq. 4-7 plus the non-idealities that matter for deployment: conductance
quantization to ``n_levels`` and Gaussian programming noise.  Per output
column j the simulated crossbar computes (Eq. 9-12)

    I_j     = Σ_i V_i · G_ij + noise_j,   G_ij = W_ij·G0 + G_ref
    I_ref   = Σ_i V_i · G_ref + noise_ref
    E[I_j - I_ref] = V_r · G0 · Σ_i W_ij x_i = V_r · G0 · z_j

and tall matrices tile into arrays of ``rows_per_tile`` wordlines whose
columns share a summing TIA, so the noise variance accumulates over all
rows (Eq. 13's denominator).

:func:`quantize_weights` carries the reference's bits as its jitted code
computes them (the FCNN's training step and vote scan are jitted): XLA
turns ``(w − w_min) / step`` into a multiply by the f32 reciprocal of
``step`` and fuses ``t·step + w_min`` into one FMA on the CPU (measured
bit-equal on 2**20 weights).  The other functions are plain f32 tensor
code; XLA may fuse their multiply-adds differently, so they agree with the
reference to an ulp or two.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import random as R
from .physics import DeviceParams, column_noise_sigma, f32


class CrossbarMapping(NamedTuple):
    """Conductance-domain view of a weight matrix."""

    g: torch.Tensor          # (in, out) device conductances [S]
    g_ref: torch.Tensor      # 0-d reference conductance [S], f32
    w_eff: torch.Tensor      # effective (quantized) weights seen by the algorithm


def quantize_weights(
    w: torch.Tensor, dp: DeviceParams, key: Optional[R.Key] = None, stochastic: bool = False
) -> torch.Tensor:
    """Quantize weights onto the grid of ``n_levels`` conductances:
    round-to-nearest (half to even), or unbiased stochastic rounding
    under the threefry ``key`` (``uniform(key, w.shape) < frac``)."""
    w = torch.clamp(w, dp.w_min, dp.w_max)
    if dp.n_levels <= 1:
        return w
    step = f32((dp.w_max - dp.w_min) / (dp.n_levels - 1))
    t = (w - dp.w_min) * f32(1.0 / step)
    if stochastic and key is not None:
        floor = torch.floor(t)
        up = R.uniform(key, tuple(w.shape), w.device) < t - floor
        t = floor + up.to(w.dtype)
    else:
        t = torch.round(t)
    return R.fma32(t, step, dp.w_min)


def map_weights(
    w: torch.Tensor, dp: DeviceParams, key: Optional[R.Key] = None, quantize: bool = True
) -> CrossbarMapping:
    """Map algorithmic weights to conductances (Eq. 4-7); with ``key``,
    stochastic quantization under ``split(key)[0]`` and programming noise
    under ``split(key)[1]``."""
    kq = kp = None
    if key is not None:
        kq, kp = R.split(key)
    w_eff = quantize_weights(w, dp, kq, stochastic=key is not None) if quantize else w
    g = w_eff * dp.g0 + dp.g_ref  # Eq. 7
    if dp.sigma_program > 0.0 and kp is not None:
        noise = R.normal(kp, tuple(g.shape), g.device)
        g = torch.clamp(g + noise * (dp.sigma_program * (dp.g_max - dp.g_min)), dp.g_min, dp.g_max)
    w_eff = (g - dp.g_ref) / dp.g0  # weights actually realized
    g_ref = torch.tensor(dp.g_ref, dtype=torch.float32, device=w.device)
    return CrossbarMapping(g=g, g_ref=g_ref, w_eff=w_eff)


def column_sum_g(mapping: CrossbarMapping) -> torch.Tensor:
    """Σ_i (G_ij + G_ref) per output column: Eq. 13's noise denominator."""
    return mapping.g.sum(dim=0) + mapping.g.shape[0] * mapping.g_ref


def analog_mac(
    key: R.Key, x: torch.Tensor, mapping: CrossbarMapping, dp: DeviceParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differential analog MAC: (delta_i, sigma_col).  ``delta_i`` (..., out)
    is the noisy I_j − I_ref (Eq. 9-12) with mean V_r·G0·(x @ W_eff), its
    noise jax's threefry ``normal(key, delta_i.shape)`` times the column's
    sigma."""
    v = x.to(torch.float32) * dp.v_read  # Eq. 6
    mean = v @ (mapping.g - mapping.g_ref)
    sigma = column_noise_sigma(column_sum_g(mapping), dp)
    noise = R.normal(key, tuple(mean.shape), mean.device) * sigma
    return mean + noise, sigma


def analog_matmul_zspace(
    key: R.Key,
    x: torch.Tensor,
    w: torch.Tensor,
    dp: DeviceParams,
    quantize: bool = True,
    map_key: Optional[R.Key] = None,
) -> torch.Tensor:
    """Analog matmul with input-referred noise, in z-units:
    x @ W_eff + n / (V_r·G0) (the ideal-ADC readout)."""
    mapping = map_weights(w, dp, key=map_key, quantize=quantize)
    delta_i, _ = analog_mac(key, x, mapping, dp)
    return delta_i / (dp.v_read * dp.g0)


def zspace_noise_sigma(w: torch.Tensor, dp: DeviceParams) -> torch.Tensor:
    """Per-column noise std in z-units: sigma_I / (V_r·G0)."""
    sum_g = (w * dp.g0 + dp.g_ref).sum(dim=0) + w.shape[0] * dp.g_ref
    return column_noise_sigma(sum_g, dp) / (dp.v_read * dp.g0)


def tile_count(n_rows: int, rows_per_tile: int) -> int:
    """Physical arrays needed for a (n_rows, ·) matrix (cost model input)."""
    return -(-n_rows // rows_per_tile)
