"""WTA binary stochastic SoftMax neurons (paper §III-B, Eq. 14), the
counterpart of ``repro/core/wta.py``.

Per decision trial every output neuron's noisy voltage ``V_j = z_j + n``,
``n ~ N(0, σ²)`` (z-units after calibration), is compared against the
threshold ``V_th0``; the neurons above it fire, and the one furthest above
wins the race that pulls the threshold to the supply, so a trial has at
most one winner.  Counting winners over T trials approximates SoftMax;
θ = σ² gives unit temperature (the Gaussian-tail argument).

The noise is jax's threefry ``normal`` (``repro_torch.random``), drawn in
the kernel of ``ops.wta_trial_counts`` on the card.  Keys are threefry key
pairs of Python ints, as elsewhere in the port.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import random as R
from repro_torch.kernels import ops as KOPS
from .physics import PROBIT_SCALE


class WTAResult(NamedTuple):
    counts: torch.Tensor        # (..., C) winner counts over trials
    n_decisions: torch.Tensor   # (...,)   trials with >= 1 neuron fired
    probs: torch.Tensor         # (..., C) normalized cumulative distribution


def wta_sigma_z(beta: float = 1.0) -> float:
    """Noise std in z-units at the calibrated operating point."""
    return PROBIT_SCALE / beta


def calibrated_threshold(beta: float = 1.0, temp: float = 1.0) -> float:
    """θ = σ²/temp gives softmax with temperature ``temp`` (tail argument)."""
    s = wta_sigma_z(beta)
    return s * s / temp


def wta_trials(
    key: R.Key,
    z: torch.Tensor,
    n_trials: int,
    vth0: float,
    sigma_z: Optional[float] = None,
    beta: float = 1.0,
) -> WTAResult:
    """T WTA decision trials on pre-activations ``z`` (..., C): the noise is
    ``normal(key, (T,) + z.shape)``, so trial t of row n (of ``z`` as (N,
    C)) draws at the flat index ``t·N·C + n·C + c``.  ``key`` is a key of
    Python ints, or its two words in an int64 tensor already on z's device
    (which spares a host-to-device copy, and its sync, a call)."""
    if sigma_z is None:
        sigma_z = wta_sigma_z(beta)
    lead, c = z.shape[:-1], z.shape[-1]
    n = math.prod(lead)
    if not isinstance(key, torch.Tensor):
        key = torch.tensor(key, dtype=torch.int64, device=z.device)
    keys = key.reshape(1, 2).expand(n, 2)
    counts, n_dec = KOPS.wta_trial_counts(
        z.reshape(n, c).to(torch.float32), keys, None, n_trials, vth0, sigma_z, (n * c, c)
    )
    counts, n_dec = counts.reshape(z.shape), n_dec.reshape(lead)
    probs = counts / counts.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return WTAResult(counts=counts, n_decisions=n_dec, probs=probs)


def wta_classify(
    key: R.Key,
    z: torch.Tensor,
    n_trials: int,
    vth0: float,
    sigma_z: Optional[float] = None,
    beta: float = 1.0,
) -> torch.Tensor:
    """Majority-vote classification: argmax of cumulative winner counts."""
    return torch.argmax(wta_trials(key, z, n_trials, vth0, sigma_z, beta).counts, dim=-1)


def wta_fire_probability(
    z: torch.Tensor, vth0: float, sigma_z: Optional[float] = None, beta: float = 1.0
) -> torch.Tensor:
    """Per-neuron single-trial fire probability P(V_j > vth0)."""
    if sigma_z is None:
        sigma_z = wta_sigma_z(beta)
    return 0.5 * (1.0 + torch.erf((z - vth0) / (sigma_z * math.sqrt(2.0))))


def wta_expected_probs(
    z: torch.Tensor, vth0: float, sigma_z: Optional[float] = None, beta: float = 1.0
) -> torch.Tensor:
    """First-order analytic P_WTA (Eq. 14 LHS): fire probabilities
    normalized; exact when at most one neuron fires per trial."""
    p = wta_fire_probability(z, vth0, sigma_z, beta)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, in descending
    order, equal values by the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def wta_topk(
    key: R.Key,
    z: torch.Tensor,
    k: int,
    n_trials: int,
    vth0: float,
    sigma_z: Optional[float] = None,
    beta: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k-winner WTA: top-k of cumulative counts (MoE-router generalization).
    Zero-count ties are broken by z, so the result is always a valid set
    of k experts.  Returns (values = vote shares, indices)."""
    res = wta_trials(key, z, n_trials, vth0, sigma_z, beta)
    vals, idx = top_k(res.counts + 1e-6 * torch.softmax(z.float(), dim=-1), k)
    share = vals / res.counts.sum(dim=-1, keepdim=True).clamp_min(1.0)
    return share, idx
