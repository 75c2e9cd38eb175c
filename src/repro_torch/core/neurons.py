"""Binary stochastic Sigmoid neurons (paper §III-A, Eq. 8-13), the
counterpart of ``repro/core/neurons.py``.

A comparator on the noisy differential column current fires with
probability

    P(I_j > I_ref) = Phi( V_r·G0·z_j / sigma_col )            (Eq. 13)
                   ~= logistic(z_j)        after SNR calibration,

the stochastic binarization rule of SBNNs (Eq. 8) with the sigmoid as
activation probability.  ``physical`` runs the full circuit through
``crossbar`` (quantization, per-column ΣG noise); ``calibrated`` is the
ideal limit P = logistic(β·z), the FCNN's path.  Both sample through a
straight-through estimator: the forward emits the hard Bernoulli sample,
the backward treats it as p.

The calibrated hard draw runs ``ops.sigmoid_sample``: one CUDA kernel a
layer on the card (bias, sigmoid, threefry uniform, comparator), its
plain version on the CPU.  Keys are threefry keys of Python ints.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import random as R
from repro_torch.kernels import ops as KOPS
from . import crossbar
from .physics import DeviceParams, column_noise_sigma

# f32(√2), the reference's jnp.sqrt(2.0)
SQRT2_F32 = R.SQRT2_F32


def fire_probability_physical(
    z: torch.Tensor, sum_g: torch.Tensor, dp: DeviceParams
) -> torch.Tensor:
    """Exact comparator fire probability Phi(V_r·G0·z / sigma) (Eq. 13)."""
    sigma = column_noise_sigma(sum_g, dp)
    arg = dp.v_read * dp.g0 * z / sigma
    return 0.5 * (1.0 + torch.erf(arg / SQRT2_F32))


def fire_probability_calibrated(z: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """The logistic limit the circuit is tuned to (right side of Eq. 13)."""
    return torch.sigmoid(beta * z)


class StochasticBinarize(torch.autograd.Function):
    """y ~ Bernoulli(p) in the forward, p itself with ``hard=False``; the
    backward passes the gradient straight to p (dE[y]/dp = 1).  ``y`` is the
    sample when the caller drew it already (the fused kernel), else it is
    drawn here: ``uniform(key, p.shape) < p``."""

    @staticmethod
    def forward(ctx, p, key, hard, y=None):
        if not hard:
            return p
        if y is None:
            y = (R.uniform(key, tuple(p.shape), p.device) < p).to(p.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def stochastic_binarize(key, p: torch.Tensor, hard: bool = True) -> torch.Tensor:
    """Sample y ~ Bernoulli(p); the gradient flows as if y == p (STE).
    With ``hard=False`` returns p (expectation propagation)."""
    return StochasticBinarize.apply(p, key, hard, None)


def sigmoid_neuron_calibrated(
    key,
    z: torch.Tensor,
    beta: float = 1.0,
    hard: bool = True,
    *,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Calibrated-limit stochastic sigmoid neuron: y ~ Bern(logistic(β·(z +
    bias))).  ``bias`` (N,) is folded into the pre-activation before the
    comparator, as the reference's ``analog_dense`` adds it to ``z``; the
    hard draw is one ``ops.sigmoid_sample`` launch.  The sigmoid is formed
    in PyTorch as well only where a gradient is needed (or ``hard`` is
    False): its backward is autograd's sigmoid derivative on p."""
    needs_grad = torch.is_grad_enabled() and (
        z.requires_grad or (bias is not None and bias.requires_grad))
    y = None
    if hard:
        y = KOPS.sigmoid_sample(z.detach(), None if bias is None else bias.detach(), beta, key)
        if not needs_grad:
            return y
    p = fire_probability_calibrated(z if bias is None else z + bias, beta)
    return StochasticBinarize.apply(p, key, hard, y)


def sigmoid_neuron_physical(
    key,
    x: torch.Tensor,
    w: torch.Tensor,
    dp: DeviceParams,
    map_key=None,
    hard: bool = True,
) -> torch.Tensor:
    """Full-circuit stochastic sigmoid layer: x (..., in) @ w (in, out) →
    binary (..., out), sampled through the STE from the comparator's exact
    fire probability (Eq. 13 with the true per-column ΣG)."""
    mapping = crossbar.map_weights(w, dp, key=map_key)
    z = x.to(torch.float32) @ mapping.w_eff
    p = fire_probability_physical(z, crossbar.column_sum_g(mapping), dp)
    return stochastic_binarize(key, p, hard)


def comparator_sample(key, x: torch.Tensor, w: torch.Tensor, dp: DeviceParams) -> torch.Tensor:
    """Literal circuit path (no STE): sample currents, compare (Eq. 8-11)."""
    delta_i, _ = crossbar.analog_mac(key, x, crossbar.map_weights(w, dp), dp)
    return (delta_i > 0.0).to(torch.float32)
