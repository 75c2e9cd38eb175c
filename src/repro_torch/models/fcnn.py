"""The paper's FCNN [784, 500, 300, 10] with RACA neurons (§IV-C), the
counterpart of ``repro/models/fcnn.py``.

Hidden layers: binary stochastic Sigmoid neurons (comparators on noisy
crossbar columns, ``core.analog.analog_dense``'s bias-folded branch);
output layer: WTA binary stochastic SoftMax neurons with majority voting
over repeated decision trials (``core.wta``).  Trained with the STE
surrogate (noise-aware QAT); inference runs the full stochastic circuit.
The digital baseline (same weights, exact sigmoid, argmax) is the
accuracy-gap reference.

Parameters are the reference's flat tree ``{"w0", "b0", "w1", ...}`` in
f32.  Keys are threefry keys of Python ints (``repro_torch.random``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as R
from repro_torch.core import analog as A
from repro_torch.core import wta as W
from repro_torch.device import resolve_device
from .config import ModelConfig


def init_fcnn(key: R.Key, cfg: ModelConfig, device=None) -> dict:
    """He-normal weights and zero biases, drawn as the reference draws them:
    layer i's weights under the first key of ``split`` of the running key,
    ``normal(k, (a, b)) · √(2/a)``."""
    dev = resolve_device(device)
    sizes = cfg.fcnn_layers
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        k1, key = R.split(key)
        params[f"w{i}"] = R.normal(k1, (a, b), dev) * (2.0 / a) ** 0.5
        params[f"b{i}"] = torch.zeros((b,), dtype=torch.float32, device=dev)
    return params


def fcnn_logits(
    params: dict,
    x: torch.Tensor,  # (B, in) in [0, 1]
    cfg: ModelConfig,
    key: Optional[R.Key] = None,
) -> torch.Tensor:
    """Forward through the hidden stochastic-binary layers (layer i under
    ``fold_in(key, i)``), returning the last layer's pre-activations z (the
    WTA neurons' drive)."""
    n = len(cfg.fcnn_layers) - 1
    acfg = cfg.analog
    h = x
    for i in range(n - 1):
        ki = None if key is None else R.fold_in(key, i)
        h = A.analog_dense(acfg, ki, h, params[f"w{i}"], params[f"b{i}"])
        if acfg.mode == "digital":
            h = torch.sigmoid(h)  # digital baseline: exact sigmoid
    return h @ params[f"w{n - 1}"] + params[f"b{n - 1}"]


def fcnn_loss(
    params: dict, batch: dict, cfg: ModelConfig, key: Optional[R.Key] = None
) -> tuple[torch.Tensor, dict]:
    """Softmax cross-entropy on the WTA drive; ``batch`` holds "image" (B,
    in) and "label" (B,)."""
    z = fcnn_logits(params, batch["image"], cfg, key)
    labels = batch["label"].long()
    logp = torch.log_softmax(z, dim=-1)
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (z.argmax(dim=-1) == labels).to(torch.float32).mean()
    return nll, {"loss": nll, "acc": acc}


@torch.no_grad()
def fcnn_predict_digital(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Digital software baseline: exact (unquantized) sigmoid hidden layers
    and argmax (the first index among equal maxima, as jnp's)."""
    dcfg = dataclasses.replace(cfg, analog=cfg.analog.with_mode("digital"))
    return fcnn_logits(params, x, dcfg, None).argmax(dim=-1)


@torch.no_grad()
def fcnn_predict_raca(
    params: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    key: R.Key,
    n_votes: int,
    vth0: Optional[float] = None,
) -> torch.Tensor:
    """Full RACA stochastic inference: every vote ``kv = split(key,
    n_votes)[v]`` re-samples each hidden layer's comparators (hard) and
    runs one WTA trial on the drive under ``fold_in(kv, 99)``; the winner
    counts add up over the votes and their argmax is the prediction
    (§III-C, Fig. 6).

    The votes are a Python loop over host keys with no device sync: the
    hidden draws take their keys by value, the WTA keys go to the device
    in one copy before the loop.  In ``analog_stochastic`` mode the hidden
    weights are quantized once, since the quantized weights do not depend
    on a vote's key (the same numbers as quantizing in every vote)."""
    acfg = dataclasses.replace(cfg.analog, hard=True)
    theta = acfg.vth0 if vth0 is None else vth0
    sigma = W.wta_sigma_z(acfg.beta)
    n = len(cfg.fcnn_layers) - 1
    if acfg.mode == "analog_stochastic":
        params = dict(params)
        for i in range(n - 1):
            params[f"w{i}"] = A.quantize_normalized(params[f"w{i}"].to(torch.float32), acfg)
        acfg = dataclasses.replace(acfg, quantize=False)
    cfg = dataclasses.replace(cfg, analog=acfg)
    keys = R.split(key, n_votes)
    wta_keys = torch.tensor([R.fold_in(kv, 99) for kv in keys], dtype=torch.int64,
                            device=x.device).reshape(n_votes, 2)
    counts = torch.zeros(x.shape[:-1] + (cfg.fcnn_layers[-1],), dtype=torch.float32,
                         device=x.device)
    for v, kv in enumerate(keys):
        z = fcnn_logits(params, x, cfg, kv)
        counts += W.wta_trials(wta_keys[v], z, n_trials=1, vth0=theta, sigma_z=sigma,
                               beta=acfg.beta).counts
    return counts.argmax(dim=-1)
