"""Fig. 6: RACA inference accuracy vs the number of WTA votes, with the
SNR (Fig. 6a) and threshold-voltage (Fig. 6b) sweeps, as
``benchmarks/bench_fcnn_accuracy.py``.

Trains the paper's FCNN at the reference bench's reduced hidden widths
(``LAYERS``; ``examples/train_mnist_raca_torch.py`` runs the full [784,
500, 300, 10]) for ``TRAIN_STEPS`` steps with the stochastic-binary STE
recipe on the MNIST surrogate, then measures the digital baseline's
accuracy (exact sigmoid + argmax), RACA's at 1/4/16/64 votes, at 16 votes
with V_th0 ∈ {0, calibrated} (Fig. 6b), and at 16 votes with β = 2
(Fig. 6a).  ``run`` reads ``LAYERS`` and ``TRAIN_STEPS`` as module
globals, as the reference's does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as R
from repro_torch.configs.fcnn_mnist import CONFIG as FCNN_CFG
from repro_torch.core.physics import DeviceParams, calibrate_v_read
from repro_torch.data import mnist_batch, mnist_dataset
from repro_torch.device import resolve_device
from repro_torch.models.fcnn import fcnn_predict_digital, fcnn_predict_raca
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step

from . import wall_us

LAYERS = (784, 128, 64, 10)
TRAIN_STEPS = 400


def _train(cfg, device):
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=5e-3, state_dtype="float32", stochastic_rounding=False)
    )
    state = init_train_state(0, cfg, tcfg, device=device)
    step = make_train_step(cfg, tcfg)
    for i in range(TRAIN_STEPS):
        state, _ = step(state, mnist_batch(batch=128, step=i, device=device))
    return state.params


def _acc(pred: torch.Tensor, y: torch.Tensor) -> float:
    return float((pred == y).float().mean())


def run(device=None) -> list[tuple[str, float, str]]:
    dev = resolve_device(device)
    rows = []
    cfg = dataclasses.replace(
        FCNN_CFG,
        fcnn_layers=LAYERS,
        analog=dataclasses.replace(
            FCNN_CFG.analog,
            device=calibrate_v_read(DeviceParams(), LAYERS[0]),
            use_pallas="off",
        ),
    )
    params, train_us = wall_us(lambda: _train(cfg, dev), dev)
    test = mnist_dataset(512, device=dev)
    x, y = test["image"], test["label"].long()

    digital = _acc(fcnn_predict_digital(params, x, cfg), y)
    rows.append(("fcnn_train", train_us, f"digital_acc={digital:.4f}"))

    for votes in (1, 4, 16, 64):
        pred, dt = wall_us(lambda: fcnn_predict_raca(params, x, cfg, R.PRNGKey(7), votes), dev)
        rows.append((f"fig6_raca_votes{votes}", dt, f"acc={_acc(pred, y):.4f}"))

    # Fig 6(b): threshold sweep at 16 votes
    for name, vth in (("vth0_zero", 0.0), ("vth0_cal", None)):
        pred = fcnn_predict_raca(params, x, cfg, R.PRNGKey(8), 16, vth0=vth)
        rows.append((f"fig6b_{name}_votes16", 0.0, f"acc={_acc(pred, y):.4f}"))

    # Fig 6(a): detuned SNR (β=2 — sharper, undertrained mismatch)
    cfg_det = dataclasses.replace(cfg, analog=dataclasses.replace(cfg.analog, beta=2.0))
    pred = fcnn_predict_raca(params, x, cfg_det, R.PRNGKey(9), 16)
    rows.append(("fig6a_detuned_beta2_votes16", 0.0, f"acc={_acc(pred, y):.4f}"))
    return rows
