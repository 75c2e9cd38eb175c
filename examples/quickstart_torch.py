"""Quickstart on the PyTorch/CUDA port: the paper's circuit in 60 lines.

Builds a stochastic binary Sigmoid neuron layer and a WTA SoftMax readout
from the public API (``repro_torch.core``), shows the calibration that
makes thermal noise act as the activation function, and classifies a
batch with majority voting.  The crossbar read runs the ``crossbar_mac``
kernel on the card (its plain version on the CPU), the WTA votes the
``wta_sample`` kernel.  ``examples/quickstart.py``'s steps and keys.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch import random as R
from repro_torch.core import (
    AnalogConfig,
    DeviceParams,
    analog,
    analog_matmul,
    calibrate_v_read,
    effective_beta,
    wta_head,
)
from repro_torch.core.crossbar import quantize_weights
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device; the card when omitted, 'cpu' for the plain PyTorch path")
dev = resolve_device(ap.parse_args().device)

# --- 1. Calibrate the device so the comparator IS a sigmoid (Eq. 13) -------
N_INPUTS = 784
dp = calibrate_v_read(DeviceParams(), n_rows=N_INPUTS)
print(f"calibrated read voltage V_r = {dp.v_read * 1e3:.2f} mV")
print(f"effective logistic slope beta = {effective_beta(dp, N_INPUTS):.4f}")

cfg = AnalogConfig(mode="analog_stochastic", device=dp, use_pallas="auto")

# --- 2. A crossbar layer: MAC + thermal noise + comparator, no ADC ---------
w = R.normal(R.PRNGKey(0), (N_INPUTS, 256), dev) * 0.05
x = (R.uniform(R.PRNGKey(1), (32, N_INPUTS), dev) < 0.3).to(torch.float32)

k1, k2 = R.split(R.PRNGKey(2))
binary_hidden = analog_matmul(cfg, k1, x, w)
print("hidden activations are binary:", sorted(set(torch.unique(binary_hidden).tolist())))
print("mean fire rate:", float(binary_hidden.mean()))

# expectation matches the logistic of the (conductance-quantized)
# pre-activation:
p_emp = torch.stack([analog_matmul(cfg, k, x, w) for k in R.split(k2, 256)]).mean(0)
p_ideal = torch.sigmoid(x @ quantize_weights(w, dp))
print("E[comparator] vs sigmoid, max err:", float((p_emp - p_ideal).abs().max()))
# the crossbar maps W/s onto the devices (s = max|W|, the layer's dynamic
# range) and its noise absorbs s: its ideal is the range-quantized weights'
p_range = torch.sigmoid(x @ analog.quantize_normalized(w, cfg))
err = (p_emp - p_range).abs()
print(f"E[comparator] vs sigmoid of the range-quantized layer: max err "
      f"{float(err.max()):.4f}, mean err {float(err.mean()):.4f}")

# --- 3. WTA SoftMax readout: votes, no exponentials ------------------------
logits = R.normal(R.PRNGKey(3), (4, 10), dev)
res = wta_head(cfg, R.PRNGKey(4), logits)
print("WTA vote shares:", [round(v, 3) for v in res.probs[0].tolist()])
print("softmax        :", [round(v, 3) for v in torch.softmax(logits[0], -1).tolist()])
print("prediction agreement:",
      bool(torch.all(torch.argmax(res.counts, -1) == torch.argmax(logits, -1))))
