"""The paper's own FCNN [784, 500, 300, 10] on (surrogate) MNIST (§IV-C).

Same numbers as ``repro/configs/fcnn_mnist.py``: hidden layers of binary
stochastic Sigmoid neurons with V_r calibrated over the 784 input rows,
a WTA head; the training forward takes the expectation (E[Bern(σ)] = σ,
the SBNN surrogate), deployment (``fcnn_predict_raca``) samples hard.
"""

import dataclasses

from repro_torch.core.analog import AnalogConfig
from repro_torch.core.physics import DeviceParams, calibrate_v_read
from repro_torch.models.config import ModelConfig

_DEVICE = calibrate_v_read(DeviceParams(), n_rows=784)

CONFIG = ModelConfig(
    name="fcnn-mnist",
    family="fcnn",
    fcnn_layers=(784, 500, 300, 10),
    analog=AnalogConfig(mode="analog_stochastic", device=_DEVICE, wta_trials=32, hard=False),
    wta_head=True,
    dtype="float32",
)


def smoke_config() -> ModelConfig:
    """(64, 32, 16, 10): inputs are the first 64 pixels of an image, as the
    reference's ``tests/test_train.py`` feeds this config."""
    return dataclasses.replace(CONFIG, fcnn_layers=(64, 32, 16, 10))
