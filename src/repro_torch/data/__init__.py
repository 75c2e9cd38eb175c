"""Synthetic data pipelines of the port (``repro/data``)."""

from .lm_synth import lm_batch
from .mnist_synth import mnist_batch, mnist_dataset

__all__ = ["lm_batch", "mnist_batch", "mnist_dataset"]
