"""Synthetic data pipelines of the port (``repro/data``)."""

from .lm_synth import lm_batch

__all__ = ["lm_batch"]
