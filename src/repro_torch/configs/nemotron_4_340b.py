"""nemotron-4-340b [dense]: 96L d18432 96H (kv=8) ff73728 vocab256000 —
GQA + squared-ReLU MLP (non-gated).  [arXiv:2402.16819; unverified]

Same numbers as ``repro/configs/nemotron_4_340b.py``.  Squared-ReLU is
not sigmoid-shaped, so the paper's stochastic-binary neuron is
inapplicable as the hidden activation here; analog execution uses the
linear-readout mode (noise-aware training) only.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="decoder_lm",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_head=192,
    d_ff=73728,
    vocab=256_000,
    mlp="relu2",
    max_seq=33_000,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (quadratic at 500k)"}


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, max_seq=128,
    )
