"""stablelm-3b [dense]: 32L d2560 32H (kv=32, MHA) ff6912 vocab50304.

Same numbers as ``repro/configs/stablelm_3b.py``: the port's main-path
model, served at full width on the card.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="decoder_lm",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=6912,
    vocab=50304,
    mlp="swiglu",
    max_seq=33_000,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab=256, max_seq=128,
    )
