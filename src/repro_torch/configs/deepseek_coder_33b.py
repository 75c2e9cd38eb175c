"""deepseek-coder-33b [dense]: 62L d7168 56H (kv=8) ff19200 vocab32256 —
llama-arch.  [arXiv:2401.14196; hf]

Same numbers as ``repro/configs/deepseek_coder_33b.py``.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="decoder_lm",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=19200,
    vocab=32256,
    mlp="swiglu",
    rope_theta=100_000.0,
    max_seq=33_000,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (quadratic at 500k)"}


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, max_seq=128,
    )
