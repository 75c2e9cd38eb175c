"""llava-next-34b [vlm]: 60L d7168 56H (kv=8) ff20480 vocab64000.

The AnyRes tiling and the vision tower are a stub: the inputs are
precomputed patch embeddings (576 for the base 336 px tile), prepended to
the text sequence.  The backbone is the Yi-34B-class dense LM.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]

Same numbers as ``repro/configs/llava_next_34b.py``.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    mlp="swiglu",
    rope_theta=5_000_000.0,
    n_patches=576,
    max_seq=34_000,
)

# full attention only -> long_500k skipped (quadratic KV at 524k).
SKIP_SHAPES = {"long_500k": "pure full-attention arch (quadratic at 500k)"}


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, n_patches=8, max_seq=128,
    )
