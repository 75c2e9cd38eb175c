"""recurrentgemma-2b [hybrid]: 26L d2560 10H (kv=1, MQA) ff7680
vocab256000 — RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427; hf]

Same numbers as ``repro/configs/recurrentgemma_2b.py``: 26 layers = 2
units of 13; each unit holds local-attention layers at positions 2, 5, 8
and 11 (4 attention + 9 recurrent per unit = 8 attention + 18 recurrent
in all, the released model's counts; the offsets inside a unit differ
from the released checkpoint's by one position, which is structurally
equivalent).  The port's first config with recurrent state.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

_UNIT = (
    "rec", "rec", "local",
    "rec", "rec", "local",
    "rec", "rec", "local",
    "rec", "rec", "local",
    "rec",
)

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    vocab=256_000,
    mlp="geglu",
    layer_pattern=_UNIT,
    local_window=2048,
    lru_width=2560,
    tie_embeddings=True,
    embed_scale=True,
    max_seq=525_000,
)

SKIP_SHAPES = {}  # sub-quadratic: RG-LRU + 2048-window local attn -> 500k OK


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, layer_pattern=("rec", "rec", "local"),
        d_model=64, n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
        lru_width=64, vocab=256, local_window=16, max_seq=128,
    )
