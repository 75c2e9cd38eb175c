"""granite-moe-3b-a800m [moe]: 32L d1536 24H (kv=8) ff512/expert
vocab49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Same numbers as ``repro/configs/granite_moe_3b.py``: every layer's MLP is
40 SwiGLU experts of d_ff 512, of which the router picks 8 a token
(``models/moe.py``); tied embeddings.  In ``analog_stochastic`` mode the
router's top-8 is an 8-winner WTA race (``core.wta.wta_topk``).  The smoke
config's capacity factor of 8.0 drops no token.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe_lm",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    mlp="swiglu",
    n_experts=40,
    moe_topk=8,
    tie_embeddings=True,
    max_seq=33_000,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (quadratic at 500k)"}


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=32, vocab=256, n_experts=8, moe_topk=2, max_seq=128,
        capacity_factor=8.0,  # drop-free for exactness tests
    )
