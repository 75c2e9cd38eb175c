"""grok-1-314b [moe]: 64L d6144 48H (kv=8) ff32768 vocab131072, MoE 8
experts top-2.  [hf:xai-org/grok-1; unverified]

Same numbers as ``repro/configs/grok_1_314b.py``: 8 GeGLU experts of
d_ff 32768 a layer, top-2, attention logits soft-capped at 30, an untied
head.  One layer holds 4.92 B parameters (9.84 GB in bf16), the whole
model 316.5 B: one card holds a few layers of it.  The smoke config's
capacity factor of 4.0 drops no token.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe_lm",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=32768,
    vocab=131072,
    mlp="geglu",
    n_experts=8,
    moe_topk=2,
    attn_softcap=30.0,   # grok uses attention logit capping
    max_seq=33_000,
)

SKIP_SHAPES = {"long_500k": "pure full-attention arch (quadratic at 500k)"}


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=64, vocab=256, n_experts=4, moe_topk=2, max_seq=128,
        capacity_factor=4.0,  # drop-free for exactness tests
    )
