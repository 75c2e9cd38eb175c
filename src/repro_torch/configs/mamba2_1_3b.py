"""mamba2-1.3b [ssm]: 48L d2048 (attention-free) vocab50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

Same numbers as ``repro/configs/mamba2_1_3b.py``: 48 Mamba-2 mixer
layers of d_inner 4096 (64 heads of 64), SSM state 128, a width-4 causal
conv and SSD chunks of 256, tied embeddings.  No attention anywhere, so a
paged cache holds no K/V pool, only the per-slot conv tail and SSM state;
O(1) decode state, so it runs long_500k.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    d_ff=0,
    vocab=50280,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    tie_embeddings=True,
    max_seq=525_000,
)

SKIP_SHAPES = {}  # attention-free: O(1) decode state -> 500k OK


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, ssm_state=16, ssm_headdim=16,
        ssm_chunk=8, vocab=256, max_seq=128,
    )
