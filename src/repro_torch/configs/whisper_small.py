"""whisper-small [audio]: 12L(enc)+12L(dec) d768 12H (kv=12) ff3072
vocab51865 — encoder-decoder; the conv-mel frontend is a stub (the
inputs are precomputed frame embeddings).  [arXiv:2212.04356]

Same numbers as ``repro/configs/whisper_small.py``.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=24,
    enc_layers=12,
    dec_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_head=64,
    d_ff=3072,
    vocab=51865,
    mlp="gelu",
    enc_seq=1500,       # encoder length for decode shapes (30 s of audio)
    max_seq=33_000,
)

SKIP_SHAPES = {"long_500k": "full-attention enc-dec (quadratic at 500k)"}


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, enc_layers=2, dec_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
        enc_seq=16, max_seq=64,
    )
