"""gemma2-2b [dense]: 26L d2304 8H (kv=4) ff9216 vocab256000 — local+global
alternating attention, attn/final logit soft-capping, post-norms, tied
embeddings.  [arXiv:2408.00118; hf]

Same numbers as ``repro/configs/gemma2_2b.py``: the port's first config
whose unit holds two attention sublayers.
"""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="decoder_lm",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_head=256,
    d_ff=9216,
    vocab=256_000,
    mlp="geglu",
    layer_pattern=("local", "global"),
    local_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
    tie_embeddings=True,
    embed_scale=True,
    max_seq=33_000,
)

SKIP_SHAPES = {
    "long_500k": "alternating local+GLOBAL attention (global layers are "
    "quadratic at 500k)"
}


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab=256, local_window=16, max_seq=128,
    )
