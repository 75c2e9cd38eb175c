"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes of each kernel and step, computed from shapes and the slots' real
contexts.

The peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity),
which assumes the card's full 700 W: the run prints the card's
``power.limit`` beside its numbers.  The attention bounds are frozen from
``chip_smoke.py``'s ``decode_bound`` / ``prefill_bound``, with each key and
value read once at the keys a query sees (not whole pages).
"""

from __future__ import annotations

from typing import Iterable

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 / fp16 tensor rate


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the byte time
    and the bf16 operation time."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)


def decode_attention(ctxs: Iterable[int], n_layers: int, h: int, hkv: int, dh: int,
                     kv_bytes: int = 2, q_bytes: int = 2) -> tuple[float, float]:
    """(bytes, flops) of the paged decode attention of one tick over the
    decoding rows' context lengths ``ctxs`` (keys each query sees): every
    key and value byte once, the query, the f32 output; 4 flops a key,
    head and dimension."""
    keys = 0
    rows = 0
    for c in ctxs:
        keys += c
        rows += 1
    per_layer_bytes = keys * hkv * dh * kv_bytes * 2 + rows * h * dh * (q_bytes + 4)
    return float(n_layers * per_layer_bytes), float(n_layers * 4 * keys * h * dh)


def prefill_attention(q0: int, c: int, n_layers: int, h: int, hkv: int, dh: int,
                      kv_bytes: int = 2, q_bytes: int = 2) -> tuple[float, float]:
    """(bytes, flops) of one causal prefill chunk of ``c`` queries from
    absolute position ``q0``: the keys and values of its whole context once,
    the queries, the f32 output; 4 flops a visible key, head and dimension."""
    ctx = q0 + c
    keys = c * q0 + c * (c + 1) // 2
    per_layer_bytes = ctx * hkv * dh * kv_bytes * 2 + c * h * dh * (q_bytes + 4)
    return float(n_layers * per_layer_bytes), float(n_layers * 4 * keys * h * dh)


def token_weights(mcfg) -> int:
    """Parameters one token's forward multiplies by, without the embedding
    lookup and with the LM head: every layer's projections, an MoE layer's
    router and its top-k experts only."""
    d, dh = mcfg.d_model, mcfg.head_dim
    attn = d * dh * (2 * mcfg.n_heads + 2 * mcfg.n_kv_heads)
    mats = 3 if mcfg.mlp in ("swiglu", "geglu") else 2
    if mcfg.n_experts:
        mlp = d * mcfg.n_experts + mcfg.moe_topk * mats * d * mcfg.d_ff
    else:
        mlp = mats * d * mcfg.d_ff
    return mcfg.n_layers * (attn + mlp) + d * mcfg.vocab


def layer_weights(mcfg) -> int:
    """:func:`token_weights` without the LM head (a prefill token that
    computes no logits)."""
    return token_weights(mcfg) - mcfg.d_model * mcfg.vocab


def decode_flops(mcfg, ctxs: Iterable[int]) -> float:
    """The model's FLOPs of one decode token per context in ``ctxs``: 2 a
    weight it multiplies by, plus attention over its context."""
    ctxs = list(ctxs)
    _, att = decode_attention(ctxs, mcfg.n_layers, mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim)
    return 2.0 * token_weights(mcfg) * len(ctxs) + att


def prefill_flops(mcfg, q0: int, c: int, last: bool) -> float:
    """The model's FLOPs of one prefill chunk: 2 a layer weight a token,
    the LM head for the prompt's last token (``last``), causal attention."""
    _, att = prefill_attention(q0, c, mcfg.n_layers, mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim)
    head = 2.0 * mcfg.d_model * mcfg.vocab if last else 0.0
    return 2.0 * layer_weights(mcfg) * c + head + att
