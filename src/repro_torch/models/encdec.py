"""Whisper-style encoder-decoder (arXiv:2212.04356;
``repro/models/encdec.py``), the ``encdec`` family.

The conv-mel audio frontend is a stub in the reference too: the inputs
are precomputed frame embeddings (B, S_enc, D).  Everything downstream is
real: sinusoidal encoder positions, a bidirectional encoder, a causal
decoder with learned positions and cross-attention, and the tied output
head ``x @ embedding.T``.

Parameters keep the reference's tree: ``enc`` and ``dec`` stacks with a
leading layer axis (``params["dec"]["cross_attn"]["wq"]`` is
``(dec_layers, d, H*Dh)``), ``embed``, ``dec_pos`` (max_seq, d) in the
model's dtype, ``enc_norm`` and ``dec_norm``.  The depth loops are
Python loops over layers; the training path unbinds each stacked leaf
once (``transformer.unbind_units``), the decode step indexes views.

Keys follow the reference: encoder layer ``li`` draws under
``fold_in(key, li)``, decoder layer ``li`` under ``fold_in(key, li +
1000)``, and that one key goes to the layer's self-attention, its
cross-attention and its MLP alike.  Each layer runs under
``layers.remat("nothing", ...)`` whatever ``cfg.remat_policy`` says, as
the reference wraps each scan body in a plain ``jax.checkpoint``: the
backward runs every layer's forward again (its crossbar reads too), and
no number moves.

Serving is the dense step alone, as in the reference (its engine and
paged entry points refuse this family): :func:`encdec_prefill` encodes
the frames, computes every decoder layer's cross K/V once into
``ck`` / ``cv`` and runs the prompt; :func:`encdec_decode_step` writes
this step's self-attention K/V at ``pos`` and advances ``pos`` in place,
so a captured step (``specs.DenseGraphs``) reads what the engine writes
there between steps.  Its cross-attention readout casts ``ck`` / ``cv``
to f32 every step, as the reference does.  No kernel is on this path but
the crossbar's, in the analog training modes: attention, the sinusoids
and the cross readout are plain PyTorch, as they are jnp in the
reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import parallel as PX
from repro_torch import random as R
from repro_torch.device import resolve_device
from . import attention as ATT
from .config import ModelConfig
from .layers import (dtype_of, init_embedding, init_generator, init_mlp, init_rmsnorm, mlp_apply,
                     randn, remat, rmsnorm)
from .transformer import cross_entropy, new_cache, unbind_units, unit_params


def sinusoid_pos(s: int, d: int, device=None) -> torch.Tensor:
    """(s, d) f32: ``sin`` then ``cos`` of ``pos / 10000**(2i/d)``."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, dtype=torch.float32, device=device),
                          2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_encdec(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Seeded random parameters on ``device`` (the card unless ``"cpu"``),
    drawn from one ``torch.Generator``: the reference's leaves, shapes and
    dtypes, other numbers than ``jax.random``'s."""
    dev = resolve_device(device)
    gen = init_generator(seed, dev)
    dt = dtype_of(cfg)
    d = cfg.d_model
    enc = (cfg.enc_layers,)
    dec = (cfg.dec_layers,)
    dec_pos = randn(gen, (cfg.max_seq, d))
    return {
        "embed": init_embedding(gen, cfg.vocab, d, dt),
        "dec_pos": (dec_pos * 0.01).to(dt),
        "enc": {
            "ln1": init_rmsnorm(d, enc, dev),
            "attn": ATT.init_attn(gen, cfg, enc),
            "ln2": init_rmsnorm(d, enc, dev),
            "ffn": init_mlp(gen, cfg, enc),
        },
        "dec": {
            "ln1": init_rmsnorm(d, dec, dev),
            "self_attn": ATT.init_attn(gen, cfg, dec),
            "ln_x": init_rmsnorm(d, dec, dev),
            "cross_attn": ATT.init_attn(gen, cfg, dec),
            "ln2": init_rmsnorm(d, dec, dev),
            "ffn": init_mlp(gen, cfg, dec),
        },
        "enc_norm": init_rmsnorm(d, (), dev),
        "dec_norm": init_rmsnorm(d, (), dev),
    }


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, key=None) -> torch.Tensor:
    """The encoder over precomputed frame embeddings (B, S_enc, D): the
    frames cast to the model's dtype plus the sinusoids, bidirectional
    self-attention without RoPE; (B, S_enc, D) after ``enc_norm``."""
    b, s, d = frames.shape
    dt = dtype_of(cfg)
    x = PX.shard(frames.to(dt) + sinusoid_pos(s, d, frames.device).to(dt),
                 ("batch", "seq", "embed"))
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    eps = cfg.norm_eps
    for li, lp in enumerate(unbind_units(params["enc"])):
        ki = None if key is None else R.fold_in(key, li)
        x = remat("nothing", _enc_layer, x, lp, positions, cfg, ki)
    return rmsnorm(params["enc_norm"], x, eps)


def _enc_layer(x, lp: dict, positions, cfg: ModelConfig, ki) -> torch.Tensor:
    eps = cfg.norm_eps
    x = x + ATT.self_attention(lp["attn"], rmsnorm(lp["ln1"], x, eps), positions, cfg,
                               kind="none", key=ki, use_rope=False)
    return x + mlp_apply(lp["ffn"], rmsnorm(lp["ln2"], x, eps), cfg, ki)


def _dec_layer(x, lp: dict, positions, enc_out, cfg: ModelConfig, ki) -> torch.Tensor:
    eps = cfg.norm_eps
    x = x + ATT.self_attention(lp["self_attn"], rmsnorm(lp["ln1"], x, eps), positions, cfg,
                               kind="global", key=ki, use_rope=False)
    x = x + ATT.cross_attention(lp["cross_attn"], rmsnorm(lp["ln_x"], x, eps), enc_out, cfg,
                                key=ki)
    return x + mlp_apply(lp["ffn"], rmsnorm(lp["ln2"], x, eps), cfg, ki)


def _embed_dec(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the learned positions 0..S-1."""
    x = PX.take_rows(params["embed"]["embedding"], tokens)
    return x + params["dec_pos"][: tokens.shape[1]][None]


def _tied_head(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["embed"]["embedding"].T.to(x.dtype)


def decode_train(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor, cfg: ModelConfig,
                 key=None) -> torch.Tensor:
    """The decoder's full-sequence forward: logits (B, S_dec, V) for tokens
    (B, S_dec) over the encoder's output (B, S_enc, D)."""
    b, s = tokens.shape
    x = PX.shard(_embed_dec(params, tokens), ("batch", "seq", "embed"))
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    eps = cfg.norm_eps
    for li, lp in enumerate(unbind_units(params["dec"])):
        ki = None if key is None else R.fold_in(key, li + 1000)
        x = remat("nothing", _dec_layer, x, lp, positions, enc_out, cfg, ki)
    logits = _tied_head(params, rmsnorm(params["dec_norm"], x, eps))
    return PX.shard(logits, ("batch", "seq", "vocab"))


def encdec_loss(params: dict, batch: dict, cfg: ModelConfig, key=None) -> tuple[torch.Tensor, dict]:
    """(loss, metrics) for a batch {"frames" (B, S_enc, D), "tokens",
    "labels" (B, S_dec), optional "mask"}; analog projections draw under
    ``key`` (digital when ``None``)."""
    enc_out = encode(params, batch["frames"], cfg, key)
    logits = decode_train(params, batch["tokens"], enc_out, cfg, key)
    loss, metrics = cross_entropy(logits, batch["labels"], batch.get("mask"))
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# The dense serving path.
# ---------------------------------------------------------------------------


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
                      device=None) -> dict:
    """Zeroed decode cache: self-attention ``k`` / ``v`` (L, B, max_len,
    Hkv, Dh), cross-attention ``ck`` / ``cv`` (L, B, enc_len, Hkv, Dh), in
    the model's dtype, and ``pos`` (B,) int32."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    lead = (cfg.dec_layers, batch)
    kv = (cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(lead + (max_len,) + kv, dtype=dt, device=dev),
        "v": torch.zeros(lead + (max_len,) + kv, dtype=dt, device=dev),
        "ck": torch.zeros(lead + (enc_len,) + kv, dtype=dt, device=dev),
        "cv": torch.zeros(lead + (enc_len,) + kv, dtype=dt, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def encdec_prefill(params: dict, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
                   max_len: int) -> tuple[dict, torch.Tensor]:
    """Encode the frames, compute every decoder layer's cross K/V (digital
    ``enc_out @ wk`` / ``wv``) into ``ck`` / ``cv``, run the prompt
    through the decoder (self-attention by ``attend_full``, no RoPE, w_o a
    plain matmul, as in the reference) and keep its K/V, zero-padded to
    ``max_len``; returns (a new cache with ``pos`` = S, last-token logits
    (B, V))."""
    b, s = tokens.shape
    enc_out = encode(params, frames, cfg)
    t = enc_out.shape[1]
    cache = new_cache(lambda dev: init_encdec_cache(cfg, b, max_len, t, dev), cfg, b,
                      tokens.device)
    kv = (cfg.n_kv_heads, cfg.head_dim)
    x = _embed_dec(params, tokens)
    positions = torch.arange(s, device=x.device)
    eps = cfg.norm_eps
    for li in range(cfg.dec_layers):
        lp = unit_params(params["dec"], li)
        ca = lp["cross_attn"]
        PX.write(cache["ck"][li], PX.unflatten(enc_out @ ca["wk"].to(enc_out.dtype), -1, kv))
        PX.write(cache["cv"][li], PX.unflatten(enc_out @ ca["wv"].to(enc_out.dtype), -1, kv))
        q, k, v = ATT.qkv(lp["self_attn"], rmsnorm(lp["ln1"], x, eps), cfg)
        o = ATT.attend_full(q, k, v, positions, positions, "global", cfg)
        emb = ("batch", "seq", "embed")
        x = x + PX.shard(o.reshape(b, s, -1) @ lp["self_attn"]["wo"].to(x.dtype), emb)
        x = x + ATT.cross_attention(ca, rmsnorm(lp["ln_x"], x, eps), enc_out, cfg)
        x = PX.shard(x + mlp_apply(lp["ffn"], rmsnorm(lp["ln2"], x, eps), cfg, None), emb)
        PX.write(cache["k"][li], k, dim=1)
        PX.write(cache["v"][li], v, dim=1)
    cache["pos"].fill_(s)
    logits = _tied_head(params, rmsnorm(params["dec_norm"], x[:, -1:, :], eps))
    return cache, logits[:, 0, :]


def encdec_decode_step(params: dict, cache: dict, token: torch.Tensor,
                       cfg: ModelConfig) -> tuple[dict, torch.Tensor]:
    """One decode step over the dense cache; returns (the same cache,
    logits (B, V)).  Each layer writes this step's K/V at ``pos`` in place
    and attends over its whole ``max_len`` window without RoPE
    (``attention.decode_self_attention``), then reads the fixed cross K/V
    in f32.  ``pos`` advances by one in its own storage after its last
    read.  The learned position is looked up at ``pos`` clamped to
    ``max_seq - 1``: an idle slot's ``pos`` keeps counting, and its rows
    are never read."""
    b = token.shape[0]
    pos = cache["pos"]
    x = PX.take_rows(params["embed"]["embedding"], token[:, None])
    x = x + params["dec_pos"][pos.long().clamp(max=cfg.max_seq - 1)][:, None, :]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    eps = cfg.norm_eps
    for li in range(cfg.dec_layers):
        lp = unit_params(params["dec"], li)
        x = x + ATT.decode_self_attention(lp["self_attn"], rmsnorm(lp["ln1"], x, eps),
                                          cache["k"][li], cache["v"][li], pos, cfg,
                                          use_rope=False)
        hx = rmsnorm(lp["ln_x"], x, eps)
        q = PX.unflatten(hx @ lp["cross_attn"]["wq"].to(hx.dtype), -1, (h, dh))
        qg = q.reshape(b, 1, hkv, h // hkv, dh).float() * (dh ** -0.5)
        sc = torch.einsum("bskgd,btkd->bkgst", qg, cache["ck"][li].float())
        w = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgst,btkd->bskgd", w, cache["cv"][li].float())
        emb = ("batch", "seq", "embed")
        # the (B, H·Dh) product a 3-D matmul folds to (a DTensor's would batch it)
        co = o.reshape(b, -1).to(x.dtype) @ lp["cross_attn"]["wo"].to(x.dtype)
        x = x + PX.shard(co[:, None], emb)
        x = PX.shard(x + mlp_apply(lp["ffn"], rmsnorm(lp["ln2"], x, eps), cfg, None), emb)
    logits = _tied_head(params, rmsnorm(params["dec_norm"], x, eps))
    pos.add_(1)
    return cache, logits[:, 0, :]
