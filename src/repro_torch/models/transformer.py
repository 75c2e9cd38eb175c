"""Decoder LM stack: init, the full-sequence forward and loss of the
training path, the paged decode step and chunked paged prefill
(``repro/models/transformer.py``, ``decoder_lm`` family).

Parameters keep the reference's tree: units stacked on a leading
``n_units`` axis (``params["units"]["l0"]["attn"]["wq"]`` is
``(n_units, d, H*Dh)``), so a bridged JAX tree and a native one are the
same structure.  The depth loop is a Python loop over units; each unit's
leaves are views into the stacked tensors.

The paged pool is updated in place: :func:`lm_decode_step` and
:func:`lm_prefill_chunk` write K/V rows into the pool tensors they are
given (see ``attention.py`` for why the writes never collide).

With ``cfg.kv_cache_dtype == "int8"`` the pools hold stochastically
rounded int8 codes plus f32 scale planes.  Every write's rounding seed is
computed on the device from a device counter or from device seeds, so a
step never waits on the host for it: decode seeds from ``quant_step``
(+1 per decode step, never reset), prefill seeds from the engine's
content-derived per-block seeds, each folded with the unit and sublayer
index exactly as the reference folds them (wrapping uint32 arithmetic,
held in int64).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import random as R
from repro_torch.device import resolve_device
from repro_torch.kernels.prng import MASK, mul32
from . import attention as ATT
from .config import ModelConfig
from .layers import (
    dtype_of,
    embed,
    init_embedding,
    init_lm_head,
    init_mlp,
    init_rmsnorm,
    logits_out,
    mlp_apply,
    rmsnorm,
)

# shared-pool cache leaves (block-table addressed); everything else in a
# paged cache is dense per-slot state
PAGE_POOL_LEAVES = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "decoder_lm" or any(
        k not in ("global", "local") for k in cfg.layer_pattern
    ):
        raise NotImplementedError(
            f"only attention-only decoder_lm models are ported, got "
            f"{cfg.family} {cfg.layer_pattern}"
        )
    if cfg.n_experts or cfg.post_norms:
        raise NotImplementedError("MoE and post-norm blocks are not ported yet")


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Seeded random parameters on ``device`` (the card unless ``"cpu"``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype_of(cfg)
    lead = (cfg.n_units,)
    params: dict = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt),
        "final_norm": init_rmsnorm(cfg.d_model, (), dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_lm_head(gen, cfg.d_model, cfg.vocab, dt)
    params["units"] = {
        f"l{i}": {
            "ln1": init_rmsnorm(cfg.d_model, lead, dev),
            "attn": ATT.init_attn(gen, cfg, lead),
            "ln2": init_rmsnorm(cfg.d_model, lead, dev),
            "ffn": init_mlp(gen, cfg, lead),
        }
        for i in range(len(cfg.layer_pattern))
    }
    return params


def _unbind_units(units: dict) -> list[dict]:
    """Every unit's parameter views, from one ``unbind`` per stacked leaf:
    its backward stacks the units' gradients once, where per-unit indexing
    would add a zero-filled full-size gradient per unit."""
    if not isinstance(units, dict):
        return units.unbind(0)
    parts = {k: _unbind_units(v) for k, v in units.items()}
    n = len(next(iter(parts.values())))
    return [{k: p[u] for k, p in parts.items()} for u in range(n)]


def unit_params(units: dict, u: int) -> dict:
    """Unit ``u``'s parameter views out of the stacked tree."""
    return {
        k: unit_params(v, u) if isinstance(v, dict) else v[u]
        for k, v in units.items()
    }


# ---------------------------------------------------------------------------
# Forward (full sequence) and loss: the training path.
# ---------------------------------------------------------------------------


def _unit_fwd(x: torch.Tensor, up: dict, positions: torch.Tensor, cfg: ModelConfig, key):
    """One unit of ``cfg.layer_pattern``; sublayer ``i`` draws under
    ``fold_in(key, i)``, its attention under ``fold_in(·, 0)`` and its MLP
    under ``fold_in(·, 1)``, as the reference folds them."""
    for i, kind in enumerate(cfg.layer_pattern):
        sub = up[f"l{i}"]
        ki = None if key is None else R.fold_in(key, i)
        a = ATT.self_attention(
            sub["attn"], rmsnorm(sub["ln1"], x, cfg.norm_eps), positions, cfg,
            kind=kind, key=None if ki is None else R.fold_in(ki, 0),
        )
        x = x + a
        h = rmsnorm(sub["ln2"], x, cfg.norm_eps)
        x = x + mlp_apply(sub["ffn"], h, cfg, key=None if ki is None else R.fold_in(ki, 1))
    return x


def backbone(params: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, key=None):
    """All units, unit ``u`` under ``fold_in(key, u)``; returns (final-norm
    hidden states, aux loss 0).  ``cfg.remat_policy`` is not honoured: every
    unit's activations stay live for the backward (stablelm-3b at full
    width and batch 8 × 128 fits the card so), so the crossbar kernel runs
    once per projection and step, where the reference's rematerialized
    backward runs it again.  It changes no number."""
    for u, up in enumerate(_unbind_units(params["units"])):
        ku = None if key is None else R.fold_in(key, u)
        x = _unit_fwd(x, up, positions, cfg, ku)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def lm_forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, key=None):
    """(logits (B, S, V), aux) for tokens (B, S)."""
    _check_family(cfg)
    x = embed(params["embed"], tokens, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x, aux = backbone(params, x, positions, cfg, key)
    return logits_out(params["embed"], params.get("head"), x, cfg), aux


def cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask=None, z_loss: float = 1e-4
) -> tuple[torch.Tensor, dict]:
    """Mean token cross-entropy plus ``z_loss·lse²``, in f32."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(lf - m).sum(dim=-1))
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    per_tok = (lse - ll) + z_loss * lse.square()
    if mask is not None:
        w = mask.float()
        loss = (per_tok * w).sum() / torch.clamp_min(w.sum(), 1.0)
    else:
        loss = per_tok.mean()
    return loss, {"nll": loss, "lse_mean": lse.mean()}


def lm_loss(params: dict, batch: dict, cfg: ModelConfig, key=None) -> tuple[torch.Tensor, dict]:
    """(loss, metrics) for a batch {"tokens", "labels", optional "mask"};
    analog projections draw under ``key`` (digital when ``None``)."""
    logits, aux = lm_forward(params, batch["tokens"], cfg, key)
    loss, metrics = cross_entropy(logits, batch["labels"], batch.get("mask"))
    total = loss + aux
    metrics["aux"] = aux
    metrics["loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# Paged cache.
# ---------------------------------------------------------------------------


def init_paged_decode_cache(
    cfg: ModelConfig, batch: int, n_pages: int, block_size: int, device=None
) -> dict:
    """Shared pool of KV blocks, ``(nu, n_attn, P, bs, Hkv, Dh)`` per K/V,
    plus the per-slot ``pos``.  Which pages a slot owns is the engine's
    host-side block table; a page may back several slots' tables at once
    (prefix sharing), and the engine forks a shared page before any slot
    writes into it.

    int8 pools (``cfg.kv_cache_dtype == "int8"``) hold int8 codes, the
    ``(nu, n_attn, P, bs, Hkv)`` f32 scale planes ``k_scale_pages`` /
    ``v_scale_pages``, and ``quant_step``, the device decode-step counter
    that seeds the decode writes' rounding."""
    _check_family(cfg)
    if cfg.kv_cache_dtype not in ("same", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'same' or 'int8', got {cfg.kv_cache_dtype!r}")
    dev = resolve_device(device)
    n_attn = len(cfg.layer_pattern)
    shape = (cfg.n_units, n_attn, n_pages, block_size, cfg.n_kv_heads, cfg.head_dim)
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.kv_cache_dtype == "int8":
        cache["k_pages"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["v_pages"] = torch.zeros(shape, dtype=torch.int8, device=dev)
        cache["k_scale_pages"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        cache["v_scale_pages"] = torch.ones(shape[:-1], dtype=torch.float32, device=dev)
        cache["quant_step"] = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        cache["k_pages"] = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
        cache["v_pages"] = torch.zeros(shape, dtype=dtype_of(cfg), device=dev)
    return cache


def _layer_seeds(base: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``(base + u·40503 + i·1299721) mod 2**32`` for every unit ``u`` and
    sublayer ``i``: (nu, n_layers, *base.shape) int64, built on base's
    device in a few launches (the reference folds one layer at a time)."""
    dev = base.device
    off = (
        torch.arange(cfg.n_units, device=dev, dtype=torch.int64)[:, None] * 40503
        + torch.arange(len(cfg.layer_pattern), device=dev, dtype=torch.int64)[None] * 1299721
    )
    return (base.reshape((1, 1) + tuple(base.shape)) + off.reshape(off.shape + (1,) * base.dim())) & MASK


def _int8_kw(pool: dict, u: int, i: int, seeds: torch.Tensor, name: str) -> dict:
    """This layer's scale-plane views and rounding seed(s) for an int8 pool."""
    return {
        "k_scale_pages": pool["k_scale_pages"][u, i],
        "v_scale_pages": pool["v_scale_pages"][u, i],
        name: seeds[u, i],
    }


def _attn_block(sub: dict, x: torch.Tensor, a: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Residual add of the attention output, then the norm + MLP tail."""
    x = x + a
    return x + mlp_apply(sub["ffn"], rmsnorm(sub["ln2"], x, cfg.norm_eps), cfg)


def lm_decode_step(
    params: dict,
    cache: dict,
    token: torch.Tensor,   # (B,) int last emitted token
    cfg: ModelConfig,
    table: torch.Tensor,   # (B, W) int32 block table
    kv_write: bool = True,
    split_batch: Optional[int] = None,
) -> tuple[dict, torch.Tensor]:
    """One decode step over the paged pool; returns (cache, logits (B, V)).

    Everything is updated in place: the pool leaves are written, and
    ``pos`` (and an int8 pool's ``quant_step``) advance by one in their own
    storage after their last read, so a captured step (``specs.DecodeGraphs``)
    reads the values the engine writes there between steps.  The returned
    cache is the same dict.  An int8 write of unit ``u``, sublayer ``i`` rounds under
    ``quant_step·2654435761 + u·40503 + i·1299721 mod 2**32``.

    ``kv_write=False`` is the speculative verify's step: the same math over
    the pool as the draft left it, which stays untouched, and no
    ``quant_step`` tick; ``pos`` still advances, so the caller passes a
    cache view with a ``pos`` of its own.  ``split_batch`` is handed to
    decode attention (``attention.paged_decode_self_attention``)."""
    pos = cache["pos"]
    int8_pool = "k_scale_pages" in cache
    if int8_pool and kv_write:
        qstep = cache["quant_step"]
        seeds = _layer_seeds(mul32(qstep.long() & MASK, 2654435761), cfg)
    x = embed(params["embed"], token[:, None], cfg)
    for u in range(cfg.n_units):
        up = unit_params(params["units"], u)
        for i, kind in enumerate(cfg.layer_pattern):
            sub = up[f"l{i}"]
            kw = {}
            if int8_pool and kv_write:
                kw = _int8_kw(cache, u, i, seeds, "quant_seed")
            elif int8_pool:
                kw = {n: cache[n][u, i] for n in ("k_scale_pages", "v_scale_pages")}
            a = ATT.paged_decode_self_attention(
                sub["attn"], rmsnorm(sub["ln1"], x, cfg.norm_eps),
                cache["k_pages"][u, i], cache["v_pages"][u, i],
                table, pos, cfg, kind=kind, write=kv_write, split_batch=split_batch, **kw,
            )
            x = _attn_block(sub, x, a, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_out(params["embed"], params.get("head"), x, cfg)
    pos.add_(1)
    if int8_pool and kv_write:
        qstep.add_(1)
    return cache, logits[:, 0, :]


def init_prefill_state(cfg: ModelConfig, device=None) -> dict:
    """Zeroed B=1 per-slot state entering a chunked prefill (``pos`` only:
    the ported family carries no recurrent state)."""
    return {"pos": torch.zeros((1,), dtype=torch.int32, device=resolve_device(device))}


def lm_prefill_chunk(
    params: dict,
    tokens: torch.Tensor,     # (1, c) one request's suffix chunk
    cfg: ModelConfig,
    pool: dict,               # page-pool leaves k_pages / v_pages (in place)
    state: dict,              # B=1 per-slot leaves incl. "pos"
    table_row: torch.Tensor,  # (Wp,) int32 blocks covering the prompt bucket
    q0: int,                  # absolute position of the chunk start
    quant_seeds: torch.Tensor | None = None,  # (nbc,) int64, int8 pools only
) -> tuple[dict, dict, torch.Tensor]:
    """One chunk of a resumable paged prefill; returns (pool, state',
    last-token logits (1, V)).  Attention writes the chunk's K/V into the
    request's own pages and attends over the whole table row at absolute
    positions, so a suffix that starts mid-prompt sees exactly what a
    whole-prompt prefill would.  int8 pools round the chunk's i-th block
    under ``quant_seeds[i] + u·40503 + i_layer·1299721 mod 2**32`` (the
    engine's content-derived block seeds, on the device)."""
    b, c = tokens.shape
    int8_pool = "k_scale_pages" in pool
    if int8_pool:
        if quant_seeds is None:
            raise ValueError("an int8 pool's prefill needs quant_seeds")
        seeds = _layer_seeds(quant_seeds.to(torch.int64), cfg)
    x = embed(params["embed"], tokens, cfg)
    for u in range(cfg.n_units):
        up = unit_params(params["units"], u)
        for i, kind in enumerate(cfg.layer_pattern):
            sub = up[f"l{i}"]
            kw = _int8_kw(pool, u, i, seeds, "quant_seeds") if int8_pool else {}
            o = ATT.paged_prefill_self_attention(
                sub["attn"], rmsnorm(sub["ln1"], x, cfg.norm_eps),
                pool["k_pages"][u, i], pool["v_pages"][u, i],
                table_row, q0, cfg, kind=kind, **kw,
            )
            x = _attn_block(sub, x, o, cfg)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    logits = logits_out(params["embed"], params.get("head"), x, cfg)
    new_state = dict(state)
    new_state["pos"] = torch.full((b,), q0 + c, dtype=torch.int32, device=tokens.device)
    return pool, new_state, logits[:, 0, :]
