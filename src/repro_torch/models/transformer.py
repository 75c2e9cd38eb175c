"""Decoder LM stack: init, paged decode step, chunked paged prefill
(``repro/models/transformer.py``, ``decoder_lm`` family).

Parameters keep the reference's tree: units stacked on a leading
``n_units`` axis (``params["units"]["l0"]["attn"]["wq"]`` is
``(n_units, d, H*Dh)``), so a bridged JAX tree and a native one are the
same structure.  The depth loop is a Python loop over units; each unit's
leaves are views into the stacked tensors.

The paged pool is updated in place: :func:`lm_decode_step` and
:func:`lm_prefill_chunk` write K/V rows into the pool tensors they are
given (see ``attention.py`` for why the writes never collide).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
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


def unit_params(units: dict, u: int) -> dict:
    """Unit ``u``'s parameter views out of the stacked tree."""
    return {
        k: unit_params(v, u) if isinstance(v, dict) else v[u]
        for k, v in units.items()
    }


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
    writes into it."""
    _check_family(cfg)
    if cfg.kv_cache_dtype != "same":
        raise NotImplementedError("int8 KV pools are not ported yet")
    dev = resolve_device(device)
    n_attn = len(cfg.layer_pattern)
    shape = (cfg.n_units, n_attn, n_pages, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "k_pages": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        "v_pages": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
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
) -> tuple[dict, torch.Tensor]:
    """One decode step over the paged pool; returns (cache, logits (B, V)).

    The pool leaves are written in place and the returned cache is the same
    dict with ``pos`` advanced by one."""
    pos = cache["pos"]
    x = embed(params["embed"], token[:, None], cfg)
    for u in range(cfg.n_units):
        up = unit_params(params["units"], u)
        for i, kind in enumerate(cfg.layer_pattern):
            sub = up[f"l{i}"]
            a = ATT.paged_decode_self_attention(
                sub["attn"], rmsnorm(sub["ln1"], x, cfg.norm_eps),
                cache["k_pages"][u, i], cache["v_pages"][u, i],
                table, pos, cfg, kind=kind,
            )
            x = _attn_block(sub, x, a, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_out(params["embed"], params.get("head"), x, cfg)
    cache["pos"] = pos + 1
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
) -> tuple[dict, dict, torch.Tensor]:
    """One chunk of a resumable paged prefill; returns (pool, state',
    last-token logits (1, V)).  Attention writes the chunk's K/V into the
    request's own pages and attends over the whole table row at absolute
    positions, so a suffix that starts mid-prompt sees exactly what a
    whole-prompt prefill would."""
    b, c = tokens.shape
    x = embed(params["embed"], tokens, cfg)
    for u in range(cfg.n_units):
        up = unit_params(params["units"], u)
        for i, kind in enumerate(cfg.layer_pattern):
            sub = up[f"l{i}"]
            o = ATT.paged_prefill_self_attention(
                sub["attn"], rmsnorm(sub["ln1"], x, cfg.norm_eps),
                pool["k_pages"][u, i], pool["v_pages"][u, i],
                table_row, q0, cfg, kind=kind,
            )
            x = _attn_block(sub, x, o, cfg)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    logits = logits_out(params["embed"], params.get("head"), x, cfg)
    new_state = dict(state)
    new_state["pos"] = torch.full((b,), q0 + c, dtype=torch.int32, device=tokens.device)
    return pool, new_state, logits[:, 0, :]
