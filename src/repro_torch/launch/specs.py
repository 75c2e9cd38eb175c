"""The paged serving entry points the engine drives (``repro/launch/specs.py``).

Each ``make_*`` returns a plain function on tensors.  The reference jits
and donates; here the functions run eagerly and update the pool in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import wta as W
from repro_torch.kernels import ops as KOPS
from repro_torch.models import ModelConfig
from repro_torch.models import transformer as TF

PAGE_POOL_LEAVES = TF.PAGE_POOL_LEAVES

# Per-slot logit-sanity codes emitted by the paged serve step (the third
# output).  0 is healthy; nonzero codes map to typed eviction reasons.
SANE_OK = 0
SANE_NAN = 1
SANE_SATURATED = 2
SANE_ENTROPY_COLLAPSE = 3
SANITY_REASONS = {
    SANE_NAN: "nan",
    SANE_SATURATED: "saturated",
    SANE_ENTROPY_COLLAPSE: "entropy_collapse",
}


def cache_batch_axis(leaf_name: str) -> int:
    """Slot axis of a per-slot cache leaf (``pos`` is (B,))."""
    if leaf_name == "pos":
        return 0
    raise KeyError(f"no per-slot leaf {leaf_name!r} in a decoder_lm cache")


def make_paged_suffix_prefill(cfg: ModelConfig):
    """One suffix chunk of a resumable, chunked paged prefill:
    (params, cache, state{B=1}, tokens (1, c), table_row (Wp,) int32, q0
    [, quant_seeds (nbc,) int64]) → (cache, state', last-token logits
    (1, V)).  Only the page-pool leaves of ``cache`` are touched; the
    per-slot leaves ride along, so a prefill in flight never disturbs the
    batched decode of the other slots (the engine writes ``state`` at the
    slot once, on completion).  int8 pools need ``quant_seeds``: one
    content-derived uint32 seed per block the chunk covers, on the device."""

    def suffix_chunk(params, cache: dict, state: dict, tokens, table_row, q0: int,
                     quant_seeds=None):
        pool = {n: cache[n] for n in PAGE_POOL_LEAVES if n in cache}
        _, new_state, logits = TF.lm_prefill_chunk(
            params, tokens, cfg, pool, state, table_row, q0, quant_seeds
        )
        return cache, new_state, logits

    return suffix_chunk


def make_paged_state_insert(cfg: ModelConfig):
    """(cache, state_leaves{B=1}, slot) → cache: write a prefilled request's
    per-slot leaves at ``slot`` (the pool is untouched)."""

    def insert(cache: dict, state_leaves: dict, slot: int) -> dict:
        for name, upd in state_leaves.items():
            leaf = cache[name]
            leaf.narrow(cache_batch_axis(name), slot, 1).copy_(upd.to(leaf.dtype))
        return cache

    return insert


def make_page_copy(cfg: ModelConfig):
    """(cache, src, dst) → cache: copy one pool page onto another across
    every page-pool leaf, an int8 pool's scale planes included (the device
    half of a copy-on-write fork)."""

    def copy(cache: dict, src: int, dst: int) -> dict:
        for name in PAGE_POOL_LEAVES:
            if name in cache:
                leaf = cache[name]  # (nu, n_attn, P, bs, ...)
                leaf[:, :, dst] = leaf[:, :, src]
        return cache

    return copy


def sample_tokens(
    cfg: ModelConfig,
    logits: torch.Tensor,
    key=None,
    steps: Optional[torch.Tensor] = None,
    n_redundant: int = 1,
) -> torch.Tensor:
    """Next-token selection shared by prefill and decode steps: (B, V) →
    (B,) int32 (``repro/launch/specs.py:559-629``).

    With ``key=None`` (or ``wta_head`` off) this is the digital argmax.
    With ``cfg.wta_head`` the token is the WTA vote over
    ``cfg.analog.wta_trials`` trials (``core.wta.wta_trials``):

    * a 1-D key (a key pair, or a (2,) tensor) — one trial tensor for the
      whole batch, ``normal(key, (T, B, V))``;
    * a 2-D key (B, 2) int64 tensor — per-slot keys, each request voting
      with its own noise stream, so its tokens depend on (its key, its
      step, its logits) only; ``steps`` (B,), when given, is folded into
      each slot's key so every step draws fresh noise.

    ``n_redundant = R > 1`` races the whole trial bank R times: read 0 on
    the plain key, read r on ``fold_in(key, r)`` (then the step); the token
    is the majority over the R reads, ties to the lowest token id.

    The reference asks its device backend for the comparator's operating
    point (``wta_readout_params``); the port has no backend seam, so it
    uses the healthy identity ``(cfg.analog.vth0, wta_sigma_z(beta))``.
    The trials run in one kernel launch per read on the card
    (``ops.wta_trial_counts``), keys folded on the device."""
    if not (cfg.wta_head and key is not None):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    b, v = logits.shape
    dev = logits.device
    keys = torch.as_tensor(key, dtype=torch.int64, device=dev)
    per_slot = keys.dim() == 2
    if not per_slot:
        keys = keys.reshape(1, 2).expand(b, 2)
    layout = (v, 0) if per_slot else (b * v, v)
    vth0, sigma_z = cfg.analog.vth0, W.wta_sigma_z(cfg.analog.beta)

    def sample_once(read: int) -> torch.Tensor:
        words = []
        if read:
            words.append(torch.full((b,), read, dtype=torch.int64, device=dev))
        if per_slot and steps is not None:
            words.append(steps.to(device=dev, dtype=torch.int64))
        folds = torch.stack(words, dim=1) if words else None
        counts, _ = KOPS.wta_trial_counts(
            logits, keys, folds, cfg.analog.wta_trials, vth0, sigma_z, layout
        )
        return torch.argmax(counts, dim=-1)

    reads = max(int(n_redundant), 1)
    if reads == 1:
        return sample_once(0).to(torch.int32)
    votes = torch.stack([sample_once(r) for r in range(reads)], dim=1)   # (B, R)
    tally = torch.zeros((b, v), dtype=torch.int32, device=dev)
    tally.scatter_add_(1, votes, torch.ones_like(votes, dtype=torch.int32))
    return torch.argmax(tally, dim=-1).to(torch.int32)


def make_paged_serve_step(
    cfg: ModelConfig, *, sat_threshold: float = 1e6, entropy_floor: float = 0.0,
    n_redundant: int = 1,
):
    """One decode step over a paged cache:
    (params, cache, table (B, W), token (B,)[, key, steps]) → (cache,
    token, sane).  ``key`` / ``steps`` follow :func:`sample_tokens`, with
    ``n_redundant`` reads.

    ``sane`` is a (B,) int32 logit-sanity code per slot: ``SANE_NAN`` for
    a non-finite row, ``SANE_SATURATED`` for max|logit| above
    ``sat_threshold``, ``SANE_ENTROPY_COLLAPSE`` for softmax entropy below
    ``entropy_floor`` (checked only when the floor is positive)."""

    def serve_step(params, cache, table, token, key=None, steps=None):
        cache, logits = TF.lm_decode_step(params, cache, token, cfg, table)
        zf = logits.float()
        finite = torch.isfinite(zf).all(dim=-1)
        sat = zf.abs().amax(dim=-1) > sat_threshold
        sane = torch.where(
            finite,
            torch.where(sat, SANE_SATURATED, SANE_OK),
            SANE_NAN,
        ).to(torch.int32)
        if entropy_floor > 0.0:
            p = torch.softmax(zf, dim=-1)
            ent = -(p * torch.log(p.clamp(1e-30, 1.0))).sum(dim=-1)
            collapsed = finite & ~sat & (ent < entropy_floor)
            sane = torch.where(collapsed, SANE_ENTROPY_COLLAPSE, sane).to(torch.int32)
        tok = sample_tokens(cfg, logits, key, steps, n_redundant=n_redundant)
        return cache, tok, sane

    return serve_step
