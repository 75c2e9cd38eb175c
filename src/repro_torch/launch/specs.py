"""The serving entry points the engine drives (``repro/launch/specs.py``):
the paged layout's, and the dense layout's (:func:`init_decode_cache`,
:func:`make_cache_insert`, :func:`make_serve_step`, compiled as
:class:`DenseGraphs`), which serve the encoder-decoder too: its cache
(:func:`init_decode_cache` at ``cfg.enc_seq`` frames) holds cross K/V
beside the self-attention K/V, slot axis 1 (:func:`cache_batch_axis`),
and its step is ``encdec.encdec_decode_step``.  The paged entry points
refuse it, as the reference's do.

Each ``make_*`` returns a plain function on tensors that updates the pool
in place, where the reference jits and donates.  The decode step is the
one that is compiled: :class:`DecodeGraphs` captures it as a CUDA graph
per (window width, redundant reads) on the card and replays it, the
counterpart of the reference's jitted step cached per window bucket; on
the CPU it runs eagerly on the same static buffers.  The other entry
points run eagerly; :class:`EagerEntry` records the argument signatures
they are called with, which is what a ``jax.jit`` compile is keyed on.
Preemption's three (:func:`make_page_spill`, :func:`make_page_restore`,
:func:`make_slot_state_gather`) take page ids at the fixed table width,
padded with the trash page, so each keeps one signature; the restore
writes into the pool's own tensors, whose addresses the graphs hold.
Self-speculation: :func:`make_paged_spec_round` fuses k chained draft
steps and one read-only verify of the drafted run, compiled as
:class:`SpecGraphs` (one CUDA graph per (window width, k)), and
:func:`make_spec_rollback` rewinds one slot's ``pos`` in place.  The
dense step attends over every slot's whole ``max_len`` window, so its
graphs are keyed by batch width alone.

The dry run's inputs (``repro/launch/specs.py:34-124, 702-707, 883-922``):
:func:`input_specs` and the ``*_specs`` helpers build every input leaf of
a cell's step on the ``meta`` device, the counterpart of the reference's
``jax.eval_shape``: shapes and dtypes, no allocation and no draw.

Sharded serving (:func:`make_sharded_paged_entry_points`,
``repro/launch/specs.py:376-560``): the same entry points over a
``(data, model)`` DTensor mesh, one process per rank.  The cache leaves
and parameters are DTensors placed by :func:`paged_cache_shardings` and
replicated; each entry point unwraps them with ``to_local()`` (the same
storage, no copy) and runs the port's kernels on the local shards, with
explicit ``torch.distributed`` collectives on the mesh's per-axis groups
around them (``parallel.PoolShards``): DTensor has no sharding rule for
the hand-written kernels, and none is registered.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import parallel as PX
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.core import wta as W
from repro_torch.kernels import backend as BK
from repro_torch.kernels import ops as KOPS
from repro_torch.models import ModelConfig, get_model_fns
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.layers import dtype_of

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


# the dense layout's per-slot K/V leaves, (nu, n_attn, B, max_len, ...)
DENSE_LEAVES = ("k", "v", "k_scale", "v_scale")
# a hybrid or ssm model's state, dense per slot in either layout: (nu,
# n_rec, B, 3, W) and (nu, n_rec, B, W); (nu, n_ssm, B, K-1, C) and (nu,
# n_ssm, B, H, P, N)
STATE_LEAVES = ("rec_conv", "rec_h", "ssm_conv", "ssm_state")


# the encoder-decoder's dense cache: (L, B, max_len or enc_len, Hkv, Dh)
ENCDEC_LEAVES = ("k", "v", "ck", "cv")


def cache_batch_axis(cfg: ModelConfig, leaf_name: str) -> int:
    """Slot axis of a per-slot cache leaf: ``pos`` is (B,); a token LM's
    dense K/V leaves are (nu, n_attn, B, ...) and its state leaves (nu,
    n_rec or n_ssm, B, ...); an encoder-decoder's leaves are (L, B, ...)."""
    if leaf_name == "pos":
        return 0
    if cfg.family == "encdec":
        if leaf_name in ENCDEC_LEAVES:
            return 1
        raise KeyError(f"no per-slot leaf {leaf_name!r} in an encdec cache")
    if leaf_name in DENSE_LEAVES or leaf_name in STATE_LEAVES:
        return 2
    raise KeyError(f"no per-slot leaf {leaf_name!r} in a decoder_lm, vlm, hybrid or ssm cache")


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """The dense layout's cache for a live batch: a token LM's
    (``TF.init_decode_cache``), or an encoder-decoder's with cross K/V
    of ``cfg.enc_seq`` frames (``encdec.init_encdec_cache``)."""
    if cfg.family == "encdec":
        return ED.init_encdec_cache(cfg, batch, max_len, cfg.enc_seq, device)
    if cfg.family == "fcnn":
        raise ValueError("an fcnn model has no decode cache")
    return TF.init_decode_cache(cfg, batch, max_len, device)


def init_paged_decode_cache(cfg: ModelConfig, batch: int, n_pages: int, block_size: int,
                            device=None) -> dict:
    """The paged pool and per-slot leaves (``TF.init_paged_decode_cache``);
    a token LM's alone."""
    if cfg.family == "encdec":
        raise ValueError("paged KV cache is token-LM only (no encdec)")
    return TF.init_paged_decode_cache(cfg, batch, n_pages, block_size, device)


def make_cache_insert(cfg: ModelConfig):
    """(batch_cache, one_cache (B=1), slot) → batch_cache: copy one
    request's prefilled dense cache into ``slot`` along each leaf's slot
    axis, in place in the batch cache's own tensors (a captured decode
    step holds their addresses).  ``slot`` is a Python int: every slot
    shares one signature."""

    def insert(batch_cache: dict, one_cache: dict, slot: int) -> dict:
        for name, leaf in batch_cache.items():
            leaf.narrow(cache_batch_axis(cfg, name), slot, 1).copy_(
                one_cache[name].to(leaf.dtype))
        return batch_cache

    return insert


def make_serve_step(cfg: ModelConfig):
    """One dense decode step: (params, cache, token (B,)[, key, steps]) →
    (cache, token (B,) int32), the cache written and ``pos`` advanced in
    place.  With ``cfg.wta_head`` the token is :func:`sample_tokens`' WTA
    vote: ``key`` one key pair for the whole batch, or (B, 2) per-slot
    keys with ``steps`` (B,) folded in.  The step is the family's
    (``models.get_model_fns``): a token LM's or an encoder-decoder's."""
    decode_step = get_model_fns(cfg).decode_step
    if decode_step is None:
        raise ValueError(f"family {cfg.family!r} cannot decode")

    def serve_step(params, cache, token, key=None, steps=None):
        cache, logits = decode_step(params, cache, token, cfg)
        return cache, sample_tokens(cfg, logits, key, steps)

    return serve_step


# ---------------------------------------------------------------------------
# The dry run's input specs: every leaf on the meta device.
# ---------------------------------------------------------------------------

META = torch.device("meta")
WHISPER_DEC_PROMPT = 448  # decoder prompt length for encdec prefill cells


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """A train cell's batch: int32 ``tokens`` and ``labels`` (B, S), a
    ``vlm`` model's ``patches`` (B, n_patches, D) and an ``encdec`` one's
    ``frames`` (B, S, D) in the model's dtype."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _spec((b, s), torch.int32), "labels": _spec((b, s), torch.int32)}
    if cfg.family == "vlm":
        out["patches"] = _spec((b, cfg.n_patches, cfg.d_model), dtype_of(cfg))
    if cfg.family == "encdec":
        out["frames"] = _spec((b, s, cfg.d_model), dtype_of(cfg))
    return out


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """A prefill cell's batch: ``tokens`` (B, S) (and a ``vlm`` model's
    ``patches``); an ``encdec`` one encodes S frames and runs a decoder
    prompt of :data:`WHISPER_DEC_PROMPT` tokens (a smoke config with
    fewer decoder positions, ``max_seq``, runs that many)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        prompt = min(WHISPER_DEC_PROMPT, cfg.max_seq)
        return {"frames": _spec((b, s, cfg.d_model), dtype_of(cfg)),
                "tokens": _spec((b, prompt), torch.int32)}
    out = {"tokens": _spec((b, s), torch.int32)}
    if cfg.family == "vlm":
        out["patches"] = _spec((b, cfg.n_patches, cfg.d_model), dtype_of(cfg))
    return out


def decode_cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """A decode cell's dense cache: B slots of ``seq_len`` positions
    (:func:`init_decode_cache`)."""
    return init_decode_cache(cfg, shape.global_batch, shape.seq_len, META)


def paged_decode_cache_specs(cfg: ModelConfig, batch: int, n_pages: int,
                             block_size: int) -> dict:
    return init_paged_decode_cache(cfg, batch, n_pages, block_size, META)


def params_specs(cfg: ModelConfig) -> dict:
    """The parameter tree, shapes and dtypes only (the init's meta path)."""
    return get_model_fns(cfg).init(0, cfg, META)


def train_state_specs(cfg: ModelConfig, tcfg):
    """The ``TrainState``: parameters, AdamW moments and, with
    ``compress_grads``, the error feedback, on meta."""
    from repro_torch.train import init_train_state

    return init_train_state(0, cfg, tcfg, device=META)


def make_prefill_step(cfg: ModelConfig, shape: ShapeSpec):
    """(params, batch) → (cache, last logits): the family's dense prefill
    into a cache of ``seq_len`` positions (plus a ``vlm`` model's
    patches)."""
    fns = get_model_fns(cfg)
    max_len = shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)

    def prefill_step(params, batch):
        return fns.prefill(params, batch, cfg, max_len)

    return prefill_step


def cell_inputs(cfg: ModelConfig, shape: ShapeSpec, tcfg) -> dict:
    """A cell's step inputs on meta: train ``state``, ``batch``; prefill
    ``params``, ``batch``; decode ``params``, ``cache``, ``token``."""
    if shape.kind == "train":
        return {"state": train_state_specs(cfg, tcfg), "batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params_specs(cfg), "batch": prefill_batch_specs(cfg, shape)}
    return {"params": params_specs(cfg), "cache": decode_cache_specs(cfg, shape),
            "token": _spec((shape.global_batch,), torch.int32)}


def input_specs(arch: str, shape_name: str, tcfg=None) -> dict:
    """The dry run's entry: an (arch, shape) cell's step kind, config,
    shape, train config and :func:`cell_inputs`."""
    from repro_torch.train import TrainConfig

    cfg, shape, tcfg = get_config(arch), SHAPES[shape_name], tcfg or TrainConfig()
    return dict(cell_inputs(cfg, shape, tcfg), kind=shape.kind, cfg=cfg, shape=shape, tcfg=tcfg)


def _spec_state_leaves(cache: dict) -> dict:
    """The per-slot leaves a speculative round snapshots and rolls back:
    all but the shared page pool and an int8 pool's engine-wide
    ``quant_step`` (rewinding it would replay rounding draws): ``pos``
    and a hybrid or ssm model's state leaves."""
    return {n: v for n, v in cache.items() if n not in PAGE_POOL_LEAVES and n != "quant_step"}


def _check_token_lm(cfg: ModelConfig) -> None:
    if cfg.family in ("encdec", "fcnn"):
        raise ValueError(f"paged serving is token-LM only (no {cfg.family})")


def make_paged_spec_round(cfg: ModelConfig, k: int):
    """One fused draft-k → verify-k speculative round over a paged cache
    (``repro/launch/specs.py:199-291``):

    (params, cache, table (B, W), token (B,)[, keys (B, 2), steps (B,)]) →
    (dtoks (B, k), doks (B, k), vtoks (B, k), voks (B, k), vstates
    {state leaf: (k, ...)}: ``pos`` (k, B), and a hybrid or ssm model's
    state leaves).

    Draft: k chained :func:`TF.lm_decode_step` + :func:`sample_tokens`
    calls, each with the slot's own ``(key, steps + j)``, so the drafts are
    k plain engine ticks; their K/V lands in the slots' pages, and ``pos``,
    the recurrent state and an int8 pool's ``quant_step`` advance in
    place, one a step.  ``vstates[leaf][j]`` is the leaf after consuming
    input j.

    Verify: ONE read-only decode step of k·B rows (``kv_write=False``):
    row (j, s) consumes input j of ``[token, dtoks[:-1]]`` for slot s at
    position ``pre-draft pos + j`` from the state the draft held there
    (state tensors of its own: the cache's are never handed over), the
    table tiled k times, resampled
    with the same ``(key, steps + j)``.  Its decode attention launches
    with the cluster split the draft's B chose (``split_batch``), so a
    verify row attends exactly as its draft row did.  In a fault-free
    round whose rows are batch-invariant ``vtoks == dtoks`` and every
    draft accepts; where they differ, the first mismatch is both the
    rejection point and the corrected token.  ``doks`` / ``voks`` are the
    per-step finite-logits flags (the NaN guard at draft depth).

    The pre-draft state is snapshot inside the round, so a captured
    round reads nothing from the host."""
    _check_token_lm(cfg)
    if k < 1:
        raise ValueError(f"speculate_k must be >= 1, got {k}")

    def finite(logits: torch.Tensor) -> torch.Tensor:
        return torch.isfinite(logits.float()).all(dim=-1)

    def spec_round(params, cache, table, token, keys=None, steps=None):
        b = token.shape[0]
        states = [{n: v.clone() for n, v in _spec_state_leaves(cache).items()}]
        dtoks, doks = [], []
        tok = token
        for j in range(k):
            cache, logits = TF.lm_decode_step(params, cache, tok, cfg, table)
            tok = sample_tokens(cfg, logits, keys, None if steps is None else steps + j)
            dtoks.append(tok)
            doks.append(finite(logits))
            states.append({n: v.clone() for n, v in _spec_state_leaves(cache).items()})
        dtoks = torch.stack(dtoks)                                   # (k, B)
        # row (j, s) of the verify holds slot s's state before input j
        view = {n: v for n, v in cache.items() if n not in states[0] and n != "quant_step"}
        for n in states[0]:
            view[n] = torch.cat([st[n] for st in states[:-1]], dim=cache_batch_axis(cfg, n))
        inputs = torch.cat([token[None], dtoks[:-1]]).reshape(-1)
        _, logits = TF.lm_decode_step(params, view, inputs, cfg, table.repeat(k, 1),
                                      kv_write=False, split_batch=b)
        xkeys = xsteps = None
        if keys is not None:
            xkeys = keys.repeat(k, 1)
        if steps is not None:
            xsteps = steps.repeat(k) + torch.arange(
                k, dtype=steps.dtype, device=steps.device).repeat_interleave(b)
        vtoks = sample_tokens(cfg, logits, xkeys, xsteps).reshape(k, b)
        voks = finite(logits).reshape(k, b)
        vstates = {n: torch.stack([st[n] for st in states[1:]]) for n in states[0]}
        return dtoks.T, torch.stack(doks).T, vtoks.T, voks.T, vstates

    return spec_round


def make_spec_rollback(cfg: ModelConfig):
    """(cache, vstates {leaf: (k, ...)}, idx, slot) → cache: roll one slot
    back to the state after consuming a round's input ``idx``
    (``vstates[leaf][idx]``, the draft's own state there, which is the
    plain engine's: ``pos`` and any recurrent state in one go), in place
    in the cache's own tensors, whose addresses the graphs hold.  Drafted
    K/V past the new ``pos`` stays in the pages as dead rows: masked, and
    overwritten when decode reaches them again.  ``idx`` and ``slot`` are
    Python ints, so every pair shares one signature."""
    _check_token_lm(cfg)

    def rollback(cache: dict, vstates: dict, idx: int, slot: int) -> dict:
        for name, st in vstates.items():
            ax = cache_batch_axis(cfg, name)
            cache[name].narrow(ax, slot, 1).copy_(st[idx].narrow(ax, slot, 1))
        return cache

    return rollback


def make_paged_suffix_prefill(cfg: ModelConfig):
    """One suffix chunk of a resumable, chunked paged prefill:
    (params, cache, state{B=1}, tokens (1, c), table_row (Wp,) int32, q0
    [, quant_seeds (nbc,) int64]) → (cache, state', last-token logits
    (1, V)).  Only the page-pool leaves of ``cache`` are touched; the
    per-slot leaves ride along, so a prefill in flight never disturbs the
    batched decode of the other slots (the engine writes ``state`` at the
    slot once, on completion).  int8 pools need ``quant_seeds``: one
    content-derived uint32 seed per block the chunk covers, on the device."""
    _check_token_lm(cfg)

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
    _check_token_lm(cfg)

    def insert(cache: dict, state_leaves: dict, slot: int) -> dict:
        for name, upd in state_leaves.items():
            leaf = cache[name]
            leaf.narrow(cache_batch_axis(cfg, name), slot, 1).copy_(upd.to(leaf.dtype))
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


def make_page_spill(cfg: ModelConfig):
    """(cache, ids (W,) int32) → {pool leaf: (nu, n_attn, W, bs, ...)}: the
    pages ``ids`` of every page-pool leaf, gathered into new tensors (the
    device half of a preemption; the pool is only read).  An int8 pool
    spills its scale planes with its codes, so a restore is bit-exact."""
    _check_token_lm(cfg)

    def spill(cache: dict, ids: torch.Tensor) -> dict:
        idx = ids.to(cache["pos"].device, torch.int64)
        return {name: cache[name][:, :, idx] for name in PAGE_POOL_LEAVES if name in cache}

    return spill


def make_page_restore(cfg: ModelConfig):
    """(cache, ids (W,) int32, payload) → cache: row ``i`` of every payload
    leaf written at page ``ids[i]``, in place in the pool's own tensors
    (the inverse of :func:`make_page_spill`).  Ids the engine does not want
    written point at the trash page, which nothing reads, so repeats of it
    are harmless."""
    _check_token_lm(cfg)

    def restore(cache: dict, ids: torch.Tensor, payload: dict) -> dict:
        for name, rows in payload.items():
            leaf = cache[name]
            leaf.index_copy_(2, ids.to(leaf.device, torch.int64), rows.to(leaf.device, leaf.dtype))
        return cache

    return restore


def make_slot_state_gather(cfg: ModelConfig):
    """(cache, slot) → state_leaves{B=1}: the one-slot view of every
    per-slot leaf (``pos`` and a hybrid or ssm model's state), shaped
    as :func:`make_paged_state_insert` takes it.  Leaves without a slot
    axis (an int8 pool's engine-wide ``quant_step``) are left out:
    restoring that counter would replay other slots' rounding draws."""
    _check_token_lm(cfg)

    def gather(cache: dict, slot: int) -> dict:
        return {
            name: leaf.narrow(cache_batch_axis(cfg, name), slot, 1)
            for name, leaf in cache.items()
            if name not in PAGE_POOL_LEAVES and leaf.ndim
            and leaf.ndim > cache_batch_axis(cfg, name)
        }

    return gather


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

    The comparator's operating point comes from the active device backend
    when this runs (``wta_readout_params`` of ``(cfg.analog.vth0,
    wta_sigma_z(beta))``: the identity on a healthy backend, shifted by a
    fault backend), so a captured step keeps the point of its capture.
    The trials run in one kernel launch per read on the card
    (``ops.wta_trial_counts``), keys folded on the device."""
    logits = PX.whole_dim(logits, -1)   # on a mesh: the vocab whole on every rank
    if not (cfg.wta_head and key is not None):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    b, v = logits.shape
    dev = logits.device
    keys = torch.as_tensor(key, dtype=torch.int64, device=dev)
    per_slot = keys.dim() == 2
    if not per_slot:
        keys = keys.reshape(1, 2).expand(b, 2)
    layout = (v, 0) if per_slot else (b * v, v)
    vth0, sigma_z = BK.get_backend().wta_readout_params(
        cfg.analog.vth0, W.wta_sigma_z(cfg.analog.beta)
    )

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


def make_sample0(cfg: ModelConfig):
    """(last-token logits (1, V), the request's key pair) → its first
    token (1,) int32: its own key, step 0, one read (the reference's
    ``_sample0``); the argmax without ``wta_head``."""

    def sample0(logits: torch.Tensor, key) -> torch.Tensor:
        if not cfg.wta_head:
            return sample_tokens(cfg, logits)
        dev = logits.device
        return sample_tokens(cfg, logits, torch.tensor([key], dtype=torch.int64, device=dev),
                             torch.zeros((1,), dtype=torch.int64, device=dev))

    return sample0


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
    _check_token_lm(cfg)

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


# ---------------------------------------------------------------------------
# Sharded serving: the paged entry points on a (data, model) DTensor mesh.
# ---------------------------------------------------------------------------


def paged_cache_shardings(cfg: ModelConfig, mesh, batch: int, n_pages: int,
                          block_size: int) -> dict:
    """A ``parallel.Sharding`` per paged-cache leaf on ``mesh``: the page
    axis over "data", kv heads over "model", per-slot leaves' slot axis
    over "data", each divisibility-guarded (``sharding.cache_partition_specs``,
    ``repro/launch/specs.py:376-385``)."""
    from repro_torch.launch import sharding as SH

    specs = paged_decode_cache_specs(cfg, batch, n_pages, block_size)
    return SH.cache_shardings(specs, mesh, cfg, batch)


def init_sharded_paged_decode_cache(cfg: ModelConfig, shardings: dict, batch: int,
                                    n_pages: int, block_size: int, device=None) -> dict:
    """:func:`init_paged_decode_cache` placed sharded from the start: each
    leaf a DTensor of ``shardings``' layout whose local shard alone is
    allocated (zeros; an int8 pool's scale planes ones, as unsharded)."""
    out = {}
    for name, spec in paged_decode_cache_specs(cfg, batch, n_pages, block_size).items():
        sh = shardings[name]
        fill = 1 if name in ("k_scale_pages", "v_scale_pages") else 0
        local = torch.full(sh.local_shape(spec.shape), fill, dtype=spec.dtype, device=device)
        out[name] = PX.place_local(local, sh, spec.shape)
    return out


class MeshSlots:
    """One rank's place on the serving mesh as the sharded entry points
    use it: ``ps`` (``parallel.PoolShards``: sizes, coordinates, groups,
    which of slots / pages / kv heads are split), the rank's slot range
    ``[slot0, slot0 + b_local)``, and each per-slot state leaf's dimension
    split over "model" (``None``: whole on every rank)."""

    def __init__(self, mesh, cache_sh: dict, batch: int):
        from torch.distributed.tensor import Shard

        names = tuple(mesh.mesh_dim_names or ())
        sizes = dict(zip(names, mesh.shape))
        if not {"data", "model"} <= set(names) or any(
                sizes[n] > 1 for n in names if n not in ("data", "model")):
            raise ValueError(f"serving mesh needs ('data', 'model') axes, got {sorted(names)}")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank sits the serving mesh out: it has no shard to serve")
        di, mi = names.index("data"), names.index("model")

        data, model = sizes["data"], sizes["model"]

        def split(sh, i):
            return mesh.shape[i] > 1 and isinstance(sh.placements[i], Shard)

        def dim(sh, i):
            return sh.placements[i].dim if split(sh, i) else None

        pool = cache_sh.get("k_pages")
        self.ps = PX.PoolShards(
            data=data, model=model, d=coord[di], m=coord[mi],
            data_group=mesh.get_group("data") if data > 1 else None,
            model_group=mesh.get_group("model") if model > 1 else None,
            slots=split(cache_sh["pos"], di),
            pages=pool is not None and split(pool, di),
            heads=pool is not None and split(pool, mi),
        )
        # a mesh of size-1 axes runs the unsharded code: no context, no
        # collective, the unsharded step's kernels in its order
        self.ctx = None if data == model == 1 else self.ps
        self.b_local = batch // data if self.ps.slots else batch
        self.slot0 = self.ps.d * self.b_local if self.ps.slots else 0
        self.model_dim = {n: dim(sh, mi) for n, sh in cache_sh.items()
                          if n not in PAGE_POOL_LEAVES and n != "quant_step"}

    def owner(self, slot: int) -> Optional[int]:
        """``slot``'s index in this rank's shard, or ``None`` if another
        data rank holds it."""
        ls = slot - self.slot0
        return ls if 0 <= ls < self.b_local else None

    def from_owner(self, t: torch.Tensor, owner: int) -> torch.Tensor:
        """Data rank ``owner``'s ``t`` on every rank (``t`` of the same
        shape everywhere)."""
        if self.ps.data == 1:
            return t
        return PX.all_gather(t[None], self.ps.data_group, self.ps.data, 0)[owner]

    def own_model(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's model block of a whole per-slot leaf ``t``."""
        md = self.model_dim.get(name)
        if md is None:
            return t
        n = t.shape[md] // self.ps.model
        return t.narrow(md, self.ps.m * n, n)

    def whole_model(self, name: str, t: torch.Tensor) -> torch.Tensor:
        md = self.model_dim.get(name)
        return t if md is None else PX.all_gather(t, self.ps.model_group, self.ps.model, md)

    def state_view(self, cache: dict) -> dict:
        """The cache a step runs on: the local shards, with every per-slot
        leaf split over "model" gathered whole (this rank's slots)."""
        return {n: self.whole_model(n, t) for n, t in cache.items()}

    def state_back(self, cache: dict, view: dict) -> None:
        """Write a step's per-slot leaves back into the model-split shards
        (the others were written in place)."""
        for n, md in self.model_dim.items():
            if md is not None and n in view:
                cache[n].copy_(self.own_model(n, view[n]))


def make_sharded_paged_entry_points(
    cfg: ModelConfig, mesh, *, batch: int, n_pages: int, block_size: int,
    speculate_k: int = 0, n_redundant: int = 1, sat_threshold: float = 1e6,
    entropy_floor: float = 0.0,
) -> dict:
    """The paged serving entry points on a ``(data, model)`` DTensor mesh
    (``repro/launch/specs.py:388-560``), as the reference's docstring lays
    them out:

    * the pool's page axis is split over "data" and its kv heads over
      "model" (divisibility-guarded: a dimension an axis does not divide
      is whole on every rank), so the pool's capacity grows with the data
      axis at constant bytes per device;
    * per-slot inputs (table (B, W), tokens (B,), keys (B, 2), step
      counters (B,)) and the per-slot leaves (``pos``, and ``rec_conv``,
      ``rec_h``, ``ssm_conv``, ``ssm_state`` on their slot axis,
      :func:`cache_batch_axis`) are split over "data", guarded on B; the
      state leaves over "model" too where ``cache_partition_specs`` says;
    * parameters are replicated, and so are the B = 1 prefill arguments,
      the chunk logits and every spill payload.

    Every rank runs the engine's host bookkeeping (scheduler, allocator,
    prefix index, block table) on the same trace, so the table is global;
    the entry points supply what GSPMD inserts in the reference: each
    paged layer gathers its whole pool over "data" and writes every slot's
    new rows (gathered over "data") into it, keeping its own pages
    (``models.attention._sharded_paged_decode``); a rank attends its kv
    heads and the head outputs are gathered over "model" before the
    replicated w_o; sampled tokens, flags and drafted runs are gathered
    over "data", so every rank's bookkeeping reads the same tokens.  An
    axis of size 1 issues no collective: on a 1 × 1 mesh each entry point
    unwraps its DTensors and runs the unsharded function, the same kernels
    in the same order.

    Per-tick inputs arrive as this rank's rows (the engine slices the
    host arrays with ``shardings``' placements); the cache and parameters
    as DTensors.  Returns ``{"serve_step", "suffix_prefill",
    "state_insert", "page_copy", "page_spill", "page_restore",
    "state_gather", "shardings"}`` (plus ``"spec_round"`` and
    ``"spec_rollback"`` with ``speculate_k > 0``); ``shardings`` maps
    ``params`` (every parameter leaf's layout), ``cache`` (one per leaf),
    ``table``, ``slot_vec``, ``slot_keys`` and ``replicated`` to
    ``parallel.Sharding`` layouts."""
    from torch.distributed.tensor import Replicate, Shard

    _check_token_lm(cfg)
    cache_sh = paged_cache_shardings(cfg, mesh, batch, n_pages, block_size)
    ms = MeshSlots(mesh, cache_sh, batch)
    names = tuple(mesh.mesh_dim_names)
    rep = PX.Sharding(mesh, (Replicate(),) * len(names))
    rows = PX.Sharding(mesh, tuple(Shard(0) if n == "data" and ms.ps.slots else Replicate()
                                   for n in names))
    L = PX.local

    def slot_outputs(*ts):
        return tuple(ms.ps.gather_slots(t) for t in ts)

    base_step = make_paged_serve_step(cfg, n_redundant=n_redundant, sat_threshold=sat_threshold,
                                      entropy_floor=entropy_floor)

    def serve_step(params, cache, table, token, key=None, steps=None):
        c = L(cache)
        view = ms.state_view(c)
        with PX.use_pool_shards(ms.ctx):
            _, tok, sane = base_step(L(params), view, table, token, key, steps)
        ms.state_back(c, view)
        return (cache, *slot_outputs(tok, sane))

    base_prefill = make_paged_suffix_prefill(cfg)

    def suffix_prefill(params, cache, state, tokens, table_row, q0, quant_seeds=None):
        with PX.use_pool_shards(ms.ctx):
            _, new_state, logits = base_prefill(L(params), L(cache), state, tokens, table_row,
                                                q0, quant_seeds)
        return cache, new_state, logits

    def state_insert(cache, state_leaves, slot):
        ls = ms.owner(slot)
        if ls is not None:
            c = L(cache)
            for name, upd in state_leaves.items():
                leaf = c[name]
                leaf.narrow(cache_batch_axis(cfg, name), ls, 1).copy_(
                    ms.own_model(name, upd).to(leaf.dtype))
        return cache

    def page_copy(cache, src, dst):
        c = L(cache)
        for name in PAGE_POOL_LEAVES:
            if name not in c:
                continue
            leaf = c[name]                       # (nu, n_attn, P_l, bs, ...)
            if not ms.ps.pages:
                leaf[:, :, dst] = leaf[:, :, src]
                continue
            pl, d = leaf.shape[2], ms.ps.d
            row = leaf[:, :, src - d * pl] if src // pl == d else torch.zeros_like(leaf[:, :, 0])
            row = ms.from_owner(row, src // pl) if src // pl != dst // pl else row
            if dst // pl == d:
                leaf[:, :, dst - d * pl] = row
        return cache

    def page_spill(cache, ids):
        c = L(cache)
        idx = ids.to(c["pos"].device, torch.int64)
        out = {}
        for name in PAGE_POOL_LEAVES:
            if name not in c:
                continue
            leaf = c[name]
            if ms.ps.pages:
                pl = leaf.shape[2]
                owner = idx // pl
                mine = (owner == ms.ps.d).reshape((1, 1, -1) + (1,) * (leaf.dim() - 3))
                rows = torch.where(mine, leaf[:, :, (idx - ms.ps.d * pl).clamp(0, pl - 1)],
                                   torch.zeros((), dtype=leaf.dtype, device=leaf.device))
                every = PX.all_gather(rows[None], ms.ps.data_group, ms.ps.data, 0)
                rows = every[owner, :, :, torch.arange(idx.numel(), device=idx.device)]
                rows = rows.movedim(0, 2)
            else:
                rows = leaf[:, :, idx]
            out[name] = ms.ps.gather_heads(rows, 4)
        return out

    def page_restore(cache, ids, payload):
        c = L(cache)
        for name, rows in payload.items():
            leaf = c[name]
            idx = ids.to(leaf.device, torch.int64)
            rows = ms.ps.own_heads(rows.to(leaf.device, leaf.dtype), 4)
            if ms.ps.pages:
                pl = leaf.shape[2]
                mine = idx // pl == ms.ps.d
                idx, rows = idx[mine] - ms.ps.d * pl, rows[:, :, mine]
            leaf.index_copy_(2, idx, rows)
        return cache

    def state_gather(cache, slot):
        c = L(cache)
        ls = ms.owner(slot)
        out = {}
        for name, leaf in c.items():
            if name in PAGE_POOL_LEAVES or not leaf.ndim or leaf.ndim <= cache_batch_axis(cfg, name):
                continue
            ax = cache_batch_axis(cfg, name)
            row = leaf.narrow(ax, 0 if ls is None else ls, 1)
            if ms.ps.slots:
                if ls is None:
                    row = torch.zeros_like(row)
                row = ms.from_owner(row, slot // ms.b_local)
            out[name] = ms.whole_model(name, row)
        return out

    out = {
        "serve_step": serve_step,
        "suffix_prefill": suffix_prefill,
        "state_insert": state_insert,
        "page_copy": page_copy,
        "page_spill": page_spill,
        "page_restore": page_restore,
        "state_gather": state_gather,
        "shardings": {"params": rep, "cache": cache_sh, "table": rows,
                      "slot_vec": rows, "slot_keys": rows, "replicated": rep},
    }
    if speculate_k:
        base_round = make_paged_spec_round(cfg, speculate_k)

        def spec_round(params, cache, table, token, keys=None, steps=None):
            c = L(cache)
            view = ms.state_view(c)
            with PX.use_pool_shards(ms.ctx):
                dtoks, doks, vtoks, voks, vstates = base_round(L(params), view, table, token,
                                                               keys, steps)
            ms.state_back(c, view)
            # vstates stay this rank's slots, every model block: the
            # rollback writes its own slots from them
            return (*slot_outputs(dtoks, doks, vtoks, voks), vstates)

        def spec_rollback(cache, vstates, idx, slot):
            ls = ms.owner(slot)
            if ls is not None:
                c = L(cache)
                for name, st in vstates.items():
                    ax = cache_batch_axis(cfg, name)
                    c[name].narrow(ax, ls, 1).copy_(ms.own_model(name, st[idx].narrow(ax, ls, 1)))
            return cache

        out["spec_round"] = spec_round
        out["spec_rollback"] = spec_rollback
    return out


def analog_call_profile(
    entry: str, *, tokens: int = 1, batch: int = 1, k: int = 0, redundant: int = 0,
) -> dict:
    """Analog-event multiplicities of ONE call of a serving entry point,
    the contract the energy accounting rides on (``kernels/backend.py``;
    ``repro/launch/specs.py:632-700``).

    * ``suffix_prefill``: one chunked-prefill step over ``tokens`` suffix
      positions, each forwarded and K/V-writing; no sampling.
    * ``sample0``: one first-token sampling decision (prefill completion,
      full prefix hit).
    * ``serve_step``: one batched decode step; ``batch`` ACTIVE slots each
      forward, sample and write one token (padded idle slots are not
      logical work); ``redundant`` extra comparator re-reads, each priced
      as one more per-sample sweep without a sample event.
    * ``spec_round``: one fused speculative round, ``k`` drafted tokens
      (forwarded, sampled, written) plus ``k`` read-only verify positions
      (forwarded, resampled) per active slot.
    * page and state movement (``page_copy``, ``page_spill``,
      ``page_restore``, ``state_gather``, ``state_insert``,
      ``spec_rollback``): memory traffic, no crossbar events.

    An unknown entry raises."""
    zero = dict(prefill=0, decode=0, draft=0, samples=0, kv_tokens=0, redundant=0)
    if entry == "suffix_prefill":
        return dict(zero, prefill=tokens, kv_tokens=tokens)
    if entry == "sample0":
        return dict(zero, samples=1)
    if entry == "serve_step":
        return dict(zero, decode=batch, samples=batch, kv_tokens=batch, redundant=redundant)
    if entry == "spec_round":
        return dict(zero, draft=k * batch, decode=k * batch, samples=2 * k * batch,
                    kv_tokens=k * batch)
    if entry in ("page_copy", "page_spill", "page_restore", "state_gather", "state_insert",
                 "spec_rollback"):
        return zero
    raise ValueError(f"unknown serving entry point {entry!r}")


def _signature(x):
    """What ``jax.jit`` keys a compile on: shapes and dtypes of tensors
    (inside dicts, tuples and lists too), the type of a Python number
    (traced, not its value)."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return tuple(_signature(v) for v in x)
    return None if x is None else type(x).__name__


class EagerEntry:
    """An eager entry point that records the distinct argument signatures
    it is called with (:func:`_signature`, plus the values of the keyword
    arguments named in ``static``, which key the signature as a jitted
    function's static arguments key its compile, and are not passed on)."""

    def __init__(self, fn, static: tuple[str, ...] = ()):
        self.fn, self.static = fn, static
        self.signatures: set = set()

    def __call__(self, *args, **kw):
        statics = tuple((k, kw.pop(k)) for k in self.static)
        self.signatures.add((_signature(args), _signature(kw), statics))
        return self.fn(*args, **kw)


@functools.cache
def capture_stream(index: int) -> "torch.cuda.Stream":
    """The side stream that every warm-up and capture on card ``index``
    runs on.  cuBLAS keeps a workspace (32 MiB on the H100) for each
    stream it has run on, for the life of the process: a new stream per
    capture would leave one behind with every engine."""
    return torch.cuda.Stream(index)


@dataclasses.dataclass
class _Entry:
    inputs: tuple                # static table, tokens[, keys, steps] on the device
    stage: tuple                 # their pinned host staging buffers
    graph: Optional["torch.cuda.CUDAGraph"] = None
    out: tuple = ()              # the graph's static (tok, sane)
    launches: dict = dataclasses.field(default_factory=dict)  # a replay's, by kernel
    capture_ms: float = 0.0


class DecodeGraphs:
    """The compiled decode step of one engine: :func:`make_paged_serve_step`
    over its parameters and cache, one entry per (window width W,
    redundant reads R).

    An entry owns its static inputs: the (B, W) int32 table, the (B,)
    int32 tokens and, under ``wta_head``, the (B, 2) int64 keys and (B,)
    int64 steps.  Each call copies the host's arrays into them through
    pinned staging buffers.  With ``capture`` (the card) an entry's first
    call runs the step eagerly on a side stream, the warm-up PyTorch
    requires before a capture, and returns its tokens; it then captures
    the step as a CUDA graph, and every later call replays the graph.  All
    entries share one memory pool, so a call's outputs hold only until the
    next call: the caller reads them first, and that read, a sync, is also
    what lets the next call refill the staging buffers.  A capture that
    fails raises; nothing falls back to eager mode.  Without ``capture``
    (the CPU, or an eager run on the card) every call runs the step
    eagerly on the same static buffers.

    The graph holds the addresses of the parameters, the cache's tensors
    (the pool, ``pos``, ``quant_step``) and the static inputs, so all of
    them are written in place and never rebound.  It also holds the kernel
    arguments of its capture, the device backend's comparator point among
    them: the engine drops the whole object when the backend's fault state
    moves.  Kernel wrappers count
    launches in Python, which a replay does not run: each entry keeps the
    counts its capture made (``launches``) and adds them on every replay.

    On a serving mesh ``step`` is the sharded step
    (:func:`make_sharded_paged_entry_points`) and ``rows`` this rank's
    slots: each call's host arrays are cut to them before staging."""

    rows: Optional[slice] = None   # this rank's slots on a serving mesh

    def __init__(self, cfg: ModelConfig, params: dict, cache: dict, *, n_redundant: int = 1,
                 capture: bool, sat_threshold: float = 1e6, entropy_floor: float = 0.0,
                 step=None, rows: Optional[slice] = None):
        self.params, self.cache = params, cache
        self.reads = n_redundant
        self.capture = capture
        self.device = cache["pos"].device
        self._step = step or make_paged_serve_step(cfg, n_redundant=n_redundant,
                                                   sat_threshold=sat_threshold,
                                                   entropy_floor=entropy_floor)
        self.rows = rows
        self.entries: dict[tuple[int, int], _Entry] = {}
        self._pool = torch.cuda.graph_pool_handle() if capture else None

    # the dtypes of a step's inputs: table, tokens[, keys, steps]
    input_dtypes = (torch.int32, torch.int32, torch.int64, torch.int64)

    def _key(self, srcs: tuple) -> tuple:
        return srcs[0].shape[1], self.reads

    def __call__(self, table: np.ndarray, tokens: np.ndarray, *wta: np.ndarray):
        """One decode step: table (B, W), tokens (B,)[, keys (B, 2), steps
        (B,)] host arrays → (tok, sane) (B,) int32 on the device."""
        return self._call((table, tokens, *wta))

    def _call(self, srcs: tuple) -> tuple:
        if self.rows is not None:
            srcs = tuple(a[self.rows] for a in srcs)
        key = self._key(srcs)
        entry = self.entries.get(key)
        if entry is None:
            pin = self.device.type == "cuda"
            entry = self.entries[key] = _Entry(
                inputs=tuple(torch.empty(a.shape, dtype=dt, device=self.device)
                             for a, dt in zip(srcs, self.input_dtypes)),
                stage=tuple(torch.empty(a.shape, dtype=dt, pin_memory=pin)
                            for a, dt in zip(srcs, self.input_dtypes)),
            )
        for dst, stage, src in zip(entry.inputs, entry.stage, srcs):
            stage.numpy()[...] = src
            dst.copy_(stage, non_blocking=True)
        if not self.capture:
            return self._run(entry.inputs)
        if entry.graph is None:
            return self._warm_up_and_capture(entry)
        entry.graph.replay()
        KOPS.add_launches(entry.launches)
        return entry.out

    def _run(self, inputs: tuple) -> tuple[torch.Tensor, ...]:
        _, tok, sane = self._step(self.params, self.cache, *inputs)
        return tok, sane

    def _warm_up_and_capture(self, entry: _Entry) -> tuple[torch.Tensor, ...]:
        cur = torch.cuda.current_stream(self.device)
        side = capture_stream(self.device.index)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self._run(entry.inputs)   # this call's step, and the warm-up
        cur.wait_stream(side)
        for t in out:
            t.record_stream(cur)
        before = KOPS.launch_counts()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side):
            # a synchronizing call (a pageable copy, a read of a device
            # value) cannot be captured: make it raise where it is made
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                entry.out = self._run(entry.inputs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        entry.capture_ms = (time.perf_counter() - t0) * 1e3
        after = KOPS.launch_counts()
        entry.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        KOPS.add_launches({k: -n for k, n in entry.launches.items()})
        entry.graph = graph
        return out

    def captures(self) -> list[tuple[tuple, float]]:
        """(entry key, capture ms) of every captured entry: (W, R) here,
        ("spec", W, k) for :class:`SpecGraphs`."""
        return [(self._log_key(k), e.capture_ms) for k, e in self.entries.items()
                if e.graph is not None]

    def _log_key(self, key: tuple) -> tuple:
        return key


class SpecGraphs(DecodeGraphs):
    """The compiled speculative round of one engine: :func:`make_paged_spec_round`
    over its parameters and cache, one entry per (window width W, k), the
    counterpart of the reference's round jitted per window bucket.

    The machinery is :class:`DecodeGraphs`': static inputs (table, tokens[,
    keys, steps]) filled through pinned staging, the first call of an
    entry eager on the capture stream and then captured under
    ``set_sync_debug_mode("error")``, every later call a replay that adds
    the capture's launch counts, no eager fallback; eager on the same
    buffers without ``capture``.  A call returns ``(dtoks, doks, vtoks,
    voks, vstates)``, which live in the graphs' memory pool until the next
    call: the engine reads the tokens and flags in one sync and does every
    rollback from ``vstates`` before it replays anything again.  The round
    writes the pool, the per-slot state and ``quant_step`` in place, k
    times a replay."""

    def __init__(self, cfg: ModelConfig, params: dict, cache: dict, *, k: int, capture: bool,
                 round=None, rows: Optional[slice] = None):
        self.params, self.cache = params, cache
        self.k = k
        self._state_names = tuple(_spec_state_leaves(cache))
        self.capture = capture
        self.device = cache["pos"].device
        self._round = round or make_paged_spec_round(cfg, k)
        self.rows = rows
        self.entries: dict[tuple[int, int], _Entry] = {}
        self._pool = torch.cuda.graph_pool_handle() if capture else None

    def _key(self, srcs: tuple) -> tuple:
        return srcs[0].shape[1], self.k

    def _log_key(self, key: tuple) -> tuple:
        return ("spec", *key)

    def __call__(self, table: np.ndarray, tokens: np.ndarray, *wta: np.ndarray):
        """One round: table (B, W), tokens (B,)[, keys (B, 2), steps (B,)]
        host arrays → (dtoks, doks, vtoks, voks) (B, k), vstates {state
        leaf: (k, ...)} on the device."""
        dtoks, doks, vtoks, voks, *states = self._call((table, tokens, *wta))
        return dtoks, doks, vtoks, voks, dict(zip(self._state_names, states))

    def _run(self, inputs: tuple) -> tuple[torch.Tensor, ...]:
        dtoks, doks, vtoks, voks, vstates = self._round(self.params, self.cache, *inputs)
        return (dtoks, doks, vtoks, voks, *(vstates[n] for n in self._state_names))


class DenseGraphs(DecodeGraphs):
    """The compiled dense decode step: :func:`make_serve_step` over the
    parameters and one dense cache per batch width, one entry per batch
    width B (the window is always ``max_len``, so no width is keyed), the
    counterpart of the reference's dense step jitted per batch shape.

    The machinery is :class:`DecodeGraphs`': static inputs (tokens (B,)
    int32[, key (2,) or keys (B, 2) int64[, steps (B,) int64]]) filled
    through pinned staging, the first call of an entry eager on the
    capture stream and then captured under ``set_sync_debug_mode("error")``,
    every later call a replay that adds the capture's launch counts; eager
    on the same buffers without ``capture``.  A call returns ``(tok,)``,
    valid until the next call.  ``caches`` maps a batch width to its cache;
    the caller adds one before the first call at a new width, and writes
    every later prompt into that same cache in place (the continuous
    engine's slot insert, the static engine's prefill), never rebinding
    a leaf: the graph holds their addresses."""

    input_dtypes = (torch.int32, torch.int64, torch.int64)

    def __init__(self, cfg: ModelConfig, params: dict, caches: dict, *, capture: bool):
        self.params, self.caches = params, caches
        self.capture = capture
        self.device = params["embed"]["embedding"].device
        self._step = make_serve_step(cfg)
        self.entries: dict[tuple[int], _Entry] = {}
        self._pool = torch.cuda.graph_pool_handle() if capture else None

    def _key(self, srcs: tuple) -> tuple:
        return (srcs[0].shape[0],)

    def _log_key(self, key: tuple) -> tuple:
        return ("dense", *key)

    def __call__(self, tokens: np.ndarray, *wta: np.ndarray):
        """One dense decode step of the cache of width ``len(tokens)``:
        tokens (B,)[, key (2,) or keys (B, 2)[, steps (B,)]] host arrays →
        (tok,) (B,) int32 on the device."""
        return self._call((tokens, *wta))

    def _run(self, inputs: tuple) -> tuple[torch.Tensor, ...]:
        _, tok = self._step(self.params, self.caches[inputs[0].shape[0]], *inputs)
        return (tok,)
