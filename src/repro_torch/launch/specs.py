"""The paged serving entry points the engine drives (``repro/launch/specs.py``).

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
:func:`make_spec_rollback` rewinds one slot's ``pos`` in place.  Absent
still: sharding.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import wta as W
from repro_torch.kernels import backend as BK
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


def _spec_state_leaves(cache: dict) -> dict:
    """The per-slot leaves a speculative round snapshots and rolls back:
    all but the shared page pool and an int8 pool's engine-wide
    ``quant_step`` (rewinding it would replay rounding draws).  The ported
    decoder has no recurrent state, so this is ``pos``."""
    return {n: v for n, v in cache.items() if n not in PAGE_POOL_LEAVES and n != "quant_step"}


def _check_token_lm(cfg: ModelConfig) -> None:
    if cfg.family in ("encdec", "fcnn"):
        raise ValueError(f"paged serving is token-LM only (no {cfg.family})")


def make_paged_spec_round(cfg: ModelConfig, k: int):
    """One fused draft-k → verify-k speculative round over a paged cache
    (``repro/launch/specs.py:199-291``):

    (params, cache, table (B, W), token (B,)[, keys (B, 2), steps (B,)]) →
    (dtoks (B, k), doks (B, k), vtoks (B, k), voks (B, k), vstates
    {"pos": (k, B)}).

    Draft: k chained :func:`TF.lm_decode_step` + :func:`sample_tokens`
    calls, each with the slot's own ``(key, steps + j)``, so the drafts are
    k plain engine ticks; their K/V lands in the slots' pages, and ``pos``
    and an int8 pool's ``quant_step`` advance in place, one a step.
    ``vstates["pos"][j]`` is ``pos`` after consuming input j.

    Verify: ONE read-only decode step of k·B rows (``kv_write=False``):
    row (j, s) consumes input j of ``[token, dtoks[:-1]]`` for slot s at
    position ``pre-draft pos + j`` (a ``pos`` tensor of its own: the
    cache's is never handed over), the table tiled k times, resampled
    with the same ``(key, steps + j)``.  Its decode attention launches
    with the cluster split the draft's B chose (``split_batch``), so a
    verify row attends exactly as its draft row did.  In a fault-free
    round whose rows are batch-invariant ``vtoks == dtoks`` and every
    draft accepts; where they differ, the first mismatch is both the
    rejection point and the corrected token.  ``doks`` / ``voks`` are the
    per-step finite-logits flags (the NaN guard at draft depth).

    The pre-draft ``pos`` is snapshot inside the round, so a captured
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
            view[n] = torch.cat([st[n] for st in states[:-1]], dim=cache_batch_axis(n))
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
    plain engine's), in place in the cache's own tensors, whose addresses
    the graphs hold.  Drafted K/V past the new ``pos`` stays in the pages
    as dead rows: masked, and overwritten when decode reaches them again.
    ``idx`` and ``slot`` are Python ints, so every pair shares one
    signature."""
    _check_token_lm(cfg)

    def rollback(cache: dict, vstates: dict, idx: int, slot: int) -> dict:
        for name, st in vstates.items():
            ax = cache_batch_axis(name)
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


def make_page_spill(cfg: ModelConfig):
    """(cache, ids (W,) int32) → {pool leaf: (nu, n_attn, W, bs, ...)}: the
    pages ``ids`` of every page-pool leaf, gathered into new tensors (the
    device half of a preemption; the pool is only read).  An int8 pool
    spills its scale planes with its codes, so a restore is bit-exact."""

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

    def restore(cache: dict, ids: torch.Tensor, payload: dict) -> dict:
        for name, rows in payload.items():
            leaf = cache[name]
            leaf.index_copy_(2, ids.to(leaf.device, torch.int64), rows.to(leaf.device, leaf.dtype))
        return cache

    return restore


def make_slot_state_gather(cfg: ModelConfig):
    """(cache, slot) → state_leaves{B=1}: the one-slot view of every
    per-slot leaf (``pos``), shaped as :func:`make_paged_state_insert`
    takes it.  Leaves without a slot axis (an int8 pool's engine-wide
    ``quant_step``) are left out: restoring that counter would replay
    other slots' rounding draws."""

    def gather(cache: dict, slot: int) -> dict:
        return {
            name: leaf.narrow(cache_batch_axis(name), slot, 1)
            for name, leaf in cache.items()
            if name not in PAGE_POOL_LEAVES and leaf.ndim and leaf.ndim > cache_batch_axis(name)
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


# the dtypes of a decode step's inputs: table, tokens[, keys, steps]
_INPUT_DTYPES = (torch.int32, torch.int32, torch.int64, torch.int64)


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
    counts its capture made (``launches``) and adds them on every replay."""

    def __init__(self, cfg: ModelConfig, params: dict, cache: dict, *, n_redundant: int = 1,
                 capture: bool, sat_threshold: float = 1e6, entropy_floor: float = 0.0):
        self.params, self.cache = params, cache
        self.reads = n_redundant
        self.capture = capture
        self.device = cache["pos"].device
        self._step = make_paged_serve_step(cfg, n_redundant=n_redundant,
                                           sat_threshold=sat_threshold,
                                           entropy_floor=entropy_floor)
        self.entries: dict[tuple[int, int], _Entry] = {}
        self._pool = torch.cuda.graph_pool_handle() if capture else None

    def _key(self, width: int) -> tuple:
        return width, self.reads

    def __call__(self, table: np.ndarray, tokens: np.ndarray, *wta: np.ndarray):
        """One decode step: table (B, W), tokens (B,)[, keys (B, 2), steps
        (B,)] host arrays → (tok, sane) (B,) int32 on the device."""
        srcs = (table, tokens, *wta)
        key = self._key(table.shape[1])
        entry = self.entries.get(key)
        if entry is None:
            pin = self.device.type == "cuda"
            entry = self.entries[key] = _Entry(
                inputs=tuple(torch.empty(a.shape, dtype=dt, device=self.device)
                             for a, dt in zip(srcs, _INPUT_DTYPES)),
                stage=tuple(torch.empty(a.shape, dtype=dt, pin_memory=pin)
                            for a, dt in zip(srcs, _INPUT_DTYPES)),
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
    writes the pool, ``pos`` and ``quant_step`` in place, k times a replay."""

    def __init__(self, cfg: ModelConfig, params: dict, cache: dict, *, k: int, capture: bool):
        self.params, self.cache = params, cache
        self.k = k
        self.capture = capture
        self.device = cache["pos"].device
        self._round = make_paged_spec_round(cfg, k)
        self.entries: dict[tuple[int, int], _Entry] = {}
        self._pool = torch.cuda.graph_pool_handle() if capture else None

    def _key(self, width: int) -> tuple:
        return width, self.k

    def _log_key(self, key: tuple) -> tuple:
        return ("spec", *key)

    def __call__(self, table: np.ndarray, tokens: np.ndarray, *wta: np.ndarray):
        """One round: table (B, W), tokens (B,)[, keys (B, 2), steps (B,)]
        host arrays → (dtoks, doks, vtoks, voks) (B, k), vstates {"pos": (k,
        B)} on the device."""
        dtoks, doks, vtoks, voks, vpos = super().__call__(table, tokens, *wta)
        return dtoks, doks, vtoks, voks, {"pos": vpos}

    def _run(self, inputs: tuple) -> tuple[torch.Tensor, ...]:
        dtoks, doks, vtoks, voks, vstates = self._round(self.params, self.cache, *inputs)
        return dtoks, doks, vtoks, voks, vstates["pos"]
