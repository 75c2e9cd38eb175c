"""Continuous-batching serving engine over the paged KV pool or the dense
per-slot cache, with greedy or WTA sampling, and the static-batch
reference engine (``repro/serving/engine.py``).

A slot-based scheduler admits queued requests into free slots of a live
decode batch.  Admission reserves a request's whole block budget from the
pool (prompt bucket + decode budget); prefill is a chunked, interleaved
phase, at most ``ServeConfig.prefill_chunk`` tokens computed per tick
between batched decode steps.  With prefix sharing on, an admission maps
the deepest resident match of its padded prompt's block-hash chain into
its block table: a full match skips prefill (first token from the stored
last-token logits), a partial match prefills only the suffix, whose
queries attend into the shared pages.  The first decode write into a
still-shared block forks it (copy-on-write) onto a spare page reserved at
admission.

With ``ModelConfig.kv_cache_dtype="int8"`` the pool holds stochastically
rounded int8 codes plus f32 scale planes.  A prompt block's rounding seed
derives from its content hash (``prefix_block_hashes``), so every writer
of the same block content writes bit-identical codes and int8 blocks stay
shareable; decode writes draw from the device step counter
``quant_step``.  A ``num_kv_blocks`` budget counts native-dtype blocks,
so an int8 pool holds twice the pages.

With ``ModelConfig.wta_head`` the tokens are the paper's WTA vote
(``specs.sample_tokens``), as in the reference: every request draws from
its own key ``fold_in(PRNGKey(seed), rid)`` with its count of emitted
tokens folded in, so its stream does not depend on which requests share
its batch, or on whether its prefill was shared; ``n_redundant_reads``
races the trial bank that many times per token and takes the majority.

The engine runs on the card unless built with ``device="cpu"``; the KV
pool, the parameters and every per-tick input live on that device, while
the block table, allocator and prefix index stay on the host.  On the
card the decode step is compiled: one CUDA graph per (window width,
redundant reads), captured on first use and replayed on every later tick
(``specs.DecodeGraphs``), as the reference jits one step per window
bucket; :meth:`ServingEngine.compile_counts` is the reference's guard on
them.  On the CPU the same step runs eagerly on the same static buffers.

Each engine owns a private device backend (``ServeConfig.device_backend``,
``kernels/backend.py``) and notes the analog work of every entry-point
call on it (``specs.analog_call_profile``), so :meth:`ServingEngine.metrics`
reports the Table I model's energy per token under RACA and 1-bit-ADC
readout (``ServingMetrics.analog``).  A fault backend (``sim_faulty``) is
installed process-wide around each tick; its ``fault_version`` moving
makes the engine drop every captured graph, whose kernel arguments hold
the comparator point and weights of their capture, and capture again on
next use.  Degraded-mode serving, as the reference's: a known-answer
canary read every ``canary_interval`` ticks (with tile retirement on a
failure), logit-sanity evictions as detection events, and the
:class:`DegradationPolicy` ladder, which raises the WTA redundant reads at
level 2 (one compiled step per R) and sheds less urgent admissions at
level 3.

Preemption, deadlines and chaos, as the reference's: when a queued
request outranks a decoding one (strictly lower ``priority``), the engine
spills the weakest victim's pages and per-slot state to a host-side store
(torch CPU tensors, fixed-width records under ``spill_budget_bytes``,
oldest dropped first) and requeues it; it restores through the admission
gate, page for page into the same pool tensors the graphs hold, or, when
the budget dropped its record, recomputes its prompt and teacher-forces
its published tokens back through decode.  A request past its
``deadline_ms`` is evicted in whatever state it is in; a killed prefill
job demotes the queued jobs that mapped its unwritten pages; the
``nan_logits`` fault poisons a private page through the restore entry
point.

Self-speculative decoding, as the reference's: with ``speculate_k = k``
a decode tick is one fused round (``specs.SpecGraphs``, one CUDA graph per
(window width, k) on the card): every decoding slot drafts k chained
tokens through the plain decode step, then the drafted run is decoded
again read-only as k·B rows, and each slot accepts its drafts up to the
first token the verify resamples otherwise, which is the token it
publishes there; a rejected tail rolls ``pos`` back in place.  Level 1 of
the degradation ladder turns it off.

The dense layout (``ServeConfig(kv_layout="dense")``), the reference's
byte-identity oracle: each slot owns a ``max_len`` window of the cache;
admission prefills a request's whole bucket in one call
(``transformer.lm_prefill``), samples its first token there and copies
its cache into the slot; each tick decodes every slot over its whole
window, one CUDA graph per batch width on the card
(``specs.DenseGraphs``).  No blocks, sharing, chunking, preemption,
speculation, fault backend or injector: :class:`ServeConfig` refuses each
of them with the reference's message.  :class:`StaticServingEngine` is
the reference's pre-continuous-batching engine on that step, kept as the
equivalence oracle and occupancy baseline.

Sharded serving (``ServeConfig(mesh=...)``, a ``(data, model)`` DTensor
mesh from ``launch.mesh``; the paged layout only): the entry points are
``specs.make_sharded_paged_entry_points``'.  The parameters are placed
once, replicated; the pool is placed sharded from the start (pages over
data, kv heads over model), and each tick's per-slot inputs are cut to
this rank's slots with the entry points' placements.  The mesh is SPMD,
one process per rank: every rank runs this engine on the same trace, so
the block table, allocator and prefix index stay host-global and
identical on every rank, and the decode step hands every rank every
slot's tokens.  A request's deadline reads each rank's own clock, so a
mesh wider than one rank refuses ``deadline_ms``.  Only a mesh of size-1
axes captures CUDA graphs (its step is the unsharded step, with no
collective to capture); a wider one runs eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch import parallel as PX
from repro_torch import random as R
from repro_torch.device import resolve_device
from repro_torch.kernels import backend as BK
from repro_torch.kernels import ops as KOPS
from repro_torch.launch import specs as SP
from repro_torch.models import ModelConfig, get_model_fns
from repro_torch.models import transformer as TF
from repro_torch.serving.scheduler import (
    BlockAllocator,
    Request,
    RequestState,
    Scheduler,
    left_pad,
    prefix_block_hashes,
)


def _pctl(vals: Sequence[float], q: float) -> float:
    """Percentile helper tolerant of empty samples (metrics views)."""
    return float(np.percentile(np.asarray(vals), q)) if len(vals) else 0.0


def _to_host(leaves: dict) -> dict:
    """Host copies of device leaves (copies on the CPU too: a spill record
    must not alias the live cache)."""
    return {k: v.to("cpu", copy=True) for k, v in leaves.items()}


def _place_tree(tree: dict, sh) -> dict:
    """Every tensor leaf of ``tree`` as a DTensor of layout ``sh``."""
    return {k: _place_tree(v, sh) if isinstance(v, dict) else PX.place(v, sh)
            for k, v in tree.items()}


def _default_buckets(max_len: int) -> tuple[int, ...]:
    out, b = [], 8
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


@dataclasses.dataclass
class DegradationPolicy:
    """Graceful-degradation ladder under sustained fault pressure.

    The engine counts *detection events* per tick (canary failures and
    logit-sanity evictions).  ``trip_after`` consecutive dirty ticks
    escalate one rung; ``recover_after`` consecutive clean canary PASSES
    de-escalate one rung (without a canary, degradation is one-way: there
    is no evidence the substrate recovered).  Rungs, in order:

    * level 0: healthy;
    * level 1: speculative decoding off (a k-deep draft multiplies one bad
      logit row's reach by k);
    * level 2: WTA redundant reads raised to ``redundant_reads`` (majority
      voting over comparator re-reads, priced in the energy accounting);
    * level 3: admissions shed: queued requests with priority strictly
      less urgent than ``shed_priority_above`` wait.

    Every transition is recorded in ``ServingMetrics.degraded_transitions``
    with its tick and cause.
    """

    trip_after: int = 2        # consecutive dirty ticks per escalation
    recover_after: int = 3     # consecutive clean canary passes per rung
    redundant_reads: int = 3   # R at level >= 2 (majority vote)
    shed_priority_above: int = 0  # level 3: shed priority > this


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8          # decode slots
    max_new_tokens: int = 32    # default per-request budget
    max_len: int = 512          # per-request capacity (prompt + generated)
    # "paged": the shared block pool; "dense": one max_len window per slot
    # (the byte-identity oracle: no sharing, chunking, preemption,
    # speculation or fault backend)
    kv_layout: str = "paged"
    eos_token: int = -1         # -1: never stop early
    seed: int = 0               # WTA sampling: the base key PRNGKey(seed)
    # prompt lengths are left-padded up to the next bucket
    prefill_buckets: tuple[int, ...] = ()
    kv_block_size: int = 16     # tokens per KV block
    # total pool size in blocks; 0 → max_batch · ceil(max_len / block) + 1
    # (one trash block); lower values back-pressure admission
    num_kv_blocks: int = 0
    # map resident prompt blocks into new requests' tables instead of
    # re-prefilling them; the first write into a shared block forks it
    enable_prefix_sharing: bool = True
    # at most this many prefill tokens are computed per tick (a positive
    # multiple of kv_block_size); 0 computes the whole bucket at once
    prefill_chunk: int = 0
    # WTA comparator re-reads per sampled token (majority vote); 1 is the
    # plain single-read path
    n_redundant_reads: int = 1
    # optional serving.faults.FaultInjector, fired at the start of every
    # tick; None costs nothing
    fault_injector: Optional[Any] = None
    # the device backend the engine accounts analog events against
    # (kernels.backend.BACKENDS): "sim" keeps the plain math; "sim_faulty"
    # adds the ReRAM fault model.  Each engine owns a private instance.
    device_backend: str = "sim"
    # kernels.backend.FaultConfig for a fault backend (loud otherwise)
    device_fault_config: Optional[Any] = None
    # fire the known-answer canary read every N ticks (0 = off); a probe
    # whose relative error exceeds canary_threshold is a detection event
    canary_interval: int = 0
    canary_threshold: float = 0.05
    # on a canary failure, retire crossbar tiles whose stuck-at density
    # reaches this (0 disables retirement)
    tile_retire_threshold: float = 0.0
    # logit-sanity detection of the decode step: |logit| above the
    # threshold evicts "saturated", softmax entropy below the floor
    # "entropy_collapse" (0.0 disables the entropy check)
    logit_sat_threshold: float = 1e6
    logit_entropy_floor: float = 0.0
    # graceful-degradation ladder; None: detection evicts, nothing downshifts
    degradation: Optional[DegradationPolicy] = None
    # a queued request that outranks a decoding one (strictly lower
    # priority) preempts the weakest: its pages spill to a host-side store
    # and it requeues at the head of its class, to restore through the
    # admission gate; single-class traffic never preempts
    enable_preemption: bool = True
    # bytes cap on the spill store (None: unbounded); over it the oldest
    # records drop, and their requests recompute their prompt and replay
    # their published tokens through decode
    spill_budget_bytes: Optional[int] = None
    # paged layout only: a DeviceMesh with ("data", "model") axes
    # (launch.mesh).  The pool's page axis is split over data (its capacity
    # grows with the data axis at constant bytes per device) and its kv
    # heads over model; per-slot inputs are split over data; the block
    # table, allocator and prefix index stay host-global, so sharing and
    # copy-on-write work across shards.  A dimension an axis does not
    # divide is whole on every rank.  A 1 × 1 mesh is byte-identical to
    # mesh=None
    mesh: Optional[Any] = None
    # self-speculative decoding depth: k > 0 makes each decode tick one
    # fused round that drafts k chained tokens per slot and verifies the
    # run read-only in one k·B-row step, accepting up to the first
    # disagreement (which is the corrected token); a rejected tail rolls
    # pos back.  Streams equal speculate_k = 0's where verify rows
    # reproduce their drafts bit for bit
    speculate_k: int = 0

    def buckets(self) -> tuple[int, ...]:
        if not self.prefill_buckets:
            return tuple(_default_buckets(self.max_len))
        bs = tuple(sorted(set(self.prefill_buckets)))
        if any(b < 1 for b in bs):
            raise ValueError(f"prefill_buckets must be >= 1: {bs}")
        kept = tuple(b for b in bs if b <= self.max_len)
        if not kept:
            raise ValueError(
                f"every prefill bucket in {bs} exceeds max_len="
                f"{self.max_len}; no prompt could ever be admitted"
            )
        return kept

    def max_kv_blocks(self) -> int:
        """Block-table width: blocks covering one request's max_len."""
        return -(-self.max_len // self.kv_block_size)

    def pool_blocks(self, kv_cache_dtype: str = "same") -> int:
        """Total pool pages (incl. the reserved trash page 0).

        ``num_kv_blocks`` is a memory budget in native-dtype blocks: an
        int8 page costs half the K/V bytes, so the same budget holds
        ``2·num_kv_blocks − 1`` pages (the trash page counted once).  The
        default (0) already fits every slot at ``max_len`` and is not
        doubled."""
        if self.num_kv_blocks:
            if kv_cache_dtype == "int8":
                return 2 * self.num_kv_blocks - 1
            return self.num_kv_blocks
        return self.max_batch * self.max_kv_blocks() + 1

    def validate(self, kv_cache_dtype: str = "same") -> None:
        """Loud, eager config validation, with the reference's refusals of
        paged-only knobs on the dense layout."""
        if kv_cache_dtype not in ("same", "int8"):
            raise ValueError(
                f"kv_cache_dtype must be 'same' or 'int8', got {kv_cache_dtype!r}"
            )
        if self.kv_layout not in ("paged", "dense"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'dense', got {self.kv_layout!r}"
            )
        self.buckets()
        if self.kv_layout == "paged":
            if self.kv_block_size < 1:
                raise ValueError(f"kv_block_size must be >= 1, got {self.kv_block_size}")
            if not isinstance(self.enable_prefix_sharing, bool):
                # a truthy string like "off" would silently ENABLE sharing
                raise ValueError(
                    f"enable_prefix_sharing must be a bool, got "
                    f"{self.enable_prefix_sharing!r}"
                )
            if not isinstance(self.enable_preemption, bool):
                raise ValueError(
                    f"enable_preemption must be a bool, got {self.enable_preemption!r}"
                )
            if self.prefill_chunk < 0:
                raise ValueError(f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
            if self.prefill_chunk and self.prefill_chunk % self.kv_block_size:
                # chunks scatter whole blocks and the resume grid is block-indexed
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must be a multiple of "
                    f"kv_block_size={self.kv_block_size}"
                )
            # the smallest admissible request: shortest bucket + one token
            need = -(-(min(self.buckets()) + 1) // self.kv_block_size)
            cap = self.pool_blocks(kv_cache_dtype) - 1  # minus trash page
            if cap < need:
                raise ValueError(
                    f"num_kv_blocks={self.num_kv_blocks} leaves a pool of {cap} "
                    f"allocatable blocks, but even the smallest request (bucket "
                    f"{min(self.buckets())} + 1 token) needs {need}"
                )
        elif self.prefill_chunk:
            raise ValueError(
                "prefill_chunk is a paged-layout knob; the dense layout "
                "prefills monolithically (it is the byte-identity oracle)"
            )
        if self.fault_injector is not None and self.kv_layout != "paged":
            raise ValueError(
                "fault_injector drives the paged allocator/pipeline; the "
                "dense layout is the fault-free byte-identity oracle"
            )
        if self.mesh is not None:
            if self.kv_layout != "paged":
                raise ValueError(
                    "mesh sharding is a paged-layout knob; the dense "
                    "layout is the single-device byte-identity oracle"
                )
            names = set(getattr(self.mesh, "mesh_dim_names", None) or ())
            if not {"data", "model"} <= names:
                raise ValueError(
                    f"serving mesh needs ('data', 'model') axes, got {sorted(names)}"
                )
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {self.speculate_k}")
        if self.speculate_k:
            if self.kv_layout != "paged":
                raise ValueError(
                    "speculate_k > 0 drafts through the paged block pool; the "
                    "dense layout is the plain-decode byte-identity oracle and "
                    "cannot speculate"
                )
            if self.speculate_k >= self.max_new_tokens:
                # a draft run as long as the whole decode budget amortizes
                # nothing: it would overrun the budget on its first round
                raise ValueError(
                    f"speculate_k={self.speculate_k} must be < the decode budget "
                    f"max_new_tokens={self.max_new_tokens}"
                )
        if self.device_backend not in BK.BACKENDS:
            raise ValueError(
                f"unknown device_backend {self.device_backend!r}; "
                f"registered: {sorted(BK.BACKENDS)}"
            )
        faulty = BK.BACKENDS[self.device_backend].overrides_compute
        if faulty and self.kv_layout != "paged":
            raise ValueError(
                f"device_backend={self.device_backend!r} overrides compute and "
                "needs the paged engine's rebuild/degradation loop; the dense "
                "layout is the healthy byte-identity oracle"
            )
        if self.device_fault_config is not None and not faulty:
            raise ValueError(
                "device_fault_config is only meaningful with a fault backend "
                f"(e.g. 'sim_faulty'); device_backend={self.device_backend!r} "
                "would silently ignore it"
            )
        if self.n_redundant_reads < 1:
            raise ValueError(
                f"n_redundant_reads must be >= 1, got {self.n_redundant_reads}"
            )
        if self.canary_interval < 0:
            raise ValueError(f"canary_interval must be >= 0, got {self.canary_interval}")
        if self.canary_threshold <= 0.0:
            raise ValueError(f"canary_threshold must be > 0, got {self.canary_threshold}")
        if not 0.0 <= self.tile_retire_threshold <= 1.0:
            raise ValueError(
                f"tile_retire_threshold must be in [0, 1], got {self.tile_retire_threshold}"
            )
        if self.degradation is not None:
            pol = self.degradation
            if pol.trip_after < 1 or pol.recover_after < 1:
                raise ValueError(
                    "DegradationPolicy trip_after/recover_after must be >= 1, got "
                    f"{pol.trip_after}/{pol.recover_after}"
                )
            if pol.redundant_reads < 1:
                raise ValueError(
                    f"DegradationPolicy redundant_reads must be >= 1, got {pol.redundant_reads}"
                )
        if self.spill_budget_bytes is not None:
            if self.kv_layout != "paged":
                raise ValueError(
                    "spill_budget_bytes bounds the paged preemption spill store; "
                    "the dense layout never spills"
                )
            if self.spill_budget_bytes < 0:
                raise ValueError(
                    f"spill_budget_bytes must be >= 0, got {self.spill_budget_bytes}"
                )


@dataclasses.dataclass
class ServingMetrics:
    """Aggregate serving statistics (completed requests only)."""

    completed: int = 0
    total_tokens: int = 0
    wall_time: float = 0.0
    tokens_per_s: float = 0.0
    ttft_mean: float = 0.0       # submit → first generated token, seconds
    ttft_max: float = 0.0
    decode_steps: int = 0
    prefills: int = 0            # bucket prefills actually COMPUTED
    occupancy_mean: float = 0.0  # mean busy-slot fraction per decode step
    decode_time: float = 0.0     # seconds inside batched decode steps only
    prefix_hits: int = 0         # admissions that skipped prefill entirely
    cow_forks: int = 0           # shared blocks forked on first write
    prefix_partial_hits: int = 0  # admissions that mapped SOME prompt blocks
    prefill_tokens: int = 0       # prefill tokens actually computed
    prefill_tokens_saved: int = 0  # prompt tokens skipped via the index
    ttft_p50: float = 0.0
    ttft_p99: float = 0.0
    preemptions: int = 0          # spill-to-host preemptions
    restores: int = 0             # spilled requests re-admitted from their pages
    spill_drops: int = 0          # spill records dropped by the bytes budget
    spec_rounds: int = 0          # fused draft + verify rounds run
    spec_drafted: int = 0         # draft tokens considered by acceptance
    spec_accepted: int = 0        # drafted tokens accepted verbatim
    spec_acceptance: float = 0.0  # accepted / drafted
    spec_tokens_per_round: float = 0.0  # tokens consumed per round
    # done_reason -> count over every finished request
    evictions: dict = dataclasses.field(default_factory=dict)
    # priority class -> {n, ttft_p50_ms, ttft_p99_ms, latency_p50_ms,
    # latency_p99_ms}: the per-class SLO view (latency = submit → done)
    latency_by_class: dict = dataclasses.field(default_factory=dict)
    # the device backend's accounting snapshot: analog event tallies, the
    # shape counts they reconcile against, and the Table I model's energy
    # under RACA and 1-bit-ADC readout (DeviceBackend.snapshot)
    analog: dict = dataclasses.field(default_factory=dict)
    # ---- degraded-device serving ----
    degraded_mode: int = 0        # current DegradationPolicy rung (0..3)
    canary_probes: int = 0        # known-answer probes fired
    canary_failures: int = 0      # probes past canary_threshold
    retired_tiles: int = 0        # crossbar tiles remapped to spares
    redundant_read_events: int = 0  # extra comparator re-reads (priced)
    # every ladder transition: {tick, from, to, why} in firing order
    degraded_transitions: list = dataclasses.field(default_factory=list)

    @property
    def decode_step_ms(self) -> float:
        return self.decode_time * 1e3 / max(self.decode_steps, 1)

    def row(self) -> str:
        out = (
            f"tok_per_s={self.tokens_per_s:.1f} "
            f"ttft_ms={self.ttft_mean * 1e3:.1f} "
            f"ttft_p99_ms={self.ttft_p99 * 1e3:.1f} "
            f"step_ms={self.decode_step_ms:.2f} "
            f"occupancy={self.occupancy_mean:.2f}"
        )
        if self.preemptions or self.restores:
            out += f" preempt={self.preemptions} restore={self.restores}"
        if self.spill_drops:
            out += f" spill_drops={self.spill_drops}"
        if self.spec_rounds:
            out += (
                f" spec_acc={self.spec_acceptance:.2f} "
                f"spec_tok_per_round={self.spec_tokens_per_round:.1f}"
            )
        if self.evictions:
            out += " evict=" + ",".join(
                f"{k}:{v}" for k, v in sorted(self.evictions.items())
            )
        if self.degraded_mode or self.degraded_transitions:
            out += (
                f" degraded={self.degraded_mode}"
                f" transitions={len(self.degraded_transitions)}"
            )
        if self.canary_probes:
            out += f" canary={self.canary_failures}/{self.canary_probes}"
        if self.retired_tiles:
            out += f" retired_tiles={self.retired_tiles}"
        if self.redundant_read_events:
            out += f" redundant_reads={self.redundant_read_events}"
        if self.latency_by_class:
            out += " class=" + ",".join(
                f"{k}:n={v['n']}/p99={v['latency_p99_ms']:.0f}ms"
                for k, v in sorted(self.latency_by_class.items())
            )
        if self.analog:
            out += (
                f" raca_pj_per_tok={self.analog['raca']['energy_pj_per_token']:.0f}"
                f" adc1b_pj_per_tok={self.analog['adc1b']['energy_pj_per_token']:.0f}"
            )
        return out


def _refuse_unservable(model_cfg: ModelConfig) -> None:
    """Both engines serve token LMs alone: a family that cannot decode, and
    the encoder-decoder (served by the dense step alone,
    ``specs.make_serve_step``), are refused with the reference's messages."""
    if get_model_fns(model_cfg).prefill is None:
        raise ValueError(f"family {model_cfg.family!r} cannot decode")
    if model_cfg.family == "encdec":
        raise ValueError("encdec serving needs frames; token-LM only")


class ServingEngine:
    """Continuous-batching engine over the paged pool or the dense cache
    (greedy or WTA sampling)."""

    def __init__(self, params, model_cfg: ModelConfig, cfg: ServeConfig, device=None, *,
                 graphs: Optional[bool] = None):
        """``graphs``: capture the decode step as CUDA graphs; ``None`` means
        on when the device is CUDA, ``False`` runs it eagerly there.
        Families it cannot serve are refused (:func:`_refuse_unservable`)."""
        _refuse_unservable(model_cfg)
        cfg.validate(model_cfg.kv_cache_dtype)
        self.device = resolve_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        elif graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, the engine is on {self.device}")
        if params["embed"]["embedding"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embed']['embedding'].device}, "
                f"the engine on {self.device}"
            )
        self.paged = cfg.kv_layout == "paged"
        self.int8 = self.paged and model_cfg.kv_cache_dtype == "int8"
        self.sharing = self.paged and cfg.enable_prefix_sharing
        self.params = params
        self.mcfg = model_cfg
        self.cfg = cfg
        self.sched = Scheduler(cfg.max_batch)
        b = cfg.max_batch
        self.blocks = None
        if self.paged:
            self._max_blocks = cfg.max_kv_blocks()
            self.blocks = BlockAllocator(
                cfg.pool_blocks(model_cfg.kv_cache_dtype), n_reserved=1
            )
            # host-authoritative block table; row = trash page 0 when free
            self._table = np.zeros((b, self._max_blocks), np.int32)
            # host mirror of cache["pos"] (drives the decode window width)
            self._host_pos = np.zeros((b,), np.int64)
        # a recurrent or ssm family resumes a partial prefix hit only at a
        # chunk boundary whose state snapshot is stashed in the prefix
        # index; an attention-only family resumes at any matched block
        self._stateful = any(k in ("rec", "ssm") for k in model_cfg.layer_pattern)
        # private device backend: analog-event accounting for THIS
        # engine's traffic; a compute-overriding one (sim_faulty) is also
        # installed process-wide around each tick
        fault_kw = {}
        if cfg.device_fault_config is not None:
            fault_kw["fault"] = cfg.device_fault_config
        self.backend = BK.make_backend(cfg.device_backend, model_cfg, **fault_kw)
        # base WTA redundant-read factor (a greedy argmax re-read can never
        # change the token)
        self._redundant_base = cfg.n_redundant_reads if model_cfg.wta_head else 1
        self.spec_k = cfg.speculate_k if self.paged else 0
        self.mesh = cfg.mesh if self.paged else None
        self._rows = None   # this rank's slots on a serving mesh
        if self.mesh is not None:
            # the parameters, replicated on the mesh, placed once here
            self._shardings = self._sharded_entry_points()["shardings"]
            self.params = _place_tree(params, self._shardings["params"])
            self._rows = PX.local_slices(self._shardings["slot_vec"], (b,))[0]
            if graphs and any(n > 1 for n in self.mesh.shape):
                # a collective inside a captured graph is not worth its risk
                graphs = False
        # the cache exists before the decode step is first captured, and
        # never moves: the graphs hold its addresses
        self._cache = self._init_cache()
        self._graphs = graphs
        self._rebuilds = 0
        self._dropped_captures: list[tuple[int, tuple[int, int], float]] = []
        self._build_entry_points()
        # rid -> admission plan built by the gate (block hashes, resume
        # depth, full-hit flag); consumed by _admit_one
        self._plans: dict[int, dict] = {}
        # rid -> (block hashes, int8 block seeds): a back-pressured queue
        # head is re-gated every tick, so only the index lookups rerun
        self._hash_memo: dict[int, list] = {}
        # rid -> in-flight chunked-prefill job, processed FIFO (the order
        # that guarantees a sharer's source pages are written before its
        # first chunk runs)
        self._jobs: dict[int, dict] = {}
        self._job_fifo: list[int] = []
        # rid -> spill record of a preempted request (torch CPU copies of
        # its pages and per-slot leaves, its decode counters); insertion
        # order is the drop order under spill_budget_bytes
        self._spill: dict[int, dict] = {}
        self._spill_bytes = 0
        # rid -> published tokens a recompute-restored request teacher-
        # forces through decode instead of recording them again
        self._replay: dict[int, list[int]] = {}
        self._preemptions = 0
        self._restores = 0
        self._spill_drops = 0
        self._spec_rounds = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_emitted = 0
        self._tokens = np.zeros((b,), np.int32)   # last emitted, per slot
        # WTA sampling: per-request keys fold_in(base, rid), set at
        # admission, and tokens emitted per slot (folded into the key)
        self._base_key = R.PRNGKey(cfg.seed)
        self._req_keys = np.zeros((b, 2), np.int64)
        self._steps = np.zeros((b,), np.int64)
        self._ticks = 0
        self._occ_sum = 0.0
        self._decode_steps = 0
        self._prefills = 0
        self._prefix_hits = 0
        self._cow_forks = 0
        self._prefix_partial_hits = 0
        self._prefill_tokens = 0
        self._prefill_tokens_saved = 0
        self._total_tokens = 0
        self._busy_time = 0.0
        self._decode_time = 0.0
        self._injector = cfg.fault_injector if self.paged else None
        # ---- degraded-device serving state ----
        self._degrade_level = 0
        self._dirty_streak = 0       # consecutive ticks with detections
        self._clean_streak = 0       # consecutive clean canary passes
        self._degraded_transitions: list[dict] = []
        self._canary_probes = 0
        self._canary_failures = 0
        self._tick_dirty = 0         # detection events in the current tick
        self._tick_canary: Optional[bool] = None
        self._canary_expected = KOPS.canary_expected() if cfg.canary_interval else None

    def _get_serve_step(self, n_redundant: int) -> SP.DecodeGraphs:
        """The compiled decode step at redundant-read factor R, one per R
        (raising R under degradation captures its own graphs once per
        window width; dropping back reuses the healthy ones)."""
        step = self._serve_steps.get(n_redundant)
        if step is None:
            sharded = (self._sharded_entry_points(n_redundant)["serve_step"]
                       if self.mesh is not None else None)
            step = self._serve_steps[n_redundant] = SP.DecodeGraphs(
                self.mcfg, self.params, self._cache, n_redundant=n_redundant,
                capture=self._graphs, sat_threshold=self.cfg.logit_sat_threshold,
                entropy_floor=self.cfg.logit_entropy_floor, step=sharded, rows=self._rows,
            )
        return step

    def _sharded_entry_points(self, n_redundant: Optional[int] = None) -> dict:
        """``specs.make_sharded_paged_entry_points`` on this engine's mesh, at
        ``n_redundant`` reads (the base factor by default)."""
        cfg = self.cfg
        return SP.make_sharded_paged_entry_points(
            self.mcfg, self.mesh, batch=cfg.max_batch,
            n_pages=cfg.pool_blocks(self.mcfg.kv_cache_dtype), block_size=cfg.kv_block_size,
            speculate_k=self.spec_k, sat_threshold=cfg.logit_sat_threshold,
            entropy_floor=cfg.logit_entropy_floor,
            n_redundant=self._redundant_base if n_redundant is None else n_redundant,
        )

    def _build_entry_points(self) -> None:
        """(Re)build every entry point: at construction, and whenever the
        device backend's ``fault_version`` moves.  A captured decode graph
        replays the kernel arguments of its capture (the comparator point,
        faulty weights), so a rebuild drops every graph, which releases
        their memory pools, and the next tick captures again.  The eager
        entry points are rebuilt too, so :meth:`compile_counts` restarts as
        the reference's new jitted functions do.  The speculative round's
        graphs (:class:`specs.SpecGraphs`) are dropped and recaptured the same
        way."""
        self._dropped_captures += [(self._rebuilds, k, ms) for k, ms in self._live_captures()]
        self._serve_steps: dict[int, SP.DecodeGraphs] = {}
        self._spec_graphs = None
        self._fault_version_seen = getattr(self.backend, "fault_version", 0)
        if not self.paged:
            # the dense step (one graph per batch width: the engine's is
            # max_batch), the monolithic prefill and the slot insert
            self._decode = SP.DenseGraphs(self.mcfg, self.params,
                                          {self.cfg.max_batch: self._cache},
                                          capture=self._graphs)
            self._serve_steps = {1: self._decode}
            self._prefill = SP.EagerEntry(self._make_prefill())
            self._insert = SP.EagerEntry(SP.make_cache_insert(self.mcfg))
            return
        self._decode = self._get_serve_step(self._redundant_base)
        if self.mesh is not None:
            # the same entry points on the mesh (pool pages over data, kv
            # heads over model, per-slot inputs over data, parameters
            # replicated); the compile discipline is the unsharded one
            eps = self._sharded_entry_points()
        else:
            eps = {"suffix_prefill": SP.make_paged_suffix_prefill(self.mcfg),
                   "state_insert": SP.make_paged_state_insert(self.mcfg),
                   "page_copy": SP.make_page_copy(self.mcfg),
                   "page_spill": SP.make_page_spill(self.mcfg),
                   "page_restore": SP.make_page_restore(self.mcfg),
                   "state_gather": SP.make_slot_state_gather(self.mcfg)}
            if self.spec_k:
                eps["spec_round"] = None
                eps["spec_rollback"] = SP.make_spec_rollback(self.mcfg)
        if self.spec_k:
            self._spec_graphs = SP.SpecGraphs(self.mcfg, self.params, self._cache,
                                              k=self.spec_k, capture=self._graphs,
                                              round=eps["spec_round"], rows=self._rows)
            # the round as the engine calls it (a test may wrap it)
            self._spec_round = self._spec_graphs
            self._spec_rollback = SP.EagerEntry(eps["spec_rollback"])
        self._suffix_prefill = SP.EagerEntry(eps["suffix_prefill"], static=("bucket",))
        self._state_insert = SP.EagerEntry(eps["state_insert"])
        self._page_copy = SP.EagerEntry(eps["page_copy"])
        self._sample0 = SP.EagerEntry(SP.make_sample0(self.mcfg))
        self._page_spill = SP.EagerEntry(eps["page_spill"])
        self._page_restore = SP.EagerEntry(eps["page_restore"])
        self._state_gather = SP.EagerEntry(eps["state_gather"])

    def _make_prefill(self):
        """The dense layout's monolithic one-request prefill: (params,
        tokens (1, L), key pair) → (cache (B=1), first token (1,)), the
        first token sampled as :func:`specs.make_sample0` samples it (the
        paged layout's prefill is the chunked ``_suffix_prefill``)."""
        cfg, max_len = self.mcfg, self.cfg.max_len
        sample0 = SP.make_sample0(cfg)

        def prefill(params, tokens, key):
            cache, logits = TF.lm_prefill(params, tokens, cfg, max_len)
            return cache, sample0(logits, key)

        return prefill

    def _check_fault_version(self) -> None:
        """Rebuild stale entry points after a backend fault-state change
        (drift bucket, retirement, degrade/recover)."""
        v = getattr(self.backend, "fault_version", None)
        if v is not None and v != self._fault_version_seen:
            self._build_entry_points()
            self._rebuilds += 1

    def _live_captures(self) -> list[tuple[tuple, float]]:
        graphs = list(getattr(self, "_serve_steps", {}).values())
        if getattr(self, "_spec_graphs", None) is not None:
            graphs.append(self._spec_graphs)
        return [c for g in graphs for c in g.captures()]

    def capture_log(self) -> list[tuple[int, tuple, float]]:
        """(build generation, key, capture ms) of every graph this engine
        has captured, those dropped by a rebuild included: the key is (W, R)
        for a decode step, ("spec", W, k) for a speculative round;
        generation g was captured after g rebuilds."""
        return self._dropped_captures + [(self._rebuilds, k, ms)
                                         for k, ms in self._live_captures()]

    # -- request API --------------------------------------------------------

    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: Optional[int] = None,
               priority: int = 1, deadline_ms: Optional[float] = None) -> int:
        """Queue a request; returns its request id.  ``priority`` is its
        scheduling class (lower is more urgent: 0 interactive overtakes 1
        batch at admission and may preempt it, and level 3 of the
        degradation ladder sheds the less urgent ones).  ``deadline_ms`` is
        a completion limit from now: past it the deadline pass evicts the
        request with reason ``"deadline"``, whatever state it is in."""
        n = len(prompt_tokens)
        if n == 0:
            raise ValueError(
                "empty prompt: at least one prompt token is required "
                "(decoding seeds from the last prompt token's logits)"
            )
        if n > max(self.cfg.buckets()):
            raise ValueError(
                f"prompt length {n} exceeds largest prefill bucket "
                f"{max(self.cfg.buckets())}"
            )
        if deadline_ms is not None and self.mesh is not None and self.mesh.size() > 1:
            # each rank would expire it on its own clock: their bookkeeping
            # would part, and their collectives with it
            raise ValueError("deadline_ms reads each rank's clock; a serving mesh wider than "
                             "one rank takes no deadlines")
        budget = self.cfg.max_new_tokens if max_new_tokens is None else max_new_tokens
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
        need = self._bucket(n) + budget
        if need > self.cfg.max_len:
            raise ValueError(
                f"prefill bucket {self._bucket(n)} + {budget} new tokens "
                f"= {need} exceeds cache max_len={self.cfg.max_len}"
            )
        if self.paged:
            nb = self._blocks_needed(self._bucket(n), budget)
            if nb > self.blocks.capacity:
                raise ValueError(
                    f"request needs {nb} KV blocks but the pool only has "
                    f"{self.blocks.capacity}; raise num_kv_blocks"
                )
        return self.sched.submit(prompt_tokens, budget, now=time.perf_counter(),
                                 priority=priority, deadline_ms=deadline_ms).rid

    def _bucket(self, n: int) -> int:
        return next(b for b in self.cfg.buckets() if b >= n)

    def _blocks_needed(self, bucket: int, budget: int) -> int:
        """Whole-lifetime block budget: prefill window + decode tokens."""
        return -(-(bucket + budget) // self.cfg.kv_block_size)

    def _init_cache(self) -> dict:
        if not self.paged:
            return SP.init_decode_cache(self.mcfg, self.cfg.max_batch, self.cfg.max_len,
                                        device=self.device)
        args = (self.mcfg, self.cfg.max_batch, self.cfg.pool_blocks(self.mcfg.kv_cache_dtype),
                self.cfg.kv_block_size)
        if self.mesh is not None:
            # placed sharded from the start: each rank allocates its shard
            return SP.init_sharded_paged_decode_cache(args[0], self._shardings["cache"],
                                                      *args[1:], device=self.device)
        return SP.init_paged_decode_cache(*args, device=self.device)

    def _put(self, x: np.ndarray) -> torch.Tensor:
        """Host → device copy of a per-tick input (never a view of host
        state the engine later mutates, even on the CPU)."""
        return torch.tensor(x, device=self.device)

    def _chunk_tokens(self, bucket: int) -> int:
        """The prefill chunk grid for ``bucket`` (0 → whole bucket)."""
        return min(self.cfg.prefill_chunk or bucket, bucket)

    def _resume_tokens(self, n_matched: int, bucket: int) -> int:
        """How many prompt tokens a partial hit of ``n_matched`` blocks
        skips.  An attention-only family resumes at the matched depth (a
        suffix position's hidden state is a function of its token and the
        K/V it attends).  A recurrent family also needs the carried state,
        which the chunked prefill stashes at chunk boundaries only, so
        the depth rounds down to the chunk grid (every registrant shares
        the grid, and jobs run FIFO, so a grid-boundary block carries its
        snapshot by the time this request's first chunk runs)."""
        p = n_matched * self.cfg.kv_block_size
        if not self._stateful:
            return p
        grid = self._chunk_tokens(bucket)
        return (p // grid) * grid

    def _try_reserve_blocks(self, req: Request) -> bool:
        """Admission gate: reserve the request's whole block budget, or
        refuse and leave the allocator untouched.

        With prefix sharing the gate maps the deepest resident chain hit
        into the request's table, reserves one spare COW page for a full
        hit ending in a partial boundary block (the request WILL write
        there at its first decode token), and registers the request's own
        fresh prompt blocks at once so same-tick duplicates already share;
        their content lands later, chunk by chunk, which is safe because
        prefill jobs run FIFO."""
        bucket = self._bucket(len(req.prompt))
        nb_total = self._blocks_needed(bucket, req.max_new_tokens)
        bs = self.cfg.kv_block_size
        n_prompt = -(-bucket // bs)
        plan: dict = {
            "full_hit": False, "hashes": None, "seeds": None,
            "n_prompt": n_prompt, "n_shared": 0, "resume": 0, "bucket": bucket,
        }
        shared: list[int] = []
        if self.sharing or self.int8:
            memo = self._hash_memo.get(req.rid)
            if memo is None:
                hashes = prefix_block_hashes(left_pad(req.prompt, bucket), bs)
                # canonical int8 rounding seeds: content-derived per block,
                # so identical prefixes re-quantize to identical codes
                memo = (hashes, np.asarray([sd for _, sd in hashes], np.int64))
                self._hash_memo[req.rid] = memo
            plan["hashes"], plan["seeds"] = memo
        rec = self._spill.get(req.rid)
        if rec is not None:
            return self._gate_restore(req, plan, rec, nb_total)
        if self.sharing:
            shared = self.blocks.longest_prefix_match([h for h, _ in plan["hashes"]])
        full = len(shared) == n_prompt
        n_spare = 1 if (full and bucket % bs != 0) else 0
        n_new = nb_total - len(shared)
        if not self.blocks.can_alloc(n_new + n_spare):
            return False
        pages = self.blocks.reserve(req.rid, n_new, shared, n_spare)
        if self.sharing:
            for i in range(len(shared), n_prompt):
                self.blocks.register(pages[i], plan["hashes"][i][0])
            plan["full_hit"] = full
            plan["n_shared"] = len(shared)
            if not full:
                plan["resume"] = self._resume_tokens(len(shared), bucket)
        self._plans[req.rid] = plan
        return True

    def _gate_restore(self, req: Request, plan: dict, rec: dict, nb_total: int) -> bool:
        """Admission gate for a spilled request, atomic as the fresh one.
        The prefix probe stops at the pristine prompt blocks: once a decode
        step wrote into an unaligned boundary block (``rec["dirty"]``) its
        content left its chain hash, and its spilled copy must come back.
        Fresh pristine blocks register again unless an identical prompt
        registered them meanwhile."""
        bucket, bs = plan["bucket"], self.cfg.kv_block_size
        n_prompt = plan["n_prompt"]
        n_clean = n_prompt - 1 if rec["dirty"] else n_prompt
        shared: list[int] = []
        if self.sharing:
            shared = self.blocks.longest_prefix_match([h for h, _ in plan["hashes"]][:n_clean])
        # an undirtied full match of an unaligned prompt writes its shared
        # boundary block at the first decode step: the fresh gate's spare
        n_spare = 1 if (len(shared) == n_prompt and bucket % bs != 0) else 0
        n_new = nb_total - len(shared)
        if not self.blocks.can_alloc(n_new + n_spare):
            return False
        pages = self.blocks.reserve(req.rid, n_new, shared, n_spare)
        if self.sharing:
            for i in range(len(shared), n_clean):
                if self.blocks.lookup(plan["hashes"][i][0]) is None:
                    self.blocks.register(pages[i], plan["hashes"][i][0])
            plan["n_shared"] = len(shared)
        plan["restore"] = True
        self._plans[req.rid] = plan
        return True

    def _release_if_done(self, req: Request) -> None:
        """Reclaim an evicted request's blocks and point its slot's table
        row at the trash page (the batched decode step keeps running).
        The dense layout has nothing to reclaim: the next admission's
        insert overwrites the slot's whole window."""
        if not (self.paged and req.state is RequestState.DONE):
            return
        self.blocks.free(req.rid)
        self._table[req.done_slot, :] = 0

    def _admit_one(self, req: Request) -> None:
        """Bind an admitted request to its slot.  Dense: the monolithic
        prefill, the slot insert, the first token; decode starts at once.
        Paged: enqueue a chunked-prefill job; its table row stays on the
        trash page until the job completes, so the batched decode steps of
        the other slots never touch it."""
        plen = self._bucket(len(req.prompt))
        rkey = R.fold_in(self._base_key, req.rid)
        self._req_keys[req.slot] = rkey
        if not self.paged:
            toks = torch.tensor([left_pad(req.prompt, plen)], dtype=torch.int32,
                                device=self.device)
            one_cache, tok0 = self._prefill(self.params, toks, rkey)
            self._cache = self._insert(self._cache, one_cache, req.slot)
            self._prefills += 1
            self._prefill_tokens += plen
            # the monolithic prefill forwards the whole padded bucket and
            # samples the first token in the same call
            self.backend.note_call(SP.analog_call_profile("suffix_prefill", tokens=plen))
            self.backend.note_call(SP.analog_call_profile("sample0"))
            self._finish_admission(req, tok0)
            return
        plan = self._plans.pop(req.rid)
        self._hash_memo.pop(req.rid, None)
        if plan.get("restore"):
            self._restore_one(req, plan)
            return
        pages = self.blocks.owned(req.rid)  # reserved by the gate
        row = np.zeros((self._max_blocks,), np.int32)
        row[: len(pages)] = pages
        if plan["full_hit"]:
            # stash the terminal payload now if it exists: the registrant
            # may diverge its partial boundary block (dropping the entry
            # and payload) before this job reaches the FIFO head.  A
            # logits-less payload is a chunk-boundary snapshot of a longer
            # prompt, not a terminal one.
            payload = self.blocks.payload(plan["hashes"][-1][0])
            plan["payload"] = (
                payload if payload is not None and payload[0] is not None else None
            )
        elif plan["n_shared"] > 0:
            self._prefix_partial_hits += 1
            self._prefill_tokens_saved += plan["resume"]
        self._jobs[req.rid] = {
            "req": req,
            "row": row,
            "plan": plan,
            "q0": plen if plan["full_hit"] else plan["resume"],
            "bucket": plen,
            "state": None,
            "tokens": left_pad(req.prompt, plen),
            "rkey": rkey,
        }
        self._job_fifo.append(req.rid)

    def _restore_one(self, req: Request, plan: dict) -> None:
        """Re-bind a spilled request to its new slot, byte-exactly: shared
        prefix pages came back through the gate as index hits, the rest of
        its used pages come back from the record at the new pages (the
        fixed-width ids point everything else at the trash page), and the
        per-slot leaves, table row, position, last token and step counter
        are put back verbatim.  Its key is ``fold_in(base, rid)`` and its
        WTA noise a function of (key, step), so the rest of its stream is
        the unpreempted one.  No token is recorded here."""
        rec = self._pop_spill(req.rid)
        slot = req.slot
        pages = self.blocks.owned(req.rid)
        row = np.zeros((self._max_blocks,), np.int32)
        row[: len(pages)] = pages
        ids = np.zeros((self._max_blocks,), np.int32)
        n_shared = plan["n_shared"]
        ids[n_shared : rec["n_used"]] = row[n_shared : rec["n_used"]]
        self._cache = self._page_restore(self._cache, self._put(ids), self._to_device(rec["pages"]))
        self._cache = self._state_insert(self._cache, self._to_device(rec["state"]), slot)
        self._table[slot] = row
        self._host_pos[slot] = rec["pos"]
        self._tokens[slot] = rec["token"]
        self._steps[slot] = rec["steps"]
        self.sched.start_decode(req)
        self._restores += 1

    def _to_device(self, leaves: dict) -> dict:
        return {k: v.to(self.device) for k, v in leaves.items()}

    def _finish_admission(self, req: Request, tok0: torch.Tensor) -> None:
        """First token, decode start, bookkeeping."""
        slot = req.slot
        self.sched.start_decode(req)
        rep = self._replay.get(req.rid)
        if rep:
            # recompute-restore of a dropped spill record: its first tokens
            # were published before the preemption, so decode starts from
            # the recorded first token (bitwise what tok0 resampled) and
            # the ticks teacher-force the rest; nothing records again
            self._tokens[slot] = rep.pop(0)
            if not rep:
                del self._replay[req.rid]
            self._steps[slot] = 1
            return
        t0 = int(tok0[0])  # waits for the prefill: TTFT stamps after it
        self._tokens[slot] = t0
        self._steps[slot] = 1
        self._total_tokens += 1
        self.sched.record_token(req, t0, self.cfg.eos_token, time.perf_counter())
        self._release_if_done(req)  # budget=1 or instant EOS

    def _complete_job(self, rid: int, job: dict, tok0: torch.Tensor) -> None:
        """Publish the job's real table row, mirror its position, decode."""
        req = job["req"]
        self._table[req.slot] = job["row"]
        self._host_pos[req.slot] = job["bucket"]
        self._job_fifo.pop(0)
        del self._jobs[rid]
        self._finish_admission(req, tok0)

    def _resume_state(self, plan: dict, q0: int) -> dict:
        """The state entering a job's first computed chunk: zeroed for a
        cold start or an attention-only family, else the boundary snapshot
        stashed on the block that ends at ``q0`` (raises if it is
        missing: the resume grid guarantees it)."""
        if q0 == 0 or not self._stateful:
            return TF.init_prefill_state(self.mcfg, self.device)
        payload = self.blocks.payload(plan["hashes"][q0 // self.cfg.kv_block_size - 1][0])
        if payload is None:
            raise RuntimeError("missing boundary-state snapshot for a grid-aligned resume")
        return payload[1]

    # -- preemption and eviction --------------------------------------------

    @staticmethod
    def _spill_nbytes(rec: dict) -> int:
        """Host bytes a spill record holds: its pages and per-slot leaves
        (the counters are noise), at the pool's dtype."""
        return sum(t.numel() * t.element_size()
                   for t in (*rec["pages"].values(), *rec["state"].values()))

    def _pop_spill(self, rid: int) -> Optional[dict]:
        """Remove a spill record (restore, cancel), keeping the byte count
        exact; None if it was never stored or the budget dropped it."""
        rec = self._spill.pop(rid, None)
        if rec is not None:
            self._spill_bytes -= self._spill_nbytes(rec)
        return rec

    def _store_spill(self, rid: int, rec: dict) -> None:
        """Insert a spill record, then hold ``spill_budget_bytes``: over it
        the oldest records drop first (insertion order; a record is touched
        again only when popped), the new one included.  A dropped record's
        request re-admits through the fresh gate, recomputes its prompt,
        and its published tokens move to ``_replay``, which decode
        teacher-forces back without publishing anything again."""
        self._spill[rid] = rec
        self._spill_bytes += self._spill_nbytes(rec)
        budget = self.cfg.spill_budget_bytes
        if budget is None:
            return
        while self._spill and self._spill_bytes > budget:
            old_rid = next(iter(self._spill))
            old = self._pop_spill(old_rid)
            self._replay[old_rid] = list(old["replay"])
            self._spill_drops += 1

    def _preempt(self, req: Request) -> None:
        """Spill a decoding request to the host-side store and requeue it.

        Its used pages (``ceil(pos / block_size)``, padded with the trash
        page to the table width: one spill signature ever) and per-slot
        leaves are copied to host tensors, outside any capture (the copy's
        sync orders it after the last replay), with its decode counters;
        then its whole reservation is released, shared prefix pages
        surviving for their other owners, and the scheduler requeues it at
        the head of its class."""
        slot, rid = req.slot, req.rid
        pages = self.blocks.owned(rid)
        pos = int(self._host_pos[slot])
        bs = self.cfg.kv_block_size
        bucket = self._bucket(len(req.prompt))
        n_used = -(-pos // bs)
        ids = np.zeros((self._max_blocks,), np.int32)
        ids[:n_used] = pages[:n_used]
        self._store_spill(rid, {
            "bucket": bucket,
            "n_used": n_used,
            "pos": pos,
            # a decode write into an unaligned boundary prompt block moved
            # its content off the chain hash: no pristine index hit there
            "dirty": bucket % bs != 0 and pos > bucket,
            "pages": _to_host(self._page_spill(self._cache, self._put(ids))),
            "state": _to_host(self._state_gather(self._cache, slot)),
            "token": int(self._tokens[slot]),
            "steps": int(self._steps[slot]),
            # published so far: the replay if the budget drops this record
            "replay": list(req.output),
        })
        self.blocks.free(rid)
        self._table[slot, :] = 0
        self.sched.requeue(req)
        self._preemptions += 1

    def _preempt_pass(self) -> None:
        """After admission: while the most urgent queued request outranks a
        decoding one (strictly), spill the weakest (lowest class, then
        newest) and admit again.  Each round takes one slot, so the loop
        ends within ``max_batch`` rounds."""
        while True:
            head = self.sched.peek()
            if head is None:
                return
            victims = [r for r in self.sched.active() if r.priority > head.priority]
            if not victims:
                return
            self._preempt(max(victims, key=lambda r: (r.priority, r.rid)))
            for req in self.sched.admit(self._try_reserve_blocks):
                self._admit_one(req)

    def _evict_request(self, req: Request, reason: str, now: float) -> None:
        """Evict a request in any live state, with a typed reason: a queued
        one leaves the queue (its spill record, if any, with it), a
        prefilling one loses its job and pages (:meth:`_kill_job`), a
        decoding one releases as usual.  A logit-sanity reason is a
        detection event for the degradation policy."""
        if reason in SP.SANITY_REASONS.values():
            self._tick_dirty += 1
        if req.state is RequestState.QUEUED:
            self.sched.cancel(req, reason, now)
            if self.paged:
                self._hash_memo.pop(req.rid, None)
                self._pop_spill(req.rid)
                self._replay.pop(req.rid, None)
        elif req.state is RequestState.PREFILL:
            if self.paged:
                self._kill_job(req)
            self.sched.evict(req, reason, now)
            if self.paged:
                self._table[req.done_slot, :] = 0
        elif req.state is RequestState.DECODE:
            self.sched.evict(req, reason, now)
            self._release_if_done(req)

    def _kill_job(self, req: Request) -> None:
        """Drop an in-flight prefill job and free its pages.  Its registered
        prompt blocks whose content never finished landing are deregistered
        first; any of them still mapped by a job queued behind it (they
        mapped it at their gate, trusting FIFO order to fill it) demotes
        that job to recompute from below its first such page.  Jobs ahead
        in the FIFO and decoding requests cannot map these pages."""
        rid = req.rid
        job = self._jobs.pop(rid)
        self._job_fifo.remove(rid)
        plan = job["plan"]
        garbage: set[int] = set()
        if self.sharing:
            bs = self.cfg.kv_block_size
            for i in range(plan["n_shared"], plan["n_prompt"]):
                if job["q0"] < min((i + 1) * bs, job["bucket"]):
                    page = int(job["row"][i])
                    self.blocks.deregister(page)
                    garbage.add(page)
        self.blocks.free(rid)
        garbage = {p for p in garbage if self.blocks.refcount(p) > 0}
        for orid in self._job_fifo:
            self._demote_job_for_garbage(self._jobs[orid], garbage)

    def _demote_job_for_garbage(self, job: dict, garbage: set) -> None:
        """Lower a queued job's resume point below its first garbage page;
        it rewrites those pages itself with the bits the dead writer would
        have written (int8 seeds derive from block content).  Only the FIFO
        head advances ``q0``, so a demoted job has computed nothing yet.  A
        recurrent family also walks down the chunk grid to the deepest
        boundary whose state snapshot is still stashed."""
        if not garbage:
            return
        plan = job["plan"]
        bs = self.cfg.kv_block_size
        frontier = min(-(-job["q0"] // bs), plan["n_prompt"])
        bad = next((i for i in range(frontier) if int(job["row"][i]) in garbage), None)
        if bad is None:
            return
        q0 = bad * bs
        if self._stateful:
            grid = self._chunk_tokens(job["bucket"])
            q0 = (q0 // grid) * grid
            while q0 > 0 and self.blocks.payload(plan["hashes"][q0 // bs - 1][0]) is None:
                q0 -= grid
        plan["full_hit"] = False
        job["q0"] = q0
        job["state"] = None

    def _nan_payload(self) -> dict:
        """A restore payload whose row 0 is NaN in every float pool leaf (an
        int8 pool's scale planes: its dequant is ``code · scale``).  The
        other rows are zeros, scattered into the trash page by the
        fixed-width ids: a NaN trash page would poison every slot, since a
        masked weight of 0 times NaN is NaN on the V side.  The spill
        payload's shapes and dtypes, so the restore keeps one signature.
        A model without attention (mamba2) has no pool leaf: the payload is
        empty, as the reference's is."""
        out = {}
        for name in SP.PAGE_POOL_LEAVES:
            if name in self._cache:
                leaf = self._cache[name]
                shape = list(leaf.shape)
                shape[2] = self._max_blocks
                rows = torch.zeros(shape, dtype=leaf.dtype, device=self.device)
                if leaf.dtype.is_floating_point:
                    rows[:, :, 0] = float("nan")
                out[name] = rows
        return out

    def _poison_nan(self, req: Request) -> bool:
        """Overwrite one of ``req``'s private read-window pages with NaNs
        (the ``nan_logits`` fault): its next decode step's logits are not
        finite and the sanity check evicts it with reason ``"nan"``.  Only
        a page of refcount 1 is poisoned, deregistered first as a real
        divergence would be; False when the request has none in its read
        window yet.  Without a pool (mamba2) the page is deregistered and
        nothing is written, so the logits stay finite and the request runs
        to its end: the reference's engine does the same."""
        slot, rid = req.slot, req.rid
        pages = self.blocks.owned(rid)
        n_read = max(1, -(-int(self._host_pos[slot]) // self.cfg.kv_block_size))
        target = next((i for i in reversed(range(min(n_read, len(pages))))
                       if self.blocks.refcount(pages[i]) == 1), None)
        if target is None:
            return False
        self.blocks.deregister(pages[target])
        ids = np.zeros((self._max_blocks,), np.int32)
        ids[0] = pages[target]
        self._cache = self._page_restore(self._cache, self._put(ids), self._nan_payload())
        return True

    def _prefill_tick(self, emitted: list[tuple[int, int]]) -> None:
        """Advance the chunked-prefill pipeline by at most one compute chunk
        (≤ ``prefill_chunk`` tokens), completing any number of zero-compute
        full hits along the way.  Jobs run strictly FIFO."""
        computed = False
        bs = self.cfg.kv_block_size
        while self._job_fifo:
            rid = self._job_fifo[0]
            job = self._jobs[rid]
            req, plan = job["req"], job["plan"]
            bucket = job["bucket"]
            if plan["full_hit"]:
                payload = plan.get("payload") or self.blocks.payload(
                    plan["hashes"][-1][0]
                )
                if payload is not None and payload[0] is not None:
                    logits, state = payload
                    self._cache = self._state_insert(self._cache, state, req.slot)
                    tok0 = self._sample0(logits, job["rkey"])
                    self.backend.note_call(SP.analog_call_profile("sample0"))
                    self._prefix_hits += 1
                    self._prefill_tokens_saved += bucket
                    self._complete_job(rid, job, tok0)
                    emitted.append((rid, req.output[-1]))
                    continue
                # no usable terminal payload (the registrant diverged its
                # boundary block while this job waited, or the hash only
                # carried a longer prompt's chunk snapshot): demote to a
                # minimal suffix recompute, block-aligned, or on the chunk
                # grid for a recurrent family
                plan["full_hit"] = False
                grid = self._chunk_tokens(bucket) if self._stateful else bs
                job["q0"] = ((bucket - 1) // grid) * grid
                last = plan["n_prompt"] - 1
                page = int(job["row"][last])
                if (
                    bucket % bs != 0
                    and self.blocks.refcount(page) > 1
                    and self.blocks.spare_count(rid) > 0
                ):
                    # the diverged boundary page carries the registrant's
                    # live decode rows: fork onto the reserved spare.  No
                    # copy is needed, the recompute rewrites every row.
                    _, new = self.blocks.cow_fork(rid, last)
                    job["row"][last] = new
                    self._cow_forks += 1
                self._prefix_partial_hits += 1
                self._prefill_tokens_saved += job["q0"]
            if computed:
                break
            q0 = job["q0"]
            if job["state"] is None:
                job["state"] = self._resume_state(plan, q0)
            grid = self._chunk_tokens(bucket)
            c = min((q0 // grid + 1) * grid, bucket) - q0
            b0, b1 = q0 // bs, -(-(q0 + c) // bs)
            self._cache, job["state"], logits = self._suffix_prefill(
                self.params,
                self._cache,
                job["state"],
                torch.tensor([job["tokens"][q0 : q0 + c]], dtype=torch.int32, device=self.device),
                self._put(job["row"][: plan["n_prompt"]]),
                q0,
                self._put(plan["seeds"][b0:b1]) if self.int8 else None,
                bucket=bucket,
            )
            self._prefill_tokens += c
            self.backend.note_call(SP.analog_call_profile("suffix_prefill", tokens=c))
            job["q0"] = q0 + c
            computed = True
            done = job["q0"] == bucket
            if self.sharing:
                # stash the boundary snapshot on the chunk's last block so
                # later admissions can resume (or, with the final chunk's
                # logits, skip) exactly here
                h_last = plan["hashes"][b1 - 1][0]
                if self.blocks.lookup(h_last) == int(job["row"][b1 - 1]):
                    self.blocks.set_payload(
                        h_last, (logits if done else None, job["state"])
                    )
            if not done:
                break
            self._cache = self._state_insert(self._cache, job["state"], req.slot)
            tok0 = self._sample0(logits, job["rkey"])
            self.backend.note_call(SP.analog_call_profile("sample0"))
            self._prefills += 1
            self._complete_job(rid, job, tok0)
            emitted.append((rid, req.output[-1]))

    def tick(self) -> list[tuple[int, int]]:
        """One engine iteration: fault pass, admit, advance the chunked
        prefill, then one batched decode step for the decoding slots.

        A compute-overriding backend (sim_faulty) is installed
        process-wide for the tick, however it leaves; the degradation
        policy moves once per tick, after detections and the canary.
        Returns the (rid, token) pairs emitted during this tick."""
        ctx = (BK.use_backend(self.backend) if self.backend.overrides_compute
               else contextlib.nullcontext())
        with ctx:
            self._tick_dirty = 0
            self._tick_canary = None
            try:
                return self._tick_inner()
            finally:
                self._policy_update()

    def _tick_inner(self) -> list[tuple[int, int]]:
        t_start = time.perf_counter()
        emitted: list[tuple[int, int]] = []
        if self._injector is not None:
            self._injector.fire(self, self._ticks)
        self._ticks += 1
        if self.paged:
            self._fault_pass()
        # deadline pass: an expired request is evicted in whatever state it
        # is (queued, mid-prefill with its job and pages, or decoding)
        for req in self.sched.expired(time.perf_counter()):
            self._evict_request(req, "deadline", time.perf_counter())
        pol = self.cfg.degradation
        shed = (pol.shed_priority_above
                if pol is not None and self._degrade_level >= 3 else None)
        gate = self._try_reserve_blocks if self.paged else None
        for req in self.sched.admit(gate, shed_priority_above=shed):
            self._admit_one(req)
            if not self.paged:
                emitted.append((req.rid, req.output[-1]))
        if not self.paged:
            self._dense_tick(emitted)
            self._busy_time += time.perf_counter() - t_start
            return emitted
        if self.cfg.enable_preemption:
            self._preempt_pass()
        self._prefill_tick(emitted)
        active = self.sched.active()
        # speculate only when no draft write can pass max_len (near the
        # end of a slot's capacity the tick falls back to plain decode, so
        # a write never clamps into a live block), and below degradation
        # level 1
        spec_now = (bool(active) and self.spec_k > 0 and self._spec_viable(active)
                    and self._degrade_level < 1)
        if active and self.sharing:
            self._cow_pass(active, self.spec_k if spec_now else 1)
        if active and spec_now:
            t_dec = time.perf_counter()
            self._spec_tick(active, emitted)
            self._decode_time += time.perf_counter() - t_dec
        elif active:
            t_dec = time.perf_counter()
            w = self._window_blocks(active)
            r_eff = self._redundant_effective()
            wta = (self._req_keys, self._steps) if self.mcfg.wta_head else ()
            nxt, sane = self._get_serve_step(r_eff)(self._table[:, :w], self._tokens, *wta)
            # one device sync per step: decode_time is honest, and the
            # outputs are read before the next step can reuse them
            nxt_np, sane_np = torch.stack([nxt, sane]).cpu().numpy()
            self._host_pos += 1  # mirrors the step's pos+1, every slot
            # logical work: one forward, sample and KV write per ACTIVE
            # slot (padding is not work), R - 1 extra re-reads each
            self.backend.note_call(SP.analog_call_profile(
                "serve_step", batch=len(active), redundant=(r_eff - 1) * len(active)))
            now = time.perf_counter()
            self._decode_time += now - t_dec
            self._occ_sum += len(active) / self.cfg.max_batch
            self._decode_steps += 1
            for req in active:
                slot = req.slot
                code = int(sane_np[slot])
                if code:
                    # logit-sanity trip: evict instead of publishing garbage
                    self._evict_request(req, SP.SANITY_REASONS.get(code, "nan"), now)
                    continue
                t = int(nxt_np[slot])
                rep = self._replay.get(req.rid)
                if rep is not None:
                    # teacher-force the next published token (the sampled
                    # one is bitwise the same in a fault-free run); nothing
                    # is recorded or published again
                    self._tokens[slot] = rep.pop(0)
                    if not rep:
                        del self._replay[req.rid]
                    self._steps[slot] += 1
                    continue
                self._tokens[slot] = t
                self._steps[slot] += 1
                self._total_tokens += 1
                self.sched.record_token(req, t, self.cfg.eos_token, now)
                self._release_if_done(req)
                emitted.append((req.rid, t))
        self._busy_time += time.perf_counter() - t_start
        return emitted

    def _dense_tick(self, emitted: list) -> None:
        """One dense decode step for every decoding slot (the reference's
        non-paged branch: one read, no sanity codes).  Every slot decodes
        over its whole window; an idle slot's row is dead weight, as in
        the reference."""
        active = self.sched.active()
        if not active:
            return
        t_dec = time.perf_counter()
        wta = (self._req_keys, self._steps) if self.mcfg.wta_head else ()
        (nxt,) = self._decode(self._tokens, *wta)
        nxt_np = nxt.cpu().numpy()   # one sync a step: decode_time is honest
        self.backend.note_call(SP.analog_call_profile("serve_step", batch=len(active)))
        now = time.perf_counter()
        self._decode_time += now - t_dec
        self._occ_sum += len(active) / self.cfg.max_batch
        self._decode_steps += 1
        for req in active:
            t = int(nxt_np[req.slot])
            self._tokens[req.slot] = t
            self._steps[req.slot] += 1
            self._total_tokens += 1
            self.sched.record_token(req, t, self.cfg.eos_token, now)
            emitted.append((req.rid, t))

    # ---- degraded-device serving: detection, mitigation, policy ----

    def _fault_pass(self) -> None:
        """Per-tick fault housekeeping before any scheduling decision:
        advance the backend's fault clock, rebuild stale entry points, and
        fire the canary on its interval (a failure is a detection event
        and may retire tiles).  The canary reads its answer back to the
        host: one sync per probe, outside any capture."""
        bk = self.backend
        if bk.overrides_compute:
            bk.advance_clock(1)
        self._check_fault_version()
        ci = self.cfg.canary_interval
        if not ci or self._ticks % ci:
            return
        self._canary_probes += 1
        key = R.fold_in(self._base_key, 0xCA9A30 + self._ticks)
        got = KOPS.canary_mac(key, self.device).cpu().numpy()
        exp = self._canary_expected
        scale = max(float(np.max(np.abs(exp))), 1e-9)
        rel = float(np.max(np.abs(got - exp))) / scale
        passed = rel <= self.cfg.canary_threshold
        self._tick_canary = passed
        if passed:
            return
        self._canary_failures += 1
        self._tick_dirty += 1
        thr = self.cfg.tile_retire_threshold
        if thr > 0.0 and hasattr(bk, "retire_tiles") and bk.retire_tiles(thr):
            # retirement changed the stuck masks the graphs were captured with
            self._check_fault_version()

    def _redundant_effective(self) -> int:
        """This tick's redundant-read factor: the config's, raised to the
        policy's at degradation level >= 2 (WTA heads only)."""
        r = self._redundant_base
        pol = self.cfg.degradation
        if pol is not None and self._degrade_level >= 2 and self.mcfg.wta_head:
            r = max(r, pol.redundant_reads)
        return r

    def _degrade_transition(self, to: int, why: str) -> None:
        self._degraded_transitions.append(
            {"tick": self._ticks, "from": self._degrade_level, "to": to, "why": why}
        )
        self._degrade_level = to

    def _policy_update(self) -> None:
        """End-of-tick step of the ladder: fold this tick's detection events
        into the streaks and move at most one rung.  Escalation needs
        ``trip_after`` consecutive dirty ticks; de-escalation
        ``recover_after`` consecutive clean canary passes."""
        pol = self.cfg.degradation
        if pol is None:
            return
        if self._tick_dirty:
            self._dirty_streak += 1
            self._clean_streak = 0
        else:
            self._dirty_streak = 0
            if self._tick_canary is True:
                self._clean_streak += 1
        if self._dirty_streak >= pol.trip_after and self._degrade_level < 3:
            self._degrade_transition(self._degrade_level + 1, "fault_pressure")
            self._dirty_streak = 0
        elif self._clean_streak >= pol.recover_after and self._degrade_level > 0:
            self._degrade_transition(self._degrade_level - 1, "canary_recovered")
            self._clean_streak = 0

    def _spec_viable(self, active: list[Request]) -> bool:
        """True when no decoding slot's k-deep draft can write past
        ``max_len`` (a write past its reservation lands in the trash page,
        but one past the table width would clamp into its last block)."""
        lim = self.cfg.max_len - self.spec_k
        return all(int(self._host_pos[r.slot]) <= lim for r in active)

    def _spec_tick(self, active: list[Request], emitted: list) -> None:
        """One fused speculative round for every decoding slot
        (``repro/serving/engine.py:1930-2050``).

        One call drafts k chained tokens per slot and verifies the run
        read-only (:class:`specs.SpecGraphs`); one sync reads its tokens and
        flags.  Per slot, drafts are accepted until the verify resamples
        otherwise: that resample is published in the draft's place, and it
        is the token a plain tick would emit there wherever the verify's
        rows equal their draft rows bit for bit (on the card cuBLAS may
        round a row otherwise at k·B rows than at B).  A rejected
        or short round rolls the slot's ``pos`` back through the draft's
        per-step states, before anything replays again (``vstates`` lives in
        the graphs' pool); drafted K/V past it stays as masked dead rows.
        The NaN guard is at draft depth: a non-finite draft step cuts the
        usable run, and a slot with nothing usable, or whose every usable
        draft accepted before it, is evicted ``nan`` as a plain tick would
        have.  A recompute-restored request teacher-forces its published
        tokens through the round, truncating it where a forced token
        differs from its draft."""
        k = self.spec_k
        w = self._window_blocks(active, k)
        pre_pos = self._host_pos.copy()
        pre_steps = self._steps.copy()
        wta = (self._req_keys, self._steps) if self.mcfg.wta_head else ()
        dtoks, doks, vtoks, _, vstates = self._spec_round(self._table[:, :w], self._tokens, *wta)
        # one device sync reads the round: decode_time is honest
        d_np, dok_np, v_np = torch.stack([dtoks, doks.to(torch.int32), vtoks]).cpu().numpy()
        # k drafted tokens (forwarded, sampled, written) and k read-only
        # verify positions per active slot; rejected drafts stay counted
        self.backend.note_call(SP.analog_call_profile("spec_round", batch=len(active), k=k))
        self._host_pos += k  # mirrors the draft's k pos bumps, every slot
        now = time.perf_counter()
        self._occ_sum += len(active) / self.cfg.max_batch
        self._decode_steps += 1
        self._spec_rounds += 1
        for req in active:
            slot = req.slot
            # usable drafts stop at the first non-finite draft step
            m = next((j for j in range(k) if not dok_np[slot, j]), k)
            if m == 0:
                self._evict_request(req, "nan", now)
                continue
            self._spec_drafted += m
            req.spec_drafted += m
            req.spec_high = max(req.spec_high, int(pre_pos[slot]) + m - 1)
            e = 0              # inputs consumed from this round
            done = False
            rollback_at = None  # the draft state to roll back to
            for i in range(m):
                t_d = int(d_np[slot, i])
                rep = self._replay.get(req.rid)
                if rep is not None:
                    # teacher-forced replay of published tokens, recorded
                    # nowhere; a forced token that differs from its draft
                    # (only under injected faults) ends the round there
                    forced = rep.pop(0)
                    if not rep:
                        del self._replay[req.rid]
                    self._tokens[slot] = forced
                    e += 1
                    if forced != t_d:
                        rollback_at = i
                        break
                    continue
                t = int(v_np[slot, i])  # the draft, where accepted
                self._tokens[slot] = t
                e += 1
                accepted = t == t_d
                if accepted:
                    self._spec_accepted += 1
                    req.spec_accepted += 1
                self._total_tokens += 1
                done = self.sched.record_token(req, t, self.cfg.eos_token, now)
                emitted.append((req.rid, t))
                if done:
                    break
                if not accepted:
                    rollback_at = i
                    break
            self._spec_emitted += e
            if done:
                self._release_if_done(req)
                continue
            if rollback_at is not None:
                self._cache = self._spec_rollback(self._cache, vstates, rollback_at, slot)
                self._host_pos[slot] = int(pre_pos[slot]) + e
            elif m < k:
                # every usable draft accepted and the next draft step went
                # non-finite from exactly this state: so would a plain tick
                self._evict_request(req, "nan", now)
                continue
            self._steps[slot] = int(pre_steps[slot]) + e

    def _cow_pass(self, active: list[Request], span: int = 1) -> None:
        """Resolve copy-on-write BEFORE the batched decode step: a slot
        about to write into a still-shared block forks it onto its spare
        page (device copy + table repoint); a sole owner writes in place,
        after dropping the page's index entry (its content diverges).  A
        speculative round writes ``span`` positions: every block they touch
        is resolved, of which only the first can be shared (decode-budget
        blocks past the prompt are always fresh)."""
        bs = self.cfg.kv_block_size
        for req in active:
            p = int(self._host_pos[req.slot])
            last = min((p + span - 1) // bs, self._max_blocks - 1)
            for wb in range(p // bs, last + 1):
                page = int(self._table[req.slot, wb])
                if page < self.blocks.n_reserved:
                    continue  # trash row of an already-evicted slot
                if self.blocks.refcount(page) > 1 and self.blocks.spare_count(req.rid) > 0:
                    _, new = self.blocks.cow_fork(req.rid, wb)
                    self._cache = self._page_copy(self._cache, page, new)
                    self._table[req.slot, wb] = new
                    self._cow_forks += 1
                else:
                    self.blocks.deregister(page)  # no-op if unregistered

    def _window_blocks(self, active: list[Request], span: int = 1) -> int:
        """Decode window width in blocks: the smallest power of two that
        covers every active slot's current position, plus the ``span``
        positions a speculative round writes."""
        bs = self.cfg.kv_block_size
        need = max((int(self._host_pos[r.slot]) + span - 1) // bs + 1 for r in active)
        w = 1
        while w < need:
            w *= 2
        return min(w, self._max_blocks)

    def compile_counts(self) -> dict[str, int]:
        """Compiled-step counts per entry point since the last rebuild, the
        reference's recompile guard.  ``serve_step``: one per (window width,
        redundant reads) seen, summed over the R variants, as captured
        graphs on the card and as prepared entries of static buffers on the
        CPU, never one per tick, slot or page set.  The eager entry points
        count the distinct argument signatures they were called with, what
        a ``jax.jit`` compile is keyed on: ``suffix_prefill`` one per
        (bucket, chunk shape), the others at most one (preemption's three
        take fixed-width page ids).  With ``speculate_k``: ``spec_round`` one
        per window width (k is fixed), ``spec_rollback`` at most one.  Dense:
        ``serve_step`` one (the batch width is fixed), ``prefill`` one per
        bucket, ``insert`` one."""
        counts = {"serve_step": sum(len(s.entries) for s in self._serve_steps.values())}
        if not self.paged:
            # one dense step per batch width; one prefill per bucket
            counts["prefill"] = len(self._prefill.signatures)
            counts["insert"] = len(self._insert.signatures)
            return counts
        for name in ("suffix_prefill", "state_insert", "page_copy", "sample0", "page_spill",
                     "page_restore", "state_gather"):
            counts[name] = len(getattr(self, f"_{name}").signatures)
        if self.spec_k:
            counts["spec_round"] = len(self._spec_graphs.entries)
            counts["spec_rollback"] = len(self._spec_rollback.signatures)
        return counts

    def run(self) -> dict[int, list[int]]:
        """Drain queue + slots; returns {rid: generated tokens}."""
        while self.sched.has_work():
            self.tick()
        return {
            r.rid: r.output
            for r in self.sched.all_requests()
            if r.state is RequestState.DONE
        }

    def step(self) -> list[list[int]]:
        """Drain and return newly completed outputs in submission order."""
        before = {
            r.rid for r in self.sched.all_requests() if r.state is RequestState.DONE
        }
        self.run()
        return [
            r.output
            for r in self.sched.all_requests()
            if r.state is RequestState.DONE and r.rid not in before
        ]

    def metrics(self) -> ServingMetrics:
        done = [r for r in self.sched.all_requests() if r.state is RequestState.DONE]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        evictions: dict[str, int] = {}
        for r in done:
            if r.done_reason:
                evictions[r.done_reason] = evictions.get(r.done_reason, 0) + 1
        by_class: dict[int, dict] = {}
        for pr in sorted({r.priority for r in done}):
            rs = [r for r in done if r.priority == pr]
            tt = [r.ttft for r in rs if r.ttft is not None]
            lat = [r.done_time - r.submit_time for r in rs if r.done_time is not None]
            by_class[pr] = {
                "n": len(rs),
                "ttft_p50_ms": _pctl(tt, 50) * 1e3,
                "ttft_p99_ms": _pctl(tt, 99) * 1e3,
                "latency_p50_ms": _pctl(lat, 50) * 1e3,
                "latency_p99_ms": _pctl(lat, 99) * 1e3,
            }
        wall = self._busy_time
        analog = self.backend.snapshot(published_tokens=self._total_tokens)
        return ServingMetrics(
            completed=len(done),
            total_tokens=self._total_tokens,
            wall_time=wall,
            tokens_per_s=self._total_tokens / max(wall, 1e-9),
            ttft_mean=float(np.mean(ttfts)) if ttfts else 0.0,
            ttft_max=float(np.max(ttfts)) if ttfts else 0.0,
            decode_steps=self._decode_steps,
            prefills=self._prefills,
            occupancy_mean=self._occ_sum / max(self._decode_steps, 1),
            decode_time=self._decode_time,
            prefix_hits=self._prefix_hits,
            cow_forks=self._cow_forks,
            prefix_partial_hits=self._prefix_partial_hits,
            prefill_tokens=self._prefill_tokens,
            prefill_tokens_saved=self._prefill_tokens_saved,
            ttft_p50=_pctl(ttfts, 50),
            ttft_p99=_pctl(ttfts, 99),
            preemptions=self._preemptions,
            restores=self._restores,
            spill_drops=self._spill_drops,
            spec_rounds=self._spec_rounds,
            spec_drafted=self._spec_drafted,
            spec_accepted=self._spec_accepted,
            spec_acceptance=self._spec_accepted / max(self._spec_drafted, 1),
            spec_tokens_per_round=self._spec_emitted / max(self._spec_rounds, 1),
            evictions=evictions,
            latency_by_class=by_class,
            analog=analog,
            degraded_mode=self._degrade_level,
            canary_probes=self._canary_probes,
            canary_failures=self._canary_failures,
            retired_tiles=int(getattr(self.backend, "retired_tiles", 0)),
            redundant_read_events=analog["redundant_read_events"],
            degraded_transitions=list(self._degraded_transitions),
        )


class StaticServingEngine:
    """The pre-continuous-batching reference: a whole batch prefilled
    together (prompts left-padded to the batch's longest, no buckets),
    every slot held until the LAST request of the batch finishes.  Kept as
    the equivalence oracle for tests and the occupancy baseline for
    benchmarks, with the reference's quirks: the first token is an argmax
    even under ``wta_head``; under WTA each decode step draws one key for
    the whole batch (:meth:`_next_key`); padded positions are attended
    without a mask; ``submit(submit_time=)`` backdates a request.

    Its decode step is the dense layout's (``specs.DenseGraphs``): on the
    card one CUDA graph per wave width, over one persistent cache of that
    width that each wave's prefill writes in place, so the graph replays
    across waves; eager on the CPU.  It refuses what :class:`ServingEngine`
    refuses, at construction (the reference's static engine fails on an
    encoder-decoder only in its first prefill)."""

    def __init__(self, params, model_cfg: ModelConfig, cfg: ServeConfig, device=None, *,
                 graphs: Optional[bool] = None):
        _refuse_unservable(model_cfg)
        self.device = resolve_device(device)
        if graphs is None:
            graphs = self.device.type == "cuda"
        elif graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, the engine is on {self.device}")
        self.params = params
        self.mcfg = model_cfg
        self.cfg = cfg
        # batch width -> its dense cache, written in place by every wave
        self._caches: dict[int, dict] = {}
        self._decode = SP.DenseGraphs(model_cfg, params, self._caches, capture=graphs)
        self._queue: list[tuple[list[int], int, float]] = []
        self._key = R.PRNGKey(cfg.seed)
        self._occ_sum = 0.0
        self._decode_steps = 0
        self._total_tokens = 0
        self._busy_time = 0.0
        self._decode_time = 0.0
        self._ttfts: list[float] = []
        self._completed = 0

    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: Optional[int] = None,
               submit_time: Optional[float] = None) -> None:
        budget = self.cfg.max_new_tokens if max_new_tokens is None else max_new_tokens
        if budget < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
        if len(prompt_tokens) + budget > self.cfg.max_len:
            raise ValueError(
                f"prompt {len(prompt_tokens)} + {budget} new tokens "
                f"exceeds cache max_len={self.cfg.max_len}"
            )
        self._queue.append((list(prompt_tokens), budget,
                            submit_time if submit_time is not None else time.perf_counter()))

    def pending(self) -> int:
        """Requests queued for a future batch wave."""
        return len(self._queue)

    def _next_key(self) -> tuple[int, int]:
        self._key, k = R.split(self._key)
        return k

    def step(self) -> list[list[int]]:
        """Serve one batch from the queue; returns generated token lists."""
        if not self._queue:
            return []
        t_start = time.perf_counter()
        batch = self._queue[: self.cfg.max_batch]
        self._queue = self._queue[self.cfg.max_batch :]
        prompts = [p for p, _, _ in batch]
        budgets = [m for _, m, _ in batch]
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        # decode starts at the batch's padded length for EVERY slot, so a
        # short prompt beside a long one can overflow the cache even when
        # its own prompt + budget fit at submit time
        worst = plen + max(budgets)
        if worst > self.cfg.max_len:
            raise ValueError(
                f"padded prompt window {plen} + max budget {max(budgets)} "
                f"= {worst} exceeds cache max_len={self.cfg.max_len}"
            )
        toks = torch.tensor([left_pad(p, plen) for p in prompts], dtype=torch.int32,
                            device=self.device)
        if b not in self._caches:
            self._caches[b] = SP.init_decode_cache(self.mcfg, b, self.cfg.max_len,
                                                   device=self.device)
        _, logits = TF.lm_prefill(self.params, toks, self.mcfg, self.cfg.max_len,
                                  cache=self._caches[b])
        token = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        out: list[list[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        now = time.perf_counter()
        for _, _, t_sub in batch:
            self._ttfts.append(now - t_sub)
        for _ in range(max(budgets)):
            for i in range(b):
                if not done[i]:
                    t = int(token[i])
                    out[i].append(t)
                    self._total_tokens += 1
                    if t == self.cfg.eos_token or len(out[i]) >= budgets[i]:
                        done[i] = True
            if done.all():
                break
            wta = (np.asarray(self._next_key(), np.int64),) if self.mcfg.wta_head else ()
            t_dec = time.perf_counter()
            (nxt,) = self._decode(token, *wta)
            token = nxt.cpu().numpy()   # the step's sync, and its output read
            self._decode_time += time.perf_counter() - t_dec
            # slots stay held for the whole batch: idle ones count against
            # occupancy, which is the cost continuous batching removes
            self._occ_sum += (b - int(done.sum())) / self.cfg.max_batch
            self._decode_steps += 1
        self._completed += b
        self._busy_time += time.perf_counter() - t_start
        return out

    def run(self) -> list[list[int]]:
        outs: list[list[int]] = []
        while self._queue:
            outs.extend(self.step())
        return outs

    def compile_counts(self) -> dict[str, int]:
        """The dense decode step's entries: one per wave width seen."""
        return {"serve_step": len(self._decode.entries)}

    def metrics(self) -> ServingMetrics:
        wall = self._busy_time
        return ServingMetrics(
            completed=self._completed,
            total_tokens=self._total_tokens,
            wall_time=wall,
            tokens_per_s=self._total_tokens / max(wall, 1e-9),
            ttft_mean=float(np.mean(self._ttfts)) if self._ttfts else 0.0,
            ttft_max=float(np.max(self._ttfts)) if self._ttfts else 0.0,
            decode_steps=self._decode_steps,
            prefills=self._completed,
            occupancy_mean=self._occ_sum / max(self._decode_steps, 1),
            decode_time=self._decode_time,
        )
