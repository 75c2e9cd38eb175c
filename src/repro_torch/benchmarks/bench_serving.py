"""Serving-side RACA under load on the port (``benchmarks/bench_serving.py``
of the reference): continuous batching against static batching, paged
against dense KV cache, greedy against WTA stochastic sampling, the int8
pool, prefix sharing, suffix-only prefill, preemption, self-speculation,
the Table I energy accounting and the fault-tolerance loop.

The reference's traces, protocol, sections and report keys, through the
port's engines (``repro_torch.serving``) on the card, or on the CPU with
``--device cpu``.  A section takes ``(cfg, params)`` as
the reference's do and serves on the device the parameters live on, so a
test can hand both packages the same weights; :func:`run` initialises
with the port's own seeded init (``transformer.init_lm``, seed 0).
``sharded_decode`` serves on a ``(data, model)`` mesh over the open
process group (a one-rank group when none is open: a 1 × 1 mesh, whose
capacity ratio is 1.0; under ``torchrun`` every rank on the data axis).

Timings are host wall clock around each engine's own device syncs
(``ServingMetrics``): tokens/s, TTFT and decode-step ms move with the
card, its power limit and the host.  Counts (requests completed, decode
steps, occupancy, admissions, prefill tokens) and the token-identity
flags do not depend on time.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving [--dry-run]
        [--device cpu] [--out BENCH_serving_torch.json] [--validate PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import cost_model as CM
from repro_torch.device import resolve_device
from repro_torch.kernels.backend import FaultConfig
from repro_torch.models.transformer import init_lm
from repro_torch.serving import (
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    DegradationPolicy,
    FaultInjector,
    RequestState,
    ServeConfig,
    ServingEngine,
    StaticServingEngine,
)

# Keys every report must carry, the reference's schema.  validate_report()
# runs on the freshly written JSON in main(), and on any report with
# --validate.
REPORT_SCHEMA = {
    "engines": dict,
    "paged_vs_dense": list,
    "paged_int8_vs_bf16": list,
    "int8_capacity_sweep": dict,
    "prefix_sharing": dict,
    "partial_prefix": dict,
    "sharded_decode": dict,
    "preemption": dict,
    "speculative_decode": dict,
    "energy_per_token": dict,
    "fault_tolerance": dict,
    "dry_run": bool,
}
_INT8_ROW_KEYS = {
    "max_len", "block_size", "bf16", "int8", "decode_speedup",
    "tokens_per_s_ratio",
}
_CAPACITY_KEYS = {
    "num_kv_blocks", "blocks_per_request", "admitted_bf16", "admitted_int8",
    "capacity_ratio",
}
_PREFIX_KEYS = {
    "n_requests", "prompt_len", "off", "on", "prefill_savings",
    "tokens_match", "num_kv_blocks", "admitted_off", "admitted_on",
    "capacity_ratio",
}
_PARTIAL_KEYS = {
    "n_requests", "prompt_len", "shared_prefix_len", "prefill_chunk",
    "off", "on", "prefill_token_reduction", "late_ttft_ratio",
    "tokens_match",
}
_SHARDED_KEYS = {
    "mesh", "devices", "single", "sharded", "tokens_match",
    "per_device_kv_blocks", "admitted_single", "admitted_sharded",
    "capacity_ratio",
}
_PREEMPTION_KEYS = {
    "n_batch", "n_interactive", "burst_tick", "on", "off",
    "tokens_match", "interactive_p99_ratio",
}
_SPECULATIVE_KEYS = {
    "speculate_k", "n_requests", "plain", "spec", "acceptance",
    "tokens_per_round", "tokens_per_s_ratio", "tokens_match",
}
_ENERGY_KEYS = {
    "n_requests", "wta_trials", "kv_cache_dtype", "accounting",
    "raca_energy_pj_per_token", "adc1b_energy_pj_per_token",
    "raca_tops_per_w", "adc1b_tops_per_w", "speculative",
}
_FAULT_KEYS = {
    "n_requests", "stuck_rate", "canary_interval", "zero_fault", "faulted",
}
_FAULTED_KEYS = {
    "accounting", "degraded_mode_final", "degraded_mode_max",
    "canary_probes", "canary_failures", "retired_tiles",
    "redundant_read_events", "transitions", "evictions", "all_served",
    "injected",
}


def _expected_counts(acc: dict):
    """Re-derive the accounted event totals from the snapshot's own
    per-event shape counts — the integer-exact reconciliation formula
    shared by the energy and fault-tolerance sections."""
    tc = acc["tokens_computed"]
    return (
        CM.AnalogOpCounts.from_dict(acc["per_token_counts"])
        .scaled(tc["total"])
        + CM.AnalogOpCounts.from_dict(acc["per_sample_counts"])
        .scaled(acc["sample_events"])
        + CM.AnalogOpCounts.from_dict(acc["per_kv_token_counts"])
        .scaled(acc["kv_written_tokens"])
        + CM.AnalogOpCounts.from_dict(acc["per_redundant_counts"])
        .scaled(acc["redundant_read_events"])
    )


def _check_schema(report: dict) -> None:
    """Every key of the schema, with its type."""
    for key, typ in REPORT_SCHEMA.items():
        if key not in report:
            raise ValueError(f"serving report missing key {key!r}")
        if not isinstance(report[key], typ):
            raise ValueError(
                f"serving report key {key!r} should be {typ.__name__}, "
                f"got {type(report[key]).__name__}"
            )


def _check_tables(report: dict) -> None:
    """The int8 rows, the capacity sweep, prefix sharing and suffix-only
    prefill: their keys, identity flags and prefill-token floor."""
    for row in report["paged_int8_vs_bf16"]:
        missing = _INT8_ROW_KEYS - set(row)
        if missing:
            raise ValueError(
                f"paged_int8_vs_bf16 row missing keys {sorted(missing)}"
            )
    missing = _CAPACITY_KEYS - set(report["int8_capacity_sweep"])
    if missing:
        raise ValueError(
            f"int8_capacity_sweep missing keys {sorted(missing)}"
        )
    missing = _PREFIX_KEYS - set(report["prefix_sharing"])
    if missing:
        raise ValueError(
            f"prefix_sharing missing keys {sorted(missing)}"
        )
    if report["prefix_sharing"]["tokens_match"] is not True:
        raise ValueError(
            "prefix_sharing: sharing-on vs sharing-off decode diverged"
        )
    missing = _PARTIAL_KEYS - set(report["partial_prefix"])
    if missing:
        raise ValueError(
            f"partial_prefix missing keys {sorted(missing)}"
        )
    if report["partial_prefix"]["tokens_match"] is not True:
        raise ValueError(
            "partial_prefix: sharing-on vs sharing-off decode diverged"
        )
    # acceptance floor, deterministic (token counts, not timings): the
    # shared-prefix trace must cut computed prefill tokens >= 3x
    if report["partial_prefix"]["prefill_token_reduction"] < 3.0:
        raise ValueError(
            "partial_prefix: prefill-token reduction "
            f"{report['partial_prefix']['prefill_token_reduction']} < 3.0"
        )


def _check_sharded(report: dict) -> None:
    """Sharded decode: its keys and identical streams."""
    missing = _SHARDED_KEYS - set(report["sharded_decode"])
    if missing:
        raise ValueError(
            f"sharded_decode missing keys {sorted(missing)}"
        )
    if report["sharded_decode"]["tokens_match"] is not True:
        raise ValueError(
            "sharded_decode: mesh-sharded vs single-device decode diverged"
        )


def _check_preemption(report: dict) -> None:
    """Preemption: identical streams, at least one preemption, and a
    strictly better interactive p99 TTFT."""
    pre = report["preemption"]
    missing = _PREEMPTION_KEYS - set(pre)
    if missing:
        raise ValueError(f"preemption missing keys {sorted(missing)}")
    # spill/restore safety: every request that COMPLETED in both runs must
    # carry the identical token stream — preemption must never change what
    # a request generates, only when
    if pre["tokens_match"] is not True:
        raise ValueError(
            "preemption: preemption-on vs preemption-off decode diverged"
        )
    if pre["on"]["preemptions"] < 1:
        raise ValueError(
            "preemption: the bursty two-class trace triggered no "
            "preemption — the benchmark is not exercising the policy"
        )
    # the point of preempting: the interactive burst's tail latency must be
    # STRICTLY better with preemption on (the batch victims absorb the wait)
    if not (
        pre["on"]["interactive"]["ttft_p99_ms"]
        < pre["off"]["interactive"]["ttft_p99_ms"]
    ):
        raise ValueError(
            "preemption: interactive p99 TTFT did not improve with "
            "preemption on "
            f"(on={pre['on']['interactive']['ttft_p99_ms']}ms, "
            f"off={pre['off']['interactive']['ttft_p99_ms']}ms)"
        )


def _check_speculative(report: dict) -> None:
    """Speculation: identical streams and a tokens/s ratio of at least 1."""
    spec = report["speculative_decode"]
    missing = _SPECULATIVE_KEYS - set(spec)
    if missing:
        raise ValueError(
            f"speculative_decode missing keys {sorted(missing)}"
        )
    # the output-distribution contract: speculation must never change what
    # a greedy request generates, only how fast — the run fails on divergence
    if spec["tokens_match"] is not True:
        raise ValueError(
            "speculative_decode: speculative-on vs plain decode diverged"
        )
    # the point of speculating: per-token cost amortizes over the draft
    # run, so steady-state tokens/s must be no worse than plain decode
    if spec["tokens_per_s_ratio"] < 1.0:
        raise ValueError(
            "speculative_decode: tokens/s ratio "
            f"{spec['tokens_per_s_ratio']} < 1.0 — speculation lost to "
            "plain decode on the serving trace"
        )


def _check_energy(report: dict) -> None:
    """Energy: exact count reconciliation, pricing, RACA below 1-bit ADC,
    the speculative ride-along."""
    en = report["energy_per_token"]
    missing = _ENERGY_KEYS - set(en)
    if missing:
        raise ValueError(
            f"energy_per_token missing keys {sorted(missing)}"
        )
    acc = en["accounting"]
    # EXACT count reconciliation from the report alone: the accounted
    # event totals must equal tokens-computed x per-token shape counts
    # (plus sampling and KV-write terms) as integers — the accounting's
    # invariance contract, enforced on every report
    tc = acc["tokens_computed"]
    if tc["prefill"] + tc["decode"] + tc["draft"] != tc["total"]:
        raise ValueError(
            f"energy_per_token: tokens_computed does not sum: {tc}"
        )
    expected = _expected_counts(acc)
    if expected.as_dict() != acc["counts"]:
        raise ValueError(
            "energy_per_token: event counts do not reconcile against "
            f"tokens computed — expected {expected.as_dict()}, "
            f"reported {acc['counts']}"
        )
    # pricing reconciliation: re-price the reconciled counts with the
    # Table I cost model and match the reported energies
    prices = CM.price_counts(expected)
    for scheme in ("raca", "adc1b"):
        gross = acc[scheme]["energy_pj_gross"]
        want = prices[f"{scheme}_energy_pj"]
        if abs(gross - want) > 1e-6 * max(want, 1.0):
            raise ValueError(
                f"energy_per_token: {scheme} gross energy {gross} != "
                f"re-priced {want}"
            )
        per = acc[scheme]["energy_pj_per_token"]
        want_per = gross / max(acc["tokens_published"], 1)
        if abs(per - want_per) > 1e-6 * max(want_per, 1.0):
            raise ValueError(
                f"energy_per_token: {scheme} per-token energy {per} != "
                f"gross/published {want_per}"
            )
        if abs(en[f"{scheme}_energy_pj_per_token"] - per) > 1e-9 * max(
            per, 1.0
        ):
            raise ValueError(
                f"energy_per_token: top-level {scheme} per-token copy "
                "diverged from the accounting section"
            )
    # the paper's point, on served traffic: ADC-free RACA readout must
    # price BELOW the 1-bit-ADC scheme for the same event stream
    if not (
        en["raca_energy_pj_per_token"] < en["adc1b_energy_pj_per_token"]
    ):
        raise ValueError(
            "energy_per_token: RACA pricing "
            f"({en['raca_energy_pj_per_token']} pJ/tok) is not below "
            f"1-bit-ADC ({en['adc1b_energy_pj_per_token']} pJ/tok)"
        )
    spe = en["speculative"]
    if spe["tokens_match"] is not True:
        raise ValueError(
            "energy_per_token: speculative vs plain published streams "
            "diverged — the energy comparison is not like-for-like"
        )
    # rejected drafts burn energy without publishing: per published
    # token, speculation can only cost MORE energy than plain decode
    if spe["overhead_ratio"] < 1.0:
        raise ValueError(
            "energy_per_token: speculative per-published-token energy "
            f"ratio {spe['overhead_ratio']} < 1.0 — drafted work is "
            "being under-accounted"
        )


def _check_fault_tolerance(report: dict) -> None:
    """Fault tolerance: identity at rest, liveness, detection, the ladder
    up and back, priced re-reads."""
    ft = report["fault_tolerance"]
    missing = _FAULT_KEYS - set(ft)
    if missing:
        raise ValueError(f"fault_tolerance missing keys {sorted(missing)}")
    fa = ft["faulted"]
    missing = _FAULTED_KEYS - set(fa)
    if missing:
        raise ValueError(
            f"fault_tolerance.faulted missing keys {sorted(missing)}"
        )
    # the zero-knob contract: sim_faulty with every fault knob at zero
    # must be BIT-IDENTICAL to the plain sim backend on a served trace
    if ft["zero_fault"]["tokens_match"] is not True:
        raise ValueError(
            "fault_tolerance: zero-knob sim_faulty stream diverged from "
            "the sim backend — the fault model is not identity at rest"
        )
    # liveness under injected device faults: every request the engine did
    # not explicitly evict (typed reason) must have published tokens
    if fa["all_served"] is not True:
        raise ValueError(
            "fault_tolerance: a non-evicted request ended without "
            "published tokens under the fault schedule"
        )
    if fa["canary_failures"] < 1:
        raise ValueError(
            "fault_tolerance: the injected comparator offset never "
            "failed a canary probe — detection is not being exercised"
        )
    # the degradation ladder must have tripped AND fully recovered once
    # the injected fault was lifted (reversibility contract)
    if not fa["transitions"]:
        raise ValueError("fault_tolerance: no degradation transitions")
    if fa["degraded_mode_max"] < 1:
        raise ValueError("fault_tolerance: degradation never engaged")
    if fa["degraded_mode_final"] != 0:
        raise ValueError(
            "fault_tolerance: engine did not recover to degraded_mode 0 "
            "after recover_device "
            f"(final level {fa['degraded_mode_final']})"
        )
    # redundant comparator re-reads must be priced: events recorded by
    # the backend reconcile integer-exactly against the count ledger
    facc = fa["accounting"]
    if fa["redundant_read_events"] != facc["redundant_read_events"]:
        raise ValueError(
            "fault_tolerance: redundant_read_events metric diverged "
            "from the accounting snapshot"
        )
    if fa["redundant_read_events"] < 1:
        raise ValueError(
            "fault_tolerance: the degraded engine recorded no redundant "
            "comparator re-reads at level >= 2"
        )
    if _expected_counts(facc).as_dict() != facc["counts"]:
        raise ValueError(
            "fault_tolerance: faulted event counts do not reconcile "
            "against tokens computed + redundant reads — expected "
            f"{_expected_counts(facc).as_dict()}, "
            f"reported {facc['counts']}"
        )


# the checks in the reference's order; validate_report stops at the first
# failure
CHECKS = (_check_schema, _check_tables, _check_sharded, _check_preemption,
          _check_speculative, _check_energy, _check_fault_tolerance)


def validate_report(report: dict) -> None:
    """Raise ValueError unless ``report`` matches the schema and every
    gate of the reference's ``validate_report``."""
    for check in CHECKS:
        check(report)


def make_trace(
    seed: int,
    n_req: int,
    mean_gap_ticks: float,
    prompt_len_range: tuple[int, int],
    new_tokens_range: tuple[int, int],
    vocab: int,
) -> list[tuple[int, list[int], int]]:
    """(arrival_tick, prompt, max_new_tokens) rows, arrival-sorted.

    Arrivals are a Poisson-ish process over engine ticks (exponential gaps)
    rather than wall clock, so the trace is deterministic for a seed and
    independent of host speed.
    """
    rng = np.random.default_rng(seed)
    t = 0.0
    trace = []
    for _ in range(n_req):
        t += rng.exponential(mean_gap_ticks)
        plen = int(rng.integers(*prompt_len_range))
        prompt = rng.integers(1, vocab, size=plen).tolist()
        budget = int(rng.integers(*new_tokens_range))
        trace.append((int(t), prompt, budget))
    return trace


def drive_continuous(engine: ServingEngine, trace) -> None:
    """Feed the trace by tick index; drain after the last arrival."""
    i, tick = 0, 0
    while i < len(trace) or engine.sched.has_work():
        while i < len(trace) and trace[i][0] <= tick:
            _, prompt, budget = trace[i]
            engine.submit(prompt, budget)
            i += 1
        engine.tick()
        tick += 1


def drive_static(engine: StaticServingEngine, trace) -> None:
    """Feed the same tick-indexed trace to the static engine.

    Static batching cannot admit mid-flight: each ``step()`` wave consumes
    as many ticks as it ran decode steps, and requests arriving during a
    wave wait in the queue — the TTFT / occupancy cost being measured.
    Requests whose arrival tick fell inside a finished wave are submitted
    with a backdated timestamp (measured seconds/tick), so their queue wait
    counts toward static TTFT just as it does for the continuous engine.
    """
    i, tick = 0, 0
    tick_wall = time.perf_counter()
    sec_per_tick = 0.0
    while i < len(trace) or engine.pending():
        while i < len(trace) and trace[i][0] <= tick:
            _, prompt, budget = trace[i]
            arrival_wall = tick_wall - (tick - trace[i][0]) * sec_per_tick
            engine.submit(prompt, budget, submit_time=arrival_wall)
            i += 1
        if engine.pending():
            before = engine.metrics().decode_steps
            t0 = time.perf_counter()
            engine.step()
            steps = max(engine.metrics().decode_steps - before, 1)
            sec_per_tick = (time.perf_counter() - t0) / steps
            tick += steps
        else:
            tick += 1
        tick_wall = time.perf_counter()


def _device(params) -> torch.device:
    return params["embed"]["embedding"].device


def _engine(params, cfg, serve_cfg) -> ServingEngine:
    """The continuous engine on the device the parameters live on."""
    return ServingEngine(params, cfg, serve_cfg, device=_device(params))


def _bench(cfg, params, trace, serve_cfg):
    eng = _engine(params, cfg, serve_cfg)
    drive_continuous(eng, trace)
    return eng.metrics()


def _metrics_dict(m) -> dict:
    return {
        "tokens_per_s": round(m.tokens_per_s, 1),
        "ttft_ms": round(m.ttft_mean * 1e3, 2),
        "decode_step_ms": round(m.decode_step_ms, 3),
        "occupancy": round(m.occupancy_mean, 3),
        "completed": m.completed,
        "decode_steps": m.decode_steps,
    }


def _steady_delta(m0, m1) -> dict:
    """Second-pass metrics (every decode graph captured, every bucket seen
    in the first) from two cumulative snapshots."""
    steps = m1.decode_steps - m0.decode_steps
    comp = m1.completed - m0.completed
    ttft = (
        m1.ttft_mean * m1.completed - m0.ttft_mean * m0.completed
    ) / max(comp, 1)
    occ = (
        m1.occupancy_mean * m1.decode_steps
        - m0.occupancy_mean * m0.decode_steps
    ) / max(steps, 1)
    wall = m1.wall_time - m0.wall_time
    return {
        "tokens_per_s": round(
            (m1.total_tokens - m0.total_tokens) / max(wall, 1e-9), 1
        ),
        "ttft_ms": round(ttft * 1e3, 2),
        "decode_step_ms": round(
            (m1.decode_time - m0.decode_time) * 1e3 / max(steps, 1), 3
        ),
        "occupancy": round(occ, 3),
        "completed": comp,
        "decode_steps": steps,
    }


def bench_paged_vs_dense(
    cfg, params, max_len: int, n_req: int, block_size: int = 16
) -> dict:
    """Dense vs paged decode at one max_len point, short-prompt trace.

    The paged pool is sized to the trace's working set (every slot holding
    its largest possible request, plus slack) rather than dense-parity
    batch·max_len — shared capacity is the layout's premise.  Occupancy is
    equal by construction: both engines run the identical trace through the
    identical scheduler."""
    max_plen, max_budget = 10, 16
    serve = dict(max_batch=4, max_new_tokens=max_budget, max_len=max_len)
    trace = make_trace(
        seed=1, n_req=n_req, mean_gap_ticks=1.0,
        prompt_len_range=(2, max_plen),
        new_tokens_range=(6, max_budget), vocab=cfg.vocab,
    )
    out = {"max_len": max_len, "block_size": block_size}
    for layout in ("dense", "paged"):
        kw = dict(serve, kv_layout=layout)
        if layout == "paged":
            # working set per request: prompts land in the smallest prefill
            # bucket covering max_plen, plus the full decode budget
            bucket = next(
                b for b in ServeConfig(**serve).buckets() if b >= max_plen
            )
            per_req = -(-(bucket + max_budget) // block_size)
            kw.update(
                kv_block_size=block_size,
                num_kv_blocks=serve["max_batch"] * per_req + 3,
            )
        eng = _engine(params, cfg, ServeConfig(**kw))
        drive_continuous(eng, trace)  # warm-up: compiles every bucket
        m0 = eng.metrics()
        drive_continuous(eng, trace)  # measured steady-state pass
        out[layout] = _steady_delta(m0, eng.metrics())
    out["decode_speedup"] = round(
        out["dense"]["decode_step_ms"]
        / max(out["paged"]["decode_step_ms"], 1e-9),
        2,
    )
    return out


def bench_paged_int8(
    cfg, params, max_len: int, n_req: int, block_size: int = 16
) -> dict:
    """bf16 vs int8 paged decode at one max_len point.

    Same trace, same scheduler, dense-parity pools for both (the latency
    comparison isolates the per-token decode cost: int8 halves the K/V
    bytes a decode step streams and fuses the dequant into the attention
    math).  Steady-state methodology matches bench_paged_vs_dense."""
    max_plen, max_budget = 10, 16
    serve = dict(
        max_batch=4, max_new_tokens=max_budget, max_len=max_len,
        kv_layout="paged", kv_block_size=block_size,
    )
    trace = make_trace(
        seed=2, n_req=n_req, mean_gap_ticks=1.0,
        prompt_len_range=(2, max_plen),
        new_tokens_range=(6, max_budget), vocab=cfg.vocab,
    )
    out = {"max_len": max_len, "block_size": block_size}
    for label, dt in (("bf16", "same"), ("int8", "int8")):
        mcfg = dataclasses.replace(cfg, kv_cache_dtype=dt)
        eng = _engine(params, mcfg, ServeConfig(**serve))
        drive_continuous(eng, trace)  # warm-up: compiles every bucket
        m0 = eng.metrics()
        drive_continuous(eng, trace)  # measured steady-state pass
        out[label] = _steady_delta(m0, eng.metrics())
    out["decode_speedup"] = round(
        out["bf16"]["decode_step_ms"]
        / max(out["int8"]["decode_step_ms"], 1e-9),
        2,
    )
    out["tokens_per_s_ratio"] = round(
        out["int8"]["tokens_per_s"]
        / max(out["bf16"]["tokens_per_s"], 1e-9),
        2,
    )
    return out


def bench_prefix_sharing(cfg, params, n_req: int = 12) -> dict:
    """Repeated-prefix trace: the same prompt submitted ``n_req`` times.

    The trace every prefix cache is built for (shared system prompt /
    few-shot header).  Measured end to end through the engine:

    * prefill work saved — with sharing on, every repeat that overlaps a
      resident copy maps the prompt blocks and samples its first token
      from the stored last-token logits instead of recomputing the bucket
      prefill (``metrics.prefills`` vs ``prefix_hits``);
    * admission capacity at equal ``num_kv_blocks`` — a tight pool admits
      the original (full block budget) plus repeats at one decode-budget
      allocation each, vs ``floor(capacity / full_budget)`` without
      sharing;
    * safety — the sharing-on and sharing-off token streams must be
      IDENTICAL (``tokens_match``; validate_report fails the run on a
      divergence, making the run a standing byte-identity check).
    """
    prompt = list(range(1, 17))  # bucket 16, block-aligned
    budget = 8
    serve = dict(
        max_batch=4, max_new_tokens=budget, max_len=64,
        kv_layout="paged", kv_block_size=8,
    )
    out: dict = {"n_requests": n_req, "prompt_len": len(prompt)}
    streams = {}
    for label, share in (("off", False), ("on", True)):
        eng = _engine(
            params, cfg, ServeConfig(**serve, enable_prefix_sharing=share)
        )
        rids = [eng.submit(prompt, budget) for _ in range(n_req)]
        outs = eng.run()
        streams[label] = [outs[r] for r in rids]
        m = eng.metrics()
        out[label] = {
            "prefills": m.prefills,
            "prefix_hits": m.prefix_hits,
            "cow_forks": m.cow_forks,
            "tokens_per_s": round(m.tokens_per_s, 1),
            "ttft_ms": round(m.ttft_mean * 1e3, 2),
        }
    out["prefill_savings"] = round(
        1.0 - out["on"]["prefills"] / max(out["off"]["prefills"], 1), 2
    )
    out["tokens_match"] = streams["on"] == streams["off"]

    # admission capacity at an equal, deliberately tight block budget
    out["num_kv_blocks"] = 8
    for label, share in (("off", False), ("on", True)):
        eng = _engine(
            params, cfg,
            ServeConfig(
                **dict(serve, max_batch=8), num_kv_blocks=8,
                enable_prefix_sharing=share,
            ),
        )
        for _ in range(8):
            eng.submit(prompt, budget)
        eng.tick()
        out[f"admitted_{label}"] = sum(
            1 for r in eng.sched.all_requests()
            if r.state is not RequestState.QUEUED
        )
    out["capacity_ratio"] = round(
        out["admitted_on"] / max(out["admitted_off"], 1), 2
    )
    return out


def bench_partial_prefix(cfg, params, n_req: int = 10) -> dict:
    """Shared-system-prompt trace: a 56-token common prefix with short
    unique suffixes, arrivals staggered so late requests land while
    earlier ones are mid-decode.

    The workload suffix-only prefill exists for.  With sharing on, every
    late arrival maps the resident prefix blocks and computes ONLY its
    8-token suffix (one `prefill_chunk` tick) instead of the whole
    64-token bucket — measured end to end through the engine:

    * computed prefill tokens (``metrics.prefill_tokens``) drop ≥ 3× —
      deterministic token counts, enforced by ``validate_report``;
    * TTFT for the late arrivals shrinks (one suffix chunk vs a full
      bucket of chunks injected between decode steps), reported as
      ``late_ttft_ratio`` (timing, not validated);
    * the on/off token streams must be IDENTICAL (``tokens_match`` —
      the run fails on divergence).
    """
    prefix = list(range(1, 57))               # 56 shared tokens
    suffix_len, budget = 8, 8
    prompts = [prefix + [200 + i] * suffix_len for i in range(n_req)]
    serve = dict(
        max_batch=4, max_new_tokens=budget, max_len=128,
        kv_layout="paged", kv_block_size=8, prefill_chunk=16,
    )
    out: dict = {
        "n_requests": n_req,
        "prompt_len": len(prompts[0]),
        "shared_prefix_len": len(prefix),
        "prefill_chunk": serve["prefill_chunk"],
    }
    streams = {}
    for label, share in (("off", False), ("on", True)):
        eng = _engine(
            params, cfg, ServeConfig(**serve, enable_prefix_sharing=share)
        )

        def drive_pass():
            rids: list[int] = []
            i = tick = 0
            while i < len(prompts) or eng.sched.has_work():
                while i < len(prompts) and 2 * i <= tick:
                    rids.append(eng.submit(prompts[i], budget))
                    i += 1
                eng.tick()
                tick += 1
            return rids

        warm = drive_pass()   # compiles every (bucket, chunk) shape
        m0 = eng.metrics()
        rids = drive_pass()   # measured steady-state pass
        outs = {r.rid: r.output for r in eng.sched.all_requests()}
        streams[label] = [outs[r] for r in warm + rids]
        m = eng.metrics()
        # late arrivals land while earlier requests are mid-decode; their
        # TTFT is the interleaved-prefill responsiveness being measured
        late = [eng.sched.request(r).ttft for r in rids[1:]]
        out[label] = {
            "prefills": m.prefills - m0.prefills,
            "prefix_partial_hits": (
                m.prefix_partial_hits - m0.prefix_partial_hits
            ),
            "prefill_tokens": m.prefill_tokens - m0.prefill_tokens,
            "prefill_tokens_saved": (
                m.prefill_tokens_saved - m0.prefill_tokens_saved
            ),
            "late_ttft_ms": round(float(np.mean(late)) * 1e3, 2),
        }
    out["prefill_token_reduction"] = round(
        out["off"]["prefill_tokens"] / max(out["on"]["prefill_tokens"], 1),
        2,
    )
    out["late_ttft_ratio"] = round(
        out["on"]["late_ttft_ms"] / max(out["off"]["late_ttft_ms"], 1e-9),
        2,
    )
    out["tokens_match"] = streams["on"] == streams["off"]
    return out


def bench_int8_capacity(cfg, params, num_kv_blocks: int = 9) -> dict:
    """Equal-memory admission sweep: requests admitted on the first tick at
    a fixed ``num_kv_blocks`` budget.  int8 pages cost half the K/V bytes,
    so the same budget holds ~2x the pages and the BlockAllocator admits
    ~2x the requests — quantization's capacity win, measured end to end
    through the admission gate."""
    block_size, budget = 8, 8
    prompt = [1, 2, 3]  # bucket 8 + budget 8 -> 2 blocks per request
    out = {
        "num_kv_blocks": num_kv_blocks,
        "blocks_per_request": 2,
    }
    for label, dt in (("bf16", "same"), ("int8", "int8")):
        mcfg = dataclasses.replace(cfg, kv_cache_dtype=dt)
        sc = ServeConfig(
            max_batch=32, max_new_tokens=budget, max_len=64,
            kv_layout="paged", kv_block_size=block_size,
            num_kv_blocks=num_kv_blocks,
            # identical prompts would ALSO share pages — sharing off to
            # isolate the dtype-driven capacity factor (the sharing win is
            # measured by bench_prefix_sharing)
            enable_prefix_sharing=False,
        )
        eng = _engine(params, mcfg, sc)
        for _ in range(32):
            eng.submit(prompt, budget)
        eng.tick()
        out[f"admitted_{label}"] = sum(
            1 for r in eng.sched.all_requests()
            if r.state is not RequestState.QUEUED
        )
    out["capacity_ratio"] = round(
        out["admitted_int8"] / max(out["admitted_bf16"], 1), 2
    )
    return out


def bench_sharded_decode(cfg, params, n_req: int = 8) -> dict:
    """Sharded paged decode over the ``(data, model)`` mesh of the open
    process group, every rank on the data axis (``model=1``: data-axis
    sharding keeps every reduction order, so the token identity is exact).
    Two claims, as the reference's:

    * safety: the same arrival trace through the unsharded engine and the
      sharded one gives IDENTICAL streams (``tokens_match``;
      validate_report fails the run otherwise);
    * capacity: at a FIXED per-device block budget the sharded pool's
      page axis spreads over data, so admission capacity grows with the
      data axis at constant bytes per device: requests admitted on the
      first tick at ``num_kv_blocks = per_device · data``.

    With no group open it opens a one-rank group: a 1 × 1 mesh, whose
    identity check is the byte-identity contract and whose capacity ratio
    is 1.0."""
    from repro_torch.launch import mesh as LM

    dev = _device(params)
    serve = dict(
        max_batch=4, max_new_tokens=8, max_len=64,
        kv_layout="paged", kv_block_size=8,
    )
    trace = make_trace(
        seed=3, n_req=n_req, mean_gap_ticks=1.0,
        prompt_len_range=(2, 12), new_tokens_range=(3, 9), vocab=cfg.vocab,
    )
    with LM.process_group(dev.type):
        mesh = LM.make_host_mesh(model=1, device=dev.type)
        data, model = (int(n) for n in mesh.shape)
        out: dict = {"mesh": {"data": data, "model": model}, "devices": data * model}
        streams = {}
        for label, m in (("single", None), ("sharded", mesh)):
            eng = _engine(params, cfg, ServeConfig(**serve, mesh=m))
            drive_continuous(eng, trace)
            streams[label] = {
                r.rid: r.output for r in eng.sched.all_requests()
                if r.state is RequestState.DONE
            }
            met = eng.metrics()
            out[label] = {
                "tokens_per_s": round(met.tokens_per_s, 1),
                "decode_step_ms": round(met.decode_step_ms, 3),
                "completed": met.completed,
            }
            del eng
        out["tokens_match"] = streams["single"] == streams["sharded"]
        # admission capacity at a FIXED per-device budget: the sharded pool
        # holds per_device·data pages at the same bytes per device
        per_device = 8
        out["per_device_kv_blocks"] = per_device
        prompt = [1, 2, 3]  # bucket 8 + budget 8 -> 2 blocks per request
        for label, m, blocks in (
            ("admitted_single", None, per_device),
            ("admitted_sharded", mesh, per_device * data),
        ):
            eng = _engine(params, cfg, ServeConfig(
                **dict(serve, max_batch=32), num_kv_blocks=blocks,
                enable_prefix_sharing=False, mesh=m,
            ))
            for _ in range(32):
                eng.submit(prompt, 8)
            eng.tick()
            out[label] = sum(
                1 for r in eng.sched.all_requests()
                if r.state is not RequestState.QUEUED
            )
            del eng
    out["capacity_ratio"] = round(
        out["admitted_sharded"] / max(out["admitted_single"], 1), 2
    )
    return out


def bench_preemption(cfg, params, n_each: int = 3) -> dict:
    """Bursty two-class trace: batch jobs saturate the slots, then an
    interactive burst arrives mid-decode at higher priority.

    The SLO scenario preemption exists for.  With preemption ON the
    engine spills the lowest-priority decoding victims to host (pages +
    recurrent state), seats the burst immediately, and restores the
    victims afterwards through the normal admission gate; with it OFF the
    burst queues behind the batch jobs' full decode budgets.  Reported
    per mode: per-class p50/p99 TTFT and completion latency, preemption /
    restore counts.  Two claims are ENFORCED by ``validate_report``:

    * ``tokens_match`` — every request completing in both runs carries an
      identical token stream (spill/restore byte identity, end to end);
    * the interactive class's p99 TTFT is STRICTLY better with
      preemption on (the batch victims absorb the wait).
    """
    batch_budget, inter_budget, burst_tick = 24, 4, 4
    serve = dict(
        max_batch=2, max_new_tokens=batch_budget, max_len=128,
        kv_layout="paged", kv_block_size=8, prefill_buckets=(16,),
    )
    batch_prompts = [
        list(range(1 + i, 13 + i)) for i in range(n_each)
    ]
    inter_prompts = [
        list(range(100 + i, 109 + i)) for i in range(n_each)
    ]
    out: dict = {
        "n_batch": n_each, "n_interactive": n_each,
        "burst_tick": burst_tick,
    }
    streams: dict[str, dict] = {}
    for label, enable in (("off", False), ("on", True)):
        eng = _engine(
            params, cfg, ServeConfig(**serve, enable_preemption=enable)
        )
        rids: dict[str, list[int]] = {"batch": [], "interactive": []}
        for p in batch_prompts:
            rids["batch"].append(
                eng.submit(p, batch_budget, priority=PRIORITY_BATCH)
            )
        tick = 0
        burst_sent = False
        while eng.sched.has_work():
            if tick >= burst_tick and not burst_sent:
                for p in inter_prompts:
                    rids["interactive"].append(
                        eng.submit(
                            p, inter_budget,
                            priority=PRIORITY_INTERACTIVE,
                        )
                    )
                burst_sent = True
            eng.tick()
            tick += 1
        m = eng.metrics()
        streams[label] = {
            r.rid: r.output for r in eng.sched.all_requests()
        }
        out[label] = {
            "preemptions": m.preemptions,
            "restores": m.restores,
            "batch": m.latency_by_class.get(PRIORITY_BATCH, {}),
            "interactive": m.latency_by_class.get(
                PRIORITY_INTERACTIVE, {}
            ),
        }
    out["tokens_match"] = streams["on"] == streams["off"]
    out["interactive_p99_ratio"] = round(
        out["on"]["interactive"].get("ttft_p99_ms", 0.0)
        / max(out["off"]["interactive"].get("ttft_p99_ms", 1e-9), 1e-9),
        3,
    )
    return out


def bench_speculative(
    cfg, params, n_req: int = 10, k: int = 4, passes: int = 3
) -> dict:
    """Self-speculative decoding vs plain decode on the same mixed trace.

    Every decoding slot drafts ``k`` tokens per tick with the fused decode
    step and verifies the run in one read-only pass — ONE device dispatch
    and one host sync per round instead of per token, so per-tick host
    overhead amortizes over the accepted run.  Two claims are ENFORCED by
    ``validate_report``:

    * ``tokens_match`` — greedy streams are byte-identical speculative-on
      vs plain (speculation changes latency, never output);
    * ``tokens_per_s_ratio >= 1.0`` — steady-state throughput must not
      lose to plain decode (warm-up pass first, then best-of-``passes``
      re-drives of the same trace per engine, plain/spec interleaved so
      transient host noise hits both; the max filters scheduler jitter,
      same spirit as the paged/int8 sections' second-pass deltas).

    Speculation's win is host-side: the draft run does the SAME model
    math as k plain steps, so tokens/s only improves by amortizing the
    per-tick host work + dispatch + sync over the accepted run.  Measure
    it on a dispatch-bound config (the smoke model) — on a compute-bound
    model the ratio pins to ~1.0 by construction.  The port's plain tick
    is a graph replay bound by its kernels on the card, and eager on the
    CPU, so the round's extra verify step is not amortised and the floor
    is not met there (``PERF.md`` §6).

    Acceptance < 1.0 on a greedy trace is budget truncation, not
    mismatch: drafts past a request's remaining budget are discarded at
    its "length" eviction but still count as drafted.
    """
    serve = dict(
        max_batch=3, max_new_tokens=16, max_len=128,
        kv_layout="paged", kv_block_size=8,
    )
    trace = make_trace(
        seed=4, n_req=n_req, mean_gap_ticks=1.0,
        prompt_len_range=(2, 12), new_tokens_range=(8, 17),
        vocab=cfg.vocab,
    )
    out: dict = {"speculate_k": k, "n_requests": n_req, "passes": passes}
    streams = {}
    engines = {}
    for label, kk in (("plain", 0), ("spec", k)):
        eng = _engine(
            params, cfg, ServeConfig(**serve, speculate_k=kk)
        )
        drive_continuous(eng, trace)  # warm-up: compiles buckets + windows
        engines[label] = eng
    # measured passes INTERLEAVED plain/spec so transient machine noise
    # (another process, a frequency shift) hits both engines, not just
    # whichever happened to run second — the ratio is what's enforced
    best: dict = {}
    for _ in range(passes):
        for label, eng in engines.items():
            m0 = eng.metrics()
            drive_continuous(eng, trace)  # steady-state re-drive
            d = _steady_delta(m0, eng.metrics())
            if (
                label not in best
                or d["tokens_per_s"] > best[label]["tokens_per_s"]
            ):
                best[label] = d
    for label, eng in engines.items():
        streams[label] = [r.output for r in eng.sched.all_requests()]
        out[label] = best[label]
        if label == "spec":
            m = eng.metrics()
            out["acceptance"] = round(m.spec_acceptance, 3)
            out["tokens_per_round"] = round(m.spec_tokens_per_round, 2)
            out[label]["spec_rounds"] = m.spec_rounds
    out["tokens_per_s_ratio"] = round(
        out["spec"]["tokens_per_s"]
        / max(out["plain"]["tokens_per_s"], 1e-9),
        2,
    )
    out["tokens_match"] = streams["plain"] == streams["spec"]
    return out


def bench_energy_per_token(cfg, params, n_req: int = 8) -> dict:
    """Energy-per-token accounting on the standard mixed trace.

    Drives the full analog-event surface at once — int8 KV pool
    (stochastic-rounding events) + WTA sampling head (comparator votes
    per emitted token) — through the Sim device backend, then prices the
    event stream under both readout schemes of the paper's Table I:
    RACA (ADC-free comparator readout) vs the 1-bit-ADC baseline.  The
    reported numbers are deterministic: counts are exact invariants of
    (tokens computed x model shape), reconciled integer-exactly by
    ``validate_report``, and the pricing is a pure function of the
    counts — no timing anywhere in this section.

    A speculative ride-along re-runs the trace greedily, plain vs
    ``speculate_k=2``: the published streams are byte-identical, but the
    speculative engine forwards every drafted AND verify position, so
    its gross energy is strictly higher — ``overhead_ratio`` reports the
    per-published-token cost of rejected drafts (>= 1.0 is enforced:
    drafted work must never be under-accounted).
    """
    mcfg = dataclasses.replace(
        cfg, kv_cache_dtype="int8", wta_head=True,
        analog=dataclasses.replace(cfg.analog, wta_trials=8),
    )
    serve = dict(
        max_batch=4, max_new_tokens=12, max_len=128,
        kv_layout="paged", kv_block_size=16,
    )
    trace = make_trace(
        seed=5, n_req=n_req, mean_gap_ticks=1.0,
        prompt_len_range=(2, 12), new_tokens_range=(4, 13),
        vocab=cfg.vocab,
    )
    eng = _engine(params, mcfg, ServeConfig(**serve))
    drive_continuous(eng, trace)
    a = eng.metrics().analog
    out: dict = {
        "n_requests": n_req,
        "wta_trials": mcfg.analog.wta_trials,
        "kv_cache_dtype": mcfg.kv_cache_dtype,
        "accounting": a,
        "raca_energy_pj_per_token": a["raca"]["energy_pj_per_token"],
        "adc1b_energy_pj_per_token": a["adc1b"]["energy_pj_per_token"],
        "raca_tops_per_w": round(a["raca"]["tops_per_w_effective"], 4),
        "adc1b_tops_per_w": round(a["adc1b"]["tops_per_w_effective"], 4),
    }

    # speculative ride-along: identical greedy streams, honest gross cost
    gcfg = dataclasses.replace(cfg, wta_head=False)
    spec = {"speculate_k": 2}
    streams = {}
    for label, kk in (("plain", 0), ("spec", spec["speculate_k"])):
        e = _engine(
            params, gcfg, ServeConfig(**serve, speculate_k=kk)
        )
        drive_continuous(e, trace)
        streams[label] = {
            r.rid: r.output for r in e.sched.all_requests()
        }
        sa = e.metrics().analog
        spec[label] = {
            "tokens_published": sa["tokens_published"],
            "tokens_computed": sa["tokens_computed"],
            "raca_energy_pj_gross": sa["raca"]["energy_pj_gross"],
            "raca_energy_pj_per_published_token": (
                sa["raca"]["energy_pj_per_token"]
            ),
        }
    spec["tokens_match"] = streams["plain"] == streams["spec"]
    spec["overhead_ratio"] = round(
        spec["spec"]["raca_energy_pj_per_published_token"]
        / max(spec["plain"]["raca_energy_pj_per_published_token"], 1e-9),
        3,
    )
    out["speculative"] = spec
    return out


def bench_fault_tolerance(cfg, params, n_req: int = 8) -> dict:
    """The analog fault model end to end: identity at rest, the full
    detect/mitigate/degrade/recover loop under an injected device fault.

    Two runs on the same WTA trace:

    * ``zero_fault`` — the ``sim_faulty`` backend with every knob at
      zero against plain ``sim``: published token streams must be
      byte-identical (the fault model is exact identity at rest;
      validate_report enforces it on the report).
    * ``faulted`` — seeded stuck cells from tick 0 plus an injected
      comparator offset (``degrade_device`` at tick 4, lifted by
      ``recover_device`` at tick 10).  The per-tick canary probe
      catches the stuck cells (tile retirement clears them) and then
      the offset (the degradation ladder climbs to load shedding);
      after recovery the ladder walks back to 0.  Enforced downstream:
      every non-evicted request published tokens, the canary failed at
      least once, transitions were recorded AND reversed, and the
      redundant comparator re-reads taken at ladder level >= 2
      reconcile integer-exactly in the energy ledger.
    """
    mcfg = dataclasses.replace(
        cfg, wta_head=True,
        analog=dataclasses.replace(cfg.analog, wta_trials=8),
    )
    serve = dict(
        max_batch=4, max_new_tokens=12, max_len=128,
        kv_layout="paged", kv_block_size=16,
    )
    trace = make_trace(
        seed=11, n_req=n_req, mean_gap_ticks=1.0,
        prompt_len_range=(2, 12), new_tokens_range=(4, 13),
        vocab=cfg.vocab,
    )

    # identity at rest: all-zero fault knobs vs the plain sim backend
    streams = {}
    for label, bk in (("sim", "sim"), ("sim_faulty", "sim_faulty")):
        e = _engine(
            params, mcfg, ServeConfig(**serve, device_backend=bk)
        )
        drive_continuous(e, trace)
        streams[label] = {r.rid: r.output for r in e.sched.all_requests()}
    zero_fault = {
        "tokens_match": streams["sim"] == streams["sim_faulty"],
    }

    # the fault loop: stuck cells from tick 0, comparator offset injected
    # mid-run and lifted again; canary every tick, retirement + ladder on
    stuck_rate = 0.02
    inj = (
        FaultInjector()
        .at(4, "degrade_device", comparator_offset=2.0)
        .at(10, "recover_device")
    )
    eng = _engine(
        params, mcfg,
        ServeConfig(
            **serve,
            device_backend="sim_faulty",
            device_fault_config=FaultConfig(seed=0, stuck_rate=stuck_rate),
            canary_interval=1,
            tile_retire_threshold=stuck_rate / 2,
            degradation=DegradationPolicy(),
            fault_injector=inj,
        ),
    )
    drive_continuous(eng, trace)
    # idle recovery: the trace can drain while the ladder is still up
    # (recover_after clean canary passes per rung) — keep ticking the
    # empty engine so the canary can walk it back to 0, bounded so a
    # recovery bug degrades to a failed check instead of a hang
    for _ in range(64):
        if eng.metrics().degraded_mode == 0:
            break
        eng.tick()
    m = eng.metrics()
    reqs = list(eng.sched.all_requests())
    evicted = {
        r.rid for r in reqs
        if r.done_reason not in (None, "eos", "length")
    }
    all_served = all(
        r.done_reason in ("eos", "length") and len(r.output) > 0
        for r in reqs if r.rid not in evicted
    )
    faulted = {
        "accounting": m.analog,
        "degraded_mode_final": m.degraded_mode,
        "degraded_mode_max": max(
            [t["to"] for t in m.degraded_transitions], default=0
        ),
        "canary_probes": m.canary_probes,
        "canary_failures": m.canary_failures,
        "retired_tiles": m.retired_tiles,
        "redundant_read_events": m.redundant_read_events,
        "transitions": m.degraded_transitions,
        "evictions": dict(m.evictions),
        "all_served": all_served,
        "injected": [(t, k) for t, k, _ in inj.applied],
    }
    return {
        "n_requests": n_req,
        "stuck_rate": stuck_rate,
        "canary_interval": 1,
        "zero_fault": zero_fault,
        "faulted": faulted,
    }


def run(device=None, dry_run: bool = False) -> tuple[list[tuple[str, float, str]], dict]:
    """Every section at the reference's protocol (``dry_run``: its tiny
    traces on the smoke model); returns the CSV rows and the report."""
    dev = resolve_device(device)
    base = get_smoke_config("stablelm-3b")
    if dry_run:
        cfg = base
        trace_kw = dict(
            seed=0, n_req=4, mean_gap_ticks=1.0,
            prompt_len_range=(2, 8), new_tokens_range=(2, 6),
        )
        serve_cfg = ServeConfig(max_batch=2, max_new_tokens=8, max_len=64)
    else:
        cfg = dataclasses.replace(
            base, n_layers=4, d_model=128, d_ff=256, n_heads=4, n_kv_heads=4,
            d_head=32, max_seq=256,
        )
        trace_kw = dict(
            seed=0, n_req=16, mean_gap_ticks=1.5,
            prompt_len_range=(3, 25), new_tokens_range=(4, 17),
        )
        serve_cfg = ServeConfig(max_batch=4, max_new_tokens=16, max_len=128)
    params = init_lm(cfg, seed=0, device=dev)
    trace = make_trace(vocab=cfg.vocab, **trace_kw)
    rows: list[tuple[str, float, str]] = []
    report: dict = {"engines": {}, "paged_vs_dense": []}
    # continuous batching, digital argmax baseline
    m_greedy = _bench(
        dataclasses.replace(cfg, wta_head=False), params, trace, serve_cfg
    )
    rows.append(("serve_cb_greedy", m_greedy.wall_time * 1e6, m_greedy.row()))
    report["engines"]["cb_greedy_paged"] = _metrics_dict(m_greedy)
    # continuous batching, WTA stochastic-SoftMax head (paper sampler)
    for trials in (8, 32) if not dry_run else (8,):
        cfg_w = dataclasses.replace(
            cfg, wta_head=True,
            analog=dataclasses.replace(cfg.analog, wta_trials=trials),
        )
        m_wta = _bench(cfg_w, params, trace, serve_cfg)
        rows.append(
            (f"serve_cb_wta_T{trials}", m_wta.wall_time * 1e6, m_wta.row())
        )
        report["engines"][f"cb_wta_T{trials}"] = _metrics_dict(m_wta)
    # static-batch reference on the same trace
    stat = StaticServingEngine(
        params, dataclasses.replace(cfg, wta_head=False), serve_cfg, device=dev
    )
    drive_static(stat, trace)
    m_stat = stat.metrics()
    rows.append(("serve_static_greedy", m_stat.wall_time * 1e6, m_stat.row()))
    report["engines"]["static_greedy_dense"] = _metrics_dict(m_stat)
    rows.append(
        (
            "serve_occupancy_gain",
            0.0,
            f"continuous={m_greedy.occupancy_mean:.2f} "
            f"static={m_stat.occupancy_mean:.2f} "
            f"gain={m_greedy.occupancy_mean - m_stat.occupancy_mean:+.2f}",
        )
    )

    # paged-vs-dense decode latency across max_len (the perf trajectory the
    # report tracks).  Always the 4-layer bench model: the smoke model
    # is too small for decode cost to rise above dispatch overhead.
    pvd_cfg = dataclasses.replace(
        base, n_layers=4, d_model=128, d_ff=256, n_heads=4, n_kv_heads=4,
        d_head=32, max_seq=1024, wta_head=False,
    )
    pvd_params = init_lm(pvd_cfg, seed=0, device=dev)
    for ml in (128, 512):
        res = bench_paged_vs_dense(
            pvd_cfg, pvd_params, max_len=ml, n_req=6 if dry_run else 16
        )
        report["paged_vs_dense"].append(res)
        rows.append(
            (
                f"serve_paged_vs_dense_L{ml}",
                res["paged"]["decode_step_ms"] * 1e3,
                f"dense_ms={res['dense']['decode_step_ms']:.2f} "
                f"paged_ms={res['paged']['decode_step_ms']:.2f} "
                f"speedup={res['decode_speedup']:.2f}x "
                f"occ_dense={res['dense']['occupancy']:.2f} "
                f"occ_paged={res['paged']['occupancy']:.2f}",
            )
        )
    # int8 vs bf16 paged pool: decode latency + throughput at the same
    # max_len points, and the equal-memory admission capacity sweep
    report["paged_int8_vs_bf16"] = []
    for ml in (128, 512):
        res = bench_paged_int8(
            pvd_cfg, pvd_params, max_len=ml, n_req=6 if dry_run else 16
        )
        report["paged_int8_vs_bf16"].append(res)
        rows.append(
            (
                f"serve_paged_int8_L{ml}",
                res["int8"]["decode_step_ms"] * 1e3,
                f"bf16_ms={res['bf16']['decode_step_ms']:.2f} "
                f"int8_ms={res['int8']['decode_step_ms']:.2f} "
                f"speedup={res['decode_speedup']:.2f}x "
                f"tok_s_ratio={res['tokens_per_s_ratio']:.2f}x",
            )
        )
    cap = bench_int8_capacity(pvd_cfg, pvd_params)
    report["int8_capacity_sweep"] = cap
    rows.append(
        (
            "serve_int8_capacity",
            0.0,
            f"blocks={cap['num_kv_blocks']} "
            f"admitted_bf16={cap['admitted_bf16']} "
            f"admitted_int8={cap['admitted_int8']} "
            f"ratio={cap['capacity_ratio']:.2f}x",
        )
    )
    # prefix sharing on a repeated-prefix trace: prefill FLOPs saved +
    # admission capacity at equal num_kv_blocks, with byte-identity checked
    pfx = bench_prefix_sharing(
        pvd_cfg, pvd_params, n_req=6 if dry_run else 12
    )
    report["prefix_sharing"] = pfx
    rows.append(
        (
            "serve_prefix_sharing",
            0.0,
            f"prefills={pfx['off']['prefills']}->{pfx['on']['prefills']} "
            f"savings={pfx['prefill_savings']:.2f} "
            f"admitted={pfx['admitted_off']}->{pfx['admitted_on']} "
            f"capacity={pfx['capacity_ratio']:.2f}x "
            f"match={pfx['tokens_match']}",
        )
    )
    # suffix-only prefill on the shared-system-prompt trace: computed
    # prefill tokens + late-arrival TTFT with chunked interleaved prefill
    par = bench_partial_prefix(
        pvd_cfg, pvd_params, n_req=6 if dry_run else 10
    )
    report["partial_prefix"] = par
    rows.append(
        (
            "serve_partial_prefix",
            0.0,
            f"prefill_tokens={par['off']['prefill_tokens']}"
            f"->{par['on']['prefill_tokens']} "
            f"reduction={par['prefill_token_reduction']:.2f}x "
            f"partial_hits={par['on']['prefix_partial_hits']} "
            f"late_ttft={par['off']['late_ttft_ms']:.1f}"
            f"->{par['on']['late_ttft_ms']:.1f}ms "
            f"match={par['tokens_match']}",
        )
    )
    # preemptive scheduling on a bursty two-class trace: interactive tail
    # latency with spill/restore preemption on vs off, identity enforced
    pre = bench_preemption(
        pvd_cfg, pvd_params, n_each=2 if dry_run else 3
    )
    report["preemption"] = pre
    rows.append(
        (
            "serve_preemption",
            0.0,
            f"preempt={pre['on']['preemptions']} "
            f"restore={pre['on']['restores']} "
            f"inter_p99="
            f"{pre['off']['interactive'].get('ttft_p99_ms', 0):.1f}"
            f"->{pre['on']['interactive'].get('ttft_p99_ms', 0):.1f}ms "
            f"ratio={pre['interactive_p99_ratio']:.2f} "
            f"match={pre['tokens_match']}",
        )
    )
    # self-speculative decoding: draft-k + one-dispatch verify vs plain
    # decode on the same trace, byte-identity + tokens/s floor enforced.
    # Run on the dispatch-bound smoke config: the draft run repeats the
    # same model math as plain steps, so the measurable win is per-tick
    # host/dispatch amortization — on the compute-bound 4-layer model the
    # ratio pins to ~1.0 and the floor check would only measure noise
    spec_params = params if cfg is base else init_lm(base, seed=0, device=dev)
    # full-length trace even under --dry-run: the enforced ratio needs
    # enough steady-state tokens that scheduler jitter can't flip it
    spd = bench_speculative(base, spec_params, n_req=10)
    report["speculative_decode"] = spd
    rows.append(
        (
            "serve_speculative_decode",
            0.0,
            f"k={spd['speculate_k']} acc={spd['acceptance']:.2f} "
            f"tok_per_round={spd['tokens_per_round']:.2f} "
            f"tok_s={spd['plain']['tokens_per_s']:.1f}"
            f"->{spd['spec']['tokens_per_s']:.1f} "
            f"ratio={spd['tokens_per_s_ratio']:.2f}x "
            f"match={spd['tokens_match']}",
        )
    )
    # energy-per-token accounting under Table I pricing (RACA vs 1b-ADC),
    # count reconciliation + the RACA-cheaper inequality enforced by
    # validate_report on the report
    ept = bench_energy_per_token(
        pvd_cfg, pvd_params, n_req=4 if dry_run else 8
    )
    report["energy_per_token"] = ept
    rows.append(
        (
            "serve_energy_per_token",
            ept["raca_energy_pj_per_token"],
            f"raca={ept['raca_energy_pj_per_token']:.0f}pJ/tok "
            f"adc1b={ept['adc1b_energy_pj_per_token']:.0f}pJ/tok "
            f"raca_tops_w={ept['raca_tops_per_w']:.2f} "
            f"spec_overhead={ept['speculative']['overhead_ratio']:.2f}x "
            f"match={ept['speculative']['tokens_match']}",
        )
    )
    # fault tolerance: zero-knob identity vs sim, then the injected
    # device-fault loop (canary detect -> tile retirement -> degradation
    # ladder -> recovery), reconciled + reversibility-checked downstream
    ft = bench_fault_tolerance(
        pvd_cfg, pvd_params, n_req=4 if dry_run else 8
    )
    report["fault_tolerance"] = ft
    fa = ft["faulted"]
    rows.append(
        (
            "serve_fault_tolerance",
            0.0,
            f"zero_match={ft['zero_fault']['tokens_match']} "
            f"canary={fa['canary_failures']}/{fa['canary_probes']} "
            f"retired={fa['retired_tiles']} "
            f"redundant={fa['redundant_read_events']} "
            f"ladder_max={fa['degraded_mode_max']}"
            f"->final={fa['degraded_mode_final']} "
            f"served={fa['all_served']}",
        )
    )
    # sharded paged decode over the open group's mesh: token identity
    # against the unsharded engine, admission capacity over the data axis
    shd = bench_sharded_decode(
        pvd_cfg, pvd_params, n_req=6 if dry_run else 8
    )
    report["sharded_decode"] = shd
    rows.append(
        (
            "serve_sharded_decode",
            0.0,
            f"mesh=({shd['mesh']['data']},{shd['mesh']['model']}) "
            f"admitted={shd['admitted_single']}->{shd['admitted_sharded']} "
            f"capacity={shd['capacity_ratio']:.2f}x "
            f"match={shd['tokens_match']}",
        )
    )
    return rows, report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--dry-run", action="store_true",
        help="tiny traces on the smoke model",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device; the card when omitted, 'cpu' for the plain PyTorch path",
    )
    ap.add_argument(
        "--out", default="BENCH_serving_torch.json",
        help="where to write the machine-readable report",
    )
    ap.add_argument(
        "--validate", metavar="PATH",
        help="validate an existing report against the schema and exit",
    )
    args = ap.parse_args(argv)
    if args.validate:
        with open(args.validate) as f:
            validate_report(json.load(f))
        print(f"{args.validate}: schema OK")
        return
    rows, report = run(args.device, dry_run=args.dry_run)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    report["dry_run"] = args.dry_run
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    # round-trip the written report through the schema check: a report
    # that no longer parses as its own schema fails the run
    with open(args.out) as f:
        validate_report(json.load(f))
    print(f"wrote {args.out} (schema OK)")


if __name__ == "__main__":
    main()
