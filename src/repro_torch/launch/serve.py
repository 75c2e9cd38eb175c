"""Serving launcher: the paged continuous-batching engine against a
randomly initialized model, greedy or WTA sampling.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
        [--smoke] [--device cpu] [--requests 4] [--new-tokens 16] \\
        [--kv-dtype int8] [--wta [--n-redundant-reads 3]] [--priority 0] \
        [--deadline-ms MS] [--no-preemption] [--spill-budget-bytes N] \
        [--speculate-k K] \
        [--device-backend sim_faulty [--stuck-rate R] [--drift-nu NU] \
         [--read-sigma-inflation I] [--comparator-offset O] [--fault-seed S]] \
        [--canary-interval N] [--tile-retire-threshold T] [--degrade]

Runs on the card unless ``--device cpu`` is given.  On the card the
engine's decode step is compiled: one CUDA graph per decode window width
and redundant-read factor (with ``--speculate-k``, one per width for the
fused draft + verify round), captured on first use and replayed, dropped
and captured again when the fault backend's state moves (the last line
prints ``compile_counts()``); on the CPU it runs eagerly.  The energy line
is the Table I cost model's pricing of the analog events the run drove
(a model of the paper's accelerator, not a measurement of the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.backend import FaultConfig
from repro_torch.models.transformer import init_lm
from repro_torch.serving import DegradationPolicy, ServeConfig, ServingEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted, 'cpu' for "
                         "the plain PyTorch path")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--wta", action="store_true",
                    help="WTA stochastic SoftMax sampling (the paper's head)")
    ap.add_argument("--n-redundant-reads", type=int, default=1,
                    help="comparator re-reads per WTA sample, majority-voted "
                         "(1 = single read)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (continuous-batching batch width)")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="pool size in blocks; 0 = every slot at max_len")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable content-hash prompt-block sharing with "
                         "copy-on-write in the paged pool")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="max prefill tokens computed per engine tick "
                         "(0 = whole bucket at once)")
    ap.add_argument("--kv-dtype", choices=["same", "int8"], default="same",
                    help="KV pool storage: the model dtype, or int8 codes "
                         "with per-row scales written by stochastic rounding")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompts and the WTA "
                         "sampler's base key")
    ap.add_argument("--priority", type=int, default=1,
                    help="priority class of the submitted requests: 0 = "
                         "interactive (may preempt lower classes, spilling "
                         "their KV pages to host), 1 = batch (default; shed "
                         "first at degradation level 3)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline in ms from submission; a "
                         "request past it is evicted with reason "
                         "'deadline' (default: none)")
    ap.add_argument("--no-preemption", action="store_true",
                    help="disable priority preemption (higher-priority "
                         "arrivals back-pressure instead of spilling a "
                         "lower-priority victim's KV pages to host)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="self-speculative decoding: draft K tokens a tick "
                         "through the compiled decode step, verify the run in "
                         "one read-only step, roll back at the first mismatch "
                         "(0 = off)")
    ap.add_argument("--spill-budget-bytes", type=int, default=None,
                    help="cap on host bytes held by preemption spill "
                         "records; the oldest drop at the cap and their "
                         "requests recompute from the prompt on restore "
                         "(default: unbounded)")
    ap.add_argument("--device-backend", default="sim",
                    help="analog device backend: 'sim' (ideal math) or "
                         "'sim_faulty' (seeded ReRAM fault model: stuck "
                         "cells, conductance drift, readout noise)")
    ap.add_argument("--stuck-rate", type=float, default=0.0,
                    help="fraction of crossbar cells stuck at SA0/SA1 "
                         "(sim_faulty; split evenly between the rails)")
    ap.add_argument("--drift-nu", type=float, default=0.0,
                    help="conductance drift exponent: multiplier "
                         "(1+clock)^-nu on the fault clock (sim_faulty)")
    ap.add_argument("--read-sigma-inflation", type=float, default=0.0,
                    help="fractional inflation of comparator read-noise "
                         "sigma (sim_faulty)")
    ap.add_argument("--comparator-offset", type=float, default=0.0,
                    help="additive comparator threshold offset in "
                         "normalized units (sim_faulty)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the deterministic stuck-cell maps "
                         "(sim_faulty)")
    ap.add_argument("--canary-interval", type=int, default=0,
                    help="run a known-answer crossbar canary probe every "
                         "N engine ticks (0 = off); failures feed the "
                         "degradation ladder and tile retirement")
    ap.add_argument("--tile-retire-threshold", type=float, default=0.0,
                    help="retire crossbar tiles whose stuck-cell density "
                         "exceeds this fraction after a canary failure "
                         "(0 = never retire)")
    ap.add_argument("--degrade", action="store_true",
                    help="enable the graceful-degradation ladder (raise "
                         "redundant reads -> shed batch admissions) driven "
                         "by canary failures and sanity evictions")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, wta_head=args.wta, kv_cache_dtype=args.kv_dtype)
    params = init_lm(cfg, seed=args.seed, device=args.device)
    fault_cfg = None
    if args.device_backend == "sim_faulty":
        fault_cfg = FaultConfig(
            seed=args.fault_seed,
            stuck_rate=args.stuck_rate,
            drift_nu=args.drift_nu,
            read_sigma_inflation=args.read_sigma_inflation,
            comparator_offset=args.comparator_offset,
        )
    eng = ServingEngine(
        params, cfg,
        ServeConfig(
            max_batch=args.slots,
            max_new_tokens=args.new_tokens,
            max_len=args.max_len,
            kv_block_size=args.kv_block_size,
            num_kv_blocks=args.kv_blocks,
            enable_prefix_sharing=not args.no_prefix_sharing,
            prefill_chunk=args.prefill_chunk,
            seed=args.seed,
            n_redundant_reads=args.n_redundant_reads,
            device_backend=args.device_backend,
            device_fault_config=fault_cfg,
            canary_interval=args.canary_interval,
            tile_retire_threshold=args.tile_retire_threshold,
            degradation=DegradationPolicy() if args.degrade else None,
            enable_preemption=not args.no_preemption,
            spill_budget_bytes=args.spill_budget_bytes,
            speculate_k=args.speculate_k,
        ),
        device=args.device,
    )
    rng = np.random.default_rng(args.seed + 7)
    for _ in range(args.requests):
        n = int(rng.integers(2, 9))
        eng.submit(rng.integers(0, cfg.vocab, n).tolist(), priority=args.priority,
                   deadline_ms=args.deadline_ms)
    t0 = time.perf_counter()
    outs = eng.step()
    dt = time.perf_counter() - t0
    m = eng.metrics()
    total = sum(len(o) for o in outs)
    print(
        f"served {len(outs)} requests, {total} tokens in {dt:.2f}s on "
        f"{eng.device} ({total / max(dt, 1e-9):.1f} tok/s, ttft "
        f"{m.ttft_mean * 1e3:.0f}ms p99 {m.ttft_p99 * 1e3:.0f}ms, "
        f"step {m.decode_step_ms:.2f}ms, occupancy {m.occupancy_mean:.2f}, "
        f"prefix hits {m.prefix_hits}, partial hits {m.prefix_partial_hits}, "
        f"prefill tokens saved {m.prefill_tokens_saved}, kv={args.kv_dtype}, "
        f"sampler={f'wta R={args.n_redundant_reads}' if args.wta else 'greedy'})"
    )
    print(
        f"preemptions {m.preemptions} (restores {m.restores}, spill drops "
        f"{m.spill_drops}); done reasons "
        + ", ".join(f"{k}={v}" for k, v in sorted(m.evictions.items()))
    )
    if m.spec_rounds:
        print(
            f"speculation k={args.speculate_k}: {m.spec_rounds} rounds, "
            f"{m.spec_accepted}/{m.spec_drafted} drafts accepted "
            f"({m.spec_acceptance:.2f}), {m.spec_tokens_per_round:.2f} tokens a round"
        )
    if m.canary_probes or m.degraded_mode or m.degraded_transitions:
        print(
            f"fault tolerance: degraded_mode {m.degraded_mode}, "
            f"canary {m.canary_failures}/{m.canary_probes} failed, "
            f"retired tiles {m.retired_tiles}, "
            f"redundant reads {m.redundant_read_events}, "
            f"transitions {len(m.degraded_transitions)}"
        )
    a = m.analog
    tc = a["tokens_computed"]
    print(
        f"energy (Table I pricing, {a['backend']} backend): "
        f"computed {tc['total']} tokens "
        f"(prefill {tc['prefill']}, decode {tc['decode']}, "
        f"draft {tc['draft']}) for {a['tokens_published']} published; "
        f"RACA {a['raca']['energy_pj_per_token']:.0f} pJ/tok "
        f"({a['raca']['tops_per_w_effective']:.2f} TOPS/W), "
        f"1b-ADC {a['adc1b']['energy_pj_per_token']:.0f} pJ/tok "
        f"({a['adc1b']['tops_per_w_effective']:.2f} TOPS/W)"
    )
    for o in outs:
        print("  ->", o)
    print(f"compile counts {eng.compile_counts()}")


if __name__ == "__main__":
    main()
