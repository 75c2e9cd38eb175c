"""Serving launcher: the paged continuous-batching engine against a
randomly initialized model, greedy or WTA sampling.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
        [--smoke] [--device cpu] [--requests 4] [--new-tokens 16] \\
        [--kv-dtype int8] [--wta [--n-redundant-reads 3]]

Runs on the card unless ``--device cpu`` is given.  On the card the
engine's decode step is compiled: one CUDA graph per decode window width,
captured on first use and replayed (the last line prints
``compile_counts()``); on the CPU it runs eagerly.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.transformer import init_lm
from repro_torch.serving import ServeConfig, ServingEngine


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
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, wta_head=args.wta, kv_cache_dtype=args.kv_dtype)
    params = init_lm(cfg, seed=args.seed, device=args.device)
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
        ),
        device=args.device,
    )
    rng = np.random.default_rng(args.seed + 7)
    for _ in range(args.requests):
        n = int(rng.integers(2, 9))
        eng.submit(rng.integers(0, cfg.vocab, n).tolist())
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
    for o in outs:
        print("  ->", o)
    print(f"compile counts {eng.compile_counts()}")


if __name__ == "__main__":
    main()
