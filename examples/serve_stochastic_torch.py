"""Serve a small LM on the PyTorch/CUDA port with continuous batching,
comparing the digital greedy sampler against the paper's WTA stochastic
SoftMax sampling head, as ``examples/serve_stochastic.py`` does on the
reference: the same model (stablelm-3b's smoke config at 4 layers x 128),
the same four requests on three decode slots, the same ``ServeConfig``
and flags.

Four requests with different prompt lengths and token budgets share three
decode slots: the scheduler prefills each arrival into a free slot and
refills slots as short requests finish.  Two requests share a prompt, so
with prefix sharing (on by default) the repeat maps the resident prompt
blocks and skips its prefill.  ``--kv-dtype int8`` stores the paged KV
pool as stochastically rounded int8 codes + scale planes;
``--priority 0`` submits the requests as the interactive class;
``--deadline-ms N`` stamps a per-request deadline (evicted past it with
reason ``"deadline"``); ``--speculate-k K`` turns on self-speculative
decoding (K drafts a tick, one read-only verify).

On the card the decode step is compiled (CUDA graphs) and the attention,
int8 KV write and WTA sampler run their hand-written kernels; with
``--device cpu`` the same engine runs eagerly on their plain versions.
The weights are the port's seeded random init (seed 0), not the
reference's: the streams are arbitrary token ids.

    PYTHONPATH=src python examples/serve_stochastic_torch.py [--device cpu]
        [--kv-dtype int8] [--no-prefix-sharing] [--priority 0]
        [--deadline-ms 500] [--speculate-k 4]
"""

import argparse
import dataclasses

from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import init_lm
from repro_torch.serving import ServeConfig, ServingEngine

REQUESTS = [  # (prompt, max_new_tokens) — mixed lengths and budgets,
    ([11, 42, 7], 16),      # with one repeated prompt so the prefix
    ([3, 3, 3, 3], 6),      # index has something to dedup
    ([250, 1, 99, 5, 17], 12),
    ([11, 42, 7], 8),
]
MODES = (("greedy (digital argmax)", False), ("WTA stochastic votes (RACA)", True))


def model_config(kv_dtype: str = "same"):
    base = get_smoke_config("stablelm-3b")
    return dataclasses.replace(base, n_layers=4, d_model=128, d_ff=256,
                               n_heads=4, n_kv_heads=4, d_head=32,
                               max_seq=256, kv_cache_dtype=kv_dtype)


def serve(params, cfg, *, prefix_sharing=True, priority=1, deadline_ms=None,
          speculate_k=0, device=None):
    """Both samplers over ``REQUESTS``: [(mode, wta, rids, outputs, metrics)]."""
    runs = []
    for mode, wta in MODES:
        mcfg = dataclasses.replace(cfg, wta_head=wta)
        eng = ServingEngine(
            params, mcfg,
            ServeConfig(
                max_batch=3, max_new_tokens=16, max_len=128,
                # block == smallest bucket: short prompts fill whole
                # blocks, so the repeated prompt can share them while the
                # original is still decoding
                kv_block_size=8,
                enable_prefix_sharing=prefix_sharing,
                speculate_k=speculate_k,
            ),
            device=device,
        )
        rids = [eng.submit(p, n, priority=priority, deadline_ms=deadline_ms)
                for p, n in REQUESTS]
        outs = eng.run()
        runs.append((mode, wta, rids, outs, eng.metrics()))
        del eng
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted, 'cpu' for the plain PyTorch path")
    ap.add_argument("--kv-dtype", choices=("same", "int8"), default="same",
                    help="KV cache dtype; 'int8' = stochastic-rounded quantized pool")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable content-hash prompt-block sharing (COW paged pool)")
    ap.add_argument("--priority", type=int, default=1,
                    help="priority class for every request: 0 = interactive (preempts "
                         "lower classes under pool pressure), 1 = batch (default)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline in ms; past it the engine evicts with "
                         "reason 'deadline' (default: none)")
    ap.add_argument("--speculate-k", type=int, default=0,
                    help="self-speculative decoding: draft K tokens per tick, verify "
                         "in one read-only pass, roll back at the first mismatch "
                         "(0 = off; greedy output is byte-identical either way)")
    args = ap.parse_args(argv)

    cfg = model_config(args.kv_dtype)
    params = init_lm(cfg, seed=0, device=args.device)
    runs = serve(params, cfg, prefix_sharing=not args.no_prefix_sharing,
                 priority=args.priority, deadline_ms=args.deadline_ms,
                 speculate_k=args.speculate_k, device=args.device)
    for mode, _wta, rids, outs, m in runs:
        print(f"--- {mode} (kv_cache_dtype={args.kv_dtype}) ---")
        for rid, (p, _) in zip(rids, REQUESTS):
            print(f"  prompt={p} -> {outs.get(rid, [])}")
        print(
            f"  {m.completed} requests, {m.total_tokens} tokens: "
            f"{m.tokens_per_s:.1f} tok/s, "
            f"ttft {m.ttft_mean * 1e3:.0f}ms (p99 {m.ttft_p99 * 1e3:.0f}ms), "
            f"occupancy {m.occupancy_mean:.2f} "
            f"over {m.decode_steps} decode steps; "
            f"{m.prefills} prefills ({m.prefix_hits} prefix hits, "
            f"{m.prefix_partial_hits} partial hits, "
            f"{m.cow_forks} COW forks; "
            f"{m.prefill_tokens} prefill tokens computed, "
            f"{m.prefill_tokens_saved} saved); "
            f"{m.preemptions} preemptions, "
            f"evictions {m.evictions or '{}'}"
        )
        if m.spec_rounds:
            print(
                f"  speculative: {m.spec_rounds} rounds, acceptance "
                f"{m.spec_acceptance:.2f}, "
                f"{m.spec_tokens_per_round:.2f} tokens/round"
            )
    return runs


if __name__ == "__main__":
    main()
