"""Smoke-sized overrides that let a cell's whole run (weights, engine,
window, output check) go on the CPU in a test: the configuration's widths
cut to the port's smoke sizes, the traffic to a few short requests and
the KV pool to the engine's default, which fits every slot."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_CONF = {
    "decoder_lm": dict(num_hidden_layers=2, hidden_size=64, intermediate_size=128,
                       num_attention_heads=4, num_key_value_heads=4, head_dim=16, vocab_size=256),
    "moe_lm": dict(num_hidden_layers=2, hidden_size=64, intermediate_size=32,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=16, vocab_size=256,
                   num_local_experts=8, num_experts_per_tok=2),
}


def smoke(conf: dict, traffic: dict, lim: dict):
    conf = dict(conf, **SMOKE_CONF[conf["family"]])
    t = dict(traffic)
    t.update(lead_s=0.3, trace_ticks=4,
             prompt_tokens={"median": 12, "sigma": 0.5, "min": 4, "max": 40},
             output_tokens={"median": 6, "sigma": 0.5, "min": 2, "max": 12},
             engine=dict(traffic["engine"], max_batch=4, max_len=64, prefill_chunk=16, num_kv_blocks=0),
             check={"requests": 4, "min_tokens": 24})
    if t["loop"] == "open":
        t["rate_rps"] = 6.0
    else:
        t["backlog"] = 12
    return conf, t, lim
