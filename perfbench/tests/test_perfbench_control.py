"""The control of each cell's output check, at a size a test run holds:
the reference computed in fp8 e4m3 in the program's place reads a larger
number (``check.readings(control=True)``, ``check.number``) than the
program does, on the same prompts and served tokens.  The program serves a
fixed set of requests to the end on the CPU, so the readings repeat.  On
the card, at the cells' own sizes, ``perfbench/calibrate.py`` reads the two
numbers each limit was set from."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _smoke import smoke
from perfbench import check as CK
from perfbench import common

MID = {
    "decoder_lm": dict(num_hidden_layers=4, hidden_size=256, intermediate_size=512,
                       num_attention_heads=4, num_key_value_heads=4, head_dim=64, vocab_size=512),
    "moe_lm": dict(num_hidden_layers=4, hidden_size=256, intermediate_size=128,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=64, vocab_size=4096,
                   num_local_experts=8, num_experts_per_tok=2),
}


def _served(conf: dict, traffic: dict, seed: int) -> tuple[dict, list]:
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    fam = common.by_name("families", conf["family"])
    mcfg = fam.model_config(conf, traffic)
    params = fam.make_weights(mcfg, seed, torch.device("cpu"))
    engine = ServingEngine(params, mcfg, ServeConfig(seed=seed, max_new_tokens=1, **traffic["engine"]),
                           device="cpu")
    rng = np.random.Generator(np.random.PCG64(seed))
    prompts = [rng.integers(0, mcfg.vocab, size=int(n)).tolist() for n in rng.integers(8, 40, 8)]
    rids = [engine.submit(p, max_new_tokens=32) for p in prompts]
    out = engine.run()
    return params, [{"rid": r, "prompt": p, "served": out[r], "done": True} for r, p in zip(rids, prompts)]


@pytest.mark.parametrize("cell", ["stablelm-3b.chat_wta", "granite-moe-3b-a800m.reasoning_batch"])
def test_fp8_control_reads_wider_gaps_than_the_program(cell):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, _, conf, traffic = common.cell_files(common.benchmark(), cell)
        conf, traffic, _ = smoke(conf, traffic, {})
        conf = dict(conf, **MID[conf["family"]])
        traffic = dict(traffic, engine=dict(traffic["engine"], max_len=128, max_batch=8))
        ref = common.by_name("families", conf["family"]).reference
        prog, ctrl = [], []
        for seed in (1, 2, 3):
            params, recs = _served(conf, traffic, seed)
            sampler = traffic["sampler"]
            prog.append(CK.number(sampler, CK.readings(params, ref, conf, traffic, recs, seed))[1])
            ctrl.append(CK.number(sampler, CK.readings(params, ref, conf, traffic, recs, seed,
                                                       control=True))[1])
    finally:
        torch.set_num_threads(n)
    print(cell, prog, ctrl)
    assert max(ctrl) > 2 * max(prog) and sum(c > p for c, p in zip(ctrl, prog)) >= 2, (prog, ctrl)
