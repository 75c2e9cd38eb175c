"""The yardstick's own arithmetic on the CPU: the traffic generator, the
percentiles and censored waits, the roofline counts, and the plain
reference against the port at smoke size."""

from __future__ import annotations

import collections
import math

import pytest
import torch

from _smoke import SMOKE_CONF  # noqa: F401  (puts src/ and the root on the path)
from perfbench import check as CK
from perfbench import common
from perfbench import roofline as RF
from perfbench import traffic as TG
from perfbench.drivers import serve
from perfbench.reference import model as RM
from perfbench.reference import threefry as TF
from perfbench.reference import wta as RW

CHAT = common.load_json(common.HERE / "traffic" / "chat_wta.json")
BATCH = common.load_json(common.HERE / "traffic" / "reasoning_batch.json")


@pytest.mark.parametrize("traffic", [CHAT, BATCH], ids=["open", "backlog"])
def test_traffic_is_the_seed_s_and_the_same_work_on_every_seed(traffic):
    a = TG.requests(traffic, 50304, 2**31 + 7, 40.0)
    b = TG.requests(traffic, 50304, 2**31 + 7, 40.0)
    c = TG.requests(traffic, 50304, 12345, 40.0)
    assert [(r.due, r.prompt, r.max_new) for r in a] == [(r.due, r.prompt, r.max_new) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in c]
    assert collections.Counter(len(r.prompt) for r in a) == collections.Counter(len(r.prompt) for r in c)
    assert collections.Counter(r.max_new for r in a) == collections.Counter(r.max_new for r in c)
    spec_p, spec_o = traffic["prompt_tokens"], traffic["output_tokens"]
    assert all(spec_p["min"] <= len(r.prompt) <= spec_p["max"] for r in a)
    k = traffic.get("in_progress", 0)   # met part-way through their outputs
    assert all(spec_o["min"] <= r.max_new <= spec_o["max"] for r in a[k:])
    assert all(1 <= r.max_new <= spec_o["max"] for r in a[:k])
    assert all(0 <= t < 50304 for r in a for t in r.prompt)


def test_arrange_puts_one_value_of_each_stratum_in_every_block():
    import numpy as np

    vals = list(range(100))
    out = TG.arrange(vals, np.random.Generator(np.random.PCG64(9)), 10)
    assert sorted(out) == vals
    for b in range(10):
        assert sorted(v // 10 for v in out[10 * b:10 * b + 10]) == list(range(10))
    assert out != TG.arrange(vals, np.random.Generator(np.random.PCG64(8)), 10)


def test_open_loop_arrivals_fill_lead_and_window_at_the_rate():
    reqs = TG.requests(CHAT, 50304, 3, 40.0)
    lead = CHAT["lead_s"]
    assert len(reqs) == round(CHAT["rate_rps"] * (lead + 40.0))
    dues = [r.due for r in reqs]
    assert dues == sorted(dues) and dues[0] == -lead and dues[-1] < 40.0
    med = sorted(len(r.prompt) for r in reqs)[len(reqs) // 2]
    assert abs(med - CHAT["prompt_tokens"]["median"]) <= 0.1 * CHAT["prompt_tokens"]["median"]


def test_percentile_and_censored_waits():
    assert common.percentile([], 95) is None
    assert common.percentile([5.0], 95) == 5.0
    assert common.percentile(list(range(101)), 95) == pytest.approx(95.0)
    assert common.percentile([1, 2, 3, 4], 50) == pytest.approx(2.5)
    recs = [serve.Rec(req=None, due=d, bucket=16, first=f) for d, f in
            [(-1.0, 0.5), (0.0, 0.25), (1.0, None), (9.0, 12.0), (10.0, None)]]
    ttft, n = serve.ttft_ms(recs, 0.0, 10.0, "open")
    # the lead-in request and the one due at the window's end are not the window's;
    # a request still waiting, or served after the end, counts its wait so far
    assert n == 3 and ttft == pytest.approx([250.0, 9000.0, 1000.0])


def test_roofline_counts_by_hand():
    # two decoding rows of 100 and 300 keys, 2 layers, 4 heads of 8, 2 kv heads
    nbytes, flops = RF.decode_attention([100, 300], 2, 4, 2, 8)
    assert nbytes == 2 * (400 * 2 * 8 * 2 * 2 + 2 * 4 * 8 * (2 + 4))
    assert flops == 2 * 4 * 400 * 4 * 8
    # a chunk of 3 queries from position 5 sees 6 + 7 + 8 keys, its context 8 keys
    nbytes, flops = RF.prefill_attention(5, 3, 1, 4, 2, 8)
    assert flops == 4 * 21 * 4 * 8
    assert nbytes == 8 * 2 * 8 * 2 * 2 + 3 * 4 * 8 * 6
    assert RF.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert RF.bound_s(0.0, 989e12) == pytest.approx(1.0)


def test_stablelm_3b_weights_a_token():
    from repro_torch.configs import get_config

    cfg = get_config("stablelm-3b")
    attn = 4 * 2560 * 2560
    mlp = 3 * 2560 * 6912
    assert RF.token_weights(cfg) == 32 * (attn + mlp) + 2560 * 50304
    moe = get_config("granite-moe-3b-a800m")
    per = 1536 * 64 * (2 * 24 + 2 * 8) + 1536 * 40 + 8 * 3 * 1536 * 512
    assert RF.token_weights(moe) == 32 * per + 1536 * 49155


def test_buckets_and_groups():
    assert CK.buckets({"max_len": 2048})[:3] == [8, 16, 32] and CK.buckets({"max_len": 2048})[-1] == 2048
    assert CK.bucket_of(193, CK.buckets({"max_len": 2048})) == 256
    assert CK.prefill_groups(1024, {"prefill_chunk": 512}) == [(0, 512), (512, 1024)]
    assert CK.prefill_groups(256, {"prefill_chunk": 512}) == [(0, 256)]


def test_threefry_and_normal_equal_the_port_s():
    from repro_torch import random as R

    key = R.fold_in(R.fold_in(R.PRNGKey(2**31 + 5), 17), 3)
    assert TF.fold_in(TF.fold_in(TF.prng_key(2**31 + 5), 17), 3) == key
    idx = torch.arange(0, 4096, dtype=torch.int64)
    got = TF.normal_at(torch.tensor(key[0]), torch.tensor(key[1]), idx)
    assert torch.equal(got, R.normal(key, (4096,)))


def test_wta_reference_elects_the_port_s_token():
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(0)
    z = torch.randn(6, 300, generator=g) * 2
    keys = torch.tensor([TF.fold_in((0, 11), i) for i in range(6)], dtype=torch.int64)
    sigma, vth = RW.sigma_vth(1.0)
    counts, _ = ref.wta_trial_counts_ref(z, keys, None, n_trials=32, vth0=vth, sigma_z=sigma,
                                         layout=(300, 0))
    chosen = counts.argmax(-1)
    r = RW.race(z, keys, 32, 1.0, chosen)
    assert torch.equal(RW.vote_winner(r), chosen)
    assert torch.all(RW.vote_gap(r, chosen) == 0)
    other = (chosen + 1) % 300
    assert torch.all(RW.vote_gap(RW.race(z, keys, 32, 1.0, other), other) > 0)


def test_wta_vote_gap_by_hand():
    # three trials, vth 0: token 2 wins trials 0 and 1 by 1.0 and 0.2, token 1
    # wins trial 2 by 3.0.  Token 2's vote needs no error; token 1 ties 1 : 1
    # (and wins it, the lower id) once trial 1 is undecided (g ≥ 0.2) and it
    # could take trial 1 (g ≥ 5 - 4.8 = 0.2); token 0 never won a trial and
    # needs g ≥ 1, where it could win trial 1 (g ≥ 5 - 4 = 1.0), tying token
    # 1's one decided vote with the lower id.
    r = {"vth": 0.0,
         "top": torch.tensor([[6.0, 5.0, 9.0]]).repeat(3, 1),
         "second": torch.tensor([[5.0, 4.8, 6.0]]).repeat(3, 1),
         "win": torch.tensor([[2, 2, 1]]).repeat(3, 1)}
    r["vs"] = torch.tensor([[6.0, 5.0, 3.0], [4.0, 4.8, 9.0], [1.0, 4.0, 2.0]])
    got = RW.vote_gap(r, torch.tensor([2, 1, 0]))
    assert got.tolist() == pytest.approx([0.0, 0.2, 1.0])


def _port_params(cfg, seed):
    from repro_torch.models import transformer as T

    p = T.init_lm(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for leaf in (p["final_norm"], p["units"]["l0"]["ln1"], p["units"]["l0"]["ln2"]):
        leaf["scale"].copy_(torch.randn(leaf["scale"].shape, generator=g) * 0.1)
    return p


@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-moe-3b-a800m"])
def test_reference_equals_the_port_s_forward_at_smoke_size(arch):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)   # drops tokens
    p = _port_params(cfg, 3)
    tokens = torch.randint(0, cfg.vocab, (1, 40), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want, _ = T.lm_forward(p, tokens, cfg)
    conf = {"hidden_act": "silu", "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "num_hidden_layers": cfg.n_layers, "num_key_value_heads": cfg.n_kv_heads,
            "head_dim": cfg.head_dim, "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_embeddings, "num_local_experts": cfg.n_experts,
            "num_experts_per_tok": cfg.moe_topk, "capacity_factor": cfg.capacity_factor}
    got = RM.logits(p, RM.Sizes.from_config(conf), tokens[0].tolist(), 0, [(0, 40)])
    assert torch.allclose(got, want[0], atol=2e-5, rtol=1e-5), (got - want[0]).abs().max()
    if cfg.n_experts:
        keep = RM.capacity_keep(torch.tensor([[0, 1], [0, 2], [0, 1], [3, 0]]), [(0, 4)], 8, 1.0)
        # C = max(int(4·2·1/8), 2) = 2: expert 0's third and fourth assignments drop
        assert keep.tolist() == [[True, True], [True, True], [False, True], [True, False]]


def test_fp8_control_moves_the_logits():
    conf = dict(SMOKE_CONF["decoder_lm"], hidden_act="silu", rms_norm_eps=1e-6, rope_theta=1e4,
                tie_word_embeddings=False)
    sz = RM.Sizes.from_config(conf)
    from repro_torch.configs import get_smoke_config
    p = _port_params(get_smoke_config("stablelm-3b"), 5)
    toks = list(range(1, 30))
    z = RM.logits(p, sz, toks, 0)
    zc = RM.logits(p, sz, toks, 0, quant="fp8")
    err = (z - zc).abs().max().item()
    assert 1e-3 < err < math.inf


def test_what_the_reference_lacks_is_refused():
    conf = common.load_json(common.HERE / "configs" / "stablelm-3b.json")
    fam = common.by_name("families", conf["family"])
    for bad in (dict(conf, hidden_act="gelu"), dict(conf, layer_pattern=["local", "global"])):
        with pytest.raises(NotImplementedError):
            fam.model_config(bad, CHAT)
        with pytest.raises(NotImplementedError):
            fam.reference.Sizes.from_config(bad)
    with pytest.raises(SystemExit):
        common.by_name("drivers", "train")
