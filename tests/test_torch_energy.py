"""Energy accounting of the port's engine (``ServingMetrics.analog``, the
device backend's Table I tallies) against ``repro``'s, on the CPU.

The port and the reference serve the same shared-prefix chunked trace
(cold prompts, full and partial prefix hits, copy-on-write, prompts that
queue) from the same f32 weights: a bf16-dtype pool, an int8 pool, and WTA
sampling at R = 1 and 3.  The snapshots must match: every integer count
exactly, every price within 1e-12 relative (the two cost models are the
same Python arithmetic, so they are in fact equal).  Then the reference's
invariances, on the port alone: the tallies do not depend on batch
composition or on the prefix-sharing flag, and a sharing hit accounts
only the tokens it computed, and speculation's gross counts keep their
documented relation to plain decode's, with ``repro``'s counts
(``tests/test_energy_accounting.py``).

The reference's 1×1-mesh case (red on jax 0.9 in the reference itself,
ROADMAP C) is ``tests/test_torch_sharded_serving.py``'s
``test_counts_invariant_to_1x1_mesh``.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.launch import specs as JSP
from repro.models import transformer as JTF
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import cost_model as CM
from repro_torch.launch import specs as SP
from repro_torch.models.transformer import init_lm
from repro_torch.serving import ServeConfig, ServingEngine

PRICE_RTOL = 1e-12
SERVE = dict(
    max_batch=4, max_new_tokens=6, max_len=64, kv_block_size=8,
    prefill_chunk=16, prefill_buckets=(12, 16, 32, 36, 48), seed=5,
)
INT_KEYS = ("backend", "tokens_computed", "tokens_published", "sample_events",
            "kv_written_tokens", "redundant_read_events", "counts", "per_token_counts",
            "per_sample_counts", "per_kv_token_counts", "per_redundant_counts")


def _trace():
    """``tests/test_torch_graphs.py``'s shared-prefix trace."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, 24).tolist()
    y = rng.integers(0, 256, 12).tolist()
    x = rng.integers(0, 256, 32).tolist()
    a = prefix + rng.integers(0, 256, 12).tolist()
    return [y, y, x, a, prefix + rng.integers(0, 256, 12).tolist(), x,
            rng.integers(0, 256, 5).tolist(), prefix + rng.integers(0, 256, 12).tolist(),
            rng.integers(0, 256, 40).tolist()]


def _bridged(kv: str, wta: bool, seed: int):
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), dtype="float32", kv_cache_dtype=kv,
                               wta_head=wta)
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32",
                               kv_cache_dtype=kv, wta_head=wta)
    jp = JTF.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p)
    return eng.run()


def assert_snapshots_match(ours: dict, theirs: dict) -> None:
    for k in INT_KEYS:
        assert ours[k] == theirs[k], k
    for scheme in ("raca", "adc1b"):
        for k, v in theirs[scheme].items():
            assert ours[scheme][k] == pytest.approx(v, rel=PRICE_RTOL, abs=0), (scheme, k)


@pytest.mark.parametrize("kv,wta,reads,seed", [
    ("same", False, 1, 1), ("int8", False, 1, 2), ("same", True, 1, 1), ("same", True, 3, 1),
], ids=["bf16", "int8", "wta", "wta_r3"])
def test_analog_snapshot_matches_reference(kv, wta, reads, seed):
    jcfg, jp, tcfg, tp = _bridged(kv, wta, seed)
    scfg = dict(SERVE, n_redundant_reads=reads)
    j_eng = JServingEngine(jp, jcfg, JServeConfig(**scfg))
    t_eng = ServingEngine(tp, tcfg, ServeConfig(**scfg), device="cpu")
    assert _serve(t_eng, _trace()) == _serve(j_eng, _trace())
    ours, theirs = t_eng.metrics(), j_eng.metrics()
    assert_snapshots_match(ours.analog, theirs.analog)
    assert ours.redundant_read_events == theirs.redundant_read_events
    assert ours.prefix_hits >= 1 and ours.prefix_partial_hits >= 1
    a = ours.analog
    assert a["tokens_published"] == ours.total_tokens
    assert a["redundant_read_events"] == (reads - 1) * a["tokens_computed"]["decode"]
    if kv == "int8":
        assert a["counts"]["stoch_round_events"] > 0
    if wta:
        assert a["counts"]["wta_samples"] == a["sample_events"] > 0


@pytest.mark.parametrize("entry,kw", [
    ("suffix_prefill", {"tokens": 16}), ("sample0", {}),
    ("serve_step", {"batch": 3, "redundant": 4}), ("spec_round", {"batch": 2, "k": 3}),
    ("page_copy", {}), ("page_spill", {}), ("page_restore", {}), ("state_gather", {}),
    ("state_insert", {}), ("spec_rollback", {}),
])
def test_call_profiles_equal_reference(entry, kw):
    assert SP.analog_call_profile(entry, **kw) == JSP.analog_call_profile(entry, **kw)


def test_unknown_call_profile_raises():
    with pytest.raises(ValueError, match="unknown serving entry point 'decode'"):
        SP.analog_call_profile("decode")


# ---------------------------------------------------------------------------
# The reference's invariances, on the port
# ---------------------------------------------------------------------------

PROMPTS = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5], [4, 4, 4, 4, 4, 4]]


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("stablelm-3b")
    return cfg, init_lm(cfg, seed=0, device="cpu")


def _arrivals(cfg, params, prompts, arrivals, **kw):
    """Drive ``prompts`` with per-request arrival ticks; return metrics."""
    eng = ServingEngine(params, cfg, ServeConfig(max_batch=2, max_new_tokens=4, max_len=64,
                                                 kv_block_size=8, **kw), device="cpu")
    order = sorted(range(len(prompts)), key=lambda i: arrivals[i])
    i = tick = 0
    while i < len(order) or eng.sched.has_work():
        while i < len(order) and arrivals[order[i]] <= tick:
            eng.submit(prompts[order[i]])
            i += 1
        eng.tick()
        tick += 1
    return eng.metrics()


def test_counts_invariant_to_batch_composition(smoke):
    """Burst and trickle arrivals (different slot co-residency every tick)
    account the same totals, which reconcile exactly against the
    per-event shape counts: padding is never logical work."""
    burst = _arrivals(*smoke, PROMPTS, [0, 0, 0, 0])
    trickle = _arrivals(*smoke, PROMPTS, [0, 3, 6, 9])
    for k in ("counts", "tokens_computed", "sample_events"):
        assert burst.analog[k] == trickle.analog[k], k
    a = burst.analog
    expected = (
        CM.AnalogOpCounts.from_dict(a["per_token_counts"]).scaled(a["tokens_computed"]["total"])
        + CM.AnalogOpCounts.from_dict(a["per_sample_counts"]).scaled(a["sample_events"])
        + CM.AnalogOpCounts.from_dict(a["per_kv_token_counts"]).scaled(a["kv_written_tokens"])
        + CM.AnalogOpCounts.from_dict(a["per_redundant_counts"]).scaled(
            a["redundant_read_events"])
    )
    assert expected.as_dict() == a["counts"]
    assert a["redundant_read_events"] == 0


def test_counts_invariant_to_prefix_sharing_flag(smoke):
    on = _arrivals(*smoke, PROMPTS, [0, 1, 2, 3], enable_prefix_sharing=True)
    off = _arrivals(*smoke, PROMPTS, [0, 1, 2, 3], enable_prefix_sharing=False)
    assert on.analog["counts"] == off.analog["counts"]
    assert on.analog["tokens_computed"] == off.analog["tokens_computed"]


def test_sharing_hits_account_only_computed_tokens(smoke):
    """Repeated prompts with sharing on skip prefill compute: the tally
    drops by exactly the skipped tokens, and the energy follows."""
    prompts = [[7, 7, 7, 1, 2, 3, 4, 5]] * 3
    on = _arrivals(*smoke, prompts, [0, 2, 4], enable_prefix_sharing=True)
    off = _arrivals(*smoke, prompts, [0, 2, 4], enable_prefix_sharing=False)
    assert on.total_tokens == off.total_tokens
    tc_on, tc_off = on.analog["tokens_computed"], off.analog["tokens_computed"]
    assert on.prefix_hits > 0 and on.prefill_tokens_saved > 0
    assert tc_on["prefill"] + on.prefill_tokens_saved == tc_off["prefill"]
    assert tc_on["decode"] == tc_off["decode"]
    assert on.analog["raca"]["energy_pj_gross"] < off.analog["raca"]["energy_pj_gross"]


def test_speculative_gross_vs_published_relationship():
    """``speculate_k = 2`` against plain decode at equal published streams:
    gross counts grow (every round forwards k drafted and k verify
    positions whether or not they publish), in the documented relation,
    and every count and price equals ``repro``'s at the same k."""
    jcfg, jp, tcfg, tp = _bridged("same", False, 1)
    k = 2
    plain = _arrivals(tcfg, tp, PROMPTS[:3], [0, 0, 0], speculate_k=0)
    spec = _arrivals(tcfg, tp, PROMPTS[:3], [0, 0, 0], speculate_k=k)
    j_eng = JServingEngine(jp, jcfg, JServeConfig(max_batch=2, max_new_tokens=4, max_len=64,
                                                  kv_block_size=8, speculate_k=k))
    _serve(j_eng, PROMPTS[:3])
    assert_snapshots_match(spec.analog, j_eng.metrics().analog)
    assert spec.spec_rounds == j_eng.metrics().spec_rounds > 0
    # the same streams publish the same totals
    assert spec.total_tokens == plain.total_tokens
    assert spec.analog["tokens_published"] == plain.analog["tokens_published"]
    tc = spec.analog["tokens_computed"]
    # whole k-deep rounds of drafts, a verify re-decode for each (plain
    # fallback ticks may add decode, never take it away)
    assert tc["draft"] > 0 and tc["draft"] % k == 0
    assert tc["decode"] >= tc["draft"]
    assert plain.analog["tokens_computed"]["draft"] == 0
    assert tc["prefill"] == plain.analog["tokens_computed"]["prefill"]
    # rejected and unpublished drafts cost energy: gross and per published
    # token both grow
    assert spec.analog["raca"]["energy_pj_gross"] > plain.analog["raca"]["energy_pj_gross"]
    assert (spec.analog["raca"]["energy_pj_per_token"]
            > plain.analog["raca"]["energy_pj_per_token"])


def test_int8_and_wta_add_their_event_classes(smoke):
    """int8 KV adds stochastic-rounding events, the WTA head comparator
    votes; the crossbar, tile and DAC counts stay equal."""
    cfg, params = smoke
    base = _arrivals(cfg, params, PROMPTS[:2], [0, 0]).analog
    q = _arrivals(dataclasses.replace(cfg, kv_cache_dtype="int8"), params, PROMPTS[:2],
                  [0, 0]).analog
    assert base["counts"]["stoch_round_events"] == 0
    assert q["counts"]["stoch_round_events"] == (
        q["kv_written_tokens"] * q["per_kv_token_counts"]["stoch_round_events"]) > 0
    for key in ("macs", "tile_reads", "dac_conversions"):
        assert base["counts"][key] == q["counts"][key]
    wcfg = dataclasses.replace(cfg, wta_head=True,
                               analog=dataclasses.replace(cfg.analog, wta_trials=8))
    w = _arrivals(wcfg, params, PROMPTS[:2], [0, 0]).analog
    assert w["counts"]["comparator_decisions"] == (
        base["counts"]["comparator_decisions"] + w["sample_events"] * 8 * cfg.vocab)


def test_metrics_row_prints_the_modelled_energy(smoke):
    m = _arrivals(*smoke, PROMPTS[:1], [0])
    row = m.row()
    assert f"raca_pj_per_tok={m.analog['raca']['energy_pj_per_token']:.0f}" in row
    assert "adc1b_pj_per_tok=" in row and m.analog["backend"] == "sim"
