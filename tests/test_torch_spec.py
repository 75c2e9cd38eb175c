"""Self-speculative decoding: the port's fused round, its rollback and the
engine's speculative ticks against ``repro`` on the CPU.

The counterparts of ``tests/test_specs.py``'s spec-round tests and of
``tests/test_serving.py``'s speculation tests (all but the sharded one).
Everything runs the smoke ``stablelm-3b`` at f32 from weights bridged
from ``repro``'s init, so the two packages agree to rounding (~2e-6 on
logits) and token streams compare byte for byte.  On the CPU the round
runs eagerly on the static buffers a card captures (``specs.SpecGraphs``);
``tests/test_torch_cuda.py`` holds capture and replay.

int8 pools: ``repro``'s CPU int8 decode rounds q and the softmax weights
to bf16 (ROADMAP C); the int8 cases run its ``attend_one_token`` at f32
(:func:`f32_int8_decode`), the arithmetic of its TPU kernel and of the
port.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch import specs as JSP
from repro.models import attention as JA
from repro.models import transformer as JTF
from repro.serving import FaultInjector as JInjector
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import paged_cache_from_numpy, params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import specs as SP
from repro_torch.models import transformer as TTF
from repro_torch.serving import FaultInjector, ServeConfig, ServingEngine

SPEC_K = 3
# tests/test_serving.py's mixed trace: slots refill mid-flight, budgets
# end inside rounds
MIXED_PROMPTS = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
                 [11, 12], [7] * 13]
MIXED_BUDGETS = [6, 9, 3, 12, 5, 7]
SERVE = dict(max_batch=3, max_new_tokens=8, max_len=64, kv_block_size=8)
POOL_ATOL = 1e-5   # f32 K/V rows of the two packages (~1e-6 apart)
CODE_AGREEMENT = 0.999
INT_KEYS = ("tokens_computed", "tokens_published", "sample_events", "kv_written_tokens",
            "redundant_read_events", "counts")


def _cfgs(kv: str = "same", wta: bool = False):
    kw = dict(dtype="float32", kv_cache_dtype=kv, wta_head=wta)
    return (dataclasses.replace(jax_smoke("stablelm-3b"), **kw),
            dataclasses.replace(get_smoke_config("stablelm-3b"), **kw))


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture
def f32_int8_decode(monkeypatch):
    """``repro``'s ``attend_one_token`` with its int8 compute dtype f32
    instead of bf16; everything else is its own source."""
    src = inspect.getsource(JA.attend_one_token)
    old = "jnp.bfloat16 if int8_cache"
    assert src.count(old) == 1, "repro's attend_one_token changed"
    ns = dict(vars(JA))
    exec(src.replace(old, "jnp.float32 if int8_cache"), ns)
    monkeypatch.setattr(JA, "attend_one_token", ns["attend_one_token"])


# ---------------------------------------------------------------------------
# The round and the rollback (tests/test_specs.py:599-715)
# ---------------------------------------------------------------------------


def _fixture(weights, kv="same", wta=False):
    """``tests/test_specs.py``'s ``_spec_fixture`` in both packages: a B=3
    paged cache with slot 0 prefilled (pages [1, 2], an 8-token prompt)
    and slots 1-2 on the trash page, bridged from ``repro``'s; per-slot
    keys and steps."""
    jcfg, tcfg = _cfgs(kv, wta)
    jp, tp = weights
    cache = JSP.init_paged_decode_cache(jcfg, 3, 8, 8)
    prefill = jax.jit(JSP.make_paged_suffix_prefill(jcfg), static_argnames=("bucket",))
    extra = {}
    if kv == "int8":
        extra["quant_seeds"] = jnp.asarray([12345], jnp.uint32)
    cache, st, _ = prefill(jp, cache, JSP.init_prefill_state(jcfg),
                           jnp.asarray([[5, 3, 7, 2, 9, 4, 6, 8]], jnp.int32),
                           jnp.asarray([1], jnp.int32), jnp.int32(0), bucket=8, **extra)
    cache = jax.jit(JSP.make_paged_state_insert(jcfg))(cache, st, jnp.int32(0))
    table = np.asarray([[1, 2], [0, 0], [0, 0]], np.int32)
    token = np.asarray([7, 0, 0], np.int32)
    keys = np.asarray([[3, 11], [5, 13], [7, 17]], np.uint32)
    steps = np.asarray([1, 4, 9], np.int32)
    tc = paged_cache_from_numpy(jax.tree.map(np.asarray, cache), tcfg, device="cpu")
    j_args = (cache, jnp.asarray(table), jnp.asarray(token), jnp.asarray(keys), jnp.asarray(steps))
    t_args = (tc, torch.from_numpy(table), torch.from_numpy(token),
              torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(steps.astype(np.int64)))
    return jcfg, tcfg, j_args, t_args


def _assert_pools_agree(tc: dict, jc: dict) -> None:
    """Pools outside the trash page 0 (idle slots write there)."""
    for name in SP.PAGE_POOL_LEAVES:
        if name not in tc:
            continue
        got, want = tc[name].numpy()[:, :, 1:], np.asarray(jc[name])[:, :, 1:]
        if got.dtype == np.int8:
            got, want = got.astype(np.int32), want.astype(np.int32)
            assert (got == want).mean() >= CODE_AGREEMENT, name
            assert np.abs(got - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, atol=POOL_ATOL, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("kv,wta", [("same", False), ("same", True), ("int8", False)],
                         ids=["greedy", "wta", "int8"])
def test_spec_round_matches_reference(weights, kv, wta, request):
    """dtoks, doks, vtoks, voks and vstates["pos"] equal ``repro``'s round on
    the same bridged cache; the pools agree (int8 codes within one level on
    99.9%), ``quant_step`` advanced k times in both."""
    if kv == "int8":
        request.getfixturevalue("f32_int8_decode")
    jcfg, tcfg, j_args, t_args = _fixture(weights, kv, wta)
    jp, tp = weights
    jc, *j_rest = j_args
    j_out = jax.jit(JSP.make_paged_spec_round(jcfg, SPEC_K))(jp, jc, *j_rest)
    tc = t_args[0]
    t_out = SP.make_paged_spec_round(tcfg, SPEC_K)(tp, *t_args)
    j_cache, jd, jdok, jv, jvok, jvs = j_out
    td, tdok, tv, tvok, tvs = t_out
    for got, want in ((td, jd), (tdok, jdok), (tv, jv), (tvok, jvok)):
        assert tuple(got.shape) == (3, SPEC_K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(tvs) == set(jvs) == {"pos"}
    np.testing.assert_array_equal(tvs["pos"].numpy(), np.asarray(jvs["pos"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(j_cache["pos"]))
    assert tdok.all() and tvok.all()
    assert torch.equal(tv, td)
    _assert_pools_agree(tc, j_cache)
    if kv == "int8":
        assert int(tc["quant_step"]) == int(j_cache["quant_step"]) == SPEC_K


@pytest.mark.parametrize("kv,wta", [("same", False), ("same", True), ("int8", False)],
                         ids=["greedy", "wta", "int8"])
def test_spec_round_matches_plain_chain(weights, kv, wta):
    """The drafts are k plain decode steps bit for bit, the verify resamples
    them exactly (a fault-free round accepts everything), ``vstates`` holds
    each step's ``pos``, and the cache ends where the chain ends."""
    _, tcfg, _, (tc, table, token, keys, steps) = _fixture(weights, kv, wta)
    _, tp = weights
    chain = {k: v.clone() for k, v in tc.items()}
    d, dok, v, vok, vs = SP.make_paged_spec_round(tcfg, SPEC_K)(tp, tc, table, token, keys,
                                                                  steps)
    assert dok.all() and vok.all()
    assert torch.equal(v, d)
    assert vs["pos"].shape == (SPEC_K, 3)
    t = token
    for j in range(SPEC_K):
        chain, logits = TTF.lm_decode_step(tp, chain, t, tcfg, table)
        t = SP.sample_tokens(tcfg, logits, keys, steps + j)
        assert torch.equal(t, d[:, j])
        assert torch.equal(vs["pos"][j], chain["pos"])
    for name in chain:
        assert torch.equal(tc[name], chain[name]), name


def test_spec_rollback_rewinds_one_slot(weights):
    """The rollback rewinds one slot's ``pos`` in place (the cache's tensors
    keep their storage), and every (idx, slot) shares one signature."""
    _, tcfg, _, (tc, *args) = _fixture(weights)
    _, tp = weights
    pre = tc["pos"].clone()
    *_, vs = SP.make_paged_spec_round(tcfg, SPEC_K)(tp, tc, *args)
    after = tc["pos"].clone()
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    rb = SP.EagerEntry(SP.make_spec_rollback(tcfg))
    back = rb(tc, vs, 1, 0)
    assert back is tc and {k: v.data_ptr() for k, v in tc.items()} == ptrs
    assert int(tc["pos"][0]) == int(pre[0]) + 2   # idx 1: inputs 0 and 1 consumed
    assert torch.equal(tc["pos"][1:], after[1:])
    rb(tc, vs, 0, 2)
    assert int(tc["pos"][2]) == int(pre[2]) + 1
    assert len(rb.signatures) == 1


@pytest.mark.parametrize("kv", ["same", "int8"])
def test_decode_step_kv_write_false_is_read_only(weights, kv):
    """The verify's step: decode once writing (the draft), then again over
    the written pool from the pre-step ``pos`` (a tensor of its own) with
    ``kv_write=False``.  The logits are bit-equal, the pool and
    ``quant_step`` untouched, only the view's ``pos`` advanced."""
    _, tcfg, _, (tc, table, token, _, _) = _fixture(weights, kv)
    _, tp = weights
    pre = tc["pos"].clone()
    _, lg_wr = TTF.lm_decode_step(tp, tc, token, tcfg, table)
    written = {k: v.clone() for k, v in tc.items()}
    view = {n: v for n, v in tc.items() if n not in ("pos", "quant_step")}
    view["pos"] = pre.clone()
    _, lg_ro = TTF.lm_decode_step(tp, view, token, tcfg, table, kv_write=False)
    assert torch.equal(lg_ro, lg_wr)
    for name in tc:
        assert torch.equal(tc[name], written[name]), name
    assert torch.equal(view["pos"], tc["pos"])


def test_spec_factories_reject_bad_args():
    cfg = get_smoke_config("stablelm-3b")
    with pytest.raises(ValueError, match="speculate_k"):
        SP.make_paged_spec_round(cfg, 0)
    for other in (dataclasses.replace(cfg, family="encdec"), get_config("fcnn-mnist")):
        with pytest.raises(ValueError, match="token-LM"):
            SP.make_paged_spec_round(other, 2)
        with pytest.raises(ValueError, match="token-LM"):
            SP.make_spec_rollback(other)


# ---------------------------------------------------------------------------
# The engine (tests/test_serving.py:1513-1656)
# ---------------------------------------------------------------------------


def _engines(weights, kv="same", wta=False, **kw):
    jcfg, tcfg = _cfgs(kv, wta)
    jp, tp = weights
    return (JServingEngine(jp, jcfg, JServeConfig(**dict(SERVE, **kw))),
            ServingEngine(tp, tcfg, ServeConfig(**dict(SERVE, **kw)), device="cpu"))


def _mixed(eng):
    for p, b in zip(MIXED_PROMPTS, MIXED_BUDGETS):
        eng.submit(p, b)
    return eng.run()


def _spec_metrics(m) -> tuple:
    return m.spec_rounds, m.spec_drafted, m.spec_accepted, m.spec_tokens_per_round


@pytest.mark.parametrize("kv,wta,k", [("same", False, 4), ("same", True, 3), ("int8", False, 4)],
                         ids=["greedy-k4", "wta-k3", "int8-k4"])
def test_spec_streams_match_plain_and_reference(weights, kv, wta, k, request):
    """Speculation changes no token: the streams equal the port's plain
    engine's and ``repro``'s at the same k, with equal speculation metrics,
    ``compile_counts()`` (key set included) and analog event counts."""
    if kv == "int8":
        request.getfixturevalue("f32_int8_decode")
    j_eng, t_eng = _engines(weights, kv, wta, speculate_k=k)
    _, plain = _engines(weights, kv, wta)
    t_out = _mixed(t_eng)
    assert t_out == _mixed(plain)
    assert t_out == _mixed(j_eng)
    tm, jm = t_eng.metrics(), j_eng.metrics()
    assert tm.spec_rounds > 0 and tm.spec_drafted > 0
    assert _spec_metrics(tm) == _spec_metrics(jm)
    assert tm.spec_acceptance == jm.spec_acceptance > 0.5
    assert tm.decode_steps == jm.decode_steps < plain.metrics().decode_steps
    assert t_eng.compile_counts() == j_eng.compile_counts()
    assert {"spec_round", "spec_rollback"} <= set(t_eng.compile_counts())
    for key in INT_KEYS:
        assert tm.analog[key] == jm.analog[key], key
    assert tm.analog["tokens_computed"]["draft"] > 0
    if kv == "int8":
        assert int(t_eng._cache["quant_step"]) == int(np.asarray(j_eng._cache["quant_step"]))


def _tamper(eng, ref: bool):
    """Every other round reports its drafts at step 1 wrong (host side,
    after the round): the engine takes the rollback path while the
    verify's tokens stay the true ones."""
    orig = eng._spec_round
    calls = {"n": 0}

    def tampered(*a, **kw):
        out = list(orig(*a, **kw))
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            d_idx = 1 if ref else 0   # repro's round returns the cache first
            d = np.asarray(out[d_idx]).copy() if ref else out[d_idx].clone()
            d[:, 1] ^= 1
            out[d_idx] = d
        return tuple(out)

    eng._spec_round = tampered
    return orig, calls


def test_spec_forced_rejection_mid_run(weights):
    """Rejections mid-run: the published streams equal the plain engine's
    and ``repro``'s under the same tampering, acceptance drops as in
    ``repro``, and the rollback keeps one signature."""
    j_eng, t_eng = _engines(weights, speculate_k=4)
    _, plain = _engines(weights)
    j_orig, _ = _tamper(j_eng, ref=True)
    t_orig, calls = _tamper(t_eng, ref=False)
    t_out, j_out = _mixed(t_eng), _mixed(j_eng)
    t_eng._spec_round, j_eng._spec_round = t_orig, j_orig
    assert t_out == j_out == _mixed(plain)
    tm, jm = t_eng.metrics(), j_eng.metrics()
    assert calls["n"] >= 2
    assert tm.spec_accepted < tm.spec_drafted
    assert _spec_metrics(tm) == _spec_metrics(jm)
    assert t_eng.compile_counts()["spec_rollback"] == 1
    assert t_eng.compile_counts() == j_eng.compile_counts()


@pytest.mark.parametrize("wta", [False, True], ids=["greedy", "wta"])
def test_spec_preempt_restore_byte_identity(weights, wta):
    """Preempting a speculating slot (forced preempts at ticks 1 and 3,
    k = 3): the streams equal the unpreempted plain run's and ``repro``'s,
    restores equal preemptions."""
    kw = dict(max_batch=2, max_new_tokens=10, max_len=64, kv_block_size=8,
              prefill_buckets=(16,))
    jcfg, tcfg = _cfgs("same", wta)
    jp, tp = weights
    prompts = [list(range(1, 10)), list(range(2, 14))]
    j_inj = JInjector().at(1, "preempt").at(3, "preempt")
    t_inj = FaultInjector().at(1, "preempt").at(3, "preempt")
    j_eng = JServingEngine(jp, jcfg, JServeConfig(**kw, speculate_k=3, fault_injector=j_inj))
    t_eng = ServingEngine(tp, tcfg, ServeConfig(**kw, speculate_k=3, fault_injector=t_inj),
                          device="cpu")
    plain = ServingEngine(tp, tcfg, ServeConfig(**kw), device="cpu")
    outs = []
    for eng in (t_eng, j_eng, plain):
        for p in prompts:
            eng.submit(p, 10)
        outs.append(eng.run())
    assert outs[0] == outs[1] == outs[2]
    m = t_eng.metrics()
    assert m.preemptions >= 1 and m.restores == m.preemptions
    assert m.spec_rounds > 0
    jm = j_eng.metrics()
    assert (m.preemptions, m.restores) == (jm.preemptions, jm.restores)
    assert _spec_metrics(m) == _spec_metrics(jm)
    assert t_eng.compile_counts() == j_eng.compile_counts()


def test_spec_nan_page_evicts_nan_at_draft_depth(weights):
    """A poisoned page under speculation: the round's finite flags end the
    request ``nan`` (there are no sanity codes in a round), as in
    ``repro``; the others finish with ``repro``'s tokens."""
    kw = dict(SERVE, speculate_k=3)
    jcfg, tcfg = _cfgs()
    jp, tp = weights
    j_eng = JServingEngine(jp, jcfg, JServeConfig(**kw, fault_injector=JInjector().at(
        2, "nan_logits")))
    t_eng = ServingEngine(tp, tcfg, ServeConfig(**kw, fault_injector=FaultInjector().at(
        2, "nan_logits")), device="cpu")
    outs = [_mixed(t_eng), _mixed(j_eng)]
    t_reasons = {r.rid: r.done_reason for r in t_eng.sched.all_requests()}
    j_reasons = {r.rid: r.done_reason for r in j_eng.sched.all_requests()}
    assert t_reasons == j_reasons
    assert "nan" in t_reasons.values()
    assert outs[0] == outs[1]
    assert _spec_metrics(t_eng.metrics()) == _spec_metrics(j_eng.metrics())


def test_spec_recompile_guard(weights):
    """One ``spec_round`` per window width, no rollback on a fault-free
    greedy trace, the reference's counts and keys, and nothing new on a
    second identical trace."""
    j_eng, t_eng = _engines(weights, speculate_k=4)
    for _ in range(2):
        assert _mixed(t_eng) == _mixed(j_eng)
        counts = t_eng.compile_counts()
        assert counts == j_eng.compile_counts()
        assert set(counts) == set(j_eng.compile_counts())
        assert 1 <= counts["spec_round"] <= 4
        assert counts["spec_rollback"] == 0
    assert sorted(t_eng._spec_graphs.entries) == sorted(
        (w, 4) for w in {w for w, _ in t_eng._spec_graphs.entries})
    assert not t_eng._spec_graphs.capture and t_eng.capture_log() == []


@pytest.mark.parametrize("kw,match", [
    (dict(speculate_k=-1), "speculate_k"),
    (dict(speculate_k=8, max_new_tokens=8), "max_new_tokens"),
])
def test_spec_validation_is_loud(weights, kw, match):
    _, tp = weights
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match=match):
        ServingEngine(tp, tcfg, ServeConfig(**kw), device="cpu")


def test_metrics_row_shows_speculation(weights):
    _, t_eng = _engines(weights, speculate_k=2)
    _mixed(t_eng)
    row = t_eng.metrics().row()
    assert "spec_acc=" in row and "spec_tok_per_round=" in row
