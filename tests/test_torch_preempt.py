"""Preemption with KV spill to host, restore, the spill budget and
deadlines: the port's engine against ``repro``'s on the CPU.

The counterparts of ``tests/test_serving.py``'s preemption, deadline and
spill-budget tests, and spec tests of the three entry points
(``make_page_spill``, ``make_page_restore``, ``make_slot_state_gather``)
against the reference's jitted ones on one bridged cache.  Every engine
case runs the smoke ``stablelm-3b`` at f32 with the same weights
(``repro_torch.bridge``), the same ``ServeConfig`` and the same
``FaultInjector`` schedule in both packages, over the pools ``same``
(f32 here) and ``int8`` and greedy and WTA sampling, and holds: the streams
equal ``repro``'s; ``preemptions``, ``restores``, ``spill_drops`` and the
done reasons equal; ``compile_counts()`` equal on every key; every spill
record's bytes equal ``repro``'s ``_spill_nbytes``.  With the ``same``
pool the preempted streams also equal the port's own unpreempted run.

int8 with WTA: ``repro``'s CPU int8 decode rounds q and the softmax
weights to bf16 (its TPU kernel and the port compute in f32, ROADMAP C),
and that moves WTA votes at this size.  Those cases run ``repro`` with its
int8 decode computed in f32: its own ``attend_one_token`` with that one
dtype changed (:func:`f32_int8_decode`).
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs as SP
from repro_torch.models import transformer as TTF
from repro_torch.serving import (
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    FaultInjector,
    ServeConfig,
    ServingEngine,
    ServingMetrics,
)

SERVE = dict(max_batch=2, max_new_tokens=10, max_len=64, kv_block_size=8, prefill_buckets=(16,))
PROMPTS = [list(range(1, 10)), list(range(2, 14))]
CASES = [("same", False), ("same", True), ("int8", False), ("int8", True)]
CASE_IDS = ["greedy", "wta", "int8", "int8-wta"]


def _cfgs(kv: str, wta: bool):
    kw = dict(dtype="float32", kv_cache_dtype=kv, wta_head=wta)
    return (dataclasses.replace(jax_smoke("stablelm-3b"), **kw),
            dataclasses.replace(get_smoke_config("stablelm-3b"), **kw))


@pytest.fixture(scope="module")
def weights():
    """The f32 smoke weights in both packages (the pool dtype and the
    sampler do not change them)."""
    jcfg, tcfg = _cfgs("same", False)
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture
def f32_int8_decode(monkeypatch):
    """``repro``'s ``attend_one_token`` with its int8 compute dtype f32
    instead of bf16 (the arithmetic of its TPU kernel and of the port);
    everything else is its own source."""
    src = inspect.getsource(JA.attend_one_token)
    old = "jnp.bfloat16 if int8_cache"
    assert src.count(old) == 1, "repro's attend_one_token changed"
    ns = dict(vars(JA))
    exec(src.replace(old, "jnp.float32 if int8_cache"), ns)
    monkeypatch.setattr(JA, "attend_one_token", ns["attend_one_token"])


def _spy_spills(eng) -> None:
    """Record (rid, bytes) of every record ``eng`` stores in
    ``eng.spills`` and the rid of every restore from a record in
    ``eng.restored``."""
    eng.spills, eng.restored = [], []
    store, restore = eng._store_spill, eng._restore_one

    def spy_store(rid, rec):
        eng.spills.append((rid, eng._spill_nbytes(rec)))
        store(rid, rec)

    def spy_restore(req, plan):
        eng.restored.append(req.rid)
        restore(req, plan)

    eng._store_spill, eng._restore_one = spy_store, spy_restore


def _scribble_freed(eng) -> None:
    """After every spill, overwrite the pages it freed (as the next owner's
    writes would): a request restored in the same tick gets them back from
    the free list, so only this makes its restore carry its stream."""
    preempt = eng._preempt

    def run(req):
        owned = set(eng.blocks.owned(req.rid))
        preempt(req)
        freed = torch.tensor(sorted(owned & set(eng.blocks._free)), dtype=torch.int64)
        for name in SP.PAGE_POOL_LEAVES:
            if name in eng._cache:
                eng._cache[name][:, :, freed] = 3

    eng._preempt = run


def _pair(weights, kv, wta, schedule=(), **kw):
    """A ``repro`` engine and a port engine on one config; ``schedule`` is
    (tick, kind) events for both packages' injectors."""
    jcfg, tcfg = _cfgs(kv, wta)
    jp, tp = weights
    engines = []
    for Inj, Cfg, Eng, cfg, params, extra in (
            (JInjector, JServeConfig, JServingEngine, jcfg, jp, {}),
            (FaultInjector, ServeConfig, ServingEngine, tcfg, tp, {"device": "cpu"})):
        inj = None
        if schedule:
            inj = Inj()
            for tick, kind in schedule:
                inj.at(tick, kind)
        eng = Eng(params, cfg, Cfg(**dict(SERVE, fault_injector=inj, **kw)), **extra)
        _spy_spills(eng)
        engines.append(eng)
    return engines


def _hold(j_eng, t_eng, j_out, t_out):
    """The port's run equals ``repro``'s in everything the schedule
    decides."""
    assert t_out == j_out
    jm, tm = j_eng.metrics(), t_eng.metrics()
    for k in ("preemptions", "restores", "spill_drops", "evictions", "completed",
              "total_tokens", "decode_steps"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert t_eng.compile_counts() == j_eng.compile_counts()
    assert t_eng.spills == j_eng.spills and t_eng.restored == j_eng.restored
    assert t_eng._spill_bytes == j_eng._spill_bytes
    assert t_eng.blocks.available == t_eng.blocks.capacity


def _run_both(engines, prompts=PROMPTS, budget=10):
    outs = []
    for eng in engines:
        for p in prompts:
            eng.submit(p, budget)
        outs.append(eng.run())
    return outs


def _unpreempted(weights, kv, wta):
    return _run_both(_pair(weights, kv, wta))


@pytest.mark.parametrize("kv,wta", CASES, ids=CASE_IDS)
def test_preempt_restore_byte_identity(weights, kv, wta, request):
    """Two forced preemptions mid-decode, each restored through the gate in
    the same tick: the port equals ``repro``, and (without int8) the
    streams equal the unpreempted run."""
    if kv == "int8" and wta:
        request.getfixturevalue("f32_int8_decode")
    j_eng, t_eng = _pair(weights, kv, wta, [(4, "preempt"), (8, "preempt")])
    _scribble_freed(t_eng)
    j_out, t_out = _run_both((j_eng, t_eng))
    _hold(j_eng, t_eng, j_out, t_out)
    m = t_eng.metrics()
    assert m.preemptions == 2 and m.restores == 2 and m.spill_drops == 0
    assert [k for _, k, _ in t_eng.cfg.fault_injector.applied] == ["preempt", "preempt"]
    assert len(t_eng.spills) == 2 and t_eng._spill == {}
    if kv == "same":
        assert t_out == _unpreempted(weights, kv, wta)[1]


@pytest.mark.parametrize("kv", ["same", "int8"])
def test_preempt_restore_compile_counts(weights, kv):
    """Spill, restore and the slot-state gather keep one signature each
    (fixed-width page ids), as ``repro`` compiles each once."""
    j_eng, t_eng = _pair(weights, kv, False, [(3, "preempt"), (7, "preempt")])
    j_out, t_out = _run_both((j_eng, t_eng), prompts=([1, 2, 3, 4], list(range(2, 14))))
    _hold(j_eng, t_eng, j_out, t_out)
    counts = t_eng.compile_counts()
    assert counts["page_spill"] == counts["page_restore"] == counts["state_gather"] == 1
    assert counts["serve_step"] <= 4
    assert t_eng.metrics().preemptions == 2


def _priority_run(eng):
    rb = eng.submit(list(range(1, 10)), 6, priority=PRIORITY_BATCH)
    for _ in range(3):
        eng.tick()
    ri = eng.submit(list(range(3, 12)), 6, priority=PRIORITY_INTERACTIVE)
    n = 0
    while eng.sched.has_work() and n < 300:
        eng.tick()
        n += 1
    return rb, ri


@pytest.mark.parametrize("kv,wta", CASES, ids=CASE_IDS)
def test_higher_priority_arrival_preempts_lowest(weights, kv, wta, request):
    """A tight pool running a batch request back-pressures an interactive
    arrival; with preemption on the batch request spills, the interactive
    one finishes first, and the victim restores; with it off nothing
    preempts.  Both runs equal ``repro``'s."""
    if kv == "int8" and wta:
        request.getfixturevalue("f32_int8_decode")
    outs = {}
    for enable in (True, False):
        engines = _pair(weights, kv, wta, max_batch=1, max_new_tokens=6, num_kv_blocks=7,
                        enable_preemption=enable)
        rids = [_priority_run(eng) for eng in engines]
        j_eng, t_eng = engines
        got = [{r.rid: r.output for r in e.sched.all_requests()} for e in engines]
        _hold(j_eng, t_eng, *got)
        outs[enable] = (t_eng, rids[1])
    t_on, (rb, ri) = outs[True]
    m = t_on.metrics()
    assert m.preemptions >= 1 and m.restores >= 1
    b, i = t_on.sched.request(rb), t_on.sched.request(ri)
    assert b.preemptions >= 1 and i.done_time < b.done_time
    t_off, (rb_off, _) = outs[False]
    assert t_off.metrics().preemptions == 0
    if kv == "same":
        assert b.output == t_off.sched.request(rb_off).output


def test_uniform_priority_never_preempts(weights):
    """A victim must have strictly lower priority: single-class traffic
    under pool pressure back-pressures instead."""
    engines = _pair(weights, "same", False, max_new_tokens=6, num_kv_blocks=7)
    outs = _run_both(engines, prompts=[list(range(1 + i, 10 + i)) for i in range(3)], budget=6)
    _hold(*engines, *outs)
    assert engines[1].metrics().preemptions == 0 and engines[1].metrics().completed == 3


def test_deadline_eviction_mid_stream(weights):
    """A request past its deadline is evicted with reason ``"deadline"``
    and its pages come back."""
    engines = _pair(weights, "same", False, max_batch=1, max_new_tokens=200, max_len=256)
    for eng in engines:
        rid = eng.submit(list(range(1, 10)), 200, deadline_ms=1e-3)
        eng.run()
        req = eng.sched.request(rid)
        assert req.done_reason == "deadline"
        assert eng.blocks.available == eng.blocks.capacity
        assert eng.metrics().evictions.get("deadline") == 1
    assert engines[1].sched.request(rid).output == engines[0].sched.request(rid).output


def test_queued_deadline_eviction_without_slot(weights):
    """Expiry also reaps queued requests that never got a slot."""
    engines = _pair(weights, "same", False, max_batch=1, max_new_tokens=4)
    got = []
    for eng in engines:
        r0 = eng.submit(list(range(1, 10)), 4)
        r1 = eng.submit(list(range(2, 12)), 4, deadline_ms=1e-3)
        eng.run()
        a, b = eng.sched.request(r0), eng.sched.request(r1)
        assert a.done_reason == "length" and b.done_reason == "deadline" and b.output == []
        got.append(a.output)
    assert got[1] == got[0]


@pytest.mark.parametrize("kw,match", [
    (dict(spill_budget_bytes=-1), "spill_budget_bytes"),
    (dict(enable_preemption="off"), "enable_preemption"),
])
def test_preemption_knobs_validation_is_loud(kw, match):
    """The reference's rules: a negative budget and a non-bool flag raise."""
    with pytest.raises(ValueError, match=match):
        ServeConfig(**kw).validate()
    with pytest.raises(ValueError, match=match):
        JServeConfig(**kw).validate()
    ServeConfig(spill_budget_bytes=0, enable_preemption=False).validate()


@pytest.mark.parametrize("kv,wta", CASES, ids=CASE_IDS)
def test_spill_budget_drop_recomputes_byte_identical(weights, kv, wta, request):
    """A zero budget drops every record at insertion: the victim
    re-admits through the fresh gate, recomputes its prompt and
    teacher-forces its published tokens, and its stream is ``repro``'s
    (without int8, the unpreempted one)."""
    if kv == "int8" and wta:
        request.getfixturevalue("f32_int8_decode")
    j_eng, t_eng = _pair(weights, kv, wta, [(4, "preempt"), (8, "preempt")],
                         spill_budget_bytes=0)
    _scribble_freed(t_eng)
    j_out, t_out = _run_both((j_eng, t_eng))
    _hold(j_eng, t_eng, j_out, t_out)
    m = t_eng.metrics()
    assert m.preemptions == 2 and m.spill_drops == 2 and m.restores == 0
    assert t_eng._spill == {} and t_eng._spill_bytes == 0 and t_eng._replay == {}
    if kv == "same":
        assert t_out == _unpreempted(weights, kv, wta)[1]


@pytest.mark.parametrize("kv,wta", CASES, ids=CASE_IDS)
def test_spill_budget_keeps_newest_drops_oldest(weights, kv, wta, request):
    """A budget of one record and two preemptions in one tick: the second
    insertion drops the first; the kept victim restores from its pages,
    the dropped one recomputes, and both streams are ``repro``'s."""
    if kv == "int8" and wta:
        request.getfixturevalue("f32_int8_decode")
    # records are fixed-width, so every one costs the same: size the budget
    # from the first record of a probe run
    probe = _pair(weights, kv, wta, [(3, "preempt")])[1]
    probe.submit(PROMPTS[0], 10)
    for _ in range(4):
        probe.tick()
    one = probe.spills[0][1]
    j_eng, t_eng = _pair(weights, kv, wta, [(3, "preempt"), (3, "preempt")],
                         spill_budget_bytes=one)
    _scribble_freed(t_eng)
    j_out, t_out = _run_both((j_eng, t_eng))
    _hold(j_eng, t_eng, j_out, t_out)
    m = t_eng.metrics()
    assert m.preemptions == 2 and m.spill_drops == 1 and m.restores == 1
    assert [b for _, b in t_eng.spills] == [one, one]
    assert t_eng.restored == [t_eng.spills[1][0]]   # the newer record was kept
    if kv == "same":
        assert t_out == _unpreempted(weights, kv, wta)[1]


def test_spill_budget_unbounded_never_drops(weights):
    engines = _pair(weights, "same", False, [(4, "preempt"), (8, "preempt")])
    outs = _run_both(engines, prompts=([1, 2, 3, 4], list(range(2, 14))))
    _hold(*engines, *outs)
    m = engines[1].metrics()
    assert m.preemptions == 2 and m.spill_drops == 0


def test_metrics_row_shows_preemption():
    assert "preempt=" not in ServingMetrics().row()
    row = ServingMetrics(preemptions=3, restores=2, spill_drops=1).row()
    assert "preempt=3 restore=2" in row and "spill_drops=1" in row


# ---------------------------------------------------------------------------
# The three entry points against the reference's jitted ones
# ---------------------------------------------------------------------------


def _bridged_cache(kv: str, dtype: str):
    """One random paged cache in both packages: 2 slots, 10 pages of 8."""
    jcfg, tcfg = _cfgs(kv, False)
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, tcfg))
    jc = JSP.init_paged_decode_cache(jcfg, 2, 10, 8)
    tc = TTF.init_paged_decode_cache(tcfg, 2, 10, 8, device="cpu")
    rng = np.random.default_rng(4)
    out = {}
    for name, leaf in jc.items():
        if name == "pos":
            v = np.asarray([19, 7], np.int32)
        elif name == "quant_step":
            v = np.asarray(5, np.int32)
        elif leaf.dtype == jnp.int8:
            v = rng.integers(-127, 128, leaf.shape).astype(np.int8)
        else:
            v = rng.standard_normal(leaf.shape).astype(np.float32)
        out[name] = jnp.asarray(v).astype(leaf.dtype)
        tc[name].copy_(torch.from_numpy(_np(out[name])))
    return jcfg, tcfg, out, tc


def _np(x) -> np.ndarray:
    """A leaf of either package as numpy, bf16 widened to f32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("kv,dtype", [("same", "float32"), ("same", "bfloat16"),
                                      ("int8", "float32")])
def test_spill_restore_gather_match_reference(kv, dtype):
    """Equal payloads and slot state; a spill → restore round trip onto
    other pages equals the reference's restore everywhere outside the trash
    page 0, in place (every leaf keeps its storage); ``quant_step`` is not
    gathered."""
    jcfg, tcfg, jc, tc = _bridged_cache(kv, dtype)
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    ids = np.zeros((8,), np.int32)
    ids[:3] = [3, 1, 6]
    want = jax.jit(JSP.make_page_spill(jcfg))(jc, jnp.asarray(ids))
    got = SP.make_page_spill(tcfg)(tc, torch.from_numpy(ids))
    assert set(got) == set(want) == {n for n in SP.PAGE_POOL_LEAVES if n in tc}
    for name in want:
        assert got[name].dtype == tc[name].dtype
        np.testing.assert_array_equal(_np(got[name]), _np(want[name]), err_msg=name)

    j_state = jax.jit(JSP.make_slot_state_gather(jcfg))(jc, 1)
    t_state = SP.make_slot_state_gather(tcfg)(tc, 1)
    assert set(t_state) == set(j_state) == {"pos"}
    np.testing.assert_array_equal(t_state["pos"].numpy(), np.asarray(j_state["pos"]))

    new = np.zeros((8,), np.int32)
    new[:3] = [8, 2, 9]
    payload = {k: v.clone() for k, v in got.items()}
    j_after = jax.jit(JSP.make_page_restore(jcfg))(jc, jnp.asarray(new), want)
    t_after = SP.make_page_restore(tcfg)(tc, torch.from_numpy(new), payload)
    assert t_after is tc
    assert {k: v.data_ptr() for k, v in tc.items()} == ptrs
    for name in want:
        np.testing.assert_array_equal(_np(tc[name])[:, :, 1:], _np(j_after[name])[:, :, 1:],
                                      err_msg=name)
        for src, dst in zip(ids[:3], new[:3]):
            assert torch.equal(tc[name][:, :, dst], got[name][:, :, list(ids).index(src)])
    if kv == "int8":
        assert int(tc["quant_step"]) == 5
