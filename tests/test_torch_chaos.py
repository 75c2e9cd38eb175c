"""The chaos faults that need preemption's machinery, the port's engine
against ``repro``'s on the CPU: ``nan_logits``, ``deadline_storm``,
``kill_prefill`` and ``preempt``, alone and in random schedules.

The counterparts of ``tests/test_faults.py``'s typed-fault tests and its
chaos fuzz.  Both packages serve the smoke ``stablelm-3b`` at f32 with the
same weights, ``ServeConfig`` and ``FaultInjector`` schedule; per request
id the done reason and the output must equal ``repro``'s, and the block
allocator's invariants (``tests/test_prefix_sharing.py``) must hold after
every tick.

The fuzz is the reference's, ``speculate_k`` drawn from (0, 2, 3) as
there, with a deadline of 600 s where the reference draws 10 s: a
deadline is wall-clock time, and the two packages must take the same
branch however long a tick takes on a loaded CPU.
"""

import dataclasses
import random

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.kernels import backend as JBK
from repro.models import transformer as JTF
from repro.serving import DegradationPolicy as JPolicy
from repro.serving import FaultInjector as JInjector
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import backend as BK
from repro_torch.launch import specs as SP
from repro_torch.serving import (
    POOL_HOG_OWNER,
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    DegradationPolicy,
    FaultInjector,
    ServeConfig,
    ServingEngine,
)
from repro_torch.serving.scheduler import EVICT_REASONS
from test_prefix_sharing import check_invariants

SERVE = dict(max_batch=2, max_new_tokens=6, max_len=64, kv_block_size=8, prefill_buckets=(16,))


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32")
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _pair(weights, kv, events=(), faulty=None, **kw):
    """A ``repro`` engine and a port engine on one config; ``events`` are
    (tick, kind, kwargs) for both injectors; ``faulty`` a ``FaultConfig``'s
    keywords for the ``sim_faulty`` backend with the canary and ladder."""
    kw = dict(SERVE, **kw)
    engines = []
    for Inj, Cfg, Eng, smoke, backend, policy, params, extra in (
            (JInjector, JServeConfig, JServingEngine, jax_smoke, JBK, JPolicy, weights[0], {}),
            (FaultInjector, ServeConfig, ServingEngine, get_smoke_config, BK,
             DegradationPolicy, weights[1], {"device": "cpu"})):
        inj = Inj()
        for tick, kind, ekw in events:
            inj.at(tick, kind, **ekw)
        fault_kw = {}
        if faulty is not None:
            fault_kw = dict(device_backend="sim_faulty",
                            device_fault_config=backend.FaultConfig(**faulty),
                            canary_interval=2, tile_retire_threshold=0.01,
                            degradation=policy())
        cfg = dataclasses.replace(smoke("stablelm-3b"), dtype="float32", kv_cache_dtype=kv)
        engines.append(Eng(params, cfg, Cfg(fault_injector=inj, **kw, **fault_kw), **extra))
    return engines


def _per_rid(eng) -> dict:
    return {r.rid: (r.done_reason, r.output) for r in eng.sched.all_requests()}


def _hold(engines):
    """Per rid, the port's done reason and output are ``repro``'s; the
    allocator is back to capacity; the injectors applied the same faults."""
    j_eng, t_eng = engines
    assert _per_rid(t_eng) == _per_rid(j_eng)
    assert t_eng.metrics().evictions == j_eng.metrics().evictions
    assert t_eng.blocks.available == t_eng.blocks.capacity
    assert t_eng.cfg.fault_injector.applied == j_eng.cfg.fault_injector.applied
    assert t_eng.compile_counts() == j_eng.compile_counts()


def _drain(eng):
    while eng.sched.has_work():
        eng.tick()
        check_invariants(eng.blocks)


@pytest.mark.parametrize("kv", ["same", "int8"])
def test_nan_logits_evicts_with_typed_reason(weights, kv):
    """A poisoned read-window page makes the next decode step's sanity code
    ``SANE_NAN``: the victim is evicted ``"nan"``, the other slot decodes
    to the end with the stream it has without the poison."""
    engines = _pair(weights, kv, [(5, "nan_logits", {})])
    for eng in engines:
        eng.submit(list(range(1, 10)), 20, priority=PRIORITY_BATCH)
        eng.submit(list(range(40, 50)), 20)
        _drain(eng)
    _hold(engines)
    t_eng = engines[1]
    victim = next(r for r in t_eng.sched.all_requests() if r.done_reason == "nan")
    survivor = next(r for r in t_eng.sched.all_requests() if r is not victim)
    assert survivor.done_reason == "length" and len(survivor.output) == 20
    assert t_eng.metrics().evictions["nan"] == 1
    assert t_eng.cfg.fault_injector.applied[-1][1] == "nan_logits"
    assert t_eng.compile_counts()["page_restore"] == 1
    clean = _pair(weights, kv)[1]
    clean.submit(list(range(1, 10)), 20, priority=PRIORITY_BATCH)
    clean.submit(list(range(40, 50)), 20)
    clean.run()
    assert survivor.output == clean.sched.request(survivor.rid).output
    assert victim.output == clean.sched.request(victim.rid).output[:len(victim.output)]


def test_nan_payload_poisons_only_row_zero(weights):
    """The poison payload: NaN in row 0 of every float pool leaf (an int8
    pool's scale planes, not its codes), zeros elsewhere, so the trash page
    it also writes stays finite; the spill payload's shapes and dtypes."""
    for kv in ("same", "int8"):
        eng = _pair(weights, kv)[1]
        payload = eng._nan_payload()
        ids = np.zeros((eng._max_blocks,), np.int32)
        spilled = eng._page_spill(eng._cache, eng._put(ids))
        assert {k: (v.shape, v.dtype) for k, v in payload.items()} == \
            {k: (v.shape, v.dtype) for k, v in spilled.items()}
        for name, rows in payload.items():
            if rows.dtype.is_floating_point:
                assert rows[:, :, 0].isnan().all() and not rows[:, :, 1:].isnan().any(), name
            else:
                assert not rows.any(), name
        assert set(payload) == ({"k_pages", "v_pages"} if kv == "same" else
                                {"k_pages", "v_pages", "k_scale_pages", "v_scale_pages"})


@pytest.mark.parametrize("kv", ["same", "int8"])
def test_deadline_storm_reaps_everything(weights, kv):
    engines = _pair(weights, kv, [(2, "deadline_storm", {})])
    for eng in engines:
        for i in range(3):
            eng.submit(list(range(1 + i, 10 + i)), 30)
        _drain(eng)
    _hold(engines)
    t_eng = engines[1]
    assert all(r.done_reason == "deadline" for r in t_eng.sched.all_requests())
    assert t_eng.metrics().evictions == {"deadline": 3}


@pytest.mark.parametrize("kv", ["same", "int8"])
def test_kill_prefill_frees_pages_and_sharers_recover(weights, kv):
    """Killing the FIFO head mid-chunk drops its job at once; the queued
    sharer of its unwritten pages demotes to recompute and still produces
    the solo run's stream."""
    prompt = list(range(1, 25))
    kw = dict(prefill_buckets=(32,), prefill_chunk=8, max_new_tokens=4)
    engines = _pair(weights, kv, [(1, "kill_prefill", {})], **kw)
    for eng in engines:
        ra = eng.submit(prompt, 4)
        rb = eng.submit(prompt, 4)
        _drain(eng)
    _hold(engines)
    t_eng = engines[1]
    killed, surv = t_eng.sched.request(ra), t_eng.sched.request(rb)
    assert killed.done_reason == "preempted" and killed.output == []
    assert surv.done_reason == "length"
    solo = _pair(weights, kv, **kw)[1]
    rc = solo.submit(prompt, 4)
    assert surv.output == solo.run()[rc]


def test_every_eviction_reason_is_typed():
    assert set(EVICT_REASONS) >= {"eos", "length", "deadline", "nan", "saturated",
                                  "entropy_collapse", "preempted"}
    assert set(SP.SANITY_REASONS.values()) <= set(EVICT_REASONS)


_FAULT_KINDS = (
    "exhaust_pool", "release_pool", "nan_logits", "deadline_storm",
    "kill_prefill", "preempt", "degrade_device", "recover_device",
)


def _chaos_trace(weights, seed: int, faulty: bool) -> None:
    """Random faults over random two-class traffic, both packages ticked in
    lockstep: invariants after every tick, the same live owners, and per
    rid the same done reason and output at the end."""
    rng = random.Random(seed)
    events = []
    for _ in range(rng.randint(2, 6)):
        kind = rng.choice(_FAULT_KINDS)
        kw = dict(comparator_offset=rng.choice((0.0, 2.0))) if kind == "degrade_device" else {}
        events.append((rng.randint(0, 20), kind, kw))
    # the hog released and the device recovered at the end, so the drain
    # can finish (level 3 of the ladder sheds batch admissions)
    events += [(21, "release_pool", {}), (21, "recover_device", {})]
    engines = _pair(
        weights, rng.choice(("same", "int8")), events,
        faulty=dict(seed=seed, stuck_rate=0.02) if faulty else None,
        prefill_buckets=(16, 32), prefill_chunk=rng.choice((0, 8)),
        num_kv_blocks=rng.choice((0, 9)), max_new_tokens=8,
        # speculative rounds in the same storm: the draft-depth NaN guard,
        # preempting a speculating slot, rollbacks under pressure
        speculate_k=rng.choice((0, 2, 3)),
    )
    submits = []
    for _ in range(24):
        if rng.random() < 0.5 and len(submits) < 6:
            n = rng.randint(1, 20)
            submits.append((list(range(1, n + 1)), rng.randint(1, 8),
                            rng.choice((PRIORITY_INTERACTIVE, PRIORITY_BATCH)),
                            rng.choice((None, 600_000.0))))
            for eng in engines:
                p, b, pr, dl = submits[-1]
                eng.submit(p, b, priority=pr, deadline_ms=dl)
        for eng in engines:
            eng.tick()
            check_invariants(eng.blocks)
            # each package's own RequestState: compare by name
            live = {r.rid for r in eng.sched.all_requests() if r.state.name != "DONE"}
            assert all(o == POOL_HOG_OWNER or o in live for o in eng.blocks._owned)
        assert _per_rid(engines[1]) == _per_rid(engines[0])
    for eng in engines:
        n = 0
        while eng.sched.has_work() and n < 400:
            eng.tick()
            check_invariants(eng.blocks)
            n += 1
        assert not eng.sched.has_work(), "engine wedged after fault storm"
        for r in eng.sched.all_requests():
            assert r.state.name == "DONE" and r.done_reason in EVICT_REASONS
    _hold(engines)
    m = engines[1].metrics()
    assert (m.preemptions, m.restores, m.spill_drops) == \
        tuple(getattr(engines[0].metrics(), k) for k in ("preemptions", "restores",
                                                         "spill_drops"))


# Seeds whose schedules together apply every fault kind (nan_logits,
# preempt and exhaust_pool at 8, kill_prefill at 6 and 4, deadline_storm
# and nan_logits at 11, degrade_device at 4); seeds 0-15 all hold, with and
# without the fault backend.
@pytest.mark.parametrize("seed", [6, 8])
def test_chaos_fuzz_equals_reference(weights, seed):
    _chaos_trace(weights, seed, faulty=False)


@pytest.mark.parametrize("seed", [4, 11])
def test_chaos_fuzz_faulty_device_backend_equals_reference(weights, seed):
    """The same with analog device faults live: ``sim_faulty`` at a stuck
    rate of 2%, a canary every two ticks, tile retirement and the ladder."""
    _chaos_trace(weights, seed, faulty=True)
