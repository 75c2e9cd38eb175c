"""Degraded-mode serving of the port's engine against ``repro``'s, on the
CPU: the fault backend installed around each tick, the canary, the
logit-sanity detections, the ``DegradationPolicy`` ladder with its
redundant reads and shedding, the fault injector's kinds, and the rebuild
of every compiled entry point when the backend's ``fault_version`` moves.

WTA streams are compared at f32 (bf16 random-init logits have near-ties,
ROADMAP C), byte for byte, as ``tests/test_torch_wta.py`` compares them;
ladder transitions, canary probes and failures, redundant-read events and
``compile_counts()`` must be equal.

Left out: the reference's 1×1-mesh cases (no sharding yet).
"""

import dataclasses

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
    RequestState,
    ServeConfig,
    ServingEngine,
)

SERVE = dict(max_batch=2, max_new_tokens=6, max_len=64, kv_block_size=8, prefill_buckets=(16,))


@pytest.fixture(scope="module")
def bridged():
    """f32 smoke stablelm-3b, greedy and WTA (8 trials), the same weights
    in both packages."""
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32")
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")

    def wta(c):
        return dataclasses.replace(c, wta_head=True,
                                   analog=dataclasses.replace(c.analog, wta_trials=8))

    return {"greedy": (jcfg, jp, tcfg, tp), "wta": (wta(jcfg), jp, wta(tcfg), tp)}


def _pair(bridged, head, inj=None, **kw):
    """A repro engine and a port engine on the same config; ``inj`` is a
    function building an injector for each package (given its class)."""
    jcfg, jp, tcfg, tp = bridged[head]
    fault = kw.pop("fault", None)
    jkw, tkw = dict(SERVE, **kw), dict(SERVE, **kw)
    if fault is not None:
        jkw["device_fault_config"] = JBK.FaultConfig(**fault)
        tkw["device_fault_config"] = BK.FaultConfig(**fault)
    if "degradation" in kw:
        jkw["degradation"] = JPolicy(**kw["degradation"])
        tkw["degradation"] = DegradationPolicy(**kw["degradation"])
    if inj is not None:
        jkw["fault_injector"], tkw["fault_injector"] = inj(JInjector), inj(FaultInjector)
    return (JServingEngine(jp, jcfg, JServeConfig(**jkw)),
            ServingEngine(tp, tcfg, ServeConfig(**tkw), device="cpu"))


def _both(engines, fn):
    return [fn(e) for e in engines]


def test_injector_kinds_are_the_ported_four():
    """The port's kinds are the reference's eight (four until preemption
    was ported, whence the name); an unknown kind is refused when it is
    scheduled."""
    assert FaultInjector.kinds() == JInjector.kinds()
    with pytest.raises(ValueError, match="unknown fault kind 'typo'"):
        FaultInjector().at(3, "typo")
    assert POOL_HOG_OWNER == -1


@pytest.mark.parametrize("kw,match", [
    (dict(device_fault_config=BK.FaultConfig()), "device_fault_config"),
    (dict(device_backend="phys"), "unknown device_backend"),
    (dict(n_redundant_reads=0), "n_redundant_reads"),
    (dict(canary_interval=-1), "canary_interval"),
    (dict(canary_threshold=0.0), "canary_threshold"),
    (dict(tile_retire_threshold=1.5), "tile_retire_threshold"),
    (dict(degradation=DegradationPolicy(trip_after=0)), "trip_after"),
    (dict(degradation=DegradationPolicy(redundant_reads=0)), "redundant_reads"),
])
def test_serve_config_rejects_bad_fault_combos(kw, match):
    with pytest.raises(ValueError, match=match):
        ServeConfig(**kw).validate()


def test_zero_knob_stream_equals_sim_and_reference(bridged):
    """A WTA trace through ``sim_faulty`` with every knob at zero is the
    ``sim`` trace, and the reference's, token for token, with equal
    accounting."""
    outs, metrics = {}, {}
    for name in ("sim", "sim_faulty"):
        j_eng, t_eng = _pair(bridged, "wta", device_backend=name)
        for eng in (j_eng, t_eng):
            for i in range(3):
                eng.submit(list(range(1 + i, 9 + i)), 5)
        outs[name] = _both((j_eng, t_eng), lambda e: e.run())
        metrics[name] = t_eng.metrics()
        assert outs[name][1] == outs[name][0], name
        assert t_eng.compile_counts() == j_eng.compile_counts()
    assert outs["sim_faulty"][1] == outs["sim"][1]
    assert metrics["sim"].analog["counts"] == metrics["sim_faulty"].analog["counts"]
    assert metrics["sim_faulty"].analog["backend"] == "sim_faulty"
    assert BK.get_backend() is not None and type(BK.get_backend()) is BK.SimBackend


def test_canary_detects_comparator_offset_as_the_reference(bridged):
    engines = _pair(bridged, "greedy", lambda I: I().at(2, "degrade_device", comparator_offset=3.0),
                    device_backend="sim_faulty", canary_interval=1)
    for eng in engines:
        eng.submit(list(range(1, 9)), 6)
    j_out, t_out = _both(engines, lambda e: e.run())
    assert t_out == j_out
    jm, tm = _both(engines, lambda e: e.metrics())
    assert (tm.canary_probes, tm.canary_failures) == (jm.canary_probes, jm.canary_failures)
    assert 0 < tm.canary_failures < tm.canary_probes   # clean before tick 2
    assert tm.degraded_mode == 0 and tm.degraded_transitions == []  # no policy armed
    assert engines[1].sched.request(0).done_reason == "length"


def test_ladder_trips_and_recovers_as_the_reference(bridged):
    """Injected comparator offset at tick 2: canary failures walk the
    ladder up to level 2 (R = 3, priced) and 3; recovery at tick 12 walks
    it back to 0 on clean canary passes.  Transitions, probes, failures,
    redundant-read events, accounting and ``compile_counts()`` equal the
    reference's, and so do the streams."""
    engines = _pair(
        bridged, "wta",
        lambda I: I().at(2, "degrade_device", comparator_offset=3.0).at(12, "recover_device"),
        device_backend="sim_faulty", canary_interval=1, max_new_tokens=10,
        degradation=dict(trip_after=2, recover_after=2),
    )
    for eng in engines:
        eng.submit(list(range(1, 9)), 10)
    j_out, t_out = _both(engines, lambda e: e.run())
    assert t_out == j_out
    for eng in engines:
        for _ in range(32):
            if eng.metrics().degraded_mode == 0:
                break
            eng.tick()
    jm, tm = _both(engines, lambda e: e.metrics())
    assert tm.degraded_transitions == jm.degraded_transitions
    levels = [t["to"] for t in tm.degraded_transitions]
    assert max(levels) >= 2 and levels[-1] == 0 and tm.degraded_mode == 0
    assert {t["why"] for t in tm.degraded_transitions} == {"fault_pressure", "canary_recovered"}
    assert (tm.canary_probes, tm.canary_failures) == (jm.canary_probes, jm.canary_failures)
    assert tm.redundant_read_events == jm.redundant_read_events > 0
    assert tm.analog["counts"] == jm.analog["counts"]
    assert tm.analog["tokens_computed"] == jm.analog["tokens_computed"]
    j_eng, t_eng = engines
    assert t_eng.compile_counts() == j_eng.compile_counts()
    assert t_eng.backend.fault_state() == j_eng.backend.fault_state()
    assert t_eng._rebuilds == 2   # degrade, recover


def test_shedding_holds_batch_admissions_until_recovery(bridged):
    """Level 3 sheds priority > 0 admissions while interactive traffic is
    admitted; after ``recover_device`` the batch request completes.  The
    transitions and streams are the reference's."""
    engines = _pair(
        bridged, "greedy",
        lambda I: I().at(0, "degrade_device", comparator_offset=3.0).at(8, "recover_device"),
        device_backend="sim_faulty", canary_interval=1,
        degradation=dict(trip_after=1, recover_after=1),
    )
    for eng in engines:
        for _ in range(4):
            eng.tick()
        assert eng.metrics().degraded_mode == 3
    rids = []
    for eng, (batch, inter) in zip(engines, ((1, 0), (PRIORITY_BATCH, PRIORITY_INTERACTIVE))):
        rb = eng.submit(list(range(1, 7)), 3, priority=batch)
        ri = eng.submit(list(range(11, 17)), 3, priority=inter)
        eng.tick()
        assert eng.sched.request(rb).state.name == "QUEUED"   # shed
        assert eng.sched.request(ri).state.name != "QUEUED"
        rids.append((rb, ri))
    j_out, t_out = _both(engines, lambda e: e.run())
    assert t_out == j_out
    for rid in rids[1]:
        req = engines[1].sched.request(rid)
        assert req.state is RequestState.DONE
        assert req.done_reason == "length" and len(req.output) == 3
    jm, tm = _both(engines, lambda e: e.metrics())
    assert tm.degraded_transitions == jm.degraded_transitions


def test_degradation_disables_speculation(bridged):
    """Level 1: a speculating engine under persistent canary failure stops
    drafting (``spec_rounds`` freezes) and decodes to completion with
    plain ticks, as the reference's does."""
    engines = _pair(
        bridged, "greedy", lambda I: I().at(0, "degrade_device", comparator_offset=3.0),
        device_backend="sim_faulty", canary_interval=1, degradation=dict(trip_after=1),
        speculate_k=2, max_new_tokens=12,
    )
    rids = [eng.submit(list(range(1, 9)), 12) for eng in engines]
    j_out, t_out = _both(engines, lambda e: e.run())
    assert t_out == j_out
    j_eng, t_eng = engines
    req = t_eng.sched.request(rids[1])
    assert req.done_reason == "length" and len(req.output) == 12
    jm, tm = _both(engines, lambda e: e.metrics())
    assert tm.degraded_mode >= 1
    # the ladder moves at the end of a tick, so the first decode tick may
    # still draft once; 12 tokens at k = 2 would take ~5 healthy rounds
    assert tm.spec_rounds <= 1
    assert (tm.spec_rounds, tm.spec_drafted, tm.spec_accepted) == (
        jm.spec_rounds, jm.spec_drafted, jm.spec_accepted)
    assert tm.degraded_transitions == jm.degraded_transitions
    assert t_eng.compile_counts() == j_eng.compile_counts()


def test_sanity_evictions_are_detection_events(bridged):
    """A saturation threshold every logit row exceeds evicts each request
    at its first decode step ("saturated"); each eviction is a detection
    event, so the ladder trips without any canary, as the reference's."""
    engines = _pair(bridged, "greedy", logit_sat_threshold=1e-3,
                    degradation=dict(trip_after=1))
    for eng in engines:
        for i in range(3):
            eng.submit(list(range(1 + i, 9 + i)), 5)
    j_out, t_out = _both(engines, lambda e: e.run())
    assert t_out == j_out and all(len(o) == 1 for o in t_out.values())
    jm, tm = _both(engines, lambda e: e.metrics())
    assert tm.evictions == jm.evictions == {"saturated": 3}
    assert tm.degraded_transitions == jm.degraded_transitions
    assert tm.degraded_mode == jm.degraded_mode >= 1 and tm.canary_probes == 0


def test_pool_exhaustion_back_pressures_then_releases(bridged):
    engines = _pair(bridged, "greedy",
                    lambda I: I().at(0, "exhaust_pool").at(3, "release_pool"))
    for eng in engines:
        eng.submit(list(range(1, 9)), 4)
        eng.tick()
        assert eng.sched.request(0).state.name == "QUEUED"
    j_out, t_out = _both(engines, lambda e: e.run())
    assert t_out == j_out and len(t_out[0]) == 4
    j_inj, t_inj = (e.cfg.fault_injector for e in engines)
    assert t_inj.applied == j_inj.applied == [(0, "exhaust_pool", None), (3, "release_pool", None)]
    assert engines[1].blocks.available == engines[1].blocks.capacity


def test_drift_rebuilds_as_the_reference(bridged):
    """With ``drift_nu`` the quantized drift bucket crosses every few ticks
    early on; each crossing bumps ``fault_version`` and the engine
    rebuilds (compile counts restart), tick for tick as the reference."""
    engines = _pair(bridged, "greedy", device_backend="sim_faulty", fault=dict(drift_nu=0.1))
    for eng in engines:
        for i in range(2):
            eng.submit(list(range(1 + i, 9 + i)), 6)
    j_out, t_out = _both(engines, lambda e: e.run())
    assert t_out == j_out
    j_eng, t_eng = engines
    assert t_eng.backend.fault_state() == j_eng.backend.fault_state()
    assert t_eng._rebuilds == t_eng.backend.fault_version > 0
    assert t_eng.compile_counts() == j_eng.compile_counts()


def test_fault_version_bump_drops_compiled_steps_and_reaches_the_sampler(bridged,
                                                                        monkeypatch):
    """A degrade replaces every compiled decode step (their entries were
    built at the old comparator point) and the next decode samples at
    vth0 + offset; a recover brings back the healthy point.  What the card
    test holds for captured graphs, here on the eager steps."""
    _, _, tcfg, tp = bridged["wta"]
    seen = []
    real = SP.KOPS.wta_trial_counts

    def recording(z, keys, folds, n_trials, vth0, sigma_z, layout):
        seen.append(vth0)
        return real(z, keys, folds, n_trials, vth0, sigma_z, layout)

    monkeypatch.setattr(SP.KOPS, "wta_trial_counts", recording)
    eng = ServingEngine(tp, tcfg, ServeConfig(**SERVE, device_backend="sim_faulty"),
                        device="cpu")
    eng.submit(list(range(1, 9)), 12)
    for _ in range(3):
        eng.tick()
    step, counts = eng._decode, eng.compile_counts()
    assert counts["serve_step"] == 1
    healthy = tcfg.analog.vth0
    assert set(seen) == {healthy}
    eng.backend.degrade(comparator_offset=3.0)
    seen.clear()
    eng.tick()
    assert eng._decode is not step and eng._rebuilds == 1
    assert eng.compile_counts()["serve_step"] == 1 and step.entries
    assert seen == [healthy + 3.0]
    eng.backend.recover()
    seen.clear()
    eng.tick()
    assert seen == [healthy] and eng._rebuilds == 2
    assert [g for g, _, _ in eng.capture_log()] == []   # nothing is captured on the CPU
    assert type(BK.get_backend()) is BK.SimBackend   # the tick's install is undone
