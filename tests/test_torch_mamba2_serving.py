"""The port's engines serving mamba2-1.3b (attention-free: a paged cache
with no K/V pool, only ``pos``, ``ssm_conv`` and ``ssm_state`` per slot)
against ``repro``'s on the CPU, the ``recurrentgemma-2b`` cases of
``tests/test_serving.py`` run on mamba2.

Both packages run the smoke config at f32 on the same weights: ``repro``'s
init (key 0) with every block's output projection scaled by
``BLOCK_GAIN`` and every mixer's ``d_skip`` zeroed, so that the streams
read the SSM state (``tests/_block_gain.py``).  Greedy streams must be
byte-identical to ``repro``'s, with the counters and ``compile_counts()``
equal.  Each reference engine runs once, in a module fixture, on first
use, and only where a number of its is compared.

- dense = paged; int8 = the float cache (there is no pool to quantize);
  chunked prefill = whole-bucket prefill (``tests/test_serving.py:313``);
- prefix sharing, and a partial hit resuming at a chunk boundary from the
  snapshot stashed there (``:609``, ``:872``), with its mutation check: the
  snapshot's ``ssm_state`` zeroed, the streams part;
- forced preemption: spill records of state alone (no pages), restored
  streams = unpreempted (``:1313``);
- speculation at k = 3, and forced rejections rolling ``ssm_conv`` and
  ``ssm_state`` back (``:1517``); WTA sampling; the static engine;
- chaos ``nan_logits``: with no pool there is no page to poison, so the
  victim's page is deregistered, nothing is written and every request
  ends by length, in both packages;
- ``specs.cache_batch_axis`` over every per-slot leaf of each ported
  family's caches (``tests/test_specs.py:26``).
"""

import dataclasses

import pytest
import torch
from _block_gain import gained_weights

from repro.configs import get_smoke_config as jax_smoke
from repro.launch import specs as JSP
from repro.serving import FaultInjector as JInjector
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs as TSP
from repro_torch.models import transformer as TTF
from repro_torch.serving import FaultInjector, ServeConfig, ServingEngine, StaticServingEngine

ARCH = "mamba2-1.3b"
# tests/test_serving.py's mixed trace: mid-flight slot refill, mixed buckets
MIXED_PROMPTS = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
                 [11, 12], [7] * 13]
MIXED_BUDGETS = [6, 9, 3, 12, 5, 7]
LAYOUT = dict(max_batch=3, max_new_tokens=8, max_len=64, kv_block_size=8)
# the repeated-prefix trace
SHARED_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9],
                  [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9]]
SHARED_BUDGETS = [6, 4, 6, 3, 5]
# three 24-token prompts on a 16-token common head, bucket 32, chunks of 8
HEAD = list(range(1, 17))
PARTIAL_PROMPTS = [HEAD + [30 + i] * 8 for i in range(3)]
PARTIAL = dict(LAYOUT, max_new_tokens=6, prefill_chunk=8)
PREEMPT = dict(max_batch=2, max_new_tokens=10, max_len=64, kv_block_size=8,
               prefill_buckets=(16,))
PREEMPT_PROMPTS = [list(range(1, 10)), list(range(2, 14))]
COUNTS = ("completed", "total_tokens", "decode_steps", "prefills", "prefill_tokens",
          "prefill_tokens_saved", "prefix_hits", "prefix_partial_hits", "cow_forks",
          "preemptions", "restores", "spec_rounds", "spec_drafted", "spec_accepted")

# name -> (ServeConfig fields, prompts, budgets, fault schedule, wta_head)
RUNS = {
    "paged": (LAYOUT, MIXED_PROMPTS, MIXED_BUDGETS, (), False),
    "spec": (dict(LAYOUT, speculate_k=3), MIXED_PROMPTS, MIXED_BUDGETS, (), False),
    "wta": (dict(LAYOUT, seed=3), MIXED_PROMPTS, MIXED_BUDGETS, (), True),
    "nan": (LAYOUT, MIXED_PROMPTS, MIXED_BUDGETS, ((3, "nan_logits"),), False),
    "share_on": (LAYOUT, SHARED_PROMPTS, SHARED_BUDGETS, (), False),
    "partial_on": (PARTIAL, PARTIAL_PROMPTS, [6] * 3, (), False),
    "plain": (PREEMPT, PREEMPT_PROMPTS, [10] * 2, (), False),
    "preempt": (PREEMPT, PREEMPT_PROMPTS, [10] * 2, ((4, "preempt"), (8, "preempt")), False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jp, tp = gained_weights(jcfg, tcfg, zero=("d_skip",))
    return (jp, jcfg), (tp, tcfg)


def _serve(package, name, wrap=None, **over):
    """One engine of ``package`` on run ``name`` (its ServeConfig fields
    updated by ``over``); ``wrap(engine)`` is called before the trace is
    submitted.  Returns (engine, streams in submission order)."""
    fields, prompts, budgets, schedule, wta = RUNS[name]
    (params, cfg), Engine, Config, Inj, kw = package
    inj = None
    if schedule:
        inj = Inj()
        for tick, kind in schedule:
            inj.at(tick, kind)
    cfg = dataclasses.replace(cfg, wta_head=wta, kv_cache_dtype=over.pop("kv", "same"))
    eng = Engine(params, cfg, Config(**dict(fields, **over), fault_injector=inj), **kw)
    if wrap is not None:
        wrap(eng)
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    out = eng.run()
    return eng, [out[r] for r in rids]


@pytest.fixture(scope="module")
def reference(weights):
    pkg = (weights[0], JServingEngine, JServeConfig, JInjector, {})
    runs: dict = {}

    def get(name: str):
        if name not in runs:
            runs[name] = _serve(pkg, name)
        return runs[name]

    return get


@pytest.fixture(scope="module")
def port(weights):
    pkg = (weights[1], ServingEngine, ServeConfig, FaultInjector, dict(device="cpu"))
    return lambda name, wrap=None, **over: _serve(pkg, name, wrap, **over)


def _assert_same_run(t_run, j_run):
    (t_eng, t_out), (j_eng, j_out) = t_run, j_run
    assert t_out == j_out
    tm, jm = t_eng.metrics(), j_eng.metrics()
    for k in COUNTS:
        assert getattr(tm, k) == getattr(jm, k), k
    assert tm.evictions == jm.evictions
    assert t_eng.compile_counts() == j_eng.compile_counts()
    assert t_eng.blocks.available == t_eng.blocks.capacity


def test_paged_engine_equals_reference_without_a_pool(port, reference):
    """The paged engine's streams, counts and compiles are the
    reference's; its cache holds ``pos`` and the state alone; the streams
    move from token to token."""
    run = port("paged")
    _assert_same_run(run, reference("paged"))
    assert sorted(run[0]._cache) == ["pos", "ssm_conv", "ssm_state"]
    assert sum(len(set(o)) > 1 for o in run[1]) == len(run[1])


@pytest.mark.parametrize("variant", ["dense", "int8", "chunked", "int8_dense"])
def test_layouts_and_options_give_the_reference_streams(port, reference, variant):
    """``test_dense_vs_paged_greedy_byte_identical``, the int8 cache and
    chunked prefill: each gives the reference's paged streams.  An int8
    config has nothing to quantize (no pool: no ``quant_step``); chunks
    of 8 tokens resume from the carried state (pages of 8, SSD chunks of
    8)."""
    over = {"dense": dict(kv_layout="dense"), "int8": dict(kv="int8"),
            "chunked": dict(prefill_chunk=8),
            "int8_dense": dict(kv="int8", kv_layout="dense")}[variant]
    t_eng, t_out = port("paged", **over)
    assert t_out == reference("paged")[1]
    assert sorted(t_eng._cache) == ["pos", "ssm_conv", "ssm_state"]
    if variant == "chunked":
        assert t_eng.metrics().prefills == len(MIXED_PROMPTS)


def test_wta_equals_reference(port, reference):
    """WTA sampling (``wta_head``, per-request keys from ``seed``): the
    reference's streams and counts, and not the greedy ones."""
    run = port("wta")
    _assert_same_run(run, reference("wta"))
    assert run[1] != port("paged")[1]


def test_prefix_sharing_equals_reference(port, reference):
    """``test_prefix_sharing_byte_identical``: sharing on and off give the
    same streams, the reference's; repeats take full hits whose stored
    payload carries the state."""
    on, off = port("share_on"), port("share_on", enable_prefix_sharing=False)
    _assert_same_run(on, reference("share_on"))
    assert on[1] == off[1]
    m_on, m_off = on[0].metrics(), off[0].metrics()
    assert m_off.prefix_hits == 0 and m_on.prefix_hits >= 1
    assert m_on.prefills == m_off.prefills - m_on.prefix_hits


def _spy(resumes: list, inserted: list, drop_state: bool = False):
    """Wraps ``_resume_state`` (records (q0, leaves); with ``drop_state``
    the snapshot's ``ssm_state`` is handed over zeroed: the mutation) and
    the state insert at the end of each prefill (records the state)."""
    def wrap(eng):
        real_resume, real_insert = eng._resume_state, eng._state_insert

        def resume_state(plan, q0):
            state = real_resume(plan, q0)
            resumes.append((q0, sorted(state)))
            if drop_state and q0:
                state = dict(state, ssm_state=torch.zeros_like(state["ssm_state"]))
            return state

        def state_insert(cache, state, slot):
            inserted.append({n: v.clone() for n, v in state.items()})
            return real_insert(cache, state, slot)

        state_insert.signatures = real_insert.signatures     # compile_counts() reads it
        eng._resume_state, eng._state_insert = resume_state, state_insert

    return wrap


def test_partial_sharing_resumes_from_the_snapshot(port, reference):
    """``test_partial_sharing_byte_identity``: the padded prompts share 24
    tokens (3 blocks, 3 chunks of 8), so the two repeats resume at 24 from
    the state snapshot stashed on the third block; the streams equal the
    unshared run's and the reference's, and each prefill leaves the
    unshared run's state at its slot, bit for bit.  Mutation check: the
    same resume with the snapshot's ``ssm_state`` zeroed leaves another
    state (the streams barely move: the last 8 prompt tokens repeat one
    token, and the SSM state decays within a few steps)."""
    runs = {tag: ([], []) for tag in ("on", "off", "bad")}
    on = port("partial_on", _spy(*runs["on"]))
    off = port("partial_on", _spy(*runs["off"]), enable_prefix_sharing=False)
    _assert_same_run(on, reference("partial_on"))
    assert on[1] == off[1]
    m = on[0].metrics()
    assert m.prefix_partial_hits == 2 and m.prefill_tokens_saved == 2 * 24
    leaves = ["pos", "ssm_conv", "ssm_state"]
    assert runs["on"][0] == [(0, leaves), (24, leaves), (24, leaves)]
    port("partial_on", _spy(*runs["bad"], drop_state=True))
    assert [q0 for q0, _ in runs["bad"][0]] == [0, 24, 24]
    for got, want in zip(runs["on"][1], runs["off"][1]):
        assert all(torch.equal(got[n], want[n]) for n in leaves)
    for got, want in zip(runs["bad"][1][1:], runs["off"][1][1:]):
        assert not torch.equal(got["ssm_state"], want["ssm_state"])


def test_preempt_restore_equals_reference(port, reference):
    """``test_preempt_restore_byte_identity``: two forced preemptions of
    decoding slots; each spill record holds no page, only ``pos``,
    ``ssm_conv`` and ``ssm_state`` (their bytes exactly), and the restored
    streams equal the unpreempted ones and the reference's."""
    records = []

    def spy(eng):
        real = eng._store_spill

        def store(rid, rec):
            records.append((rec["pages"], sorted(rec["state"]), eng._spill_nbytes(rec)))
            real(rid, rec)

        eng._store_spill = store

    run = port("preempt", spy)
    _assert_same_run(run, reference("preempt"))
    assert run[1] == port("plain")[1]
    assert run[0].metrics().preemptions == 2
    cfg = get_smoke_config(ARCH)
    state_bytes = 4 + cfg.n_layers * (3 * (cfg.d_inner + 2 * cfg.ssm_state)
                                      + cfg.d_inner * cfg.ssm_state) * 4
    assert records == [({}, ["pos", "ssm_conv", "ssm_state"], state_bytes)] * 2


def test_speculation_equals_reference(port, reference):
    """``test_spec_greedy_byte_identity`` at k = 3: the plain engine's
    streams, with the reference's rounds, drafts and acceptances."""
    run = port("spec")
    _assert_same_run(run, reference("spec"))
    assert run[1] == reference("paged")[1]
    assert run[0].metrics().spec_rounds > 0


def test_forced_rejections_roll_the_state_back(port, reference):
    """``test_spec_forced_rejection_mid_run`` on mamba2: every other round
    reports its second draft changed, so each slot accepts one draft and
    rolls ``pos``, ``ssm_conv`` and ``ssm_state`` back to the state after
    it; the streams stay the plain engine's."""
    calls = {"n": 0, "states": set()}

    def tamper(eng):
        orig = eng._spec_round

        def tampered(*a, **kw):
            d, dok, v, vok, vs = orig(*a, **kw)
            calls["n"] += 1
            calls["states"] |= set(vs)
            if calls["n"] % 2 == 0:
                d = d.clone()
                d[:, 1] ^= 1
            return d, dok, v, vok, vs

        eng._spec_round = tampered

    eng, out = port("spec", tamper)
    assert out == reference("paged")[1]
    m = eng.metrics()
    assert calls["n"] >= 2 and m.spec_accepted < m.spec_drafted
    assert calls["states"] == {"pos", "ssm_conv", "ssm_state"}
    assert eng.compile_counts()["spec_rollback"] == 1


def test_nan_chaos_without_a_pool_equals_reference(port, reference):
    """The ``nan_logits`` fault on a pool-free model, as the reference's
    engine takes it: the injector picks a victim, its page is deregistered
    and an empty payload restored, so nothing is poisoned, the logits stay
    finite and every stream is the clean run's."""
    run = port("nan")
    j_eng, _ = reference("nan")
    _assert_same_run(run, reference("nan"))
    applied = run[0].cfg.fault_injector.applied
    assert applied == j_eng.cfg.fault_injector.applied
    assert [kind for _, kind, _ in applied] == ["nan_logits"]
    assert run[0]._nan_payload() == {}
    assert run[1] == port("paged")[1]
    assert run[0].metrics().evictions == {"length": len(MIXED_PROMPTS)}


def test_static_engine_equals_continuous(weights):
    """``test_static_vs_continuous_byte_identical``: with the padded
    windows equal (prompts on one bucket), ``StaticServingEngine`` gives
    the continuous engine's streams."""
    tp, tcfg = weights[1]
    one = ServeConfig(max_batch=3, max_new_tokens=6, max_len=64, prefill_buckets=(8,))
    cont = ServingEngine(tp, tcfg, one, device="cpu")
    stat = StaticServingEngine(tp, tcfg, one, device="cpu")
    for p in MIXED_PROMPTS[:3]:
        cont.submit(p)
        stat.submit(p)
    c_out = cont.run()
    assert [c_out[r] for r in sorted(c_out)] == stat.run()
    assert stat.compile_counts() == {"serve_step": 1}


@pytest.mark.parametrize("arch", ["stablelm-3b", "recurrentgemma-2b", "mamba2-1.3b"])
@pytest.mark.parametrize("kv", ["same", "int8"])
def test_cache_batch_axis_contract(arch, kv):
    """``tests/test_specs.py::test_decode_cache_batch_axis_contract`` for
    the port: every per-slot leaf of a dense and of a paged cache (all but
    the page pool and ``quant_step``) carries the slot axis where
    ``cache_batch_axis`` says, the reference's axis."""
    cfg = dataclasses.replace(get_smoke_config(arch), kv_cache_dtype=kv)
    jcfg = dataclasses.replace(jax_smoke(arch), kv_cache_dtype=kv)
    b = 5
    caches = (TTF.init_decode_cache(cfg, b, 16, device="cpu"),
              TTF.init_paged_decode_cache(cfg, b, 4, 8, device="cpu"))
    seen = set()
    for cache in caches:
        for name, leaf in cache.items():
            if name in TSP.PAGE_POOL_LEAVES or name == "quant_step":
                continue
            ax = TSP.cache_batch_axis(cfg, name)
            assert ax == JSP.cache_batch_axis(jcfg, name), name
            assert leaf.shape[ax] == b, (name, tuple(leaf.shape), ax)
            seen.add(name)
    assert {"pos"} < seen
    assert ("ssm_state" in seen) == (arch == "mamba2-1.3b")
    with pytest.raises(KeyError):
        TSP.cache_batch_axis(cfg, "k_pages")
