"""The port's engines serving the MoE family (granite-moe-3b-a800m and
grok-1-314b: attention blocks whose MLP is a mixture of experts) against
``repro``'s on the CPU.

Both packages run the smoke configs at f32 on the same weights,
``repro``'s init (key 0) carried across by ``bridge``: at that init the
greedy streams read the experts (zeroing one layer's experts moves most
tokens), so no gain is applied.  Greedy streams must be byte-identical to
``repro``'s, with the counters and ``compile_counts()`` equal.  Each
reference engine runs once, in a module fixture, on first use, and only
where a number of its is compared.

- paged, dense and chunked prefill (``tests/test_serving.py:313``);
- the int8 pool against the reference's own int8 run;
- speculation at k = 3 (the verify's k·B rows are k·B groups of one
  token, so it drops nothing), and forced rejections;
- WTA sampling; the static engine against the continuous one;
- forced preemption, and a prefix-sharing partial hit;
- the drop case: at capacity factor 1.0 tokens overflow, and a capacity
  group is the prefill call's sequence, so chunked prefill (chunks of 8)
  routes other tokens than whole-bucket prefill: the port's chunked and
  whole streams each equal the reference's, and part from each other as
  the reference's do.

The smoke configs' own factors (8.0 and 4.0) drop no token, so every
other case's chunked prefill, sharing and preemption leave the streams
as they are.
"""

import dataclasses

import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.serving import FaultInjector as JInjector
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.serving import FaultInjector, ServeConfig, ServingEngine, StaticServingEngine

ARCHS = ["granite-moe-3b-a800m", "grok-1-314b"]
# tests/test_serving.py's mixed trace: mid-flight slot refill, mixed buckets
MIXED_PROMPTS = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
                 [11, 12], [7] * 13]
MIXED_BUDGETS = [6, 9, 3, 12, 5, 7]
LAYOUT = dict(max_batch=3, max_new_tokens=8, max_len=64, kv_block_size=8)
# three 24-token prompts on a 16-token common head, bucket 32, chunks of 8
HEAD = list(range(1, 17))
PARTIAL_PROMPTS = [HEAD + [30 + i] * 8 for i in range(3)]
PARTIAL = dict(LAYOUT, max_new_tokens=6, prefill_chunk=8)
PREEMPT = dict(max_batch=2, max_new_tokens=10, max_len=64, kv_block_size=8,
               prefill_buckets=(16,))
PREEMPT_PROMPTS = [list(range(1, 10)), list(range(2, 14))]
DROP_FACTOR = 1.0
COUNTS = ("completed", "total_tokens", "decode_steps", "prefills", "prefill_tokens",
          "prefill_tokens_saved", "prefix_hits", "prefix_partial_hits", "cow_forks",
          "preemptions", "restores", "spec_rounds", "spec_drafted", "spec_accepted")

# name -> (ServeConfig fields, prompts, budgets, fault schedule, cfg fields)
RUNS = {
    "paged": (LAYOUT, MIXED_PROMPTS, MIXED_BUDGETS, (), {}),
    "int8": (LAYOUT, MIXED_PROMPTS, MIXED_BUDGETS, (), {"kv_cache_dtype": "int8"}),
    "spec": (dict(LAYOUT, speculate_k=3), MIXED_PROMPTS, MIXED_BUDGETS, (), {}),
    "wta": (dict(LAYOUT, seed=3), MIXED_PROMPTS, MIXED_BUDGETS, (), {"wta_head": True}),
    "partial_on": (PARTIAL, PARTIAL_PROMPTS, [6] * 3, (), {}),
    "plain": (PREEMPT, PREEMPT_PROMPTS, [10] * 2, (), {}),
    "preempt": (PREEMPT, PREEMPT_PROMPTS, [10] * 2, ((4, "preempt"), (8, "preempt")), {}),
    "drop_whole": (LAYOUT, MIXED_PROMPTS, MIXED_BUDGETS, (), {"capacity_factor": DROP_FACTOR}),
    "drop_chunked": (dict(LAYOUT, prefill_chunk=8), MIXED_PROMPTS, MIXED_BUDGETS, (),
                     {"capacity_factor": DROP_FACTOR}),
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
    """arch -> ((repro's params, its cfg), (the port's params, its cfg)),
    f32, built on first use."""
    import jax
    import numpy as np

    from repro.models import transformer as JTF

    made: dict = {}

    def get(arch: str):
        if arch not in made:
            jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
            tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
            jp = jax.jit(JTF.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
            made[arch] = ((jp, jcfg), (tp, tcfg))
        return made[arch]

    return get


def _serve(package, name, wrap=None, **over):
    """One engine of ``package`` on run ``name`` (its ServeConfig fields
    updated by ``over``); ``wrap(engine)`` is called before the trace is
    submitted.  Returns (engine, streams in submission order)."""
    fields, prompts, budgets, schedule, cfg_over = RUNS[name]
    (params, cfg), Engine, Config, Inj, kw = package
    inj = None
    if schedule:
        inj = Inj()
        for tick, kind in schedule:
            inj.at(tick, kind)
    cfg = dataclasses.replace(cfg, **cfg_over)
    eng = Engine(params, cfg, Config(**dict(fields, **over), fault_injector=inj), **kw)
    if wrap is not None:
        wrap(eng)
    rids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    out = eng.run()
    return eng, [out[r] for r in rids]


@pytest.fixture(scope="module")
def reference(weights):
    runs: dict = {}

    def get(arch: str, name: str):
        if (arch, name) not in runs:
            pkg = (weights(arch)[0], JServingEngine, JServeConfig, JInjector, {})
            runs[arch, name] = _serve(pkg, name)
        return runs[arch, name]

    return get


@pytest.fixture(scope="module")
def port(weights):
    def run(arch: str, name: str, wrap=None, **over):
        pkg = (weights(arch)[1], ServingEngine, ServeConfig, FaultInjector, dict(device="cpu"))
        return _serve(pkg, name, wrap, **over)

    return run


def _assert_same_run(t_run, j_run):
    (t_eng, t_out), (j_eng, j_out) = t_run, j_run
    assert t_out == j_out
    tm, jm = t_eng.metrics(), j_eng.metrics()
    for k in COUNTS:
        assert getattr(tm, k) == getattr(jm, k), k
    assert tm.evictions == jm.evictions
    assert t_eng.compile_counts() == j_eng.compile_counts()
    assert t_eng.blocks.available == t_eng.blocks.capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_equals_reference(port, reference, arch):
    """The paged engine's streams, counts and compiles are the
    reference's; its cache is the K/V pool of an attention-only model."""
    run = port(arch, "paged")
    _assert_same_run(run, reference(arch, "paged"))
    assert sorted(run[0]._cache) == ["k_pages", "pos", "v_pages"]


@pytest.mark.parametrize("arch", ARCHS)
def test_streams_read_the_experts(weights, port, arch):
    """At this init the streams depend on the experts: zeroing the first
    layer's experts (``w_down`` of unit 0) moves many greedy tokens."""
    base = port(arch, "paged")[1]
    tp, tcfg = weights(arch)[1]
    cut = {k: v for k, v in tp.items()}
    moe = dict(tp["units"]["l0"]["moe"])
    moe["w_down"] = moe["w_down"].clone()
    moe["w_down"][0].zero_()
    cut["units"] = {"l0": dict(tp["units"]["l0"], moe=moe)}
    eng = ServingEngine(cut, tcfg, ServeConfig(**LAYOUT), device="cpu")
    rids = [eng.submit(p, b) for p, b in zip(MIXED_PROMPTS, MIXED_BUDGETS)]
    out = eng.run()
    moved = sum(a != b for r, o in zip(rids, base) for a, b in zip(out[r], o))
    assert moved >= sum(MIXED_BUDGETS) // 8, moved


@pytest.mark.parametrize("variant", ["dense", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_and_chunked_give_the_reference_streams(port, reference, arch, variant):
    """``test_dense_vs_paged_greedy_byte_identical`` and chunked prefill
    (chunks of 8, each its own capacity group, which drops nothing at the
    smoke factor): each gives the reference's paged streams."""
    over = {"dense": dict(kv_layout="dense"), "chunked": dict(prefill_chunk=8)}[variant]
    t_eng, t_out = port(arch, "paged", **over)
    assert t_out == reference(arch, "paged")[1]
    if variant == "chunked":
        assert t_eng.metrics().prefills == len(MIXED_PROMPTS)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_pool_equals_reference_int8(port, reference, arch):
    """The int8 pool (stochastically rounded codes, scale planes) gives the
    reference's int8 streams and counts: both round under the same
    seeds."""
    run = port(arch, "int8")
    _assert_same_run(run, reference(arch, "int8"))
    assert run[0]._cache["k_pages"].dtype == torch.int8


@pytest.mark.parametrize("arch", ARCHS)
def test_speculation_equals_reference(port, reference, arch):
    """``test_spec_greedy_byte_identity`` at k = 3: the plain engine's
    streams, with the reference's rounds, drafts and acceptances."""
    run = port(arch, "spec")
    _assert_same_run(run, reference(arch, "spec"))
    assert run[1] == reference(arch, "paged")[1]
    assert run[0].metrics().spec_rounds > 0


def test_forced_rejections_keep_the_streams(port, reference):
    """``test_spec_forced_rejection_mid_run`` on granite: every other round
    reports its second draft changed, so each slot accepts one draft and
    rolls ``pos`` back; the streams stay the plain engine's."""
    calls = {"n": 0}

    def tamper(eng):
        orig = eng._spec_round

        def tampered(*a, **kw):
            d, dok, v, vok, vs = orig(*a, **kw)
            calls["n"] += 1
            if calls["n"] % 2 == 0:
                d = d.clone()
                d[:, 1] ^= 1
            return d, dok, v, vok, vs

        eng._spec_round = tampered

    eng, out = port(ARCHS[0], "spec", tamper)
    assert out == reference(ARCHS[0], "paged")[1]
    m = eng.metrics()
    assert calls["n"] >= 2 and m.spec_accepted < m.spec_drafted
    assert eng.compile_counts()["spec_rollback"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_wta_equals_reference(port, reference, arch):
    """WTA sampling (``wta_head``, per-request keys from ``seed``): the
    reference's streams and counts, and not the greedy ones."""
    run = port(arch, "wta")
    _assert_same_run(run, reference(arch, "wta"))
    assert run[1] != reference(arch, "paged")[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_static_engine_equals_continuous(weights, arch):
    """``test_static_vs_continuous_byte_identical``: with the padded
    windows equal (prompts on one bucket), ``StaticServingEngine`` gives
    the continuous engine's streams."""
    tp, tcfg = weights(arch)[1]
    one = ServeConfig(max_batch=3, max_new_tokens=6, max_len=64, prefill_buckets=(8,))
    cont = ServingEngine(tp, tcfg, one, device="cpu")
    stat = StaticServingEngine(tp, tcfg, one, device="cpu")
    for p in MIXED_PROMPTS[:3]:
        cont.submit(p)
        stat.submit(p)
    c_out = cont.run()
    assert [c_out[r] for r in sorted(c_out)] == stat.run()
    assert stat.compile_counts() == {"serve_step": 1}


def test_preempt_restore_equals_reference(port, reference):
    """``test_preempt_restore_byte_identity`` on granite: two forced
    preemptions of decoding slots, each spill record holding the slot's
    pages and ``pos``; the restored streams equal the unpreempted ones and
    the reference's."""
    records = []

    def spy(eng):
        real = eng._store_spill

        def store(rid, rec):
            records.append((len(rec["pages"]), sorted(rec["state"])))
            real(rid, rec)

        eng._store_spill = store

    run = port(ARCHS[0], "preempt", spy)
    _assert_same_run(run, reference(ARCHS[0], "preempt"))
    assert run[1] == port(ARCHS[0], "plain")[1]
    assert run[0].metrics().preemptions == 2
    assert len(records) == 2 and all(n > 0 and st == ["pos"] for n, st in records), records


def test_partial_sharing_equals_reference(port, reference):
    """``test_partial_sharing_byte_identity`` on granite: the padded
    prompts share their head's blocks, so the two repeats prefill only
    their suffix; the streams equal the unshared run's and the
    reference's, with its hits and saved tokens."""
    on = port(ARCHS[0], "partial_on")
    off = port(ARCHS[0], "partial_on", enable_prefix_sharing=False)
    _assert_same_run(on, reference(ARCHS[0], "partial_on"))
    assert on[1] == off[1]
    m = on[0].metrics()
    assert m.prefix_partial_hits == 2 and m.prefill_tokens_saved > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_drops_follow_the_prefill_calls_as_in_reference(port, reference, arch):
    """At capacity factor 1.0 tokens overflow their experts.  A capacity
    group is the prefill call's sequence, so whole-bucket and chunked
    prefill drop other tokens: the port's whole and chunked streams each
    equal the reference's (counts and compiles too), and they part from
    each other in the same requests as the reference's do; dense = paged
    still holds."""
    whole, chunked = port(arch, "drop_whole"), port(arch, "drop_chunked")
    j_whole, j_chunked = reference(arch, "drop_whole"), reference(arch, "drop_chunked")
    _assert_same_run(whole, j_whole)
    _assert_same_run(chunked, j_chunked)
    parted = [i for i, (a, b) in enumerate(zip(whole[1], chunked[1])) if a != b]
    assert parted and parted == [i for i, (a, b) in enumerate(zip(j_whole[1], j_chunked[1]))
                                 if a != b]
    assert port(arch, "drop_whole", kv_layout="dense")[1] == whole[1]
