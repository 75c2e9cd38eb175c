"""The port's engines serving recurrentgemma-2b (RG-LRU state beside the
paged, or dense, KV of its local attention) against ``repro``'s on the
CPU: the ``recurrentgemma-2b`` cases of ``tests/test_serving.py`` that
need no prefix sharing or preemption (those are in
``tests/test_torch_recurrentgemma_sharing.py``).

Both packages run the smoke config at f32 on the same weights: ``repro``'s
init (key 0) with every block's output projection (``w_out``, ``wo``,
``w_down``) scaled by ``BLOCK_GAIN`` in both.  At the plain init the tied,
scaled embedding dominates the residual stream, so every greedy stream
repeats its prompt's last token whatever the recurrent state holds; with
the gain the streams move from token to token and depend on the state.
Greedy streams must be byte-identical to ``repro``'s, and the counters
and ``compile_counts()`` equal (f32: the two packages' logits differ by
rounding, far below the winning margins here).  Each reference engine
runs once, in a module fixture shared by the tests that compare against
it.

- the dense and the paged layout (``tests/test_serving.py:313``);
- the int8 pool: the reference's agreement gate against the float pool
  (``:465``);
- self-speculation at k = 4 (``:1517``), and with forced rejections: the
  rollback restores ``rec_conv`` / ``rec_h`` with ``pos``;
- the static engine against the continuous one.

The reference runs only where a number of its is compared (its paged and
speculative engines): its own tests hold its dense, int8 and static
engines to its paged one, and each reference engine's compiles take
seconds of a tier-1 run that has little to spare.
"""

import dataclasses

import pytest
import torch
from _block_gain import gained_weights

from repro.configs import get_smoke_config as jax_smoke
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.serving import ServeConfig, ServingEngine, StaticServingEngine

ARCH = "recurrentgemma-2b"
# tests/test_serving.py's mixed trace: mid-flight slot refill, mixed buckets
MIXED_PROMPTS = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
                 [11, 12], [7] * 13]
MIXED_BUDGETS = [6, 9, 3, 12, 5, 7]
LAYOUT = dict(max_batch=3, max_new_tokens=8, max_len=64, kv_block_size=8)
INT8_AGREEMENT = 0.95   # tests/test_serving.py::test_int8_paged_matches_bf16_paged_greedy
COUNTS = ("completed", "total_tokens", "decode_steps", "prefills", "prefill_tokens",
          "prefix_hits", "prefix_partial_hits", "spec_rounds", "spec_drafted", "spec_accepted")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kv: str = "same"):
    kw = dict(dtype="float32", kv_cache_dtype=kv)
    return (dataclasses.replace(jax_smoke(ARCH), **kw),
            dataclasses.replace(get_smoke_config(ARCH), **kw))


@pytest.fixture(scope="module")
def weights():
    return gained_weights(*_cfgs())


def _run(eng):
    for p, b in zip(MIXED_PROMPTS, MIXED_BUDGETS):
        eng.submit(p, b)
    return eng, eng.run()


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's engines on the mixed trace, each run once, on
    first use: ``reference(name)`` → (engine, streams)."""
    jp = weights[0]
    runs: dict = {}
    kinds = {"paged": ("same", {}), "spec": ("same", {"speculate_k": 4})}

    def get(name: str):
        if name not in runs:
            kv, kw = kinds[name]
            runs[name] = _run(JServingEngine(jp, _cfgs(kv)[0], JServeConfig(**LAYOUT, **kw)))
        return runs[name]

    return get


def _port(weights, kv="same", **kw):
    return _run(ServingEngine(weights[1], _cfgs(kv)[1], ServeConfig(**LAYOUT, **kw),
                              device="cpu"))


def _assert_same_run(t_eng, t_out, j_eng, j_out):
    assert t_out == j_out
    tm, jm = t_eng.metrics(), j_eng.metrics()
    for k in COUNTS:
        assert getattr(tm, k) == getattr(jm, k), k
    assert t_eng.compile_counts() == j_eng.compile_counts()


def test_streams_move_with_the_state(reference):
    """The gain does what it is for: most streams are not one repeated
    token, so the decode reads the recurrent state."""
    _, out = reference("paged")
    assert sum(len(set(o)) > 1 for o in out.values()) >= len(out) - 1


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_layout_streams_equal_reference(weights, reference, layout):
    """``tests/test_serving.py::test_dense_vs_paged_greedy_byte_identical``
    for the hybrid family: the port's paged and dense engines give the
    reference's paged streams (its dense ones are the same bytes, by its
    own test); the paged engine also its counts and compiles."""
    t_eng, t_out = _port(weights, kv_layout=layout)
    if layout == "paged":
        _assert_same_run(t_eng, t_out, *reference("paged"))
        assert t_eng.blocks.available == t_eng.blocks.capacity
        return
    assert t_out == reference("paged")[1]
    assert t_eng.compile_counts()["serve_step"] == 1
    assert set(t_eng.compile_counts()) == {"serve_step", "prefill", "insert"}


def test_int8_pool_meets_the_agreement_gate(weights):
    """``test_int8_paged_matches_bf16_paged_greedy``: the int8 pool's
    greedy streams agree with the float pool's on at least
    ``INT8_AGREEMENT`` of the tokens, and the engine drains."""
    _, out_f = _port(weights)
    t_eng, out_8 = _port(weights, "int8")
    assert sorted(out_f) == sorted(out_8)
    total = agree = 0
    for rid in out_f:
        assert len(out_f[rid]) == len(out_8[rid])
        total += len(out_f[rid])
        agree += sum(a == b for a, b in zip(out_f[rid], out_8[rid]))
    assert agree / total >= INT8_AGREEMENT, (agree, total)
    assert t_eng.blocks.available == t_eng.blocks.capacity
    assert t_eng._cache["k_pages"].dtype == torch.int8


def test_speculation_equals_reference(weights, reference):
    """``test_spec_greedy_byte_identity``: at k = 4 the streams are the
    plain engine's and ``repro``'s, with its rounds, drafts and
    acceptances."""
    t_eng, t_out = _port(weights, speculate_k=4)
    j_eng, j_out = reference("spec")
    assert t_out == reference("paged")[1]
    _assert_same_run(t_eng, t_out, j_eng, j_out)
    m = t_eng.metrics()
    assert m.spec_rounds > 0 and m.spec_acceptance > 0.5


def test_forced_rejections_roll_the_recurrent_state_back(weights, reference):
    """``test_spec_forced_rejection_mid_run`` on the hybrid model: every
    other round reports its second draft changed, so each slot accepts one
    draft and rolls ``pos``, ``rec_conv`` and ``rec_h`` back to the state
    after it; the streams stay the plain engine's."""
    eng = ServingEngine(weights[1], _cfgs()[1], ServeConfig(**LAYOUT, speculate_k=4),
                        device="cpu")
    orig = eng._spec_round
    calls = {"n": 0, "states": set()}

    def tampered(*a, **kw):
        d, dok, v, vok, vs = orig(*a, **kw)
        calls["n"] += 1
        calls["states"] |= set(vs)
        if calls["n"] % 2 == 0:
            d = d.clone()
            d[:, 1] ^= 1
        return d, dok, v, vok, vs

    eng._spec_round = tampered
    _, out = _run(eng)
    assert out == reference("paged")[1]
    m = eng.metrics()
    assert calls["n"] >= 2 and m.spec_accepted < m.spec_drafted
    assert calls["states"] == {"pos", "rec_conv", "rec_h"}
    assert eng.compile_counts()["spec_rollback"] == 1


def test_static_engine_equals_continuous(weights):
    """``test_static_vs_continuous_byte_identical``: with the padded
    windows equal (prompts on one bucket), ``StaticServingEngine`` gives
    the continuous engine's streams; over two waves of mixed prompts it
    drains with one graph entry per wave width."""
    _, tcfg = _cfgs()
    _, tp = weights
    sc = dict(max_batch=3, max_new_tokens=6, max_len=64)
    teng = StaticServingEngine(tp, tcfg, ServeConfig(**sc), device="cpu")
    for p, b in zip(MIXED_PROMPTS[:5], MIXED_BUDGETS[:5]):
        teng.submit(p, b)
    outs = teng.run()
    assert [len(o) for o in outs] == MIXED_BUDGETS[:5]
    assert teng.compile_counts() == {"serve_step": 2}
    prompts = MIXED_PROMPTS[:3]
    one = ServeConfig(**sc, prefill_buckets=(8,))
    cont = ServingEngine(tp, tcfg, one, device="cpu")
    stat = StaticServingEngine(tp, tcfg, one, device="cpu")
    for p in prompts:
        cont.submit(p)
        stat.submit(p)
    c_out = cont.run()
    assert [c_out[r] for r in sorted(c_out)] == stat.run()
