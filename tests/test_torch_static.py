"""The port's dense serving layout and ``StaticServingEngine`` against
``repro`` on the CPU.

Both packages serve the same traces from the same weights (``repro``'s
init carried across by ``bridge``).  Token identity is pinned at f32, where
the two packages agree to rounding (~1e-6 on logits) and the smoke
model's greedy tokens win by far more (``tests/test_torch_engine.py``
checks those margins for the paged engine); bf16 greedy identity is
fragile on random smoke weights (ROADMAP C).  Here:

- the dense engine and the static engine give ``repro``'s greedy streams
  byte for byte, with its metrics' counts, ``compile_counts()`` keys and
  Table I accounting (``metrics().analog``);
- the ports of ``tests/test_serving.py``'s layout oracles: static against
  continuous, dense against paged (also under page recycling), and int8
  dense against int8 paged (>= 0.95 of tokens: two quantizers);
- every dense refusal raises the reference's ``ValueError`` with its
  message;
- ``serve.py --static`` and ``--kv-layout dense``.
"""

import dataclasses
import io
import time
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as JTF
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import StaticServingEngine as JStaticServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as SERVE_CLI
from repro_torch.serving import ServeConfig, ServingEngine, StaticServingEngine

# tests/test_serving.py's mixed trace: mid-flight slot refill, mixed buckets
MIXED_PROMPTS = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
                 [11, 12], [7] * 13]
MIXED_BUDGETS = [6, 9, 3, 12, 5, 7]
LAYOUT = dict(max_batch=3, max_new_tokens=8, max_len=64, kv_block_size=8)
INT8_AGREEMENT = 0.95   # tests/test_serving.py::test_int8_paged_matches_int8_dense
# seconds by which the static engine's submissions are backdated: the
# TTFT must carry them whatever the clock's origin (perf_counter() counts
# from boot on Linux, so an absolute reading is no fixed number)
BACKDATE = 3600.0
COUNT_FIELDS = ("completed", "total_tokens", "decode_steps", "prefills", "prefill_tokens",
                "occupancy_mean")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kv: str = "same", dtype: str = "float32", **kw):
    kw = dict(dtype=dtype, kv_cache_dtype=kv, **kw)
    return (dataclasses.replace(jax_smoke("stablelm-3b"), **kw),
            dataclasses.replace(get_smoke_config("stablelm-3b"), **kw))


@pytest.fixture(scope="module")
def weights():
    """f32 smoke weights from ``repro``'s init (key 0), in both packages."""
    jcfg, tcfg = _cfgs()
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jp, tp


def _run_layout(params, cfg, layout, serve_kw=None, engine=ServingEngine, **eng_kw):
    eng = engine(params, cfg, ServeConfig(**LAYOUT, kv_layout=layout, **(serve_kw or {})),
                 **eng_kw)
    for p, b in zip(MIXED_PROMPTS, MIXED_BUDGETS):
        eng.submit(p, b)
    return eng, eng.run()


def _jrun_layout(params, cfg, layout, serve_kw=None):
    eng = JServingEngine(params, cfg,
                         JServeConfig(**LAYOUT, kv_layout=layout, **(serve_kw or {})))
    for p, b in zip(MIXED_PROMPTS, MIXED_BUDGETS):
        eng.submit(p, b)
    return eng, eng.run()


@pytest.fixture(scope="module")
def dense_runs(weights):
    """The mixed trace through the dense engine of each package, f32."""
    jcfg, tcfg = _cfgs()
    jp, tp = weights
    return _jrun_layout(jp, jcfg, "dense"), _run_layout(tp, tcfg, "dense", device="cpu")


def test_dense_engine_byte_identical_to_reference(dense_runs):
    """Greedy streams, the metrics' counts and the done reasons of the
    port's dense engine equal ``repro``'s on the same weights."""
    (jeng, jout), (teng, tout) = dense_runs
    assert tout == jout
    assert sorted(tout) == list(range(len(MIXED_PROMPTS)))
    assert [len(tout[r]) for r in sorted(tout)] == MIXED_BUDGETS
    tm, jm = teng.metrics(), jeng.metrics()
    for field in COUNT_FIELDS:
        assert getattr(tm, field) == getattr(jm, field), field
    assert tm.evictions == jm.evictions == {"length": len(MIXED_PROMPTS)}
    assert teng.blocks is None and not teng.paged


def test_dense_compile_counts_match_reference(dense_runs):
    """The dense engine's ``compile_counts()`` has the reference's keys
    (``serve_step``, ``prefill``, ``insert``) and values: one decode step
    (one batch width), one prefill per bucket, one insert; a second serve
    of the trace adds none."""
    (jeng, _), (teng, _) = dense_runs
    counts = teng.compile_counts()
    assert counts == jeng.compile_counts()
    assert counts["serve_step"] == 1 and counts["insert"] == 1
    assert counts["prefill"] == len({teng._bucket(len(p)) for p in MIXED_PROMPTS})
    for p, b in zip(MIXED_PROMPTS, MIXED_BUDGETS):
        teng.submit(p, b)
        jeng.submit(p, b)
    assert teng.run() == jeng.run()
    assert teng.compile_counts() == counts == jeng.compile_counts()


def test_dense_analog_accounting_matches_reference(dense_runs):
    """``metrics().analog``: the Table I accounting of the dense engine's
    two admission ``note_call``s (the whole bucket forwarded, one sample)
    and its decode steps equals the reference's."""
    (jeng, _), (teng, _) = dense_runs
    assert teng.metrics().analog == jeng.metrics().analog


def test_static_engine_byte_identical_to_reference(weights):
    """``StaticServingEngine`` over two waves (three slots, then two, one
    graph per wave width on a card): the reference's streams and
    counts; ``submit_time`` backdates the TTFT."""
    jcfg, tcfg = _cfgs()
    jp, tp = weights
    sc = dict(max_batch=3, max_new_tokens=6, max_len=64)
    jeng = JStaticServingEngine(jp, jcfg, JServeConfig(**sc))
    teng = StaticServingEngine(tp, tcfg, ServeConfig(**sc), device="cpu")
    for p, b in zip(MIXED_PROMPTS[:5], MIXED_BUDGETS[:5]):
        jeng.submit(p, b)
        teng.submit(p, b, submit_time=time.perf_counter() - BACKDATE)
    assert teng.pending() == 5
    assert teng.run() == jeng.run()
    tm, jm = teng.metrics(), jeng.metrics()
    for field in COUNT_FIELDS[:-2] + ("occupancy_mean",):
        assert getattr(tm, field) == getattr(jm, field), field
    assert teng.compile_counts() == {"serve_step": 2}
    assert tm.ttft_mean >= BACKDATE   # submitted BACKDATE seconds ago
    with pytest.raises(ValueError, match="max_len"):
        teng.submit([1] * 60, 8)


def test_static_vs_continuous_byte_identical(weights):
    """``tests/test_serving.py::test_static_vs_continuous_byte_identical``:
    with the padded windows equal (prompts on the single bucket, the
    static batch's longest), the static and the continuous engine's greedy
    streams are the same bytes."""
    _, tcfg = _cfgs()
    _, tp = weights
    prompts = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2]]
    sc = ServeConfig(max_batch=3, max_new_tokens=6, max_len=64, prefill_buckets=(8,))
    cont = ServingEngine(tp, tcfg, sc, device="cpu")
    stat = StaticServingEngine(tp, tcfg, sc, device="cpu")
    for p in prompts:
        cont.submit(p)
        stat.submit(p)
    assert cont.step() == stat.step()


def test_dense_vs_paged_greedy_byte_identical(weights, dense_runs):
    """``tests/test_serving.py::test_dense_vs_paged_greedy_byte_identical``
    (stablelm-3b): the mixed trace with mid-flight refill gives the same
    greedy bytes through the dense oracle and the paged engine."""
    _, tcfg = _cfgs()
    _, tp = weights
    _, (_, out_dense) = dense_runs
    _, out_paged = _run_layout(tp, tcfg, "paged", device="cpu")
    assert out_dense == out_paged


def test_paged_identity_under_page_recycling(weights, dense_runs):
    """``tests/test_serving.py::test_paged_identity_under_page_recycling``:
    a pool of 12 blocks (3 slots x 3 pages + trash, no slack) hands freed
    pages to later requests mid-flight; decode stays dense's bytes."""
    _, tcfg = _cfgs()
    _, tp = weights
    _, (_, out_dense) = dense_runs
    eng, out_paged = _run_layout(tp, tcfg, "paged", {"num_kv_blocks": 12}, device="cpu")
    assert out_dense == out_paged
    assert eng.blocks.available == eng.blocks.capacity


def test_int8_paged_matches_int8_dense(weights):
    """``tests/test_serving.py::test_int8_paged_matches_int8_dense``: the
    dense layout's nearest rounding and the paged pool's stochastic
    rounding are different quantizers of one cache; their greedy streams
    agree on at least 95% of tokens (bf16 weights, as the reference's
    smoke model)."""
    jcfg, tcfg = _cfgs("int8", "bfloat16")
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg,
                           device="cpu")
    deng, out_dense = _run_layout(tp, tcfg, "dense", device="cpu")
    _, out_paged = _run_layout(tp, tcfg, "paged", device="cpu")
    assert deng._cache["k"].dtype == torch.int8 and "k_scale" in deng._cache
    total = agree = 0
    for rid in out_dense:
        total += len(out_dense[rid])
        agree += sum(a == b for a, b in zip(out_dense[rid], out_paged[rid]))
    assert agree / total >= INT8_AGREEMENT, (agree, total)


REFUSALS = [
    dict(prefill_chunk=16),
    dict(fault_injector=object()),
    dict(speculate_k=2),
    dict(device_backend="sim_faulty"),
    dict(spill_budget_bytes=1 << 20),
]


@pytest.mark.parametrize("knob", REFUSALS, ids=[next(iter(k)) for k in REFUSALS])
def test_dense_refusals_match_reference(knob):
    """Each paged-only knob on the dense layout raises ``ValueError`` with
    the reference's message, at construction as well as in ``validate``."""
    with pytest.raises(ValueError) as want:
        JServeConfig(kv_layout="dense", **knob).validate()
    with pytest.raises(ValueError) as got:
        ServeConfig(kv_layout="dense", **knob).validate()
    assert str(got.value) == str(want.value)
    assert "dense" in str(got.value) or "paged" in str(got.value)
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="dense|paged"):
        ServingEngine({"embed": {"embedding": torch.zeros(1)}}, tcfg,
                      ServeConfig(kv_layout="dense", **knob), device="cpu")


def test_bad_kv_layout_is_loud():
    with pytest.raises(ValueError) as want:
        JServeConfig(kv_layout="flat").validate()
    with pytest.raises(ValueError) as got:
        ServeConfig(kv_layout="flat").validate()
    assert str(got.value) == str(want.value)


def test_dense_wta_engine_serves():
    """WTA sampling on the dense layout: per-slot keys and steps, a first
    token drawn at admission; the streams are not the greedy ones, and a
    second engine on the same seed repeats them."""
    _, tcfg = _cfgs(wta_head=True)
    from repro_torch.models.transformer import init_lm

    tp = init_lm(tcfg, seed=0, device="cpu")
    outs = []
    for _ in range(2):
        _, out = _run_layout(tp, tcfg, "dense", device="cpu")
        outs.append(out)
    assert outs[0] == outs[1]
    _, greedy = _run_layout(tp, dataclasses.replace(tcfg, wta_head=False), "dense",
                            device="cpu")
    assert outs[0] != greedy


@pytest.mark.parametrize("flags", [["--static"], ["--kv-layout", "dense"],
                                   ["--static", "--wta"]])
def test_serve_cli_static_and_dense(flags):
    """``serve.py --static`` and ``--kv-layout dense`` serve on the CPU; the
    static engine takes no priority or deadline and drains through
    ``run()``; the dense layout refuses ``--prefill-chunk``."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        outs = SERVE_CLI.main(["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
                               "--requests", "5", "--new-tokens", "4", "--slots", "2", *flags])
    text = buf.getvalue()
    assert len(outs) == 5 and all(len(o) == 4 for o in outs)
    assert ("engine=static" in text) == ("--static" in flags)
    assert "dense" in text
    counts = eval(text.strip().splitlines()[-1].removeprefix("compile counts "))
    # one dense step per batch width: the static engine's waves are 2, 2, 1
    assert counts["serve_step"] == (2 if "--static" in flags else 1)
    if "--static" not in flags:
        assert set(counts) == {"serve_step", "prefill", "insert"}
        with pytest.raises(ValueError, match="prefill_chunk"):
            SERVE_CLI.main(["--arch", "stablelm-3b", "--smoke", "--device", "cpu",
                            *flags, "--prefill-chunk", "16"])
