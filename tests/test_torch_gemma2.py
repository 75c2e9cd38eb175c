"""The paged engine serving the other decoder configs, against ``repro``'s
on the CPU.

gemma2-2b's smoke config (local window 16, attention and final soft-caps,
post-block norms, tied and scaled embeddings, units of a local and a
global sublayer) serves prompts of 20 to 38 tokens in one 40-token
bucket, so that the prefill and the decode steps both reach past the
window and the local mask cuts keys (``tests/test_torch_archs.py`` runs
the chunked prefill past it).  Both packages run the same f32 weights
(``repro_torch.bridge``) under one ``ServeConfig``; the streams, the
counters and ``compile_counts()`` must be equal, over a float pool and an
int8 pool with greedy and WTA sampling, as ``tests/test_torch_preempt.py``
holds stablelm-3b, and on the int8 pool under self-speculation with two
forced preemptions (every leaf of both sublayers spilled, restored and
rolled back).  One bucket and whole-bucket prefill keep the reference's
compiles few.  int8 with WTA runs ``repro`` with its int8 decode computed
in f32 (its CPU path rounds q and the weights to bf16; its TPU kernel and
the port compute in f32): :func:`f32_int8_decode`.  The port's dense and
paged layouts give the same greedy streams at f32.  deepseek-coder-33b and
nemotron-4-340b smoke serve one greedy f32 trace each against ``repro``.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as JA
from repro.models import transformer as JTF
from repro.serving import FaultInjector as JInjector
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.serving import FaultInjector, ServeConfig, ServingEngine

SERVE = dict(max_batch=2, max_new_tokens=10, max_len=64, kv_block_size=8, prefill_buckets=(40,))
_rng = np.random.default_rng(11)
PROMPTS = [_rng.integers(0, 256, n).tolist() for n in (20, 38, 30)]
CASES = [("same", False), ("same", True), ("int8", False), ("int8", True)]
CASE_IDS = ["greedy", "wta", "int8", "int8-wta"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, kv: str = "same", wta: bool = False):
    kw = dict(dtype="float32", kv_cache_dtype=kv, wta_head=wta)
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _weights(arch: str):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.jit(JTF.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


@pytest.fixture(scope="module")
def gemma_weights():
    return _weights("gemma2-2b")


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


def _serve_both(arch, weights, kv="same", wta=False, schedule=(), **kw):
    """Both packages' engines on the trace; ``schedule`` is (tick, kind)
    events for both packages' fault injectors."""
    jcfg, tcfg = _cfgs(arch, kv, wta)
    jp, tp = weights
    injectors = []
    for Inj in (JInjector, FaultInjector):
        inj = Inj() if schedule else None
        for tick, kind in schedule:
            inj.at(tick, kind)
        injectors.append(inj)
    j_eng = JServingEngine(jp, jcfg, JServeConfig(**dict(SERVE, fault_injector=injectors[0],
                                                          **kw)))
    t_eng = ServingEngine(tp, tcfg, ServeConfig(**dict(SERVE, fault_injector=injectors[1], **kw)),
                          device="cpu")
    outs = []
    for eng in (j_eng, t_eng):
        for p in PROMPTS:
            eng.submit(p)
        outs.append(eng.run())
    j_out, t_out = outs
    assert t_out == j_out
    assert sorted(t_out) == list(range(len(PROMPTS)))
    jm, tm = j_eng.metrics(), t_eng.metrics()
    for k in ("evictions", "completed", "total_tokens", "decode_steps", "prefill_tokens",
              "prefix_hits", "prefix_partial_hits", "preemptions", "restores", "spec_rounds",
              "spec_accepted", "spec_drafted"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert t_eng.compile_counts() == j_eng.compile_counts()
    assert t_eng.blocks.available == t_eng.blocks.capacity
    return t_eng


@pytest.mark.parametrize("kv,wta", CASES, ids=CASE_IDS)
def test_gemma2_paged_streams_equal_reference(gemma_weights, kv, wta, request):
    if kv == "int8" and wta:
        request.getfixturevalue("f32_int8_decode")
    eng = _serve_both("gemma2-2b", gemma_weights, kv, wta)
    assert eng.metrics().total_tokens == len(PROMPTS) * SERVE["max_new_tokens"]


def test_gemma2_int8_speculation_with_preemption_equals_reference(gemma_weights):
    """Self-speculation at k = 3 on an int8 pool with two forced
    preemptions: the draft steps, the verify, the rollbacks, and every
    spilled and restored leaf of both sublayers of each unit (codes and
    scale planes) leave the streams equal to ``repro``'s."""
    eng = _serve_both("gemma2-2b", gemma_weights, "int8", schedule=[(2, "preempt"),
                                                                     (4, "preempt")],
                      speculate_k=3)
    m = eng.metrics()
    assert m.spec_rounds > 0 and m.preemptions == 2 and m.restores == 2


def test_gemma2_dense_equals_paged(gemma_weights):
    """The port's dense layout (whole-bucket prefill, one window a slot)
    and its paged layout give the same greedy f32 streams."""
    _, tcfg = _cfgs("gemma2-2b")
    outs = []
    for layout in ("paged", "dense"):
        eng = ServingEngine(gemma_weights[1], tcfg, ServeConfig(**dict(SERVE, kv_layout=layout)),
                            device="cpu")
        for p in PROMPTS:
            eng.submit(p)
        outs.append(eng.run())
    assert outs[0] == outs[1]
    assert all(len(o) == SERVE["max_new_tokens"] for o in outs[1].values())


@pytest.mark.parametrize("arch", ["deepseek-coder-33b", "nemotron-4-340b"])
def test_other_decoders_greedy_streams_equal_reference(arch):
    _serve_both(arch, _weights(arch))
