"""The compiled decode step (``specs.DecodeGraphs``) and the engine's
``compile_counts()``, on the CPU, against ``repro``.

On the CPU the step runs eagerly on the static buffers that the card's
CUDA graphs capture, so these tests hold everything but capture and
replay (``tests/test_torch_cuda.py`` holds those on the card): the
in-place advance of ``pos`` and ``quant_step`` that a graph depends on,
RoPE frequencies bit-identical to their old host-tensor form, one
``serve_step`` entry per window width, the reference's compile counts on
the same trace, and greedy, int8 and WTA (R = 1, 3) streams through the
static buffers byte-identical to ``repro`` at f32, with speculation
(``speculate_k``, ``specs.SpecGraphs``) too.
"""

import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as JTF
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops as KOPS
from repro_torch.launch import specs as SP
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TTF
from repro_torch.models.transformer import init_lm
from repro_torch.serving import ServeConfig, ServingEngine

SERVE = dict(
    max_batch=4, max_new_tokens=6, max_len=64, kv_block_size=8,
    prefill_chunk=16, prefill_buckets=(12, 16, 32, 36, 48), seed=5,
)


def _trace():
    """``tests/test_torch_engine.py``'s shared-prefix trace: cold prompts,
    same-tick full hits (one forking copy-on-write), partial hits that
    prefill only their suffix, unrelated prompts that queue."""
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


def _serve(eng, prompts, budgets=None):
    for i, p in enumerate(prompts):
        eng.submit(p, None if budgets is None else budgets[i])
    return eng.run()


@pytest.mark.parametrize("kv", ["same", "int8"])
def test_decode_step_advances_pos_and_quant_step_in_place(kv):
    """A captured step reads ``pos`` and ``quant_step`` from fixed
    addresses, so the step advances them in their own storage."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32",
                              kv_cache_dtype=kv)
    params = init_lm(cfg, seed=0, device="cpu")
    cache = TTF.init_paged_decode_cache(cfg, 2, 6, 8, device="cpu")
    cache["pos"].copy_(torch.tensor([9, 3], dtype=torch.int32))
    before = {k: (v.data_ptr(), v.clone()) for k, v in cache.items()
              if k in ("pos", "quant_step")}
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    for step in range(1, 4):
        out, _ = TTF.lm_decode_step(params, cache, torch.tensor([5, 7], dtype=torch.int32),
                                    cfg, table)
        assert out is cache
        for k, (ptr, v0) in before.items():
            assert cache[k].data_ptr() == ptr, k
            assert torch.equal(cache[k], v0 + step), k
    assert ("quant_step" in before) == (kv == "int8")


@pytest.mark.parametrize("head_dim,theta", [(80, 10000.0), (16, 10000.0), (64, 1e6),
                                            (128, 500000.0), (8, 10.0)])
def test_rope_freqs_bit_identical_to_the_host_tensor_form(head_dim, theta):
    """The frequencies no longer build a device tensor from the host, and
    keep the bits of the old form ``pow(tensor(theta), exps)``; they are
    computed once per (head_dim, theta, device)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32) / half
    old = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    new = TL.rope_freqs(head_dim, theta, "cpu")
    assert new.dtype == torch.float32
    assert torch.equal(new.view(torch.int32), old.view(torch.int32))
    assert TL.rope_freqs(head_dim, theta, torch.device("cpu")) is new


def test_one_serve_step_entry_per_window_width():
    """The counterpart of ``test_paged_recompile_guard``
    (``tests/test_serving.py``): one ``serve_step`` entry per decode window
    width the trace reaches, far fewer than decode steps, and a second
    identical trace adds none, to any entry point."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32")
    eng = ServingEngine(init_lm(cfg, seed=0, device="cpu"), cfg, ServeConfig(**SERVE),
                        device="cpu")
    widths = []
    window = eng._window_blocks
    eng._window_blocks = lambda active: widths.append(window(active)) or widths[-1]
    prompts = _trace()
    budgets = [6, 2, 9, 4, 12, 1, 3, 7, 8]
    _serve(eng, prompts, budgets)
    counts = eng.compile_counts()
    assert counts["serve_step"] == len(set(widths)) >= 2
    assert sorted(k[0] for k in eng._decode.entries) == sorted(set(widths))
    assert eng.metrics().decode_steps == len(widths) > counts["serve_step"]
    assert counts["state_insert"] == counts["sample0"] == counts["page_copy"] == 1
    _serve(eng, prompts, budgets)
    assert eng.compile_counts() == counts, "steady-state trace recompiled"
    assert eng.metrics().decode_steps == len(widths)


@pytest.mark.parametrize("kv,wta,reads,seed,spec", [
    ("same", False, 1, 1, 0), ("int8", False, 1, 2, 0), ("same", True, 1, 1, 0),
    ("same", True, 3, 1, 0), ("same", False, 1, 1, 3),
], ids=["greedy", "int8", "wta", "wta_r3", "greedy_spec3"])
def test_compile_counts_and_streams_match_reference(kv, wta, reads, seed, spec):
    """The port's ``compile_counts()`` equals ``repro``'s on the same trace,
    with the same keys (the preemption entry points ``page_spill``,
    ``page_restore`` and ``state_gather`` included, at 0 on a trace that
    preempts nothing; with ``speculate_k`` also ``spec_round`` and
    ``spec_rollback``), before and after a second identical trace; the
    streams through the static decode buffers are byte-identical to
    ``repro``'s."""
    jcfg, jp, tcfg, tp = _bridged(kv, wta, seed)
    scfg = dict(SERVE, n_redundant_reads=reads, speculate_k=spec)
    j_eng = JServingEngine(jp, jcfg, JServeConfig(**scfg))
    t_eng = ServingEngine(tp, tcfg, ServeConfig(**scfg), device="cpu")
    for _ in range(2):
        prompts = _trace()
        assert _serve(t_eng, prompts) == _serve(j_eng, prompts)
        ours, theirs = t_eng.compile_counts(), j_eng.compile_counts()
        assert set(ours) == set(theirs)
        assert ours == theirs
        assert ("spec_round" in ours) == bool(spec)
    assert t_eng.metrics().decode_steps == j_eng.metrics().decode_steps
    if spec:
        assert t_eng.metrics().spec_rounds > 0


def test_graphs_default_is_eager_on_the_cpu():
    """``graphs=None`` means on when the device is CUDA: on the CPU it is
    the eager path, with the streams of ``graphs=False``; ``graphs=True``
    on the CPU raises."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32", wta_head=True)
    params = init_lm(cfg, seed=0, device="cpu")
    default = ServingEngine(params, cfg, ServeConfig(**SERVE), device="cpu")
    eager = ServingEngine(params, cfg, ServeConfig(**SERVE), device="cpu", graphs=False)
    assert not default._decode.capture and not eager._decode.capture
    assert _serve(default, _trace()) == _serve(eager, _trace())
    assert default.compile_counts() == eager.compile_counts()
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        ServingEngine(params, cfg, ServeConfig(**SERVE), device="cpu", graphs=True)


@pytest.mark.parametrize("wta,spec", [(False, 0), (True, 0), (False, 3)],
                         ids=["False", "True", "spec3"])
def test_engine_is_freed_when_dropped(wta, spec):
    """Nothing an engine holds (its entry points, its compiled step and
    speculative round) refers back to it, so dropping the last reference
    frees it, its pool and its graphs at once, without waiting for the
    cycle collector: a process that builds engines one after another
    (``chip_smoke.py``) holds one pool at a time."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32", wta_head=wta)
    eng = ServingEngine(init_lm(cfg, seed=0, device="cpu"), cfg,
                        ServeConfig(**SERVE, speculate_k=spec), device="cpu")
    _serve(eng, _trace()[:4])
    assert eng.compile_counts()["spec_round" if spec else "serve_step"] >= 1
    ref, pool = weakref.ref(eng), weakref.ref(eng._cache["k_pages"])
    gc.disable()
    try:
        del eng
        assert ref() is None and pool() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("wta,reads", [(False, 1), (True, 3)])
def test_decode_graphs_static_buffers_equal_the_plain_step(wta, reads):
    """``DecodeGraphs`` fills one entry's static inputs in place on every
    call (same storage, new values) and returns what
    ``make_paged_serve_step`` returns on the same inputs and cache."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32", wta_head=wta)
    params = init_lm(cfg, seed=0, device="cpu")
    cache = TTF.init_paged_decode_cache(cfg, 3, 10, 8, device="cpu")
    plain_cache = {k: v.clone() for k, v in cache.items()}
    graphs = SP.DecodeGraphs(cfg, params, cache, n_redundant=reads, capture=False)
    step = SP.make_paged_serve_step(cfg, n_redundant=reads)
    rng = np.random.default_rng(0)
    full = rng.permutation(np.arange(1, 10, dtype=np.int32)).reshape(3, 3)
    ptrs = {}
    for i, w in enumerate((2, 2, 3, 2)):
        table = full[:, :w]
        tokens = rng.integers(0, cfg.vocab, 3).astype(np.int32)
        wta_in = ((rng.integers(0, 2**32, (3, 2)), np.full((3,), i, np.int64))
                  if wta else ())
        tok, sane = graphs(table, tokens, *wta_in)
        _, want_tok, want_sane = step(params, plain_cache, *(torch.from_numpy(np.array(a))
                                                             for a in (table, tokens, *wta_in)))
        assert torch.equal(tok, want_tok) and torch.equal(sane, want_sane)
        entry = graphs.entries[(w, reads)]
        got = [x.data_ptr() for x in entry.inputs]
        assert ptrs.setdefault(w, got) == got
        assert np.array_equal(entry.inputs[0].numpy(), table)
    assert sorted(graphs.entries) == [(2, reads), (3, reads)]
    for k in cache:
        assert torch.equal(cache[k], plain_cache[k]), k


def test_launch_counts_cover_every_wrapper_and_add():
    """``ops.launch_counts`` reads every kernel wrapper's counter (each
    module attribute named ``*launches``), and ``ops.add_launches`` moves
    them, as a graph replay does."""
    from repro_torch.kernels import (crossbar_mac, paged_attention, prefill_attention,
                                     sigmoid_sample, stoch_round, wta_counts, wta_sample)

    mods = (crossbar_mac, paged_attention, prefill_attention, sigmoid_sample, stoch_round,
            wta_counts, wta_sample)
    attrs = {(m.__name__, a) for m in mods for a in vars(m) if a.endswith("launches")
             and isinstance(getattr(m, a), int)}
    assert {(m.__name__, a) for m, a in KOPS._COUNTERS.values()} == attrs
    before = KOPS.launch_counts()
    KOPS.add_launches({"paged_attention": 32, "write_kv_int8": 32, "wta_sample": 3})
    try:
        after = KOPS.launch_counts()
        assert after["paged_attention"] - before["paged_attention"] == 32
        assert after["write_kv_int8"] - before["write_kv_int8"] == 32
        assert after["wta_sample"] - before["wta_sample"] == 3
        assert all(after[k] == before[k] for k in after
                   if k not in ("paged_attention", "write_kv_int8", "wta_sample"))
    finally:
        KOPS.add_launches({"paged_attention": -32, "write_kv_int8": -32, "wta_sample": -3})
    assert KOPS.launch_counts() == before
