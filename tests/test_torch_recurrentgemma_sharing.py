"""The port's paged engine carrying recurrentgemma-2b's recurrent state
through prefix sharing, the chunk-grid resume and preemption, against
``repro``'s on the CPU: the ``recurrentgemma-2b`` cases of
``tests/test_serving.py`` at ``:609`` (prefix sharing), ``:872`` (partial
sharing on the chunk grid), ``:1313`` (preempt / restore) and ``:1584``
(speculation with preemption).

Both packages run the smoke config at f32 on the same weights as
``tests/test_torch_recurrentgemma_serving.py`` (``repro``'s init with the
blocks' output projections scaled by ``BLOCK_GAIN``, so the streams read
the state).  Greedy streams must be byte-identical to ``repro``'s, and the
counters and ``compile_counts()`` equal.  A full prefix hit inserts the
stored (logits, state) payload; a partial hit resumes at the deepest chunk
boundary it matched, from the state snapshot stashed there; a spill record
carries ``rec_conv`` / ``rec_h`` with the pages and ``pos``.  Each
reference engine runs once, in a module fixture, and only where a number
of its is compared: the port's engines without sharing are held to the
port's with it, as the reference holds its own.
"""

import dataclasses

import pytest
import torch
from _block_gain import gained_weights

from repro.configs import get_smoke_config as jax_smoke
from repro.serving import FaultInjector as JInjector
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config
from repro_torch.serving import FaultInjector, ServeConfig, ServingEngine

ARCH = "recurrentgemma-2b"
# tests/test_serving.py's repeated-prefix trace
SHARED_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9],
                  [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9]]
SHARED_BUDGETS = [6, 4, 6, 3, 5]
SHARING = dict(max_batch=3, max_new_tokens=8, max_len=64, kv_block_size=8)
# three 24-token prompts on a 16-token common head, bucket 32, chunks of 8
HEAD = list(range(1, 17))
PARTIAL_PROMPTS = [HEAD + [30 + i] * 8 for i in range(3)]
PARTIAL = dict(max_batch=3, max_new_tokens=6, max_len=64, kv_block_size=8, prefill_chunk=8)
PREEMPT = dict(max_batch=2, max_new_tokens=10, max_len=64, kv_block_size=8,
               prefill_buckets=(16,))
PREEMPT_PROMPTS = [list(range(1, 10)), list(range(2, 14))]
COUNTS = ("completed", "total_tokens", "decode_steps", "prefills", "prefill_tokens",
          "prefill_tokens_saved", "prefix_hits", "prefix_partial_hits", "cow_forks",
          "preemptions", "restores", "spec_rounds", "spec_drafted", "spec_accepted")


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
    jp, tp = gained_weights(jcfg, tcfg)
    return (jp, jcfg), (tp, tcfg)


# name -> (ServeConfig fields, prompts, budgets, fault schedule)
RUNS = {
    "share_on": (SHARING, SHARED_PROMPTS, SHARED_BUDGETS, ()),
    "share_off": (dict(SHARING, enable_prefix_sharing=False), SHARED_PROMPTS, SHARED_BUDGETS,
                  ()),
    "partial_on": (PARTIAL, PARTIAL_PROMPTS, [6] * 3, ()),
    "partial_off": (dict(PARTIAL, enable_prefix_sharing=False), PARTIAL_PROMPTS, [6] * 3, ()),
    "plain": (PREEMPT, PREEMPT_PROMPTS, [10] * 2, ()),
    "preempt": (PREEMPT, PREEMPT_PROMPTS, [10] * 2, ((4, "preempt"), (8, "preempt"))),
    "spec_preempt": (dict(PREEMPT, speculate_k=3), PREEMPT_PROMPTS, [10] * 2,
                     ((1, "preempt"), (3, "preempt"))),
}


def _serve(package, name, wrap=None):
    """One engine of ``package`` ("repro" or "port") on run ``name``;
    ``wrap(engine)`` is called before the trace is submitted."""
    fields, prompts, budgets, schedule = RUNS[name]
    (params, cfg), Engine, Config, Inj, kw = package
    inj = None
    if schedule:
        inj = Inj()
        for tick, kind in schedule:
            inj.at(tick, kind)
    eng = Engine(params, cfg, Config(**fields, fault_injector=inj), **kw)
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
    return lambda name, wrap=None: _serve(pkg, name, wrap)


def _assert_same_run(t_run, j_run):
    (t_eng, t_out), (j_eng, j_out) = t_run, j_run
    assert t_out == j_out
    tm, jm = t_eng.metrics(), j_eng.metrics()
    for k in COUNTS:
        assert getattr(tm, k) == getattr(jm, k), k
    assert t_eng.compile_counts() == j_eng.compile_counts()
    assert t_eng.blocks.available == t_eng.blocks.capacity


def test_prefix_sharing_equals_reference(port, reference):
    """``test_prefix_sharing_byte_identical``: sharing on and off give the
    same streams, the reference's, and repeats take full hits whose
    stored payload carries the recurrent state."""
    on, off = port("share_on"), port("share_off")
    _assert_same_run(on, reference("share_on"))
    assert on[1] == off[1]
    m_on, m_off = on[0].metrics(), off[0].metrics()
    assert m_off.prefix_hits == 0 and m_on.prefix_hits >= 1
    assert m_on.prefills == m_off.prefills - m_on.prefix_hits


def test_partial_sharing_resumes_on_the_chunk_grid(port, reference):
    """``test_partial_sharing_byte_identity``: the padded prompts share 24
    tokens (3 blocks, 3 chunks of 8), so the two repeats resume at 24 from
    the state snapshot stashed on the third block, and the streams equal
    the unshared run's and the reference's."""
    resumes = []

    def spy(eng):
        real = eng._resume_state

        def resume_state(plan, q0):
            state = real(plan, q0)
            resumes.append((q0, sorted(state)))
            return state

        eng._resume_state = resume_state

    on, off = port("partial_on", spy), port("partial_off")
    _assert_same_run(on, reference("partial_on"))
    assert on[1] == off[1]
    m, m_off = on[0].metrics(), off[0].metrics()
    assert m_off.prefix_partial_hits == m_off.prefill_tokens_saved == 0
    assert m.prefix_partial_hits == 2 and m.prefill_tokens_saved == 2 * 24
    assert m.prefill_tokens == m_off.prefill_tokens - 2 * 24
    assert [q0 for q0, _ in resumes] == [0, 24, 24]
    assert resumes[1][1] == ["pos", "rec_conv", "rec_h"]


def test_partial_hit_off_the_grid_rounds_down():
    """A prompt matching 2 blocks (16 tokens) of a chunk grid of 12 blocks'
    worth resumes at 0: the depth rounds down to the grid, where a state
    snapshot exists (``_resume_tokens``)."""
    eng = ServingEngine.__new__(ServingEngine)
    eng._stateful = True
    eng.cfg = ServeConfig(**dict(PARTIAL, prefill_chunk=24))
    assert eng._resume_tokens(2, 32) == 0
    assert eng._resume_tokens(3, 32) == 24
    eng._stateful = False
    assert eng._resume_tokens(2, 32) == 16


def test_preempt_restore_equals_reference(port, reference):
    """``test_preempt_restore_byte_identity``: two forced preemptions of
    decoding slots; the spill records hold the pages and ``pos``,
    ``rec_conv``, ``rec_h`` (as many bytes as the reference's), and the
    restored streams equal the unpreempted ones and the reference's."""
    records = []

    def spy(eng):
        real = eng._store_spill

        def store(rid, rec):
            records.append((sorted(rec["state"]), eng._spill_nbytes(rec)))
            real(rid, rec)

        eng._store_spill = store

    run = port("preempt", spy)
    _assert_same_run(run, reference("preempt"))
    assert run[1] == reference("plain")[1] == port("plain")[1]
    assert run[0].metrics().preemptions == 2
    assert [names for names, _ in records] == [["pos", "rec_conv", "rec_h"]] * 2
    cfg = get_smoke_config(ARCH)
    w, n_rec = cfg.lru_width, cfg.layer_pattern.count("rec")
    state_bytes = 4 + n_rec * (3 * w + w) * 4       # pos, f32 conv tail and h
    assert all(nbytes > state_bytes for _, nbytes in records)


def test_speculation_with_preemption_equals_reference(port, reference):
    """``test_spec_preempt_restore_byte_identity``: speculation at k = 3
    with preemptions between rounds; the streams equal the plain
    unpreempted run's and the reference's."""
    run = port("spec_preempt")
    _assert_same_run(run, reference("spec_preempt"))
    assert run[1] == reference("plain")[1]
    m = run[0].metrics()
    assert m.preemptions >= 1 and m.restores == m.preemptions and m.spec_rounds > 0
