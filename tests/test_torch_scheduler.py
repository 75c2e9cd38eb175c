"""The port's copy of the scheduler under the allocator invariant fuzz.

``repro_torch/serving/scheduler.py`` is a verbatim copy of the reference's
host-only scheduler.  This file reruns ``tests/test_prefix_sharing.py``'s
random admission / COW / eviction traces, with every invariant re-checked
after every operation, against the port's ``BlockAllocator``.
"""

import pytest

import test_prefix_sharing as TPS
from _hypothesis_compat import hypothesis, st
from repro_torch.serving import scheduler as TS

given = hypothesis.given
settings = hypothesis.settings


def _port_fuzz_trace(seed: int, n_blocks: int, n_ops: int) -> None:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TPS, "BlockAllocator", TS.BlockAllocator)
        TPS._fuzz_trace(seed, n_blocks, n_ops)


@settings(deadline=None, max_examples=25)
@given(
    seed=st.integers(0, 10_000),
    n_blocks=st.integers(3, 24),
    n_ops=st.integers(10, 120),
)
def test_port_allocator_invariants_under_fuzz(seed, n_blocks, n_ops):
    _port_fuzz_trace(seed, n_blocks, n_ops)


@settings(deadline=None, max_examples=5)
@given(seed=st.integers(0, 10_000))
def test_port_allocator_invariants_under_long_tight_fuzz(seed):
    _port_fuzz_trace(seed, 5, 400)


def test_port_scheduler_is_the_reference_copy():
    """Same chain hashes, same padding, same admission order."""
    from repro.serving import scheduler as JS

    prompt = list(range(37))
    assert TS.prefix_block_hashes(TS.left_pad(prompt, 48), 16) == \
        JS.prefix_block_hashes(JS.left_pad(prompt, 48), 16)
    ts, js = TS.Scheduler(2), JS.Scheduler(2)
    for pr in (1, 0, 1):
        ts.submit([1, 2], 4, priority=pr)
        js.submit([1, 2], 4, priority=pr)
    assert [r.rid for r in ts.admit()] == [r.rid for r in js.admit()] == [1, 0]
