"""A whole run of each cell on the CPU at smoke size (the look for a card
skipped): sound runs come out correct, and a run whose served tokens are
altered where they are produced comes out not correct."""

from __future__ import annotations

import time

import pytest
import torch

from _smoke import smoke  # noqa: F401  (puts src/ and the root on the path)
from perfbench import run as RUN

CELLS = ["stablelm-3b.chat_wta", "granite-moe-3b-a800m.reasoning_batch"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cell, seed=7, trace=False, fault=None):
    return RUN.run_cell(cell, seed, 1.5, trace, time.perf_counter(), device="cpu",
                        overrides=smoke, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"] and "itl_p99_ms" in line["metrics"]
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("cell", CELLS)
def test_altered_token_is_not_correct(cell, monkeypatch):
    from repro_torch.launch import specs

    orig = specs.sample_tokens

    def altered(cfg, logits, *a, **kw):
        tok = orig(cfg, logits, *a, **kw)
        return torch.where(torch.arange(tok.shape[0]) % 2 == 0, (tok + 97) % cfg.vocab, tok).to(tok.dtype)

    monkeypatch.setattr(specs, "sample_tokens", altered)
    line = _run(cell)
    assert not line["correct"], line["compared"]


def test_one_trial_sampler_is_not_correct(monkeypatch):
    """A WTA sampler that serves its first trial's winner, not the vote of
    its 32 trials: every served token won a trial, and the check still
    fails it by the tally."""
    import dataclasses

    from repro_torch.launch import specs

    orig = specs.sample_tokens

    def one_trial(cfg, logits, *a, **kw):
        one = dataclasses.replace(cfg, analog=dataclasses.replace(cfg.analog, wta_trials=1))
        return orig(one, logits, *a, **kw)

    monkeypatch.setattr(specs, "sample_tokens", one_trial)
    line = _run(CELLS[0])
    assert not line["correct"], line["compared"]


def test_traced_run_reads_its_counters():
    line = _run(CELLS[0], trace=True)
    m = line["metrics"]
    assert {"decode_step_ms", "decode_mfu", "device_idle_pct.serve", "ttft_p95_ms.chat"} <= set(m)
    assert m["ttft_p95_ms.chat"]["value"] > 0
    assert line["device"]["window_s"] > 0
    assert len(line["breakdown"]["idle_gaps"]) <= 10
