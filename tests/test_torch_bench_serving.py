"""The port's serving bench (``repro_torch.benchmarks.bench_serving``)
against the reference's (``benchmarks/bench_serving.py``) on the CPU.

Sections of both packages run on the same weights (``repro``'s init at
f32, carried across by ``bridge``) and the same tiny traces; the fields
that do not depend on time must be equal: requests completed, decode
steps and occupancy of the steady-state pass, admitted counts and
capacity ratios, prefill counts and savings, the prefill-token
reduction, preemptions and restores, and each package's own token-
identity flags.  Timings (tokens/s, TTFT, step ms) are the host's and
differ.

``validate_report`` is the reference's: it passes the reference's
committed report (``BENCH_serving.json``) and refuses each drift of it
with the reference's message.  The
port's CPU dry-run report passes every check but one: the speculative
section's floor (tokens/s with speculation at least plain decode's).  That floor is a claim about a compiled step: on
the card a round is one graph replay, as the reference's is one jitted
call, and the host work a token shrinks; on the CPU the port runs each
of the round's k + 1 forward passes eagerly, against k ticks of plain
decode, and the ratio is below 1.  The whole report is validated on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 4e (d)).
"""

import copy
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import bench_serving as JBS  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.benchmarks import bench_serving as TBS  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402

STEADY = ("completed", "decode_steps", "occupancy")


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
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32")
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return (jcfg, jp), (tcfg, tp)


def _both(weights, fn: str, **kw):
    (jcfg, jp), (tcfg, tp) = weights
    return getattr(JBS, fn)(jcfg, jp, **kw), getattr(TBS, fn)(tcfg, tp, **kw)


def test_paged_vs_dense_counts_match_reference(weights):
    """The short-prompt trace through the dense and the paged engine, a
    warm-up pass then the measured one: each layout's steady-state counts
    equal the reference's (the paged engine prefills one request a tick,
    the dense one every admission at once, so their occupancy differs in
    both packages)."""
    want, got = _both(weights, "bench_paged_vs_dense", max_len=64, n_req=6)
    for key in ("max_len", "block_size"):
        assert got[key] == want[key]
    for layout in ("dense", "paged"):
        for field in STEADY:
            assert got[layout][field] == want[layout][field], (layout, field)
    assert got["decode_speedup"] > 0


def test_int8_capacity_matches_reference(weights):
    want, got = _both(weights, "bench_int8_capacity")
    assert got == want
    assert got["admitted_int8"] > got["admitted_bf16"]


def test_prefix_sharing_matches_reference(weights):
    want, got = _both(weights, "bench_prefix_sharing", n_req=6)
    for key in ("n_requests", "prompt_len", "prefill_savings", "tokens_match", "num_kv_blocks",
                "admitted_off", "admitted_on", "capacity_ratio"):
        assert got[key] == want[key], key
    for label in ("off", "on"):
        for key in ("prefills", "prefix_hits", "cow_forks"):
            assert got[label][key] == want[label][key], (label, key)
    assert got["tokens_match"] is True


def test_partial_prefix_matches_reference(weights):
    want, got = _both(weights, "bench_partial_prefix", n_req=6)
    for key in ("prefill_token_reduction", "tokens_match", "prompt_len", "shared_prefix_len"):
        assert got[key] == want[key], key
    for label in ("off", "on"):
        for key in ("prefills", "prefix_partial_hits", "prefill_tokens", "prefill_tokens_saved"):
            assert got[label][key] == want[label][key], (label, key)
    assert got["prefill_token_reduction"] >= 3.0


def test_preemption_matches_reference(weights):
    want, got = _both(weights, "bench_preemption", n_each=2)
    assert got["tokens_match"] is want["tokens_match"] is True
    for label in ("off", "on"):
        for key in ("preemptions", "restores"):
            assert got[label][key] == want[label][key], (label, key)
        for cls in ("batch", "interactive"):
            assert got[label][cls]["n"] == want[label][cls]["n"], (label, cls)
    assert got["on"]["preemptions"] >= 1


@pytest.fixture(scope="module")
def dry_report(tmp_path_factory):
    """The port's ``--dry-run`` on the CPU, written by ``main``."""
    out = tmp_path_factory.mktemp("bench") / "BENCH_serving_torch.json"
    try:
        TBS.main(["--dry-run", "--device", "cpu", "--out", str(out)])
    except ValueError as err:
        # the speculative floor (see the module docstring); anything else fails
        assert "speculative_decode: tokens/s ratio" in str(err), err
    return json.loads(out.read_text())


def test_dry_run_report_passes_every_cpu_check(dry_report):
    """The report has every key of the reference's schema, and passes
    each of ``validate_report``'s checks but the speculative floor; the
    speculative streams are identical, and so are the sharded ones (a
    1 × 1 mesh over a one-rank group)."""
    assert set(dry_report) == set(JBS.REPORT_SCHEMA)
    assert dry_report["sharded_decode"]["mesh"] == {"data": 1, "model": 1}
    assert set(TBS.REPORT_SCHEMA) == set(dry_report)
    assert dry_report["dry_run"] is True
    for check in TBS.CHECKS:
        if check is not TBS._check_speculative:
            check(dry_report)
    spec = dry_report["speculative_decode"]
    assert set(spec) >= TBS._SPECULATIVE_KEYS and spec["tokens_match"] is True
    ratio = spec["tokens_per_s_ratio"]
    if ratio >= 1.0:
        TBS.validate_report(dry_report)


def _drifts():
    """(label, edit) pairs that each break one gate of the schema."""
    def drop(key):
        return lambda r: r.pop(key)

    def setp(path, value):
        def edit(r):
            d = r
            for k in path[:-1]:
                d = d[k]
            d[path[-1]] = value
        return edit

    return [
        ("missing engines", drop("engines")),
        ("wrong type", setp(("dry_run",), "yes")),
        ("int8 row keys", lambda r: r["paged_int8_vs_bf16"][0].pop("decode_speedup")),
        ("capacity keys", lambda r: r["int8_capacity_sweep"].pop("capacity_ratio")),
        ("prefix diverged", setp(("prefix_sharing", "tokens_match"), False)),
        ("partial diverged", setp(("partial_prefix", "tokens_match"), False)),
        ("partial floor", setp(("partial_prefix", "prefill_token_reduction"), 2.9)),
        ("sharded keys", lambda r: r["sharded_decode"].pop("capacity_ratio")),
        ("sharded diverged", setp(("sharded_decode", "tokens_match"), False)),
        ("preemption diverged", setp(("preemption", "tokens_match"), False)),
        ("no preemption", setp(("preemption", "on", "preemptions"), 0)),
        ("p99 not better", lambda r: r["preemption"]["on"]["interactive"].__setitem__(
            "ttft_p99_ms", r["preemption"]["off"]["interactive"]["ttft_p99_ms"])),
        ("spec diverged", setp(("speculative_decode", "tokens_match"), False)),
        ("spec floor", setp(("speculative_decode", "tokens_per_s_ratio"), 0.99)),
        ("energy counts", lambda r: r["energy_per_token"]["accounting"]["counts"].__setitem__(
            "crossbar_reads",
            r["energy_per_token"]["accounting"]["counts"].get("crossbar_reads", 0) + 1)),
        ("raca not cheaper", setp(("energy_per_token", "raca_energy_pj_per_token"), 1e30)),
        ("spec under-accounted", setp(("energy_per_token", "speculative", "overhead_ratio"),
                                      0.5)),
        ("zero-knob diverged", setp(("fault_tolerance", "zero_fault", "tokens_match"), False)),
        ("not all served", setp(("fault_tolerance", "faulted", "all_served"), False)),
        ("no canary failure", setp(("fault_tolerance", "faulted", "canary_failures"), 0)),
        ("not recovered", setp(("fault_tolerance", "faulted", "degraded_mode_final"), 2)),
        ("no re-reads", setp(("fault_tolerance", "faulted", "redundant_read_events"), 0)),
    ]


@pytest.fixture(scope="module")
def committed():
    """The reference's committed report, for each package's check."""
    full = json.loads((ROOT / "BENCH_serving.json").read_text())
    JBS.validate_report(full)
    TBS.validate_report(full)
    return full, full


@pytest.mark.parametrize("label,edit", _drifts(), ids=[d[0] for d in _drifts()])
def test_validate_report_refuses_a_drifted_report(committed, label, edit):
    """Each drift of the reference's committed report raises in both
    packages' ``validate_report`` with the same message (the schema's
    name for the file aside)."""
    full, port = committed
    jbad, tbad = copy.deepcopy(full), copy.deepcopy(port)
    edit(jbad)
    edit(tbad)
    with pytest.raises(ValueError) as want:
        JBS.validate_report(jbad)
    with pytest.raises(ValueError) as got:
        TBS.validate_report(tbad)
    assert str(got.value) == str(want.value).replace("BENCH_serving.json", "serving report")
