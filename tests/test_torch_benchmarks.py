"""The paper's benches on the port (``repro_torch.benchmarks``) against the
reference's (``benchmarks/``) on the CPU: the same rows under the same
names, and the same numbers within stated bounds.

- Table I: the derived strings equal (the same cost model, host floats).
- Fig. 4: each rmse within 1e-4, one unit of the printed precision (the
  inputs are threefry draws, bit-equal but where torch's and XLA's f32
  ``log1p`` round a normal an ulp apart, which moves an rmse by ~1e-6;
  a value at a rounding boundary can still print one digit apart).
- Fig. 5: the same one-winner flag and argmax agreement, decision rates
  within 0.02 and TV distances within 0.01 (a trial moves only where an
  ulp of a normal decides a race between two comparators).
- ``bench_kernels``: the reference's rows and names, timed on the plain
  versions here (one call after the warm-up, as the timing is not what is
  held); the derived column carries the H100 bound and no ``tpu_`` field.

Fig. 6 is held in ``test_torch_benchmarks_fig6.py`` (the reference's
Fig. 6 alone takes most of a minute on a CPU, even cut).  The serving
bench runs its dry-run protocol here for its row names (the reference's);
its numbers are held against the reference's in
``test_torch_bench_serving.py``.
"""

import io
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import bench_cost_model as J4  # noqa: E402
from benchmarks import bench_kernels as JK  # noqa: E402
from benchmarks import bench_sigmoid as JS  # noqa: E402
from benchmarks import bench_wta as JW  # noqa: E402
from repro_torch.benchmarks import bench_fcnn_accuracy as T6  # noqa: E402
from repro_torch.benchmarks import bench_kernels as TK  # noqa: E402
from repro_torch.benchmarks import run as TR  # noqa: E402

CUT_LAYERS, CUT_STEPS = (784, 64, 32, 10), 150
FIG4_ATOL = 1e-4
FIG5_TV_ATOL, FIG5_RATE_ATOL = 0.01, 0.02
TAGS = {"fig4": JS, "fig5": JW, "table1": J4, "kernels": JK}
FIG6_NAMES = ["fcnn_train"] + [f"fig6_raca_votes{v}" for v in (1, 4, 16, 64)] + [
    "fig6b_vth0_zero_votes16", "fig6b_vth0_cal_votes16", "fig6a_detuned_beta2_votes16"]
# benchmarks/bench_serving.py's dry-run rows, in order
SERVING_NAMES = ["serve_cb_greedy", "serve_cb_wta_T8", "serve_static_greedy",
                 "serve_occupancy_gain", "serve_paged_vs_dense_L128",
                 "serve_paged_vs_dense_L512", "serve_paged_int8_L128", "serve_paged_int8_L512",
                 "serve_int8_capacity", "serve_prefix_sharing", "serve_partial_prefix",
                 "serve_preemption", "serve_speculative_decode", "serve_energy_per_token",
                 "serve_fault_tolerance", "serve_sharded_decode"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small PyTorch ops, which
    only wait on each other's threads when the run's workers share the
    cores (the tier-1 run puts six on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _num(derived: str, key: str) -> float:
    return float(re.search(rf"{key}=([-+0-9.e]+)", derived).group(1))


@pytest.fixture(scope="module")
def rows(request):
    """The reference's benches but Fig. 6 and serving once, and the port's
    harness (``run_all``, Fig. 6 at the cut protocol, serving's dry run),
    whose printout is kept."""
    mp = pytest.MonkeyPatch()
    mp.setattr(T6, "LAYERS", CUT_LAYERS)
    mp.setattr(T6, "TRAIN_STEPS", CUT_STEPS)
    mp.setattr(TK, "N_CALLS", 1)
    ref = {tag: mod.run() for tag, mod in TAGS.items()}
    out = io.StringIO()
    port, failed = TR.run_all("cpu", out=out, dry_run=True)
    mp.undo()
    assert not failed
    return ref, port, out.getvalue()


def test_same_rows_and_names(rows):
    """The harness prints every row the reference's prints for these six
    benches, under the same ``tag/name``, as ``name,us_per_call,derived``
    (Fig. 6's names are the reference's, held against its rows in
    ``test_torch_benchmarks_fig6.py``; serving's are the reference's dry
    run's)."""
    ref, port, text = rows
    ref = {**ref, "fig6": [(n, 0.0, "") for n in FIG6_NAMES],
           "serving": [(n, 0.0, "") for n in SERVING_NAMES]}
    assert [tag for tag, _ in TR.BENCHES] == ["fig4", "fig5", "fig6", "table1", "kernels",
                                              "serving"]
    for tag, _ in TR.BENCHES:
        assert [r[0] for r in port[tag]] == [r[0] for r in ref[tag]], tag
    lines = text.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    want = [f"{tag}/{name}" for tag, _ in TR.BENCHES for name, _, _ in ref[tag]]
    assert [line.split(",")[0] for line in lines[1:]] == want


def test_table1_equal(rows):
    ref, port, _ = rows
    assert port["table1"] == ref["table1"]


def test_fig4_rmse(rows):
    ref, port, _ = rows
    for (name, _, a), (_, us, b) in zip(ref["fig4"], port["fig4"]):
        assert abs(_num(a, "rmse") - _num(b, "rmse")) <= FIG4_ATOL, name
    assert port["fig4"][0][1] > 0
    cal = _num(port["fig4"][0][2], "rmse")
    assert cal < 0.02 and cal < _num(port["fig4"][-1][2], "rmse")


def test_fig5_votes(rows):
    ref, port, _ = rows
    (_, _, a), (_, _, b) = ref["fig5"][0], port["fig5"][0]
    assert "one_winner_per_trial=True" in a and "one_winner_per_trial=True" in b
    assert abs(_num(a, "decision_rate") - _num(b, "decision_rate")) <= FIG5_RATE_ATOL
    for (name, _, a), (_, _, b) in zip(ref["fig5"][1:], port["fig5"][1:]):
        assert abs(_num(a, "tv") - _num(b, "tv")) <= FIG5_TV_ATOL, name
        assert ("argmax_agree=True" in a) == ("argmax_agree=True" in b), name


def test_kernel_rows_carry_h100_bounds(rows):
    ref, port, _ = rows
    for (name, _, a), (_, us, b) in zip(ref["kernels"], port["kernels"]):
        assert us > 0 and "tpu_" not in b and _num(b, "h100_bound_us") > 0, name
        for key in ("flops", "bytes"):
            if f"{key}=" in a:
                assert _num(a, key) == _num(b, key), name


def test_harness_exits_1_when_a_bench_raises(monkeypatch, capsys):
    def broken(device=None):
        raise RuntimeError("bench failed")

    monkeypatch.setattr(TR, "BENCHES", (("table1", TR.bench_cost_model), ("fig4", type(
        "M", (), {"run": staticmethod(broken)}))))
    with pytest.raises(SystemExit) as e:
        TR.main(["--device", "cpu"])
    assert e.value.code == 1
    assert "table1/table1_changes" in capsys.readouterr().out
