"""Fig. 6's bench on the port (``repro_torch.benchmarks.bench_fcnn_accuracy``)
against the reference's (``benchmarks/bench_fcnn_accuracy.py``) on the CPU,
at a cut protocol: both modules' ``LAYERS`` and ``TRAIN_STEPS`` patched to
(784, 64, 32, 10) and 150 steps (the reference alone takes 54 s at its
own).  The same rows under the same names; digital accuracy within 2/512
(f32 training in another summation order can move an image at the
boundary), RACA accuracies within 0.03 (15 of 512 images: the hidden
neurons' sigmoid and the WTA normals round an ulp apart on a fraction of
a percent of draws, and a moved decision can move an image); 64 votes at
or above 1 vote, as the paper's curve.
"""

import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import bench_fcnn_accuracy as J6  # noqa: E402
from repro_torch.benchmarks import bench_fcnn_accuracy as T6  # noqa: E402

CUT_LAYERS, CUT_STEPS = (784, 64, 32, 10), 150
FIG6_DIGITAL_ATOL, FIG6_RACA_ATOL = 2 / 512, 0.03


def _num(derived: str, key: str) -> float:
    return float(re.search(rf"{key}=([-+0-9.e]+)", derived).group(1))


def test_fig6_cut_protocol(monkeypatch):
    for mod in (J6, T6):
        monkeypatch.setattr(mod, "LAYERS", CUT_LAYERS)
        monkeypatch.setattr(mod, "TRAIN_STEPS", CUT_STEPS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # many small ops: see test_torch_benchmarks.py
    try:
        ref, port = J6.run(), T6.run("cpu")
    finally:
        torch.set_num_threads(threads)
    assert [r[0] for r in port] == [r[0] for r in ref]
    (_, _, a), (_, us, b) = ref[0], port[0]
    assert us > 0
    assert abs(_num(a, "digital_acc") - _num(b, "digital_acc")) <= FIG6_DIGITAL_ATOL
    for (name, _, a), (_, _, b) in zip(ref[1:], port[1:]):
        assert abs(_num(a, "acc") - _num(b, "acc")) <= FIG6_RACA_ATOL, name
    acc = {name: _num(d, "acc") for name, _, d in port[1:]}
    assert acc["fig6_raca_votes64"] >= acc["fig6_raca_votes1"]
