"""The port's public API (``repro_torch.core``) and its examples, against
the reference's on the CPU.

- ``repro_torch.core.__all__`` is ``repro.core.__all__``, each name the
  port's own object.
- ``examples/quickstart_torch.py`` against ``examples/quickstart.py``: V_r
  and β to f32 bits, hidden activations binary, the mean fire rate within
  0.03 (two independent 8192-draw means of a rate near 0.5: 4σ), the
  printed "max err" within 0.05 of the reference's (both against the
  reference's own ideal, whose weights skip the layer's dynamic-range
  scale: ≈0.28 either way, sampling moves it by a few 1e-2), and against
  the ideal of the range-quantized layer the crossbar computes: mean error
  ≤ 0.1 and max error ≤ 5σ of a 256-sample mean (0.156); the WTA
  prediction agreement of both.
- ``examples/serve_stochastic_torch.py``'s streams against ``repro``'s
  engine on carried parameters at f32 (bf16 greedy identity is fragile,
  ROADMAP C): greedy and WTA, plain and speculative; token for token.
- ``train_lm_torch``, ``train_mnist_raca_torch``: run with ``--device cpu``
  through the loop and its checkpoints (the LM at a cut width: its 104 M
  parameters take ~50 s a step in plain PyTorch on a CPU).
"""

import dataclasses
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import repro.core as JCORE
import repro_torch.core as TCORE
from repro.configs import get_smoke_config as j_smoke
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.models import get_model_fns as j_model_fns
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import latest_step
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
FIRE_RATE_ATOL = 0.03
REF_MAX_ERR_ATOL = 0.05
RANGE_MEAN_ERR, RANGE_MAX_ERR = 0.1, 5 * (0.25 / 256) ** 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small PyTorch ops, which
    only wait on each other's threads when the run's workers share the
    cores (the tier-1 run puts six on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_core_all_equals_reference():
    assert TCORE.__all__ == JCORE.__all__
    for name in TCORE.__all__:
        obj = getattr(TCORE, name)
        assert getattr(obj, "__module__", getattr(obj, "__name__", "")).startswith("repro_torch"), name


def _run_example(path: Path, argv, monkeypatch, capsys, run_name="__main__") -> str:
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    runpy.run_path(str(path), run_name=run_name)
    return capsys.readouterr().out


def _after(text: str, label: str) -> str:
    return next(line for line in text.splitlines() if line.startswith(label))[len(label):].strip()


def test_quickstart_against_reference(monkeypatch, capsys):
    ref = _run_example(EXAMPLES / "quickstart.py", [], monkeypatch, capsys)
    out = _run_example(EXAMPLES / "quickstart_torch.py", ["--device", "cpu"], monkeypatch, capsys)
    for label in ("calibrated read voltage V_r =", "effective logistic slope beta =",
                  "hidden activations are binary:"):
        assert _after(out, label) == _after(ref, label), label
    assert _after(out, "hidden activations are binary:") == "[0.0, 1.0]"
    jd, td = j_calibrate(JDevice(), 784), t_calibrate(TDevice(), 784)
    assert np.float32(td.v_read).view(np.uint32) == np.float32(jd.v_read).view(np.uint32)
    assert abs(float(_after(out, "mean fire rate:")) - float(_after(ref, "mean fire rate:"))) \
        <= FIRE_RATE_ATOL
    label = "E[comparator] vs sigmoid, max err:"
    assert abs(float(_after(out, label)) - float(_after(ref, label))) <= REF_MAX_ERR_ATOL
    m = re.search(r"range-quantized layer: max err ([0-9.]+), mean err ([0-9.]+)", out)
    assert float(m.group(2)) <= RANGE_MEAN_ERR and float(m.group(1)) <= RANGE_MAX_ERR
    assert _after(out, "prediction agreement:") == _after(ref, "prediction agreement:") == "True"


@pytest.mark.parametrize("speculate_k", [0, 3])
def test_serve_stochastic_streams_match_reference(speculate_k):
    ex = runpy.run_path(str(EXAMPLES / "serve_stochastic_torch.py"), run_name="example")
    tcfg = dataclasses.replace(ex["model_config"](), dtype="float32")
    jcfg = dataclasses.replace(
        j_smoke("stablelm-3b"), n_layers=4, d_model=128, d_ff=256, n_heads=4, n_kv_heads=4,
        d_head=32, max_seq=256, dtype="float32")
    jparams = j_model_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(lambda x: np.array(x, np.float32), jparams),
                                tcfg, "cpu")
    runs = ex["serve"](tparams, tcfg, speculate_k=speculate_k, device="cpu")
    assert [wta for _, wta, *_ in runs] == [False, True]
    for _mode, wta, rids, outs, m in runs:
        eng = JServingEngine(jparams, dataclasses.replace(jcfg, wta_head=wta), JServeConfig(
            max_batch=3, max_new_tokens=16, max_len=128, kv_block_size=8,
            enable_prefix_sharing=True, speculate_k=speculate_k))
        jrids = [eng.submit(p, n, priority=1, deadline_ms=None) for p, n in ex["REQUESTS"]]
        want = eng.run()
        assert [outs[r] for r in rids] == [want[r] for r in jrids]
        assert m.completed == 4 and m.prefix_hits == eng.metrics().prefix_hits == 1
        assert m.total_tokens == sum(n for _, n in ex["REQUESTS"])


def test_train_lm_example_on_cpu(tmp_path, monkeypatch, capsys):
    """``train_lm_torch`` through the loop at a cut width (2 x 64, vocab
    256), then again from its checkpoint; the full config's size."""
    ex = runpy.run_path(str(EXAMPLES / "train_lm_torch.py"), run_name="example")
    full = ex["small_lm"](False)
    assert (full.n_layers, full.d_model, full.vocab, full.dtype) == (8, 640, 50304, "float32")
    assert 100e6 < full.param_count() < 110e6
    assert ex["small_lm"](True).analog.mode == "analog_stochastic"
    main = ex["main"]
    small = ex["small_lm"]
    main.__globals__["small_lm"] = lambda analog: dataclasses.replace(
        small(analog), n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
        vocab=256)
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    state, stats = main([*argv, "--steps", "3", "--analog"])
    assert state.step == 3 and latest_step(str(tmp_path)) == 3
    state, stats = main([*argv, "--steps", "4", "--analog"])
    assert state.step == 4 and [s for s, _ in stats["losses"]] == [3]
    assert "loss: first10=" in capsys.readouterr().out


def test_train_mnist_raca_example_on_cpu(tmp_path, capsys):
    """The FCNN example through the loop, its Fig. 6 protocol on 256 of
    its 1024 test images."""
    ex = runpy.run_path(str(EXAMPLES / "train_mnist_raca_torch.py"), run_name="example")
    main = ex["main"]
    full = main.__globals__["mnist_dataset"]
    main.__globals__["mnist_dataset"] = lambda n, device=None: full(256, device=device)
    state, stats = main(["--device", "cpu", "--small", "--steps", "5", "--batch", "32",
                         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert state.step == 5 and stats["restarts"] == 0 and latest_step(str(tmp_path)) == 5
    assert "restarts=0" in out and out.count("RACA stochastic inference") == 4
