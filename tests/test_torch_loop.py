"""The fault-tolerant training loop, the port against the reference, on
smoke stablelm-3b in f32 (bf16 moments with stochastic rounding, lr 1e-2):

- the port's loop from a state carried from ``repro`` against ``repro``'s
  loop from that state: per-step losses, counters, checkpoint names;
- a run that ``repro`` checkpoints at step 8 and the port resumes to 12,
  against ``repro``'s uninterrupted 12 steps;
- fault recovery within the port: bit-identical to the clean run, digital
  and analog (a resumed run redraws the crossbar noise from (rng, step));
- ``FAULT_INJECT_STEP`` from the environment, ``max_restarts`` exceeded,
  and ``StragglerMonitor``, each as the reference behaves.

Tolerances are ``test_torch_train.py``'s: losses within 1e-5 (f32 sums in
another order); after four steps apart, parameters within lr·2**-5 and
99.9% of them within 1e-5, moments within one bf16 ulp + 2e-6 and 99%
bit-equal.  Eight steps apart, only the losses are held: a moment rounded
the other way stays in that element's later updates (b1 and b2 decay it
slowly), so the per-element state bounds are those of a few steps.
Within the port a restart is exact: the same inputs through the same
operations.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config as j_smoke
from repro.core.analog import AnalogConfig as JAnalog
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.data import lm_batch as j_lm_batch
from repro.optim import AdamWConfig as JAdamWConfig
from repro.testing import InjectedFault as JInjectedFault
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import loop as JL
from repro_torch.bridge import train_state_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.data import lm_batch as t_lm_batch
from repro_torch.optim import AdamWConfig as TAdamWConfig
from repro_torch.optim import tree_leaves
from repro_torch.testing import InjectedFault
from repro_torch.train import TrainConfig as TTrainConfig
from repro_torch.train import loop as TL

LR = 1e-2
ATOL = 1e-5
PARAM_CLOSE = 0.999
MOMENT_EQUAL = 0.99
MOMENT_ATOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small PyTorch ops, which
    only wait on each other's threads when the run's workers share the
    cores (the tier-1 run puts six on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(mode="digital"):
    jc = dataclasses.replace(j_smoke("stablelm-3b"), dtype="float32", remat_policy="full")
    tc = dataclasses.replace(t_smoke("stablelm-3b"), dtype="float32")
    if mode != "digital":
        jc = dataclasses.replace(jc, analog=JAnalog(
            mode=mode, device=j_calibrate(JDevice(), jc.d_model), use_pallas="on"))
        tc = dataclasses.replace(tc, analog=TAnalog(
            mode=mode, device=t_calibrate(TDevice(), tc.d_model)))
    jt = JTrainConfig(opt=JAdamWConfig(lr=LR), warmup_steps=2, total_steps=12)
    tt = TTrainConfig(opt=TAdamWConfig(lr=LR), warmup_steps=2, total_steps=12)
    return jc, tc, jt, tt


def _jbatch(jc):
    return lambda s: j_lm_batch(jc, batch=4, seq=16, step=s)


def _tbatch(tc):
    return lambda s: t_lm_batch(tc, batch=4, seq=16, step=s, device="cpu")


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _assert_states_close(js, ts):
    d = np.concatenate([
        np.abs(b.detach().numpy() - np.asarray(a)).reshape(-1)
        for a, b in zip(jax.tree.leaves(js.params), tree_leaves(ts.params), strict=True)
    ])
    assert d.max() <= LR * 2.0**-5 and float((d <= ATOL).mean()) >= PARAM_CLOSE
    for jm, tm in ((js.opt.m, ts.opt.m), (js.opt.v, ts.opt.v)):
        a32 = np.concatenate([np.asarray(a.astype(jnp.float32)).reshape(-1) for a in jax.tree.leaves(jm)])
        b32 = torch.cat([b.float().reshape(-1) for b in tree_leaves(tm)]).numpy()
        assert (np.abs(b32 - a32) <= np.abs(a32) * 2.0**-7 + MOMENT_ATOL).all()
        assert float((a32 == b32).mean()) >= MOMENT_EQUAL
    assert ts.step == int(js.step) and ts.opt.step == int(js.opt.step)


def _assert_losses_close(jl, tl):
    assert [s for s, _ in jl] == [s for s, _ in tl]
    assert max(abs(a - b) for (_, a), (_, b) in zip(jl, tl)) <= ATOL


def test_loop_from_carried_state_matches_repro(tmp_path):
    """Both loops from one state (the reference's init, carried across), 8
    steps with a checkpoint every 4: every loss, the counters, and the two
    checkpoint directories hold the same steps and leaf names."""
    jc, tc, jt, tt = _cfgs()
    js0 = j_init_train_state(jax.random.PRNGKey(0), jc, jt)
    st = jax.tree.map(np.asarray, js0)
    ts0 = train_state_from_numpy(
        _np(st.params), _np(st.opt.m), _np(st.opt.v), int(st.opt.step), int(st.step),
        jax.random.key_data(js0.rng), tc, tt, device="cpu")
    kw = dict(steps=8, ckpt_every=4, log_every=100)
    js, jstats = JL.run(jc, jt, JL.LoopConfig(ckpt_dir=str(tmp_path / "j"), **kw),
                        _jbatch(jc), state=js0)
    ts, tstats = TL.run(tc, tt, TL.LoopConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                        _tbatch(tc), state=ts0, device="cpu")
    _assert_losses_close(jstats["losses"], tstats["losses"])
    assert (ts.step, ts.opt.step) == (int(js.step), int(js.opt.step)) == (8, 8)
    assert tstats["restarts"] == jstats["restarts"] == 0
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) \
        == ["step_00000004", "step_00000008"]
    for step in ("step_00000004", "step_00000008"):
        man = [json.load(open(tmp_path / p / step / "manifest.json")) for p in ("j", "t")]
        assert man[0]["leaves"] == man[1]["leaves"] and man[0]["step"] == man[1]["step"]
    assert len(tstats["step_s"]) == 8 and tstats["restart_s"] == []
    assert [s["step"] for s in tstats["saves"]] == [4, 8, 8]
    assert all(s["bytes"] > 0 and s["write_s"] > 0 for s in tstats["saves"])


def test_port_resumes_a_repro_run(tmp_path):
    """``repro`` trains 8 steps and checkpoints; the port's loop finds that
    checkpoint, loads it into its own state and trains on to 12.  Against
    ``repro``'s uninterrupted 12 steps: the last four losses and the final
    state."""
    jc, tc, jt, tt = _cfgs()
    kw = dict(ckpt_every=4, log_every=100)
    JL.run(jc, jt, JL.LoopConfig(steps=8, ckpt_dir=str(tmp_path / "run"), **kw), _jbatch(jc))
    js, jstats = JL.run(jc, jt, JL.LoopConfig(steps=12, ckpt_dir=str(tmp_path / "full"), **kw),
                        _jbatch(jc))
    ts, tstats = TL.run(tc, tt, TL.LoopConfig(steps=12, ckpt_dir=str(tmp_path / "run"), **kw),
                        _tbatch(tc), device="cpu")
    assert [s for s, _ in tstats["losses"]] == [8, 9, 10, 11]
    _assert_losses_close(jstats["losses"][8:], tstats["losses"])
    _assert_states_close(js, ts)
    assert ts.rng == tuple(int(w) for w in np.asarray(jax.random.key_data(js.rng)))


@pytest.mark.parametrize("mode", ["digital", "analog_stochastic"])
def test_fault_recovery_bit_identical(tmp_path, mode):
    """The reference's ``test_fault_injection_recovers_to_identical_state``
    on the port, held exactly: a fault before step 9, a restart from the
    step-8 checkpoint, and the same final parameters, moments, counters and
    key as the clean run."""
    _, tc, _, tt = _cfgs(mode)
    kw = dict(steps=12, ckpt_every=4, log_every=100)
    clean, _ = TL.run(tc, tt, TL.LoopConfig(ckpt_dir=str(tmp_path / "clean"), **kw),
                      _tbatch(tc), device="cpu")
    faulty, stats = TL.run(tc, tt, TL.LoopConfig(ckpt_dir=str(tmp_path / "faulty"),
                                                 fault_inject_step=9, **kw),
                           _tbatch(tc), device="cpu")
    assert stats["restarts"] == 1 and faulty.step == 12
    assert [s for s, _ in stats["losses"]] == list(range(9)) + [8, 9, 10, 11]
    assert len(stats["restart_s"]) == 1 and stats["restart_s"][0]["step"] == 8
    for tree_c, tree_f in ((clean.params, faulty.params), (clean.opt.m, faulty.opt.m),
                           (clean.opt.v, faulty.opt.v)):
        for a, b in zip(tree_leaves(tree_c), tree_leaves(tree_f), strict=True):
            assert torch.equal(a.detach(), b.detach())
    assert (clean.step, clean.opt.step, clean.rng) == (faulty.step, faulty.opt.step, faulty.rng)


def test_fault_step_from_env(tmp_path, monkeypatch):
    """``FAULT_INJECT_STEP`` arms the fault when the config does not: both
    loops restart once and record the same steps."""
    jc, tc, jt, tt = _cfgs()
    monkeypatch.setenv("FAULT_INJECT_STEP", "2")
    kw = dict(steps=4, ckpt_every=1, log_every=100)
    _, jstats = JL.run(jc, jt, JL.LoopConfig(ckpt_dir=str(tmp_path / "j"), **kw), _jbatch(jc))
    _, tstats = TL.run(tc, tt, TL.LoopConfig(ckpt_dir=str(tmp_path / "t"), **kw),
                       _tbatch(tc), device="cpu")
    assert tstats["restarts"] == jstats["restarts"] == 1
    assert [s for s, _ in tstats["losses"]] == [s for s, _ in jstats["losses"]] == [0, 1, 2, 3]


def test_max_restarts_exceeded_reraises(tmp_path):
    """A step that faults every time: ``max_restarts`` retries, then the
    fault propagates, after the same number of attempts as the reference."""
    jc, tc, jt, tt = _cfgs()
    calls = {"j": 0, "t": 0}

    def failing(tag, exc):
        def step(state, batch):
            calls[tag] += 1
            raise exc("injected in every step")
        return step

    kw = dict(steps=3, ckpt_every=1, log_every=100, max_restarts=2)
    with pytest.raises(JInjectedFault):
        JL.run(jc, jt, JL.LoopConfig(ckpt_dir=str(tmp_path / "j"), **kw), _jbatch(jc),
               step_fn=failing("j", JInjectedFault))
    with pytest.raises(InjectedFault):
        TL.run(tc, tt, TL.LoopConfig(ckpt_dir=str(tmp_path / "t"), **kw), _tbatch(tc),
               step_fn=failing("t", InjectedFault), device="cpu")
    assert calls["t"] == calls["j"] == 3


def test_straggler_monitor_parity():
    """The same step times through both monitors: the same flags, EMA and
    count (the reference's test: ten steady steps, then one 5x slower)."""
    times = [0.1] * 10 + [0.5, 0.1, 0.25, 0.3, 0.12, 0.9]
    jm, tm = JL.StragglerMonitor(factor=2.0), TL.StragglerMonitor(factor=2.0)
    for dt in times:
        assert tm.observe(dt) == jm.observe(dt)
        assert tm.ema == jm.ema
    assert tm.flagged == jm.flagged >= 2
    assert TL._InjectedFault is InjectedFault
