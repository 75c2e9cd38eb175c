"""The port's training path against the reference, on smoke stablelm-3b in
f32: data, loss and gradients, the AdamW step with stochastically
rounded bf16 moments, micro-batching, and loss going down.

The reference runs its analog modes with ``AnalogConfig(use_pallas="on")``
(the interpret-mode Pallas kernel, the TPU's semantics) and, for that,
``remat_policy="full"``: jax cannot rematerialise interpret mode's
callbacks.  Rematerialisation changes no number, and the port does not
rematerialise.

Tolerances, and why:

- ``lm_batch`` tokens: equal (the zipf draw's f32 ``exp`` matched on every
  token tried; an ulp there could move a token, which would show here);
- loss and gradients, digital and analog: atol 1e-5 (f32 products and
  sums in another order; the comparator's decisions agree, since the
  kernel's noise and quantized weights match to an ulp);
- AdamW's stochastic rounding: bit-identical on identical inputs (same
  threefry bits, integer rounding);
- two steps from one bridged state: the gradients agree to atol 1e-5 (as
  above), so a moment, an average of gradients, agrees to within one bf16
  ulp (2**-7 relative, stochastic rounding may cross a boundary the other
  side did not) plus 2e-6 absolute (two steps of (1 − b1)·1e-5), and at
  least 99% of the moments are bit-equal; the parameters, moved by
  lr·m̂/(√v̂ + eps), are all within lr·2**-5 (a few percent of one
  normalised update, where a moment's relative error is that large) and
  at least 99.9% of them within 1e-5.
"""

import dataclasses

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
from repro.models import transformer as JTF
from repro.optim import adamw as JADAM
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.bridge import params_from_numpy, train_state_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.data import lm_batch as t_lm_batch
from repro_torch.models import transformer as TTF
from repro_torch.optim import AdamWConfig as TAdamWConfig
from repro_torch.optim import adamw as TADAM
from repro_torch.optim import tree_leaves, warmup_cosine
from repro_torch.train import TrainConfig as TTrainConfig
from repro_torch.train import init_train_state as t_init_train_state
from repro_torch.train import make_train_step as t_make_train_step

ATOL = 1e-5
MOMENT_EQUAL = 0.99
MOMENT_ATOL = 2e-6
PARAM_CLOSE = 0.999
LR = 1e-2
MODES = ["digital", "analog_stochastic", "analog_linear"]


def _cfgs(mode: str = "digital"):
    jc = dataclasses.replace(j_smoke("stablelm-3b"), dtype="float32", remat_policy="full")
    tc = dataclasses.replace(t_smoke("stablelm-3b"), dtype="float32")
    if mode != "digital":
        jc = dataclasses.replace(jc, analog=JAnalog(
            mode=mode, device=j_calibrate(JDevice(), jc.d_model), use_pallas="on"))
        tc = dataclasses.replace(tc, analog=TAnalog(
            mode=mode, device=t_calibrate(TDevice(), tc.d_model)))
    return jc, tc


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _pair(key):
    a = np.asarray(jax.random.key_data(key), np.uint32)
    return int(a[0]), int(a[1])


@pytest.mark.parametrize("step", [0, 1, 17])
@pytest.mark.parametrize("seq", [16, 128])
def test_lm_batch_tokens_equal(step, seq):
    jc, tc = _cfgs()
    for cfg_j, cfg_t in ((jc, tc), (dataclasses.replace(jc, vocab=50304),
                                    dataclasses.replace(tc, vocab=50304))):
        a = j_lm_batch(cfg_j, batch=8, seq=seq, step=step, seed=5)
        b = t_lm_batch(cfg_t, batch=8, seq=seq, step=step, seed=5, device="cpu")
        for k in ("tokens", "labels"):
            assert b[k].dtype == torch.int32
            assert np.array_equal(b[k].numpy(), np.asarray(a[k])), k


@pytest.mark.parametrize("mode", MODES)
def test_lm_loss_and_gradients_match(mode):
    jc, tc = _cfgs(mode)
    params = JTF.init_lm(jax.random.PRNGKey(1), jc)
    batch = j_lm_batch(jc, batch=2, seq=16, step=0)
    key = jax.random.PRNGKey(3)
    (lj, _), gj = jax.value_and_grad(
        lambda p: JTF.lm_loss(p, batch, jc, key), has_aux=True)(params)
    tp = params_from_numpy(_np(params), tc, "cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    lt, metrics = TTF.lm_loss(tp, _tbatch(batch), tc, _pair(key))
    gt = torch.autograd.grad(lt, leaves)
    assert abs(float(lj) - float(lt.detach())) <= ATOL
    assert set(metrics) == {"nll", "lse_mean", "aux", "loss"}
    for a, b in zip(jax.tree.leaves(gj), gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


def test_analog_modes_differ_from_digital():
    """The key reaches the crossbar: analog losses differ from the digital
    one and from each other, and change with the key."""
    losses = {}
    for mode in MODES:
        _, tc = _cfgs(mode)
        p = TTF.init_lm(tc, seed=1, device="cpu")
        batch = t_lm_batch(tc, batch=2, seq=16, step=0, device="cpu")
        losses[mode] = float(TTF.lm_loss(p, batch, tc, (0, 3))[0])
        if mode != "digital":
            assert float(TTF.lm_loss(p, batch, tc, (0, 4))[0]) != losses[mode]
    assert len(set(losses.values())) == 3, losses


@pytest.mark.parametrize("n", [7, 3 * 517])
def test_sround_bit_identical(n):
    """AdamW's stochastic rounding to bf16: the same f32 inputs and key give
    the same bf16 bits, whole and in slices of the flat range."""
    x = (np.random.default_rng(n).standard_normal(n) * 1e-3).astype(np.float32)
    x[:3] = [0.0, -0.0, 1.0]
    key = jax.random.fold_in(jax.random.PRNGKey(9), 4)
    want = np.asarray(JADAM._sround(jnp.asarray(x), jnp.bfloat16, key).astype(jnp.float32))
    xt = torch.from_numpy(x)
    got = TADAM._sround(xt, torch.bfloat16, _pair(key))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))
    cut = n // 2
    parts = torch.cat([TADAM._sround(xt[:cut], torch.bfloat16, _pair(key), 0),
                       TADAM._sround(xt[cut:], torch.bfloat16, _pair(key), cut)])
    assert torch.equal(parts.view(torch.int16), got.view(torch.int16))


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 10_000, 20_000])
def test_warmup_cosine_matches(step):
    want = float(j_warmup_cosine(step, warmup=100, total=10_000))
    assert warmup_cosine(step, warmup=100, total=10_000) == pytest.approx(want, abs=1e-7)


def _bridged(jstate, tc, tcfg):
    st = jax.tree.map(np.asarray, jstate)
    return train_state_from_numpy(
        _np(st.params), _np(st.opt.m), _np(st.opt.v), int(st.opt.step), int(st.step),
        jax.random.key_data(jstate.rng), tc, tcfg, device="cpu",
    )


def _assert_states_close(js, ts):
    d = np.concatenate([
        np.abs(b.detach().numpy() - np.asarray(a)).reshape(-1)
        for a, b in zip(jax.tree.leaves(js.params), tree_leaves(ts.params))
    ])
    assert d.max() <= LR * 2.0**-5 and float((d <= ATOL).mean()) >= PARAM_CLOSE
    for jm, tm in ((js.opt.m, ts.opt.m), (js.opt.v, ts.opt.v)):
        a32 = np.concatenate([np.asarray(a.astype(jnp.float32)).reshape(-1) for a in jax.tree.leaves(jm)])
        b32 = torch.cat([b.float().reshape(-1) for b in tree_leaves(tm)]).numpy()
        assert all(b.dtype == torch.bfloat16 for b in tree_leaves(tm))
        assert (np.abs(b32 - a32) <= np.abs(a32) * 2.0**-7 + MOMENT_ATOL).all()
        assert float((a32 == b32).mean()) >= MOMENT_EQUAL
    assert ts.step == int(js.step) and ts.opt.step == int(js.opt.step)


@pytest.mark.parametrize("mode", ["digital", "analog_stochastic"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match(mode, microbatches):
    """Two steps from one bridged state: bf16 moments with stochastic
    rounding, warmup schedule, clipping, weight decay, the step keys."""
    jc, tc = _cfgs(mode)
    opt = dict(lr=LR)
    jt = JTrainConfig(opt=JADAM.AdamWConfig(**opt), microbatches=microbatches,
                      warmup_steps=2, total_steps=10)
    tt = TTrainConfig(opt=TAdamWConfig(**opt), microbatches=microbatches,
                      warmup_steps=2, total_steps=10)
    js = j_init_train_state(jax.random.PRNGKey(0), jc, jt)
    js = js._replace(step=jnp.asarray(1, jnp.int32))   # past step 0's zero learning rate
    ts = _bridged(js, tc, tt)
    assert ts.rng == _pair(js.rng)
    jstep = jax.jit(j_make_train_step(jc, jt))
    tstep = t_make_train_step(tc, tt)
    for i in range(2):
        batch = j_lm_batch(jc, batch=4, seq=16, step=i)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, _tbatch(batch))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= ATOL
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    _assert_states_close(js, ts)


def test_init_train_state_and_compress_refused():
    _, tc = _cfgs("analog_stochastic")
    state = t_init_train_state(0, tc, TTrainConfig(), device="cpu")
    assert state.rng == _pair(jax.random.fold_in(jax.random.PRNGKey(0), 1))
    assert state.step == 0 and state.opt.step == 0
    assert all(p.requires_grad for p in tree_leaves(state.params))
    assert all(m.dtype == torch.bfloat16 and not m.any() for m in tree_leaves(state.opt.m))
    with pytest.raises(NotImplementedError):
        t_make_train_step(tc, TTrainConfig(compress_grads=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        t_init_train_state(0, tc, TTrainConfig())


@pytest.mark.parametrize("mode", ["digital", "analog_stochastic"])
def test_loss_decreases(mode):
    """As the reference's ``test_loss_decreases_lm``: 20 steps at lr 1e-2
    with f32 moments; the last five losses average 0.1 below the first
    five."""
    _, tc = _cfgs(mode)
    tcfg = TTrainConfig(opt=TAdamWConfig(lr=1e-2, state_dtype="float32",
                                         stochastic_rounding=False))
    state = t_init_train_state(0, tc, tcfg, device="cpu")
    step = t_make_train_step(tc, tcfg)
    losses = []
    for i in range(20):
        state, m = step(state, t_lm_batch(tc, batch=8, seq=16, step=i, device="cpu"))
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_launcher_runs_on_cpu_and_refuses_unported_flags(capsys):
    from repro_torch.launch import train as LT

    LT.main(["--arch", "stablelm-3b", "--smoke", "--analog", "--device", "cpu",
             "--steps", "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "done: steps=3 first_loss=" in out and "last_loss=" in out
    for flags in (["--compress"], ["--model-par", "2"], ["--ckpt-dir", "x"]):
        with pytest.raises(SystemExit):
            LT.main(["--arch", "stablelm-3b", "--smoke", "--device", "cpu", *flags])
