"""The paper's FCNN path of the port against the reference: the MNIST
surrogate, init, logits, loss and gradients, hard hidden activations,
RACA prediction, the training step, the registry, the bridge and the
launcher; and a reduced run of Fig. 6's relations in the port alone.

Both packages run on the reference's parameters (through the bridge) and
the reference's images.  Tolerances, and why:

- labels: equal (``randint`` is threefry and integer arithmetic);
- images: within ``IMG_ATOL`` (one f32 ulp of 1.0 was the largest gap
  seen) on at least ``IMG_CLOSE`` of the pixels, since an ulp in the f32
  affine map could move a rounded glyph coordinate; ≥ 98% bit-equal
  (``normal``'s ``log1p``, ``tests/torch_cpu_rounding.py``);
- init: ≥ 99% bit-equal, all within rtol 1e-6 (``normal`` again);
- logits, loss and gradients, digital and expectation (training) modes:
  atol 1e-5 (f32 products summed in another order);
- hard hidden activations: the uniforms are jax's bit for bit and the
  port's p lay within 5 ulps of 1.0 of the reference's at (1024, 128) and
  (1024, 64) (torch's ``sigmoid``, products summed in another order), so a
  decision can differ only where ``u`` sits within ``P_ULPS`` ulps of
  ``p``; at least ``HARD_AGREE`` equal (all 786k were, over four keys);
- RACA predictions at 1 and 8 votes: at least ``PRED_AGREE`` equal (all
  1024 were; one flipped hidden unit can move a vote);
- the training step: loss within 1e-5 and parameters within 1e-5 after
  ``TRAIN_STEPS`` steps (f32 moments, no stochastic rounding).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.fcnn_mnist import CONFIG as J_CFG
from repro.core import analog as JA
from repro.data import mnist_batch as j_mnist_batch
from repro.data import mnist_dataset as j_mnist_dataset
from repro.models import fcnn as JF
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import random as R
from repro_torch.bridge import params_from_numpy, train_state_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.fcnn_mnist import CONFIG as T_CFG
from repro_torch.core import analog as TA
from repro_torch.data import mnist_batch as t_mnist_batch
from repro_torch.data import mnist_dataset as t_mnist_dataset
from repro_torch.launch import train as launch_train
from repro_torch.models import ModelConfig, get_model_fns
from repro_torch.models import fcnn as TF
from repro_torch.optim import AdamWConfig as TAdamWConfig
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainConfig as TTrainConfig
from repro_torch.train import make_train_step as t_make_train_step

ATOL = 1e-5
IMG_ATOL = 1e-6
IMG_CLOSE = 0.999
IMG_EQUAL = 0.98
HARD_AGREE = 0.9999
PRED_AGREE = 0.99
P_ULPS = 8
TRAIN_STEPS = 3
SMALL = (784, 128, 64, 10)


def _pair(key) -> tuple[int, int]:
    a = np.asarray(jax.random.key_data(key), np.uint32)
    return int(a[0]), int(a[1])


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _cfgs(layers=SMALL, **analog):
    jc = dataclasses.replace(J_CFG, fcnn_layers=layers,
                             analog=dataclasses.replace(J_CFG.analog, **analog))
    tc = dataclasses.replace(T_CFG, fcnn_layers=layers,
                             analog=dataclasses.replace(T_CFG.analog, **analog))
    return jc, tc


def _setup(layers=SMALL, batch=64, seed=1, **analog):
    jc, tc = _cfgs(layers, **analog)
    params = JF.init_fcnn(jax.random.PRNGKey(seed), jc)
    b = j_mnist_batch(batch=batch, step=3)
    tb = {"image": torch.from_numpy(np.array(b["image"])),
          "label": torch.from_numpy(np.array(b["label"]))}
    return jc, tc, params, params_from_numpy(_np(params), tc, "cpu"), b, tb


# ---------------------------------------------------------------------------
# data, config, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step,seed,batch", [(0, 0, 128), (7, 3, 64), (0, 1234, 256)])
def test_mnist_batch_matches(step, seed, batch):
    want = j_mnist_batch(batch=batch, step=step, seed=seed)
    got = t_mnist_batch(batch=batch, step=step, seed=seed, device="cpu")
    assert got["label"].dtype == torch.int32 and got["image"].shape == (batch, 784)
    assert np.array_equal(got["label"].numpy(), np.asarray(want["label"]))
    a, b = got["image"].numpy(), np.asarray(want["image"])
    assert float((np.abs(a - b) <= IMG_ATOL).mean()) >= IMG_CLOSE
    assert float((a == b).mean()) >= IMG_EQUAL
    assert a.min() >= 0.0 and a.max() <= 1.0


def test_mnist_dataset_matches():
    want, got = j_mnist_dataset(64), t_mnist_dataset(64, device="cpu")
    assert np.array_equal(got["label"].numpy(), np.asarray(want["label"]))
    assert float((np.abs(got["image"].numpy() - np.asarray(want["image"])) <= IMG_ATOL).mean()) \
        >= IMG_CLOSE


def test_config_matches_reference():
    j_smoke = dataclasses.replace(J_CFG, fcnn_layers=(64, 32, 16, 10))
    for tc, jc in ((get_config("fcnn-mnist"), J_CFG), (get_smoke_config("fcnn-mnist"), j_smoke)):
        assert (tc.name, tc.family, tc.fcnn_layers, tc.dtype, tc.wta_head) == \
            (jc.name, jc.family, jc.fcnn_layers, jc.dtype, jc.wta_head)
        ta, ja = tc.analog, jc.analog
        assert (ta.mode, ta.beta, ta.hard, ta.quantize, ta.calibrated, ta.wta_trials, ta.vth0) == \
            (ja.mode, ja.beta, ja.hard, ja.quantize, ja.calibrated, ja.wta_trials, ja.vth0)
        assert dataclasses.asdict(ta.device) == dataclasses.asdict(ja.device)
        assert tc.param_count() == jc.param_count()


@pytest.mark.parametrize("seed", [0, 5])
def test_init_fcnn_matches(seed):
    jc, tc = _cfgs((784, 500, 300, 10))
    want = JF.init_fcnn(jax.random.PRNGKey(seed), jc)
    got = TF.init_fcnn(R.PRNGKey(seed), tc, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
        assert float((a == b).mean()) >= 0.99, k


def test_model_fns_registry():
    fns = get_model_fns(T_CFG)
    assert fns.loss is TF.fcnn_loss
    p = fns.init(0, dataclasses.replace(T_CFG, fcnn_layers=(64, 32, 10)), "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w0": (64, 32), "b0": (32,), "w1": (32, 10), "b1": (10,)}
    lm = get_smoke_config("stablelm-3b")
    assert set(get_model_fns(lm).init(0, lm, "cpu")) == {"embed", "final_norm", "head", "units"}
    with pytest.raises(NotImplementedError, match="unknown family"):
        get_model_fns(ModelConfig(name="x", family="tpu_only"))
    from repro_torch.models import encdec as ED

    ed = get_model_fns(get_smoke_config("whisper-small"))
    assert ed.loss is ED.encdec_loss and ed.decode_step is ED.encdec_decode_step


# ---------------------------------------------------------------------------
# logits, loss, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["digital", "analog_stochastic"])
def test_fcnn_loss_and_gradients_match(mode):
    """Digital, and the training forward of the analog config (the
    expectation, hard=False): logits, loss and every gradient within 1e-5."""
    jc, tc, params, tp, b, tb = _setup(mode=mode)
    key = jax.random.PRNGKey(4)
    jz = np.asarray(jax.jit(lambda p, x: JF.fcnn_logits(p, x, jc, key))(params, b["image"]))
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: JF.fcnn_loss(p, b, jc, key), has_aux=True))(params)
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tz = TF.fcnn_logits(tp, tb["image"], tc, _pair(key))
    np.testing.assert_allclose(tz.detach().numpy(), jz, atol=ATOL, rtol=0)
    lt, mt = TF.fcnn_loss(tp, tb, tc, _pair(key))
    gt = torch.autograd.grad(lt, leaves)
    assert abs(float(lt.detach()) - float(lj)) <= ATOL
    assert float(mt["acc"]) == float(mj["acc"])
    for a, g in zip(jax.tree.leaves(gj), gt):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), atol=ATOL, rtol=0)


def test_fcnn_hard_hidden_activations_agree():
    """Hard (deployment) hidden layers, each fed the reference's input to
    it: decisions agree on HARD_AGREE, and every difference lies where u is
    within P_ULPS ulps of the reference's p."""
    jc, tc, params, tp, b, tb = _setup(batch=256, hard=True)
    key = jax.random.PRNGKey(21)
    h_j = np.asarray(b["image"])
    total, diff = 0, 0
    for i in range(2):
        ki = jax.random.fold_in(key, i)
        w, bias = params[f"w{i}"], params[f"b{i}"]
        want = np.asarray(jax.jit(lambda x, w, bb: JA.analog_dense(jc.analog, ki, x, w, bb))(
            h_j, w, bias))
        got = TA.analog_dense(tc.analog, _pair(ki), torch.from_numpy(h_j), tp[f"w{i}"],
                              tp[f"b{i}"]).numpy()
        wq = np.asarray(jax.jit(lambda w: JA.quantize_normalized(w, jc.analog))(w))
        p = np.asarray(jax.nn.sigmoid(h_j @ wq + bias))
        u = R.uniform(_pair(ki), want.shape).numpy()
        d = got != want
        assert np.all(np.abs(u - p)[d] <= P_ULPS * 2.0**-24), np.abs(u - p)[d].max()
        total, diff = total + d.size, diff + int(d.sum())
        h_j = want
    assert 1 - diff / total >= HARD_AGREE


@pytest.mark.parametrize("votes", [1, 8])
def test_fcnn_predict_raca_agrees(votes):
    """RACA inference through the same weights: predictions agree on at
    least PRED_AGREE of the images; the digital baseline exactly."""
    jc, tc, params, tp, b, tb = _setup(batch=256)
    # a few reference training steps, so that the votes carry signal
    tcfg = JTrainConfig(opt=JAdamWConfig(lr=5e-3, state_dtype="float32",
                                         stochastic_rounding=False), warmup_steps=1)
    state = j_init_train_state(jax.random.PRNGKey(1), jc, tcfg)
    step = jax.jit(j_make_train_step(jc, tcfg))
    for i in range(10):
        state, _ = step(state, j_mnist_batch(batch=128, step=i))
    params = state.params
    tp = params_from_numpy(_np(params), tc, "cpu")
    key = jax.random.PRNGKey(7)
    want = np.asarray(JF.fcnn_predict_raca(params, b["image"], jc, key, votes))
    got = TF.fcnn_predict_raca(tp, tb["image"], tc, _pair(key), votes)
    assert got.dtype == torch.int64 and got.shape == (256,)
    assert float((got.numpy() == want).mean()) >= PRED_AGREE
    dig = np.asarray(JF.fcnn_predict_digital(params, b["image"], jc))
    assert np.array_equal(TF.fcnn_predict_digital(tp, tb["image"], tc).numpy(), dig)


def test_fcnn_predict_raca_quantizes_once():
    """Quantizing the hidden weights once per call gives the numbers of
    quantizing in every vote (analog_dense with the config as it is)."""
    _, tc, _, tp, _, tb = _setup((784, 48, 32, 10), batch=32)
    key, votes = (0, 77), 3
    got = TF.fcnn_predict_raca(tp, tb["image"], tc, key, votes)
    hcfg = dataclasses.replace(tc, analog=dataclasses.replace(tc.analog, hard=True))
    counts = torch.zeros((32, 10))
    for kv in R.split(key, votes):
        z = TF.fcnn_logits(tp, tb["image"], hcfg, kv)
        counts += TF.W.wta_trials(R.fold_in(kv, 99), z, 1, hcfg.analog.vth0).counts
    assert torch.equal(got, counts.argmax(-1))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_train_step_matches():
    """TRAIN_STEPS steps of the reference's example settings (f32 moments,
    no stochastic rounding) from one bridged state."""
    jc, tc = _cfgs((784, 64, 32, 10))
    jt = JTrainConfig(opt=JAdamWConfig(lr=3e-3, state_dtype="float32",
                                       stochastic_rounding=False), warmup_steps=2)
    tt = TTrainConfig(opt=TAdamWConfig(lr=3e-3, state_dtype="float32",
                                       stochastic_rounding=False), warmup_steps=2)
    js = j_init_train_state(jax.random.PRNGKey(0), jc, jt)
    ts = train_state_from_numpy(
        _np(js.params), _np(js.opt.m), _np(js.opt.v), int(js.opt.step), int(js.step),
        jax.random.key_data(js.rng), tc, tt, "cpu")
    jstep, tstep = jax.jit(j_make_train_step(jc, jt)), t_make_train_step(tc, tt)
    for i in range(TRAIN_STEPS):
        b = j_mnist_batch(batch=64, step=i)
        js, mj = jstep(js, b)
        ts, mt = tstep(ts, {k: torch.from_numpy(np.array(v)) for k, v in b.items()})
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= ATOL
    for k in js.params:
        np.testing.assert_allclose(ts.params[k].detach().numpy(), np.asarray(js.params[k]),
                                   atol=ATOL, rtol=0)
    assert ts.step == int(js.step) == TRAIN_STEPS


def test_init_train_state_is_reference_init():
    from repro_torch.train import init_train_state

    _, tc = _cfgs((784, 32, 10))
    st = init_train_state(3, tc, TTrainConfig(), device="cpu")
    want = TF.init_fcnn(R.PRNGKey(3), tc, "cpu")
    assert all(torch.equal(st.params[k].detach(), want[k]) for k in want)
    assert st.rng == R.fold_in(R.PRNGKey(3), 1)


def test_launcher_fcnn(capsys, tmp_path):
    # the launcher checkpoints (by default into ckpts/<name>, resuming from it)
    launch_train.main(["--arch", "fcnn-mnist", "--smoke", "--device", "cpu", "--steps", "3",
                       "--batch", "16", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "done: steps=3" in out
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "fcnn-mnist", "--analog", "--device", "cpu"])


def test_fig6_relations_in_the_port():
    """tests/test_system.py's recipe in the port alone, reduced to (784,
    128, 64, 10): trained accuracy > 0.85; 64 votes at least 1 vote, and
    within 0.05 of the digital ceiling."""
    _, tc = _cfgs(SMALL)
    tcfg = TTrainConfig(opt=TAdamWConfig(lr=5e-3, state_dtype="float32",
                                         stochastic_rounding=False))
    from repro_torch.train import init_train_state

    state = init_train_state(0, tc, tcfg, device="cpu")
    step = t_make_train_step(tc, tcfg)
    for i in range(500):
        state, _ = step(state, t_mnist_batch(batch=128, step=i, device="cpu"))
    params = state.params
    test = t_mnist_dataset(512, device="cpu")
    acc = float((TF.fcnn_predict_digital(params, test["image"], tc) == test["label"]).float().mean())
    assert acc > 0.85, acc
    x, y = test["image"][:256], test["label"][:256]
    digital = float((TF.fcnn_predict_digital(params, x, tc) == y).float().mean())
    accs = {v: float((TF.fcnn_predict_raca(params, x, tc, R.PRNGKey(7), v) == y).float().mean())
            for v in (1, 8, 64)}
    assert accs[64] >= accs[1]
    assert accs[64] >= digital - 0.05, (accs, digital)
