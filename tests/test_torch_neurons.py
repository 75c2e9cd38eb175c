"""The port's RACA primitives under the FCNN path against the reference:
``random.randint`` at any span, the device physics, the crossbar mapping,
the stochastic Sigmoid neurons (the plain version of the
``sigmoid_sample`` kernel among them) and ``analog_dense``.

Tolerances, and why:

- ``randint``, ``quantize_weights``, ``quantize_normalized``: equal (the
  same threefry bits and integer steps; the quantizer's f32 steps are
  those of the reference's jitted code, a multiply by the reciprocal and
  one FMA, see ``core/crossbar.py``);
- the other physics and crossbar functions: rtol 4e-7 (two f32 ulps):
  XLA may fuse a multiply-add the port rounds twice, and torch's f32
  ``sqrt`` on the CPU is not correctly rounded on every build
  (``tests/torch_cpu_rounding.py``); where ``normal`` noise enters, its
  ``log1p`` adds a few ulps of the noise: 1e-6 of the largest value;
- ``fire_probability_*``: atol 1e-6 (``erf`` and ``logistic`` of two
  libraries, a few ulps);
- hard decisions: the bits and uniforms are equal, ``p`` differs by a few
  ulps (torch's ``sigmoid`` against XLA's ``logistic``, 99.6% equal, and
  f32 products summed in another order), so a decision can flip only where
  ``u`` lies within ``P_ULPS`` ulps of ``p``; every flip is shown to lie
  there;
- ``analog_dense`` outputs and gradients, digital and expectation modes:
  atol 1e-5 (f32 products in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import analog as JA
from repro.core import crossbar as JC
from repro.core import neurons as JN
from repro.core import physics as JP
from repro_torch import random as R
from repro_torch.core import analog as TA
from repro_torch.core import crossbar as TC
from repro_torch.core import neurons as TN
from repro_torch.core import physics as TP
from repro_torch.kernels import ops, ref

ATOL = 1e-5
RTOL = 4e-7
P_ATOL = 1e-6
# where threefry normal noise enters (its log1p, a few ulps): relative to
# the largest value
NOISY_RTOL = 1e-6
# a decision may flip only where |u − p| is at most this many ulps of 1.0
# (2**-24): the port's p lay within 5 of the reference's (test_torch_fcnn)
P_ULPS = 8
SEEDS = [0, 7, 2**31 - 1]


def _pair(key) -> tuple[int, int]:
    a = np.asarray(jax.random.key_data(key), np.uint32)
    return int(a[0]), int(a[1])


def _dp():
    """The FCNN config's device (V_r calibrated over 784 rows)."""
    return (JP.calibrate_v_read(JP.DeviceParams(), 784),
            TP.calibrate_v_read(TP.DeviceParams(), 784))


def _close(got: torch.Tensor, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# randint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("span", [10, 3, 1000, 2**16, 2**16 - 1, 1, 8])
@pytest.mark.parametrize("dtype", [jnp.int32, jnp.uint32])
def test_randint_any_span(seed, span, dtype):
    """jax's two-word reduction for spans that are not powers of two, the
    low bits for those that are; minval added; sliced draws equal."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), span)
    want = np.asarray(jax.random.randint(key, (3, 517), 5, 5 + span, dtype=dtype)).astype(np.int64)
    got = R.randint(_pair(key), (3, 517), 5, 5 + span).numpy()
    assert np.array_equal(got, want)
    part = R.randint(_pair(key), (3, 517), 5, 5 + span, start=400, count=900).numpy()
    assert np.array_equal(part, want.reshape(-1)[400:1300])


def test_randint_power_of_two_unchanged():
    """A power-of-two span is the low bits of the second split key's bits,
    as before the general path existed."""
    key = R.fold_in(R.PRNGKey(4), 9)
    lo = R.random_bits(R.split(key)[1], (1000,))
    for span in (1, 2, 1024, 2**16):
        assert torch.equal(R.randint(key, (1000,), 0, span), lo & (span - 1))


# ---------------------------------------------------------------------------
# physics and crossbar
# ---------------------------------------------------------------------------


def test_physics_tensor_functions():
    jdp, tdp = _dp()
    rng = np.random.default_rng(0)
    w = rng.uniform(-1, 1, (64, 48)).astype(np.float32)
    g = rng.uniform(1e-6, 1e-4, (64, 48)).astype(np.float32)
    z = rng.normal(size=(8, 48)).astype(np.float32)
    sum_g = rng.uniform(1e-3, 1e-1, (48,)).astype(np.float32)
    tw, tg, tz, ts = (torch.from_numpy(a) for a in (w, g, z, sum_g))
    _close(TP.weight_to_conductance(tw, tdp), JP.weight_to_conductance(w, jdp))
    _close(TP.weight_from_conductance(tg, tdp), JP.weight_from_conductance(g, jdp), atol=1e-7)
    _close(TP.thermal_noise_rms(tg, tdp), JP.thermal_noise_rms(g, jdp))
    _close(TP.column_noise_sigma(ts, tdp), JP.column_noise_sigma(sum_g, jdp))
    _close(TP.snr_db(ts, ts.flip(0)), JP.snr_db(sum_g, sum_g[::-1]), atol=1e-5)
    _close(TP.column_snr_db(tz, ts, tdp), JP.column_snr_db(z, sum_g, jdp), atol=1e-4)
    for n in (784, 500, 64):
        assert TP.effective_beta(tdp, n) == JP.effective_beta(jdp, n)
    key = jax.random.PRNGKey(3)
    want = JP.sample_noise_current(key, sum_g, jdp)
    got = TP.sample_noise_current(_pair(key), ts, tdp)
    # normal: equal bits, log1p a few ulps apart on some draws
    _close(got, want, rtol=1e-5)
    assert TP.sample_noise_current(_pair(key), ts, tdp, (4, 48)).shape == (4, 48)


@pytest.mark.parametrize("scale", [0.05, 0.6, 3.0])
def test_quantize_weights_exact(scale):
    """Round-to-nearest and stochastic quantization equal the reference's
    jitted quantizer bit for bit."""
    jdp, tdp = _dp()
    w = (np.random.default_rng(1).normal(size=(256, 96)) * scale).astype(np.float32)
    tw = torch.from_numpy(w)
    want = np.asarray(jax.jit(lambda a: JC.quantize_weights(a, jdp))(w))
    assert np.array_equal(TC.quantize_weights(tw, tdp).numpy(), want)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.jit(lambda a, k: JC.quantize_weights(a, jdp, k, True))(w, key))
    assert np.array_equal(TC.quantize_weights(tw, tdp, _pair(key), True).numpy(), want)


@pytest.mark.parametrize("sigma_program", [0.0, 0.02])
def test_crossbar_mapping_and_mac(sigma_program):
    jdp, tdp = _dp()
    jdp, tdp = jdp.replace(sigma_program=sigma_program), tdp.replace(sigma_program=sigma_program)
    rng = np.random.default_rng(2)
    w = rng.uniform(-1, 1, (96, 40)).astype(np.float32)
    x = rng.uniform(0, 1, (6, 96)).astype(np.float32)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    mkey, key = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    for mk in (None, mkey):
        jm = jax.jit(lambda a, k=mk: JC.map_weights(a, jdp, key=k))(w)
        tm = TC.map_weights(tw, tdp, key=None if mk is None else _pair(mk))
        _close(tm.g, jm.g, rtol=NOISY_RTOL)   # programming noise: normal's ulps
        _close(tm.w_eff, jm.w_eff, rtol=0, atol=1e-6)
        assert float(tm.g_ref) == float(jm.g_ref)
        _close(TC.column_sum_g(tm), JC.column_sum_g(jm))
    jm, tm = JC.map_weights(w, jdp), TC.map_weights(tw, tdp)
    jd, js = JC.analog_mac(key, x, jm, jdp)
    td, ts = TC.analog_mac(_pair(key), tx, tm, tdp)
    _close(ts, js)
    _close(td, jd, rtol=0, atol=NOISY_RTOL * float(np.abs(np.asarray(jd)).max()))
    jz = np.asarray(JC.analog_matmul_zspace(key, x, w, jdp))
    _close(TC.analog_matmul_zspace(_pair(key), tx, tw, tdp), jz, rtol=0,
           atol=NOISY_RTOL * float(np.abs(jz).max()))
    _close(TC.zspace_noise_sigma(tw, tdp), JC.zspace_noise_sigma(w, jdp))
    for n, r in ((784, 256), (256, 256), (1, 256), (513, 128)):
        assert TC.tile_count(n, r) == JC.tile_count(n, r)


# ---------------------------------------------------------------------------
# neurons
# ---------------------------------------------------------------------------


def test_fire_probabilities():
    jdp, tdp = _dp()
    rng = np.random.default_rng(3)
    z = rng.normal(size=(16, 40)).astype(np.float32) * 3
    sum_g = rng.uniform(1e-3, 1e-1, (40,)).astype(np.float32)
    tz, ts = torch.from_numpy(z), torch.from_numpy(sum_g)
    _close(TN.fire_probability_physical(tz, ts, tdp),
           JN.fire_probability_physical(z, sum_g, jdp), rtol=0, atol=P_ATOL)
    for beta in (1.0, 0.5):
        _close(TN.fire_probability_calibrated(tz, beta),
               JN.fire_probability_calibrated(z, beta), rtol=0, atol=P_ATOL)


def _flips_near_p(got, want, u, p, label):
    """Decisions equal except where |u − p| <= P_ULPS ulps of 1.0."""
    diff = got != want
    gap = (u - p).abs()[diff]
    assert bool((gap <= P_ULPS * 2.0**-24).all()), (label, gap.max())
    return float(diff.float().mean())


@pytest.mark.parametrize("seed", SEEDS)
def test_sigmoid_sample_plain_version(seed):
    """ops.sigmoid_sample on the CPU (the kernel's plain version) against
    the reference's stochastic_binarize of sigmoid(β(acc + b)) on the same
    acc: the uniforms are jax's bit for bit, and a decision differs only
    where u sits within ulps of p; a counter offset draws the flat range
    further on."""
    rng = np.random.default_rng(seed)
    acc = rng.normal(size=(37, 53)).astype(np.float32) * 4
    b = rng.normal(size=(53,)).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    for beta in (1.0, 0.7):
        want = np.asarray(jax.jit(lambda a, bb, k: JN.sigmoid_neuron_calibrated(
            k, a + bb, beta=beta, hard=True))(acc, b, key))
        got = ops.sigmoid_sample(torch.from_numpy(acc), torch.from_numpy(b), beta, _pair(key))
        u = torch.from_numpy(np.asarray(jax.random.uniform(key, acc.shape)))
        assert torch.equal(R.uniform(_pair(key), acc.shape), u)
        p = torch.from_numpy(np.asarray(jax.nn.sigmoid(beta * (acc + b))))
        _flips_near_p(got, torch.from_numpy(want), u, p, beta)
    # without a bias, and from a counter offset (the tail of a longer draw)
    got = ops.sigmoid_sample(torch.from_numpy(acc), None, 1.0, _pair(key), offset=100)
    bits = R.random_bits(_pair(key), (100 + acc.size,))[100:].reshape(acc.shape)
    u = R.uniform_from_bits(bits, 0.0, 1.0)
    assert torch.equal(got, (u < torch.sigmoid(torch.from_numpy(acc))).float())
    assert ops.sigmoid_sample(torch.zeros((0, 5)), None, 1.0, (0, 1)).shape == (0, 5)


def test_stochastic_binarize_straight_through():
    """Forward y (or p with hard=False), backward the gradient to p, for
    the plain draw and for the kernel's sample through the neuron."""
    p = torch.rand((8, 20), generator=torch.Generator().manual_seed(0)).requires_grad_(True)
    key = (0, 9)
    y = TN.stochastic_binarize(key, p)
    assert torch.equal(y, (R.uniform(key, (8, 20)) < p).float())
    g = torch.randn((8, 20))
    (gp,) = torch.autograd.grad(y, p, g)
    assert torch.equal(gp, g)
    assert TN.stochastic_binarize(key, p, hard=False) is not None
    assert torch.equal(TN.stochastic_binarize(key, p, hard=False), p)
    z = torch.randn((8, 20), generator=torch.Generator().manual_seed(1)).requires_grad_(True)
    b = torch.randn((20,), generator=torch.Generator().manual_seed(2)).requires_grad_(True)
    y = TN.sigmoid_neuron_calibrated(key, z, 0.8, True, bias=b)
    assert torch.equal(y, ref.sigmoid_sample_ref(z.detach(), b.detach(), beta=0.8, key=key))
    gz, gb = torch.autograd.grad(y, (z, b), g)
    s = torch.sigmoid(0.8 * (z + b)).detach()
    torch.testing.assert_close(gz, g * s * (1 - s) * 0.8, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(gb, gz.sum(0), rtol=1e-5, atol=1e-6)


def test_sigmoid_neuron_physical_and_comparator():
    """The full-circuit neuron's fire probability and the literal
    comparator: the reference's decisions, up to flips near the boundary."""
    jdp, tdp = _dp()
    rng = np.random.default_rng(4)
    w = rng.uniform(-1, 1, (96, 40)).astype(np.float32) * 0.3
    x = (rng.uniform(0, 1, (64, 96)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want = np.asarray(JN.sigmoid_neuron_physical(key, x, w, jdp))
    got = TN.sigmoid_neuron_physical(_pair(key), torch.from_numpy(x), torch.from_numpy(w), tdp)
    assert float((got.numpy() == want).mean()) >= 0.999
    want = np.asarray(JN.comparator_sample(key, x, w, jdp))
    got = TN.comparator_sample(_pair(key), torch.from_numpy(x), torch.from_numpy(w), tdp)
    assert float((got.numpy() == want).mean()) >= 0.999


# ---------------------------------------------------------------------------
# analog_dense
# ---------------------------------------------------------------------------


def _acfgs(mode, hard):
    jdp, tdp = _dp()
    return (JA.AnalogConfig(mode=mode, device=jdp, hard=hard),
            TA.AnalogConfig(mode=mode, device=tdp, hard=hard))


@pytest.mark.parametrize("scale", [0.05, 1.5])
def test_quantize_normalized_exact(scale):
    jc, tc = _acfgs("analog_stochastic", False)
    w = (np.random.default_rng(5).normal(size=(300, 120)) * scale).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: JA.quantize_normalized(a, jc))(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    got = TA.quantize_normalized(tw, tc)
    assert np.array_equal(got.detach().numpy(), want)
    (g,) = torch.autograd.grad(got.sum(), tw)
    assert torch.equal(g, torch.ones_like(g))   # straight through
    nq = dataclasses.replace(tc, quantize=False)
    assert TA.quantize_normalized(tw, nq) is tw


@pytest.mark.parametrize("mode", ["digital", "analog_stochastic"])
def test_analog_dense_matches(mode):
    """Outputs and gradients (x, w, b) within 1e-5 in digital and
    expectation (hard=False) modes."""
    jc, tc = _acfgs(mode, False)
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (16, 80)).astype(np.float32)
    w = (rng.normal(size=(80, 40)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(40,)) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(8)

    def jf(x, w, b):
        return (JA.analog_dense(jc, key, x, w, b) * jnp.arange(40.0)).sum()

    want, grads = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2)))(x, w, b)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y = TA.analog_dense(tc, _pair(key), tx, tw, tb)
    got = (y * torch.arange(40.0)).sum()
    assert abs(float(got) - float(want)) <= ATOL * max(1.0, abs(float(want)))
    for t, g in zip(torch.autograd.grad(got, (tx, tw, tb)), grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(g), atol=ATOL, rtol=1e-5)


def test_analog_dense_hard_decisions():
    """Hard mode: the bias-folded comparator's decisions equal the
    reference's except where u lies within P_ULPS ulps of p; the
    straight-through gradients equal the reference's where they agree."""
    jc, tc = _acfgs("analog_stochastic", True)
    rng = np.random.default_rng(7)
    x = (rng.uniform(0, 1, (128, 96)) > 0.5).astype(np.float32)
    w = (rng.normal(size=(96, 64)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(64,)) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.jit(lambda *a: JA.analog_dense(jc, key, *a))(x, w, b))
    got = TA.analog_dense(tc, _pair(key), *(torch.from_numpy(a) for a in (x, w, b)))
    wq = np.asarray(jax.jit(lambda a: JA.quantize_normalized(a, jc))(w))
    p = torch.from_numpy(np.asarray(jax.nn.sigmoid(x @ wq + b)))
    u = R.uniform(_pair(key), (128, 64))
    assert _flips_near_p(got, torch.from_numpy(want), u, p, "hard") <= 1e-3
    _, grads = jax.jit(jax.value_and_grad(
        lambda w, b: JA.analog_dense(jc, key, x, w, b).sum(), argnums=(0, 1)))(w, b)
    tw, tb = torch.from_numpy(w).requires_grad_(True), torch.from_numpy(b).requires_grad_(True)
    y = TA.analog_dense(tc, _pair(key), torch.from_numpy(x), tw, tb)
    for t, g in zip(torch.autograd.grad(y.sum(), (tw, tb)), grads):
        np.testing.assert_allclose(t.numpy(), np.asarray(g), atol=ATOL, rtol=1e-5)
