"""The generic ``ops.stoch_round`` through the device backend seam, and
``ops.wta_counts_reference``, against the JAX reference on the CPU.

``stoch_round`` equals the reference's ``stoch_round_reference`` (its jnp
oracle, ``repro/kernels/ops.py:558-568``) bit for bit: integer hashing and
exact f32 steps.  The reference's interpret-mode Pallas kernel can sit an
ulp off its own oracle where ``step != 1`` (it contracts an FMA), so the
kernel itself is compared at ``step == 1`` only.  Shapes are odd on
purpose: columns off the 512 grid, rows off the 256 grid, a 3-D input.
The WTA counts go through ``log1p``, which torch's CPU build rounds
otherwise than XLA, so they are held by agreement (> 0.9995,
``tests/test_kernels.py:57``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import backend as JBK
from repro.kernels import ops as JOPS
from repro_torch.kernels import backend as TBK
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import prng

WTA_AGREEMENT = 0.9995
INT8 = dict(step=1.0, lo=-127.0, hi=127.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(seed: int):
    """A jax key and the port's pair of words for it."""
    jk = jax.random.PRNGKey(seed)
    return jk, tuple(int(v) for v in np.asarray(jax.random.key_data(jk)))


def _x(shape, scale, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,kw,scale", [
    ((37, 700), INT8, 60.0),
    ((4, 10, 300), INT8, 60.0),
    ((300, 513), dict(step=0.125, lo=-16.0, hi=15.875), 6.0),
    ((3, 5, 1030), dict(step=2.0 / 31, lo=-1.0, hi=1.0), 0.7),
])
def test_stoch_round_equals_reference_oracle(shape, kw, scale):
    x = _x(shape, scale)
    jk, tk = _key(7)
    want = np.asarray(JOPS.stoch_round_reference(jnp.asarray(x), jk, **kw))
    got = TOPS.stoch_round(torch.from_numpy(x), tk, **kw)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TOPS.stoch_round_reference(torch.from_numpy(x), tk, **kw).numpy(), want)


@pytest.mark.parametrize("shape", [(37, 700), (4, 10, 300)])
def test_stoch_round_equals_reference_kernel_at_step_one(shape):
    """At ``step == 1`` (the int8 KV quantizer's) the reference's
    interpret-mode kernel, its oracle and the port agree."""
    x = _x(shape, 60.0, seed=1)
    jk, tk = _key(3)
    want = np.asarray(JOPS.stoch_round(jnp.asarray(x), jk, **INT8))
    np.testing.assert_array_equal(TOPS.stoch_round(torch.from_numpy(x), tk, **INT8).numpy(), want)


def test_stoch_round_is_unbiased_onto_the_grid():
    x = torch.full((64, 1024), 0.3)
    y = TOPS.stoch_round(x, (0, 5), step=1.0, lo=-2.0, hi=2.0)
    assert set(y.unique().tolist()) == {0.0, 1.0}
    assert abs(float(y.mean()) - 0.3) < 0.01


def test_stoch_round_straight_through_gradient():
    """``g·[lo ≤ x ≤ hi]``, the reference's ``_sr_bwd``, held against
    ``jax.grad`` on the same inputs."""
    kw = dict(step=0.25, lo=-1.0, hi=1.0)
    x = _x((9, 33), 1.5, seed=2)
    g = _x((9, 33), 1.0, seed=3)
    jk, tk = _key(11)
    want = jax.grad(lambda v: jnp.sum(JOPS.stoch_round(v, jk, **kw) * jnp.asarray(g)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (TOPS.stoch_round(xt, tk, **kw) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    mask = (x >= -1.0) & (x <= 1.0)
    assert 0 < mask.sum() < mask.size
    np.testing.assert_array_equal(xt.grad.numpy(), g * mask)


def test_stoch_round_unchanged_under_the_faulty_backend():
    """A fault backend leaves the rounding alone (a digital op), as the
    reference's ``test_zero_knob_stoch_round_bit_identical`` and a
    perturbed one show."""
    x = _x((8, 8), 4.0, seed=6)
    kw = dict(step=0.125, lo=-16.0, hi=15.875)
    jk, tk = _key(7)
    want = TOPS.stoch_round(torch.from_numpy(x), tk, **kw)
    knobs = dict(stuck_rate=0.1, drift_nu=0.2, read_sigma_inflation=3.0, comparator_offset=0.5)
    with TBK.use_backend(TBK.FaultySimBackend(fault=TBK.FaultConfig(**knobs))):
        got = TOPS.stoch_round(torch.from_numpy(x), tk, **kw)
    assert torch.equal(got, want)
    with JBK.use_backend(JBK.FaultySimBackend(fault=JBK.FaultConfig(**knobs))):
        jwant = np.asarray(JOPS.stoch_round(jnp.asarray(x), jk, **kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))


def test_stoch_round_goes_through_the_backend():
    seen = []

    class Spy(TBK.SimBackend):
        def stoch_round(self, x, key, *, step, lo, hi):
            seen.append((tuple(x.shape), key, step))
            return super().stoch_round(x, key, step=step, lo=lo, hi=hi)

    with TBK.use_backend(Spy()):
        TOPS.stoch_round(torch.zeros(2, 3), (1, 2), step=1.0, lo=-1.0, hi=1.0)
    assert seen == [((2, 3), (1, 2), 1.0)]


@pytest.mark.parametrize("shape,n_trials", [((37, 300), 16), ((2, 5, 130), 32)])
def test_wta_counts_reference_agrees_with_reference(shape, n_trials):
    z = _x(shape, 2.0, seed=4)
    jk, tk = _key(3)
    kw = dict(n_trials=n_trials, vth0=0.5, sigma_z=1.0)
    want = np.asarray(JOPS.wta_counts_reference(jnp.asarray(z), jk, **kw))
    got = TOPS.wta_counts_reference(torch.from_numpy(z), prng.key_to_seed(tk), **kw).numpy()
    assert got.shape == shape
    assert float((got == want).mean()) > WTA_AGREEMENT
    # on the CPU the backend's counts are the plain version's
    np.testing.assert_array_equal(
        TOPS.wta_counts(torch.from_numpy(z), prng.key_to_seed(tk), **kw).numpy(), got)
