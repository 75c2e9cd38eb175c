"""The port's crossbar read (``repro_torch.kernels.ops.crossbar_mac``, its
plain PyTorch path on the CPU) against the reference's
``repro.kernels.ops.crossbar_mac``, which runs the Pallas kernel in
interpret mode here, as ``tests/test_kernels.py`` runs it.

Same numpy inputs, same threefry key.  Tolerances, and why:

- linear readout: atol 2e-5, rtol 1e-5 (``test_kernels.py``'s): the
  quantized weights and the noise agree to an ulp, the products differ in
  f32 summation order (and the interpret-mode kernel may contract the
  quantizer's multiply-add into an FMA);
- comparator readout: more than 99.95% of the decisions equal
  (``test_kernels.py:57``): an element whose noisy sum sits within that
  rounding of 0 may flip;
- STE gradients: atol 1e-5, rtol 1e-4 (f32 products in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.analog import AnalogConfig as JAnalog
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.kernels import ops as JOPS
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.kernels import ops as TOPS

LIN_ATOL, LIN_RTOL = 2e-5, 1e-5
AGREEMENT = 0.9995
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4

SHAPES = [(8, 64, 16), (100, 300, 200), (128, 512, 128), (64, 1200, 130), (257, 513, 129)]
KEY = jax.random.PRNGKey(42)
TKEY = tuple(int(w) for w in np.asarray(jax.random.key_data(KEY)))


def _cfgs(**kw):
    return (
        JAnalog(mode="analog_stochastic", device=j_calibrate(JDevice(), 512), use_pallas="on", **kw),
        TAnalog(mode="analog_stochastic", device=t_calibrate(TDevice(), 512), **kw),
    )


def _inputs(m, k, n, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * scale).astype(np.float32)
    return x, w


def _both(x, w, binarize, **kw):
    jc, tc = _cfgs(**kw)
    yj = np.asarray(JOPS.crossbar_mac(jnp.asarray(x), jnp.asarray(w), KEY, jc, binarize=binarize))
    yt = TOPS.crossbar_mac(torch.from_numpy(x), torch.from_numpy(w), TKEY, tc, binarize=binarize)
    return yj, yt.numpy()


def test_calibrated_device_params_match():
    assert t_calibrate(TDevice(), 512) == TDevice(**vars(j_calibrate(JDevice(), 512)))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_crossbar_linear_matches_reference(m, k, n):
    x, w = _inputs(m, k, n)
    yj, yt = _both(x, w, binarize=False)
    np.testing.assert_allclose(yt, yj, atol=LIN_ATOL, rtol=LIN_RTOL)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_crossbar_binary_agreement(m, k, n):
    x, w = _inputs(m, k, n)
    yj, yt = _both(x, w, binarize=True)
    assert set(np.unique(yt)) <= {0.0, 1.0}
    assert float((yj == yt).mean()) > AGREEMENT


@pytest.mark.parametrize("binarize", [True, False])
def test_crossbar_physical_noise_path(binarize):
    """Uncalibrated read: σ per column from ΣW_q (Johnson noise)."""
    x, w = _inputs(64, 512, 128, seed=2)
    yj, yt = _both(x, w, binarize=binarize, calibrated=False)
    if binarize:
        assert float((yj == yt).mean()) > AGREEMENT
    else:
        np.testing.assert_allclose(yt, yj, atol=LIN_ATOL, rtol=LIN_RTOL)


def test_crossbar_unquantized_canary_read():
    """The serving canary's read: unquantized, calibrated, linear, σ 0.01,
    (1, 128) × (128, 8)."""
    rng = np.random.default_rng(0xCA9A31)
    x = rng.uniform(-1.0, 1.0, (1, 128)).astype(np.float32)
    w = rng.uniform(-1.0, 1.0, (128, 8)).astype(np.float32)
    kw = dict(quantize=False, calibrated=True, linear_sigma=0.01)
    yj, yt = _both(x, w, binarize=False, **kw)
    np.testing.assert_allclose(yt, yj, atol=LIN_ATOL, rtol=LIN_RTOL)


def test_crossbar_leading_batch_dims():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 32)) * 0.1).astype(np.float32)
    yj, yt = _both(x, w, binarize=False)
    assert yt.shape == (4, 6, 32)
    np.testing.assert_allclose(yt, yj, atol=LIN_ATOL, rtol=LIN_RTOL)


def test_crossbar_reference_entry_point_is_the_plain_path():
    """``crossbar_mac_reference`` (what the card is held against) is the
    same function as the CPU path of ``crossbar_mac``."""
    x, w = _inputs(100, 300, 200)
    _, tc = _cfgs()
    for b in (True, False):
        a = TOPS.crossbar_mac(torch.from_numpy(x), torch.from_numpy(w), TKEY, tc, binarize=b)
        r = TOPS.crossbar_mac_reference(torch.from_numpy(x), torch.from_numpy(w), TKEY, tc, binarize=b)
        assert torch.equal(a, r)


@pytest.mark.parametrize("binarize", [True, False])
@pytest.mark.parametrize("calibrated", [True, False])
def test_crossbar_ste_gradients_match(binarize, calibrated):
    """jax.grad through the reference's custom_vjp against torch.autograd
    through the port's autograd.Function, for x and W, with a loss that
    weights every output differently."""
    x, w = _inputs(32, 128, 64, seed=4, scale=0.1 if calibrated else 0.6)
    g = np.random.default_rng(5).standard_normal((32, 64)).astype(np.float32)
    jc, tc = _cfgs(calibrated=calibrated)

    def jloss(xx, ww):
        return jnp.sum(JOPS.crossbar_mac(xx, ww, KEY, jc, binarize) * g)

    gx_j, gw_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    (TOPS.crossbar_mac(xt, wt, TKEY, tc, binarize) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    if not calibrated:   # the clip mask of the physical path is live here
        assert (np.abs(w) > 1.0).any() and not wt.grad.numpy()[np.abs(w) > 1.0].any()


def test_crossbar_ste_keeps_bf16_weights():
    """The backward saves the bf16 parameter (no f32 copy) and returns a
    bf16 gradient, as jax's cast transposes to one."""
    x, w = _inputs(16, 64, 32, seed=6, scale=0.1)
    _, tc = _cfgs()
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    y = TOPS.crossbar_mac(xt, wt, TKEY, tc, binarize=True)
    saved = y.grad_fn.next_functions[0][0].saved_tensors   # past the reshape
    assert any(t.dtype == torch.bfloat16 and t.data_ptr() == wt.data_ptr() for t in saved)
    y.sum().backward()
    assert wt.grad.dtype == torch.bfloat16 and xt.grad.dtype == torch.float32
