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


# ---------------------------------------------------------------------------
# The tensor-core kernel's arithmetic, in plain PyTorch.
#
# The card runs the read in the level domain: x split into three bf16
# pieces, W quantized into centered integer levels C, per 64-column
# k-slice the pieces' products with C, slices summed in f32, then
# z = qstep·acc + c0·Σx (``ref.crossbar_level_read``).  These tests hold
# that arithmetic to the gates ``chip_smoke.py`` applies to the kernel:
# linear readout within 2·sqrt(K)·2**-24·Σ|x·Wq| of the plain version (plus
# 1e-5 relative with the physical noise model), comparator readout with at
# least 99.95% of the decisions equal.
# ---------------------------------------------------------------------------

from repro_torch.kernels import crossbar_mac as TCB  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402


def _card_case(m, k, n, binarize, physical=False, seed=0):
    """chip_smoke.py's construction: x normal, W a bf16 N(0, 1/K) weight
    divided by its range scale (×1.2 past the clip range on the physical
    path), σ the calibrated comparator's 1.702 / s or 0.01."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, n)) * k**-0.5).astype(np.float32))
    w = w.to(torch.bfloat16).float()
    s = TOPS.range_scale(w)
    w = w / s * (1.2 if physical else 1.0)
    sigma = torch.tensor(1.702) / s if binarize else torch.tensor(0.01)
    dp = t_calibrate(TDevice(), k)
    kw = dict(binarize=binarize, physical_noise=physical, noise_params=TOPS._noise_params(dp, k),
              qstep=TOPS._qstep(dp), w_min=dp.w_min, w_max=dp.w_max)
    return x, w, 0xBEEF + seed, sigma.float(), kw


def _linear_worst(x, w, got, want, kw):
    wq = TREF.crossbar_quantize(w, kw["qstep"], kw["w_min"], kw["w_max"])
    tol = 2 * x.shape[1] ** 0.5 * 2.0**-24 * (x.abs() @ wq.abs())
    if kw["physical_noise"]:
        tol = tol + 1e-5 * want.abs()
    return float(((got - want).abs() / tol).max())


@pytest.mark.parametrize("binarize", [False, True])
@pytest.mark.parametrize("m,k,n,physical", [
    (257, 513, 129, False), (192, 640, 200, True), (64, 640, 256, False),
])
def test_level_domain_read_passes_the_card_gates(m, k, n, physical, binarize):
    x, w, seed, sigma, kw = _card_case(m, k, n, binarize, physical)
    got = TREF.crossbar_level_read(x, w, seed, sigma, **kw)
    want = TREF.crossbar_mac_ref(x, w, seed, sigma, **kw)
    if binarize:
        assert float((got == want).float().mean()) >= AGREEMENT
    else:
        assert _linear_worst(x, w, got, want, kw) <= 1.0


def test_one_bf16_pass_fails_the_linear_gate():
    """Why the kernel splits x: one bf16 pass (8 bits of x) misses the
    linear gate by orders of magnitude, two bf16 or TF32 pieces do not."""
    x, w, seed, sigma, kw = _card_case(257, 513, 129, False)
    want = TREF.crossbar_mac_ref(x, w, seed, sigma, **kw)
    worst = {
        (p, f): _linear_worst(x, w, TREF.crossbar_level_read(x, w, seed, sigma, pieces=p, fmt=f, **kw),
                              want, kw)
        for p, f in ((1, "bf16"), (1, "tf32"), (2, "bf16"), (3, "bf16"))
    }
    assert worst[(1, "bf16")] > 10.0 and worst[(1, "tf32")] > 1.0
    assert worst[(3, "bf16")] <= worst[(2, "bf16")] <= 1.0


@pytest.mark.parametrize("physical", [False, True])
def test_level_domain_valid_k_contributes_nothing_past_k(physical):
    """K = 100 pads to the 128-column slice grid: the pieces and the levels
    are zero past K (not the level of w_min), so padded rows add nothing to
    z or to ΣW_q; the levels rebuild Wq, the pieces rebuild x."""
    x, w, seed, sigma, kw = _card_case(33, 100, 70, False, physical)
    q = (kw["qstep"], kw["w_min"], kw["w_max"])
    xs, rowsum, ct, colsum = TREF.crossbar_prepass_ref(x, w, *q)
    assert xs.shape == (3, 33, 128) and ct.shape == (70, 128)
    assert not xs[:, :, 100:].any() and not ct[:, 100:].any()
    assert torch.equal(xs.sum(0)[:, :100], x)
    center = TREF.level_center(*q)
    wq = TREF.crossbar_quantize(w, *q)
    torch.testing.assert_close(kw["qstep"] * (ct[:, :100].T + center) + kw["w_min"], wq,
                               atol=2e-7, rtol=0)
    sum_wq = kw["qstep"] * colsum.float() + (kw["w_min"] + center * kw["qstep"]) * 100
    torch.testing.assert_close(sum_wq, wq.sum(0), atol=1e-5, rtol=1e-6)
    got = TREF.crossbar_gemm_ref(xs, rowsum, ct, colsum, 100, seed, sigma, **kw)
    want = TREF.crossbar_mac_ref(x, w, seed, sigma, **kw)
    assert _linear_worst(x, w, got, want, kw) <= 1.0


def test_split_pieces_are_exact():
    """Three bf16 pieces hold every f32 exactly (8 + 8 + 8 bits); one TF32
    piece keeps 10 mantissa bits."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(4096).astype(np.float32) * 7)
    p = TREF.split_pieces(x, 3, "bf16")
    assert torch.equal(p[0] + p[1] + p[2], x)
    assert all(torch.equal(t, t.to(torch.bfloat16).float()) for t in p)
    t = TREF.split_pieces(x, 1, "tf32")[0]
    assert not (t.view(torch.int32) & 0x1FFF).any()
    assert float(((t - x).abs() / x.abs()).max()) <= 2.0**-11


def test_crossbar_tile_geometry():
    """128 × 64 tiles on every read (the width the tile sweep chose); every
    output column and row is covered; the sweep's override takes only
    compiled widths."""
    for m, k, n in ((1024, 2560, 2560), (1024, 2560, 6912), (1024, 6912, 2560), (257, 513, 129)):
        geo = TCB.crossbar_geometry(m, k, n)
        assert geo["tile_n"] == TCB.TILE_N == 64
        assert geo["kp"] % 64 == 0 and 0 <= geo["kp"] - k < 64
        for tn in TCB.TILE_NS:
            gx, gy = TCB.crossbar_geometry(m, k, n, tile_n=tn)["grid"]
            assert gx * tn >= n > (gx - 1) * tn
            assert gy * TCB.BM >= m > (gy - 1) * TCB.BM
    with pytest.raises(ValueError):
        TCB.crossbar_geometry(64, 64, 64, tile_n=80)
    with pytest.raises(ValueError):
        TREF.level_center(1e-3, -1.0, 1.0)   # 2001 levels: |C| past bf16's exact integers


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("binarize", [False, True])
def test_level_domain_read_matches_reference(m, k, n, binarize):
    """The kernel's arithmetic through the port's own normalization and
    seed pipeline against the reference's Pallas kernel (interpret mode),
    under this file's tolerances."""
    x, w = _inputs(m, k, n)
    jc, tc = _cfgs()
    yj = np.asarray(JOPS.crossbar_mac(jnp.asarray(x), jnp.asarray(w), KEY, jc, binarize=binarize))
    from repro_torch.kernels import prng as TPRNG

    yt = TOPS._crossbar_forward(torch.from_numpy(x), torch.from_numpy(w), TPRNG.key_to_seed(TKEY),
                                tc, binarize, TREF.crossbar_level_read).numpy()
    if binarize:
        assert float((yj == yt).mean()) > AGREEMENT
    else:
        np.testing.assert_allclose(yt, yj, atol=LIN_ATOL, rtol=LIN_RTOL)
