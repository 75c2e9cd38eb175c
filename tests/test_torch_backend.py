"""The port's device-backend seam (``repro_torch.kernels.backend``) against
``repro.kernels.backend``, on the CPU: the registry and the scoped
install, the zero-knob identity of ``sim_faulty`` with ``sim``, the
canary, and the fault model's host state (stuck masks, the drift clock,
degrade/recover, tile retirement), which is host numpy and Python floats
on both sides and must be equal exactly.

Tolerances where f32 tensor arithmetic meets:

- faulty weights against the reference's *jitted* ``_faulty_weights``
  (what its engine traces): XLA fuses ``g0·w + g_ref`` and may multiply by
  the reciprocal of ``g0``, the port rounds op by op (ROADMAP C).  Each of
  those roundings is an ulp of the conductance (≈ 1e-4 S), which is
  ≈ 6e-12 S, or 1.2e-7 in normalized weight units after the division by
  G0 = 4.95e-5; ``WEIGHT_ULPS`` allows 4 such ulps times max|w| (1.48e-7
  times max|w| measured here).  Against the reference's eager ops (one
  rounding each, as the port) they are equal.  Stuck cells are exactly
  ±max|w| on both sides.
- the faulty crossbar read: ``tests/test_torch_crossbar.py``'s gates
  (linear atol 2e-5, rtol 1e-5; comparator decisions > 99.95% equal).
- the faulty WTA counts: ``tests/test_torch_stochastic.py``'s rule (vote
  sums equal, Σ|Δcounts| ≤ 2 % of B·T).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analog import AnalogConfig as JAnalog
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.kernels import backend as JBK
from repro.kernels import ops as JOPS
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.kernels import backend as BK
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import prng as TPRNG

KEY = jax.random.PRNGKey(42)
TKEY = tuple(int(w) for w in np.asarray(jax.random.key_data(KEY)))
LIN_ATOL, LIN_RTOL = 2e-5, 1e-5
AGREEMENT = 0.9995
WTA_FLIP_FRACTION = 0.01
WEIGHT_ULPS = 4 * 1.2e-7


def _inputs(m, k, n, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * scale).astype(np.float32)
    return x, w


def _faulty(**kw):
    return (JBK.make_backend("sim_faulty", fault=JBK.FaultConfig(**kw)),
            BK.make_backend("sim_faulty", fault=BK.FaultConfig(**kw)))


# ---------------------------------------------------------------------------
# Registry and scoped install
# ---------------------------------------------------------------------------


def test_make_backend_unknown_name_is_loud():
    with pytest.raises(ValueError, match="unknown device backend 'phys'") as e:
        BK.make_backend("phys")
    assert all(name in str(e.value) for name in BK.BACKENDS)
    assert sorted(BK.BACKENDS) == sorted(JBK.BACKENDS)


def test_make_backend_without_model_cfg():
    """model_cfg=None: zeroed shape counts; note_call still tallies tokens."""
    bk = BK.make_backend("sim")
    bk.note_call({"prefill": 3, "decode": 2, "draft": 0, "samples": 2,
                  "kv_tokens": 5, "redundant": 1})
    snap = bk.snapshot(published_tokens=0)
    assert snap["tokens_computed"]["total"] == 5
    assert snap["redundant_read_events"] == 1
    assert all(v == 0 for v in snap["counts"].values())
    assert snap["raca"]["energy_pj_per_token"] == snap["raca"]["energy_pj_gross"]


def test_default_backend_is_sim():
    assert type(BK.get_backend()) is BK.SimBackend


def test_use_backend_restores_on_exception():
    prev = BK.get_backend()
    faulty = BK.make_backend("sim_faulty")
    with pytest.raises(RuntimeError, match="boom"):
        with BK.use_backend(faulty):
            assert BK.get_backend() is faulty
            raise RuntimeError("boom")
    assert BK.get_backend() is prev


def test_use_backend_nests():
    prev = BK.get_backend()
    a, b = BK.make_backend("sim"), BK.make_backend("sim_faulty")
    with BK.use_backend(a):
        with BK.use_backend(b):
            assert BK.get_backend() is b
        assert BK.get_backend() is a
    assert BK.get_backend() is prev


def test_wrappers_look_the_backend_up_when_called():
    """A wrapper asks for the backend at call time: a backend installed
    after the wrapper was first called takes the next call."""
    x, w = _inputs(2, 32, 8)
    cfg = TAnalog(mode="analog_linear", quantize=False)
    calls = []

    class Recording(BK.SimBackend):
        def crossbar_mac(self, *a, **kw):
            calls.append(a[1].shape)
            return super().crossbar_mac(*a, **kw)

    TOPS.crossbar_mac(torch.from_numpy(x), torch.from_numpy(w), TKEY, cfg, binarize=False)
    with BK.use_backend(Recording()):
        TOPS.crossbar_mac(torch.from_numpy(x), torch.from_numpy(w), TKEY, cfg, binarize=False)
    assert calls == [(32, 8)]


# ---------------------------------------------------------------------------
# Zero-knob identity, per public op
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("binarize", [True, False])
def test_zero_knob_crossbar_mac_bit_identical(binarize):
    x, w = _inputs(4, 64, 16, seed=1, scale=1.0)
    cfg = (TAnalog(mode="analog_stochastic") if binarize
           else TAnalog(mode="analog_linear", quantize=False))
    args = (torch.from_numpy(x), torch.from_numpy(w), TKEY, cfg)
    want = TOPS.crossbar_mac(*args, binarize=binarize)
    with BK.use_backend(BK.make_backend("sim_faulty", fault=BK.FaultConfig())):
        got = TOPS.crossbar_mac(*args, binarize=binarize)
    assert torch.equal(got, want)


def test_zero_knob_wta_counts_bit_identical():
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 300)).astype(np.float32))
    want = TOPS.wta_counts(z, 5, n_trials=8, vth0=0.5, sigma_z=1.0)
    with BK.use_backend(BK.make_backend("sim_faulty")):
        got = TOPS.wta_counts(z, 5, n_trials=8, vth0=0.5, sigma_z=1.0)
    assert torch.equal(got, want)


def test_zero_knob_stoch_round_serving_bit_identical():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 80)).astype(np.float32))
    want = TOPS.stoch_round_serving(x, 7, step=0.125, lo=-16.0, hi=15.875)
    with BK.use_backend(BK.make_backend("sim_faulty")):
        got = TOPS.stoch_round_serving(x, 7, step=0.125, lo=-16.0, hi=15.875)
    assert torch.equal(got, want)


def test_zero_knob_paged_attention_bit_identical():
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((6, 8, 2, 16)).astype(np.float32))
              for _ in range(2))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([9, 12], dtype=torch.int32)
    want = TOPS.paged_attention(q, kp, vp, table, pos)
    pre = TOPS.paged_prefill_attention(q, kp, vp, table[0], 3)
    with BK.use_backend(BK.make_backend("sim_faulty")):
        assert torch.equal(TOPS.paged_attention(q, kp, vp, table, pos), want)
        assert torch.equal(TOPS.paged_prefill_attention(q, kp, vp, table[0], 3), pre)


def test_zero_knob_wta_readout_params_identity():
    assert BK.make_backend("sim_faulty").wta_readout_params(0.5, 1.702) == (0.5, 1.702)
    assert BK.make_backend("sim").wta_readout_params(0.5, 1.702) == (0.5, 1.702)


def test_zero_knob_canary_passes_and_matches_reference():
    exp = TOPS.canary_expected()
    assert np.array_equal(exp, JOPS.canary_expected())
    with BK.use_backend(BK.make_backend("sim_faulty")):
        got = TOPS.canary_mac(TKEY, "cpu").numpy()
    rel = float(np.max(np.abs(got - exp))) / float(np.max(np.abs(exp)))
    assert rel < 0.05
    want = np.asarray(JOPS.canary_mac(KEY), np.float32)
    np.testing.assert_allclose(got, want, atol=LIN_ATOL, rtol=LIN_RTOL)


@pytest.mark.parametrize("knob", [{"comparator_offset": 3.0}, {"read_sigma_inflation": 20.0}])
def test_canary_fails_as_the_reference_under_a_degraded_readout(knob):
    """A comparator offset of 3 (or a 21× noise sigma) moves the canary's
    read past the 5% threshold, in both packages."""
    jb, tb = _faulty()
    jb.degrade(**knob)
    tb.degrade(**knob)
    exp = TOPS.canary_expected()
    with BK.use_backend(tb):
        got = TOPS.canary_mac(TKEY, "cpu").numpy()
    with JBK.use_backend(jb):
        want = np.asarray(JOPS.canary_mac(KEY), np.float32)
    rel = [float(np.max(np.abs(v - exp))) / float(np.max(np.abs(exp))) for v in (got, want)]
    assert rel[0] > 0.05 and rel[1] > 0.05
    np.testing.assert_allclose(got, want, atol=LIN_ATOL, rtol=LIN_RTOL)


# ---------------------------------------------------------------------------
# Fault model host state: equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 64), (64, 64), (300, 17), (2560, 256)])
@pytest.mark.parametrize("seed,rate", [(0, 0.05), (9, 0.05), (3, 1e-3)])
def test_stuck_masks_equal_reference(shape, seed, rate):
    jb, tb = _faulty(seed=seed, stuck_rate=rate)
    (j0, j1), (t0, t1) = jb._stuck_masks(shape), tb._stuck_masks(shape)
    assert np.array_equal(t0, j0) and np.array_equal(t1, j1)
    assert not np.any(t0 & t1)
    assert tb.stuck_cell_count() == jb.stuck_cell_count()
    assert tb._stuck_masks((4, 4, 4)) == (None, None)


def test_stuck_masks_move_to_the_device_once():
    _, tb = _faulty(stuck_rate=0.05)
    a = tb._device_masks((64, 32), torch.device("cpu"))
    assert tb._device_masks((64, 32), torch.device("cpu")) is a
    assert torch.equal(a[0], torch.from_numpy(tb._stuck_masks((64, 32))[0]))
    tb.retire_tiles(1e-3)
    b = tb._device_masks((64, 32), torch.device("cpu"))
    assert b is not a and not b[0].any() and not b[1].any()


@pytest.mark.parametrize("nu,quant", [(0.1, 0.02), (0.3, 0.02), (0.05, 0.0), (0.1, 0.1)])
def test_drift_versions_over_50_ticks_equal_reference(nu, quant):
    jb, tb = _faulty(drift_nu=nu, drift_quant=quant)
    for _ in range(50):
        jb.advance_clock(1)
        tb.advance_clock(1)
        assert tb.fault_state() == jb.fault_state()
    assert tb.fault_version > 0
    jb.advance_clock(7)
    tb.advance_clock(7)
    assert tb.fault_state() == jb.fault_state()


def test_degrade_and_recover_equal_reference():
    jb, tb = _faulty(drift_nu=0.1)
    for bk in (jb, tb):
        bk.advance_clock(3)
        bk.degrade(comparator_offset=0.3, read_sigma_inflation=0.5)
    assert tb.fault_state() == jb.fault_state()
    assert tb.wta_readout_params(0.5, 1.0) == jb.wta_readout_params(0.5, 1.0)
    assert tb.wta_readout_params(0.5, 1.0) == pytest.approx((0.8, 1.5))
    for bk in (jb, tb):
        bk.degrade(clock=400, drift_nu=0.2)
    assert tb.fault_state() == jb.fault_state()
    for bk in (jb, tb):
        bk.recover()
    assert tb.fault_state() == jb.fault_state()
    assert tb.wta_readout_params(0.5, 1.0) == (0.5, 1.0)
    with pytest.raises(ValueError, match="unknown knob"):
        tb.degrade(stuck_rate=0.5)


@pytest.mark.parametrize("rate,tile,threshold", [(0.04, 32, 0.01), (0.01, 128, 0.5),
                                                 (0.02, 16, 0.03), (0.05, 64, 0.05)])
def test_retirement_counts_equal_reference(rate, tile, threshold):
    jb, tb = _faulty(stuck_rate=rate, tile_rows=tile, tile_cols=tile)
    for bk in (jb, tb):
        bk._stuck_masks((64, 64))
        bk._stuck_masks((200, 96))
    n = tb.retire_tiles(threshold)
    assert n == jb.retire_tiles(threshold)
    assert tb.fault_state() == jb.fault_state()
    for bk in (jb, tb):
        bk.recover()
    assert tb.retired_tiles == jb.retired_tiles == n   # one-way
    assert tb.retire_tiles(threshold) == jb.retire_tiles(threshold) == 0


# ---------------------------------------------------------------------------
# Faulty compute against the reference
# ---------------------------------------------------------------------------

FAULTS = {
    "stuck": dict(stuck_rate=0.05),
    "drift": dict(drift_nu=0.1),
    "stuck_drift": dict(stuck_rate=1e-3, drift_nu=0.3, seed=5),
}


def _clocked(knobs):
    jb, tb = _faulty(**knobs)
    for bk in (jb, tb):
        bk.advance_clock(100)
    return jb, tb


@pytest.mark.parametrize("fault", FAULTS)
def test_faulty_weights_match_reference(fault):
    jb, tb = _clocked(FAULTS[fault])
    _, w = _inputs(1, 256, 96, seed=3, scale=0.1)
    got = tb._faulty_weights(torch.from_numpy(w)).numpy()
    eager = np.asarray(jb._faulty_weights(jnp.asarray(w)))
    jitted = np.asarray(jax.jit(jb._faulty_weights)(jnp.asarray(w)))
    assert np.array_equal(got, eager)
    s = float(np.abs(w).max())
    np.testing.assert_allclose(got, jitted, rtol=0, atol=WEIGHT_ULPS * s)
    if "stuck" in fault:
        sa0, sa1 = tb._stuck_masks(w.shape)
        assert (got[sa0] == -s).all() and (got[sa1] == s).all()
        assert (jitted[sa0] == -s).all() and (jitted[sa1] == s).all()
    if "drift" in fault:
        assert tb.fault_state()["drift_mult"] < 1.0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("binarize", [False, True], ids=["linear", "comparator"])
def test_faulty_crossbar_read_matches_reference(fault, binarize):
    """The read through each package's fault backend, at the reference's
    ``use_pallas="on"`` (its Pallas kernel in interpret mode here)."""
    jb, tb = _clocked(dict(FAULTS[fault], read_sigma_inflation=0.2, comparator_offset=0.5))
    x, w = _inputs(64, 256, 96, seed=4)
    mode = "analog_stochastic" if binarize else "analog_linear"
    jc = JAnalog(mode=mode, device=j_calibrate(JDevice(), 256), use_pallas="on")
    tc = TAnalog(mode=mode, device=t_calibrate(TDevice(), 256))
    with JBK.use_backend(jb):
        want = np.asarray(JOPS.crossbar_mac(jnp.asarray(x), jnp.asarray(w), KEY, jc,
                                            binarize=binarize))
    with BK.use_backend(tb):
        got = TOPS.crossbar_mac(torch.from_numpy(x), torch.from_numpy(w), TKEY, tc,
                                binarize=binarize).numpy()
    healthy = TOPS.crossbar_mac(torch.from_numpy(x), torch.from_numpy(w), TKEY, tc,
                                binarize=binarize).numpy()
    assert not np.array_equal(got, healthy)
    if binarize:
        assert float((got == want).mean()) > AGREEMENT
    else:
        np.testing.assert_allclose(got, want, atol=LIN_ATOL, rtol=LIN_RTOL)


def test_faulty_wta_counts_shift_the_operating_point():
    """``wta_counts`` through the fault backend is the plain call at the
    shifted (vth0 + offset, σ·(1 + i)), exactly, and agrees with the
    reference's faulty call by its vote rule."""
    jb, tb = _faulty(comparator_offset=0.5, read_sigma_inflation=0.2)
    z = (np.random.default_rng(2).standard_normal((5, 300)) * 2.0).astype(np.float32)
    seed = TPRNG.key_to_seed(TKEY)
    kw = dict(n_trials=16, vth0=2.897, sigma_z=1.702)
    with BK.use_backend(tb):
        got = TOPS.wta_counts(torch.from_numpy(z), seed, **kw)
    shifted = TOPS.wta_counts_sim(torch.from_numpy(z), seed, n_trials=16,
                                  vth0=2.897 + 0.5, sigma_z=1.702 * 1.2)
    assert torch.equal(got, shifted)
    assert not torch.equal(got, TOPS.wta_counts(torch.from_numpy(z), seed, **kw))
    with JBK.use_backend(jb):
        want = np.asarray(JOPS.wta_counts(jnp.asarray(z), KEY, **kw))
    got = got.numpy()
    np.testing.assert_array_equal(got.sum(-1), want.sum(-1))
    assert np.abs(got - want).sum() <= 2 * WTA_FLIP_FRACTION * 5 * 16


def test_faulty_read_keeps_the_ste_gradient():
    """Stuck cells pass no gradient to their weight (they are constants),
    as ``jnp.where`` passes none in the reference."""
    _, tb = _clocked(dict(stuck_rate=0.05))
    x, w = _inputs(8, 128, 32, seed=6)
    wt = torch.from_numpy(w).requires_grad_(True)
    tc = TAnalog(mode="analog_linear", device=t_calibrate(TDevice(), 128))
    with BK.use_backend(tb):
        TOPS.crossbar_mac(torch.from_numpy(x), wt, TKEY, tc, binarize=False).sum().backward()
    sa0, sa1 = tb._stuck_masks(w.shape)
    g = wt.grad.numpy()
    assert (g[sa0 | sa1] == 0).all() and np.abs(g[~(sa0 | sa1)]).sum() > 0


def test_configs_carry_the_same_readout_knobs():
    """The inflation rewrites fields both configs have."""
    names = {f.name for f in dataclasses.fields(TAnalog)}
    assert {"beta", "linear_sigma", "calibrated", "device"} <= names
    assert {f.name for f in dataclasses.fields(BK.FaultConfig)} == {
        f.name for f in dataclasses.fields(JBK.FaultConfig)}
