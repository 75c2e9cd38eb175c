"""The port's counter PRNG, stochastic rounding and WTA vote counts against
the JAX reference.

Same numpy inputs and the same uint32 seeds go through ``repro`` and
``repro_torch``.  Tolerances, and why:

- ``hash_u32`` and ``uniform`` are integer arithmetic plus exact f32 steps:
  bit-equal.
- ``gaussian`` goes through log and cos, which round differently across
  frameworks: within 2e-6 absolute (observed max 9.5e-7 on 2**20 counters).
- stochastic rounding is bit-equal to the reference's jnp oracle (which is
  what its serving path runs off the TPU).  The interpret-mode Pallas
  kernel picks the same levels, but XLA's CPU backend contracts its
  ``q·step + lo`` into one FMA, so for ``step != 1`` its outputs may sit one
  f32 ulp of the grid's range away; at ``step == 1`` (the int8 KV path)
  they are bit-equal too.
- WTA counts draw Gaussians, so a trial can flip where two voltages race
  within an ulp: row sums must be equal (one vote per trial that fires) and
  Σ|Δcounts| at most 2 per flipped decision, with at most 1% of the B·T
  decisions flipped.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as JOPS
from repro.kernels import prng as JPRNG
from repro.kernels import ref as JREF
from repro.kernels.compat import interpret_mode
from repro.kernels.stoch_round import stoch_round_pallas
from repro.kernels.wta_kernel import wta_counts_pallas
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import prng as TPRNG
from repro_torch.kernels import ref as TREF

SEEDS = [0, 12345, 2**31, 2**32 - 1]
GAUSS_ATOL = 2e-6
WTA_FLIP_FRACTION = 0.01


def _i32(seed: int) -> np.ndarray:
    """A uint32 seed as the (1,) int32 SMEM operand the Pallas kernels take."""
    return np.asarray([seed], np.uint32).view(np.int32)


def _counters():
    idx = np.arange(1 << 14, dtype=np.uint32) * np.uint32(2654435761)
    idx[-3:] = [2**32 - 3, 2**32 - 2, 2**32 - 1]
    return idx


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_hash_and_uniform_bit_equal(seed):
    idx = _counters()
    t_idx = torch.from_numpy(idx.astype(np.int64))
    h_j = np.asarray(JPRNG.hash_u32(jnp.asarray(idx), jnp.uint32(seed)))
    np.testing.assert_array_equal(TPRNG.hash_u32(t_idx, seed).numpy(), h_j.astype(np.int64))
    u_j = np.asarray(JPRNG.uniform(jnp.asarray(idx), jnp.uint32(seed)))
    u_t = TPRNG.uniform(t_idx, torch.tensor(seed)).numpy()
    np.testing.assert_array_equal(u_t, u_j)
    assert u_t.min() > 0.0 and u_t.max() < 1.0


@pytest.mark.parametrize("seed", [7, 2**32 - 1])
def test_prng_gaussian_within_tolerance(seed):
    idx = _counters()
    g_j = np.asarray(JPRNG.gaussian(jnp.asarray(idx), jnp.uint32(seed)))
    g_t = TPRNG.gaussian(torch.from_numpy(idx.astype(np.int64)), seed).numpy()
    np.testing.assert_allclose(g_t, g_j, atol=GAUSS_ATOL, rtol=0)
    assert abs(g_t.mean()) < 0.05 and abs(g_t.std() - 1.0) < 0.05


def _sr_input(seed, shape, lo, hi):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.8 * hi).astype(np.float32)
    # clip and boundary values: below lo, at lo, at hi, above hi, grid points
    x.flat[:6] = [lo - 1.0, lo, hi, hi + 1.0, 0.0, lo + (hi - lo) / 2]
    return x


SR_CASES = [
    ((33, 70), 2.0 / 31, -1.0, 1.0),     # bench_kernels.py's quantizer grid
    ((16, 520), 2.0 / 31, -1.0, 1.0),    # over 512 columns: n_padded = 1024
    ((64, 80), 1.0, -127.0, 127.0),      # the int8 KV write
    ((5, 1030), 0.1, -1.0, 1.0),
]


@pytest.mark.parametrize("shape,step,lo,hi", SR_CASES)
def test_stoch_round_plain_bit_equal_to_oracle(shape, step, lo, hi):
    x = _sr_input(1, shape, lo, hi)
    n_pad = -(-shape[1] // 512) * 512
    xp = np.pad(x, ((0, 0), (0, n_pad - shape[1])))
    for seed in (3, 2**32 - 1):
        want = np.asarray(JREF.stoch_round_ref(
            jnp.asarray(xp), jnp.uint32(seed), step=step, lo=lo, hi=hi))[:, : shape[1]]
        got = TREF.stoch_round_ref(torch.from_numpy(x), seed, step=step, lo=lo, hi=hi)
        np.testing.assert_array_equal(got.numpy(), want)
        lv = (got.numpy() - lo) / np.float32(step)
        np.testing.assert_allclose(lv, np.round(lv), atol=1e-3)
        assert got.min() >= lo and got.max() <= hi


@pytest.mark.parametrize("shape,step,lo,hi", [SR_CASES[1], SR_CASES[2]])
def test_stoch_round_plain_matches_pallas_interpret(shape, step, lo, hi):
    x = _sr_input(2, shape, lo, hi)
    m_pad, n_pad = -(-shape[0] // 256) * 256, -(-shape[1] // 512) * 512
    xp = np.pad(x, ((0, m_pad - shape[0]), (0, n_pad - shape[1])))
    seed = 2**32 - 7
    pl = np.asarray(stoch_round_pallas(
        jnp.asarray(xp), jnp.asarray(_i32(seed)), step=step, lo=lo, hi=hi,
        interpret=interpret_mode(),
    ))[: shape[0], : shape[1]]
    got = TREF.stoch_round_ref(torch.from_numpy(x), seed, step=step, lo=lo, hi=hi).numpy()
    levels = lambda y: np.round((y - lo) / np.float32(step)).astype(np.int64)  # noqa: E731
    np.testing.assert_array_equal(levels(got), levels(pl))
    if step == 1.0:
        np.testing.assert_array_equal(got, pl)
    else:
        # one f32 ulp of the grid's range: the FMA rounds q·step + lo once
        ulp = float(np.spacing(np.float32(max(abs(lo), abs(hi)))))
        np.testing.assert_allclose(got, pl, rtol=0, atol=ulp)


def test_stoch_round_row_groups_match_per_group_calls():
    """G seeds split the rows into G groups, each one reference call whose
    counter restarts at row 0: the prefill chunk's one-launch form."""
    x = _sr_input(3, (4 * 24, 80), -127.0, 127.0)
    seeds = [5, 2**32 - 1, 77, 2**31 + 3]
    got = TOPS.stoch_round_serving(
        torch.from_numpy(x), torch.tensor(seeds), step=1.0, lo=-127.0, hi=127.0
    ).numpy()
    for g, seed in enumerate(seeds):
        want = np.asarray(JOPS.stoch_round_serving_sim(
            jnp.asarray(x[g * 24 : (g + 1) * 24]), jnp.uint32(seed),
            step=1.0, lo=-127.0, hi=127.0,
        ))
        np.testing.assert_array_equal(got[g * 24 : (g + 1) * 24], want)


@pytest.mark.parametrize("shape", [(3, 1, 4, 16), (8, 4, 80), (2, 5, 1, 4, 16)])
def test_quantize_kv_pair_equals_reference(shape):
    rng = np.random.default_rng(4)
    k = (rng.standard_normal(shape) * 3).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    v[0, ..., :] = 0.0                     # an all-zero row: scale floors at 1e-6
    for seed in (0, 2**32 - 2):
        want = JOPS.quantize_kv_pair_int8(jnp.asarray(k), jnp.asarray(v), jnp.uint32(seed))
        got = TOPS.quantize_kv_pair_int8(torch.from_numpy(k), torch.from_numpy(v), seed)
        for w, g in zip(want, got):
            assert g.dtype == (torch.int8 if w.dtype == jnp.int8 else torch.float32)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_quantize_kv_per_block_seeds_equal_reference_loop():
    """The prefill chunk's form: (nbc, bs, Hkv, Dh) blocks under (nbc,)
    seeds equal the reference's per-block loop."""
    rng = np.random.default_rng(5)
    kb = rng.standard_normal((3, 8, 4, 16)).astype(np.float32)
    vb = rng.standard_normal((3, 8, 4, 16)).astype(np.float32)
    seeds = np.asarray([11, 2**32 - 1, 2**31], np.uint32)
    got = TOPS.quantize_kv_pair_int8(
        torch.from_numpy(kb), torch.from_numpy(vb), torch.from_numpy(seeds.astype(np.int64))
    )
    for i in range(3):
        want = JOPS.quantize_kv_pair_int8(
            jnp.asarray(kb[i]), jnp.asarray(vb[i]), jnp.uint32(seeds[i])
        )
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def _wta_both(b, c, n_trials, seed, vth0=2.897, sigma=1.702, scale=2.0):
    z = (np.random.default_rng(c).standard_normal((b, c)) * scale).astype(np.float32)
    zp = np.pad(z, ((0, (-b) % 128), (0, (-c) % 128)))
    want = np.asarray(wta_counts_pallas(
        jnp.asarray(zp), jnp.asarray(_i32(seed)), n_trials=n_trials, vth0=vth0,
        sigma_z=sigma, valid_c=c, interpret=interpret_mode(),
    ))[:b, :c]
    got = TOPS.wta_counts(torch.from_numpy(z), seed, n_trials=n_trials,
                          vth0=vth0, sigma_z=sigma).numpy()
    return z, got, want


def _assert_wta_agree(got, want, b, n_trials):
    np.testing.assert_array_equal(got.sum(-1), want.sum(-1))
    assert np.abs(got - want).sum() <= 2 * WTA_FLIP_FRACTION * b * n_trials


@pytest.mark.parametrize("b,c,n_trials,seed", [
    (5, 300, 16, 99),          # B and C off the 128 grid
    (3, 8200, 3, 2**32 - 1),   # c_pad 8320: the trial stride wraps 2**32
])
def test_wta_counts_plain_matches_pallas_interpret(b, c, n_trials, seed):
    z, got, want = _wta_both(b, c, n_trials, seed)
    _assert_wta_agree(got, want, b, n_trials)
    assert got.sum() > 0 and got.max() <= n_trials


def test_wta_counts_reference_wrapper_and_lead_dims():
    """ops.wta_counts over (..., C) equals the flattened call, and the
    reference Sim wrapper's padding rules give the same counts."""
    z = np.random.default_rng(9).standard_normal((2, 3, 130)).astype(np.float32) * 2
    got = TOPS.wta_counts(torch.from_numpy(z), 41, n_trials=8, vth0=1.0, sigma_z=1.0)
    flat = TOPS.wta_counts(torch.from_numpy(z.reshape(6, 130)), 41, n_trials=8,
                           vth0=1.0, sigma_z=1.0)
    assert got.shape == (2, 3, 130)
    assert torch.equal(got.reshape(6, 130), flat)
    want = np.asarray(JREF.wta_counts_ref(
        jnp.asarray(np.pad(z.reshape(6, 130), ((0, 122), (0, 126)))), jnp.uint32(41),
        n_trials=8, vth0=1.0, sigma_z=1.0, valid_c=130,
    ))[:6, :130]
    _assert_wta_agree(flat.numpy(), want, 6, 8)
