"""The port's threefry (``repro_torch.random``) against ``jax.random``.

Every function is integer arithmetic plus an exact f32 step, so every
comparison is bit for bit (``np.array_equal``), over several keys and
shapes, including draws whose flat index passes 2**32 (the counter's high
word), and draws made in slices of the flat range.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import prng as JPRNG
from repro_torch import random as R
from repro_torch.kernels import prng as TPRNG

SEEDS = [0, 1, 42, 2**31 - 1]


def _key(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k), np.uint32)


def _pair(k) -> tuple[int, int]:
    a = _key(k)
    return int(a[0]), int(a[1])


def test_jax_uses_partitionable_threefry():
    """The port reproduces jax's default PRNG: threefry2x32, partitionable."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS + [2**31 + 5, 2**32 - 1])
def test_prngkey(seed):
    assert R.PRNGKey(seed) == _pair(jax.random.PRNGKey(seed))
    with pytest.raises(ValueError):
        R.PRNGKey(2**32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 13, 2**31 + 3, 2**32 - 1])
def test_fold_in(seed, data):
    key = jax.random.PRNGKey(seed)
    assert R.fold_in(R.PRNGKey(seed), data) == _pair(jax.random.fold_in(key, np.uint32(data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split(seed, num):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    got = R.split(R.fold_in(R.PRNGKey(seed), 3), num)
    want = [_pair(k) for k in jax.random.split(key, num)]
    assert got == want


def test_threefry_on_tensors_matches_ints():
    """The block function gives the same words on int64 tensors as on
    Python ints (the same code serves keys and bulk draws)."""
    x1 = torch.tensor([0, 1, 2**32 - 1, 12345], dtype=torch.int64)
    x2 = torch.tensor([0, 2**31, 7, 2**32 - 2], dtype=torch.int64)
    y1, y2 = R.threefry2x32(0x12345678, 0x9ABCDEF0, x1, x2)
    for i in range(4):
        assert R.threefry2x32(0x12345678, 0x9ABCDEF0, int(x1[i]), int(x2[i])) == (int(y1[i]), int(y2[i]))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 129)])
def test_random_bits(seed, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 11)
    want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    got = R.random_bits(_pair(key), shape).numpy()
    assert got.shape == shape
    assert np.array_equal(got.astype(np.uint32), want)


def test_random_bits_past_2_pow_32_and_in_slices():
    """A draw's counters are the high and low words of the flat index
    (``iota_2x32_shape``): past 2**32 elements the high word counts up.
    jax cannot materialise such a draw here, so the port's slice past
    2**32 is held against jax's threefry primitive on the same counter
    words; and slicing a draw never changes a bit."""
    from jax._src import prng as jprng

    key = _pair(jax.random.PRNGKey(3))
    start = 2**32 - 5
    idx = np.arange(start, start + 10, dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = jprng.threefry2x32_p.bind(
        jnp.uint32(key[0]), jnp.uint32(key[1]), jnp.asarray(hi), jnp.asarray(lo))
    want = np.asarray(b1) ^ np.asarray(b2)
    got = R.random_bits(key, (2**33,), start=start, count=10).numpy().astype(np.uint32)
    assert hi[0] == 0 and hi[-1] == 1 and np.array_equal(got, want)
    # the counter words jax builds for a shape are the flat index's
    chi, clo = jprng.iota_2x32_shape((3, 7))
    assert not np.asarray(chi).any() and np.array_equal(np.asarray(clo).reshape(-1), np.arange(21))
    whole = R.random_bits(key, (64,)).numpy()
    parts = np.concatenate([R.random_bits(key, (64,), start=a, count=16).numpy()
                            for a in range(0, 64, 16)])
    assert np.array_equal(whole, parts)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,lo,hi", [((4, 33), 0.0, 1.0), ((1000,), -2.0, 3.0)])
def test_uniform(seed, shape, lo, hi):
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    want = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi))
    got = R.uniform(_pair(key), shape, minval=lo, maxval=hi).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(5,), (3, 517)])
def test_randint_u16(seed, shape):
    """AdamW's rounding noise: randint(0, 2**16) in uint32, the low 16 bits
    of the second split key's bits (jax's multiplier is 0 for this span)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 9)
    want = np.asarray(jax.random.randint(key, shape, 0, 1 << 16, dtype=jnp.uint32))
    got = R.randint(_pair(key), shape, 0, 1 << 16).numpy()
    assert np.array_equal(got.astype(np.uint32), want)
    n = int(np.prod(shape))
    part = R.randint(_pair(key), shape, 0, 1 << 16, start=n // 3, count=n - n // 3).numpy()
    assert np.array_equal(part.astype(np.uint32), want.reshape(-1)[n // 3 :])
    with pytest.raises(NotImplementedError):   # jax's uint32 products would wrap
        R.randint(_pair(key), shape, 0, (1 << 16) + 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_to_seed(seed):
    for key in (jax.random.PRNGKey(seed), jax.random.fold_in(jax.random.PRNGKey(seed), 5)):
        want = int(np.asarray(JPRNG.key_to_seed(key)).astype(np.uint32))
        assert TPRNG.key_to_seed(_pair(key)) == want
