"""The subset of ``jax.random`` the training path draws from, bit for bit.

jax's default PRNG is threefry2x32 with ``jax_threefry_partitionable``
(the default since jax 0.5): a key is two uint32 words, and

- ``PRNGKey(seed)`` is ``[0, seed]`` for a uint32 seed (jax's 32-bit mode);
- ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
- ``split(key, n)[i]`` hashes ``(hi(i), lo(i))``, the high and low words of
  the flat index, and keeps both output words as the new key;
- ``random_bits`` hashes ``(hi(i), lo(i))`` for every flat index ``i`` of
  the shape and returns the xor of the two output words;
- ``uniform`` puts the top 23 bits into the mantissa of a float in [1, 2)
  and subtracts 1; ``normal`` is ``√2 · erf_inv(u)`` for ``u`` uniform on
  ``[nextafter(−1, 0), 1)``, with XLA's f32 ``erf_inv``; ``randint``
  over a 32-bit span up to 2**16 draws two words a value, ``hi`` under
  ``split(key)[0]`` and ``lo`` under ``split(key)[1]``, and reduces
  ``((hi % span)·mult + lo % span) % span`` with ``mult = (2**16 %
  span)**2 % span``; for a power-of-two span ``mult`` is 0 and only
  ``lo``'s low bits count.

Because every counter is a flat index, a draw can be made in slices of
its flat range with identical bits (``start`` / ``count`` below), which
keeps large draws' temporaries bounded, and at any set of flat indices
(``index``): a rank's block of a sharded leaf, which is not contiguous in
flat order, draws the bits the whole draw has there (jax's threefry is
partitionable in the same way).

Keys are tuples of two Python ints.  :func:`threefry2x32` is written with
``+ ^ << >> &`` only, so the same code hashes host ints (key derivation:
no device work, no sync) and int64 tensors holding uint32 values (bulk
draws on the device; PyTorch on the CPU has no ``>>`` for uint32).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = tuple[int, int]
Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x1: Word, x2: Word) -> tuple[Word, Word]:
    """The threefry2x32 block function (20 rounds) on uint32 words: Python
    ints or int64 tensors with values in ``[0, 2**32)``."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def PRNGKey(seed: int) -> Key:  # noqa: N802  (jax's name)
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**32``."""
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return (0, seed)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    return threefry2x32(key[0], key[1], 0, data & MASK)


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(key, num)`` as a list of keys."""
    return [threefry2x32(key[0], key[1], i >> 32, i & MASK) for i in range(num)]


def random_bits(
    key: Key, shape: Sequence[int], device=None, *, start: int = 0, count: Optional[int] = None,
    index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values.  With
    ``count``, only the flat indices ``[start, start + count)`` of the draw,
    flattened; with ``index`` (an int64 tensor of flat indices), the draw's
    values there, in ``index``'s shape."""
    if index is None:
        n = math.prod(shape) if count is None else count
        idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    else:
        idx = index
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK)
    bits = b1 ^ b2
    return bits.reshape(tuple(shape)) if count is None and index is None else bits


def uniform(
    key: Key, shape: Sequence[int], device=None, minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.  XLA
    fuses ``f·(maxval − minval) + minval`` into one FMA; the port forms it
    in f64 (the f32 product is exact there) and rounds to f32, which equals
    the FMA except where the f64 sum sits exactly between two f32 values."""
    return uniform_from_bits(random_bits(key, shape, device), minval, maxval)


def uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """The f32 uniforms :func:`uniform` makes of ``random_bits``' values."""
    one = (bits >> 9) | 0x3F800000             # mantissa bits of a float in [1, 2)
    f = one.to(torch.int32).view(torch.float32) - 1.0
    lo = float(torch.tensor(minval, dtype=torch.float32))
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    return torch.clamp_min((f.double() * span + lo).float(), lo)


def randint(
    key: Key, shape: Sequence[int], minval: int, maxval: int, device=None,
    *, start: int = 0, count: Optional[int] = None, index: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for a 32-bit
    integer dtype (uint32 or int32: the same draw) as int64 values, for a
    span ``maxval - minval`` in ``[1, 2**16]``, where no product of jax's
    uint32 arithmetic wraps.  A power-of-two span draws only ``lo``.
    ``start`` / ``count`` / ``index`` select flat indices as in
    :func:`random_bits`."""
    span = maxval - minval
    if not 0 < span <= 1 << 16:
        raise NotImplementedError(f"randint is ported for spans in [1, 2**16], got {span}")
    k1, k2 = split(key)
    lo = random_bits(k2, shape, device, start=start, count=count, index=index)
    if span & (span - 1) == 0:
        return (lo & (span - 1)) + minval
    hi = random_bits(k1, shape, device, start=start, count=count, index=index)
    mult = (1 << 16) % span
    mult = mult * mult % span
    return ((hi % span) * mult + lo % span) % span + minval


# XLA's f32 erf_inv (Giles' single-precision approximation): with
# w = −log1p(−x²), a polynomial in w − 2.5 where w < 5, else in √w − 3,
# each written from the highest coefficient down.
ERFINV_W_LT_5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
ERFINV_W_GE_5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)
SQRT2_F32 = 1.4142135381698608   # f32(√2)
NORMAL_LO = -0.9999999403953552  # nextafter(−1, 0) in f32


def fma32(a: torch.Tensor, b: Union[torch.Tensor, float],
          c: Union[torch.Tensor, float]) -> torch.Tensor:
    """``a·b + c`` of f32 values (tensors, or f32-valued Python floats for
    ``b`` and ``c``) rounded once to f32, as XLA's FMA, formed in f64: the
    product is exact there, and the f64 sum rounds once more.  That double
    rounding can differ from the FMA's one rounding only where the f64 sum
    falls exactly halfway between two f32 values after a first rounding;
    on every value tested against jax it did not."""
    def f64(v):
        return v.double() if isinstance(v, torch.Tensor) else v

    return (a.double() * f64(b) + f64(c)).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` on f32: XLA's formula, each Horner step one
    rounding of ``c + p·w``, the square root correctly rounded (taken in
    f64), ±inf at ±1 and NaN beyond.  It equals XLA's bit for bit where
    ``log1p`` does: torch's and XLA's f32 ``log1p`` are both within an ulp
    or two of the true value but can round differently (on about a fifth
    of inputs in (−1, 1) for torch 2.13.0+cpu)."""
    x = x.float()
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, w.double().sqrt().float() - 3.0)
    lo = torch.tensor(ERFINV_W_LT_5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(ERFINV_W_GE_5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(ERFINV_W_LT_5)):
        p = fma32(p, w, torch.where(lt, lo[i], hi[i]))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(
    key: Key, shape: Sequence[int], device=None, *, start: int = 0, count: Optional[int] = None
) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``√2 · erf_inv(u)``, with
    ``u`` uniform on ``[nextafter(−1, 0), 1)``.  ``start`` / ``count`` slice
    the flat range as in :func:`random_bits`."""
    bits = random_bits(key, shape, device, start=start, count=count)
    u = uniform_from_bits(bits, NORMAL_LO, 1.0)
    return erf_inv(u) * SQRT2_F32
