"""Counter-based PRNG shared by the stochastic kernels
(``repro/kernels/prng.py``).

A stateless splitmix32-style hash of a uint32 element counter and a
uint32 seed: the same (seed, counter) pair gives the same bits in the
plain PyTorch path here and in the CUDA kernels (``csrc/prng.cuh``), which
is what makes kernel-vs-plain stochastic rounding bit-exact.

PyTorch on the CPU has no ``>>`` for ``torch.uint32``, so the plain path
holds uint32 values in int64 tensors and masks every result to 32 bits;
products are split so no intermediate leaves int64's range.  Seeds follow
the same convention everywhere in the port: an int64 tensor (or Python
int) holding a value in ``[0, 2**32)``.  ``gaussian`` matches the JAX
package to within an ulp or two (log and cos round differently across
frameworks); ``hash_u32`` and ``uniform`` match bit for bit.
"""

from __future__ import annotations

import torch

GOLDEN = 0x9E3779B9
M1 = 0x7FEB352D
M2 = 0x846CA68B
MASK = 0xFFFFFFFF
# f32(2π) exactly as the reference rounds it: jnp.float32(2.0 * 3.14159265358979)
TWO_PI_F32 = float(torch.tensor(2.0 * 3.14159265358979, dtype=torch.float32))


def mul32(x, c: int):
    """``x · c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a constant
    ``c`` in ``[0, 2**32)``, without leaving int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def hash_u32(x: torch.Tensor, seed) -> torch.Tensor:
    """splitmix32-style avalanche hash of uint32 counters ``x`` (int64)
    with a uint32 seed; returns uint32 values in int64."""
    x = (x + mul32(seed, GOLDEN)) & MASK
    x = mul32(x ^ (x >> 16), M1)
    x = mul32(x ^ (x >> 15), M2)
    return x ^ (x >> 16)


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) → f32 uniform in the open interval (0, 1): the
    top 24 bits plus a half-ulp offset, so ``log`` is always finite."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (1.0 / (1 << 25))


def uniform(idx: torch.Tensor, seed) -> torch.Tensor:
    """Uniform (0, 1) f32 per counter element."""
    return uniform01(hash_u32(idx, seed))


def gaussian(idx: torch.Tensor, seed) -> torch.Tensor:
    """Standard normal f32 per counter element (Box-Muller over two
    streams: the seed and the seed offset by the golden-ratio constant)."""
    u1 = uniform(idx, seed)
    u2 = uniform(idx, (seed + GOLDEN) & MASK)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(TWO_PI_F32 * u2)


def key_to_seed(key) -> int:
    """Fold a threefry key (``repro_torch.random``'s pair of uint32 ints)
    into a uint32 kernel seed: ``key[0]·golden + key[1] mod 2**32``, as
    ``repro/kernels/prng.py``'s ``key_to_seed`` folds jax's key data."""
    s = key[0]
    for word in key[1:]:
        s = (s * GOLDEN + word) & MASK
    return s
