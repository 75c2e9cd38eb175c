"""jax's threefry2x32 key derivation and ``normal`` draw, frozen from the
port's ``repro_torch/random.py`` so that the reference works out each
request's sampler noise itself: a key is two uint32 words, held as Python
ints or in int64 tensors; ``PRNGKey(seed)`` is ``(0, seed)``,
``fold_in(key, d)`` hashes ``(0, d)``, and ``normal`` is ``√2·erf_inv(u)``
for ``u`` uniform on ``[nextafter(−1, 0), 1)`` with XLA's f32 ``erf_inv``."""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
SQRT2_F32 = 1.4142135381698608
NORMAL_LO = -0.9999999403953552
ERFINV_W_LT_5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
ERFINV_W_GE_5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """20 rounds on uint32 words (Python ints or int64 tensors)."""
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


def prng_key(seed: int) -> tuple[int, int]:
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return (0, seed)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    return threefry2x32(key[0], key[1], 0, data & MASK)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return (a.double() * b.double() + c.double()).float()


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, w.double().sqrt().float() - 3.0)
    lo = torch.tensor(ERFINV_W_LT_5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(ERFINV_W_GE_5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(ERFINV_W_LT_5)):
        p = _fma32(p, w, torch.where(lt, lo[i], hi[i]))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal_at(k1: torch.Tensor, k2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f32 ``normal`` at flat counters ``idx`` under keys ``(k1, k2)``
    (int64 tensors broadcast against ``idx``)."""
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    bits = b1 ^ b2
    one = (bits >> 9) | 0x3F800000
    f = one.to(torch.int32).view(torch.float32) - 1.0
    lo = float(torch.tensor(NORMAL_LO, dtype=torch.float32))
    span = float(torch.tensor(1.0, dtype=torch.float32) - lo)
    u = torch.clamp_min((f.double() * span + lo).float(), lo)
    return erf_inv(u) * SQRT2_F32
