"""Stochastic rounding: the CUDA kernel's wrapper and its plain version.

Replaces ``stoch_round_pallas`` (``repro/kernels/stoch_round.py``), the
paper's conductance-programming primitive (§II-B) that the int8 KV pool
applies to every cache write.  The kernel (``csrc/stoch_round.cu``) runs
one thread per element and reads its seeds from device memory, so a
serving step never waits on the host for them.  Its plain PyTorch version
is :func:`stoch_round_ref`; ``ops.stoch_round_serving`` sends CPU tensors
there and CUDA tensors here.  ``launches`` counts kernel launches (nothing
else adds to it).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import stoch_round_ref  # noqa: F401  (the plain version)

launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("stoch_round")
    fn = lib.stoch_round_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P]
        fn.restype = _I
    return fn


def stoch_round_cuda(
    x: torch.Tensor,       # (M, N) f32, contiguous, on the card
    seeds: torch.Tensor,   # (G,) int64 uint32 seeds on the card, G divides M
    *,
    step: float,
    lo: float,
    hi: float,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (M, N) f32.  Same
    contract as :func:`stoch_round_ref`: group ``g`` of the M/G-row groups
    draws under ``seeds[g]`` with counter ``row_in_group·n_padded + col``."""
    global launches
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"stoch_round takes a 2-D f32 CUDA tensor, got {x.dtype} {x.device}")
    if not x.is_contiguous():
        raise ValueError("stoch_round input must be contiguous")
    seeds = seeds.reshape(-1)
    if seeds.dtype != torch.int64 or seeds.device != x.device or not seeds.is_contiguous():
        raise ValueError("seeds must be a contiguous int64 tensor on the input's device")
    m, n = x.shape
    if m % seeds.shape[0]:
        raise ValueError(f"{seeds.shape[0]} seeds do not split {m} rows evenly")
    if m * n >= 2**31:
        raise ValueError(f"stoch_round takes fewer than 2**31 elements, got {m}x{n}")
    n_padded = -(-n // 512) * 512  # the counter's row stride, as the reference pads
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # 1/step rounds to f32 on the host, as jnp.float32(1.0 / step) does
    rc = _lib()(
        x.data_ptr(), seeds.data_ptr(), out.data_ptr(), m, n, n_padded,
        m // seeds.shape[0], step, 1.0 / step, lo, hi, stream,
    )
    if rc != 0:
        raise RuntimeError(f"stoch_round kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
