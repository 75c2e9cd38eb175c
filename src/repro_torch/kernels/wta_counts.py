"""Winner-take-all vote counts: the CUDA kernel's wrapper and its plain
version.

Replaces ``wta_counts_pallas`` (``repro/kernels/wta_kernel.py``), the
paper's binary stochastic SoftMax (§III-B).  The kernel
(``csrc/wta_counts.cu``) runs one thread block per (row, trial) and adds
each trial's winners with atomic float adds, which are exact for integer
counts.  Its plain PyTorch version is :func:`wta_counts_ref`;
``ops.wta_counts`` sends CPU tensors there and CUDA tensors here.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import wta_counts_ref, wta_trial_stride  # noqa: F401  (the plain version)

launches = 0

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


def _lib():
    lib = build.load("wta_counts")
    fn = lib.wta_counts_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _U, _I, _F, _F, _P]
        fn.restype = _I
    return fn


def wta_counts_cuda(
    z: torch.Tensor,       # (B, C) f32, contiguous, on the card
    seed: torch.Tensor,    # one int64 uint32 seed on the card
    *,
    n_trials: int,
    vth0: float,
    sigma_z: float,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (B, C) f32 counts.
    Same contract as :func:`wta_counts_ref`."""
    global launches
    if z.device.type != "cuda" or z.dtype != torch.float32 or z.dim() != 2:
        raise ValueError(f"wta_counts takes a 2-D f32 CUDA tensor, got {z.dtype} {z.device}")
    if not z.is_contiguous():
        raise ValueError("wta_counts input must be contiguous")
    seed = seed.reshape(-1)
    if seed.shape != (1,) or seed.dtype != torch.int64 or seed.device != z.device:
        raise ValueError("seed must be one int64 value on the input's device")
    b, c = z.shape
    c_pad = -(-c // 128) * 128  # the reference's padded class width
    if not 0 <= n_trials < 65536 or b >= 2**31:
        raise ValueError(f"wta_counts cannot take B={b} T={n_trials}")
    counts = torch.zeros_like(z)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    rc = _lib()(
        z.data_ptr(), seed.data_ptr(), counts.data_ptr(), b, c, c_pad,
        wta_trial_stride(c_pad), n_trials, vth0, sigma_z, stream,
    )
    if rc != 0:
        raise RuntimeError(f"wta_counts kernel launch failed: CUDA error {rc}")
    launches += 1
    return counts
