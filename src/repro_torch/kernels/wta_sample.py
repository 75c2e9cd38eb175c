"""WTA sampling under threefry noise: the CUDA kernel's wrapper.

The reference computes ``wta_trials`` (``repro/core/wta.py``) in jnp, with
no Pallas kernel; the serving sampler calls it once per read and token,
which draws T·B·V ≈ 12.9 M normals a tick at the serving head.  The
kernel (``csrc/wta_sample.cu``) draws them with jax's threefry and XLA's
``erf_inv`` (``csrc/threefry.cuh``) and keeps only the vote: one CTA per
(row, trial), a strided scan, a warp and a block arg-max, one atomic vote.
Its plain PyTorch version is ``ref.wta_trial_counts_ref``;
``ops.wta_trial_counts`` sends CPU tensors there and CUDA tensors here.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import wta_trial_counts_ref  # noqa: F401  (the plain version)

launches = 0

_P, _I, _U, _F, _LL, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                             ctypes.c_longlong, ctypes.c_ulonglong)


def _lib():
    lib = build.load("wta_sample")
    if lib.wta_sample_launch.argtypes is None:
        lib.wta_sample_launch.argtypes = [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _LL, _LL, _F,
                                          _F, _P]
        lib.wta_sample_probe.argtypes = [_P, _U, _U, _ULL, _I, _F, _F, _P, _P, _P, _P]
        for fn in (lib.wta_sample_launch, lib.wta_sample_probe):
            fn.restype = _I
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def wta_sample_cuda(
    z: torch.Tensor,                 # (N, C) f32 or bf16, contiguous, on the card
    keys: torch.Tensor,              # (N, 2) int64 threefry keys
    folds: Optional[torch.Tensor],   # (N, F) int64, F <= 2, or None
    *,
    n_trials: int,
    vth0: float,
    sigma_z: float,
    layout: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; returns (counts (N, C) f32,
    n_decisions (N,) f32).  Same contract as ``ref.wta_trial_counts_ref``.
    A call with no trial to run (N, C or ``n_trials`` 0) returns zeros and
    launches nothing."""
    global launches
    if z.device.type != "cuda" or z.dim() != 2 or z.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wta_sample takes a 2-D f32 or bf16 CUDA tensor, got {z.dtype} "
                         f"{tuple(z.shape)} on {z.device}")
    n, c = z.shape
    if not z.is_contiguous():
        raise ValueError("wta_sample input must be contiguous")
    if keys.shape != (n, 2) or keys.dtype != torch.int64 or keys.device != z.device \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous (N, 2) int64 tensor on the input's device")
    n_folds = 0 if folds is None else folds.shape[1]
    if folds is not None and (folds.shape != (n, n_folds) or n_folds > 2
                              or folds.dtype != torch.int64 or folds.device != z.device
                              or not folds.is_contiguous()):
        raise ValueError("folds must be a contiguous (N, F <= 2) int64 tensor on the input's "
                         "device")
    if n_trials < 0 or n * max(n_trials, 1) >= 2**31:
        raise ValueError(f"wta_sample cannot take N={n} T={n_trials}")
    counts = torch.zeros((n, c), dtype=torch.float32, device=z.device)
    n_dec = torch.zeros((n,), dtype=torch.float32, device=z.device)
    if n == 0 or c == 0 or n_trials == 0:   # no trial to run: nothing is launched
        return counts, n_dec
    rc = _lib().wta_sample_launch(
        z.data_ptr(), int(z.dtype == torch.bfloat16), keys.data_ptr(),
        None if folds is None else folds.data_ptr(), n_folds, counts.data_ptr(),
        n_dec.data_ptr(), n, c, n_trials, layout[0], layout[1], vth0, sigma_z,
        torch.cuda.current_stream(z.device).cuda_stream,
    )
    _check(rc, "wta_sample")
    launches += 1
    return counts, n_dec


def draw_probe(z: torch.Tensor, key: tuple[int, int], start: int, *, vth0: float,
               sigma_z: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's draw alone (``wta_sample_probe_kernel``), one element a
    thread: under ``key``, for the flat counters ``start + i`` of ``z``'s
    (K,) f32 elements, (the bits as int64, the uniforms, the voltage where
    it fires, else −inf).  Not counted in ``launches``."""
    if z.device.type != "cuda" or z.dtype != torch.float32 or z.dim() != 1 \
            or not z.is_contiguous():
        raise ValueError("draw_probe takes a contiguous 1-D f32 CUDA tensor")
    k = z.shape[0]
    bits = torch.empty((k,), dtype=torch.int32, device=z.device)
    u, v = torch.empty_like(z), torch.empty_like(z)
    _check(_lib().wta_sample_probe(z.data_ptr(), key[0], key[1], start, k, vth0, sigma_z,
                                   bits.data_ptr(), u.data_ptr(), v.data_ptr(),
                                   torch.cuda.current_stream(z.device).cuda_stream),
           "wta_sample_probe")
    return bits.to(torch.int64) & 0xFFFFFFFF, u, v
