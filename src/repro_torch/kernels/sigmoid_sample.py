"""Binary stochastic Sigmoid neurons under threefry noise: the CUDA
kernel's wrapper.

The reference computes ``sigmoid_neuron_calibrated``
(``repro/core/neurons.py:52-84``) in jnp, with no Pallas kernel: every
hidden layer of the paper's FCNN draws ``jax.random.uniform(key, (M, N))``
and fires where ``u < sigmoid(β·(x @ Wq + b))``.  Drawn with the port's
plain threefry that is ≈ 400 int64 elementwise launches a layer; the
kernel (``csrc/sigmoid_sample.cu``) folds the bias, takes the sigmoid,
hashes and compares in one launch.  Its plain PyTorch version is
``ref.sigmoid_sample_ref``; ``ops.sigmoid_sample`` sends CPU tensors there
and CUDA tensors here.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import sigmoid_sample_ref  # noqa: F401  (the plain version)

launches = 0

_P, _I, _U, _F, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                        ctypes.c_ulonglong)


def _lib():
    lib = build.load("sigmoid_sample")
    if lib.sigmoid_sample_launch.argtypes is None:
        lib.sigmoid_sample_launch.argtypes = [_P, _P, _P, _I, _I, _F, _U, _U, _ULL, _P]
        lib.sigmoid_sample_probe.argtypes = [_P, _P, _I, _I, _F, _U, _U, _ULL, _P, _P, _P, _P, _P]
        for fn in (lib.sigmoid_sample_launch, lib.sigmoid_sample_probe):
            fn.restype = _I
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _check_args(acc: torch.Tensor, bias: Optional[torch.Tensor], offset: int) -> None:
    if acc.device.type != "cuda" or acc.dim() != 2 or acc.dtype != torch.float32 \
            or not acc.is_contiguous():
        raise ValueError(f"sigmoid_sample takes a contiguous 2-D f32 CUDA tensor, got "
                         f"{acc.dtype} {tuple(acc.shape)} on {acc.device}")
    m, n = acc.shape
    if bias is not None and (bias.shape != (n,) or bias.dtype != torch.float32
                             or bias.device != acc.device or not bias.is_contiguous()):
        raise ValueError("bias must be a contiguous (N,) f32 tensor on the input's device")
    if m * n >= 2**31 - 1:
        raise ValueError(f"sigmoid_sample cannot take {m} x {n} elements")
    if offset < 0 or offset + m * n > 2**64:
        raise ValueError(f"counter offset {offset} out of range")


def sigmoid_sample_cuda(
    acc: torch.Tensor,               # (M, N) f32, contiguous, on the card
    bias: Optional[torch.Tensor],    # (N,) f32 or None
    *,
    beta: float,
    key: tuple[int, int],
    offset: int = 0,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns y (M, N) f32 in
    {0, 1}.  Same contract as ``ref.sigmoid_sample_ref``.  An empty input
    launches nothing."""
    global launches
    _check_args(acc, bias, offset)
    m, n = acc.shape
    y = torch.empty_like(acc)
    if m * n == 0:
        return y
    rc = _lib().sigmoid_sample_launch(
        acc.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(), m, n, beta,
        key[0], key[1], offset, torch.cuda.current_stream(acc.device).cuda_stream,
    )
    _check(rc, "sigmoid_sample")
    launches += 1
    return y


def draw_probe(
    acc: torch.Tensor, bias: Optional[torch.Tensor], *, beta: float, key: tuple[int, int],
    offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic with its pieces written out
    (``sigmoid_sample_probe_kernel``): (bits as int64, u, p, y), each (M,
    N).  Not counted in ``launches``."""
    _check_args(acc, bias, offset)
    m, n = acc.shape
    bits = torch.empty((m, n), dtype=torch.int32, device=acc.device)
    u, p, y = (torch.empty_like(acc) for _ in range(3))
    if m * n:
        _check(_lib().sigmoid_sample_probe(
            acc.data_ptr(), None if bias is None else bias.data_ptr(), m, n, beta, key[0],
            key[1], offset, bits.data_ptr(), u.data_ptr(), p.data_ptr(), y.data_ptr(),
            torch.cuda.current_stream(acc.device).cuda_stream), "sigmoid_sample_probe")
    return bits.to(torch.int64) & 0xFFFFFFFF, u, p, y
