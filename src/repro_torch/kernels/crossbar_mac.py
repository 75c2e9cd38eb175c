"""The RACA crossbar read: the CUDA kernel's wrapper and its plain version.

Replaces ``crossbar_mac_pallas`` (``repro/kernels/crossbar_mac.py``), the
paper's own compute: conductance quantization → MAC → thermal noise →
comparator.  The kernel (``csrc/crossbar_mac.cu``) stages x and the
quantized W through shared memory and accumulates 128 × 128 output tiles
with f32 FMAs on the CUDA cores; noise and comparator are fused into the
store.  Its plain PyTorch version is :func:`crossbar_mac_ref`;
``ops.crossbar_mac`` sends CPU tensors there and CUDA tensors here.
``launches`` counts kernel launches (nothing else adds to it).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import CROSSBAR_PAD_N, crossbar_mac_ref  # noqa: F401  (the plain version)

launches = 0

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float


def _lib():
    lib = build.load("crossbar_mac")
    fn = lib.crossbar_mac_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _I, _I,
                       _F, _F, _F, _F, _F, _F, _F, _F, _P]
        fn.restype = _I
    return fn


def crossbar_mac_cuda(
    x: torch.Tensor,        # (M, K) f32, contiguous, on the card
    w: torch.Tensor,        # (K, N) f32, contiguous, already range-normalized
    seed: int,              # uint32 noise seed
    sigma: torch.Tensor,    # one f32 on the card (read unless physical_noise)
    *,
    binarize: bool = True,
    physical_noise: bool = False,
    noise_params: tuple = (0.0, 1.0, 0.0, 1.0, 0),
    quantize: bool = True,
    qstep: float = 2.0 / 31,
    w_min: float = -1.0,
    w_max: float = 1.0,
) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (M, N) f32.  Same
    contract as :func:`crossbar_mac_ref`."""
    global launches
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"crossbar_mac takes 2-D f32 CUDA tensors, got {name} {t.dtype} {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"crossbar_mac's {name} must be contiguous")
    m, k = x.shape
    if w.shape[0] != k or w.device != x.device:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not chain on one device")
    if sigma.device != x.device or sigma.dtype != torch.float32 or sigma.numel() != 1:
        raise ValueError("sigma must be one f32 value on the input's device")
    n = w.shape[1]
    if max(m * k, k * n, m * n) >= 2**31:
        raise ValueError(f"crossbar_mac takes operands under 2**31 elements, got {m}x{k}x{n}")
    four_ktdf, g0, g_ref, v_read, k_rows = noise_params
    n_padded = -(-n // CROSSBAR_PAD_N) * CROSSBAR_PAD_N
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # every float argument rounds to f32 in ctypes, as the reference's
    # weakly typed Python floats round (1/qstep included)
    rc = _lib()(
        x.data_ptr(), w.data_ptr(), sigma.data_ptr(), out.data_ptr(), m, k, n, n_padded,
        seed & 0xFFFFFFFF, int(binarize), int(physical_noise), int(quantize),
        qstep, 1.0 / qstep, w_min, w_max,
        g0, 2.0 * k_rows * g_ref, four_ktdf, v_read * g0, stream,
    )
    if rc != 0:
        raise RuntimeError(f"crossbar_mac kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
