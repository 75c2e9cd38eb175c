"""Chunked-prefill attention: the CUDA kernel's wrapper and its plain version.

Replaces ``paged_prefill_attention_pallas``
(``repro/kernels/prefill_attention.py``).  The kernel
(``csrc/prefill_attention.cu``) tiles the suffix chunk into 16-query tiles
per head and loops over the request's pages up to each tile's last
absolute position.  Its plain PyTorch version is
:func:`prefill_attention_ref`; ``ops.paged_prefill_attention`` sends CPU
tensors there and CUDA tensors here.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .paged_attention import DTYPE_CODES, check_index, check_pool_args, data_ptr
from .ref import prefill_attention_ref  # noqa: F401  (the plain version)

launches = 0

QUERY_TILE = 16  # kQT in csrc/prefill_attention.cu
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("prefill_attention")
    fn = lib.paged_prefill_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 9 + [_F, _P]
        fn.restype = _I
    return fn


def paged_prefill_attention_cuda(
    q: torch.Tensor,         # (S, H, Dh) f32 or bf16 suffix-chunk queries
    k_pages: torch.Tensor,   # (P, bs, Hkv, Dh) q's dtype, or int8 codes
    v_pages: torch.Tensor,
    table: torch.Tensor,     # (W,) int32 page ids; <0 reads page 0
    q0: int,                 # absolute position of the first query
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,  # (P, bs, Hkv) f32, int8 pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the prefill kernel on the current stream; returns (S, H, Dh) f32."""
    global launches
    s, h, dh = q.shape
    _, bs, hkv, _ = k_pages.shape
    check_pool_args(q, k_pages, v_pages, k_scale, v_scale, kind, local_window, QUERY_TILE)
    check_index(table, (table.shape[0],), q.device, "table")
    q0 = int(q0)
    if q0 < 0:
        raise ValueError(f"q0 must be >= 0, got {q0}")
    out = torch.empty((s, h, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        data_ptr(q), DTYPE_CODES[q.dtype], data_ptr(k_pages), data_ptr(v_pages),
        DTYPE_CODES[k_pages.dtype], data_ptr(k_scale), data_ptr(v_scale), data_ptr(table),
        data_ptr(out), s, q0, h, hkv, dh, bs, table.shape[0],
        int(kind == "local"), int(local_window), float(softcap), stream,
    )
    if rc != 0:
        raise RuntimeError(f"prefill attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
