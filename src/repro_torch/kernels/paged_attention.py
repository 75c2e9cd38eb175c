"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Replaces ``paged_attention_pallas`` (``repro/kernels/paged_attention.py``).
The kernel (``csrc/paged_attention.cu``) runs one thread block per (slot,
kv head) and loops over the slot's live pages, reading bf16/int8 pages as
they lie and accumulating in f32.  Its plain PyTorch version is
:func:`paged_attention_ref` (the reference oracle's math over a gathered
window); ``ops.paged_attention`` sends CPU tensors there and CUDA tensors
here.  ``launches`` counts kernel launches (nothing else adds to it).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import paged_attention_ref  # noqa: F401  (the plain version)

launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_SMEM_BYTES = 227 * 1024


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P] + [_I] * 8 + [_F, _P]
        fn.restype = _I
    return fn


def data_ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def check_pool_args(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
    kind: str,
    local_window: int,
    rows: int,
) -> None:
    """Checks shared by both attention kernels; raises on what they do not
    take.  ``rows`` is the query rows one thread block holds."""
    if q.device.type != "cuda":
        raise ValueError(f"CUDA attention kernel got a {q.device} tensor")
    n_pages, bs, hkv, dh = k_pages.shape
    if q.shape[-1] != dh or q.shape[-2] % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages {tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype:
        raise ValueError("k_pages and v_pages differ in shape or dtype")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported")
    int8 = k_pages.dtype == torch.int8
    if not int8 and k_pages.dtype != q.dtype:
        raise ValueError(f"q {q.dtype} with {k_pages.dtype} pages not supported")
    if int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools need both scale planes; float pools none")
    tensors = [q, k_pages, v_pages]
    if int8:
        for s in (k_scale, v_scale):
            if s.shape != (n_pages, bs, hkv) or s.dtype != torch.float32:
                raise ValueError(f"scale plane {tuple(s.shape)} {s.dtype}")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("attention operands must be contiguous on one device")
    if kind not in ("global", "local"):
        raise ValueError(f"unknown attention kind {kind!r}")
    if kind == "local" and local_window < 1:
        raise ValueError(f"local attention needs local_window >= 1, got {local_window}")
    smem = 4 * (2 * rows * dh + bs * (2 * dh + 1) + rows * bs + 3 * rows + 2 * bs)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"tile needs {smem} bytes of shared memory")


def check_index(t: torch.Tensor, shape: tuple, dev: torch.device, name: str) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be int32 {shape}, got {t.dtype} {tuple(t.shape)}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {dev}")


def paged_attention_cuda(
    q: torch.Tensor,         # (B, H, Dh) f32 or bf16
    k_pages: torch.Tensor,   # (P, bs, Hkv, Dh) q's dtype, or int8 codes
    v_pages: torch.Tensor,
    table: torch.Tensor,     # (B, W) int32 page ids; <0 reads page 0
    pos: torch.Tensor,       # (B,) int32 last valid key position
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,  # (P, bs, Hkv) f32, int8 pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the decode kernel on the current stream; returns (B, H, Dh) f32."""
    global launches
    b, h, dh = q.shape
    _, bs, hkv, _ = k_pages.shape
    check_pool_args(q, k_pages, v_pages, k_scale, v_scale, kind, local_window, h // hkv)
    check_index(table, (b, table.shape[1]), q.device, "table")
    check_index(pos, (b,), q.device, "pos")
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        data_ptr(q), DTYPE_CODES[q.dtype], data_ptr(k_pages), data_ptr(v_pages),
        DTYPE_CODES[k_pages.dtype], data_ptr(k_scale), data_ptr(v_scale), data_ptr(table),
        data_ptr(pos), data_ptr(out), b, h, hkv, dh, bs, table.shape[1],
        int(kind == "local"), int(local_window), float(softcap), stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
