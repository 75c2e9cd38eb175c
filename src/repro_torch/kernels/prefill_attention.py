"""Chunked-prefill attention: the CUDA kernel's wrapper and its plain version.

Replaces ``paged_prefill_attention_pallas``
(``repro/kernels/prefill_attention.py``).  The kernel
(``csrc/prefill_attention.cu``) takes one of two routes by query type:
bf16 queries run tensor-core tiles of 16 queries of one head whose keys
up to eight warps share, in 32-key chunks loaded by TMA; f32 queries run
CUDA-core tiles of 16 queries.  Both walk the request's keys up to each
tile's last absolute position.  :func:`prefill_geometry` is the launch's
shape.  Its plain PyTorch version is :func:`prefill_attention_ref`;
``ops.paged_prefill_attention`` sends CPU tensors there and CUDA tensors
here.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .paged_attention import (
    CHUNK, DTYPE_CODES, MAX_SMEM_BYTES, SM_SMEM_BYTES, check_box_shape, check_index,
    check_pool_args, chunk_stage_bytes, data_ptr,
)
from .ref import prefill_attention_ref  # noqa: F401  (the plain version)

launches = 0

TC_ROWS = 16      # query rows of a tensor-core CTA (csrc/prefill_attention.cu)
TC_WARPS = 8      # kTcWarps: warps of a CTA, sharing its key chunks (four above Dh 192)
# the head dims the tile is compiled for; above 128 its query rows are
# staged in shared memory
TC_HEAD_DIMS = (*range(16, 129, 16), 192, 256)
PAD = 8           # kPad in csrc/attention_chunks.cuh: the int8 work tile's row padding
F32_ROWS = 16     # kQT, the CUDA-core route's query tile
F32_REGISTERS = 64  # at least ptxas's count for the CUDA-core kernels (56-64)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    lib = build.load("prefill_attention")
    fn = lib.paged_prefill_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _I, _P, _P, _P, _P] + [_I] * 10 + [_F, _P]
        fn.restype = _I
    return fn


def tc_warp_bytes(bs: int, dh: int, kv_dtype: torch.dtype) -> int:
    """A tensor-core warp's shared memory (``tc_warp_bytes`` in
    ``csrc/attention_chunks.cuh``): one stage and the int8 work tile, or
    its f32 (O, m, l) if that is larger, in 128-byte units."""
    ring = chunk_stage_bytes(bs, dh, kv_dtype)
    if kv_dtype == torch.int8:
        ring += CHUNK * (dh + PAD) * 2
    return -(-max(ring, 16 * dh * 4 + 2 * 16 * 4) // 128) * 128


def prefill_tc_smem_bytes(bs: int, dh: int, kv_dtype: torch.dtype, warps: int) -> int:
    """``prefill_tc_smem_bytes`` in the source: the warps' regions and
    mbarriers, and above Dh = 128 the staged query tile."""
    q_tile = 16 * (dh + PAD) * 2 if dh > 128 else 0
    return 128 + warps * (tc_warp_bytes(bs, dh, kv_dtype) + 8) + q_tile


def prefill_geometry(
    s: int, h: int, hkv: int, dh: int, bs: int, q_dtype: torch.dtype, kv_dtype: torch.dtype
) -> dict:
    """Launch shape of the prefill kernel: its ``route`` ("tensor-core" for
    bf16 queries, "cuda-core" for f32), ``grid`` (query tiles, H), the
    query ``rows`` of a tile, its ``warps``, ``threads`` and dynamic
    ``smem_bytes`` (``prefill_tc_smem_bytes`` / ``smem_floats`` in the
    sources), and the CTAs an SM holds at once (``ctas_per_sm``, by shared
    memory, registers and threads).  A tensor-core CTA has eight warps,
    four above Dh = 192 (``tc_warps`` in the source)."""
    if q_dtype == torch.bfloat16:
        warps = TC_WARPS if dh <= 192 else TC_WARPS // 2
        smem = prefill_tc_smem_bytes(bs, dh, kv_dtype, warps)
        regs = 128 if dh <= 80 else 255  # ptxas's cap: 2 CTAs an SM up to Dh 80, else 1
        threads = 32 * warps
        per_sm = min(SM_SMEM_BYTES // (smem + 1024), 65536 // (regs * threads), 2048 // threads)
        return {"route": "tensor-core", "grid": (-(-s // TC_ROWS), h), "rows": TC_ROWS,
                "warps": warps, "threads": threads, "smem_bytes": smem, "ctas_per_sm": per_sm}
    r = F32_ROWS
    smem = 4 * (2 * r * dh + bs * (2 * dh + 1) + r * bs + 3 * r + 2 * bs)
    per_sm = min(SM_SMEM_BYTES // (smem + 1024), 65536 // (F32_REGISTERS * 128), 2048 // 128)
    return {"route": "cuda-core", "grid": (-(-s // r), h), "rows": r, "warps": 4, "threads": 128,
            "smem_bytes": smem, "ctas_per_sm": per_sm}


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
    check_pool_args(q, k_pages, v_pages, k_scale, v_scale, kind, local_window)
    check_index(table, (table.shape[0],), q.device, "table")
    geo = prefill_geometry(s, h, hkv, dh, bs, q.dtype, k_pages.dtype)
    if geo["route"] == "tensor-core":
        check_box_shape(dh, bs, k_pages.dtype)
        if dh not in TC_HEAD_DIMS:
            raise ValueError(f"bf16 queries need Dh in {list(TC_HEAD_DIMS)}, got {dh}")
        if dh > 128 and q.data_ptr() % 16:
            raise ValueError("bf16 queries at Dh > 128 must be 16-byte aligned")
    if geo["smem_bytes"] > MAX_SMEM_BYTES:
        raise ValueError(f"prefill tile needs {geo['smem_bytes']} bytes of shared memory")
    q0 = int(q0)
    if q0 < 0:
        raise ValueError(f"q0 must be >= 0, got {q0}")
    out = torch.empty((s, h, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        data_ptr(q), DTYPE_CODES[q.dtype], data_ptr(k_pages), data_ptr(v_pages),
        DTYPE_CODES[k_pages.dtype], data_ptr(k_scale), data_ptr(v_scale), data_ptr(table),
        data_ptr(out), k_pages.shape[0], s, q0, h, hkv, dh, bs, table.shape[0],
        int(kind == "local"), int(local_window), float(softcap), stream,
    )
    if rc != 0:
        raise RuntimeError(f"prefill attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
