"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Replaces ``paged_attention_pallas`` (``repro/kernels/paged_attention.py``).
The kernel (``csrc/paged_attention.cu``) gives each (slot, kv head) a
thread block cluster of ``n_split`` CTAs that share its live pages; inside
a CTA each warp walks its own 32-key chunks through a ring of TMA page
loads, reading bf16/int8 pages as they lie and accumulating in f32.
:func:`decode_geometry` is the launch's shape (grid, ``n_split``, the
warps and ring stages of a CTA, shared memory), :func:`split_shares` the
pages each CTA takes.  Its plain
PyTorch version is :func:`paged_attention_ref` (the reference oracle's
math over a gathered window); ``ops.paged_attention`` sends CPU tensors
there and CUDA tensors here.  ``launches`` counts kernel launches
(nothing else adds to it).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import paged_attention_ref  # noqa: F401  (the plain version)

launches = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_SMEM_BYTES = 227 * 1024   # dynamic shared memory a CTA may have
SM_SMEM_BYTES = 228 * 1024    # shared memory of an SM; each CTA also takes 1 KiB
SMS = 132             # H100 SXM streaming multiprocessors
WARPS = 4             # kWarps in csrc/paged_attention.cu (128 threads)
# (warps, ring stages a warp) in the order decode_geometry tries them: the
# first whose shared memory fits is the CTA's plan
PLANS = ((WARPS, 2), (WARPS, 1), (2, 1))   # the kernel's instantiations
CHUNK = 32            # kChunk in csrc/attention_chunks.cuh: keys per warp step
MAX_SPLIT = 8         # portable thread block cluster size
MIN_SHARE = 8         # pages of a full window each CTA of a cluster keeps
REGISTERS = 120       # at least ptxas's count for the 4-warp decode kernels (95-120, as
                      # chip_smoke.py prints them); the 2-warp plan's (up to 128)
                      # runs one CTA an SM by shared memory


def split_shares(w_lo: int, w_hi: int, n_split: int) -> list[tuple[int, int]]:
    """The pages ``[lo, hi)`` each CTA of a cluster takes of the live pages
    ``[w_lo, w_hi)`` (as the kernel computes them from ``pos``)."""
    n = max(w_hi - w_lo, 0)
    return [(w_lo + n * r // n_split, w_lo + n * (r + 1) // n_split) for r in range(n_split)]


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def chunk_stage_bytes(bs: int, dh: int, kv_dtype: torch.dtype) -> int:
    """One ring stage of 32 keys (``chunk_stage_bytes`` in
    ``csrc/attention_chunks.cuh``): K and V boxes of min(bs, 32) rows in
    128-byte aligned slots, then the int8 scale entries."""
    item = ITEMSIZE[kv_dtype]
    rows = min(bs, CHUNK)
    stage = 2 * (CHUNK // rows) * _round128(rows * dh * item)
    return stage + (8 * CHUNK if kv_dtype == torch.int8 else 0)


def decode_smem_bytes(g: int, dh: int, bs: int, kv_dtype: torch.dtype, warps: int,
                      stages: int) -> int:
    """``decode_smem_bytes`` in the source: ``stages`` 32-key stages per
    warp, their mbarriers, then the f32 state (q rows, each warp's
    weights, m, l and acc, the CTA's m and l)."""
    floats = g * dh + warps * (32 + -(-2 * g // 4) * 4 + g * dh) + 2 * g
    return 128 + warps * (stages * chunk_stage_bytes(bs, dh, kv_dtype) + 16) + 4 * floats


def decode_geometry(
    b: int, h: int, hkv: int, dh: int, bs: int, w: int, kv_dtype: torch.dtype
) -> dict:
    """Launch shape of the decode kernel: ``grid`` (n_split, Hkv, B),
    ``n_split`` CTAs per (slot, kv head) cluster, the ``warps`` of a CTA and
    the ring ``stages`` of a warp (the first of :data:`PLANS` whose shared
    memory fits: four warps of two stages up to Dh = 128 in bf16 and int8),
    ``threads``, the G query ``rows`` of a CTA, its dynamic ``smem_bytes``
    and the CTAs an SM holds at once (``ctas_per_sm``, by shared memory,
    registers and threads).  The host knows only the window ``w``: the
    split doubles while the doubled grid still fits in one wave of
    resident CTAs and each CTA keeps MIN_SHARE pages of a full window (the
    rule the split sweep of chip_smoke.py bears out, PERF.md)."""
    g = h // hkv
    for warps, stages in PLANS:
        smem = decode_smem_bytes(g, dh, bs, kv_dtype, warps, stages)
        if smem <= MAX_SMEM_BYTES:
            break
    threads = 32 * warps
    per_sm = min(SM_SMEM_BYTES // (smem + 1024), 65536 // (REGISTERS * threads), 2048 // threads)
    n_split = 1
    while (n_split < MAX_SPLIT and 2 * n_split * MIN_SHARE <= w
           and b * hkv * 2 * n_split <= SMS * per_sm):
        n_split *= 2
    return {"grid": (n_split, hkv, b), "n_split": n_split, "warps": warps, "stages": stages,
            "threads": threads, "rows": g, "smem_bytes": smem, "ctas_per_sm": per_sm}


def check_box_shape(dh: int, bs: int, kv_dtype: torch.dtype) -> None:
    """Pools the TMA page boxes take; raises on others.  A box is (Dh, 1,
    min(bs, 32)) of 16-byte multiples, at most 256 wide."""
    if (dh * ITEMSIZE[kv_dtype]) % 16 or dh > 256:
        raise ValueError(f"a page row of Dh={dh} {kv_dtype} must be a multiple of 16 bytes, "
                         "with Dh <= 256")
    if bs < 1 or bs & (bs - 1):
        raise ValueError(f"block size {bs} must be a power of two")


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P] + [_I] * 12 + [_F, _P]
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
) -> None:
    """Checks shared by both attention kernels; raises on what they do not
    take.  Each kernel checks its own geometry besides."""
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
    for t in tensors[1:3]:
        if t.data_ptr() % 16:
            raise ValueError("page pools must be 16-byte aligned (TMA copies)")
    if kind not in ("global", "local"):
        raise ValueError(f"unknown attention kind {kind!r}")
    if kind == "local" and local_window < 1:
        raise ValueError(f"local attention needs local_window >= 1, got {local_window}")


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
    n_split: Optional[int] = None,
    split_batch: Optional[int] = None,
) -> torch.Tensor:
    """Launch the decode kernel on the current stream; returns (B, H, Dh) f32.
    ``n_split`` overrides :func:`decode_geometry`'s cluster size (1, 2, 4
    or 8), for measuring the choice; the main path leaves it unset.
    ``split_batch`` takes the cluster size :func:`decode_geometry` picks
    for that batch width instead of B: a row's output depends on its own
    pages, its position, W and the split only, so a speculative verify of
    k·B rows launched with its draft's B sums every row as the draft did."""
    global launches
    b, h, dh = q.shape
    _, bs, hkv, _ = k_pages.shape
    check_pool_args(q, k_pages, v_pages, k_scale, v_scale, kind, local_window)
    check_index(table, (b, table.shape[1]), q.device, "table")
    check_index(pos, (b,), q.device, "pos")
    check_box_shape(dh, bs, k_pages.dtype)
    geo = decode_geometry(split_batch or b, h, hkv, dh, bs, table.shape[1], k_pages.dtype)
    geo["grid"] = (geo["n_split"], hkv, b)
    if n_split is not None:
        if n_split not in (1, 2, 4, 8):
            raise ValueError(f"n_split must be 1, 2, 4 or 8, got {n_split}")
        geo["n_split"], geo["grid"] = n_split, (n_split, hkv, b)
    if geo["smem_bytes"] > MAX_SMEM_BYTES:
        raise ValueError(f"decode CTA needs {geo['smem_bytes']} bytes of shared memory")
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        data_ptr(q), DTYPE_CODES[q.dtype], data_ptr(k_pages), data_ptr(v_pages),
        DTYPE_CODES[k_pages.dtype], data_ptr(k_scale), data_ptr(v_scale), data_ptr(table),
        data_ptr(pos), data_ptr(out), k_pages.shape[0], b, h, hkv, dh, bs, table.shape[1],
        geo["n_split"], geo["warps"], geo["stages"], int(kind == "local"), int(local_window),
        float(softcap), stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
