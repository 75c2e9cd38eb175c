"""Stochastic rounding: the CUDA kernels' wrappers and their plain versions.

Replaces ``stoch_round_pallas`` (``repro/kernels/stoch_round.py``), the
paper's conductance-programming primitive (§II-B) that the int8 KV pool
applies to every cache write.  Two kernels of ``csrc/stoch_round.cu``:

- ``stoch_round``: a CTA of ``ty`` rows with ``tx`` threads across each
  (:func:`stoch_round_geometry`), 16-byte loads and stores with scalar
  heads and tails where a row is not aligned, seeds read from device
  memory so a serving step never waits on the host for them; plain version
  :func:`stoch_round_ref`, reached through ``ops.stoch_round_serving``;
- ``write_kv_int8``: a layer's whole int8 KV write (absmax, scale,
  stochastic rounding, int8 cast and the scatter of K and V codes and
  scales into their pages) in one launch; plain version
  :func:`write_kv_int8_ref`, reached through ``ops.write_kv_int8``.

``launches`` and ``write_launches`` count each kernel's launches (nothing
else adds to them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from . import build
from .ref import stoch_round_ref, write_kv_int8_ref  # noqa: F401  (the plain versions)

launches = 0
write_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

THREADS = 256   # per CTA (csrc/stoch_round.cu: kSrThreads)
UNROLL = 4      # float4 loads in flight per thread (kSrUnroll)


class SrGeometry(NamedTuple):
    tx: int       # threads across a row, a multiple of 32
    ty: int       # rows per CTA
    blocks: int


@functools.lru_cache(maxsize=None)   # once per shape: small calls are launch-bound
def stoch_round_geometry(m: int, n: int) -> SrGeometry:
    """The launch shape for (m, n): enough threads across a row that each
    keeps at most ``UNROLL`` of the row's ≈ n/4 vectors (32 to 256), and as
    many rows per CTA as fill ``THREADS``: (2048, 2048) runs 1024 CTAs of
    2 rows × 128 threads, (256, 80) 32 CTAs of 8 rows × 32."""
    per_thread = -(-max(n // 4, 1) // UNROLL)
    tx = min(THREADS, -(-per_thread // 32) * 32)
    ty = THREADS // tx
    return SrGeometry(tx, ty, -(-m // ty))


def _lib():
    lib = build.load("stoch_round")
    if lib.stoch_round_launch.argtypes is None:
        lib.stoch_round_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _I, _I,
                                           _P]
        lib.write_kv_int8_launch.argtypes = [_P] * 9 + [_I] * 10 + [_P]
        lib.stoch_round_launch.restype = lib.write_kv_int8_launch.restype = _I
    return lib


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
    geo = stoch_round_geometry(m, n)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # 1/step rounds to f32 on the host, as jnp.float32(1.0 / step) does
    rc = _lib().stoch_round_launch(
        x.data_ptr(), seeds.data_ptr(), out.data_ptr(), m, n, n_padded,
        m // seeds.shape[0], step, 1.0 / step, lo, hi, geo.tx, geo.ty, stream,
    )
    if rc != 0:
        raise RuntimeError(f"stoch_round kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def write_kv_int8_cuda(
    k: torch.Tensor,          # decode (B, 1, Hkv, Dh); chunk (1, c, Hkv, Dh); f32 or bf16
    v: torch.Tensor,
    k_pages: torch.Tensor,    # (P, bs, Hkv, Dh) int8, written in place
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,    # (P, bs, Hkv) f32, written in place
    v_scale: torch.Tensor,
    seeds: torch.Tensor,      # decode (1,); chunk (nbc,) int64 uint32 seeds
    *,
    table: Optional[torch.Tensor] = None,
    pos: Optional[torch.Tensor] = None,
    table_row: Optional[torch.Tensor] = None,
    b0: int = 0,
) -> None:
    """Launch the fused write on the current stream.  Same contract as
    :func:`write_kv_int8_ref`; evicted slots may write the same row of the
    trash page 0, which nothing reads."""
    global write_launches
    dev = k.device
    if dev.type != "cuda" or k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"write_kv_int8 takes f32 or bf16 CUDA rows, got {k.dtype} {dev}")
    if v.shape != k.shape or v.dtype != k.dtype or k.dim() != 4:
        raise ValueError(f"k {tuple(k.shape)} {k.dtype} and v {tuple(v.shape)} {v.dtype} differ")
    n_pages, bs, hkv, dh = k_pages.shape
    if k.shape[2:] != (hkv, dh) or v_pages.shape != k_pages.shape:
        raise ValueError(f"rows {tuple(k.shape)} do not fit pools {tuple(k_pages.shape)}")
    if k_scale.shape != (n_pages, bs, hkv) or v_scale.shape != k_scale.shape:
        raise ValueError("scale planes must be (P, bs, Hkv)")
    for name, t, dt in (("k_pages", k_pages, torch.int8), ("v_pages", v_pages, torch.int8),
                        ("k_scale", k_scale, torch.float32), ("v_scale", v_scale, torch.float32),
                        ("seeds", seeds, torch.int64)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {dev}")
    k, v = k.contiguous(), v.contiguous()
    if table is not None:
        decode, idx, int_args = 1, table, (("table", table), ("pos", pos))
        n_tok = n_valid = k.shape[0]
        if k.shape[1] != 1 or table.shape[0] != n_tok or pos.shape != (n_tok,) or seeds.numel() != 1:
            raise ValueError("decode writes one row per slot under one seed")
        table_w = table.shape[1]
    else:
        decode, idx, int_args = 0, table_row, (("table_row", table_row),)
        n_valid = k.shape[1]
        nbc = -(-n_valid // bs)
        n_tok, table_w = nbc * bs, table_row.shape[0]
        if k.shape[0] != 1 or seeds.numel() != nbc or b0 + nbc > table_w:
            raise ValueError(f"a chunk of {n_valid} rows needs {nbc} seeds and table blocks "
                             f"from {b0}, got {seeds.numel()} of {table_w}")
    for name, t in int_args:
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
    if n_pages * bs * hkv * dh >= 2**31:
        raise ValueError("write_kv_int8 takes pools under 2**31 codes")
    rc = _lib().write_kv_int8_launch(
        k.data_ptr(), v.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), seeds.data_ptr(), idx.data_ptr(), pos.data_ptr() if decode else None,
        int(k.dtype == torch.bfloat16), decode, n_tok, n_valid, table_w, b0, bs, hkv, dh,
        -(-dh // 512) * 512, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"write_kv_int8 kernel launch failed: CUDA error {rc}")
    write_launches += 1
