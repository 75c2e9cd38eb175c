"""Kernel dispatch for the attention path (``repro/kernels/ops.py:386-512``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version, and nothing else happens in between: no fallback, no
try.  The kernels return f32; callers cast to the model dtype, as the
reference does.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import paged_attention as PA
from . import prefill_attention as PF
from . import ref


def paged_attention(
    q: torch.Tensor,         # (B, H, Dh)
    k_pages: torch.Tensor,   # (P, bs, Hkv, Dh) cache dtype or int8 codes
    v_pages: torch.Tensor,
    table: torch.Tensor,     # (B, W) int32
    pos: torch.Tensor,       # (B,) int32
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Block-table decode attention: (B, H, Dh) f32."""
    fn = PA.paged_attention_cuda if q.is_cuda else ref.paged_attention_ref
    return fn(
        q, k_pages, v_pages, table, pos, kind=kind, local_window=local_window,
        softcap=softcap, k_scale=k_scale, v_scale=v_scale,
    )


def paged_prefill_attention(
    q: torch.Tensor,         # (S, H, Dh) one request's suffix-chunk queries
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    table: torch.Tensor,     # (W,) int32 the request's block-table row
    q0: int,                 # absolute position of the first query
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Prefix-aware chunked-prefill attention: (S, H, Dh) f32."""
    fn = PF.paged_prefill_attention_cuda if q.is_cuda else ref.prefill_attention_ref
    return fn(
        q, k_pages, v_pages, table, q0, kind=kind, local_window=local_window,
        softcap=softcap, k_scale=k_scale, v_scale=v_scale,
    )
