"""Plain PyTorch versions of the attention kernels (``repro/kernels/ref.py``).

Each function is the reference oracle's math over a gathered window: the
table's pages are gathered into a contiguous ``W·bs`` key window, then a
masked full-softmax attention runs in f32.  The CPU path of the port runs
these; on the card they are what ``chip_smoke.py`` holds each CUDA kernel
against.  Nothing on the main path calls them when a card is present.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def _masked_softmax_readout(
    sc: torch.Tensor,          # (..., T) f32 scores, already scaled/capped
    ok: torch.Tensor,          # broadcastable bool mask over sc
    v: torch.Tensor,           # value window, f32
    v_scale: Optional[torch.Tensor],
    einsum_out: str,
) -> torch.Tensor:
    sc = sc + torch.where(ok, 0.0, NEG_INF)
    w = torch.softmax(sc, dim=-1)
    if v_scale is not None:
        w = w * v_scale
    return torch.einsum(einsum_out, w, v)


def paged_attention_ref(
    q: torch.Tensor,         # (B, H, Dh)
    k_pages: torch.Tensor,   # (P, bs, Hkv, Dh) cache dtype or int8 codes
    v_pages: torch.Tensor,
    table: torch.Tensor,     # (B, W) int page ids; <0 treated as page 0
    pos: torch.Tensor,       # (B,) int last valid key position
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,  # (P, bs, Hkv) f32, int8 pools
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention of one query per slot over its block-table pages;
    returns (B, H, Dh) f32.  int8 pools fold ``k_scale/127`` into the
    scores and ``v_scale/127`` into the value weights (the cache itself is
    never dequantized)."""
    b, h, dh = q.shape
    _, bs, hkv, _ = k_pages.shape
    g = h // hkv
    pages = table.long().clamp_min(0)
    kb = k_pages[pages].reshape(b, -1, hkv, dh).float()
    vb = v_pages[pages].reshape(b, -1, hkv, dh).float()
    t = kb.shape[1]
    qg = q.reshape(b, hkv, g, dh).float() * dh**-0.5
    sc = torch.einsum("bkgd,btkd->bkgt", qg, kb)
    if k_scale is not None:
        ks = k_scale[pages].reshape(b, t, hkv)
        sc = sc * (ks.transpose(1, 2) / 127.0)[:, :, None, :]
    if softcap > 0.0:
        sc = torch.tanh(sc / softcap) * softcap
    kpos = torch.arange(t, device=q.device)[None]
    p = pos.long()[:, None]
    ok = kpos <= p
    if kind == "local":
        ok &= kpos > (p - local_window)
    vs = None
    if v_scale is not None:
        vs = (v_scale[pages].reshape(b, t, hkv).transpose(1, 2) / 127.0)[:, :, None, :]
    out = _masked_softmax_readout(
        sc, ok[:, None, None, :], vb, vs, "bkgt,btkd->bkgd"
    )
    return out.reshape(b, h, dh)


def prefill_attention_ref(
    q: torch.Tensor,         # (S, H, Dh) one request's suffix-chunk queries
    k_pages: torch.Tensor,   # (P, bs, Hkv, Dh) cache dtype or int8 codes
    v_pages: torch.Tensor,
    table: torch.Tensor,     # (W,) int page ids; <0 treated as page 0
    q0: int,                 # absolute position of the first query
    *,
    kind: str = "global",
    local_window: int = 0,
    softcap: float = 0.0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked-prefill attention: query ``i`` sits at absolute position
    ``q0 + i`` and key ``t`` of block ``w`` at ``w·bs + t``; returns
    (S, H, Dh) f32.  int8 pools fold their scale planes in exactly like
    :func:`paged_attention_ref`."""
    s, h, dh = q.shape
    _, bs, hkv, _ = k_pages.shape
    g = h // hkv
    pages = table.long().clamp_min(0)
    kb = k_pages[pages].reshape(-1, hkv, dh).float()
    vb = v_pages[pages].reshape(-1, hkv, dh).float()
    t = kb.shape[0]
    qg = q.reshape(s, hkv, g, dh).float() * dh**-0.5
    sc = torch.einsum("skgd,tkd->kgst", qg, kb)
    if k_scale is not None:
        ks = k_scale[pages].reshape(t, hkv)
        sc = sc * (ks.transpose(0, 1) / 127.0)[:, None, None, :]
    if softcap > 0.0:
        sc = torch.tanh(sc / softcap) * softcap
    qpos = int(q0) + torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    ok = kpos <= qpos
    if kind == "local":
        ok &= kpos > (qpos - local_window)
    vs = None
    if v_scale is not None:
        vs = (v_scale[pages].reshape(t, hkv).transpose(0, 1) / 127.0)[:, None, None, :]
    out = _masked_softmax_readout(sc, ok[None, None], vb, vs, "kgst,tkd->skgd")
    return out.reshape(s, h, dh)
