"""Attention (``repro/models/attention.py``): the full-sequence
self-attention of the training path, and the paged attention of the
serving path.

The training path's projections take threefry keys (``split`` of the
layer's key, as the reference splits it) and run the crossbar in analog
modes; its softmax is digital and plain PyTorch, as the reference's
``attend_full`` is plain jnp.  The serving path passes no keys, so its
projections stay digital.

Unlike the reference, the KV pool is updated IN PLACE (``__setitem__`` on
the pool tensor or on a view of it), where JAX built a new pool with
``.at[].set``.  The collision-freedom argument carries over unchanged:
every slot's current page is exclusively owned (the engine's host-side
copy-on-write pass forks any still-shared page at ``pos // bs`` before
the decode step runs), so the per-slot scatter never collides; shared
pages are only ever read.  Slots whose table row is all trash (page 0)
write into page 0, which no live request reads.

Attention and the int8 KV write go through ``kernels.ops``: the
hand-written CUDA kernels for CUDA tensors, their plain PyTorch versions
for CPU tensors.  int8 pools carry per-(page, row, kv head) f32 scale
planes beside the codes; one fused write quantizes a layer's K/V rows and
scatters codes and scales in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import random as R
from repro_torch.core import analog as A
from repro_torch.kernels import ops as KOPS
from repro_torch.kernels.ref import chunk_to_blocks, paged_write, paged_write_chunk
from .config import ModelConfig
from .layers import apply_rope, dtype_of, normal_init

NEG_INF = -2.0e38


def init_attn(gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int] = ()) -> dict:
    d, hd, h, hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = dtype_of(cfg)
    lead = tuple(lead)
    return {
        "wq": normal_init(gen, lead + (d, h * hd), d, dt),
        "wk": normal_init(gen, lead + (d, hkv * hd), d, dt),
        "wv": normal_init(gen, lead + (d, hkv * hd), d, dt),
        "wo": normal_init(gen, lead + (h * hd, d), h * hd, dt),
    }


def _proj_cfg(cfg: ModelConfig) -> A.AnalogConfig:
    a = cfg.analog
    return a.with_mode("analog_linear") if a.mode == "analog_stochastic" else a


def qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, key=None):
    b, s, _ = x.shape
    acfg = _proj_cfg(cfg)
    keys = (None,) * 3 if key is None else R.split(key, 3)
    q = A.analog_matmul(acfg, keys[0], x, p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = A.analog_matmul(acfg, keys[1], x, p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = A.analog_matmul(acfg, keys[2], x, p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def attend_full(
    q: torch.Tensor,      # (B, S, H, Dh)
    k: torch.Tensor,      # (B, T, Hkv, Dh)
    v: torch.Tensor,
    qpos: torch.Tensor,   # (S,) query positions
    kpos: torch.Tensor,   # (T,) key positions
    kind: str,            # global | local | none
    cfg: ModelConfig,
) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``cfg.attn_kv_chunk``
    keys: (B, S, H, Dh) in q's dtype.  The mask is built per chunk from
    positions; scores and probabilities in ``cfg.attn_probs_dtype``,
    accumulation in f32, as the reference's ``attend_full``."""
    if cfg.attn_pad_heads or cfg.gqa_repeat_kv:
        raise NotImplementedError("attn_pad_heads / gqa_repeat_kv are not ported")
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    pdt = getattr(torch, cfg.attn_probs_dtype)
    qg = q.reshape(b, s, hkv, g, dh).to(pdt) * torch.tensor(dh**-0.5, dtype=pdt)
    nchunks = max(t // cfg.attn_kv_chunk, 1)
    cs = t // nchunks
    if t % cs:
        raise ValueError(f"{t} keys do not split into chunks of {cs}")
    m = torch.full((b, hkv, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, s, dh), dtype=torch.float32, device=q.device)
    for c in range(nchunks):
        kc = k[:, c * cs : (c + 1) * cs].to(pdt)
        vc = v[:, c * cs : (c + 1) * cs].to(pdt)
        sc = torch.einsum("bskgd,bckd->bkgsc", qg, kc).float()
        if cfg.attn_softcap > 0.0:
            sc = cfg.attn_softcap * torch.tanh(sc / cfg.attn_softcap)
        d = qpos[:, None] - kpos[None, c * cs : (c + 1) * cs]
        if kind == "none":
            ok = torch.ones_like(d, dtype=torch.bool)
        elif kind == "local":
            ok = (d >= 0) & (d < cfg.local_window)
        else:
            ok = d >= 0
        sc = sc + torch.where(ok, 0.0, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        scale = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None]).to(pdt)
        l = l * scale + p.sum(dim=-1).float()
        acc = acc * scale[..., None] + torch.einsum("bkgsc,bckd->bkgsd", p, vc).float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def self_attention(
    p: dict,
    x: torch.Tensor,          # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    kind: str = "global",
    key=None,
) -> torch.Tensor:
    """Full-sequence causal self-attention with RoPE: (B, S, D).  Keys:
    ``split(key)`` into the q/k/v projections' key and w_o's."""
    b, s, _ = x.shape
    kq = ko = None
    if key is not None:
        kq, ko = R.split(key)
    q, k, v = qkv(p, x, cfg, kq)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    qpos = positions[0] if positions.dim() == 2 else positions
    out = attend_full(q, k, v, qpos, qpos, kind, cfg).reshape(b, s, -1)
    return A.analog_matmul(_proj_cfg(cfg), ko, out, p["wo"])


def paged_gather(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(P, bs, ...), (B, W) → (B, W·bs, ...) contiguous window."""
    b, w = table.shape
    bs = pages.shape[1]
    return pages[table.long().clamp_min(0)].reshape((b, w * bs) + pages.shape[2:])


def paged_prefill_self_attention(
    p: dict,
    x: torch.Tensor,          # (1, c, D) one request's suffix chunk
    k_pages: torch.Tensor,    # (P, bs, Hkv, Dh) this layer's pool (in place)
    v_pages: torch.Tensor,
    table_row: torch.Tensor,  # (Wp,) int32 blocks covering the prompt bucket
    q0: int,                  # absolute position of the chunk's start
    cfg: ModelConfig,
    kind: str = "global",
    k_scale_pages: Optional[torch.Tensor] = None,  # (P, bs, Hkv) f32, int8 pools
    v_scale_pages: Optional[torch.Tensor] = None,
    quant_seeds: Optional[torch.Tensor] = None,    # (nbc,) int64 uint32 seeds
) -> torch.Tensor:
    """Write the chunk's K/V into its own pages, then let its queries attend
    over the request's whole table row (shared prefix pages included) at
    absolute positions.  Returns the (1, c, D) output after w_o.

    int8 pools quantize each chunk block under its own content-derived seed
    (``quant_seeds[i]`` for the chunk's i-th block), so any writer of the
    same block content writes bit-identical codes and scales; the scale
    planes are written in place beside the codes."""
    int8_pool = k_pages.dtype == torch.int8
    b, c, _ = x.shape
    bs = k_pages.shape[1]
    positions = (q0 + torch.arange(c, device=x.device))[None].expand(b, c)
    q, k, v = qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    b0 = q0 // bs
    if int8_pool:
        # one fused launch writes every block of the chunk: block i (its
        # bs·Hkv rows, zero-padded past c) draws under quant_seeds[i]
        KOPS.write_kv_int8(k, v, k_pages, v_pages, k_scale_pages, v_scale_pages, quant_seeds,
                           table_row=table_row, b0=b0)
    else:
        paged_write_chunk(k_pages, chunk_to_blocks(k, bs), table_row, b0)
        paged_write_chunk(v_pages, chunk_to_blocks(v, bs), table_row, b0)
    out = KOPS.paged_prefill_attention(
        q[0], k_pages, v_pages, table_row, q0,
        kind=kind, local_window=cfg.local_window, softcap=cfg.attn_softcap,
        k_scale=k_scale_pages if int8_pool else None,
        v_scale=v_scale_pages if int8_pool else None,
    ).to(x.dtype)                      # (c, H, Dh)
    # w_o is a plain matmul here, as in the reference's prefill
    return out.reshape(b, c, -1) @ p["wo"].to(x.dtype)


def paged_decode_self_attention(
    p: dict,
    x: torch.Tensor,         # (B, 1, D)
    k_pages: torch.Tensor,   # (P, bs, Hkv, Dh) this layer's pool (in place)
    v_pages: torch.Tensor,
    table: torch.Tensor,     # (B, W) int32 block table
    pos: torch.Tensor,       # (B,) int32
    cfg: ModelConfig,
    kind: str = "global",
    k_scale_pages: Optional[torch.Tensor] = None,  # (P, bs, Hkv) f32, int8 pools
    v_scale_pages: Optional[torch.Tensor] = None,
    quant_seed: Optional[torch.Tensor] = None,     # int64 uint32 seed (device)
    write: bool = True,
    split_batch: Optional[int] = None,
) -> torch.Tensor:
    """Write this step's K/V into each slot's current block, then attend
    over the W table blocks only.  Returns the (B, 1, D) output after w_o.

    int8 pools quantize the step's K/V rows under ``quant_seed`` and write
    codes and scales in place; attention folds the scales into its math.

    ``write=False`` is the speculative verify's re-read: the draft step
    already wrote this position's K/V, so the pool is attended as it lies
    and left untouched (an int8 pool passes its scale planes, no seed).
    ``split_batch`` launches the card's kernel with the cluster split it
    would choose for that batch width (the draft's), so that a verify row
    sums in its draft row's order; the plain version ignores it."""
    int8_pool = k_pages.dtype == torch.int8
    q, k, v = qkv(p, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    if write and int8_pool:
        KOPS.write_kv_int8(k, v, k_pages, v_pages, k_scale_pages, v_scale_pages, quant_seed,
                           table=table, pos=pos)
    elif write:
        paged_write(k_pages, k, table, pos)
        paged_write(v_pages, v, table, pos)
    out = KOPS.paged_attention(
        q[:, 0], k_pages, v_pages, table, pos,
        kind=kind, local_window=cfg.local_window, softcap=cfg.attn_softcap,
        k_scale=k_scale_pages if int8_pool else None,
        v_scale=v_scale_pages if int8_pool else None, split_batch=split_batch,
    ).reshape(x.shape[0], 1, -1)
    return A.analog_matmul(_proj_cfg(cfg), None, out.to(x.dtype), p["wo"])
