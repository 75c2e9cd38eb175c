"""Attention (``repro/models/attention.py``): the full-sequence
self-attention of the training path and of the dense prefill, the
encoder-decoder's cross-attention (:func:`cross_attention`), the dense
decode attention (:func:`attend_one_token`, :func:`decode_self_attention`)
and the paged attention of the serving path.

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

The dense layout's attention is plain PyTorch on every device, as the
reference's is jnp on every backend (it reaches no Pallas kernel): its
cache is a per-slot ``max_len`` window written in place at ``pos``, an
int8 one with nearest-rounded codes and per-(slot, position, head) scales.
The reference's ``init_cache`` / ``KVCache`` have no caller there and are
not ported.

Paged attention and the int8 KV write go through ``kernels.ops``: the
hand-written CUDA kernels for CUDA tensors, their plain PyTorch versions
for CPU tensors.  int8 pools carry per-(page, row, kv head) f32 scale
planes beside the codes; one fused write quantizes a layer's K/V rows and
scatters codes and scales in place.

On a serving mesh (``parallel.use_pool_shards``, installed by the sharded
entry points of ``launch/specs.py``) the paged layers run on this rank's
shards of the slots, pages and kv heads, with the collectives that gather
them (:func:`_sharded_paged_decode`, :func:`_sharded_paged_prefill`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import parallel as PX
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
    acfg = _proj_cfg(cfg)
    keys = (None,) * 3 if key is None else R.split(key, 3)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = PX.unflatten(A.analog_matmul(acfg, keys[0], x, p["wq"]), -1, (h, dh))
    k = PX.unflatten(A.analog_matmul(acfg, keys[1], x, p["wk"]), -1, (hkv, dh))
    v = PX.unflatten(A.analog_matmul(acfg, keys[2], x, p["wv"]), -1, (hkv, dh))
    return (PX.shard(q, ("batch", "seq", "heads", None)),
            PX.shard(k, ("batch", "seq", "kv_heads", None)),
            PX.shard(v, ("batch", "seq", "kv_heads", None)))


def _maybe_expand(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig):
    """The head-layout knobs (``repro/models/attention.py:86-115``):
    ``gqa_repeat_kv`` repeats each KV head over its query group, and
    ``attn_pad_heads`` pads the query heads with zeros up to that count.
    KV is repeated at the original head count, before any padding, so the
    q → kv grouping holds, and padding implies the repeated layout (the
    padded KV heads are zeros beside the padded queries).  Both are the
    identity on the real heads; the caller slices the padded ones away."""
    h, hkv = q.shape[2], k.shape[2]
    pad = cfg.attn_pad_heads - h if cfg.attn_pad_heads > h else 0
    repeat = cfg.gqa_repeat_kv or pad
    if repeat and hkv < h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
        hkv = h
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad))
        if hkv == h:
            k = torch.nn.functional.pad(k, (0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if repeat:
        k = PX.shard(k, ("batch", "seq", "heads", None))
        v = PX.shard(v, ("batch", "seq", "heads", None))
    return PX.shard(q, ("batch", "seq", "heads", None)), k, v


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
    accumulation in f32, as the reference's ``attend_full``.  The head
    knobs (:func:`_maybe_expand`) apply first; padded heads are sliced
    away from the output."""
    h_orig = q.shape[2]
    q, k, v = _maybe_expand(q, k, v, cfg)
    b, s, h, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    pdt = getattr(torch, cfg.attn_probs_dtype)
    qg = PX.unflatten(q, 2, (hkv, g)).to(pdt) * torch.tensor(dh**-0.5, dtype=pdt)
    nchunks = max(t // cfg.attn_kv_chunk, 1)
    cs = t // nchunks
    if t % cs:
        raise ValueError(f"{t} keys do not split into chunks of {cs}")
    # laid out as the queries (on a mesh: their batch and head split)
    rows = qg.permute(0, 2, 3, 1, 4)
    m = torch.full_like(rows[..., 0], NEG_INF, dtype=torch.float32,
                        memory_format=torch.contiguous_format)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(rows, dtype=torch.float32, memory_format=torch.contiguous_format)
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
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)[:, :, :h_orig].to(q.dtype)


def self_attention(
    p: dict,
    x: torch.Tensor,          # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
    kind: str = "global",
    key=None,
    use_rope: bool = True,
) -> torch.Tensor:
    """Full-sequence self-attention (causal, local, or with ``kind="none"``
    bidirectional), with RoPE unless ``use_rope`` is false: (B, S, D).
    Keys: ``split(key)`` into the q/k/v projections' key and w_o's."""
    b, s, _ = x.shape
    kq = ko = None
    if key is not None:
        kq, ko = R.split(key)
    q, k, v = qkv(p, x, cfg, kq)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    qpos = positions[0] if positions.dim() == 2 else positions
    out = PX.same_grad_layout(attend_full(q, k, v, qpos, qpos, kind, cfg).reshape(b, s, -1))
    return PX.shard(A.analog_matmul(_proj_cfg(cfg), ko, out, p["wo"]), ("batch", "seq", "embed"))


def cross_attention(
    p: dict,
    x: torch.Tensor,        # (B, S, D) decoder stream
    enc_out: torch.Tensor,  # (B, T, D) encoder output
    cfg: ModelConfig,
    key=None,
) -> torch.Tensor:
    """Decoder cross-attention over the encoder's output, no mask and no
    RoPE: q from ``x``, k and v from ``enc_out``, then w_o; (B, S, D).
    Keys: ``split(key, 4)``, one a projection in that order."""
    b, s, _ = x.shape
    t = enc_out.shape[1]
    acfg = _proj_cfg(cfg)
    keys = (None,) * 4 if key is None else R.split(key, 4)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = PX.unflatten(A.analog_matmul(acfg, keys[0], x, p["wq"]), -1, (h, dh))
    k = PX.unflatten(A.analog_matmul(acfg, keys[1], enc_out, p["wk"]), -1, (hkv, dh))
    v = PX.unflatten(A.analog_matmul(acfg, keys[2], enc_out, p["wv"]), -1, (hkv, dh))
    qpos = torch.arange(s, device=x.device)
    kpos = torch.arange(t, device=x.device)
    out = PX.same_grad_layout(attend_full(q, k, v, qpos, kpos, "none", cfg).reshape(b, s, -1))
    return PX.shard(A.analog_matmul(acfg, keys[3], out, p["wo"]), ("batch", "seq", "embed"))


def _write_at(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """Write ``new`` (B, 1, ...) at row ``pos[b]`` of each slot's window in
    ``buf`` (B, Smax, ...), in place in ``buf``'s own storage.  A position
    past the window is clamped to its last row, as the reference's
    ``dynamic_update_slice`` clamps: an idle slot's ``pos`` keeps counting
    up, and its writes land where no live request reads."""
    PX.write_at(buf, new, pos)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(slot, position, head) int8 codes of K/V rows, by
    deterministic nearest rounding: (codes int8, scales f32 (..., Hkv)).
    The scale factors out of the head_dim contraction, so attention over
    an int8 cache multiplies its scores and weights by ``scale / 127``."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-6)
    q = torch.round(xf / scale[..., None] * 127.0)
    return q.to(torch.int8), scale


def attend_one_token(
    q: torch.Tensor,        # (B, 1, H, Dh), RoPE applied
    k_buf: torch.Tensor,    # (B, T, Hkv, Dh) float or int8
    v_buf: torch.Tensor,
    pos: torch.Tensor,      # (B,) last valid key position
    cfg: ModelConfig,
    kind: str = "global",
    k_scale: Optional[torch.Tensor] = None,  # (B, T, Hkv) for int8 buffers
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One query token's attention over a contiguous KV window, the dense
    layout's readout: (B, 1, H·Dh) f32, before w_o.

    The compute dtype is the reference's: bf16 for an int8 cache, else
    ``cfg.attn_probs_dtype``.  Operands are rounded to it and the products
    summed in f32 (the reference's ``preferred_element_type``), which an
    f32 einsum over the rounded operands reproduces: a product of two bf16
    values is exact in f32.  Keys past ``pos`` (and, for ``local``, before
    the window) score NEG_INF and weigh exactly 0."""
    b, t = k_buf.shape[0], k_buf.shape[1]
    hkv = cfg.n_kv_heads
    int8_cache = k_buf.dtype == torch.int8
    cdt = torch.bfloat16 if int8_cache else getattr(torch, cfg.attn_probs_dtype)
    scale = torch.tensor(cfg.head_dim**-0.5, dtype=cdt)
    qg = PX.unflatten(q, 2, (hkv, q.shape[2] // hkv)).to(cdt) * scale
    sc = torch.einsum("bskgd,btkd->bkgst", qg.float(), k_buf.to(cdt).float())
    if int8_cache:
        sc = sc * (k_scale.transpose(1, 2) / 127.0)[:, :, None, None, :]
    if cfg.attn_softcap > 0.0:
        sc = cfg.attn_softcap * torch.tanh(sc / cfg.attn_softcap)
    kpos = torch.arange(t, device=q.device)[None]
    ok = kpos <= pos[:, None]
    if kind == "local":
        ok &= kpos > (pos[:, None] - cfg.local_window)
    sc = sc + torch.where(ok, 0.0, NEG_INF)[:, None, None, None, :]
    w = torch.softmax(sc, dim=-1)
    if int8_cache:
        w = w * (v_scale.transpose(1, 2) / 127.0)[:, :, None, None, :]
    out = torch.einsum("bkgst,btkd->bskgd", w.to(cdt).float(), v_buf.to(cdt).float())
    return out.reshape(b, 1, -1)


def decode_self_attention(
    p: dict,
    x: torch.Tensor,         # (B, 1, D)
    k_cache: torch.Tensor,   # (B, Smax, Hkv, Dh) float or int8 (in place)
    v_cache: torch.Tensor,
    pos: torch.Tensor,       # (B,) write index
    cfg: ModelConfig,
    kind: str = "global",
    k_scale: Optional[torch.Tensor] = None,  # (B, Smax, Hkv) f32, int8 caches
    v_scale: Optional[torch.Tensor] = None,
    use_rope: bool = True,
) -> torch.Tensor:
    """One token's attention against the dense cache: write this step's
    K/V at ``pos`` in place (an int8 cache: its nearest-rounded codes and
    scales, :func:`quantize_kv`), then attend over the whole ``Smax``
    window (:func:`attend_one_token`).  Returns (B, 1, D) after w_o.
    ``use_rope=False`` is the encoder-decoder's decoder, which has learned
    positions instead."""
    int8_cache = k_cache.dtype == torch.int8
    q, k, v = qkv(p, x, cfg)
    if use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
    if int8_cache:
        k8, ks = quantize_kv(k)
        v8, vs = quantize_kv(v)
        _write_at(k_cache, k8, pos)
        _write_at(v_cache, v8, pos)
        _write_at(k_scale, ks, pos)
        _write_at(v_scale, vs, pos)
    else:
        _write_at(k_cache, k, pos)
        _write_at(v_cache, v, pos)
    out = attend_one_token(q, k_cache, v_cache, pos, cfg, kind,
                           k_scale=k_scale, v_scale=v_scale).to(x.dtype)
    # (B, H·Dh) @ w_o: the product a 3-D matmul folds to, which a DTensor's
    # matmul (its size-1 row's stride) would expand into a batched one instead
    o = A.analog_matmul(_proj_cfg(cfg), None, out[:, 0], p["wo"])[:, None]
    return PX.shard(o, ("batch", "seq", "embed"))


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
    planes are written in place beside the codes.  Under a serving mesh
    the pool is this rank's shard: :func:`_sharded_paged_prefill`."""
    int8_pool = k_pages.dtype == torch.int8
    b, c, _ = x.shape
    bs = k_pages.shape[1]
    positions = (q0 + torch.arange(c, device=x.device))[None].expand(b, c)
    q, k, v = qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    b0 = q0 // bs
    px = PX.pool_shards()
    if px is not None:
        out = _sharded_paged_prefill(px, q, k, v, k_pages, v_pages, table_row, q0, cfg, kind,
                                     k_scale_pages, v_scale_pages, quant_seeds)
        return out.to(x.dtype).reshape(b, c, -1) @ p["wo"].to(x.dtype)
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
    sums in its draft row's order; the plain version ignores it.

    Under a serving mesh (``parallel.use_pool_shards``) the slots, pages
    and kv heads are this rank's shards: :func:`_sharded_paged_decode`."""
    int8_pool = k_pages.dtype == torch.int8
    q, k, v = qkv(p, x, cfg)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    px = PX.pool_shards()
    if px is not None:
        out = _sharded_paged_decode(px, q, k, v, k_pages, v_pages, table, pos, cfg, kind,
                                    k_scale_pages, v_scale_pages, quant_seed, write, split_batch)
        return A.analog_matmul(_proj_cfg(cfg), None, out.to(x.dtype), p["wo"])
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


# ---------------------------------------------------------------------------
# The paged layers on a serving mesh: this rank's shards of the slots (over
# "data"), of the pool's pages (over "data") and of its kv heads (over
# "model"), with the collectives the reference's GSPMD inserts.
# ---------------------------------------------------------------------------


def _sharded_paged_decode(px, q, k, v, k_pages, v_pages, table, pos, cfg, kind,
                          k_scale_pages, v_scale_pages, quant_seed, write, split_batch):
    """One layer's decode over this rank's slots (B_l rows of ``q``, ``k``,
    ``v``, ``table``, ``pos``) and pool shard: (B_l, 1, H·Dh) f32.

    The layer's pool is gathered whole over "data" (every page, this
    rank's kv heads).  Each step's new K/V rows are gathered over "data",
    so every rank writes every slot's row into its gathered copy (int8:
    the fused write under the step's seed, as unsharded; with the heads
    split, the same codes quantized whole and this rank's heads
    scattered), then copies its own pages back.  Its slots attend over
    the gathered pool with their query heads of its kv heads, and the
    head outputs are gathered over "model"."""
    int8 = k_pages.dtype == torch.int8
    mine = [k_pages, v_pages] + ([k_scale_pages, v_scale_pages] if int8 else [])
    whole = [px.gather_pages(t) for t in mine]
    if write:
        k_all, v_all = px.gather_slots(k), px.gather_slots(v)
        t_all, p_all = px.gather_slots(table), px.gather_slots(pos)
        if int8 and not px.heads:
            KOPS.write_kv_int8(k_all, v_all, *whole, quant_seed, table=t_all, pos=p_all)
        else:
            rows = KOPS.quantize_kv_pair_int8(k_all, v_all, quant_seed) if int8 else (k_all, v_all)
            # quantize_kv_pair_int8 gives (k codes, k scales, v codes, v scales)
            order = (rows[0], rows[2], rows[1], rows[3]) if int8 else rows
            for pages, new in zip(whole, order):
                paged_write(pages, px.own_heads(new, 2), t_all, p_all)
        for w, t in zip(whole, mine):
            px.keep_own_pages(w, t)
    out = KOPS.paged_attention(
        px.own_heads(q[:, 0], 1).contiguous(), whole[0], whole[1], table, pos,
        kind=kind, local_window=cfg.local_window, softcap=cfg.attn_softcap,
        k_scale=whole[2] if int8 else None, v_scale=whole[3] if int8 else None,
        split_batch=split_batch,
    )
    return px.gather_heads(out, 1).reshape(q.shape[0], 1, -1)


def _sharded_paged_prefill(px, q, k, v, k_pages, v_pages, table_row, q0, cfg, kind,
                           k_scale_pages, v_scale_pages, quant_seeds):
    """One layer of a suffix chunk (one request, on every rank alike)
    over this rank's pool shard: (c, H, Dh) f32.  The layer's pool is
    gathered over "data", the chunk's blocks written into the gathered
    copy (this rank's kv heads), its own pages copied back; the chunk
    attends with its query heads of this rank's kv heads, gathered over
    "model" after."""
    int8 = k_pages.dtype == torch.int8
    bs = k_pages.shape[1]
    b0 = q0 // bs
    mine = [k_pages, v_pages] + ([k_scale_pages, v_scale_pages] if int8 else [])
    whole = [px.gather_pages(t) for t in mine]
    if int8 and not px.heads:
        KOPS.write_kv_int8(k, v, *whole, quant_seeds, table_row=table_row, b0=b0)
    else:
        kb, vb = chunk_to_blocks(k, bs), chunk_to_blocks(v, bs)
        rows = KOPS.quantize_kv_pair_int8(kb, vb, quant_seeds) if int8 else (kb, vb)
        order = (rows[0], rows[2], rows[1], rows[3]) if int8 else rows
        for pages, new in zip(whole, order):
            paged_write_chunk(pages, px.own_heads(new, 2), table_row, b0)
    for w, t in zip(whole, mine):
        px.keep_own_pages(w, t)
    out = KOPS.paged_prefill_attention(
        px.own_heads(q[0], 1).contiguous(), whole[0], whole[1], table_row, q0,
        kind=kind, local_window=cfg.local_window, softcap=cfg.attn_softcap,
        k_scale=whole[2] if int8 else None, v_scale=whole[3] if int8 else None,
    )
    return px.gather_heads(out, 1)
