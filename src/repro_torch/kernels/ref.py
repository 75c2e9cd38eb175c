"""Plain PyTorch versions of the kernels (``repro/kernels/ref.py``).

The attention functions are the reference oracle's math over a gathered
window: the table's pages are gathered into a contiguous ``W·bs`` key
window, then a masked full-softmax attention runs in f32.  The stochastic
functions repeat the TPU kernels' counter layout element for element.  The
CPU path of the port runs these; on the card they are what
``chip_smoke.py`` holds each CUDA kernel against.  Nothing on the main
path calls them when a card is present.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import prng

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


def _f32(v: float) -> torch.Tensor:
    """A Python float rounded to f32, as ``jnp.float32(v)`` rounds it."""
    return torch.tensor(v, dtype=torch.float32)


def stoch_round_ref(
    x: torch.Tensor,       # (M, N) f32
    seeds,                 # (G,) int64 uint32 seeds, G divides M (or one int)
    *,
    step: float,
    lo: float,
    hi: float,
) -> torch.Tensor:
    """Stochastic rounding onto ``{lo + k·step} ∩ [lo, hi]``: (M, N) f32.

    The rows fall into G equal groups; group ``g`` is one call of the
    reference's ``stoch_round_ref`` under ``seeds[g]`` on a (M/G, N) array
    padded to ``n_padded`` = N rounded up to 512 columns (as
    ``ops.stoch_round_serving`` pads), so its counter is
    ``row_in_group · n_padded + col``."""
    m, n = x.shape
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=x.device).reshape(-1)
    groups = seeds.shape[0]
    if m % groups:
        raise ValueError(f"{groups} seeds do not split {m} rows evenly")
    n_padded = -(-n // 512) * 512
    rows = m // groups
    idx = (
        torch.arange(rows, device=x.device, dtype=torch.int64)[:, None] * n_padded
        + torch.arange(n, device=x.device, dtype=torch.int64)[None]
    ) & prng.MASK
    lo_t, step_t = _f32(lo).to(x.device), _f32(step).to(x.device)
    inv = _f32(1.0 / step).to(x.device)
    out = []
    for g in range(groups):
        xg = torch.clamp(x[g * rows : (g + 1) * rows].float(), lo, hi)
        t = (xg - lo_t) * inv
        fl = torch.floor(t)
        frac = t - fl
        u = prng.uniform(idx, seeds[g])
        q = fl + (u < frac).to(torch.float32)
        out.append(q * step_t + lo_t)
    return torch.cat(out)


def wta_trial_stride(c_pad: int) -> int:
    """Counter offset between trials, ``t · bm·c_pad·4096`` with the
    reference wrapper's fixed ``bm = 128``, in its wrapping uint32
    arithmetic (``wta_kernel.py:59``)."""
    return (128 * c_pad * 4096) & prng.MASK


def wta_counts_ref(
    z: torch.Tensor,       # (B, C) f32, unpadded
    seed,                  # int64 uint32 seed (tensor or int)
    *,
    n_trials: int,
    vth0: float,
    sigma_z: float,
) -> torch.Tensor:
    """Winner counts over ``n_trials`` WTA trials: (B, C) f32.

    Per trial, ``v = z + σ·gaussian(row·c_pad + col + t·stride)``; the
    neurons with ``v > vth0`` fire, and every fired neuron equal to the
    row's fired maximum wins (exact ties split the vote).  ``c_pad`` = C
    rounded up to 128 is the reference's padded class width; its padded
    classes never fire, so they are not materialised."""
    b, c = z.shape
    c_pad = -(-c // 128) * 128
    seed = torch.as_tensor(seed, dtype=torch.int64, device=z.device)
    zf = z.float()
    base = (
        torch.arange(b, device=z.device, dtype=torch.int64)[:, None] * c_pad
        + torch.arange(c, device=z.device, dtype=torch.int64)[None]
    )
    stride = wta_trial_stride(c_pad)
    sigma, vth = _f32(sigma_z).to(z.device), _f32(vth0).to(z.device)
    neg = torch.finfo(torch.float32).min
    counts = torch.zeros_like(zf)
    for t in range(n_trials):
        idx = (base + t * stride) & prng.MASK
        v = zf + prng.gaussian(idx, seed) * sigma
        fired = v > vth
        vm = torch.where(fired, v, neg)
        vmax = vm.amax(dim=-1, keepdim=True)
        counts += ((vm == vmax) & fired.any(dim=-1, keepdim=True)).to(torch.float32)
    return counts


# crossbar_mac's noise counter runs over the width the TPU kernel pads N to
CROSSBAR_PAD_N = 128


def crossbar_quantize(w: torch.Tensor, qstep: float, w_min: float, w_max: float) -> torch.Tensor:
    """Round-to-nearest (half to even) onto the conductance grid
    ``{w_min + k·qstep}``: ``round((clip(w) − w_min)·f32(1/qstep))·qstep +
    w_min``, a multiply by the f32 reciprocal as the reference does it."""
    w = torch.clamp(w, w_min, w_max)
    return torch.round((w - w_min) * _f32(1.0 / qstep).to(w.device)) * qstep + w_min


def crossbar_mac_ref(
    x: torch.Tensor,        # (M, K) f32
    w: torch.Tensor,        # (K, N) f32, already divided by the range scale
    seed: int,              # uint32 noise seed
    sigma: torch.Tensor,    # 0-d f32 noise std on x's device (unless physical)
    *,
    binarize: bool = True,
    physical_noise: bool = False,
    noise_params: tuple = (0.0, 1.0, 0.0, 1.0, 0),
    quantize: bool = True,
    qstep: float = 2.0 / 31,
    w_min: float = -1.0,
    w_max: float = 1.0,
) -> torch.Tensor:
    """RACA crossbar read: (M, N) f32 (``repro/kernels/ref.py:24``).

    Quantize W onto the conductance grid, z = x·W_q, add thermal noise
    ``σ·gaussian(row·n_padded + col, seed)`` with ``n_padded`` = N rounded
    up to 128 (the TPU kernel's padded width), then read out linearly or
    through the comparator ``(z + noise > 0)``.  σ is the device scalar,
    or, with ``physical_noise``, the column's Johnson noise
    ``sqrt(4kTΔf·(g0·ΣW_q + 2·k_rows·g_ref)) / (v_read·g0)``."""
    m, _ = x.shape
    n = w.shape[1]
    wq = crossbar_quantize(w.float(), qstep, w_min, w_max) if quantize else w.float()
    z = x.float() @ wq
    if physical_noise:
        four_ktdf, g0, g_ref, v_read, k_rows = noise_params
        sum_g = g0 * wq.sum(dim=0, keepdim=True) + 2.0 * k_rows * g_ref
        sigma = torch.sqrt(four_ktdf * sum_g) / (v_read * g0)
    n_padded = -(-n // CROSSBAR_PAD_N) * CROSSBAR_PAD_N
    gidx = (
        torch.arange(m, device=x.device, dtype=torch.int64)[:, None] * n_padded
        + torch.arange(n, device=x.device, dtype=torch.int64)[None]
    ) & prng.MASK
    v = z + prng.gaussian(gidx, seed) * sigma
    return (v > 0.0).to(torch.float32) if binarize else v
