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

from repro_torch import random as R
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


# draws per slice of the threefry sampler's plain version (bounds its
# int64 temporaries at ~32 MB each)
WTA_SAMPLE_SLICE = 1 << 22


def _fold_keys(keys: torch.Tensor, folds: Optional[torch.Tensor]) -> tuple:
    """Per-row threefry keys after ``fold_in`` of each column of ``folds``
    in turn: (N, 2) int64 keys and (N, F) int64 words → two (N,) int64
    tensors, the keys' words."""
    k1, k2 = keys[:, 0], keys[:, 1]
    for j in range(0 if folds is None else folds.shape[1]):
        k1, k2 = R.threefry2x32(k1, k2, 0, folds[:, j] & R.MASK)
    return k1, k2


def wta_trial_counts_ref(
    z: torch.Tensor,                 # (N, C) any float dtype
    keys: torch.Tensor,              # (N, 2) int64 threefry keys (uint32 words)
    folds: Optional[torch.Tensor],   # (N, F) int64, F <= 2, or None
    *,
    n_trials: int,
    vth0: float,
    sigma_z: float,
    layout: tuple[int, int],         # (trial stride, row stride) of the counter
) -> tuple[torch.Tensor, torch.Tensor]:
    """WTA winner counts under threefry noise (``repro/core/wta.py``'s
    ``wta_trials``): (counts (N, C) f32, n_decisions (N,) f32).

    Row n's key is ``keys[n]`` with ``folds[n]`` folded in, in order.
    Trial t of row n draws ``normal`` at the flat counter ``t·layout[0] +
    n·layout[1] + c`` for column c, ``v = z + σ·n``; the columns with ``v >
    vth0`` fire (NaN never does), the largest fired ``v`` wins, the lowest
    column on a tie, and a trial in which nothing fires casts no vote."""
    n, c = z.shape
    dev = z.device
    zf = z.float()
    k1, k2 = _fold_keys(keys, folds)
    k1, k2 = k1[None, :, None], k2[None, :, None]
    ts, rs = layout
    base = (torch.arange(n, device=dev, dtype=torch.int64)[:, None] * rs
            + torch.arange(c, device=dev, dtype=torch.int64)[None])
    sigma, vth = _f32(sigma_z).to(dev), _f32(vth0).to(dev)
    counts = torch.zeros_like(zf)
    n_dec = torch.zeros(n, dtype=torch.float32, device=dev)
    per = max(1, WTA_SAMPLE_SLICE // max(n * c, 1))
    for t0 in range(0, n_trials, per):
        t = torch.arange(t0, min(t0 + per, n_trials), device=dev, dtype=torch.int64)
        idx = t[:, None, None] * ts + base[None]                   # (Tc, N, C)
        b1, b2 = R.threefry2x32(k1, k2, idx >> 32, idx & R.MASK)
        u = R.uniform_from_bits(b1 ^ b2, R.NORMAL_LO, 1.0)
        v = zf + (R.erf_inv(u) * R.SQRT2_F32) * sigma
        fired = v > vth
        win = torch.where(fired, v, -torch.inf).argmax(dim=-1)     # (Tc, N)
        hit = fired.any(dim=-1)
        counts.scatter_add_(1, win.T, hit.T.to(torch.float32))
        n_dec += hit.sum(dim=0, dtype=torch.float32)
    return counts, n_dec


def sigmoid_sample_ref(
    acc: torch.Tensor,               # (M, N) f32
    bias: Optional[torch.Tensor],    # (N,) f32 or None
    *,
    beta: float,
    key: tuple[int, int],
    offset: int = 0,
) -> torch.Tensor:
    """Binary stochastic Sigmoid neurons (``repro/core/neurons.py:52-84``):
    y (M, N) f32 in {0, 1}, 1 where ``u < sigmoid(β·(acc + bias))``, with
    ``u`` jax's threefry ``uniform`` at the flat counter ``offset + m·N +
    n`` under ``key`` (``uniform(key, (M, N))`` for offset 0)."""
    m, n = acc.shape
    z = acc if bias is None else acc + bias
    p = torch.sigmoid(beta * z)
    bits = R.random_bits(key, (m, n), acc.device, start=offset, count=m * n)
    u = R.uniform_from_bits(bits, 0.0, 1.0).reshape(m, n)
    return (u < p).to(torch.float32)


# crossbar_mac's noise counter runs over the width the TPU kernel pads N to
CROSSBAR_PAD_N = 128


def crossbar_levels(w: torch.Tensor, qstep: float, w_min: float, w_max: float) -> torch.Tensor:
    """Grid level of each weight, an integer-valued f32 in [0, levels):
    ``round((clip(w) − w_min)·f32(1/qstep))`` (half to even), a multiply
    by the f32 reciprocal as the reference does it."""
    w = torch.clamp(w, w_min, w_max)
    return torch.round((w - w_min) * _f32(1.0 / qstep).to(w.device))


def crossbar_quantize(w: torch.Tensor, qstep: float, w_min: float, w_max: float) -> torch.Tensor:
    """Round-to-nearest (half to even) onto the conductance grid
    ``{w_min + k·qstep}``: ``level·qstep + w_min``."""
    return crossbar_levels(w, qstep, w_min, w_max) * qstep + w_min


def crossbar_physical_sigma(sum_wq: torch.Tensor, noise_params: tuple) -> torch.Tensor:
    """Each column's Johnson noise from its ``ΣW_q``:
    ``sqrt(4kTΔf·(g0·ΣW_q + 2·k_rows·g_ref)) / (v_read·g0)``."""
    four_ktdf, g0, g_ref, v_read, k_rows = noise_params
    return torch.sqrt(four_ktdf * (g0 * sum_wq + 2.0 * k_rows * g_ref)) / (v_read * g0)


def crossbar_readout(z: torch.Tensor, seed: int, sigma: torch.Tensor, binarize: bool) -> torch.Tensor:
    """Add the read noise ``σ·gaussian(row·n_padded + col, seed)``, with
    ``n_padded`` = N rounded up to 128 (the TPU kernel's padded width),
    then read out linearly or through the comparator ``(z + noise > 0)``."""
    m, n = z.shape
    n_padded = -(-n // CROSSBAR_PAD_N) * CROSSBAR_PAD_N
    gidx = (
        torch.arange(m, device=z.device, dtype=torch.int64)[:, None] * n_padded
        + torch.arange(n, device=z.device, dtype=torch.int64)[None]
    ) & prng.MASK
    v = z + prng.gaussian(gidx, seed) * sigma
    return (v > 0.0).to(torch.float32) if binarize else v


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

    Quantize W onto the conductance grid, z = x·W_q, then
    :func:`crossbar_readout`.  σ is the device scalar, or, with
    ``physical_noise``, each column's :func:`crossbar_physical_sigma`."""
    wq = crossbar_quantize(w.float(), qstep, w_min, w_max) if quantize else w.float()
    z = x.float() @ wq
    if physical_noise:
        sigma = crossbar_physical_sigma(wq.sum(dim=0, keepdim=True), noise_params)
    return crossbar_readout(z, seed, sigma, binarize)


# The tensor-core read works in the level domain: Wq = qstep·(C + center)
# + w_min with C = L − center, so z = qstep·(x @ C) + c0·Σ_k x with
# c0 = w_min + center·qstep; x is split into bf16 pieces whose products
# with the small integers C are exact.
CROSSBAR_SLICE_K = 64       # the kernel's k-slice; K is padded to it
MAX_LEVEL_CENTER = 256      # |C| <= 256 is exact in bf16


def level_center(qstep: float, w_min: float, w_max: float) -> int:
    """The level subtracted so that C = L − center is centered on 0:
    (levels − 1) // 2.  Raises where |C| would not be exact in bf16."""
    steps = round((w_max - w_min) / qstep)
    center = steps // 2
    if steps - center > MAX_LEVEL_CENTER:
        raise ValueError(f"crossbar_mac takes at most {2 * MAX_LEVEL_CENTER + 1} levels, "
                         f"got {steps + 1}")
    return center


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (10 mantissa bits, half to even)."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.to(torch.int32).view(torch.float32)


def split_pieces(x: torch.Tensor, pieces: int = 3, fmt: str = "bf16") -> list[torch.Tensor]:
    """x ≈ x1 + … + x_pieces, each piece the ``fmt`` ("bf16" or "tf32")
    rounding of what the earlier pieces left (f32 values).  Three bf16
    pieces hold every f32 exactly; one piece is a single pass."""
    rnd = (lambda t: t.to(torch.bfloat16).float()) if fmt == "bf16" else round_tf32
    out, rest = [], x.float()
    for _ in range(pieces):
        out.append(rnd(rest))
        rest = rest - out[-1]
    return out


def crossbar_prepass_ref(
    x: torch.Tensor, w: torch.Tensor, qstep: float, w_min: float, w_max: float,
    *, pieces: int = 3, fmt: str = "bf16",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The crossbar prepass: x (M, K), w (K, N) f32 → x's pieces (P, M,
    Kp), its row sums (M,) f32, the centered levels transposed (N, Kp) and
    their integer column sums (N,) int32; Kp is K rounded up to the
    k-slice, and pieces and levels are zero past K.  The pieces and levels
    are f32 tensors here, bf16 on the card (the values are equal)."""
    m, k = x.shape
    kp = -(-k // CROSSBAR_SLICE_K) * CROSSBAR_SLICE_K
    center = level_center(qstep, w_min, w_max)
    c = crossbar_levels(w.float(), qstep, w_min, w_max) - center
    ct = torch.zeros((w.shape[1], kp), dtype=torch.float32, device=x.device)
    ct[:, :k] = c.T
    xs = torch.zeros((pieces, m, kp), dtype=torch.float32, device=x.device)
    xs[:, :, :k] = torch.stack(split_pieces(x, pieces, fmt))
    return xs, x.float().sum(dim=1), ct, c.sum(dim=0).to(torch.int32)


def crossbar_gemm_ref(
    xs: torch.Tensor, rowsum: torch.Tensor, ct: torch.Tensor, colsum: torch.Tensor,
    k: int, seed: int, sigma: torch.Tensor, *,
    binarize: bool = True, physical_noise: bool = False,
    noise_params: tuple = (0.0, 1.0, 0.0, 1.0, 0),
    qstep: float = 2.0 / 31, w_min: float = -1.0, w_max: float = 1.0,
) -> torch.Tensor:
    """The tensor-core read from the prepass's outputs: per k-slice, the
    pieces' products with C summed (the kernel's tensor-core tile), slices
    added in order in f32, then ``z = qstep·acc + c0·rowsum``,
    ``ΣW_q = qstep·ΣC + c0·K`` and :func:`crossbar_readout`."""
    center = level_center(qstep, w_min, w_max)
    c0 = float(_f32(w_min + center * qstep))
    q = float(_f32(qstep))
    acc = torch.zeros((xs.shape[1], ct.shape[0]), dtype=torch.float32, device=xs.device)
    for k0 in range(0, ct.shape[1], CROSSBAR_SLICE_K):
        sl = slice(k0, k0 + CROSSBAR_SLICE_K)
        acc = acc + sum(p[:, sl] @ ct[:, sl].T for p in xs)
    z = q * acc + c0 * rowsum[:, None]
    if physical_noise:
        sum_wq = q * colsum.to(torch.float32) + c0 * float(k)
        sigma = crossbar_physical_sigma(sum_wq[None], noise_params)
    return crossbar_readout(z, seed, sigma, binarize)


def crossbar_level_read(
    x: torch.Tensor, w: torch.Tensor, seed: int, sigma: torch.Tensor, *,
    pieces: int = 3, fmt: str = "bf16", **kw,
) -> torch.Tensor:
    """The kernel's arithmetic end to end (quantized reads): the prepass,
    then the level-domain GEMM; ``pieces=1`` models one bf16 or TF32 pass
    of x.  ``kw`` as :func:`crossbar_mac_ref` (``quantize`` excepted)."""
    kw.pop("quantize", None)
    xs, rowsum, ct, colsum = crossbar_prepass_ref(
        x, w, kw.get("qstep", 2.0 / 31), kw.get("w_min", -1.0), kw.get("w_max", 1.0),
        pieces=pieces, fmt=fmt,
    )
    return crossbar_gemm_ref(xs, rowsum, ct, colsum, x.shape[1], seed, sigma, **kw)


# ---------------------------------------------------------------------------
# The int8 KV write: quantize K/V rows, scatter codes and scales into pages.
# ---------------------------------------------------------------------------


def quantize_kv_int8_ref(x: torch.Tensor, seeds) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization with unbiased stochastic
    rounding: ``x`` (..., Dh) → (codes int8 (..., Dh), scale f32 (...,)),
    ``scale = max(max|x|, 1e-6)``, codes = SR(``x / scale · 127``) onto
    the integers of [−127, 127].  ``seeds`` (G,) split the rows of
    ``x.reshape(-1, Dh)`` into G groups, as :func:`stoch_round_ref`."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6)
    t = xf / scale[..., None] * 127.0   # a divide, then a multiply, as the reference
    q = stoch_round_ref(t.reshape(-1, t.shape[-1]), seeds, step=1.0, lo=-127.0, hi=127.0)
    return q.reshape(t.shape).to(torch.int8), scale


def paged_write(
    pages: torch.Tensor,  # (P, bs, ...) block pool, written in place
    new: torch.Tensor,    # (B, 1, ...) this step's K/V rows
    table: torch.Tensor,  # (B, W) int block table
    pos: torch.Tensor,    # (B,) int logical write position per slot
) -> None:
    """Scatter one token's K/V row (or its scales) per slot into its
    current block.

    ``pos // bs`` is clamped into the table width so evicted slots whose
    ``pos`` keeps advancing stay in bounds; unassigned (-1) ids go to the
    trash page 0."""
    bs = pages.shape[1]
    pos = pos.long()
    blk = (pos // bs).clamp(0, table.shape[1] - 1)
    page_ids = table.long().gather(1, blk[:, None])[:, 0].clamp_min(0)
    pages[page_ids, pos % bs] = new[:, 0].to(pages.dtype)


def paged_write_chunk(
    pages: torch.Tensor,      # (P, bs, ...) block pool, written in place
    new: torch.Tensor,        # (nbc, bs, ...) block-shaped chunk rows
    table_row: torch.Tensor,  # (Wp,) int one request's block-table row
    b0: int,                  # first block index the chunk covers
) -> None:
    """Scatter a block-aligned suffix chunk's K/V into its own pages."""
    nbc = new.shape[0]
    ids = table_row[b0 : b0 + nbc].long().clamp_min(0)
    pages[ids] = new.to(pages.dtype)


def chunk_to_blocks(x: torch.Tensor, bs: int) -> torch.Tensor:
    """(1, c, ...) chunk rows → (nbc, bs, ...) zero-padded whole blocks."""
    c = x.shape[1]
    nbc = -(-c // bs)
    out = x.new_zeros((nbc * bs,) + tuple(x.shape[2:]))
    out[:c] = x[0]
    return out.reshape((nbc, bs) + tuple(x.shape[2:]))


def write_kv_int8_ref(
    k: torch.Tensor,          # decode (B, 1, Hkv, Dh); chunk (1, c, Hkv, Dh)
    v: torch.Tensor,
    k_pages: torch.Tensor,    # (P, bs, Hkv, Dh) int8, written in place
    v_pages: torch.Tensor,
    k_scale: torch.Tensor,    # (P, bs, Hkv) f32, written in place
    v_scale: torch.Tensor,
    seeds: torch.Tensor,      # decode (1,); chunk (nbc,) int64 uint32 seeds
    *,
    table: Optional[torch.Tensor] = None,   # decode: (B, W) int32 block table
    pos: Optional[torch.Tensor] = None,     # decode: (B,) int32 write positions
    table_row: Optional[torch.Tensor] = None,  # chunk: (Wp,) int32 table row
    b0: int = 0,                            # chunk: its first block index
) -> None:
    """The whole int8 write of one layer: quantize K under ``seeds`` and V
    under the seeds offset by the golden-ratio constant (so k and v never
    share rounding draws), then scatter codes and scales in place.

    Decode (``table``, ``pos``): one seed over the B·Hkv rows, each slot's
    row to ``table[b, clamp(pos//bs)]`` (−1 → trash page 0) at ``pos %
    bs``.  Chunk (``table_row``, ``b0``): the chunk is cut into whole
    blocks (rows past c are zeros: scale 1e-6, codes 0), block i draws
    under ``seeds[i]`` with its counter restarting at row 0, and lands in
    page ``table_row[b0 + i]``."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64, device=k.device).reshape(-1)
    v_seeds = (seeds + prng.GOLDEN) & prng.MASK
    if table is not None:
        k8, ks = quantize_kv_int8_ref(k, seeds)
        v8, vs = quantize_kv_int8_ref(v, v_seeds)
        for pages, new in ((k_scale, ks), (v_scale, vs), (k_pages, k8), (v_pages, v8)):
            paged_write(pages, new, table, pos)
        return
    bs = k_pages.shape[1]
    kb, vb = chunk_to_blocks(k, bs), chunk_to_blocks(v, bs)
    k8, ks = quantize_kv_int8_ref(kb, seeds)
    v8, vs = quantize_kv_int8_ref(vb, v_seeds)
    for pages, new in ((k_scale, ks), (v_scale, vs), (k_pages, k8), (v_pages, v8)):
        paged_write_chunk(pages, new, table_row, b0)
