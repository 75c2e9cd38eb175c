"""Launch geometry of the attention kernels, and their split-softmax math.

The CUDA kernels cannot run here; what surrounds them can.  These tests
check ``decode_geometry`` / ``split_shares`` and ``prefill_geometry``
(the shapes ``csrc/paged_attention.cu`` and ``csrc/prefill_attention.cu``
launch with), and hold a plain-PyTorch model of the decode kernel's
algorithm against the plain version ``ref.paged_attention_ref``: online
softmax per warp over its pages, warps merged per CTA, CTAs of a cluster
combined with ``exp(m_r - m*)`` under the reference's finite NEG_INF,
including CTAs whose share is empty and shares whose keys are all masked.
Tolerance: 2e-5 absolute / 1e-5 relative, f32 throughout (only the order
of the sums differs).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import prefill_attention as PF
from repro_torch.kernels import ref as TREF

ATOL, RTOL = 2e-5, 1e-5
NEG_INF = torch.tensor(-2.0e38, dtype=torch.float32)
SMEM = 227 * 1024
BF16 = torch.bfloat16


def _first_block(p, local, lw, bs):
    if not local:
        return 0
    lo = p - lw + 1
    return 0 if lo <= 0 else lo // bs


@pytest.mark.parametrize("b", [1, 8])
def test_split_shares_cover_live_pages_exactly(b):
    """For every window bucket W in 1..32 and every live range [w_lo, w_hi)
    inside it, the n_split shares are contiguous, disjoint and cover the
    range; the split never exceeds the cluster limit or half the window."""
    for w in range(1, 33):
        geo = PA.decode_geometry(b, 32, 32, 80, 16, w, BF16)
        ns = geo["n_split"]
        assert geo["grid"] == (ns, 32, b)
        assert ns in (1, 2, 4, 8) and (ns == 1 or 8 * ns <= w)
        for w_lo in range(w + 1):
            for w_hi in range(w_lo, w + 1):
                shares = PA.split_shares(w_lo, w_hi, ns)
                assert len(shares) == ns
                assert shares[0][0] == w_lo and shares[-1][1] == w_hi
                for (lo0, hi0), (lo1, _) in zip(shares, shares[1:]):
                    assert lo0 <= hi0 == lo1
                pages = [p for lo, hi in shares for p in range(lo, hi)]
                assert pages == list(range(w_lo, w_hi))


def test_split_fills_one_wave():
    """The split doubles while the doubled grid fits in one wave of resident
    CTAs and each CTA keeps 8 pages of a full window: at B=1 (where the old
    grid's B*Hkv blocks used 32 of 132 SMs) W=32 splits 4 ways, B=8 over
    bf16 pools stays whole (256 CTAs of 84 KB fill the card's two per SM),
    and int8 pools, whose CTAs fit four per SM, split 2 ways."""
    I8 = torch.int8
    assert PA.decode_geometry(1, 32, 32, 80, 16, 32, BF16)["n_split"] == 4
    assert PA.decode_geometry(1, 32, 32, 80, 16, 16, BF16)["n_split"] == 2
    assert PA.decode_geometry(8, 32, 32, 80, 16, 32, BF16)["n_split"] == 1
    assert PA.decode_geometry(8, 32, 32, 80, 16, 32, I8)["n_split"] == 2
    assert PA.decode_geometry(8, 32, 32, 80, 16, 16, I8)["n_split"] == 2
    assert PA.decode_geometry(8, 32, 32, 80, 16, 1, BF16)["n_split"] == 1
    assert PA.decode_geometry(64, 32, 32, 80, 16, 512, I8)["n_split"] == 1
    assert PA.decode_geometry(8, 32, 32, 80, 16, 32, BF16)["ctas_per_sm"] == 2
    assert PA.decode_geometry(8, 32, 32, 80, 16, 32, I8)["ctas_per_sm"] == 4
    for b in (1, 2, 4, 8, 16):
        for w in (1, 2, 4, 8, 16, 32, 64):
            for kv in (BF16, I8):
                geo = PA.decode_geometry(b, 32, 32, 80, 16, w, kv)
                ns, wave = geo["n_split"], PA.SMS * geo["ctas_per_sm"]
                assert b * 32 * ns <= max(wave, b * 32) and (ns == 1 or ns * 8 <= w)
                grows = 2 * ns * 8 <= w and b * 32 * 2 * ns <= wave
                assert ns == PA.MAX_SPLIT or not grows


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.int8),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
])
@pytest.mark.parametrize("g", [1, 4, 8, 32])
def test_shared_memory_within_the_sm(q_dtype, kv_dtype, g):
    """Both kernels' CTAs stay within the 227 KB a block may use, at the
    heads the port serves (Dh 16, 80, 128, 192 and 256), for every type
    pair and GQA group size G.  Decode over an f32 pool at Dh 128 (two
    32-key stages of 16 KB of K and V for each of four warps would not
    fit) runs four warps of one stage; Dh 80 keeps four warps of two."""
    for dh in (16, 80, 128, 192, 256):
        for bs in (8, 16, 32, 64):
            geo = PA.decode_geometry(8, 32, 32 // g, dh, bs, 32, kv_dtype)
            assert geo["smem_bytes"] <= SMEM and geo["ctas_per_sm"] >= 1, (dh, bs, geo)
            assert geo["rows"] == g and geo["grid"][1] == 32 // g
            if dh <= 80:
                assert (geo["warps"], geo["stages"]) == (4, 2)
            if dh == 128 and kv_dtype == torch.float32:
                assert (geo["warps"], geo["stages"]) == (4, 1)
            pg = PF.prefill_geometry(128, 32, 32 // g, dh, bs, q_dtype, kv_dtype)
            assert pg["smem_bytes"] <= SMEM
            assert pg["route"] == ("tensor-core" if q_dtype == BF16 else "cuda-core")


def test_tile_shape_checks():
    """The wrappers refuse what a TMA box or the tensor-core tile cannot
    hold, before any launch."""
    PA.check_box_shape(80, 16, BF16)
    PA.check_box_shape(80, 16, torch.int8)
    PA.check_box_shape(40, 16, BF16)                 # 80-byte rows
    PA.check_box_shape(20, 64, torch.float32)
    for dh, bs, kv in ((80, 12, BF16), (20, 16, torch.int8), (264, 16, torch.float32)):
        with pytest.raises(ValueError):
            PA.check_box_shape(dh, bs, kv)
    assert list(PF.TC_HEAD_DIMS) == [16, 32, 48, 64, 80, 96, 112, 128, 192, 256]


@pytest.mark.parametrize("s", [1, 15, 16, 31, 32, 33, 37, 50, 128, 300])
@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_prefill_grid_covers_every_query_row(s, q_dtype):
    """Query tiles cover rows 0..S-1 with no tile wholly past S, one tile
    row of the grid per head."""
    geo = PF.prefill_geometry(s, 32, 8, 80, 16, q_dtype, torch.bfloat16)
    tiles, heads = geo["grid"]
    assert heads == 32
    rows = geo["rows"]
    assert tiles * rows >= s and (tiles - 1) * rows < s
    covered = sorted(i for t in range(tiles) for i in range(t * rows, min((t + 1) * rows, s)))
    assert covered == list(range(s))
    assert geo["threads"] == (256 if q_dtype == torch.bfloat16 else 128)


def _split_decode(q, kp, vp, table, pos, *, kind="global", local_window=0, softcap=0.0,
                  k_scale=None, v_scale=None, n_split=1, warps=4, chunk=32,
                  visit_from_zero=False):
    """The decode kernel's algorithm in plain f32 PyTorch: per (slot, kv
    head), CTA r of the cluster takes ``split_shares``' r-th share of the
    live pages, whose keys fall into chunks of 32; warp j takes chunks j,
    j+warps, ... with its own online softmax, the warps merge, then the
    CTAs combine.  Rows of a chunk past the share are masked (they belong
    to the next CTA).  ``visit_from_zero`` starts local windows at page 0
    instead of ``first_block``, so whole shares see only masked keys."""
    b, h, dh = q.shape
    _, bs, hkv, _ = kp.shape
    g = h // hkv
    out = torch.empty((b, h, dh), dtype=torch.float32)
    local = kind == "local"
    for bi in range(b):
        p = int(pos[bi])
        w_hi = min(p // bs + 1, table.shape[1])
        w_lo = 0 if visit_from_zero else _first_block(p, local, local_window, bs)
        for kh in range(hkv):
            qs = q[bi, kh * g:(kh + 1) * g].float() * dh**-0.5
            ctas = []
            for lo, hi in PA.split_shares(w_lo, w_hi, n_split):
                k_lo, k_hi = lo * bs, hi * bs
                n_chunks = -(-(k_hi - k_lo) // chunk)
                states = []
                for wj in range(warps):
                    m = NEG_INF.expand(g).clone()
                    l = torch.zeros(g)
                    acc = torch.zeros(g, dh)
                    for c in range(wj, n_chunks, warps):
                        kpos = k_lo + c * chunk + torch.arange(chunk)
                        live = kpos < k_hi
                        kc = torch.where(live, kpos, 0)
                        page = table[bi, kc // bs].long().clamp_min(0)
                        k = kp[page, kc % bs, kh].float() * live[:, None]
                        v = vp[page, kc % bs, kh].float() * live[:, None]
                        s = qs @ k.T
                        if k_scale is not None:
                            s = s * (k_scale[page, kc % bs, kh] / 127.0)
                        if softcap > 0:
                            s = torch.tanh(s / softcap) * softcap
                        ok = (kpos <= p) & live
                        if local:
                            ok &= kpos > p - local_window
                        s = torch.where(ok, s, NEG_INF)
                        mx = torch.maximum(m, s.max(-1).values)
                        alpha = torch.exp(m - mx)
                        pr = torch.exp(s - mx[:, None])
                        l = l * alpha + pr.sum(-1)
                        if v_scale is not None:
                            pr = pr * (v_scale[page, kc % bs, kh] / 127.0)
                        acc = acc * alpha[:, None] + pr @ v
                        m = mx
                    states.append((m, l, acc))
                ctas.append(_combine(states))
            m, l, acc = _combine(ctas)
            out[bi, kh * g:(kh + 1) * g] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


def _combine(states):
    """Merge (m, l, acc) states: weights exp(m_r - m*), m* the largest m."""
    mx = torch.stack([m for m, _, _ in states]).max(0).values
    l = sum(ll * torch.exp(m - mx) for m, ll, _ in states)
    acc = sum(a * torch.exp(m - mx)[:, None] for m, _, a in states)
    return mx, l, acc


def _case(seed, b, h, hkv, dh, bs, w, int8):
    rng = np.random.default_rng(seed)
    n_pages = b * w + 2
    if int8:
        kp = torch.from_numpy(rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8))
        vp = torch.from_numpy(rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8))
        sc = {k: torch.from_numpy((np.abs(rng.standard_normal((n_pages, bs, hkv))) + 0.1)
                                  .astype(np.float32)) for k in ("k_scale", "v_scale")}
    else:
        kp = torch.from_numpy(rng.standard_normal((n_pages, bs, hkv, dh)).astype(np.float32))
        vp = torch.from_numpy(rng.standard_normal((n_pages, bs, hkv, dh)).astype(np.float32))
        sc = {}
    q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32))
    table = rng.permutation(n_pages - 1)[: b * w].reshape(b, w).astype(np.int32) + 1
    table[-1, 1] = -1                                   # a live id < 0 reads page 0
    return q, kp, vp, torch.from_numpy(table), sc


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_split", [1, 2, 8])
@pytest.mark.parametrize("kind,local_window,softcap,visit_from_zero", [
    ("global", 0, 0.0, False),
    ("global", 0, 30.0, False),
    ("local", 5, 0.0, False),
    ("local", 1, 30.0, False),
    ("local", 5, 0.0, True),      # early shares see only masked keys
    ("local", 12, 30.0, True),
])
def test_split_softmax_combine_equals_plain_version(int8, n_split, kind, local_window,
                                                    softcap, visit_from_zero):
    """Per-share (m, l, acc) combined under NEG_INF equals the full
    softmax of the plain version, at W = 6 pages of 8 keys (not a multiple
    of the split; shares of odd page counts leave masked tail rows in
    their last chunk), with slots at pos = W*bs - 1, pos < bs (one live
    page: empty CTAs and warps), mid-table and at a page boundary, GQA
    G = 2."""
    q, kp, vp, table, sc = _case(n_split, 4, 4, 2, 16, 8, 6, int8)
    pos = torch.tensor([47, 3, 29, 16], dtype=torch.int32)
    kw = dict(kind=kind, local_window=local_window, softcap=softcap, **sc)
    got = _split_decode(q, kp, vp, table, pos, n_split=n_split,
                        visit_from_zero=visit_from_zero, **kw)
    want = TREF.paged_attention_ref(q, kp, vp, table, pos, **kw)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_split_softmax_combine_at_the_kernels_chunks():
    """bs = 64 gives two 32-key chunks per page, G = 1 (stablelm-3b's MHA),
    W = 3 across a cluster of 2 CTAs, one of whose warps gets no chunk."""
    q, kp, vp, table, _ = _case(5, 2, 4, 4, 80, 64, 3, False)
    pos = torch.tensor([191, 70], dtype=torch.int32)
    got = _split_decode(q, kp, vp, table, pos, n_split=2)
    torch.testing.assert_close(got, TREF.paged_attention_ref(q, kp, vp, table, pos),
                               atol=ATOL, rtol=RTOL)
