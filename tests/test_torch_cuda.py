"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither jax nor ``repro``, so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the attention kernels within 2e-5 absolute / 1e-5 relative
of their plain versions on f32 inputs (only summation order differs);
with bf16 queries (the decode kernel's split and warp paths, the prefill
kernel's tensor-core path) within 2e-4 absolute and relative, derived in
``test_cuda_bf16_attention_split_and_tensor_core_paths``;
``stoch_round`` and the int8 quantizer bit-identical to their plain
versions (integer hashing, exact f32 steps, no FMA contraction);
``wta_counts`` with equal row sums and at most 1% of its B·T decisions
flipped, because its Gaussians pass through log and cos, and exactly
equal where σ = 0 makes v = z (ties) or nothing can fire, and to the
votes of every column drawn in full with the card's own log and cos
(its pruning is exact); ``wta_sample`` (the threefry WTA sampler) with
its threefry bits, uniforms and normals bit-identical to
``repro_torch.random`` on the card and its counts and decisions exactly
equal to its plain version's (both draw with CUDA's ``log1pf`` and round
every other step once), no vote in rows that are all NaN or all below
the threshold, and no launch counted for an empty call; ``sigmoid_sample``
(the FCNN's stochastic Sigmoid neurons) with its bits and uniforms equal
to ``repro_torch.random``'s, its p to ``torch.sigmoid``'s on the card
(the kernel takes torch's CUDA form, ``1 / (1 + expf(-x))``) and its
decisions to its plain version's, exactly;
``crossbar_mac``
with at least 99.95% of its comparator decisions equal and its linear
readout within 2e-5 / 1e-5 (its quantized weights and noise are
bit-identical, its f32 sums run in another order), and, at stablelm-3b's
training shapes, within ``chip_smoke.py``'s gates (linear error at most
2·sqrt(K)·2**-24·Σ|x·Wq|, plus 1e-5 relative with the physical noise
model); its prepass bit-identical to its plain version (exact splits and
integer levels); the fused int8 KV write bit-identical to its plain
version outside the trash page 0; a smoke-size analog ``lm_loss`` on the
card within 1e-3 of the CPU's (a flipped comparator decision moves one
token's loss), its gradients finite.  The device backend seam: a
``fault_version`` bump replaces every captured decode graph, so replays
give an eager engine's streams under a degrade and a recover; the
crossbar read through the fault backend within the gates above of its
plain version on the same faulty weights, which lie within 4 ulps of a
conductance of the CPU's (PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal).  Self-speculation: a replayed round
equals the eager round on the same state bit for bit, rollbacks keep the
pool's and ``pos``'s addresses, and a ``fault_version`` bump recaptures
the round's graphs.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF

ATOL, RTOL = 2e-5, 1e-5
WTA_FLIP_FRACTION = 0.01


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _pool(rng, n_pages, bs, hkv, dh, int8):
    if int8:
        kp = rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8)
        vp = rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8)
        ks = (np.abs(rng.standard_normal((n_pages, bs, hkv))) + 0.1).astype(np.float32)
        vs = (np.abs(rng.standard_normal((n_pages, bs, hkv))) + 0.1).astype(np.float32)
        return kp, vp, ks, vs
    kp = rng.standard_normal((n_pages, bs, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, bs, hkv, dh)).astype(np.float32)
    return kp, vp, None, None


def _decode_case(seed, b, h, hkv, dh, bs, w, int8=False):
    rng = np.random.default_rng(seed)
    n_pages = b * w + 2
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp, vp, ks, vs = _pool(rng, n_pages, bs, hkv, dh, int8)
    table = (rng.permutation(n_pages - 1)[: b * w] + 1).reshape(b, w).astype(np.int32)
    return q, kp, vp, table, ks, vs


def _prefill_case(seed, s, h, hkv, dh, bs, w, int8=False):
    rng = np.random.default_rng(seed)
    n_pages = w + 4
    q = rng.standard_normal((s, h, dh)).astype(np.float32)
    kp, vp, ks, vs = _pool(rng, n_pages, bs, hkv, dh, int8)
    table = (rng.permutation(n_pages - 1)[:w] + 1).astype(np.int32)
    return q, kp, vp, table, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kind,local_window,softcap,hkv", [
    ("global", 0, 0.0, 4), ("local", 5, 30.0, 2),
])
def test_cuda_kernels_match_plain_versions(cuda_device, int8, kind, local_window, softcap, hkv):
    """Both attention kernels vs their plain versions on the card, f32
    inputs: only summation order differs, so the CPU bound holds."""
    kw = dict(kind=kind, local_window=local_window, softcap=softcap)
    q, kp, vp, table, ks, vs = _decode_case(7, 3, 4, hkv, 80, 16, 4, int8)
    table[2, 3] = -1
    pos = torch.tensor([63, 20, 40], dtype=torch.int32, device=cuda_device)
    dev = [torch.from_numpy(a).to(cuda_device) for a in (q, kp, vp, table)]
    sc = {} if not int8 else dict(
        k_scale=torch.from_numpy(ks).to(cuda_device),
        v_scale=torch.from_numpy(vs).to(cuda_device),
    )
    y_k = TOPS.paged_attention(*dev, pos, **kw, **sc)
    y_p = TREF.paged_attention_ref(*dev, pos, **kw, **sc)
    torch.testing.assert_close(y_k, y_p, atol=ATOL, rtol=RTOL)
    q, kp, vp, table, ks, vs = _prefill_case(8, 37, 4, hkv, 80, 16, 5, int8)
    dev = [torch.from_numpy(a).to(cuda_device) for a in (q, kp, vp, table)]
    sc = {} if not int8 else dict(
        k_scale=torch.from_numpy(ks).to(cuda_device),
        v_scale=torch.from_numpy(vs).to(cuda_device),
    )
    y_k = TOPS.paged_prefill_attention(*dev, 21, **kw, **sc)
    y_p = TREF.prefill_attention_ref(*dev, 21, **kw, **sc)
    torch.testing.assert_close(y_k, y_p, atol=ATOL, rtol=RTOL)


BF16_TOL = 2e-4


def _bf16_case(rng, n_pages, bs, hkv, dh, int8, dev):
    """A pool on the card: bf16 values, or int8 codes with scale planes."""
    kp, vp, ks, vs = _pool(rng, n_pages, bs, hkv, dh, int8)
    to = lambda a, t=None: torch.from_numpy(a).to(dev, t)  # noqa: E731
    if int8:
        return to(kp), to(vp), dict(k_scale=to(ks), v_scale=to(vs))
    return to(kp, torch.bfloat16), to(vp, torch.bfloat16), {}


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hkv", [32, 8, 4, 1])
@pytest.mark.parametrize("kind,local_window,softcap", [
    ("global", 0, 0.0), ("global", 0, 30.0), ("local", 20, 0.0), ("local", 1, 50.0),
    ("local", 37, 30.0),
])
def test_cuda_bf16_attention_split_and_tensor_core_paths(
    cuda_device, int8, hkv, kind, local_window, softcap
):
    """bf16 queries at stablelm-3b's head shape (H = 32, Dh = 80, bs = 16;
    MHA, and GQA with G = 4, 8 and 32) on bf16 and int8 pools, against the
    plain versions on the same card inputs.

    Decode: W = 25 pages.  B = 1, one slot at pos = W*bs - 1, splits over
    a cluster of 2 CTAs (25 is odd), and again at every cluster size;
    B = 5 adds slots at pos < bs (one live page, empty CTAs),
    mid-table with a live id < 0, and local windows that leave most CTAs
    of a cluster without pages.  Prefill: S = 37 and 50 (not multiples of
    the 16-row tile) at q0 = 0 and 45, with a live id < 0.

    Tolerance.  The decode kernel computes in f32 like the plain version;
    only summation order differs (~1e-6).  The prefill kernel's tensor
    cores multiply bf16 x bf16 exactly into f32 sums; its P.V splits each
    f32 weight into bf16 high and low parts, which keep ~16 bits, so each
    weight is off by at most 2**-16 of itself and the output by at most
    2**-16 * sum_t w_t |v_t| / l <= 1.5e-5 * max|v| (~4.5 for these bf16
    normals, ~1 after int8's v_scale/127): 2e-4 absolute and relative
    holds it with room for the f32 score and exp roundings."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import prefill_attention as PF

    rng = np.random.default_rng(hkv + 100 * int8)
    kw = dict(kind=kind, local_window=local_window, softcap=softcap)
    h, dh, bs, w = 32, 80, 16, 25
    for b, pos in ((1, [w * bs - 1]), (5, [w * bs - 1, 9, 100, 150, 0])):
        n_pages = b * w + 2
        kp, vp, sc = _bf16_case(rng, n_pages, bs, hkv, dh, int8, cuda_device)
        q = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32))
        q = q.to(cuda_device, torch.bfloat16)
        table = (rng.permutation(n_pages - 1)[: b * w] + 1).reshape(b, w).astype(np.int32)
        if b > 1:
            table[2, 3] = -1
        table = torch.from_numpy(table).to(cuda_device)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=cuda_device)
        geo = PA.decode_geometry(b, h, hkv, dh, bs, w, kp.dtype)
        if b == 1:
            assert geo["n_split"] > 1 and w % geo["n_split"]
        before = PA.launches
        got = TOPS.paged_attention(q, kp, vp, table, pos_t, **kw, **sc)
        assert PA.launches == before + 1
        want = TREF.paged_attention_ref(q, kp, vp, table, pos_t, **kw, **sc)
        torch.testing.assert_close(got, want, atol=BF16_TOL, rtol=BF16_TOL)
        for ns in (1, 2, 4, 8):   # every cluster size gives the same rows
            got = PA.paged_attention_cuda(q, kp, vp, table, pos_t, **kw, **sc, n_split=ns)
            torch.testing.assert_close(got, want, atol=BF16_TOL, rtol=BF16_TOL)
    for s_len, q0 in ((37, 0), (50, 0), (37, 45), (50, 45)):
        n_pages = 8
        kp, vp, sc = _bf16_case(rng, n_pages, bs, hkv, dh, int8, cuda_device)
        q = torch.from_numpy(rng.standard_normal((s_len, h, dh)).astype(np.float32))
        q = q.to(cuda_device, torch.bfloat16)
        table = (rng.permutation(n_pages - 1)[:7] + 1).astype(np.int32)
        table[1] = -1
        table = torch.from_numpy(table).to(cuda_device)
        assert PF.prefill_geometry(s_len, h, hkv, dh, bs, q.dtype, kp.dtype)["route"] == "tensor-core"
        before = PF.launches
        got = TOPS.paged_prefill_attention(q, kp, vp, table, q0, **kw, **sc)
        assert PF.launches == before + 1
        want = TREF.prefill_attention_ref(q, kp, vp, table, q0, **kw, **sc)
        torch.testing.assert_close(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def _sr_input(shape, lo, hi):
    x = (np.random.default_rng(6).standard_normal(shape) * 0.8 * hi).astype(np.float32)
    x.flat[:6] = [lo - 1.0, lo, hi, hi + 1.0, 0.0, lo + (hi - lo) / 2]
    return torch.from_numpy(x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,step,lo,hi", [
    ((33, 70), 2.0 / 31, -1.0, 1.0),
    ((16, 520), 2.0 / 31, -1.0, 1.0),
    ((256, 80), 1.0, -127.0, 127.0),
    ((5, 1030), 0.1, -1.0, 1.0),
])
def test_cuda_stoch_round_bit_equal_to_plain(cuda_device, shape, step, lo, hi):
    from repro_torch.kernels import stoch_round as SR

    x = _sr_input(shape, lo, hi).to(cuda_device)
    kw = dict(step=step, lo=lo, hi=hi)
    seeds = torch.tensor([2**32 - 1], device=cuda_device)
    assert torch.equal(SR.stoch_round_cuda(x, seeds, **kw), TREF.stoch_round_ref(x, seeds, **kw))
    groups = torch.tensor([3, 2**31, 9], device=cuda_device)
    x3 = torch.cat([x, x, x])
    got = SR.stoch_round_cuda(x3, groups, **kw)
    assert torch.equal(got, TREF.stoch_round_ref(x3, groups, **kw))
    # the card's answer is the CPU's answer
    assert torch.equal(got.cpu(), TREF.stoch_round_ref(x3.cpu(), groups.cpu(), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,step,lo,hi", [
    ((33, 70), 2.0 / 31, -1.0, 1.0),
    ((256, 80), 1.0, -127.0, 127.0),
    ((5, 1030), 0.1, -1.0, 1.0),
    ((64, 512), 2.0 / 31, -1.0, 1.0),
    ((2048, 2048), 2.0 / 31, -1.0, 1.0),
])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_stoch_round_views_and_sizes(cuda_device, shape, step, lo, hi, offset):
    """A contiguous (m, n) view ``offset`` elements into its storage (1: a
    data pointer off the 16-byte grid, so rows take scalar heads and the
    output, aligned, takes scalar stores), at the quantizer's 2048² too."""
    from repro_torch.kernels import stoch_round as SR

    m, n = shape
    flat = torch.empty(m * n + offset, device=cuda_device)
    x = flat[offset:].view(m, n)
    x.copy_(_sr_input(shape, lo, hi).to(cuda_device))
    assert x.is_contiguous() and x.storage_offset() == offset
    kw = dict(step=step, lo=lo, hi=hi)
    seeds = torch.tensor([7, 2**32 - 1], device=cuda_device) if m % 2 == 0 else \
        torch.tensor([7], device=cuda_device)
    assert torch.equal(SR.stoch_round_cuda(x, seeds, **kw), TREF.stoch_round_ref(x, seeds, **kw))


@pytest.mark.cuda
def test_cuda_quantize_kv_pair_equals_cpu(cuda_device):
    """The int8 write path on the card (kernel) equals the CPU plain path on
    the same input, codes and scales, for the decode and prefill forms."""
    from repro_torch.kernels import stoch_round as SR

    rng = np.random.default_rng(7)
    for shape, seeds in (((8, 1, 32, 80), [2**32 - 1]), ((8, 16, 32, 80), list(range(8)))):
        k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3)
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        sd = torch.tensor(seeds)
        before = SR.launches
        got = TOPS.quantize_kv_pair_int8(k.to(cuda_device), v.to(cuda_device), sd.to(cuda_device))
        assert SR.launches == before + 2
        for g, w in zip(got, TOPS.quantize_kv_pair_int8(k, v, sd)):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n_trials", [(5, 300, 16), (3, 8200, 3), (8, 50304, 4)])
def test_cuda_wta_counts_agree_with_plain(cuda_device, b, c, n_trials):
    from repro_torch.kernels import wta_counts as WTA

    z = torch.from_numpy(
        np.random.default_rng(c).standard_normal((b, c)).astype(np.float32) * 2
    ).to(cuda_device)
    seed = torch.tensor([2**32 - 1], device=cuda_device)
    kw = dict(n_trials=n_trials, vth0=2.897, sigma_z=1.702)
    got = WTA.wta_counts_cuda(z, seed, **kw).cpu()
    want = TREF.wta_counts_ref(z.cpu(), seed.cpu(), **kw)
    assert torch.equal(got.sum(-1), want.sum(-1))
    assert float((got - want).abs().sum()) <= 2 * WTA_FLIP_FRACTION * b * n_trials
    assert torch.equal(TOPS.wta_counts(z, seed, **kw).cpu(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n_trials,case", [
    (64, 10, 100, "noisy"),        # the paper's 10-class head: one warp per (row, trial)
    (64, 10, 100, "ties"),
    (6, 300, 8, "ties"),
    (4, 8200, 5, "ties"),          # clusters of 2 CTAs
    (2, 50304, 3, "ties"),         # the serving head: clusters of 8
    (3, 300, 16, "below"),
    (2, 50304, 4, "below"),
])
def test_cuda_wta_counts_ties_and_silence(cuda_device, b, c, n_trials, case):
    """σ = 0 makes v = z: every column at a row's maximum (three of them,
    or the whole row) gets all T votes, exactly as the plain version; rows
    where nothing can pass vth0 get no vote."""
    from repro_torch.kernels import wta_counts as WTA

    z = torch.from_numpy(
        np.random.default_rng(c + b).standard_normal((b, c)).astype(np.float32) * 1.702)
    kw = dict(n_trials=n_trials, vth0=1.702**2, sigma_z=1.702)
    if case == "ties":
        z[0, [1, c // 2, c - 1]] = float(z.max()) + 1.0
        z[1] = 3.0
        kw["sigma_z"] = 0.0
    elif case == "below":
        z -= 100.0
    seed = torch.tensor([12345], device=cuda_device)
    got = WTA.wta_counts_cuda(z.to(cuda_device), seed, **kw).cpu()
    want = TREF.wta_counts_ref(z, seed.cpu(), **kw)
    if case == "noisy":
        assert torch.equal(got.sum(-1), want.sum(-1))
        assert float((got - want).abs().sum()) <= 2 * WTA_FLIP_FRACTION * b * n_trials
    else:
        assert torch.equal(got, want)
    if case == "ties":
        assert got[0, [1, c // 2, c - 1]].tolist() == [n_trials] * 3
        assert bool((got[1] == n_trials).all())
    if case == "below":
        assert got.sum() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,n_trials", [
    (64, 10, 100),      # one warp per (row, trial), every column drawn
    (256, 128, 64),
    (5, 700, 16),       # a cluster of 1 CTA of 1 warp, pruned
    (4, 8201, 9),       # clusters of 2 CTAs, C not a multiple of 4
    (8, 50304, 32),     # the serving head: clusters of 2 CTAs of 8 warps
    (2, 50304, 3),      # clusters of 8 CTAs
])
def test_cuda_wta_counts_equal_full_draw(cuda_device, b, c, n_trials):
    """Noisy inputs at the serving head's operating point: the pruned
    kernel's counts equal, exactly, the votes of every column drawn in full
    by the probe kernel with the same logf, sqrtf and cosf."""
    from repro_torch.kernels import wta_counts as WTA

    z = torch.from_numpy(
        np.random.default_rng(c * b).standard_normal((b, c)).astype(np.float32) * 1.702
    ).to(cuda_device)
    seed = torch.tensor([2**31 + c], device=cuda_device)
    kw = dict(n_trials=n_trials, vth0=1.702**2, sigma_z=1.702)
    got = WTA.wta_counts_cuda(z, seed, **kw)
    full = WTA.full_draw_counts(z, seed, **kw)
    assert torch.equal(got, full)
    assert int(full.sum()) >= b * n_trials // 2   # most trials have a winner


@pytest.mark.cuda
def test_cuda_wta_draw_bounds(cuda_device):
    """The WTA kernel prunes on v <= z + r·|σ| <= z + R[bucket]·|σ|: over
    every value its uniforms can take, this card's cosf keeps |cos| <= 1,
    and its radius table equals the CPU's within an ulp or two (logf)."""
    from repro_torch.kernels import wta_counts as WTA

    r_max, cos_max = WTA.draw_bounds(cuda_device)
    assert 5.88 < r_max < 5.89 and 0.999 < cos_max <= 1.0
    from repro_torch.kernels import prng

    k = torch.arange(0, 1 << 24, 1 << 13, dtype=torch.int64)   # each bucket's first u1
    cpu = torch.sqrt(-2.0 * torch.log(prng.uniform01(k << 8)))
    table = WTA.radius_table(cuda_device)[: WTA.RADIUS_BUCKETS].cpu()
    torch.testing.assert_close(table, cpu, rtol=5e-7, atol=0)


def _wta_sample_case(dev, n, c, reads, layout, dtype=torch.float32, seed=0):
    """z (n, c) at the serving head's spread, per-row keys, and fold words:
    none (one whole-batch key), the step, or a read index then the step."""
    from repro_torch import random as R

    rng = np.random.default_rng(seed + c)
    z = torch.from_numpy((rng.standard_normal((n, c)) * 2.5).astype(np.float32)).to(dtype)
    if layout == "one key":
        keys = torch.tensor([R.fold_in(R.PRNGKey(seed), 3)] * n, dtype=torch.int64)
        folds = None
    else:
        keys = torch.tensor([R.fold_in(R.PRNGKey(seed), i) for i in range(n)], dtype=torch.int64)
        steps = torch.from_numpy(rng.integers(0, 2**31, n)).to(torch.int64)
        folds = steps[:, None] if reads == 0 else torch.stack(
            [torch.full((n,), reads, dtype=torch.int64), steps], dim=1)
    return z.to(dev), keys.to(dev), None if folds is None else folds.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,t,read,layout,dtype", [
    (8, 50304, 32, 0, "per slot", torch.bfloat16),   # the serving head, read 0
    (8, 50304, 32, 2, "per slot", torch.bfloat16),   # a redundant read
    (1, 50304, 32, 0, "per slot", torch.float32),    # the first token
    (64, 10, 100, 0, "one key", torch.float32),      # wta_trials on the 10-class head
    (5, 777, 20, 1, "per slot", torch.float32),      # an odd width
    (3, 4097, 7, 0, "one key", torch.bfloat16),
])
def test_cuda_wta_sample_matches_plain(cuda_device, n, c, t, read, layout, dtype):
    from repro_torch.kernels import wta_sample as WS

    z, keys, folds = _wta_sample_case(cuda_device, n, c, read, layout, dtype)
    lay = (c, 0) if layout == "per slot" else (n * c, c)
    kw = dict(n_trials=t, vth0=2.897, sigma_z=1.702, layout=lay)
    before = WS.launches
    counts, n_dec = WS.wta_sample_cuda(z, keys, folds, **kw)
    assert WS.launches == before + 1
    want, want_dec = TREF.wta_trial_counts_ref(z, keys, folds, **kw)
    print(f"wta_sample ({n}, {c}) T={t}: sum|Δcounts| {float((counts - want).abs().sum())}, "
          f"rows with other decisions {(n_dec != want_dec).nonzero().flatten().tolist()}")
    assert torch.equal(counts, want) and torch.equal(n_dec, want_dec)
    assert torch.equal(counts.sum(-1), n_dec) and bool((n_dec <= t).all())
    got, _ = TOPS.wta_trial_counts(z, keys, folds, t, 2.897, 1.702, lay)
    assert torch.equal(got, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [10, 50304])
def test_cuda_wta_sample_nan_and_silent_rows(cuda_device, c):
    """Rows that are all NaN or all far below the threshold get no vote."""
    from repro_torch.kernels import wta_sample as WS

    z, keys, folds = _wta_sample_case(cuda_device, 4, c, 0, "per slot")
    z[1] = float("nan")
    z[2] = -100.0
    z[3, ::2] = float("nan")
    kw = dict(n_trials=16, vth0=2.897, sigma_z=1.702, layout=(c, 0))
    counts, n_dec = WS.wta_sample_cuda(z, keys, folds, **kw)
    want, want_dec = TREF.wta_trial_counts_ref(z, keys, folds, **kw)
    assert counts[1:3].sum() == 0 and n_dec[1:3].sum() == 0
    assert counts[3, ::2].sum() == 0
    assert torch.equal(want, counts) and torch.equal(want_dec, n_dec)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,t", [(0, 50304, 32), (8, 0, 32), (8, 50304, 0)])
def test_cuda_wta_sample_empty_call_counts_no_launch(cuda_device, n, c, t):
    """An empty call returns zeros without a launch, so ``launches`` counts
    only kernels that ran."""
    from repro_torch.kernels import wta_sample as WS

    z = torch.zeros((n, c), device=cuda_device)
    keys = torch.zeros((n, 2), dtype=torch.int64, device=cuda_device)
    before = WS.launches
    counts, n_dec = WS.wta_sample_cuda(z, keys, None, n_trials=t, vth0=2.897, sigma_z=1.702,
                                       layout=(c, 0))
    assert WS.launches == before
    assert counts.shape == (n, c) and n_dec.shape == (n,)
    assert not counts.any() and not n_dec.any()


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 2**32 - 4096])
def test_cuda_wta_sample_draw_bit_equal(cuda_device, start):
    """The kernel's threefry bits, uniforms and normals are the port's on
    the card, bit for bit, across the counter's high word."""
    from repro_torch import random as R
    from repro_torch.kernels import wta_sample as WS

    key, k = R.fold_in(R.PRNGKey(7), 11), 1 << 16
    z = torch.zeros(k, device=cuda_device)
    bits, u, v = WS.draw_probe(z, key, start, vth0=-float("inf"), sigma_z=1.0)
    want_bits = R.random_bits(key, (2**33,), cuda_device, start=start, count=k)
    assert torch.equal(bits, want_bits)
    assert torch.equal(u, R.uniform_from_bits(want_bits, R.NORMAL_LO, 1.0))
    assert torch.equal(v, R.erf_inv(u) * R.SQRT2_F32)


@pytest.mark.cuda
@pytest.mark.parametrize("binarize", [True, False])
@pytest.mark.parametrize("physical", [False, True])
def test_cuda_crossbar_mac_matches_plain(cuda_device, binarize, physical):
    """The crossbar kernel at an odd shape (ragged K, N past the 128 pad)."""
    from repro_torch.kernels import crossbar_mac as CB

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((37, 203)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.uniform(-1.1, 1.1, (203, 131)).astype(np.float32)).to(cuda_device)
    sigma = torch.full((), 1.7 if binarize else 0.01, device=cuda_device)
    kw = dict(binarize=binarize, physical_noise=physical,
              noise_params=(1.6568e-11, 4.95e-05, 5.05e-05, 0.0109, 203.0))
    before = CB.launches
    got = CB.crossbar_mac_cuda(x, w, 2**32 - 7, sigma, **kw)
    assert CB.launches == before + 1
    want = TREF.crossbar_mac_ref(x, w, 2**32 - 7, sigma, **kw)
    if binarize:
        assert float((got == want).float().mean()) >= 0.9995
    else:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


CB_AGREEMENT = 0.9995


def _crossbar_training_case(dev, m, k, n, binarize, *, binary_x=False, physical=False,
                            quantize=True, seed=0):
    """Inputs as the analog training path hands them to the kernel (the
    same construction as ``chip_smoke.py``'s)."""
    from repro_torch.core.physics import DeviceParams, calibrate_v_read

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev)
    if binary_x:
        x = (x > 0.5).float()
    w = (torch.randn((k, n), generator=gen, device=dev) * k**-0.5).to(torch.bfloat16).float()
    s = TOPS.range_scale(w)
    w = (w / s * (1.2 if physical else 1.0)).contiguous()
    sigma = (torch.tensor(1.702, device=dev) / s) if binarize else torch.full((), 0.01, device=dev)
    dp = calibrate_v_read(DeviceParams(), k)
    kw = dict(binarize=binarize, physical_noise=physical,
              noise_params=TOPS._noise_params(dp, k), quantize=quantize,
              qstep=TOPS._qstep(dp), w_min=dp.w_min, w_max=dp.w_max)
    return x, w, 0xC0FFEE + seed, sigma.reshape(()).float(), kw


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,binarize,binary_x,physical,quantize", [
    (1024, 2560, 2560, False, False, False, True),   # wq wk wv wo
    (1024, 2560, 6912, True, False, False, True),    # w_up, w_gate
    (1024, 6912, 2560, False, True, False, True),    # w_down on the binary hidden layer
    (257, 513, 129, False, False, False, True),
    (257, 513, 129, True, False, False, True),
    (192, 640, 200, False, False, True, True),
    (192, 640, 200, True, False, True, True),
    (1, 128, 8, False, False, False, False),         # the serving canary, unquantized
])
def test_cuda_crossbar_tensor_core_read_gates(cuda_device, m, k, n, binarize, binary_x,
                                              physical, quantize):
    """The tensor-core read (prepass + wgmma GEMM) at the training shapes
    and the odd, physical and canary cases, under chip_smoke.py's gates;
    one read launch each, and one prepass launch per quantized read."""
    from repro_torch.kernels import crossbar_mac as CB

    x, w, seed, sigma, kw = _crossbar_training_case(
        cuda_device, m, k, n, binarize, binary_x=binary_x, physical=physical, quantize=quantize)
    reads, preps = CB.launches, CB.prepass_launches
    got = CB.crossbar_mac_cuda(x, w, seed, sigma, **kw)
    assert (CB.launches - reads, CB.prepass_launches - preps) == (1, int(quantize))
    _assert_crossbar_gates(x, w, kw, got, TREF.crossbar_mac_ref(x, w, seed, sigma, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [64, 96, 128])
@pytest.mark.parametrize("m,k,n,binarize", [
    (1024, 2560, 2560, False), (257, 513, 129, False), (257, 513, 129, True),
])
def test_cuda_crossbar_gemm_every_tile_width(cuda_device, m, k, n, binarize, tile_n):
    """Every compiled tile width of the GEMM (the tile sweep times them
    all) passes the read's gates, on its own register tiles and epilogue
    indexing."""
    from repro_torch.kernels import crossbar_mac as CB

    x, w, seed, sigma, kw = _crossbar_training_case(cuda_device, m, k, n, binarize)
    q = dict(qstep=kw["qstep"], w_min=kw["w_min"], w_max=kw["w_max"])
    parts = CB.crossbar_prepass_cuda(x, w, *q.values())
    got = CB.crossbar_gemm_cuda(*parts, k, seed, sigma, binarize=binarize,
                                noise_params=kw["noise_params"], **q, tile_n=tile_n)
    _assert_crossbar_gates(x, w, kw, got, TREF.crossbar_mac_ref(x, w, seed, sigma, **kw))


def _assert_crossbar_gates(x, w, kw, got, want):
    """chip_smoke.py's gates: comparator decisions >= 0.9995 equal; linear
    error <= 2·sqrt(K)·2**-24·Σ|x·Wq| (+ 1e-5 relative, physical noise)."""
    assert bool(torch.isfinite(got).all())
    if kw["binarize"]:
        assert float((got == want).float().mean()) >= CB_AGREEMENT
        return
    wq = TREF.crossbar_quantize(w, kw["qstep"], kw["w_min"], kw["w_max"]) if kw["quantize"] else w
    tol = 2 * x.shape[1]**0.5 * 2.0**-24 * (x.abs() @ wq.abs())
    if kw["physical_noise"]:
        tol = tol + 1e-5 * want.abs()
    assert float(((got - want).abs() / tol.clamp_min(1e-30)).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,physical", [(257, 513, 129, True), (1024, 2560, 2560, False)])
def test_cuda_crossbar_prepass_bit_equal_to_plain(cuda_device, m, k, n, physical):
    """The prepass writes x's three bf16 pieces and the centered levels
    exactly (zero past K), and the integer column sums exactly; the row
    sums differ from the plain version's only in f32 summation order."""
    from repro_torch.kernels import crossbar_mac as CB

    x, w, _, _, kw = _crossbar_training_case(cuda_device, m, k, n, False, physical=physical)
    q = (kw["qstep"], kw["w_min"], kw["w_max"])
    xs, rowsum, ct, colsum = CB.crossbar_prepass_cuda(x, w, *q, physical_noise=physical)
    xs_p, rowsum_p, ct_p, colsum_p = TREF.crossbar_prepass_ref(x, w, *q)
    assert torch.equal(xs.float(), xs_p) and torch.equal(ct.float(), ct_p)
    assert torch.equal(xs.float().sum(0)[:, :k], x)      # the pieces sum to x exactly
    if physical:
        assert torch.equal(colsum, colsum_p)
    tol = 2 * k**0.5 * 2.0**-24 * x.abs().sum(1)
    assert bool(((rowsum - rowsum_p).abs() <= tol).all())


def _int8_pools(rng, n_pages, bs, hkv, dh, dev):
    return [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8),
        rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8),
        (rng.random((n_pages, bs, hkv)) + 0.5).astype(np.float32),
        (rng.random((n_pages, bs, hkv)) + 0.5).astype(np.float32),
    )]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_write_kv_int8_bit_equal_to_plain(cuda_device, dtype):
    """The fused int8 write on the card against its plain version on the
    card, both modes, at stablelm-3b's kv heads (Hkv 32, Dh 80, bs 16):
    codes and scales bit for bit, page 0 (the trash page several evicted
    slots may write at once) left out.  Decode: a slot on the trash page,
    a slot past its table, seeds near 2**32.  Chunk: c = 37 (not a
    multiple of bs) from block 2, one seed per block."""
    from repro_torch.kernels import stoch_round as SR

    rng = np.random.default_rng(21)
    bs, hkv, dh, n_pages = 16, 32, 80, 40
    table = torch.from_numpy(
        (rng.permutation(n_pages - 1)[:24] + 1).reshape(6, 4).astype(np.int32)).to(cuda_device)
    table[1, 2] = -1                                   # slot 1 writes the trash page
    pos = torch.tensor([5, 40, 63, 64 + 7, 1000, 0], dtype=torch.int32, device=cuda_device)
    row = torch.from_numpy((rng.permutation(n_pages - 1)[:6] + 1).astype(np.int32)).to(cuda_device)
    for kind, shape, seeds, where in (
        ("decode", (6, 1, hkv, dh), [2**32 - 1], dict(table=table, pos=pos)),
        ("chunk", (1, 37, hkv, dh), [2**32 - 2, 7, 2**31], dict(table_row=row, b0=2)),
    ):
        k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3).to(cuda_device, dtype)
        v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device, dtype)
        sd = torch.tensor(seeds, dtype=torch.int64, device=cuda_device)
        got = _int8_pools(np.random.default_rng(5), n_pages, bs, hkv, dh, cuda_device)
        want = [t.clone() for t in got]
        before = SR.write_launches
        TOPS.write_kv_int8(k, v, *got, sd, **where)
        assert SR.write_launches == before + 1, kind
        TREF.write_kv_int8_ref(k, v, *want, sd, **where)
        for g, w in zip(got, want):
            assert torch.equal(g[1:], w[1:]), kind
        # and the card's plain version is the CPU's
        cpu = [t.cpu() for t in _int8_pools(np.random.default_rng(5), n_pages, bs, hkv, dh, "cpu")]
        TREF.write_kv_int8_ref(k.cpu(), v.cpu(), *cpu, sd.cpu(),
                               **{a: (b.cpu() if torch.is_tensor(b) else b) for a, b in where.items()})
        for g, w in zip(got, cpu):
            assert torch.equal(g[1:].cpu(), w[1:]), kind


@pytest.mark.cuda
def test_cuda_analog_lm_loss_with_backward(cuda_device):
    """Smoke stablelm-3b in analog-stochastic mode: loss and gradients on
    the card through the crossbar kernel, against the CPU's plain path."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.physics import DeviceParams, calibrate_v_read
    from repro_torch.data import lm_batch
    from repro_torch.kernels import crossbar_mac as CB
    from repro_torch.models import transformer as TF
    from repro_torch.optim import tree_leaves

    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32", analog=AnalogConfig(
        mode="analog_stochastic", device=calibrate_v_read(DeviceParams(), 64)))
    batch = lm_batch(cfg, batch=4, seq=32, step=0, device="cpu")
    out = {}
    for d in ("cpu", cuda_device):
        params = _tree_to(TF.init_lm(cfg, seed=2, device="cpu"), d)
        leaves = tree_leaves(params)
        before = CB.launches
        loss, _ = TF.lm_loss(params, {k: v.to(d) for k, v in batch.items()}, cfg, (0, 5))
        grads = torch.autograd.grad(loss, leaves)
        out[str(d)] = (float(loss.detach()), CB.launches - before)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert out["cpu"][1] == 0 and out[str(cuda_device)][1] == 7 * cfg.n_layers
    assert abs(out["cpu"][0] - out[str(cuda_device)][0]) <= 1e-3


def _tree_to(tree, d):
    return {k: _tree_to(v, d) if isinstance(v, dict) else v.to(d).requires_grad_(True)
            for k, v in tree.items()}


# the FCNN's hidden layers at Fig. 6's batch and at the training batch, an
# odd shape, and draws from a counter offset across the high word
SIGMOID_SHAPES = [(1024, 500, 0), (1024, 300, 0), (128, 500, 0), (128, 300, 0), (7, 33, 0),
                  (7, 33, 2**32 - 100), (300, 17, 12345)]


def _sigmoid_case(dev, m, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.randn((m, n), generator=g, device=dev) * 4
    bias = torch.randn((n,), generator=g, device=dev)
    return acc, bias


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,offset", SIGMOID_SHAPES)
@pytest.mark.parametrize("beta", [1.0, 0.7])
def test_cuda_sigmoid_sample_matches_plain(cuda_device, m, n, offset, beta):
    """Decisions equal to the plain version's, with and without a bias;
    the draw's bits, uniforms and p equal to repro_torch.random's and
    torch.sigmoid's; one launch counted a call."""
    from repro_torch import random as R
    from repro_torch.kernels import sigmoid_sample as SS

    acc, bias = _sigmoid_case(cuda_device, m, n, m * n + offset)
    key = R.fold_in(R.PRNGKey(m), n)
    for b in (bias, None):
        before = SS.launches
        y = SS.sigmoid_sample_cuda(acc, b, beta=beta, key=key, offset=offset)
        assert SS.launches == before + 1
        want = TREF.sigmoid_sample_ref(acc, b, beta=beta, key=key, offset=offset)
        print(f"sigmoid_sample ({m}, {n}) offset {offset}: {int((y != want).sum())} decisions "
              f"differ, {float(y.mean()):.4f} fire")
        assert torch.equal(y, want)
        assert torch.equal(TOPS.sigmoid_sample(acc, b, beta, key, offset), y)
    bits, u, p, y2 = SS.draw_probe(acc, bias, beta=beta, key=key, offset=offset)
    want_bits = R.random_bits(key, (m, n), cuda_device, start=offset, count=m * n).reshape(m, n)
    assert torch.equal(bits, want_bits)
    assert torch.equal(u, R.uniform_from_bits(want_bits, 0.0, 1.0))
    assert torch.equal(p, torch.sigmoid(beta * (acc + bias)))
    assert torch.equal(y2, (u < p).float())


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(0, 500), (128, 0)])
def test_cuda_sigmoid_sample_empty_counts_no_launch(cuda_device, m, n):
    from repro_torch.kernels import sigmoid_sample as SS

    acc = torch.zeros((m, n), device=cuda_device)
    before = SS.launches
    y = SS.sigmoid_sample_cuda(acc, torch.zeros((n,), device=cuda_device), beta=1.0, key=(0, 1))
    assert SS.launches == before and y.shape == (m, n)


@pytest.mark.cuda
def test_cuda_sigmoid_sample_refuses(cuda_device):
    """Wrong dtype, layout or bias shape raise, and count no launch."""
    from repro_torch.kernels import sigmoid_sample as SS

    acc = torch.zeros((8, 16), device=cuda_device)
    before = SS.launches
    for bad, b in ((acc.double(), None), (acc.t(), None), (acc.cpu(), None),
                   (acc, torch.zeros((15,), device=cuda_device))):
        with pytest.raises(ValueError):
            SS.sigmoid_sample_cuda(bad, b, beta=1.0, key=(0, 1))
    assert SS.launches == before


@pytest.mark.cuda
def test_cuda_fcnn_predict_raca_matches_cpu(cuda_device):
    """A small FCNN's RACA prediction on the card (both kernels) equals the
    CPU's (plain versions) on the same weights and images, and launches
    two sigmoid_sample and one wta_sample a vote."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.configs.fcnn_mnist import CONFIG
    from repro_torch.data import mnist_batch
    from repro_torch.kernels import sigmoid_sample as SS
    from repro_torch.kernels import wta_sample as WS
    from repro_torch.models import fcnn as FC

    cfg = dataclasses.replace(CONFIG, fcnn_layers=(784, 64, 32, 10))
    params = FC.init_fcnn(R.PRNGKey(2), cfg, "cpu")
    x = mnist_batch(batch=64, step=0, device="cpu")["image"]
    want = FC.fcnn_predict_raca(params, x, cfg, R.PRNGKey(7), 6)
    SS.launches = WS.launches = 0
    got = FC.fcnn_predict_raca({k: v.to(cuda_device) for k, v in params.items()},
                               x.to(cuda_device), cfg, R.PRNGKey(7), 6)
    torch.cuda.synchronize()
    assert (SS.launches, WS.launches) == (12, 6)
    assert float((got.cpu() == want).float().mean()) >= 0.98


# ---------------------------------------------------------------------------
# The compiled decode step: CUDA graphs per (window width, reads), replayed.
# ---------------------------------------------------------------------------


def _graph_trace():
    """Shared prefixes, a same-tick full hit, prompts of several buckets:
    decode windows of 2, 4 and 8 blocks."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, 256, 24).tolist()
    y = rng.integers(0, 256, 12).tolist()
    return [y, y, prefix + rng.integers(0, 256, 12).tolist(), rng.integers(0, 256, 40).tolist(),
            prefix + rng.integers(0, 256, 12).tolist(), rng.integers(0, 256, 5).tolist(),
            rng.integers(0, 256, 60).tolist()]


def _graph_serve(device, kv, wta, reads, graphs, engine=None):
    """Serve ``_graph_trace`` at smoke size (bf16); returns (engine,
    streams, the launch counts it added)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving import ServeConfig, ServingEngine

    if engine is None:
        cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), kv_cache_dtype=kv,
                                  wta_head=wta)
        engine = ServingEngine(
            init_lm(cfg, seed=4, device=device), cfg,
            ServeConfig(max_batch=4, max_new_tokens=12, max_len=128, kv_block_size=8,
                        prefill_chunk=16, seed=3, n_redundant_reads=reads),
            device=device, graphs=graphs)
    before = TOPS.launch_counts()
    for p in _graph_trace():
        engine.submit(p)
    outs = engine.run()
    torch.cuda.synchronize()
    after = TOPS.launch_counts()
    return engine, outs, {k: after[k] - before[k] for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("kv,wta,reads", [("same", False, 1), ("int8", False, 1),
                                          ("same", True, 1), ("same", True, 3)],
                         ids=["greedy", "int8", "wta", "wta_r3"])
def test_cuda_graph_replays_equal_eager(cuda_device, kv, wta, reads):
    """The engine's replayed decode steps give the eager engine's streams,
    pool (outside the trash page 0), positions and int8 step counter, bit
    for bit, and the launch counters count the replays: the same counts
    as eager mode.  One graph per window width, each replayed."""
    g_eng, g_out, g_launch = _graph_serve(cuda_device, kv, wta, reads, None)
    e_eng, e_out, e_launch = _graph_serve(cuda_device, kv, wta, reads, False)
    assert g_eng._decode.capture and not e_eng._decode.capture
    assert g_out == e_out
    assert g_launch == e_launch
    assert g_launch["paged_attention"] == 2 * g_eng.metrics().decode_steps
    if kv == "int8":
        assert g_launch["write_kv_int8"] == (g_launch["paged_attention"]
                                             + g_launch["paged_prefill_attention"])
    want_wta = reads * g_eng.metrics().decode_steps + len(_graph_trace()) if wta else 0
    assert g_launch["wta_sample"] == want_wta
    for name, leaf in g_eng._cache.items():
        other = e_eng._cache[name]
        if name.endswith("pages"):
            leaf, other = leaf[:, :, 1:], other[:, :, 1:]
        assert torch.equal(leaf, other), name
    counts = g_eng.compile_counts()
    widths = {w for w, _ in g_eng._decode.entries}
    assert counts["serve_step"] == len(widths) == len(g_eng._decode.captures()) >= 2
    assert g_eng.metrics().decode_steps > counts["serve_step"]
    assert counts == e_eng.compile_counts()


@pytest.mark.cuda
def test_cuda_graph_repeat_trace_captures_nothing_new(cuda_device):
    """A second identical trace through the same engine replays the
    graphs it has: no new capture, no new signature."""
    eng, _, _ = _graph_serve(cuda_device, "same", True, 1, None)
    counts, graphs = eng.compile_counts(), {k: e.graph for k, e in eng._decode.entries.items()}
    eng, _, launch = _graph_serve(cuda_device, "same", True, 1, None, engine=eng)
    assert eng.compile_counts() == counts
    assert {k: e.graph for k, e in eng._decode.entries.items()} == graphs
    assert launch["paged_attention"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,theta", [(80, 10000.0), (16, 10000.0), (64, 1e6)])
def test_cuda_rope_freqs_bit_identical_to_the_host_tensor_form(cuda_device, head_dim, theta):
    from repro_torch.models.layers import rope_freqs

    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=cuda_device) / half
    old = torch.pow(torch.tensor(theta, dtype=torch.float32, device=cuda_device), exps)
    assert torch.equal(rope_freqs(head_dim, theta, cuda_device).view(torch.int32),
                       old.view(torch.int32))


@pytest.mark.cuda
def test_cuda_graph_failed_capture_raises(cuda_device, monkeypatch):
    """A step that cannot be captured (here a pageable host-to-device copy
    inside it) makes the tick raise: the engine does not go on eagerly."""
    from repro_torch.launch import specs as SP

    real = SP.sample_tokens

    def with_a_host_copy(cfg, logits, *args, **kw):
        torch.tensor(1.0, device=logits.device)
        return real(cfg, logits, *args, **kw)

    monkeypatch.setattr(SP, "sample_tokens", with_a_host_copy)
    with pytest.raises(RuntimeError):
        _graph_serve(cuda_device, "same", False, 1, None)


# ---------------------------------------------------------------------------
# Self-speculation: the fused round captured per (W, k), its rollback.
# ---------------------------------------------------------------------------


def _spec_engine(device, kv, wta, graphs, k=3, params=None, **kw):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), kv_cache_dtype=kv, wta_head=wta)
    params = init_lm(cfg, seed=4, device=device) if params is None else params
    eng = ServingEngine(
        params, cfg,
        ServeConfig(max_batch=4, max_new_tokens=12, max_len=128, kv_block_size=8,
                    prefill_chunk=16, seed=3, speculate_k=k, **kw),
        device=device, graphs=graphs)
    return eng, params


def _tamper_every_other_round(eng) -> dict:
    """Report every other round's drafts at step 1 wrong, after the round:
    the engine takes the rollback path, the verify's tokens stay true."""
    orig, calls = eng._spec_round, {"n": 0}

    def tampered(*a):
        d, dok, v, vok, vs = orig(*a)
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            d = d.clone()
            d[:, 1] ^= 1
        return d, dok, v, vok, vs

    eng._spec_round = tampered
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("kv,wta", [("same", False), ("int8", False), ("same", True)],
                         ids=["greedy", "int8", "wta"])
def test_cuda_spec_round_captured_equals_eager(cuda_device, kv, wta):
    """A replayed round equals the eager round on the same state, bit for
    bit: drafts, flags, verify tokens, ``vstates``, the pool and ``pos``
    (and ``quant_step``) after it; one capture per (W, k), the launch
    counters adding each replay's launches."""
    from repro_torch.launch import specs as SP

    eng, _ = _spec_engine(cuda_device, kv, wta, None)
    eng.submit(list(range(1, 20)), 11)
    eng.submit(list(range(3, 9)), 11)
    while eng._job_fifo or eng.sched.queued():
        eng.tick()
    cache = {k: v.clone() for k, v in eng._cache.items()}
    graphs = SP.SpecGraphs(eng.mcfg, eng.params, eng._cache, k=3, capture=True)
    eager = SP.SpecGraphs(eng.mcfg, eng.params, cache, k=3, capture=False)
    table = eng._table[:, :4].copy()
    tokens = eng._tokens.copy()
    wta_in = (eng._req_keys.copy(), eng._steps.copy()) if wta else ()
    for rnd in range(3):   # warm-up, capture; then replays
        before = TOPS.launch_counts()
        got = graphs(table, tokens, *wta_in)
        mid = TOPS.launch_counts()
        want = eager(table, tokens, *wta_in)
        after = TOPS.launch_counts()
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w), rnd
        assert torch.equal(got[4]["pos"], want[4]["pos"])
        for name in cache:
            a, b = eng._cache[name], cache[name]
            if name.endswith("pages"):   # idle slots race on the trash page 0
                a, b = a[:, :, 1:], b[:, :, 1:]
            assert torch.equal(a, b), (rnd, name)
        if rnd:
            assert {k: mid[k] - before[k] for k in mid} == {k: after[k] - mid[k] for k in mid}
        tokens = got[0][:, -1].cpu().numpy()
        if wta:
            wta_in = (wta_in[0], wta_in[1] + 3)
    assert list(graphs.entries) == [(4, 3)] and len(graphs.captures()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["same", "int8"])
def test_cuda_spec_engine_graphs_equal_eager_with_rollbacks(cuda_device, kv):
    """A speculating engine on captured rounds equals one on eager rounds,
    with rejections forced every other round: streams, pool (outside the
    trash page 0), ``pos`` and launch counts; every rollback writes into
    the tensors the graphs hold (their addresses never change), the
    rollback keeps one signature, and no round is captured per tick."""
    runs = {}
    params = None
    for graphs in (None, False):
        eng, params = _spec_engine(cuda_device, kv, False, graphs, params=params)
        ptrs = {k: v.data_ptr() for k, v in eng._cache.items()}
        calls = _tamper_every_other_round(eng)
        before = TOPS.launch_counts()
        for p in _graph_trace():
            eng.submit(p)
        outs = eng.run()
        torch.cuda.synchronize()
        after = TOPS.launch_counts()
        assert {k: v.data_ptr() for k, v in eng._cache.items()} == ptrs
        assert calls["n"] >= 2
        runs[graphs] = (eng, outs, {k: after[k] - before[k] for k in after})
    (g_eng, g_out, g_launch), (e_eng, e_out, e_launch) = runs[None], runs[False]
    assert g_eng._spec_graphs.capture and not e_eng._spec_graphs.capture
    assert g_out == e_out and g_launch == e_launch
    for name, leaf in g_eng._cache.items():
        other = e_eng._cache[name]
        if name.endswith("pages"):
            leaf, other = leaf[:, :, 1:], other[:, :, 1:]
        assert torch.equal(leaf, other), name
    m = g_eng.metrics()
    assert m.spec_accepted < m.spec_drafted
    counts = g_eng.compile_counts()
    assert counts == e_eng.compile_counts()
    assert counts["spec_rollback"] == 1
    assert counts["spec_round"] == len(g_eng._spec_graphs.captures()) < m.spec_rounds
    # decode attention: one launch per layer a draft step, one a verify
    plain_ticks = m.decode_steps - m.spec_rounds
    assert g_launch["paged_attention"] == 2 * (4 * m.spec_rounds + plain_ticks)


@pytest.mark.cuda
def test_cuda_fault_version_bump_recaptures_spec_graphs(cuda_device):
    """A ``fault_version`` bump drops the speculative round's graphs with
    the decode step's and captures them again: the replayed engine's
    streams equal an eager engine's under a degrade at tick 2 and a
    recover at tick 4, and the capture log holds round captures of every
    build generation."""
    from repro_torch.serving import FaultInjector

    def inj():
        return (FaultInjector().at(2, "degrade_device", comparator_offset=3.0)
                .at(4, "recover_device"))

    g_eng, params = _spec_engine(cuda_device, "same", True, None, k=2,
                                 device_backend="sim_faulty", fault_injector=inj())
    e_eng, _ = _spec_engine(cuda_device, "same", True, False, k=2, params=params,
                            device_backend="sim_faulty", fault_injector=inj())
    for eng in (g_eng, e_eng):
        for p in _graph_trace():
            eng.submit(p)
    while g_eng.sched.has_work():
        spec = g_eng._spec_graphs
        g_eng.tick()
        if g_eng._ticks - 1 in (2, 4):
            assert g_eng._spec_graphs is not spec
    assert g_eng.run() == e_eng.run()
    assert g_eng._rebuilds == e_eng._rebuilds == 2
    gens = {g for g, key, _ in g_eng.capture_log() if key[0] == "spec"}
    assert gens == {0, 1, 2}, g_eng.capture_log()
    assert g_eng.compile_counts() == e_eng.compile_counts()


# ---------------------------------------------------------------------------
# The device backend seam: fault state moving under captured graphs, and
# the faulty crossbar read.
# ---------------------------------------------------------------------------


def _fault_engine(device, backend, graphs, inj=None, params=None):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving import ServeConfig, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), wta_head=True)
    params = init_lm(cfg, seed=4, device=device) if params is None else params
    eng = ServingEngine(
        params, cfg,
        ServeConfig(max_batch=4, max_new_tokens=12, max_len=128, kv_block_size=8,
                    prefill_chunk=16, seed=3, device_backend=backend, fault_injector=inj),
        device=device, graphs=graphs)
    for p in _graph_trace():
        eng.submit(p)
    return eng, params


@pytest.mark.cuda
def test_cuda_fault_version_bump_drops_every_graph(cuda_device):
    """A ``fault_version`` bump drops every captured decode graph before
    the next tick (each baked the comparator point of its capture) and
    captures again: the replayed engine's streams equal an eager engine's
    that reads the backend every tick, under a degrade at tick 4 and a
    recover at tick 8, and differ from the healthy ``sim`` streams."""
    from repro_torch.serving import FaultInjector

    def inj():
        return (FaultInjector().at(4, "degrade_device", comparator_offset=3.0)
                .at(8, "recover_device"))

    g_eng, params = _fault_engine(cuda_device, "sim_faulty", None, inj())
    e_eng, _ = _fault_engine(cuda_device, "sim_faulty", False, inj(), params)
    h_eng, _ = _fault_engine(cuda_device, "sim", None, None, params)
    while g_eng.sched.has_work():
        graphs = [e.graph for s in g_eng._serve_steps.values() for e in s.entries.values()]
        g_eng.tick()
        if g_eng._ticks - 1 in (4, 8):   # the injector's ticks: every graph was replaced
            assert not any(e.graph is g for s in g_eng._serve_steps.values()
                           for e in s.entries.values() for g in graphs)
    outs = {"graphs": g_eng.run(), "eager": e_eng.run(), "sim": h_eng.run()}
    assert outs["graphs"] == outs["eager"]
    assert outs["graphs"] != outs["sim"]
    assert g_eng._rebuilds == e_eng._rebuilds == 2
    gens = {g for g, _, _ in g_eng.capture_log()}
    assert gens == {0, 1, 2}, g_eng.capture_log()
    assert g_eng.compile_counts() == e_eng.compile_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("binarize", [False, True])
def test_cuda_faulty_crossbar_read_matches_plain(cuda_device, binarize):
    """The crossbar read through ``FaultySimBackend`` (stuck cells, drift,
    read-noise inflation, comparator offset) on the card against its plain
    version on the same faulty weights, under chip_smoke.py's gates
    (linear: scaled by the read's range scale).  The faulty weights equal the
    CPU's within 4 ulps of a conductance (4 · 1.2e-7 · max|w|): PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, the
    CPU divides; stuck cells are exactly ±max|w| on both."""
    import dataclasses

    from repro_torch import random as R
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.physics import DeviceParams, calibrate_v_read
    from repro_torch.kernels import backend as BK

    def faulty():
        bk = BK.FaultySimBackend(fault=BK.FaultConfig(
            stuck_rate=0.01, drift_nu=0.1, read_sigma_inflation=0.2, comparator_offset=0.5))
        bk.advance_clock(100)
        return bk

    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.standard_normal((512, 200)) * 0.05).astype(np.float32))
    mode = "analog_stochastic" if binarize else "analog_linear"
    cfg = AnalogConfig(mode=mode, device=calibrate_v_read(DeviceParams(), 512))
    bk, key = faulty(), R.PRNGKey(5)
    wf = bk._faulty_weights(w.to(cuda_device))
    cpu = faulty()._faulty_weights(w)
    torch.testing.assert_close(wf.cpu(), cpu, atol=4 * 1.2e-7 * float(w.abs().max()), rtol=0)
    sa0, sa1 = (torch.from_numpy(a) for a in bk._stuck_masks(tuple(w.shape)))
    assert torch.equal(wf.cpu()[sa0 | sa1], cpu[sa0 | sa1])
    with BK.use_backend(bk):
        got = TOPS.crossbar_mac(x, w.to(cuda_device), key, cfg, binarize=binarize)
    # the fault backend's read is the plain read of the faulty weights at
    # the inflated noise, offset on the linear readout
    if binarize:
        pcfg = dataclasses.replace(cfg, beta=cfg.beta / 1.2)
        want = TOPS.crossbar_mac_reference(x, wf, key, pcfg, binarize=True)
        assert float((got == want).float().mean()) >= 0.9995
    else:
        # chip_smoke.py's linear gate, scaled by the range scale s the read
        # multiplies back (one more rounding on each side: 2**-23·|out|)
        pcfg = dataclasses.replace(cfg, linear_sigma=cfg.linear_sigma * 1.2)
        want = TOPS.crossbar_mac_reference(x, wf, key, pcfg, binarize=False) + 0.5
        s = TOPS.range_scale(wf)
        dp = cfg.device
        wq = TREF.crossbar_quantize(wf / s, TOPS._qstep(dp), dp.w_min, dp.w_max)
        tol = s * 2 * 512**0.5 * 2.0**-24 * (x.abs() @ wq.abs()) + 2.0**-23 * want.abs()
        assert float(((got - want).abs() / tol).max()) <= 1.0
