"""Plain-PyTorch models of the CUDA kernels' decompositions for
``wta_counts`` and ``stoch_round``, held bit for bit against their plain
versions on the CPU.

``model_wta_counts`` is the WTA kernel's race (``csrc/wta_counts.cu``):
column slices per CTA (``wta_geometry``), the CTA's warps over
interleaved 256-column steps, the bucket bound ``z + R[b]·|σ|`` (R: the
largest radius over each of 2048 buckets of the first uniform) and the
radius bound ``ub = z + r·|σ|``, with their strict comparisons against the
trial's best fired voltage (shared over the cluster), the per-warp fired
maximum with its tie list, the cluster combine, and votes from the tie
lists without a second pass (a warp with more than 32 columns at its
maximum draws again); narrow rows (C <= 512) draw every column, one warp
per (row, trial).  Pruning is exact, so the model equals
``ref.wta_counts_ref`` whatever order the warps run in: bit-equal, and
through it within the same agreement as the port's plain version against
``wta_counts_pallas`` in interpret mode (row sums equal, at most 1% of the
B·T decisions flipped: the reference's log and cos round differently).

``model_stoch_round`` is the 2-D ``stoch_round`` launch
(``stoch_round_geometry``): rows per CTA, the group and counter base once
per row, a scalar head up to the input row's 16-byte boundary (for a base
pointer that is not aligned), ``UNROLL`` float4 vectors per thread, the
``n % 4`` tail; every element covered once, bit-equal to
``ref.stoch_round_ref``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.compat import interpret_mode
from repro.kernels.wta_kernel import wta_counts_pallas
from repro_torch.kernels import prng as TPRNG
from repro_torch.kernels import ref as TREF
from repro_torch.kernels import stoch_round as SR
from repro_torch.kernels import wta_counts as WTA

WTA_FLIP_FRACTION = 0.01


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def _radius(idx, seed):
    return torch.sqrt(-2.0 * torch.log(TPRNG.uniform(idx, seed)))


def _noise(idx, seed, r, sigma):
    u2 = TPRNG.uniform(idx, (seed + TPRNG.GOLDEN) & TPRNG.MASK)
    return (r * torch.cos(TPRNG.TWO_PI_F32 * u2)) * sigma


_TABLE = []


def _radius_table():
    """The kernel's radius table on the CPU: the largest radius over each
    of the 2048 buckets of u1's 2**24 values (its top 11 bits)."""
    if not _TABLE:
        k = torch.arange(1 << 24, dtype=torch.int64)
        r = torch.sqrt(-2.0 * torch.log(TPRNG.uniform01(k << 8)))
        _TABLE.append(r.reshape(WTA.RADIUS_BUCKETS, -1).amax(-1))
    return _TABLE[0]


def _bucket_bound(idx, seed, abs_sigma):
    bits = TPRNG.hash_u32(idx, seed)
    return _radius_table()[bits >> 21] * abs_sigma


def _warps(geo):
    """(lo, hi, first step, step stride) per warp of one (row, trial)."""
    per = geo.cols_per_cta
    return [(r * per, r * per + per, w, geo.warps)
            for r in range(geo.n_cta) for w in range(geo.warps)]


def _draw_all(z, seed, base, sigma, cols):
    idx = (base + cols) & TPRNG.MASK
    return z + _noise(idx, seed, _radius(idx, seed), sigma)


def model_wta_counts(z, seed, *, n_trials, vth0, sigma_z, geometry=None, order=0):
    """The kernel's decomposition in plain PyTorch.  ``geometry`` (default:
    ``wta_geometry`` on a card of 6336 resident warps) picks the narrow-row
    kernel (every column drawn) or the cluster race; ``order`` seeds the
    interleaving of the racing warps' steps (each warp keeps its own steps
    in order)."""
    b, c = z.shape
    c_pad = -(-c // 128) * 128
    stride = WTA.wta_trial_stride(c_pad)
    sigma, abs_sigma, vth = _f32(sigma_z), _f32(abs(sigma_z)), _f32(vth0)
    geo = geometry or WTA.wta_geometry(c, b * n_trials, 6336)
    rng = np.random.default_rng(order)
    counts = torch.zeros_like(z)
    for row in range(b):
        for t in range(n_trials):
            base = (row * c_pad + t * stride) & TPRNG.MASK
            if geo.n_cta == 0:                          # one warp, every column drawn
                v = _draw_all(z[row], seed, base, sigma, torch.arange(c))
                fired = v > vth
                if fired.any():                         # from the tie list, or drawn again
                    counts[row, fired & (v == v[fired].max())] += 1.0
                continue
            warps = [(lo, min(hi, c), s0, ds) for lo, hi, s0, ds in _warps(geo)]
            steps = [list(range(s0, max(0, -(-(hi - lo) // WTA.STEP_COLS)), ds))
                     for lo, hi, s0, ds in warps]
            sched = np.concatenate([np.full(len(s), i) for i, s in enumerate(steps)]).astype(int)
            rng.shuffle(sched)
            best = [_f32(-np.inf)] * len(warps)
            ties, n = [[] for _ in warps], [0] * len(warps)
            shared = _f32(-np.inf)
            for i in sched:
                lo, hi, _, _ = warps[i]
                s = steps[i].pop(0)
                cols = torch.arange(lo + s * WTA.STEP_COLS, min(hi, lo + (s + 1) * WTA.STEP_COLS))
                zz = z[row, cols]
                prune = torch.maximum(best[i], shared)
                idx = (base + cols) & TPRNG.MASK
                ubb = zz + _bucket_bound(idx, seed, abs_sigma)   # after the first hash
                keep = (ubb > vth) & ~(ubb < prune)
                cols, zz, idx = cols[keep], zz[keep], idx[keep]
                r = _radius(idx, seed)
                ub = zz + r * abs_sigma                 # the radius bound
                cand = (ub > vth) & ~(ub < prune)
                cols, idx, zz, r = cols[cand], idx[cand], zz[cand], r[cand]
                v = zz + _noise(idx, seed, r, sigma)
                fired = v > vth
                if not fired.any():
                    continue
                m = v[fired].max()
                if m > best[i]:
                    best[i], ties[i], n[i] = m, [], 0
                    shared = torch.maximum(shared, m)
                win = fired & (v == best[i])
                ties[i] += cols[win].tolist()
                n[i] += int(win.sum())
            for i, (lo, hi, s0, ds) in enumerate(warps):
                if n[i] == 0 or not bool(best[i] == shared):
                    continue
                if n[i] <= WTA.TIES:                    # votes from the tie list
                    counts[row, ties[i][: WTA.TIES]] += 1.0
                    continue
                mine = torch.cat([torch.arange(lo + s * WTA.STEP_COLS,
                                               min(hi, lo + (s + 1) * WTA.STEP_COLS))
                                  for s in range(s0, -(-(hi - lo) // WTA.STEP_COLS), ds)])
                v = _draw_all(z[row, mine], seed, base, sigma, mine)
                counts[row, mine[(v > vth) & (v == shared)]] += 1.0
    return counts


def _z(seed, b, c, scale=1.702):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal((b, c)) * scale).astype(np.float32))


def test_wta_geometry_shapes():
    assert WTA.wta_geometry(50304, 8 * 32, 6336) == (2, 8, 25152)   # the serving head
    assert WTA.wta_geometry(50304, 32, 6336) == (8, 8, 6288)        # one row: 64 warps
    assert WTA.wta_geometry(50304, 4096, 6336) == (2, 8, 25152)     # many waves
    assert WTA.wta_geometry(8200, 9, 6336) == (2, 8, 4100)
    assert WTA.wta_geometry(1030, 8, 6336) == (1, 2, 1032)
    assert WTA.wta_geometry(512, 8, 6336) == (0, 1, 512)
    assert WTA.wta_geometry(10, 6400, 6336) == (0, 1, 10)
    for c in (513, 1030, 4097, 8200, 33000, 50304, 262144):
        for pairs in (1, 8, 256, 5000):
            n_cta, warps, per = WTA.wta_geometry(c, pairs, 6336)
            assert n_cta in (1, 2, 4, 8) and 1 <= warps <= WTA.WARPS and per % 4 == 0
            assert n_cta * per >= c and (n_cta - 1) * per < c   # every CTA has columns
            assert n_cta * warps <= max(1, c // WTA.MIN_WARP_COLS) + n_cta - 1


@pytest.mark.parametrize("b,c,n_trials,seed", [
    (3, 300, 8, 99),             # warp mode, C off the 128 grid
    (2, 1030, 4, 7),             # one CTA of 8 warps, C % 4 != 0
    (2, 8200, 2, 2**32 - 1),     # a cluster of 4, the trial stride wraps 2**32
    (24, 10, 3, 5),              # the 10-class head at T = 3: rows share a CTA
])
def test_wta_model_bit_equal_to_plain(b, c, n_trials, seed):
    z = _z(c, b, c)
    kw = dict(n_trials=n_trials, vth0=1.702**2, sigma_z=1.702)
    want = TREF.wta_counts_ref(z, seed, **kw)
    got = model_wta_counts(z, seed, **kw)
    assert torch.equal(got, want)
    assert torch.equal(model_wta_counts(z, seed, **kw, order=1), want)
    assert want.sum() > 0
    if c > WTA.WARP_MODE_MAX_C:                  # every cluster shape gives the same counts
        for n_cta, warps in ((1, 1), (4, 3), (8, 8)):
            geo = WTA.WtaGeometry(n_cta, warps, -(-c // n_cta // 4) * 4 + 4)
            assert torch.equal(model_wta_counts(z, seed, **kw, geometry=geo), want)


def test_wta_model_serving_head_shape():
    """One row of the 50304-class head at its own launch shape (clusters of
    2 CTAs of 8 warps) and at 8 × 8 warps."""
    z = _z(50304, 1, 50304)
    kw = dict(n_trials=2, vth0=1.702**2, sigma_z=1.702)
    want = TREF.wta_counts_ref(z, 77, **kw)
    for geo in ((2, 8, 25152), (8, 8, 6288)):
        assert torch.equal(model_wta_counts(z, 77, **kw, geometry=WTA.WtaGeometry(*geo)), want)


def test_wta_model_rows_that_never_fire():
    z = _z(4, 6, 300)
    z[1] -= 100.0
    z[4] = -50.0
    kw = dict(n_trials=8, vth0=1.702**2, sigma_z=1.702)
    got = model_wta_counts(z, 3, **kw)
    assert torch.equal(got, TREF.wta_counts_ref(z, 3, **kw))
    assert got[1].sum() == 0 and got[4].sum() == 0 and got[0].sum() == 8
    nothing = model_wta_counts(z, 3, n_trials=4, vth0=1e6, sigma_z=1.702)
    assert nothing.sum() == 0


@pytest.mark.parametrize("c", [10, 300, 1030, 8200])
def test_wta_model_exact_ties(c):
    """σ = 0 makes v = z: a duplicated maximum ties in every trial and each
    tied column gets T votes; a row of equal values overflows every warp's
    tie list and votes by drawing again."""
    z = _z(c + 1, 3, c)
    top = float(z.max()) + 1.0
    z[0, [1, c // 2, c - 1]] = top
    z[2] = 2.0                      # every column tied, above vth0
    kw = dict(n_trials=5, vth0=1.0, sigma_z=0.0)
    want = TREF.wta_counts_ref(z, 11, **kw)
    got = model_wta_counts(z, 11, **kw)
    assert torch.equal(got, want)
    assert got[0].tolist() == [5.0 if j in (1, c // 2, c - 1) else 0.0 for j in range(c)]
    assert bool((got[2] == 5).all())


@pytest.mark.parametrize("seed", [0, 12345, 2**31, 2**32 - 1])
def test_wta_bounds_hold_elementwise(seed):
    """v ≤ ub = z ⊕ (r ⊗ |σ|) ≤ z ⊕ (R[b] ⊗ |σ|) for every element, at both
    signs of σ, over many counters."""
    g = np.random.default_rng(seed)
    idx = torch.from_numpy(g.integers(0, 2**32, 1 << 16, dtype=np.int64))
    z = torch.from_numpy((g.standard_normal(1 << 16) * 3).astype(np.float32))
    for s in (1.702, -0.37, 25.0):
        sigma, abs_sigma = _f32(s), _f32(abs(s))
        r = _radius(idx, seed)
        v = z + TPRNG.gaussian(idx, seed) * sigma      # the plain version's voltage
        assert torch.equal(v, z + _noise(idx, seed, r, sigma))
        ub = z + r * abs_sigma
        ubb = z + _bucket_bound(idx, seed, abs_sigma)
        assert bool((v <= ub).all()) and bool((ub <= ubb).all())


def test_wta_bound_premises_over_every_uniform():
    """The 2**24 values each uniform can take: |cos(2π·u2)| ≤ 1, and the
    table's largest radius is u1 = 2**-25's (the card checks its own logf
    and cosf the same way, ``wta_counts.draw_bounds``)."""
    u = TPRNG.uniform01(torch.arange(1 << 24, dtype=torch.int64) << 8)
    assert 5.88 < float(_radius_table().max()) < 5.89
    assert float(torch.cos(TPRNG.TWO_PI_F32 * u).abs().max()) <= 1.0
    # the radius falls with u1, so each bucket's largest is at its first value
    assert torch.equal(_radius_table(), torch.sqrt(-2.0 * torch.log(u[:: 1 << 13])))


@pytest.mark.parametrize("b,c,n_trials,seed", [(5, 300, 16, 99), (10, 10, 12, 4),
                                                (2, 1030, 3, 2**32 - 1)])
def test_wta_model_agrees_with_pallas_interpret(b, c, n_trials, seed):
    vth0, sigma = 2.897, 1.702
    z = (np.random.default_rng(c).standard_normal((b, c)) * 2.0).astype(np.float32)
    zp = np.pad(z, ((0, (-b) % 128), (0, (-c) % 128)))
    want = np.asarray(wta_counts_pallas(
        jnp.asarray(zp), jnp.asarray(np.asarray([seed], np.uint32).view(np.int32)),
        n_trials=n_trials, vth0=vth0, sigma_z=sigma, valid_c=c, interpret=interpret_mode(),
    ))[:b, :c]
    got = model_wta_counts(torch.from_numpy(z), seed, n_trials=n_trials, vth0=vth0,
                           sigma_z=sigma).numpy()
    np.testing.assert_array_equal(got.sum(-1), want.sum(-1))
    assert np.abs(got - want).sum() <= 2 * WTA_FLIP_FRACTION * b * n_trials


# ---------------------------------------------------------------------------
# stoch_round's 2-D launch
# ---------------------------------------------------------------------------


def _vector_order(nv, tx):
    """The vectors each thread takes, lane by lane: v0 = lane, lane +
    tx·UNROLL, ..., each with its UNROLL loads in flight."""
    vec = []
    for lane in range(tx):
        for v0 in range(lane, nv, tx * SR.UNROLL):
            vec += [v0 + u * tx for u in range(SR.UNROLL) if v0 + u * tx < nv]
    assert sorted(vec) == list(range(nv))                 # each vector once
    return vec


def model_stoch_round(x, seeds, *, step, lo, hi, x_off=0, out_off=0):
    """The kernel's indexing: ``x_off`` / ``out_off`` are the data pointers'
    offsets in f32 elements from a 16-byte boundary.  Returns the output
    and, per row, which elements its head, vectors and tail wrote."""
    m, n = x.shape
    geo = SR.stoch_round_geometry(m, n)
    assert geo.tx % 32 == 0 and geo.tx * geo.ty <= SR.THREADS and geo.blocks * geo.ty >= m
    seeds = torch.as_tensor(seeds, dtype=torch.int64).reshape(-1)
    rows_per_seed = m // seeds.shape[0]
    n_padded = -(-n // 512) * 512
    lo_t, step_t, inv = _f32(lo), _f32(step), _f32(1.0 / step)
    out = torch.full_like(x, float("nan"))
    paths = []
    for row in range(m):
        group = row // rows_per_seed                        # once per row
        ctr0 = ((row - group * rows_per_seed) * n_padded) & TPRNG.MASK

        def rnd(cols):
            t = (torch.clamp(x[row, cols], lo, hi) - lo_t) * inv
            fl = torch.floor(t)
            u = TPRNG.uniform((ctr0 + cols) & TPRNG.MASK, seeds[group])
            out[row, cols] = (fl + (u < t - fl).to(torch.float32)) * step_t + lo_t

        head = min(n, (-(x_off + row * n)) % 4)
        nv = (n - head) // 4
        tail0 = head + 4 * nv
        rnd(torch.arange(head))                             # lanes < head
        rnd(torch.arange(tail0, n))                         # lanes < n % 4 past the vectors
        vec = _vector_order(nv, geo.tx)
        vec_cols = (head + 4 * torch.tensor(vec, dtype=torch.int64)[:, None]
                    + torch.arange(4)).reshape(-1)
        rnd(vec_cols)
        assert (x_off + row * n + head) % 4 == 0 or nv == 0   # aligned loads
        paths.append((head, nv, n - tail0, (out_off + row * n + head) % 4 == 0))
    return out, paths


def _sr_x(seed, shape, lo, hi):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.8 * hi).astype(np.float32)
    x.flat[:6] = [lo - 1.0, lo, hi, hi + 1.0, 0.0, lo + (hi - lo) / 2]
    return torch.from_numpy(x)


@pytest.mark.parametrize("shape,step,lo,hi,groups", [
    ((33, 70), 2.0 / 31, -1.0, 1.0, 1),
    ((16, 520), 2.0 / 31, -1.0, 1.0, 1),
    ((256, 80), 1.0, -127.0, 127.0, 1),
    ((5, 1030), 0.1, -1.0, 1.0, 1),
    ((99, 70), 2.0 / 31, -1.0, 1.0, 3),
    ((4096, 80), 1.0, -127.0, 127.0, 8),     # the int8 prefill chunk's rows
])
@pytest.mark.parametrize("x_off", [0, 1])
def test_stoch_round_model_bit_equal_to_plain(shape, step, lo, hi, groups, x_off):
    x = _sr_x(shape[1], shape, lo, hi)
    seeds = torch.tensor([2**32 - 1, 3, 2**31, 9, 0, 77, 5, 12][:groups])
    kw = dict(step=step, lo=lo, hi=hi)
    got, paths = model_stoch_round(x, seeds, **kw, x_off=x_off)
    assert torch.equal(got, TREF.stoch_round_ref(x, seeds, **kw))
    heads = {h for h, *_ in paths}
    tails = {t for _, _, t, _ in paths}
    if shape[1] % 4 == 0:
        assert heads == {(-x_off) % 4} and tails == {(4 - heads.pop()) % 4}
        assert all(ovec == (x_off == 0) for *_, ovec in paths)   # out is aligned
    else:
        assert len(heads) > 1 and max(tails) > 0


def test_stoch_round_geometry_shapes():
    assert SR.stoch_round_geometry(2048, 2048) == (128, 2, 1024)
    assert SR.stoch_round_geometry(256, 80) == (32, 8, 32)
    assert SR.stoch_round_geometry(4096, 80) == (32, 8, 512)
    assert SR.stoch_round_geometry(5, 1030) == (96, 2, 3)
    assert SR.stoch_round_geometry(3, 1) == (32, 8, 1)
    assert SR.stoch_round_geometry(16, 256) == (32, 8, 2)
    assert SR.stoch_round_geometry(1, 65536) == (256, 1, 1)
