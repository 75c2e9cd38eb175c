"""The port's WTA sampling against ``repro.core.wta`` and the reference's
serving sampler.

The same numpy inputs and the same threefry keys go to both packages.
Tolerances, and why:

- ``erf_inv`` fed jax's own ``log1p`` is XLA's polynomial step for step:
  bit-equal.  With torch's ``log1p`` (the port's), ``normal`` is bit-equal
  on at least 95% of a (32, 50304) draw and within 8 ulp everywhere
  (99.06% and 3 ulp with torch 2.13.0+cpu,
  ``tests/torch_cpu_rounding.py``); the bits and uniforms are exact.
- WTA counts and decisions: a trial can change only where an ulp of noise
  moves a voltage across the threshold or past another fired voltage, so
  at least 99.95% of the elements agree (``tests/test_kernels.py``'s
  agreement), and counted over trials, Σ|Δcounts| is at most two per
  trial for 0.1% of the N·T trials (one at least); in these cases all of
  them agree.
- fire probabilities: 1e-5 relative, 1e-6 absolute (16 ulps of f32 erf
  near −1, where the two frameworks' erf differ by a few ulps);
- ``sample_tokens``: the reference's token in at least 99.9% of at least
  2000 (slot, step) cases, over one read and over three.
- The port's own identities (batch composition, prefix sharing, one read
  against the plain path) are byte for byte; the engines' WTA streams at
  f32 are held equal, and a divergence is reported with the vote counts
  at it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import wta as JW
from repro.launch import specs as JSP
from repro.models import transformer as JTF
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import random as R
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import analog as TA
from repro_torch.core import wta as TW
from repro_torch.kernels import ref
from repro_torch.launch import specs as SP
from repro_torch.models import transformer as TTF
from repro_torch.models.transformer import init_lm
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.scheduler import left_pad

NORMAL_EQUAL = 0.95
NORMAL_ULP = 8
COUNT_AGREEMENT = 0.9995
# and, counted over trials: a trial that names another winner moves at
# most two counts, and at most 0.1% of the N·T trials (one at least) may
TRIAL_FLIPS = 0.001
TOKEN_AGREEMENT = 0.999
PROB_ATOL = 1e-6   # 16 ulps of erf near -1
VTH0, SIGMA = 1.702**2, 1.702


def _pair(k) -> tuple[int, int]:
    a = np.asarray(jax.random.key_data(k), np.uint32)
    return int(a[0]), int(a[1])


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want).astype(np.float32))


# ---------------------------------------------------------------------------
# erf_inv and normal.
# ---------------------------------------------------------------------------


def test_erf_inv_is_xlas_polynomial(monkeypatch):
    """Fed jax's log1p, the port's erf_inv is jax.lax.erf_inv bit for bit,
    near ±1 (the √w branch), at ±1 (±inf) and beyond (NaN) included."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-1, 1, 200_000), 1 - rng.random(20_000) * 1e-5,
        -1 + rng.random(20_000) * 1e-5, [1.0, -1.0, 0.0, -0.0, 1.5, np.nan],
    ]).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    monkeypatch.setattr(torch, "log1p",
                        lambda t: torch.from_numpy(np.array(jnp.log1p(jnp.asarray(t.numpy())))))
    got = R.erf_inv(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_normal_matches_jax(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    shape = (32, 50304)
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = R.normal(_pair(key), shape).numpy()
    equal, worst = float((got == want).mean()), float(_ulps(got, want).max())
    print(f"normal {shape}: {equal:.4f} bit-equal, worst {worst:.0f} ulp")
    assert equal >= NORMAL_EQUAL and worst <= NORMAL_ULP
    # the uniforms under it are exact
    u = R.uniform(_pair(key), shape, minval=R.NORMAL_LO, maxval=1.0).numpy()
    ju = jax.random.uniform(key, shape, jnp.float32, np.nextafter(np.float32(-1), np.float32(0)), 1)
    assert np.array_equal(u, np.asarray(ju))
    # a slice of the flat range draws the same values
    part = R.normal(_pair(key), shape, start=2**20 + 3, count=5000).numpy()
    assert np.array_equal(part, got.reshape(-1)[2**20 + 3 : 2**20 + 5003])


# ---------------------------------------------------------------------------
# core.wta against repro.core.wta.
# ---------------------------------------------------------------------------

# (N, C, T): narrow rows, the paper's 10-class head, wider rows
SHAPES = [(4, 3, 64), (64, 10, 100), (8, 17, 50), (3, 300, 32), (2, 2000, 16)]


def _z(rng, n, c):
    z = (rng.standard_normal((n, c)) * SIGMA).astype(np.float32)
    z[0] = -40.0   # a row in which nothing fires
    return z


@pytest.mark.parametrize("n,c,t", SHAPES)
def test_wta_trials_match_reference(n, c, t):
    rng = np.random.default_rng(n * 1000 + c)
    z = _z(rng, n, c)
    key = jax.random.PRNGKey(int(rng.integers(0, 2**31)))
    want = JW.wta_trials(key, jnp.asarray(z), t, VTH0, SIGMA)
    got = TW.wta_trials(_pair(key), torch.from_numpy(z), t, VTH0, SIGMA)
    counts = got.counts.numpy()
    agree = float((counts == np.asarray(want.counts)).mean())
    moved = float(np.abs(counts - np.asarray(want.counts)).sum())
    print(f"wta_trials ({n}, {c}) T={t}: counts agree on {agree:.6f}, sum|Δcounts| {moved:.0f}")
    assert agree >= COUNT_AGREEMENT
    assert moved <= 2 * max(1, int(TRIAL_FLIPS * n * t))
    assert float((got.n_decisions.numpy() == np.asarray(want.n_decisions)).mean()) \
        >= COUNT_AGREEMENT
    np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), atol=2.0 / t)
    # one winner per fired trial, none where nothing fires
    np.testing.assert_array_equal(counts.sum(-1), got.n_decisions.numpy())
    assert counts[0].sum() == 0 and got.n_decisions[0] == 0
    assert (counts.sum(-1)[1:] <= t).all()


def test_wta_trials_leading_axes():
    """z (..., C): the trial tensor is normal(key, (T,) + z.shape)."""
    rng = np.random.default_rng(5)
    z = (rng.standard_normal((2, 3, 12)) * SIGMA).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = JW.wta_trials(key, jnp.asarray(z), 40, VTH0, SIGMA)
    got = TW.wta_trials(_pair(key), torch.from_numpy(z), 40, VTH0, SIGMA)
    assert got.counts.shape == z.shape and got.n_decisions.shape == z.shape[:-1]
    assert float((got.counts.numpy() == np.asarray(want.counts)).mean()) >= COUNT_AGREEMENT


def test_wta_classify_topk_and_expected_probs_match_reference():
    rng = np.random.default_rng(11)
    z = (rng.standard_normal((16, 10)) * SIGMA).astype(np.float32)
    key = jax.random.PRNGKey(4)
    zt = torch.from_numpy(z)
    cls_j = np.asarray(JW.wta_classify(key, jnp.asarray(z), 64, VTH0, SIGMA))
    cls_t = TW.wta_classify(_pair(key), zt, 64, VTH0, SIGMA).numpy()
    assert float((cls_j == cls_t).mean()) >= COUNT_AGREEMENT
    share_j, idx_j = JW.wta_topk(key, jnp.asarray(z), 3, 64, VTH0, SIGMA)
    share_t, idx_t = TW.wta_topk(_pair(key), zt, 3, 64, VTH0, SIGMA)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(share_t.numpy(), np.asarray(share_j), rtol=1e-6)
    # 0.5·(1 + erf): near erf = −1 the sum keeps erf's absolute error, and
    # torch's and XLA's f32 erf differ there by a few of its ulps (6e-8)
    np.testing.assert_allclose(
        TW.wta_expected_probs(zt, VTH0, SIGMA).numpy(),
        np.asarray(JW.wta_expected_probs(jnp.asarray(z), VTH0, SIGMA)), rtol=1e-5, atol=PROB_ATOL,
    )
    np.testing.assert_allclose(
        TW.wta_fire_probability(zt, VTH0, beta=2.0).numpy(),
        np.asarray(JW.wta_fire_probability(jnp.asarray(z), VTH0, beta=2.0)), rtol=1e-5,
        atol=PROB_ATOL,
    )
    assert TW.calibrated_threshold(2.0, 0.5) == JW.calibrated_threshold(2.0, 0.5)


def test_analog_wta_readouts_match_reference():
    from repro.core import analog as JA

    rng = np.random.default_rng(12)
    z = (rng.standard_normal((4, 10)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(8)
    for kw in ({}, {"wta_vth0": 1.5, "beta": 2.0, "wta_trials": 50}):
        jc, tc = JA.AnalogConfig(**kw), TA.AnalogConfig(**kw)
        assert tc.vth0 == jc.vth0
        want = JA.wta_head(jc, key, jnp.asarray(z))
        got = TA.wta_head(tc, _pair(key), torch.from_numpy(z))
        assert np.array_equal(got.counts.numpy(), np.asarray(want.counts))
    stoch = TA.AnalogConfig(mode="analog_stochastic")
    _, idx_j = JA.wta_router_topk(JA.AnalogConfig(mode="analog_stochastic"), key,
                                  jnp.asarray(z), 2)
    _, idx_t = TA.wta_router_topk(stoch, _pair(key), torch.from_numpy(z), 2)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    vals_j, idx_j = JA.wta_router_topk(JA.AnalogConfig(), None, jnp.asarray(z), 2)
    vals_t, idx_t = TA.wta_router_topk(TA.AnalogConfig(), None, torch.from_numpy(z), 2)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j), rtol=1e-6)


# ---------------------------------------------------------------------------
# The serving sampler.
# ---------------------------------------------------------------------------


def _wta_cfgs(trials=32):
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), wta_head=True)
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), wta_head=True)
    if trials != 32:
        jcfg = dataclasses.replace(jcfg, analog=dataclasses.replace(jcfg.analog, wta_trials=trials))
        tcfg = dataclasses.replace(tcfg, analog=dataclasses.replace(tcfg.analog, wta_trials=trials))
    return jcfg, tcfg


def _slot_cases(n_slots=8, n_steps=125, v=256, seed=0):
    """One row per (slot, step): the slot's key, the step, random logits."""
    rng = np.random.default_rng(seed)
    base = jax.random.PRNGKey(17)
    slot_keys = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(base, s)))
                          for s in range(n_slots)]).astype(np.uint32)
    keys = np.repeat(slot_keys, n_steps, axis=0)
    steps = np.tile(np.arange(n_steps), n_slots).astype(np.int32)
    steps[-1] = 2**31 - 1
    logits = (rng.standard_normal((n_slots * n_steps, v)) * 2.5).astype(np.float32)
    return keys, steps, logits


@pytest.mark.parametrize("reads", [1, 3])
def test_sample_tokens_matches_reference(reads):
    jcfg, tcfg = _wta_cfgs()
    keys, steps, logits = _slot_cases(seed=reads)
    want = np.asarray(JSP.sample_tokens(jcfg, jnp.asarray(logits), jnp.asarray(keys),
                                        jnp.asarray(steps), n_redundant=reads))
    got = SP.sample_tokens(tcfg, torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
                           torch.from_numpy(steps.astype(np.int64)), n_redundant=reads).numpy()
    mismatches = int((got != want).sum())
    print(f"sample_tokens R={reads}: {mismatches} of {len(want)} (slot, step) cases differ")
    assert got.dtype == np.int32 and len(want) >= 1000
    assert 1 - mismatches / len(want) >= TOKEN_AGREEMENT


def test_sample_tokens_whole_batch_key_matches_reference():
    """A 1-D key: one trial tensor for the batch (steps are not folded)."""
    jcfg, tcfg = _wta_cfgs()
    _, _, logits = _slot_cases(n_slots=1, n_steps=64, seed=5)
    key = jax.random.PRNGKey(23)
    for reads in (1, 3):
        want = np.asarray(JSP.sample_tokens(jcfg, jnp.asarray(logits), key,
                                            n_redundant=reads))
        got = SP.sample_tokens(tcfg, torch.from_numpy(logits), _pair(key),
                               torch.zeros(64, dtype=torch.int64), n_redundant=reads).numpy()
        assert float((got == want).mean()) >= TOKEN_AGREEMENT


def test_sample_tokens_greedy_without_key_or_head():
    _, tcfg = _wta_cfgs()
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 40)).astype(np.float32))
    want = torch.argmax(logits, -1).to(torch.int32)
    assert torch.equal(SP.sample_tokens(tcfg, logits), want)
    greedy = dataclasses.replace(tcfg, wta_head=False)
    assert torch.equal(SP.sample_tokens(greedy, logits, (0, 1), torch.zeros(5)), want)


def test_one_read_is_the_plain_path():
    """Per-slot sampling with R = 1 is, row for row, the argmax of
    ``wta_trials`` under the slot key with its step folded in; and read 0
    of R = 3 is that same draw."""
    _, tcfg = _wta_cfgs()
    keys, steps, logits = _slot_cases(n_slots=3, n_steps=4, v=64, seed=9)
    tk, ts = torch.from_numpy(keys.astype(np.int64)), torch.from_numpy(steps.astype(np.int64))
    got = SP.sample_tokens(tcfg, torch.from_numpy(logits), tk, ts)
    for i in range(len(logits)):
        k = R.fold_in((int(keys[i, 0]), int(keys[i, 1])), int(steps[i]))
        res = TW.wta_trials(k, torch.from_numpy(logits[i]), 32, tcfg.analog.vth0,
                            TW.wta_sigma_z(tcfg.analog.beta))
        assert int(got[i]) == int(torch.argmax(res.counts))
    counts0, _ = ref.wta_trial_counts_ref(torch.from_numpy(logits), tk, ts[:, None], n_trials=32,
                                          vth0=tcfg.analog.vth0, sigma_z=1.702,
                                          layout=(64, 0))
    assert torch.equal(counts0.argmax(-1).to(torch.int32), got)


def test_wta_vote_concentration_with_trials():
    """As the trial count grows the majority vote concentrates on the
    argmax token (``tests/test_serving.py``'s case, on the port)."""
    z = np.asarray([0.0, -0.5, 0.3, 2.0, 0.8, -1.0, 0.5, -0.2,
                    0.1, -0.8, 0.4, 0.0, -0.3, 0.6, -0.6, 0.2], np.float32)
    n = 256
    logits = torch.from_numpy(np.broadcast_to(z, (n, z.size)).copy())
    base = R.PRNGKey(123)
    keys = torch.tensor([R.fold_in(base, i) for i in range(n)], dtype=torch.int64)
    steps = torch.zeros(n, dtype=torch.int64)
    rates = {}
    for trials in (1, 16, 256):
        _, tcfg = _wta_cfgs(trials)
        toks = SP.sample_tokens(tcfg, logits, keys, steps)
        rates[trials] = float((toks == int(np.argmax(z))).float().mean())
    assert rates[16] > rates[1] - 0.05
    assert rates[256] > rates[16] - 0.05
    assert rates[256] > 0.9, rates


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------


def _smoke_engine(wcfg, params, **kw):
    sc = dict(max_batch=3, max_new_tokens=4, max_len=32, seed=11)
    sc.update(kw)
    return ServingEngine(params, wcfg, ServeConfig(**sc), device="cpu")


def test_per_request_sampling_invariant_to_batch_composition():
    cfg = get_smoke_config("stablelm-3b")
    wcfg = dataclasses.replace(cfg, wta_head=True)
    params = init_lm(cfg, seed=0, device="cpu")
    solo = _smoke_engine(wcfg, params)
    rid = solo.submit([5, 6, 7])
    out_solo = solo.run()[rid]
    crowd = _smoke_engine(wcfg, params)
    rid = crowd.submit([5, 6, 7])   # the same rid 0: the same key
    crowd.submit([1, 2, 3, 4])
    crowd.submit([9])
    assert crowd.run()[rid] == out_solo
    # the sampler draws: another seed gives another stream
    other = _smoke_engine(wcfg, params, seed=12)
    rid = other.submit([5, 6, 7])
    assert other.run()[rid] != out_solo
    greedy = _smoke_engine(cfg, params)
    rid = greedy.submit([5, 6, 7])
    assert greedy.run()[rid] != out_solo


SHARED_PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8], [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9],
                  [1, 2, 3, 4, 5, 6, 7, 8], [9, 9, 9]]
SHARED_BUDGETS = [6, 4, 6, 3, 5]


@pytest.mark.parametrize("reads", [1, 3])
def test_prefix_sharing_wta_sampling_stays_per_request(reads):
    """A full hit samples its first token from stored logits under its own
    key: sharing on and off give the same streams, byte for byte."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), wta_head=True)
    params = init_lm(cfg, seed=0, device="cpu")
    outs, engs = [], []
    for share in (True, False):
        eng = _smoke_engine(cfg, params, max_new_tokens=8, max_len=64, kv_block_size=8,
                            enable_prefix_sharing=share, n_redundant_reads=reads)
        for p, b in zip(SHARED_PROMPTS, SHARED_BUDGETS):
            eng.submit(p, b)
        outs.append(eng.run())
        engs.append(eng)
    assert outs[0] == outs[1]
    assert engs[0].metrics().prefix_hits >= 1


def test_redundant_reads_validated():
    with pytest.raises(ValueError, match="n_redundant_reads"):
        ServeConfig(n_redundant_reads=0).validate()


SERVE = dict(
    max_batch=4, max_new_tokens=6, max_len=64, kv_block_size=8,
    prefill_chunk=16, prefill_buckets=(12, 16, 32, 36, 48), seed=5,
)


def _trace():
    """``tests/test_torch_engine.py``'s shared-prefix trace."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, 24).tolist()
    y = rng.integers(0, 256, 12).tolist()
    x = rng.integers(0, 256, 32).tolist()
    a = prefix + rng.integers(0, 256, 12).tolist()
    return [y, y, x, a, prefix + rng.integers(0, 256, 12).tolist(), x,
            rng.integers(0, 256, 5).tolist(), prefix + rng.integers(0, 256, 12).tolist(),
            rng.integers(0, 256, 40).tolist()]


def _votes_at(tp, tcfg, prompt, bucket, stream, i, rkey):
    """The port's and the reference's top-two vote counts for token i of a
    stream, teacher-forced through the port's model (the report of a
    divergence)."""
    bs, n_blocks = SERVE["kv_block_size"], SERVE["max_len"] // SERVE["kv_block_size"]
    cache = TTF.init_paged_decode_cache(tcfg, 1, n_blocks + 1, bs, device="cpu")
    row = torch.arange(1, n_blocks + 1, dtype=torch.int32)
    toks = torch.tensor([left_pad(prompt, bucket)], dtype=torch.int32)
    _, _, logits = TTF.lm_prefill_chunk(
        tp, toks, tcfg, cache, TTF.init_prefill_state(tcfg, "cpu"), row, 0
    )
    cache["pos"] = torch.tensor([bucket], dtype=torch.int32)
    for t in stream[:i]:
        cache, logits = TTF.lm_decode_step(
            tp, cache, torch.tensor([t], dtype=torch.int32), tcfg, row[None]
        )
    k = R.fold_in(rkey, i)
    z = logits[0].float()
    mine = TW.wta_trials(k, z, 32, tcfg.analog.vth0).counts
    theirs = np.asarray(JW.wta_trials(jax.random.wrap_key_data(np.asarray(k, np.uint32)),
                                      jnp.asarray(z.numpy()), 32, tcfg.analog.vth0).counts)
    return torch.topk(mine, 2), np.sort(theirs)[-2:][::-1], np.argsort(-theirs, kind="stable")[:2]


def test_wta_engine_streams_match_reference():
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), dtype="float32", wta_head=True)
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32", wta_head=True)
    jp = JTF.init_lm(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts = _trace()
    j_eng = JServingEngine(jp, jcfg, JServeConfig(**SERVE))
    t_eng = ServingEngine(tp, tcfg, ServeConfig(**SERVE), device="cpu")
    for p in prompts:
        j_eng.submit(p)
        t_eng.submit(p)
    j_out, t_out = j_eng.run(), t_eng.run()
    assert sorted(t_out) == sorted(j_out) == list(range(len(prompts)))
    for rid, p in enumerate(prompts):
        if t_out[rid] == j_out[rid]:
            continue
        i = next(i for i, (a, b) in enumerate(zip(t_out[rid], j_out[rid])) if a != b)
        rkey = R.fold_in(R.PRNGKey(SERVE["seed"]), rid)
        mine, theirs, their_ids = _votes_at(tp, tcfg, p, t_eng._bucket(len(p)), t_out[rid], i,
                                            rkey)
        pytest.fail(
            f"request {rid} diverges at token {i}: port {t_out[rid][i]} (top votes "
            f"{mine.values.tolist()} at {mine.indices.tolist()}), reference {j_out[rid][i]} "
            f"(top votes {theirs.tolist()} at {their_ids.tolist()})"
        )
    m, jm = t_eng.metrics(), j_eng.metrics()
    assert m.prefix_hits >= 2 and m.prefix_partial_hits >= 2 and m.cow_forks >= 1
    for field in ("prefix_hits", "prefix_partial_hits", "cow_forks", "decode_steps"):
        assert getattr(m, field) == getattr(jm, field), field
    # the WTA streams are not the greedy ones
    greedy = ServingEngine(tp, dataclasses.replace(tcfg, wta_head=False), ServeConfig(**SERVE),
                           device="cpu")
    for p in prompts:
        greedy.submit(p)
    assert greedy.run() != t_out
