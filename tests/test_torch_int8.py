"""The port's int8 paged KV path against the JAX reference.

Identical pools go to both packages through ``repro_torch.bridge`` and the
same uint32 seeds are handed to both.  For the same f32 input the codes
are bit-exact (``test_torch_stochastic.py``); across the packages the K/V
rows themselves differ at f32 rounding (matmul summation order, ~1e-7
relative), so a value sitting within that distance of a rounding draw can
take the neighbouring code.  Tolerances, and why:

- codes written by a layer: at least 99.9% equal, and any difference is one
  level (expected flip rate ~1e-5 per element);
- scale planes: 1e-6 relative (the row max carries the rows' rounding)
  where a layer gets identical inputs; 5e-6 relative where the K/V rows
  went through the whole smoke model (``MODEL_SCALE_RTOL``).  That budget:
  the two packages compute the same function, and their K rows before
  quantization differ by rounding alone, at the ulp level and growing
  with depth.  ``tests/torch_cpu_rounding.py`` compares them unit by unit
  on this test's first chunk (torch 2.13.0+cpu): unit 0's rows are 37%
  bit-equal, worst |Δk| 3.0e-7 of the row's max |k| and row max 2.8e-7
  apart (about two f32 ulps: the matmuls' summation order, and the CPU
  build's f32 ``rsqrt``, which disagrees with jax's on 29% of inputs);
  unit 1's 4% bit-equal, 2.0e-6 and 1.09e-6.  The latter is the worst
  relative difference of a first-chunk scale, as the quantizers are
  bit-exact on equal rows.  With the port's ``rsqrt`` replaced by
  ``1 / sqrt`` (the same model under other rounding) the scales' worst
  is 6.5e-7.  5e-6 is 1.09e-6 with a margin of 4.6x.
  The codes' agreement and their one-level bound are what catch a wrong
  rounding, and they keep their bounds;
- prefill layer outputs and logits: 1e-4 absolute (observed ~1e-6 with no
  flipped code);
- decode: the reference's CPU path (``attend_one_token``) rounds q and the
  softmax weights to bf16 for int8 pools, where its TPU kernel and the
  port compute in f32; so decode outputs and logits are held to 2e-2
  absolute, a few bf16 ulps at magnitudes ~1-4, and the codes a decode
  step writes in the second unit (whose input carries that rounding) to
  98% agreement and scales to 1e-2 relative (observed 99.3% and 2.9e-3);
- engine: greedy streams byte-identical, with every emitted token's
  top-1/top-2 margin in the engine's own logits above 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as JATT
from repro.models import transformer as JTF
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import paged_cache_from_numpy, params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs as SP
from repro_torch.models import attention as TATT
from repro_torch.models import transformer as TTF
from repro_torch.serving import RequestState, ServeConfig, ServingEngine

CODE_AGREEMENT = 0.999
SCALE_RTOL = 1e-6
MODEL_SCALE_RTOL = 5e-6
OUT_ATOL = 1e-4
DECODE_ATOL = 2e-2
DECODE_CODE_AGREEMENT = 0.98
DECODE_SCALE_RTOL = 1e-2
MIN_MARGIN = 1e-3


def _bridged():
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), dtype="float32", kv_cache_dtype="int8")
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32",
                               kv_cache_dtype="int8")
    jp = JTF.init_lm(jax.random.PRNGKey(2), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _random_int8_pool(rng, n_pages, bs, hkv, dh):
    return {
        "k_pages": rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8),
        "v_pages": rng.integers(-127, 128, (n_pages, bs, hkv, dh)).astype(np.int8),
        "k_scale_pages": (rng.random((n_pages, bs, hkv)) + 0.5).astype(np.float32),
        "v_scale_pages": (rng.random((n_pages, bs, hkv)) + 0.5).astype(np.float32),
    }


def _assert_pools_agree(t_pool: dict, j_pool: dict, agreement=CODE_AGREEMENT,
                        scale_rtol=SCALE_RTOL):
    for name in ("k_pages", "v_pages"):
        got, want = t_pool[name].numpy().astype(np.int32), np.asarray(j_pool[name]).astype(np.int32)
        assert (got == want).mean() >= agreement, name
        assert np.abs(got - want).max() <= 1, name
    for name in ("k_scale_pages", "v_scale_pages"):
        np.testing.assert_allclose(t_pool[name].numpy(), np.asarray(j_pool[name]), rtol=scale_rtol)


def _unit0_attn(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["units"]["l0"]["attn"]),
            TTF.unit_params(tp["units"], 0)["l0"]["attn"])


def test_decode_layer_int8_matches_reference():
    jcfg, jp, tcfg, tp = _bridged()
    ja, ta = _unit0_attn(jp, tp)
    rng = np.random.default_rng(0)
    pool = _random_int8_pool(rng, 9, 8, tcfg.n_kv_heads, tcfg.head_dim)
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    table = np.asarray([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    pos = np.asarray([20, 8, 0], np.int32)   # mid-block, block start, first token
    for seed in (17, 2**32 - 1):
        out_j, *j_pool = JATT.paged_decode_self_attention(
            ja, jnp.asarray(x), *[jnp.asarray(pool[n]) for n in ("k_pages", "v_pages")],
            jnp.asarray(table), jnp.asarray(pos), jcfg,
            k_scale_pages=jnp.asarray(pool["k_scale_pages"]),
            v_scale_pages=jnp.asarray(pool["v_scale_pages"]), quant_seed=jnp.uint32(seed),
        )
        t_pool = paged_cache_from_numpy(pool, tcfg, device="cpu")
        out_t = TATT.paged_decode_self_attention(
            ta, torch.from_numpy(x), t_pool["k_pages"], t_pool["v_pages"],
            torch.from_numpy(table), torch.from_numpy(pos), tcfg,
            k_scale_pages=t_pool["k_scale_pages"], v_scale_pages=t_pool["v_scale_pages"],
            quant_seed=torch.tensor(seed),
        )
        _assert_pools_agree(t_pool, dict(zip(pool, j_pool)))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=DECODE_ATOL)
        # the rows at pos really were written: slot 1 writes row 0 of page 5
        assert (t_pool["k_pages"][5, 0].numpy() != pool["k_pages"][5, 0]).any()


@pytest.mark.parametrize("q0,c", [(0, 16), (16, 13)])
def test_prefill_layer_int8_matches_reference(q0, c):
    """A whole-block chunk and an unaligned suffix chunk over three pages,
    each block under its own seed (one near 2**32)."""
    jcfg, jp, tcfg, tp = _bridged()
    ja, ta = _unit0_attn(jp, tp)
    rng = np.random.default_rng(1)
    bs = 8
    pool = _random_int8_pool(rng, 7, bs, tcfg.n_kv_heads, tcfg.head_dim)
    x = rng.standard_normal((1, c, tcfg.d_model)).astype(np.float32)
    row = np.asarray([5, 2, 6, 3, 1], np.int32)
    nbc = -(-c // bs)
    seeds = np.asarray([2**32 - 1, 31337, 2**31][:nbc], np.uint32)
    out_j, *j_pool = JATT.paged_prefill_self_attention(
        ja, jnp.asarray(x), jnp.asarray(pool["k_pages"]), jnp.asarray(pool["v_pages"]),
        jnp.asarray(row), jnp.asarray(q0, jnp.int32), 40, jcfg,
        k_scale_pages=jnp.asarray(pool["k_scale_pages"]),
        v_scale_pages=jnp.asarray(pool["v_scale_pages"]), quant_seeds=jnp.asarray(seeds),
    )
    t_pool = paged_cache_from_numpy(pool, tcfg, device="cpu")
    out_t = TATT.paged_prefill_self_attention(
        ta, torch.from_numpy(x), t_pool["k_pages"], t_pool["v_pages"],
        torch.from_numpy(row), q0, tcfg,
        k_scale_pages=t_pool["k_scale_pages"], v_scale_pages=t_pool["v_scale_pages"],
        quant_seeds=torch.from_numpy(seeds.astype(np.int64)),
    )
    _assert_pools_agree(t_pool, dict(zip(pool, j_pool)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=OUT_ATOL)


def test_bridge_carries_an_int8_paged_cache():
    jcfg, _, tcfg, _ = _bridged()
    jc = JTF.init_paged_decode_cache(jcfg, 3, 6, 8)
    jc = dict(jc, quant_step=jnp.asarray(41, jnp.int32))
    tc = paged_cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    native = TTF.init_paged_decode_cache(tcfg, 3, 6, 8, device="cpu")
    assert sorted(tc) == sorted(native)
    for name, leaf in native.items():
        assert tc[name].dtype == leaf.dtype and tc[name].shape == leaf.shape, name
        if name != "quant_step":
            assert torch.equal(tc[name], leaf), name
    assert int(tc["quant_step"]) == 41


def test_int8_prefill_chunks_and_decode_steps_match_reference():
    """The slice as a whole: a two-chunk int8 prefill and three decode steps
    through both models from the same pool, seeds and quant_step; the
    prefill's scale planes are held to ``MODEL_SCALE_RTOL`` (the budget in
    the module docstring)."""
    jcfg, jp, tcfg, tp = _bridged()
    bs, n_pages = 8, 12
    toks = np.random.default_rng(3).integers(0, 256, (1, 28)).astype(np.int32)
    row = np.asarray([3, 7, 1, 9], np.int32)
    seeds = np.asarray([2**32 - 3, 5, 2**31 + 1, 99], np.uint32)
    jc = dict(JTF.init_paged_decode_cache(jcfg, 2, n_pages, bs),
              quant_step=jnp.asarray(2**31 - 2, jnp.int32))
    tc = paged_cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    jpool = {k: jc[k] for k in JTF.PAGE_POOL_LEAVES}
    jst, tst = JTF.init_prefill_state(jcfg), TTF.init_prefill_state(tcfg, "cpu")
    for lo, hi in [(0, 16), (16, 28)]:
        sd = seeds[lo // bs : -(-hi // bs)]
        jpool, jst, jl = JTF.lm_prefill_chunk(
            jp, jnp.asarray(toks[:, lo:hi]), jcfg, jpool, jst, jnp.asarray(row),
            jnp.asarray(lo, jnp.int32), 32, jnp.asarray(sd),
        )
        _, tst, tl = TTF.lm_prefill_chunk(
            tp, torch.from_numpy(toks[:, lo:hi]), tcfg, tc, tst, torch.from_numpy(row), lo,
            torch.from_numpy(sd.astype(np.int64)),
        )
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=OUT_ATOL)
    _assert_pools_agree(tc, jpool, scale_rtol=MODEL_SCALE_RTOL)
    table = np.asarray([[3, 7, 1, 9], [0, 0, 0, 0]], np.int32)
    jcache = dict(jc, **jpool, pos=jnp.asarray([28, 5], jnp.int32))
    tc["pos"] = torch.tensor([28, 5], dtype=torch.int32)
    tok = np.asarray([5, 9], np.int32)
    for _ in range(3):
        jcache, jl = JTF.lm_decode_step(jp, jcache, jnp.asarray(tok), jcfg, jnp.asarray(table))
        tc, tl = TTF.lm_decode_step(tp, tc, torch.from_numpy(tok), tcfg, torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=DECODE_ATOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    # unit 0's decode rows come straight from the embeddings: tight; later
    # units see the reference's bf16 decode attention in their inputs
    _assert_pools_agree({k: tc[k][0] for k in JTF.PAGE_POOL_LEAVES},
                        {k: jcache[k][0] for k in JTF.PAGE_POOL_LEAVES})
    _assert_pools_agree(tc, jcache, DECODE_CODE_AGREEMENT, DECODE_SCALE_RTOL)
    # the int32 counter wraps in both; seeds read it as uint32
    assert int(tc["quant_step"]) == int(jcache["quant_step"]) == 2**31 + 1 - 2**32


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

SERVE = dict(
    max_batch=4, max_new_tokens=6, max_len=64, kv_block_size=8,
    prefill_chunk=16, prefill_buckets=(12, 16, 32, 36, 48),
)


def _trace():
    """Cold prompts, same-tick full hits (one forking an unaligned boundary
    block), partial hits that prefill only their suffix, and queued
    unrelated prompts (the trace of ``test_torch_engine.py``)."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, 24).tolist()
    y = rng.integers(0, 256, 12).tolist()
    x = rng.integers(0, 256, 32).tolist()
    a = prefix + rng.integers(0, 256, 12).tolist()
    return [
        y, y, x, a,
        prefix + rng.integers(0, 256, 12).tolist(),
        x,
        rng.integers(0, 256, 5).tolist(),
        prefix + rng.integers(0, 256, 12).tolist(),
        rng.integers(0, 256, 40).tolist(),
    ]


def _record_margins(eng, monkeypatch) -> list:
    """Every emitted token's top-1/top-2 margin in the logits the engine
    itself sampled it from (prefill, prefix-hit payload or decode step)."""
    margins, last = [], {}
    sample = SP.sample_tokens

    def sample_and_keep(cfg, logits, *args, **kw):
        last["logits"] = logits
        return sample(cfg, logits, *args, **kw)

    record = eng.sched.record_token

    def record_and_check(req, t, *args, **kw):
        lg = last["logits"]
        row = lg[0] if lg.shape[0] == 1 else lg[req.slot]
        top2 = torch.topk(row, 2).values
        assert int(torch.argmax(row)) == t
        margins.append(float(top2[0] - top2[1]))
        return record(req, t, *args, **kw)

    monkeypatch.setattr(SP, "sample_tokens", sample_and_keep)
    monkeypatch.setattr(eng.sched, "record_token", record_and_check)
    return margins


def test_int8_engine_streams_byte_identical_to_reference(monkeypatch):
    jcfg, jp, tcfg, tp = _bridged()
    prompts = _trace()
    j_eng = JServingEngine(jp, jcfg, JServeConfig(**SERVE))
    t_eng = ServingEngine(tp, tcfg, ServeConfig(**SERVE), device="cpu")
    margins = _record_margins(t_eng, monkeypatch)
    for p in prompts:
        j_eng.submit(p)
        t_eng.submit(p)
    j_out, t_out = j_eng.run(), t_eng.run()
    assert t_out == j_out
    assert sorted(t_out) == list(range(len(prompts)))
    m, jm = t_eng.metrics(), j_eng.metrics()
    assert m.prefix_hits >= 2 and m.prefix_partial_hits >= 2 and m.cow_forks >= 1
    assert m.evictions == {"length": len(prompts)}
    for field in ("prefix_hits", "prefix_partial_hits", "cow_forks",
                  "prefill_tokens", "prefill_tokens_saved", "decode_steps"):
        assert getattr(m, field) == getattr(jm, field), field
    assert len(margins) == sum(len(o) for o in t_out.values())
    assert min(margins) > MIN_MARGIN
    assert t_eng._cache["k_pages"].dtype == torch.int8
    assert int(t_eng._cache["quant_step"]) == m.decode_steps


def test_int8_pool_doubles_admission_capacity():
    """At equal num_kv_blocks (a native-dtype memory budget) an int8 pool
    holds 2·num_kv_blocks − 1 pages, so admission takes about twice the
    requests (``tests/test_serving.py``'s capacity contract)."""
    cfg = get_smoke_config("stablelm-3b")
    icfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params = TTF.init_lm(cfg, device="cpu")
    sc = ServeConfig(max_batch=8, max_new_tokens=8, max_len=64, kv_block_size=8,
                     num_kv_blocks=5, enable_prefix_sharing=False)
    assert sc.pool_blocks("int8") == 2 * 5 - 1 and sc.pool_blocks() == 5
    assert ServeConfig(max_batch=2, max_len=64, kv_block_size=8).pool_blocks("int8") == 2 * 8 + 1

    def admitted(mcfg):
        eng = ServingEngine(params, mcfg, sc, device="cpu")
        for _ in range(8):
            eng.submit([1, 2, 3], 8)  # 2 blocks each
        eng.tick()
        return sum(1 for r in eng.sched.all_requests() if r.state is not RequestState.QUEUED)

    assert admitted(cfg) == 2 and admitted(icfg) == 4  # capacity 4 vs 8 blocks
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        sc.validate("fp8")


def test_page_copy_copies_scale_planes():
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), kv_cache_dtype="int8")
    cache = TTF.init_paged_decode_cache(cfg, 2, 4, 8, device="cpu")
    for i, name in enumerate(SP.PAGE_POOL_LEAVES):
        cache[name][:, :, 1] = i + 2
    SP.make_page_copy(cfg)(cache, 1, 3)
    for i, name in enumerate(SP.PAGE_POOL_LEAVES):
        assert (cache[name][:, :, 3] == i + 2).all(), name


# ---------------------------------------------------------------------------
# The fused write's plain version against the composition it replaces.
# ---------------------------------------------------------------------------

from repro_torch.kernels import ops as TOPS  # noqa: E402
from repro_torch.kernels import ref as TREF  # noqa: E402


def _old_composition(k, v, pools, seeds, *, table=None, pos=None, table_row=None, b0=0):
    """The int8 write as the port did it before the fused kernel: the pair
    quantizer, then four scatters (``paged_write`` per decode slot,
    ``paged_write_chunk`` of the zero-padded blocks per prefill chunk)."""
    kp, vp, ks_p, vs_p = pools
    if table is not None:
        k8, ks, v8, vs = TOPS.quantize_kv_pair_int8(k, v, seeds)
        for pages, new in ((ks_p, ks), (vs_p, vs), (kp, k8), (vp, v8)):
            TREF.paged_write(pages, new, table, pos)
        return
    bs = kp.shape[1]
    kb, vb = TREF.chunk_to_blocks(k, bs), TREF.chunk_to_blocks(v, bs)
    k8, ks, v8, vs = TOPS.quantize_kv_pair_int8(kb, vb, seeds)
    for pages, new in ((ks_p, ks), (vs_p, vs), (kp, k8), (vp, v8)):
        TREF.paged_write_chunk(pages, new, table_row, b0)


def _pools(seed, n_pages, bs, hkv, dh):
    p = _random_int8_pool(np.random.default_rng(seed), n_pages, bs, hkv, dh)
    return [torch.from_numpy(p[n]) for n in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")]


def _assert_same_outside_trash(got, want):
    """Bit for bit on every page but the trash page 0, which several
    evicted slots may write at once."""
    for g, w in zip(got, want):
        assert torch.equal(g[1:], w[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_write_plain_version_equals_old_composition_decode(dtype):
    """Decode: slot 1's current block is unassigned (−1 → trash page 0),
    slot 2's position is past its table (clamped into the last block),
    slot 3 writes row 0 of a block, one seed near 2**32."""
    rng = np.random.default_rng(8)
    bs, hkv, dh, n_pages = 8, 4, 24, 20
    table = torch.from_numpy((rng.permutation(n_pages - 1)[:16] + 1).reshape(4, 4).astype(np.int32))
    table[1, 1] = -1
    pos = torch.tensor([5, 12, 200, 24], dtype=torch.int32)
    k = torch.from_numpy(rng.standard_normal((4, 1, hkv, dh)).astype(np.float32) * 3).to(dtype)
    v = torch.from_numpy(rng.standard_normal((4, 1, hkv, dh)).astype(np.float32)).to(dtype)
    seed = torch.tensor(2**32 - 5)
    got, want = _pools(1, n_pages, bs, hkv, dh), _pools(1, n_pages, bs, hkv, dh)
    TOPS.write_kv_int8(k, v, *got, seed, table=table, pos=pos)
    _old_composition(k, v, want, seed, table=table, pos=pos)
    _assert_same_outside_trash(got, want)
    # the rows landed where the table says: slot 2 in its last block, row 200 % 8
    assert not torch.equal(got[0][table[2, 3]], _pools(1, n_pages, bs, hkv, dh)[0][table[2, 3]])


@pytest.mark.parametrize("c,b0", [(13, 0), (8, 1), (21, 2), (1, 3)])
def test_fused_write_plain_version_equals_old_composition_chunk(c, b0):
    """Prefill chunk: c rows from block b0, c not a multiple of bs (bar
    one case), one seed per block; padding rows get scale 1e-6 and code
    0 in the chunk's own last page."""
    rng = np.random.default_rng(c)
    bs, hkv, dh, n_pages = 8, 4, 24, 20
    row = torch.from_numpy((rng.permutation(n_pages - 1)[:6] + 1).astype(np.int32))
    k = torch.from_numpy(rng.standard_normal((1, c, hkv, dh)).astype(np.float32) * 2)
    v = torch.from_numpy(rng.standard_normal((1, c, hkv, dh)).astype(np.float32))
    nbc = -(-c // bs)
    seeds = torch.tensor([2**32 - 1, 77, 2**31, 5][:nbc], dtype=torch.int64)
    got, want = _pools(2, n_pages, bs, hkv, dh), _pools(2, n_pages, bs, hkv, dh)
    TOPS.write_kv_int8(k, v, *got, seeds, table_row=row, b0=b0)
    _old_composition(k, v, want, seeds, table_row=row, b0=b0)
    _assert_same_outside_trash(got, want)
    last = int(row[b0 + nbc - 1])
    tail = c - (nbc - 1) * bs
    if tail < bs:
        assert bool((got[2][last, tail:] == 1e-6).all()) and not got[0][last, tail:].any()
