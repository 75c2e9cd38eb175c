"""The dense KV layout of the port against ``repro`` on the CPU: the
decode attention over a per-slot window (``attend_one_token``,
``decode_self_attention``, bf16 and int8 caches), the dense cache, the
monolithic prefill, the dense decode step, the slot insert and the
slot-axis contract.

The same numpy inputs go through both packages.  The reference runs this
code on every backend (it reaches no Pallas kernel), so its CPU numbers
are its TPU numbers too.  Tolerances:

- f32 compute over f32 or bf16 operands: both packages round the same
  operands and sum exact products in f32, in another order, so outputs
  agree to a few f32 ulps of the sums (``F32_ATOL``);
- an int8 cache computes in bf16, as the reference does: the query and
  the softmax weights are rounded to bf16 in both, so a weight could
  round the other way only where an ulp of ``exp`` straddles a bf16
  rounding boundary, moving the output by a bf16 ulp of one weight times
  a value (``INT8_ATOL``; equal bits were seen here);
- a bf16 model's layer output is rounded to bf16: two bf16 ulps at the
  outputs' scale (``BF16_ATOL``);
- nearest-rounded int8 codes agree except where ``x / scale · 127`` sits
  within an ulp of a half (``CODE_AGREEMENT``), and their scales exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.launch import specs as JSP
from repro.models import attention as JA
from repro.models import transformer as JTF
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs as SP
from repro_torch.models import attention as TA
from repro_torch.models import get_model_fns
from repro_torch.models import transformer as TTF

F32_ATOL = 2e-5
INT8_ATOL = 1e-2
BF16_ATOL = 2e-2
LOGIT_ATOL = 1e-4
CODE_AGREEMENT = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kv: str = "same", dtype: str = "float32", **kw):
    kw = dict(dtype=dtype, kv_cache_dtype=kv, **kw)
    return (dataclasses.replace(jax_smoke("stablelm-3b"), **kw),
            dataclasses.replace(get_smoke_config("stablelm-3b"), **kw))


def _t(a, dtype=None) -> torch.Tensor:
    """A numpy (or jax) array as a torch CPU tensor; bf16 through f32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _window(rng, b, t, hkv, dh, dtype):
    """Random K/V windows in ``dtype`` (int8: codes and positive scales)."""
    if dtype == "int8":
        codes = rng.integers(-127, 128, (b, t, hkv, dh)).astype(np.int8)
        return codes, rng.uniform(0.5, 2.0, (b, t, hkv)).astype(np.float32)
    x = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    return jnp.asarray(x, dtype), None


@pytest.mark.parametrize("cache,kind,softcap", [
    ("float32", "global", 0.0), ("bfloat16", "global", 0.0), ("bfloat16", "local", 0.0),
    ("float32", "global", 30.0), ("int8", "global", 0.0), ("int8", "local", 0.0),
])
def test_attend_one_token_matches_reference(cache, kind, softcap):
    """GQA (8 query heads on 2 KV heads), positions spread over the window:
    the readout of both packages on the same q and window."""
    jcfg, tcfg = _cfgs(n_heads=8, n_kv_heads=2, d_head=16, attn_softcap=softcap,
                       local_window=5)
    rng = np.random.default_rng(0)
    b, t = 4, 24
    q = rng.standard_normal((b, 1, 8, 16)).astype(np.float32)
    k, ks = _window(rng, b, t, 2, 16, cache)
    v, vs = _window(rng, b, t, 2, 16, cache)
    pos = np.array([0, 5, 17, 23], np.int32)
    want = JA.attend_one_token(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), jcfg, kind,
                               k_scale=None if ks is None else jnp.asarray(ks),
                               v_scale=None if vs is None else jnp.asarray(vs))
    got = TA.attend_one_token(_t(q), _t(k), _t(v), _t(pos), tcfg, kind,
                              k_scale=None if ks is None else _t(ks),
                              v_scale=None if vs is None else _t(vs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 1, 8 * 16)
    atol = INT8_ATOL if cache == "int8" else F32_ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def test_quantize_kv_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 4, 16)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: scale 1e-6, codes 0
    jq, js = JA.quantize_kv(jnp.asarray(x))
    tq, ts = TA.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq.numpy() == np.asarray(jq)).mean() >= CODE_AGREEMENT
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1


@pytest.fixture(scope="module")
def bridged():
    """f32 and bf16 smoke weights from ``repro``'s init, carried across."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(dtype=dtype)
        jp = JTF.init_lm(jax.random.PRNGKey(1), jcfg)
        tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg,
                               device="cpu")
        out[dtype] = (jp, tp)
    return out


@pytest.mark.parametrize("kv,dtype", [("same", "bfloat16"), ("int8", "bfloat16"),
                                      ("same", "float32")])
def test_decode_self_attention_matches_reference(bridged, kv, dtype):
    """Unit 0's first attention layer on a cache holding rows already: the
    written row at each slot's ``pos`` (an idle slot's past the window,
    clamped to its last row as the reference's slice update clamps) and
    the layer's output."""
    jcfg, tcfg = _cfgs(kv, dtype)
    jp, tp = bridged[dtype]
    rng = np.random.default_rng(2)
    b, smax, h, dh = 3, 16, tcfg.n_kv_heads, tcfg.head_dim
    x = rng.standard_normal((b, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([0, 9, smax + 3], np.int32)
    int8 = kv == "int8"
    k, ks = _window(rng, b, smax, h, dh, "int8" if int8 else dtype)
    v, vs = _window(rng, b, smax, h, dh, "int8" if int8 else dtype)
    jsub = jax.tree.map(lambda a: a[0], jp["units"]["l0"]["attn"])
    tsub = {n: w[0] for n, w in tp["units"]["l0"]["attn"].items()}
    jx = jnp.asarray(x, jcfg.dtype)
    res = JA.decode_self_attention(jsub, jx, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                   jcfg, k_scale=None if ks is None else jnp.asarray(ks),
                                   v_scale=None if vs is None else jnp.asarray(vs))
    tk, tv = _t(k), _t(v)
    tks = None if ks is None else _t(ks)
    tvs = None if vs is None else _t(vs)
    got = TA.decode_self_attention(tsub, _t(np.asarray(jx)), tk, tv, _t(pos), tcfg,
                                   k_scale=tks, v_scale=tvs)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(_np(got), np.asarray(res[0], np.float32), atol=atol, rtol=0)
    rows = np.minimum(pos, smax - 1)
    for name, t_buf, j_buf in (("k", tk, res[1]), ("v", tv, res[2])):
        jb = np.asarray(j_buf, np.float32)
        tb = _np(t_buf).astype(np.float32)
        untouched = np.ones(smax, bool)
        for s, r in enumerate(rows):
            mask = untouched.copy()
            mask[r] = False
            np.testing.assert_array_equal(tb[s, mask], jb[s, mask], err_msg=name)
            if int8:
                assert np.abs(tb[s, r] - jb[s, r]).max() <= 1, name
            else:
                np.testing.assert_allclose(tb[s, r], jb[s, r], atol=BF16_ATOL if dtype != "float32"
                                           else F32_ATOL, rtol=0, err_msg=name)
    if int8:
        for t_sc, j_sc in ((tks, res[3]), (tvs, res[4])):
            np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc), rtol=1e-2)


def test_init_decode_cache_matches_reference():
    for kv in ("same", "int8"):
        jcfg, tcfg = _cfgs(kv, "bfloat16")
        want = JSP.init_decode_cache(jcfg, 3, 40)
        got = SP.init_decode_cache(tcfg, 3, 40, device="cpu")
        assert set(got) == set(want)
        for name, leaf in want.items():
            assert tuple(got[name].shape) == leaf.shape, name
            np.testing.assert_array_equal(_np(got[name]), np.asarray(leaf, np.float32), name)
        assert got["k"].dtype == (torch.int8 if kv == "int8" else torch.bfloat16)


@pytest.mark.parametrize("kv", ["same", "int8"])
def test_prefill_and_dense_decode_steps_match_reference(bridged, kv):
    """``lm_prefill`` of two left-padded prompts into a 32-wide cache, then
    four dense decode steps each package on its own cache, at f32: logits
    within ``LOGIT_ATOL``, the greedy tokens equal, caches agree (int8:
    codes within one step, ``CODE_AGREEMENT`` equal), ``pos`` equal."""
    jcfg, tcfg = _cfgs(kv)
    jp, tp = bridged["float32"]
    rng = np.random.default_rng(3)
    toks = rng.integers(1, tcfg.vocab, (2, 12)).astype(np.int32)
    toks[1, :5] = 0
    jcache, jlog = JTF.lm_prefill(jp, jnp.asarray(toks), jcfg, 32)
    tcache, tlog = TTF.lm_prefill(tp, _t(toks), tcfg, 32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)

    def caches_agree():
        assert set(tcache) == set(jcache)
        for name in tcache:
            a, b = _np(tcache[name]), np.asarray(jcache[name])
            if name == "pos":
                np.testing.assert_array_equal(a, b)
            elif a.dtype == np.int8:
                assert (a == b).mean() >= CODE_AGREEMENT, name
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
            else:
                np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=1e-5, err_msg=name)

    caches_agree()
    tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
    for _ in range(4):
        jcache, jlog = JTF.lm_decode_step(jp, jcache, jnp.asarray(tok), jcfg)
        out = TTF.lm_decode_step(tp, tcache, _t(tok), tcfg)
        assert out[0] is tcache   # updated in place
        tlog = out[1]
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0)
        caches_agree()
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)
        assert np.array_equal(tok, tlog.argmax(-1).numpy())


def test_prefill_into_a_given_cache_overwrites_it_whole(bridged):
    """The static engine's waves: a prefill into a cache that held a longer
    prompt leaves exactly what a prefill into a fresh cache does."""
    _, tcfg = _cfgs("int8")
    _, tp = bridged["float32"]
    rng = np.random.default_rng(4)
    old = _t(rng.integers(1, tcfg.vocab, (2, 20)).astype(np.int32))
    new = _t(rng.integers(1, tcfg.vocab, (2, 6)).astype(np.int32))
    cache, _ = TTF.lm_prefill(tp, old, tcfg, 32)
    leaves = {n: t.data_ptr() for n, t in cache.items()}
    got, glog = TTF.lm_prefill(tp, new, tcfg, 32, cache=cache)
    want, wlog = TTF.lm_prefill(tp, new, tcfg, 32)
    assert got is cache and {n: t.data_ptr() for n, t in got.items()} == leaves
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)
    torch.testing.assert_close(glog, wlog, rtol=0, atol=0)


def test_model_fns_prefill_and_decode_step():
    """``get_model_fns`` hands out the dense prefill (a batch dict) and the
    decode step, as the reference's registry does."""
    _, tcfg = _cfgs()
    fns = get_model_fns(tcfg)
    params = fns.init(0, tcfg, "cpu")
    cache, logits = fns.prefill(params, {"tokens": torch.tensor([[3, 4, 5]])}, tcfg, 16)
    assert tuple(logits.shape) == (1, tcfg.vocab) and int(cache["pos"][0]) == 3
    cache, logits = fns.decode_step(params, cache, torch.tensor([7], dtype=torch.int32), tcfg)
    assert int(cache["pos"][0]) == 4
    assert get_model_fns(get_smoke_config("fcnn-mnist")).prefill is None


@pytest.mark.parametrize("kv", ["same", "int8"])
def test_cache_insert_into_each_slot(kv):
    """``make_cache_insert`` copies a one-slot cache into slot ``s`` of a
    batch cache, in place, touching no other slot, as the reference's."""
    jcfg, tcfg = _cfgs(kv)
    b, max_len = 3, 16
    rng = np.random.default_rng(5)
    tbatch = SP.init_decode_cache(tcfg, b, max_len, device="cpu")
    jbatch = JSP.init_decode_cache(jcfg, b, max_len)
    ptrs = {n: t.data_ptr() for n, t in tbatch.items()}
    insert, jinsert = SP.make_cache_insert(tcfg), jax.jit(JSP.make_cache_insert(jcfg))
    for slot in (2, 0, 1):
        one = {}
        for name, leaf in jbatch.items():
            shape = list(leaf.shape)
            shape[SP.cache_batch_axis(tcfg, name)] = 1
            if leaf.dtype == jnp.int8:
                one[name] = rng.integers(-127, 128, shape).astype(np.int8)
            elif name == "pos":
                one[name] = rng.integers(0, max_len, shape).astype(np.int32)
            else:
                one[name] = rng.standard_normal(shape).astype(np.float32)
        jbatch = jinsert(jbatch, {n: jnp.asarray(a) for n, a in one.items()}, slot)
        assert insert(tbatch, {n: _t(a) for n, a in one.items()}, slot) is tbatch
        for name in tbatch:
            np.testing.assert_array_equal(_np(tbatch[name]), np.asarray(jbatch[name]), name)
    assert {n: t.data_ptr() for n, t in tbatch.items()} == ptrs


def test_decode_cache_batch_axis_contract():
    """``tests/test_specs.py::test_decode_cache_batch_axis_contract`` for
    stablelm-3b (the ported family): every dense cache leaf carries the
    slot axis where ``cache_batch_axis`` says it is, in the reference's
    layout (nu, n_attn, B, max_len, Hkv, Dh), int8 scales included."""
    for kv in ("same", "int8"):
        jcfg, tcfg = _cfgs(kv, "bfloat16")
        cache = SP.init_decode_cache(tcfg, 5, 24, device="cpu")
        want = JSP.init_decode_cache(jcfg, 5, 24)
        assert cache["pos"].shape == (5,) and cache["pos"].dtype == torch.int32
        for name, leaf in cache.items():
            ax = SP.cache_batch_axis(tcfg, name)
            assert leaf.shape[ax] == 5, (name, leaf.shape, ax)
            assert ax == JSP.cache_batch_axis(jcfg, name)
            assert tuple(leaf.shape) == want[name].shape
        n_attn = len(tcfg.layer_pattern)
        assert tuple(cache["k"].shape) == (tcfg.n_units, n_attn, 5, 24, tcfg.n_kv_heads,
                                           tcfg.head_dim)
    with pytest.raises(KeyError):
        SP.cache_batch_axis(tcfg, "k_pages")
