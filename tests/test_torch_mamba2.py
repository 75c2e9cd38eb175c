"""The port's Mamba-2 block (``repro_torch/models/mamba2.py``) and
mamba2-1.3b (the ``ssm`` family) against ``repro`` on the CPU, at the
smoke config (d 64, d_inner 128, 8 heads of 16, state 16, chunk 8) in
f32, on the reference's init carried across by ``bridge``.

Tolerances, and why:

- ``_causal_conv``: both packages sum the same four f32 products tap by
  tap; XLA may contract a product and a sum into an FMA and its ``silu``
  rounds otherwise, so the outputs agree to ``CONV_ATOL``;
- ``ssd_chunked``: the port contracts each three-operand einsum over the
  state (or the chunk) first and scales after, as XLA does, but the sums
  inside a contraction may run in another order and ``exp`` is torch's (a
  few ulps from XLA's, ROADMAP C).  An output sums 16 state terms and up
  to 8 within-chunk terms of products of three factors, so the error
  budget is a few ulps (2**-23 ≈ 1.2e-7 each) of the largest magnitude:
  ``SSD_RTOL`` = 1e-6, about 8 ulps; measured at most 4.4e-7 over S ≤
  128, with 22–53% of elements bit-equal to the jitted reference;
- the block's outputs (``softplus``, ``silu``, the gated RMS norm and
  f32 matmuls in another order as well) agree to ``BLOCK_ATOL``; a
  chunked prefill, and a decode step that sums the recurrence one token at
  a time, are held to the whole prefill within ``BLOCK_ATOL`` too;
- model losses within ``LOSS_ATOL``, gradients within ``GRAD_ATOL``, in
  the three modes (``analog_stochastic`` projects linearly in this block,
  so the crossbar reads are the same function as ``analog_linear``'s);
  logits within ``LOGIT_ATOL``;
- a whole prefill IS a chunked prefill from a zero carry: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs import skip_shapes as jax_skip_shapes
from repro.core.analog import AnalogConfig as JAnalog
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.models import mamba2 as JM2
from repro.models import transformer as JTF
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config, skip_shapes
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.kernels import ops as KOPS
from repro_torch.models import mamba2 as TM2
from repro_torch.models import transformer as TTF
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainConfig, init_train_state, make_train_step

ARCH = "mamba2-1.3b"
CONV_ATOL = 1e-6
SSD_RTOL = 1e-6
BLOCK_ATOL = 2e-5
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
LOGIT_ATOL = 1e-4
B, S = 2, 24
D, C = 64, 160          # d_model, conv channels (d_inner 128 + 2 * state 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(mode: str = "digital", dtype: str = "float32"):
    jc = dataclasses.replace(jax_smoke(ARCH), dtype=dtype)
    tc = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    if mode != "digital":
        # the reference's analog modes as its TPU runs them; interpret-mode
        # Pallas cannot be rematerialised (ROADMAP C)
        jc = dataclasses.replace(jc, remat_policy="full", analog=JAnalog(
            mode=mode, device=j_calibrate(JDevice(), jc.d_model), use_pallas="on"))
        tc = dataclasses.replace(tc, analog=TAnalog(
            mode=mode, device=t_calibrate(TDevice(), tc.d_model)))
    return jc, tc


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _key_pair(key) -> tuple[int, int]:
    a = np.asarray(jax.random.key_data(key), np.uint32)
    return int(a[0]), int(a[1])


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def block():
    """One mixer's parameters from ``repro``'s init (key 5), in both
    packages, and an input x (B, S, d) drawn with numpy."""
    jc, tc = _cfgs()
    jp = JM2.init_mamba(jax.random.PRNGKey(5), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    x = np.random.default_rng(0).standard_normal((B, S, D)).astype(np.float32)
    return jp, tp, x


# the reference's prefill and decode step, jitted as its engine runs them
j_prefill = jax.jit(JM2.mamba_prefill, static_argnums=2)
j_prefill_chunk = jax.jit(JM2.mamba_prefill_chunk, static_argnums=4)
j_decode_step = jax.jit(JM2.mamba_decode_step, static_argnums=4)


# ---------------------------------------------------------------------------
# The block.
# ---------------------------------------------------------------------------


def test_init_leaves_match_reference():
    """The port's own init has the reference's leaves, shapes and dtypes
    (``a_log``, ``d_skip``, ``dt_bias`` f32 in a bf16 model), and the
    bridge keeps those three f32, bit for bit."""
    jc, tc = _cfgs(dtype="bfloat16")
    jp = JM2.init_mamba(jax.random.PRNGKey(0), jc)
    tp = TM2.init_mamba(torch.Generator().manual_seed(0), tc)
    assert sorted(tp) == sorted(jp)
    for k, v in jax.tree_util.tree_leaves_with_path(jp):
        got = tp[k[0].key] if len(k) == 1 else tp[k[0].key][k[1].key]
        assert tuple(got.shape) == v.shape, k
        assert str(got.dtype).split(".")[-1] == str(v.dtype), k
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]), rtol=1e-6)
    bridged = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tc,
                                device="cpu")
    for k in ("a_log", "d_skip", "dt_bias"):
        assert bridged[k].dtype == torch.float32
        np.testing.assert_array_equal(bridged[k].numpy(), np.asarray(jp[k]))
    assert bridged["in_proj"].dtype == bridged["out_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_matches_reference(block, with_cache):
    jp, tp, _ = block
    rng = np.random.default_rng(1)
    u = rng.standard_normal((B, S, C)).astype(np.float32)
    cache = rng.standard_normal((B, 3, C)).astype(np.float32) if with_cache else None
    want = JM2._causal_conv(jnp.asarray(u), jp["conv_w"], jp["conv_b"],
                            None if cache is None else jnp.asarray(cache))
    got = TM2._causal_conv(_t(u), tp["conv_w"], tp["conv_b"], None if cache is None else _t(cache))
    _close(got.numpy(), want, CONV_ATOL)


def test_causal_conv_zero_cache_is_the_zero_pad(block):
    _, tp, _ = block
    u = _t(np.random.default_rng(2).standard_normal((B, S, C)))
    assert torch.equal(TM2._causal_conv(u, tp["conv_w"], tp["conv_b"]),
                       TM2._causal_conv(u, tp["conv_w"], tp["conv_b"], torch.zeros(B, 3, C)))


def _ssd_inputs(s: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, 8, 16)).astype(np.float32)
    a = -rng.uniform(0.01, 2.0, (B, s, 8)).astype(np.float32)
    bm = rng.standard_normal((B, s, 16)).astype(np.float32)
    cm = rng.standard_normal((B, s, 16)).astype(np.float32)
    return x, a, bm, cm


@pytest.mark.parametrize("s", [3, 8, 13, 24])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(s, with_h0):
    """At S divisible by the chunk of 8 and not, from zero and from an h0:
    outputs and the final state against the reference's (jitted), and
    against the plain sequential recurrence in numpy."""
    x, a, bm, cm = _ssd_inputs(s, s)
    h0 = (np.random.default_rng(99).standard_normal((B, 8, 16, 16)).astype(np.float32)
          if with_h0 else None)
    jy, jh = jax.jit(JM2.ssd_chunked, static_argnums=4)(
        *(jnp.asarray(v) for v in (x, a, bm, cm)), 8, None if h0 is None else jnp.asarray(h0))
    ty, th = TM2.ssd_chunked(*(_t(v) for v in (x, a, bm, cm)), 8,
                             None if h0 is None else _t(h0))
    for got, want in ((ty, jy), (th, jh)):
        want = np.asarray(want)
        _close(got.numpy(), want, SSD_RTOL * np.abs(want).max())
    h = np.zeros((B, 8, 16, 16)) if h0 is None else h0.astype(np.float64)
    ys = []
    for t in range(s):
        h = h * np.exp(a[:, t])[:, :, None, None] + x[:, t, :, :, None] * bm[:, t, None, None, :]
        ys.append(np.einsum("bhpn,bn->bhp", h, cm[:, t]))
    _close(ty.numpy(), np.stack(ys, 1), 1e-4)
    _close(th.numpy(), h, 1e-4)


def test_ssd_chunked_gradient_is_finite():
    """Masking before ``exp``: the upper triangle's positive exponents
    would overflow to inf and give NaN gradients (inf·0)."""
    x, a, bm, cm = (_t(v).requires_grad_(True) for v in _ssd_inputs(16, 5))
    y, h = TM2.ssd_chunked(x, a * 40, bm, cm, 8)
    (y.sum() + h.sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in (x, a, bm, cm))


def test_prefill_matches_reference(block):
    jp, tp, x = block
    jc, tc = _cfgs()
    want = j_prefill(jp, jnp.asarray(x), jc)
    got = TM2.mamba_prefill(tp, _t(x), tc)
    for g, w in zip(got, want):
        _close(g.numpy(), w, BLOCK_ATOL)


def test_prefill_is_a_chunk_from_zero_and_two_chunks_equal_one(block):
    """``mamba_prefill`` IS ``mamba_prefill_chunk`` from a zero carry (bit
    for bit); two chunks carried through (conv tail, state), 16 + 8 tokens
    (the second a whole SSD chunk, the first two), give the whole
    prefill's outputs and final state, in both packages."""
    jp, tp, x = block
    jc, tc = _cfgs()
    whole = TM2.mamba_prefill(tp, _t(x), tc)
    zero = TM2.mamba_prefill_chunk(tp, _t(x), torch.zeros(B, 3, C), torch.zeros(B, 8, 16, 16), tc)
    assert all(torch.equal(a, b) for a, b in zip(whole, zero))
    o1, conv, st = TM2.mamba_prefill_chunk(tp, _t(x[:, :16]), torch.zeros(B, 3, C),
                                           torch.zeros(B, 8, 16, 16), tc)
    o2, conv, st = TM2.mamba_prefill_chunk(tp, _t(x[:, 16:]), conv, st, tc)
    jo1, jconv, jst = j_prefill_chunk(jp, jnp.asarray(x[:, :16]), jnp.zeros((B, 3, C)),
                                      jnp.zeros((B, 8, 16, 16)), jc)
    jo2, jconv, jst = j_prefill_chunk(jp, jnp.asarray(x[:, 16:]), jconv, jst, jc)
    for got in ((torch.cat([o1, o2], 1), conv, st),
                (_t(np.concatenate([jo1, jo2], 1)), _t(jconv), _t(jst))):
        for g, w in zip(got, whole):
            _close(g.numpy(), w.numpy(), BLOCK_ATOL)
    zx = _t(x[:, 16:]) @ tp["in_proj"]
    assert torch.equal(conv, zx[:, -3:, 128:128 + C])


def test_decode_step_after_prefill_equals_longer_prefill(block):
    """Prefill S − 2 tokens, decode the last two one at a time: each step's
    output and state equal the whole prefill's, and the reference's decode
    step from the same state."""
    jp, tp, x = block
    jc, tc = _cfgs()
    whole_out, whole_conv, whole_st = TM2.mamba_prefill(tp, _t(x), tc)
    _, conv, st = TM2.mamba_prefill(tp, _t(x[:, :-2]), tc)
    for t in (S - 2, S - 1):
        jo, jconv, jst = j_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                       jnp.asarray(conv.numpy()), jnp.asarray(st.numpy()), jc)
        o, conv, st = TM2.mamba_decode_step(tp, _t(x[:, t:t + 1]), conv, st, tc)
        _close(o.numpy(), whole_out[:, t:t + 1].numpy(), BLOCK_ATOL)
        for g, w in zip((o, conv, st), (jo, jconv, jst)):
            _close(g.numpy(), w, BLOCK_ATOL)
    np.testing.assert_array_equal(conv.numpy(), whole_conv.numpy())
    _close(st.numpy(), whole_st.numpy(), BLOCK_ATOL)


def test_decode_step_bf16_rounds_like_the_prefill():
    """In bf16 the decode step rounds its conv output through bf16, as the
    prefill's is: decode after a prefill stays within bf16 rounding of the
    whole prefill, and of the reference's step; the state stays f32."""
    jc, tc = _cfgs(dtype="bfloat16")
    jp = JM2.init_mamba(jax.random.PRNGKey(5), jc)
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tc,
                           device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((B, 9, D))
                         .astype(np.float32)).bfloat16()
    whole, _, _ = TM2.mamba_prefill(tp, x, tc)
    _, conv, st = TM2.mamba_prefill(tp, x[:, :-1], tc)
    assert conv.dtype == torch.bfloat16 and st.dtype == torch.float32
    o, _, st1 = TM2.mamba_decode_step(tp, x[:, -1:], conv, st, tc)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jo, _, jst = JM2.mamba_decode_step(
        jp, jx[:, -1:], jnp.asarray(conv.float().numpy(), jnp.bfloat16), jnp.asarray(st.numpy()),
        jc)
    scale = float(whole.float().abs().max())
    _close(o.float().numpy(), whole[:, -1:].float().numpy(), 2 ** -6 * scale)
    _close(o.float().numpy(), np.asarray(jo, np.float32), 2 ** -6 * scale)
    _close(st1.numpy(), np.asarray(jst), 1e-2 * float(np.abs(np.asarray(jst)).max()))


@pytest.mark.parametrize("mode", ["digital", "analog_linear", "analog_stochastic"])
def test_block_apply_matches_reference(block, mode):
    """Digital, and both analog modes: ``in_proj`` and ``out_proj`` read the
    crossbar under ``split(key)`` (linear reads under
    ``analog_stochastic`` too, so that mode equals ``analog_linear``)."""
    jp, tp, x = block
    jc, tc = _cfgs(mode)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JM2.mamba_apply(jp, jnp.asarray(x), jc, key))
    got = TM2.mamba_apply(tp, _t(x), tc, _key_pair(key)).numpy()
    _close(got, want, BLOCK_ATOL)
    if mode != "digital":
        assert np.array_equal(got, TM2.mamba_apply(tp, _t(x), _cfgs("analog_linear")[1],
                                                   _key_pair(key)).numpy())
        digital = TM2.mamba_apply(tp, _t(x), _cfgs()[1], _key_pair(key)).numpy()
        assert np.abs(got - digital).max() > 10 * BLOCK_ATOL


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs()
    jp = jax.jit(JTF.init_lm, static_argnums=1)(jax.random.PRNGKey(1), jc)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_configs_equal_reference():
    for t, j in ((get_config(ARCH), jax_config(ARCH)), (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count() and t.n_units == j.n_units
        assert (t.d_inner, t.ssm_nheads) == (j.d_inner, j.ssm_nheads)
    assert skip_shapes(ARCH) == jax_skip_shapes(ARCH) == {}
    full = get_config(ARCH)
    assert (full.n_layers, full.d_inner, full.ssm_nheads, full.ssm_state) == (48, 4096, 64, 128)


def test_init_tree_matches_reference():
    """Leaves, shapes and dtypes of the port's own bf16 init are the
    reference's, and the full model has ≈ 1.344 B parameters by its
    shapes."""
    cfg = get_smoke_config(ARCH)
    tp = TTF.init_lm(cfg, seed=0, device="cpu")
    jp = jax.eval_shape(lambda: JTF.init_lm(jax.random.PRNGKey(0), jax_smoke(ARCH)))
    flat_t = {"/".join(k): v for k, v in _flatten(tp)}
    flat_j = {"/".join(k): v for k, v in _flatten(jp)}
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == tuple(v.shape), k
        assert str(flat_t[k].dtype).split(".")[-1] == str(v.dtype), k
    full = jax.eval_shape(lambda: JTF.init_lm(jax.random.PRNGKey(0), jax_config(ARCH)))
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(full))
    assert 1.34e9 < n < 1.35e9, n


@pytest.mark.parametrize("mode", ["digital", "analog_linear", "analog_stochastic"])
def test_loss_and_gradients_match_reference(weights, mode):
    """``tests/test_models.py:36`` for the port: the loss and every
    gradient equal the reference's within ``LOSS_ATOL`` / ``GRAD_ATOL``,
    digitally and with both projections of every mixer on the crossbar
    (the reference's interpret-mode kernel, ``use_pallas="on"``)."""
    jc, tc = _cfgs(mode)
    jp, _ = weights
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    key = None if mode == "digital" else jax.random.PRNGKey(2)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, jc, key),
        has_aux=True))(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl, _ = TTF.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc,
                        None if key is None else _key_pair(key))
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_ATOL
    tg = torch.autograd.grad(tl, leaves)
    for a, b in zip(jax.tree.leaves(jg), tg):
        _close(b.numpy(), a, GRAD_ATOL)


def test_analog_stochastic_train_step_reads_both_projections(monkeypatch):
    """One ``analog_stochastic`` step through ``train/step.py``: finite
    loss and a finite non-zero gradient norm; the forward reads the
    crossbar twice a layer (``in_proj``, ``out_proj``), both linear, and
    draws no ``sigmoid_sample``; the backward reads them again, since it
    recomputes every unit (``remat_policy`` "nothing", the default)."""
    _, tc = _cfgs("analog_stochastic")
    calls, sig = [], []
    real = KOPS.crossbar_mac

    def counted(x, w, key, cfg, binarize=False, **kw):
        calls.append((tuple(w.shape), binarize))
        return real(x, w, key, cfg, binarize=binarize, **kw)

    monkeypatch.setattr(KOPS, "crossbar_mac", counted)
    monkeypatch.setattr(KOPS, "sigmoid_sample", lambda *a, **kw: sig.append(1))
    tcfg = TrainConfig(warmup_steps=1, total_steps=4)
    state = init_train_state(0, tc, tcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, tc.vocab, (2, 17))
                            .astype(np.int32))
    state, m = make_train_step(tc, tcfg)(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"]))
    assert tc.remat_policy == "nothing"
    assert calls == [((64, 296), False), ((128, 64), False)] * tc.n_layers * 2
    assert not sig
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0


def test_prefill_decode_match_forward(weights):
    """``tests/test_models.py:54`` for the port: its dense prefill + decode
    steps and its chunked paged prefill (two chunks, the second from the
    first's state, 16 + 4 tokens: the second not a whole SSD chunk) +
    paged decode steps, against its own forward and the reference's."""
    jc, tc = _cfgs()
    jp, tp = weights
    b, s, n_dec = 2, 20, 3
    toks = np.random.default_rng(2).integers(0, tc.vocab, (b, s + n_dec)).astype(np.int32)
    jfull = np.asarray(JTF.lm_forward(jp, jnp.asarray(toks), jc)[0])
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full = TTF.lm_forward(tp, tt.long(), tc)[0].numpy()
        _close(full, jfull, LOGIT_ATOL)
        cache, lp = TTF.lm_prefill(tp, tt[:, :s], tc, 32)
        assert sorted(cache) == ["pos", "ssm_conv", "ssm_state"]
        assert cache["ssm_conv"].shape == (2, 1, b, 3, C)
        assert cache["ssm_state"].shape == (2, 1, b, 8, 16, 16)
        _close(lp.numpy(), full[:, s - 1], LOGIT_ATOL)
        for t in range(n_dec):
            cache, ld = TTF.lm_decode_step(tp, cache, tt[:, s + t], tc)
            _close(ld.numpy(), full[:, s + t], LOGIT_ATOL)
        pool = TTF.init_paged_decode_cache(tc, b, 9, 8, device="cpu")
        table = torch.arange(1, 9, dtype=torch.int32).reshape(b, 4)
        for r in range(b):
            st = TTF.init_prefill_state(tc, "cpu")
            for lo, hi in ((0, 16), (16, s)):
                _, st, lp = TTF.lm_prefill_chunk(tp, tt[r:r + 1, lo:hi], tc, {}, st,
                                                 table[r], lo)
            _close(lp[0].numpy(), full[r, s - 1], LOGIT_ATOL)
            for name in ("ssm_conv", "ssm_state", "pos"):
                pool[name].narrow(0 if name == "pos" else 2, r, 1).copy_(st[name])
        for t in range(n_dec):
            pool, ld = TTF.lm_decode_step(tp, pool, tt[:, s + t], tc, table)
            _close(ld.numpy(), full[:, s + t], LOGIT_ATOL)
        for name in ("ssm_conv", "ssm_state"):
            _close(pool[name].numpy(), cache[name].numpy(), 1e-5)


def test_chunk_prefill_keeps_its_input_state(weights):
    """A chunk returns new state tensors: the state it was given (in the
    engine, a boundary snapshot stashed in the prefix index) is not
    written."""
    _, tc = _cfgs()
    _, tp = weights
    toks = torch.arange(1, 17, dtype=torch.int32)[None]
    row = torch.arange(1, 3, dtype=torch.int32)
    with torch.no_grad():
        _, st, _ = TTF.lm_prefill_chunk(tp, toks[:, :8], tc, {}, TTF.init_prefill_state(tc, "cpu"),
                                        row, 0)
        snap = {n: v.clone() for n, v in st.items()}
        _, st2, _ = TTF.lm_prefill_chunk(tp, toks[:, 8:], tc, {}, st, row, 8)
    assert all(torch.equal(snap[n], st[n]) for n in snap)
    assert not torch.equal(st2["ssm_state"], st["ssm_state"])
    assert int(st2["pos"][0]) == 16


@pytest.mark.parametrize("kv", ["same", "int8"])
def test_caches_hold_exactly_the_reference_leaves(kv):
    """No K/V pool, no scale planes and no ``quant_step`` under int8: a
    mamba2 cache of either layout has the reference's leaves, shapes and
    dtypes (``pos`` and the state)."""
    jc = dataclasses.replace(jax_smoke(ARCH), kv_cache_dtype=kv)
    tc = dataclasses.replace(get_smoke_config(ARCH), kv_cache_dtype=kv)
    for jfn, tfn in (
            (lambda: JTF.init_paged_decode_cache(jc, 3, 7, 8),
             lambda: TTF.init_paged_decode_cache(tc, 3, 7, 8, device="cpu")),
            (lambda: JTF.init_decode_cache(jc, 3, 32),
             lambda: TTF.init_decode_cache(tc, 3, 32, device="cpu"))):
        want = jax.eval_shape(jfn)
        got = tfn()
        assert sorted(got) == sorted(want) == ["pos", "ssm_conv", "ssm_state"]
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
