"""The port's RG-LRU block (``repro_torch/models/rglru.py``) against
``repro/models/rglru.py`` on the CPU, at recurrentgemma-2b's smoke width
(d 64, W 64) in f32, on the reference's own init carried across by
``bridge``.

Tolerances, and why:

- ``_conv``: both packages sum the same four f32 products tap by tap, so
  the results are equal to ``CONV_ATOL`` (one f32 ulp of the largest
  output; XLA may contract a product and a sum into an FMA);
- ``rglru_scan``: the port mirrors ``jax.lax.associative_scan``'s odd/even
  recursion, so the products and sums have the same operands in the same
  order, but ``exp`` and ``sqrt`` are torch's (a few ulps from XLA's on
  this CPU, ROADMAP C), and the reference runs jitted, as its engine
  does (XLA may contract a product and a sum into an FMA): the hidden
  states agree to ``SCAN_RTOL`` relative to their largest magnitude;
- the block's outputs (sigmoid, softplus, tanh ``gelu`` and f32 matmuls
  in another order as well) agree to ``BLOCK_ATOL``;
- a chunked prefill reduces in another order than one whole chunk, and
  the decode step sums the recurrence one step at a time: both are held
  to the whole prefill within ``BLOCK_ATOL`` (the same package on both
  sides);
- ``analog_stochastic`` gates are comparator draws from the same threefry
  uniforms: a draw can differ only where the two packages' sigmoids
  straddle the uniform, so they are compared by agreement fraction
  (``GATE_AGREEMENT``), never bit for bit, and the block's outputs are
  compared only at positions no disagreeing draw reaches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import neurons as JN
from repro.core.analog import AnalogConfig as JAnalog
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.models import rglru as JRG
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import neurons as TN
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.models import rglru as TRG

ARCH = "recurrentgemma-2b"
CONV_ATOL = 1e-6
SCAN_RTOL = 5e-7
BLOCK_ATOL = 2e-5
GATE_AGREEMENT = 0.999
B, S = 2, 24


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
        jc = dataclasses.replace(jc, analog=JAnalog(
            mode=mode, device=j_calibrate(JDevice(), jc.d_model), use_pallas="on"))
        tc = dataclasses.replace(tc, analog=TAnalog(
            mode=mode, device=t_calibrate(TDevice(), tc.d_model)))
    return jc, tc


@pytest.fixture(scope="module")
def block():
    """One block's parameters from ``repro``'s init (key 5), in both
    packages, and an input x (B, S, d) drawn with numpy."""
    jc, tc = _cfgs()
    jp = JRG.init_rglru_block(jax.random.PRNGKey(5), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    x = np.random.default_rng(0).standard_normal((B, S, jc.d_model)).astype(np.float32)
    return jp, tp, x


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


# the reference's prefill and decode step, jitted as its engine runs them
j_prefill = jax.jit(JRG.rglru_prefill, static_argnums=2)
j_prefill_chunk = jax.jit(JRG.rglru_prefill_chunk, static_argnums=4)
j_decode_step = jax.jit(JRG.rglru_decode_step, static_argnums=4)


def test_init_leaves_match_reference():
    """The port's own init has the reference's leaves, shapes and dtypes
    (``ba``, ``bx``, ``lam`` f32 in a bf16 model), and the bridge keeps
    those three f32."""
    jc, tc = _cfgs(dtype="bfloat16")
    jp = JRG.init_rglru_block(jax.random.PRNGKey(0), jc)
    tp = TRG.init_rglru_block(torch.Generator().manual_seed(0), tc)
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(v.dtype), k
    bridged = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tc,
                                device="cpu")
    for k in ("ba", "bx", "lam"):
        assert bridged[k].dtype == torch.float32
        np.testing.assert_array_equal(bridged[k].numpy(), np.asarray(jp[k]))
    assert bridged["wa"].dtype == torch.bfloat16


@pytest.mark.parametrize("with_cache", [False, True])
def test_conv_matches_reference(block, with_cache):
    jp, tp, x = block
    rng = np.random.default_rng(1)
    u = rng.standard_normal((B, S, 64)).astype(np.float32)
    cache = rng.standard_normal((B, 3, 64)).astype(np.float32) if with_cache else None
    want = JRG._conv(jnp.asarray(u), jp["conv_w"], jp["conv_b"],
                     None if cache is None else jnp.asarray(cache))
    got = TRG._conv(_t(u), tp["conv_w"], tp["conv_b"], None if cache is None else _t(cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CONV_ATOL, rtol=0)


def test_conv_zero_cache_is_the_zero_pad(block):
    _, tp, _ = block
    u = _t(np.random.default_rng(2).standard_normal((B, S, 64)))
    assert torch.equal(TRG._conv(u, tp["conv_w"], tp["conv_b"]),
                       TRG._conv(u, tp["conv_w"], tp["conv_b"], torch.zeros(B, 3, 64)))


@pytest.mark.parametrize("s", [1, 7, 24, 33])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_reference(s, with_h0):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((B, s, 64)).astype(np.float32)
    log_a = -rng.uniform(0.01, 3.0, (B, s, 64)).astype(np.float32)
    h0 = rng.standard_normal((B, 64)).astype(np.float32) if with_h0 else None
    want = np.asarray(jax.jit(JRG.rglru_scan)(jnp.asarray(x), jnp.asarray(log_a),
                                              None if h0 is None else jnp.asarray(h0)))
    got = TRG.rglru_scan(_t(x), _t(log_a), None if h0 is None else _t(h0)).numpy()
    np.testing.assert_allclose(got, want, atol=SCAN_RTOL * np.abs(want).max(), rtol=0)
    # the recursion is the sequential recurrence, reordered
    a, h, ref = np.exp(log_a), np.zeros((B, 64)) if h0 is None else h0, []
    for t in range(s):
        h = a[:, t] * h + np.sqrt(np.maximum(1 - a[:, t] ** 2, 1e-12)) * x[:, t]
        ref.append(h)
    np.testing.assert_allclose(got, np.stack(ref, 1), atol=1e-5, rtol=0)


def test_prefill_matches_reference(block):
    jp, tp, x = block
    jc, tc = _cfgs()
    want = j_prefill(jp, jnp.asarray(x), jc)
    got = TRG.rglru_prefill(tp, _t(x), tc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BLOCK_ATOL, rtol=0)


def test_prefill_in_two_chunks_equals_one(block):
    """Two chunks carried through (conv tail, h) give the whole prefill's
    outputs and final state, in both packages."""
    jp, tp, x = block
    jc, tc = _cfgs()
    whole = TRG.rglru_prefill(tp, _t(x), tc)
    o1, conv, h = TRG.rglru_prefill_chunk(tp, _t(x[:, :16]), torch.zeros(B, 3, 64),
                                          torch.zeros(B, 64), tc)
    o2, conv, h = TRG.rglru_prefill_chunk(tp, _t(x[:, 16:]), conv, h, tc)
    jo1, jconv, jh = j_prefill_chunk(jp, jnp.asarray(x[:, :16]), jnp.zeros((B, 3, 64)),
                                     jnp.zeros((B, 64)), jc)
    jo2, jconv, jh = j_prefill_chunk(jp, jnp.asarray(x[:, 16:]), jconv, jh, jc)
    for got in ((torch.cat([o1, o2], 1), conv, h),
                (_t(np.concatenate([jo1, jo2], 1)), _t(jconv), _t(jh))):
        for g, w in zip(got, whole):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BLOCK_ATOL, rtol=0)
    np.testing.assert_array_equal(conv.numpy(), x[:, -3:] @ tp["w_main"].numpy())


def test_decode_step_after_prefill_equals_longer_prefill(block):
    """Prefill S − 2 tokens, decode the last two one at a time: each step's
    output and state equal the whole prefill's, and the reference's decode
    step from the same state."""
    jp, tp, x = block
    jc, tc = _cfgs()
    whole_out, whole_conv, whole_h = TRG.rglru_prefill(tp, _t(x), tc)
    _, conv, h = TRG.rglru_prefill(tp, _t(x[:, :-2]), tc)
    for t in (S - 2, S - 1):
        jo, jconv, jh = j_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                      jnp.asarray(conv.numpy()), jnp.asarray(h.numpy()), jc)
        o, conv, h = TRG.rglru_decode_step(tp, _t(x[:, t:t + 1]), conv, h, tc)
        np.testing.assert_allclose(o.numpy(), whole_out[:, t:t + 1].numpy(), atol=BLOCK_ATOL,
                                   rtol=0)
        for g, w in zip((o, conv, h), (jo, jconv, jh)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BLOCK_ATOL, rtol=0)
    np.testing.assert_array_equal(conv.numpy(), whole_conv.numpy())
    np.testing.assert_allclose(h.numpy(), whole_h.numpy(), atol=BLOCK_ATOL, rtol=0)


def test_decode_step_bf16_rounds_like_the_prefill():
    """In bf16 the decode step rounds its conv output through bf16, as the
    prefill's conv output is: decode after a prefill stays within bf16
    rounding of the whole prefill, and of the reference's step."""
    jc, tc = _cfgs(dtype="bfloat16")
    jp = JRG.init_rglru_block(jax.random.PRNGKey(5), jc)
    tp = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tc,
                           device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((B, 9, 64))
                         .astype(np.float32)).bfloat16()
    whole, _, _ = TRG.rglru_prefill(tp, x, tc)
    _, conv, h = TRG.rglru_prefill(tp, x[:, :-1], tc)
    assert conv.dtype == torch.bfloat16 and h.dtype == torch.float32
    o, _, h1 = TRG.rglru_decode_step(tp, x[:, -1:], conv, h, tc)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    jo, _, jh = JRG.rglru_decode_step(jp, jx[:, -1:], jnp.asarray(conv.float().numpy(),
                                                                   jnp.bfloat16),
                                      jnp.asarray(h.numpy()), jc)
    scale = float(whole.float().abs().max())
    np.testing.assert_allclose(o.float().numpy(), whole[:, -1:].float().numpy(),
                               atol=2 ** -6 * scale, rtol=0)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32),
                               atol=2 ** -6 * scale, rtol=0)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh), atol=1e-2, rtol=0)


def _key_pair(key) -> tuple[int, int]:
    a = np.asarray(jax.random.key_data(key), np.uint32)
    return int(a[0]), int(a[1])


@pytest.mark.parametrize("mode", ["digital", "analog_linear"])
def test_block_apply_matches_reference(block, mode):
    """Digital, and ``analog_linear`` (both input projections through the
    crossbar under ``split(key, 4)[0:2]``): the reference's outputs."""
    jp, tp, x = block
    jc, tc = _cfgs(mode)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JRG.rglru_block_apply(jp, jnp.asarray(x), jc, key))
    got = TRG.rglru_block_apply(tp, _t(x), tc, _key_pair(key)).numpy()
    np.testing.assert_allclose(got, want, atol=BLOCK_ATOL, rtol=0)
    if mode != "digital":
        digital = TRG.rglru_block_apply(tp, _t(x), _cfgs()[1], _key_pair(key)).numpy()
        assert np.abs(got - digital).max() > 10 * BLOCK_ATOL


def test_block_apply_stochastic_gates_match_reference(block):
    """``analog_stochastic``: the gates are comparator draws under
    ``split(key, 4)[2:4]``.  On the same pre-activations the two packages'
    draws agree on at least ``GATE_AGREEMENT`` of the elements, and are
    binary; the block's outputs agree wherever no disagreeing draw
    reaches (a gate at (b, t, c) feeds every later h of row b)."""
    jp, tp, x = block
    jc, tc = _cfgs("analog_stochastic")
    key = jax.random.PRNGKey(3)
    ks = jax.random.split(key, 4)
    z = np.random.default_rng(6).standard_normal((B, S, 64)).astype(np.float32) * 3
    total = agree = 0
    first_diff = np.full(B, S)
    for k in ks[2:]:
        want = np.asarray(JN.sigmoid_neuron_calibrated(k, jnp.asarray(z), beta=jc.analog.beta))
        got = TN.sigmoid_neuron_calibrated(_key_pair(k), _t(z), beta=tc.analog.beta).numpy()
        assert set(np.unique(got)) <= {0.0, 1.0}
        total += got.size
        agree += int((got == want).sum())
    assert agree / total >= GATE_AGREEMENT, (agree, total)
    want = np.asarray(JRG.rglru_block_apply(jp, jnp.asarray(x), jc, key))
    got = TRG.rglru_block_apply(tp, _t(x), tc, _key_pair(key)).numpy()
    close = np.abs(got - want).max(axis=-1) <= BLOCK_ATOL        # (B, S)
    for b in range(B):
        # outputs agree up to the first position a differing draw reaches
        bad = np.flatnonzero(~close[b])
        first_diff[b] = bad[0] if bad.size else S
    assert first_diff.sum() >= 0.9 * B * S, first_diff
    digital = TRG.rglru_block_apply(tp, _t(x), _cfgs()[1]).numpy()
    assert np.abs(got - digital).max() > 10 * BLOCK_ATOL
