"""The port's encoder-decoder (``repro_torch/models/encdec.py``,
whisper-small, the ``encdec`` family) against ``repro`` on the CPU, at the
smoke config (2 + 2 layers, d 64, 4 heads of 16, 16 frames) in f32, on
the reference's init (key 0) carried across by ``bridge``.

Tolerances, and why:

- ``sinusoid_pos``: torch's CPU ``pow`` may round an angle an ulp away
  from XLA's, and ``sin`` / ``cos`` move by at most that much; each value
  is held to one f32 ulp of the largest angle plus one of 1
  (``_sinusoid_atol``);
- the encoder, the decoder and the cross-attention sum the same f32
  products in another order (a few ulps of their sums): ``ACT_ATOL``;
- losses within ``LOSS_ATOL`` and gradients within ``GRAD_ATOL``, in the
  three modes: the crossbar reads are the reference's interpret-mode
  kernel (``use_pallas="on"``) against the port's plain version, on the
  same threefry draws;
- prefill and decode logits and cache leaves within ``LOGIT_ATOL``; the
  port's own prefill + decode against its ``decode_train`` too (the
  decode readout sums in another order than ``attend_full``).

The reference wraps its scan bodies in ``jax.checkpoint`` whatever
``remat_policy`` says (the port checkpoints each layer so too), and
interpret-mode Pallas cannot be rematerialised
(ROADMAP C): its analog gradients run here with ``jax.checkpoint``
patched to the identity for that call alone.  On the digital gradients
the patch moves nothing by more than f32 rounding (XLA fuses the
recomputed forward otherwise): ``REMAT_ATOL``, a hundredth of
``GRAD_ATOL``.

The dense serve step's streams (``specs.make_serve_step`` over a 3-slot
cache filled by ``make_cache_insert``) are held to the reference's token
for token, greedy and WTA, on std-1 frames and with the decoder's three
block outputs (``self_attn.wo``, ``cross_attn.wo``, ``ffn.w_down``) times
``BLOCK_GAIN``: at ``lm_batch``'s frame scale and the plain init the
streams barely read the frames (ROADMAP C).  Zeroing ``ck`` / ``cv``
before every step must move them.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.configs import skip_shapes as jax_skip_shapes
from repro.core.analog import AnalogConfig as JAnalog
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.data import lm_batch as j_lm_batch
from repro.launch import specs as JSP
from repro.models import attention as JA
from repro.models import encdec as JED
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro_torch import checkpoint as TCK
from repro_torch.bridge import encdec_cache_from_numpy, params_from_numpy, train_state_from_numpy
from repro_torch.configs import get_config, get_smoke_config, skip_shapes
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.data import lm_batch
from repro_torch.launch import specs as SP
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TED
from repro_torch.models import get_model_fns
from repro_torch.models import transformer as TTF
from repro_torch.optim import tree_leaves
from repro_torch.serving import ServeConfig, ServingEngine, StaticServingEngine
from repro_torch.train import TrainConfig, init_train_state

from _block_gain import BLOCK_GAIN

ARCH = "whisper-small"
ACT_ATOL = 1e-5
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
LOGIT_ATOL = 1e-4
REMAT_ATOL = 1e-7
B, S_DEC = 2, 12
N_SLOTS, N_STEPS, MAX_LEN = 3, 12, 32
# the decoder's block outputs the stream tests scale by BLOCK_GAIN
DEC_OUTPUTS = (("self_attn", "wo"), ("cross_attn", "wo"), ("ffn", "w_down"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(mode: str = "digital", **kw):
    jc = dataclasses.replace(jax_smoke(ARCH), dtype="float32", **kw)
    tc = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", **kw)
    if mode != "digital":
        # the reference's analog modes as its TPU runs them (the crossbar's
        # Pallas kernel, here in interpret mode)
        jc = dataclasses.replace(jc, analog=JAnalog(
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


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs()
    jp = jax.jit(JED.init_encdec, static_argnums=1)(jax.random.PRNGKey(0), jc)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    """Frames (B, 16, d) at std 1 and tokens (B, S_DEC + 1), from numpy."""
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, 16, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (B, S_DEC + 1)).astype(np.int32)
    return frames, toks


# ---------------------------------------------------------------------------
# Configs, positions, init.
# ---------------------------------------------------------------------------


def test_configs_equal_reference():
    for t, j in ((get_config(ARCH), jax_config(ARCH)), (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
    assert skip_shapes(ARCH) == jax_skip_shapes(ARCH)
    full = get_config(ARCH)
    assert (full.enc_layers, full.dec_layers, full.d_model, full.n_heads, full.head_dim,
            full.d_ff, full.vocab, full.enc_seq, full.mlp) == (
        12, 12, 768, 12, 64, 3072, 51865, 1500, "gelu")


def _sinusoid_atol(s: int) -> float:
    """One f32 ulp of the largest angle (s - 1) plus one of 1."""
    return float(np.spacing(np.float32(max(s - 1, 1))) + np.spacing(np.float32(1.0)))


@pytest.mark.parametrize("s,d", [(16, 64), (448, 768), (1500, 768)])
def test_sinusoid_pos_matches_reference(s, d):
    got = TED.sinusoid_pos(s, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, d)
    _close(got.numpy(), JED.sinusoid_pos(s, d), _sinusoid_atol(s))


def test_init_tree_matches_reference():
    """The port's own bf16 init has the reference's leaves, shapes and
    dtypes (``enc`` / ``dec`` stacked on a leading layer axis, ``dec_pos``
    in the model's dtype, norm scales f32); the bridge carries every leaf
    over unchanged; the full model has ≈ 0.263 B parameters by its shapes."""
    cfg = get_smoke_config(ARCH)
    tp = get_model_fns(cfg).init(0, cfg, "cpu")
    jp = jax.eval_shape(lambda: JED.init_encdec(jax.random.PRNGKey(0), jax_smoke(ARCH)))
    flat_t = {"/".join(k): v for k, v in _flatten(tp)}
    flat_j = {"/".join(k): v for k, v in _flatten(jp)}
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == tuple(v.shape), k
        assert str(flat_t[k].dtype).split(".")[-1] == str(v.dtype), k
    assert flat_t["dec/cross_attn/wq"].shape == (2, 64, 64)
    assert abs(float(tp["dec_pos"].float().std()) - 0.01) < 1e-3
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(np.float32), jp)
    bridged = {"/".join(k): v for k, v in _flatten(params_from_numpy(tree, cfg, device="cpu"))}
    for k, v in _flatten(tree):
        got = bridged["/".join(k)]
        want = v.astype(jnp.bfloat16).astype(np.float32) if got.dtype == torch.bfloat16 else v
        np.testing.assert_array_equal(got.float().numpy(), want)
    full = jax.eval_shape(lambda: JED.init_encdec(jax.random.PRNGKey(0), jax_config(ARCH)))
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(full))
    assert 0.263e9 < n < 0.264e9, n


# ---------------------------------------------------------------------------
# The modules, digitally and on the crossbar.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["digital", "analog_linear"])
def test_cross_attention_matches_reference(weights, inputs, mode):
    """One decoder layer's cross-attention alone, on the same x and
    encoder output; in ``analog_linear`` its four projections read the
    crossbar under ``split(key, 4)``."""
    jc, tc = _cfgs(mode)
    jp, tp = weights
    frames, _ = inputs
    x = np.random.default_rng(4).standard_normal((B, 5, 64)).astype(np.float32)
    key = None if mode == "digital" else jax.random.PRNGKey(7)
    jl = jax.tree.map(lambda a: a[1], jp["dec"]["cross_attn"])
    want = JA.cross_attention(jl, jnp.asarray(x), jnp.asarray(frames), jc, key)
    got = TA.cross_attention({k: v[1] for k, v in tp["dec"]["cross_attn"].items()}, _t(x),
                             _t(frames), tc, None if key is None else _key_pair(key))
    assert tuple(got.shape) == (B, 5, 64)
    _close(got.numpy(), want, ACT_ATOL)


def test_encode_and_decode_train_match_reference(weights, inputs):
    jc, tc = _cfgs()
    jp, tp = weights
    frames, toks = inputs
    je = jax.jit(JED.encode, static_argnums=2)(jp, jnp.asarray(frames), jc)
    jl = jax.jit(JED.decode_train, static_argnums=3)(jp, jnp.asarray(toks), je, jc)
    with torch.no_grad():
        te = TED.encode(tp, _t(frames), tc)
        tl = TED.decode_train(tp, torch.from_numpy(toks).long(), _t(je), tc)
    _close(te.numpy(), je, ACT_ATOL)
    assert tuple(tl.shape) == (B, S_DEC + 1, 256)
    _close(tl.numpy(), jl, LOGIT_ATOL)


def _identity_checkpoint(fn=None, **kw):
    return fn if fn is not None else (lambda f: f)


def _reference_loss_and_grads(jc, jp, batch, key, monkeypatch=None):
    """The reference's ``encdec_loss`` and its gradients, jitted; with
    ``monkeypatch``, ``jax.checkpoint`` is the identity for this call."""
    if monkeypatch is not None:
        monkeypatch.setattr(jax, "checkpoint", _identity_checkpoint)
    try:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: JED.encdec_loss(p, jbatch, jc, key), has_aux=True))(jp)
        return float(loss), jax.tree.map(np.asarray, grads)
    finally:
        if monkeypatch is not None:
            monkeypatch.undo()


def _loss_batch(inputs):
    frames, toks = inputs
    return {"frames": frames, "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_checkpoint_patch_changes_no_digital_number(weights, inputs, monkeypatch):
    """The reference's digital loss and gradients, with and without
    ``jax.checkpoint``: the same loss, gradients within ``REMAT_ATOL``."""
    jc, _ = _cfgs()
    jp, _ = weights
    batch = _loss_batch(inputs)
    l0, g0 = _reference_loss_and_grads(jc, jp, batch, None)
    l1, g1 = _reference_loss_and_grads(jc, jp, batch, None, monkeypatch)
    assert abs(l0 - l1) <= REMAT_ATOL
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1), strict=True):
        _close(b, a, REMAT_ATOL)
    assert jax.checkpoint is not _identity_checkpoint


@pytest.mark.parametrize("mode", ["digital", "analog_linear", "analog_stochastic"])
def test_loss_and_gradients_match_reference(weights, inputs, mode, monkeypatch):
    """``tests/test_models.py:36`` for the port: the loss and every
    gradient equal the reference's within ``LOSS_ATOL`` / ``GRAD_ATOL``;
    in the analog modes every encoder, decoder and cross-attention
    projection reads the crossbar (``analog_stochastic``: the MLP's
    ``w_up`` through the comparator, its output the activation)."""
    jc, tc = _cfgs(mode)
    jp, _ = weights
    batch = _loss_batch(inputs)
    key = None if mode == "digital" else jax.random.PRNGKey(2)
    jl, jg = _reference_loss_and_grads(jc, jp, batch, key,
                                       None if mode == "digital" else monkeypatch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tl, metrics = TED.encdec_loss(tp, tbatch, tc, None if key is None else _key_pair(key))
    assert float(metrics["loss"].detach()) == float(tl.detach())
    assert abs(float(tl.detach()) - jl) <= LOSS_ATOL
    for a, b in zip(jax.tree.leaves(jg), torch.autograd.grad(tl, leaves), strict=True):
        _close(b.numpy(), a, GRAD_ATOL)


def test_analog_stochastic_step_reads(monkeypatch):
    """One ``analog_stochastic`` training step of the smoke config through
    ``make_train_step``: 6 crossbar reads an encoder layer (q, k, v, o
    linear; ``w_up`` a comparator; ``w_down`` linear) and 10 a decoder
    layer (4 self-attention, 4 cross-attention, the MLP's 2), in that
    order; then the backward's recompute of every layer, the decoder's
    first (each layer is checkpointed, as the reference's scan bodies
    are); no ``sigmoid_sample``; the tied head stays digital."""
    from repro_torch.kernels import ops as KOPS
    from repro_torch.train import make_train_step

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
    batch = lm_batch(tc, batch=2, seq=12, step=0, device="cpu")
    state, m = make_train_step(tc, tcfg)(state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    lin, cmp_, down = ((64, 64), False), ((64, 128), True), ((128, 64), False)
    enc = [lin] * 4 + [cmp_, down]
    dec = [lin] * 8 + [cmp_, down]
    fwd, bwd = enc * tc.enc_layers + dec * tc.dec_layers, dec * tc.dec_layers + enc * tc.enc_layers
    assert calls == fwd + bwd
    assert not sig


# ---------------------------------------------------------------------------
# Prefill and decode.
# ---------------------------------------------------------------------------


def test_prefill_and_decode_match_reference(weights, inputs):
    """``encdec_prefill`` and two ``encdec_decode_step`` calls: every cache
    leaf and the logits against the reference's on the same weights; the
    second step runs both packages from one bridged cache."""
    jc, tc = _cfgs()
    jp, tp = weights
    frames, toks = inputs
    j_prefill = jax.jit(JED.encdec_prefill, static_argnums=(3, 4))
    j_step = jax.jit(JED.encdec_decode_step, static_argnums=3)
    jcache, jlp = j_prefill(jp, jnp.asarray(frames), jnp.asarray(toks[:, :-2]), jc, MAX_LEN)
    with torch.no_grad():
        tcache, tlp = TED.encdec_prefill(tp, _t(frames), torch.from_numpy(toks[:, :-2]).long(),
                                         tc, MAX_LEN)
        _close(tlp.numpy(), jlp, LOGIT_ATOL)
        assert sorted(tcache) == sorted(jcache) == ["ck", "cv", "k", "pos", "v"]
        for name, leaf in jcache.items():
            assert tuple(tcache[name].shape) == leaf.shape, name
            _close(tcache[name].numpy(), leaf, LOGIT_ATOL)
        assert tcache["k"].shape == (2, B, MAX_LEN, 4, 16)
        assert tcache["ck"].shape == (2, B, 16, 4, 16)
        for t in (S_DEC - 1, S_DEC):
            tok = toks[:, t]
            if t == S_DEC:
                # both packages step from one cache: the reference's
                tcache = encdec_cache_from_numpy(jax.tree.map(np.asarray, jcache), tc, "cpu")
            jcache, jld = j_step(jp, jcache, jnp.asarray(tok), jc)
            _, tld = TED.encdec_decode_step(tp, tcache, torch.from_numpy(tok).long(), tc)
            _close(tld.numpy(), jld, LOGIT_ATOL)
            for name, leaf in jcache.items():
                _close(tcache[name].numpy(), leaf, LOGIT_ATOL)
            assert tcache["pos"].tolist() == [t + 1] * B


def test_prefill_decode_match_port_forward(weights, inputs):
    """``tests/test_models.py:53-79`` for the port: its prefill logits and
    decode steps against its own ``decode_train`` over its ``encode``."""
    _, tc = _cfgs()
    _, tp = weights
    frames, toks = inputs
    s = S_DEC - 2
    tt = torch.from_numpy(toks).long()
    fns = get_model_fns(tc)
    with torch.no_grad():
        full = TED.decode_train(tp, tt, TED.encode(tp, _t(frames), tc), tc)
        cache, lp = fns.prefill(tp, {"frames": _t(frames), "tokens": tt[:, :s]}, tc, MAX_LEN)
        _close(lp.numpy(), full[:, s - 1].numpy(), LOGIT_ATOL)
        for t in range(s, S_DEC + 1):
            cache, ld = fns.decode_step(tp, cache, tt[:, t], tc)
            _close(ld.numpy(), full[:, t].numpy(), LOGIT_ATOL)


def test_lm_batch_frames_match_reference():
    jc, tc = jax_smoke(ARCH), get_smoke_config(ARCH)
    want = j_lm_batch(jc, batch=2, seq=12, step=3, seed=1)
    got = lm_batch(tc, batch=2, seq=12, step=3, seed=1, device="cpu")
    assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
    assert got["frames"].dtype == torch.float32 and tuple(got["frames"].shape) == (2, 12, 64)
    # torch's log1p under the normal's erf_inv: a few ulps from XLA's
    # (tests/test_torch_wta.py's normal criteria)
    g, w = got["frames"].numpy(), np.asarray(want["frames"])
    assert (g == w).mean() >= 0.95
    np.testing.assert_array_max_ulp(g, w, maxulp=8)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


# ---------------------------------------------------------------------------
# The dense serve step.
# ---------------------------------------------------------------------------


def _gain_decoder(tree, scale):
    """``tree`` with the decoder's block outputs (``DEC_OUTPUTS``) times
    ``BLOCK_GAIN``; ``scale(leaf, gain)`` is the package's multiply."""
    dec = dict(tree["dec"])
    for blk, name in DEC_OUTPUTS:
        dec[blk] = dict(dec[blk], **{name: scale(dec[blk][name], BLOCK_GAIN)})
    return dict(tree, dec=dec)


@pytest.fixture(scope="module")
def served():
    """The gained weights in both packages, three requests' std-1 frames and
    prompts of 3, 5 and 4 tokens (numpy), and the reference's greedy and
    WTA streams through its jitted prefill, slot insert and serve step."""
    jc, tc = _cfgs()
    jp = _gain_decoder(jax.jit(JED.init_encdec, static_argnums=1)(jax.random.PRNGKey(0), jc),
                       lambda a, g: a * g)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(11)
    frames = [rng.standard_normal((1, 16, 64)).astype(np.float32) for _ in range(N_SLOTS)]
    prompts = [rng.integers(0, 256, (1, n)).astype(np.int32) for n in (3, 5, 4)]
    want = {wta: _reference_streams(jp, jc, frames, prompts, wta) for wta in (False, True)}
    return jp, tp, frames, prompts, want


def _slot_keys(wta: bool):
    """Per-slot WTA keys (slot i: fold_in(PRNGKey(5), i)) as uint32 pairs."""
    return np.stack([np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.PRNGKey(5), i)), np.uint32) for i in range(N_SLOTS)])


def _reference_streams(jp, jc, frames, prompts, wta):
    cfg = dataclasses.replace(jc, wta_head=wta)
    prefill = jax.jit(JED.encdec_prefill, static_argnums=(3, 4))
    insert = jax.jit(JSP.make_cache_insert(cfg))
    step = jax.jit(JSP.make_serve_step(cfg))
    cache = JSP.init_decode_cache(cfg, N_SLOTS, MAX_LEN)
    first = []
    for i, (f, p) in enumerate(zip(frames, prompts)):
        one, logits = prefill(jp, jnp.asarray(f), jnp.asarray(p), cfg, MAX_LEN)
        cache = insert(cache, one, i)
        first.append(int(jnp.argmax(logits[0])))
    tok = jnp.asarray(first, jnp.int32)
    keys = jnp.asarray(_slot_keys(wta))
    out = [first]
    for t in range(N_STEPS):
        steps = jnp.full((N_SLOTS,), t, jnp.int32)
        cache, tok = step(jp, cache, tok, keys, steps) if wta else step(jp, cache, tok)
        out.append(np.asarray(tok).tolist())
    return np.array(out).T.tolist()


def _port_streams(tp, tc, frames, prompts, wta, zero_cross=False):
    cfg = dataclasses.replace(tc, wta_head=wta)
    insert = SP.make_cache_insert(cfg)
    step = SP.make_serve_step(cfg)
    fns = get_model_fns(cfg)
    cache = SP.init_decode_cache(cfg, N_SLOTS, MAX_LEN, device="cpu")
    assert cache["ck"].shape == (2, N_SLOTS, 16, 4, 16)
    first = []
    with torch.no_grad():
        for i, (f, p) in enumerate(zip(frames, prompts)):
            one, logits = fns.prefill(tp, {"frames": _t(f), "tokens": torch.from_numpy(p).long()},
                                      cfg, MAX_LEN)
            insert(cache, one, i)
            first.append(int(torch.argmax(logits[0])))
        tok = torch.tensor(first, dtype=torch.int32)
        keys = torch.from_numpy(_slot_keys(wta).astype(np.int64))
        out = [first]
        for t in range(N_STEPS):
            if zero_cross:
                cache["ck"].zero_()
                cache["cv"].zero_()
            steps = torch.full((N_SLOTS,), t, dtype=torch.int64)
            cache, tok = step(tp, cache, tok, keys, steps) if wta else step(tp, cache, tok)
            out.append(tok.tolist())
    assert cache["pos"].tolist() == [p.shape[1] + N_STEPS for p in prompts]
    return np.array(out).T.tolist()


@pytest.mark.parametrize("wta", [False, True], ids=["greedy", "wta"])
def test_dense_serve_streams_match_reference(served, wta):
    """Three requests prefilled alone, inserted into slots 0-2 and decoded
    N_STEPS tokens through ``make_serve_step``: the port's streams are the
    reference's token for token; the streams move (at least N_SLOTS
    steps change the token: 10 of 36 greedy)."""
    _, tp, frames, prompts, want = served
    _, tc = _cfgs()
    got = _port_streams(tp, tc, frames, prompts, wta)
    assert got == want[wta]
    moves = sum(a != b for st in got for a, b in zip(st, st[1:]))
    assert moves >= N_SLOTS, got
    if wta:
        assert got != want[False]


def test_dense_serve_streams_read_the_cross_cache(served):
    """The mutation check of the stream test: with ``ck`` / ``cv`` zeroed
    before every step the greedy streams are no longer the reference's."""
    _, tp, frames, prompts, want = served
    _, tc = _cfgs()
    got = _port_streams(tp, tc, frames, prompts, False, zero_cross=True)
    moved = sum(a != b for g, w in zip(got, want[False]) for a, b in zip(g, w))
    assert moved >= N_SLOTS * N_STEPS // 4, moved


def test_cache_batch_axis_and_insert():
    """``tests/test_specs.py``'s slot-axis contract for the encdec cache:
    axis 1 for ``k``, ``v``, ``ck``, ``cv`` and 0 for ``pos``, the
    reference's; an insert writes only its slot."""
    jc, tc = jax_smoke(ARCH), get_smoke_config(ARCH)
    cache = SP.init_decode_cache(tc, 4, 8, device="cpu")
    jcache = JSP.init_decode_cache(jc, 4, 8)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jcache.items()}
    for name, leaf in cache.items():
        ax = SP.cache_batch_axis(tc, name)
        assert ax == JSP.cache_batch_axis(jc, name) and leaf.shape[ax] == 4
    one = {k: torch.full_like(v, 7)[:1] if k == "pos" else torch.full_like(v, 7).narrow(1, 0, 1)
           for k, v in cache.items()}
    SP.make_cache_insert(tc)(cache, one, 2)
    for name, leaf in cache.items():
        arr = leaf.float().movedim(SP.cache_batch_axis(tc, name), 0)
        assert bool((arr[2] == 7).all()) and bool((arr[[0, 1, 3]] == 0).all())
    with pytest.raises(KeyError):
        SP.cache_batch_axis(tc, "k_pages")


def test_refusals_name_the_family():
    """Both engines (and so ``serve.py``), every paged entry point and the
    paged cache refuse the encoder-decoder with the reference's messages;
    the decoder stack names it."""
    cfg = get_smoke_config(ARCH)
    tp = get_model_fns(cfg).init(0, cfg, "cpu")
    for engine_cls in (ServingEngine, StaticServingEngine):
        with pytest.raises(ValueError, match="encdec serving needs frames; token-LM only"):
            engine_cls(tp, cfg, ServeConfig(max_batch=2, max_len=32), device="cpu")
    with pytest.raises(ValueError, match=r"paged KV cache is token-LM only \(no encdec\)"):
        SP.init_paged_decode_cache(cfg, 2, 8, 8, device="cpu")
    for make in (SP.make_paged_suffix_prefill, SP.make_paged_serve_step,
                 SP.make_spec_rollback, SP.make_page_spill, SP.make_page_restore,
                 SP.make_slot_state_gather, SP.make_paged_state_insert,
                 lambda c: SP.make_paged_spec_round(c, 2)):
        with pytest.raises(ValueError, match=r"paged serving is token-LM only \(no encdec\)"):
            make(cfg)
    with pytest.raises(NotImplementedError, match="got encdec .*models/encdec.py"):
        TTF.init_lm(cfg, device="cpu")
    # serve.py stops at the engine's refusal, as the reference's launcher does
    from repro_torch.launch import serve as LS

    for extra in ([], ["--static"]):
        with pytest.raises(ValueError, match="encdec serving needs frames"):
            LS.main(["--arch", ARCH, "--smoke", "--device", "cpu", *extra])


# ---------------------------------------------------------------------------
# The launcher and checkpoints.
# ---------------------------------------------------------------------------


def test_train_launcher_smoke(tmp_path):
    """``launch.train --arch whisper-small --smoke --device cpu`` for two
    steps on ``lm_batch``'s frames, with a checkpoint."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    ).stdout
    assert "done: steps=2" in out, out
    assert TCK.latest_step(str(tmp_path / "ck")) == 2


def test_checkpoint_round_trip(tmp_path):
    """The reference's whisper TrainState (its init, bf16 parameters),
    written by the reference and read by the port, equals the bridged
    state; the port's write reads back in the reference bit for bit."""
    jc, tc = jax_smoke(ARCH), get_smoke_config(ARCH)   # bf16 parameters
    jt, tt = JTrainConfig(warmup_steps=1), TrainConfig(warmup_steps=1)
    js = j_init_train_state(jax.random.PRNGKey(0), jc, jt)
    JCK.save_checkpoint(str(tmp_path / "j"), 1, js)
    like = init_train_state(0, tc, tt, device="cpu")
    got = TCK.load_checkpoint(str(tmp_path / "j"), 1, like)
    f32 = lambda tree: jax.tree.map(lambda x: np.array(x, np.float32), tree)  # noqa: E731
    want = train_state_from_numpy(f32(js.params), f32(js.opt.m), f32(js.opt.v), int(js.opt.step),
                                  int(js.step), jax.random.key_data(js.rng), tc, tt,
                                  device="cpu")
    assert got.step == want.step == 0 and got.rng == want.rng
    for a, b in zip(tree_leaves(got.params) + tree_leaves(got.opt.m),
                    tree_leaves(want.params) + tree_leaves(want.opt.m), strict=True):
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach())
    assert got.params["dec_pos"].dtype == torch.bfloat16
    TCK.save_checkpoint(str(tmp_path / "t"), 1, got)
    back = JCK.load_checkpoint(str(tmp_path / "t"), 1, jax.eval_shape(lambda: js))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(js), strict=True):
        assert x.dtype == y.dtype and np.array_equal(np.asarray(x), np.asarray(y))
