"""The port's recurrentgemma-2b (the ``hybrid`` family: units of RG-LRU
blocks and MQA local attention) against ``repro`` on the CPU, at the
smoke config in f32, on ``repro``'s init carried across by ``bridge``.

- The full and smoke configs equal the reference's field for field; the
  port's own init has the reference's leaves, shapes and dtypes.
- The ports of ``tests/test_models.py:36`` and ``:54``: the loss and its
  gradients equal the reference's within ``LOSS_ATOL`` / ``GRAD_ATOL``
  (f32 sums in another order, torch's ``exp`` / ``sqrt`` / tanh ``gelu``
  a few ulps from XLA's), digitally: the analog modes are held against
  the reference at the block (``tests/test_torch_rglru.py``), whose
  interpret-mode crossbar at model scale would cost a tier-1 run tens of
  seconds; one ``analog_stochastic`` training step runs
  ``sigmoid_sample`` twice per recurrent sublayer; the dense prefill +
  decode and the chunked paged
  prefill + paged decode equal the port's own forward within
  ``LOGIT_ATOL`` and the reference's forward within ``LOGIT_ATOL`` (the
  reference holds its own bit for bit; the port's decode step sums the
  recurrence and the attention in another order than the forward).
- An int8 pool's write of unit ``u``, sublayer ``i`` rounds under a seed
  that folds in ``i``, the sublayer's index in the whole pattern, not its
  index among the attention sublayers: the port's pool equals the
  reference's after a prefill and a decode step.
- The decoder stack refuses ``encdec`` (whisper-small), naming the
  family and its module (``tests/test_torch_encdec.py`` holds that
  module), and inits ``vlm`` (llava-next-34b,
  ``tests/test_torch_vlm.py``); mamba2-1.3b, the ``ssm`` family, is
  ``tests/test_torch_mamba2.py``'s, the ``moe_lm`` family
  ``tests/test_torch_moe.py``'s.
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
from repro.models import transformer as JTF
from repro_torch.bridge import paged_cache_from_numpy, params_from_numpy
from repro_torch.configs import get_config, get_smoke_config, skip_shapes
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.kernels import ops as KOPS
from repro_torch.models import ModelConfig
from repro_torch.models import transformer as TTF
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainConfig, init_train_state, make_train_step

ARCH = "recurrentgemma-2b"
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
LOGIT_ATOL = 1e-4
INT8_CODE_AGREEMENT = 0.98


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
        # the reference's analog modes as its TPU runs them; interpret-mode
        # Pallas cannot be rematerialised (ROADMAP C)
        jc = dataclasses.replace(jc, remat_policy="full", analog=JAnalog(
            mode=mode, device=j_calibrate(JDevice(), jc.d_model), use_pallas="on"))
        tc = dataclasses.replace(tc, analog=TAnalog(
            mode=mode, device=t_calibrate(TDevice(), tc.d_model)))
    return jc, tc


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
    assert skip_shapes(ARCH) == jax_skip_shapes(ARCH) == {}
    full = get_config(ARCH)
    assert full.layer_pattern.count("rec") * full.n_units == 18
    assert full.layer_pattern.count("local") * full.n_units == 8


def test_init_tree_matches_reference():
    """Leaves, shapes and dtypes of the port's own bf16 init are the
    reference's (the RG-LRU's ``ba``, ``bx``, ``lam`` f32 among bf16
    weights), and the full model has ≈ 2.89 B parameters by its shapes."""
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
    assert 2.88e9 < n < 2.90e9, n


def test_loss_and_gradients_match_reference(weights):
    jc, tc = _cfgs()
    jp, _ = weights
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JTF.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, jc),
        has_aux=True))(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl, _ = TTF.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tc)
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_ATOL
    tg = torch.autograd.grad(tl, leaves)
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=GRAD_ATOL, rtol=0)


def test_analog_stochastic_train_step_samples_the_gates(monkeypatch):
    """One ``analog_stochastic`` step through ``train/step.py``: finite
    loss, a finite non-zero gradient norm, and the RG-LRU gates drawn
    through ``ops.sigmoid_sample`` twice per recurrent sublayer in the
    forward, and again in the backward, which recomputes every unit
    (``remat_policy`` "nothing", the default)."""
    _, tc = _cfgs("analog_stochastic")
    calls = []
    real = KOPS.sigmoid_sample

    def counted(acc, *a, **kw):
        calls.append(tuple(acc.shape))
        return real(acc, *a, **kw)

    monkeypatch.setattr(KOPS, "sigmoid_sample", counted)
    tcfg = TrainConfig(warmup_steps=1, total_steps=4)
    state = init_train_state(0, tc, tcfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, tc.vocab, (2, 17))
                            .astype(np.int32))
    state, m = make_train_step(tc, tcfg)(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert np.isfinite(float(m["loss"]))
    n_rec = tc.layer_pattern.count("rec") * tc.n_units
    assert tc.remat_policy == "nothing"
    assert calls == [(2, 16, tc.lru_width)] * (2 * n_rec) * 2
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0


def test_prefill_decode_match_forward(weights):
    """The reference's ``test_prefill_decode_match_forward`` for the port:
    its dense prefill + decode steps and its chunked paged prefill (two
    chunks, the second from the first's recurrent state) + paged decode
    steps, against its own forward and the reference's, past the smoke
    window of 16."""
    jc, tc = _cfgs()
    jp, tp = weights
    b, s, n_dec = 2, 20, 3
    toks = np.random.default_rng(2).integers(0, tc.vocab, (b, s + n_dec)).astype(np.int32)
    jfull = np.asarray(JTF.lm_forward(jp, jnp.asarray(toks), jc)[0])
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full = TTF.lm_forward(tp, tt.long(), tc)[0].numpy()
        np.testing.assert_allclose(full, jfull, atol=LOGIT_ATOL, rtol=0)
        cache, lp = TTF.lm_prefill(tp, tt[:, :s], tc, 32)
        assert cache["rec_conv"].shape == (1, 2, b, 3, 64) and cache["rec_h"].shape == (1, 2, b, 64)
        np.testing.assert_allclose(lp.numpy(), full[:, s - 1], atol=LOGIT_ATOL, rtol=0)
        for t in range(n_dec):
            cache, ld = TTF.lm_decode_step(tp, cache, tt[:, s + t], tc)
            np.testing.assert_allclose(ld.numpy(), full[:, s + t], atol=LOGIT_ATOL, rtol=0)
        bs, wp = 8, 4
        pool = TTF.init_paged_decode_cache(tc, b, 1 + b * wp, bs, device="cpu")
        # one attention sublayer a unit: the K/V leaves count it alone
        assert pool["k_pages"].shape[:2] == (1, 1)
        table = torch.arange(1, 1 + b * wp, dtype=torch.int32).reshape(b, wp)
        for r in range(b):
            st = TTF.init_prefill_state(tc, "cpu")
            for lo, hi in ((0, 16), (16, s)):
                _, st, lp = TTF.lm_prefill_chunk(tp, tt[r:r + 1, lo:hi], tc, pool, st,
                                                 table[r], lo)
            np.testing.assert_allclose(lp[0].numpy(), full[r, s - 1], atol=LOGIT_ATOL, rtol=0)
            for name in ("rec_conv", "rec_h", "pos"):
                ax = 0 if name == "pos" else 2
                pool[name].narrow(ax, r, 1).copy_(st[name])
        for t in range(n_dec):
            pool, ld = TTF.lm_decode_step(tp, pool, tt[:, s + t], tc, table)
            np.testing.assert_allclose(ld.numpy(), full[:, s + t], atol=LOGIT_ATOL, rtol=0)
        for name in ("rec_conv", "rec_h"):
            np.testing.assert_allclose(pool[name].numpy(), cache[name].numpy(), atol=1e-5, rtol=0)


def test_chunk_prefill_keeps_its_input_state(weights):
    """A chunk returns new state tensors: the state it was given (in the
    engine, a boundary snapshot stashed in the prefix index) is not
    written."""
    _, tc = _cfgs()
    _, tp = weights
    pool = TTF.init_paged_decode_cache(tc, 1, 5, 8, device="cpu")
    toks = torch.arange(1, 17, dtype=torch.int32)[None]
    with torch.no_grad():
        _, st, _ = TTF.lm_prefill_chunk(tp, toks[:, :8], tc, pool,
                                        TTF.init_prefill_state(tc, "cpu"),
                                        torch.arange(1, 3, dtype=torch.int32), 0)
        snap = {n: v.clone() for n, v in st.items()}
        _, st2, _ = TTF.lm_prefill_chunk(tp, toks[:, 8:], tc, pool, st,
                                         torch.arange(1, 3, dtype=torch.int32), 8)
    assert all(torch.equal(snap[n], st[n]) for n in snap)
    assert not torch.equal(st2["rec_h"], st["rec_h"])
    assert int(st2["pos"][0]) == 16


def _assert_pools_agree(tpool: dict, jpool: dict, rows) -> None:
    """The K/V rows entering the write differ by ulps (the recurrent
    sublayers before it), so the scales agree to ``1e-6`` relative and a
    stochastic rounding can cross a level on either side: the codes agree
    on at least ``INT8_CODE_AGREEMENT`` of the elements.  Under the seed
    of the sublayer's attention index instead, 0.82 of the prefill's K
    codes agreed."""
    for n in ("k_scale_pages", "v_scale_pages"):
        np.testing.assert_allclose(tpool[n][rows].numpy(), np.asarray(jpool[n])[rows],
                                   rtol=1e-6, atol=0, err_msg=n)
    for n in ("k_pages", "v_pages"):
        got, want = tpool[n][rows].numpy(), np.asarray(jpool[n])[rows]
        assert (got == want).mean() >= INT8_CODE_AGREEMENT, (n, (got == want).mean())


def test_int8_pool_seeds_fold_the_pattern_index(weights):
    """int8 pool writes at a hybrid unit (rec, rec, local): the local
    sublayer is attention sublayer 0 of the pool but sublayer 2 of the
    pattern, and its rounding seed folds 2 in, as the reference's does.
    After one prefill chunk and one decode step the port's codes and
    scales agree with the reference's, and so does the recurrent state."""
    jc, tc = _cfgs(kv_cache_dtype="int8")
    jp, tp = weights
    bs, n_pages = 8, 5
    jpool = JTF.init_paged_decode_cache(jc, 1, n_pages, bs)
    tpool = TTF.init_paged_decode_cache(tc, 1, n_pages, bs, device="cpu")
    toks = np.arange(3, 19, dtype=np.int32)[None]
    row = np.arange(1, 3, dtype=np.int32)
    seeds = np.array([12345, 678910], np.uint32)
    jpool_l = {n: jpool[n] for n in TTF.PAGE_POOL_LEAVES}
    jpool_l, jst, _ = JTF.lm_prefill_chunk(jp, jnp.asarray(toks), jc, jpool_l,
                                           JTF.init_prefill_state(jc), jnp.asarray(row),
                                           jnp.asarray(0, jnp.int32), 16, jnp.asarray(seeds))
    with torch.no_grad():
        _, tst, _ = TTF.lm_prefill_chunk(tp, torch.from_numpy(toks), tc, tpool,
                                         TTF.init_prefill_state(tc, "cpu"),
                                         torch.from_numpy(row), 0,
                                         torch.from_numpy(seeds.astype(np.int64)))
    _assert_pools_agree(tpool, jpool_l, np.s_[:, :, 1:])
    jcache = dict(jpool, **jpool_l, **jst)
    jcache["pos"] = jnp.asarray([16], jnp.int32)
    tcache = paged_cache_from_numpy(jax.tree.map(np.asarray, jcache), tc, device="cpu")
    table = np.array([[1, 2, 3]], np.int32)
    jcache, _ = JTF.lm_decode_step(jp, jcache, jnp.asarray([7], jnp.int32), jc,
                                   jnp.asarray(table))
    with torch.no_grad():
        TTF.lm_decode_step(tp, tcache, torch.tensor([7], dtype=torch.int32), tc,
                           torch.from_numpy(table))
    _assert_pools_agree(tcache, jcache, np.s_[:, :, 3])
    np.testing.assert_allclose(tcache["rec_h"].numpy(), np.asarray(jcache["rec_h"]), atol=1e-5)


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
def test_unported_families_still_refused(arch):
    """The last two families are ported now, each by its own module: the
    decoder stack still refuses the encoder-decoder, naming the family
    and its module (``models/encdec.py`` runs it), and llava-next-34b's
    config, carried from the reference field for field, resolves in the
    port and inits through the decoder stack (``vlm``)."""
    j = jax_smoke(arch)
    fields = {f.name: getattr(j, f.name) for f in dataclasses.fields(ModelConfig)
              if f.name != "analog"}
    cfg = ModelConfig(**fields)
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(cfg)
    if arch == "whisper-small":
        for fn in (lambda: TTF.init_lm(cfg, device="cpu"),
                   lambda: TTF.init_paged_decode_cache(cfg, 1, 4, 8, device="cpu"),
                   lambda: TTF.init_decode_cache(cfg, 1, 16, device="cpu"),
                   lambda: TTF.lm_forward({}, torch.zeros((1, 4), dtype=torch.long), cfg)):
            with pytest.raises(NotImplementedError, match=f"got {cfg.family} .*models/encdec.py"):
                fn()
        return
    params = TTF.init_lm(cfg, device="cpu")
    assert tuple(params["units"]["l0"]["attn"]["wk"].shape) == (2, 64, 32)
    assert TTF.init_decode_cache(cfg, 1, 16, device="cpu")["k"].shape == (2, 1, 1, 16, 2, 16)
