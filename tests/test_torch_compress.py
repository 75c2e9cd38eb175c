"""int8 gradient compression with error feedback, the port against the
reference: ``compress_grads`` on equal inputs, the training step with
``compress_grads`` at 1 and 4 microbatches from one bridged state, and the
reference's convergence test, ported.

Tolerances, and why:

- ``compress_grads``: bit-identical output and residual on identical
  inputs, with the key and without (same threefry uniforms, the scale
  divided by a tensor in both);
- one training step from one bridged state: the loss within 1e-5 and the
  (compressed) gradient norm within rel 1e-5, as ``test_torch_train.py``;
  the gradients themselves differ at f32 rounding (atol 1e-5 there), so
  where a rounding draw falls between the two sides' fractions one level
  flips: the residual then differs by one quantization step, the leaf's
  ``max|g| / 127``, which is at least every |residual| of the leaf.  So
  every residual element is within 2·max|residual| + 1e-6 of the
  reference's, and at least 99.9% within 1e-6 (a flip needs a draw in an
  interval of ~1e-7 relative width; two in 8192 were seen);
- a second step: its loss within 1e-4 (a flipped level moves one
  element's gradient by a quantization step, ~1e-3, and the next loss by
  ~lr·1e-3 at most).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config as j_smoke
from repro.data import lm_batch as j_lm_batch
from repro.optim import adamw as JADAM
from repro.optim import compress as JC
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.bridge import train_state_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.data import lm_batch as t_lm_batch
from repro_torch.optim import AdamWConfig as TAdamWConfig
from repro_torch.optim import compress as TC
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainConfig as TTrainConfig
from repro_torch.train import init_train_state as t_init_train_state
from repro_torch.train import make_train_step as t_make_train_step

LOSS_ATOL = 1e-5
LOSS_ATOL_NEXT = 1e-4
RESIDUAL_ATOL = 1e-6
RESIDUAL_EQUAL = 0.999


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small PyTorch ops, which
    only wait on each other's threads when the run's workers share the
    cores (the tier-1 run puts six on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(key):
    a = np.asarray(jax.random.key_data(key), np.uint32)
    return int(a[0]), int(a[1])


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)).view(np.uint32)


def _trees(seed: int):
    """A gradient tree (f32 leaves of several scales, one bf16 leaf, one
    all-zero leaf) and a residual tree, as numpy."""
    rng = np.random.default_rng(seed)
    g = {
        "attn": {"wq": rng.standard_normal((33, 17)).astype(np.float32) * 1e-3,
                 "scale": rng.standard_normal(40).astype(np.float32)},
        "b": np.zeros(7, np.float32),
        "embed": (rng.standard_normal((64, 9)) * 3e-2).astype(np.float32),
    }
    e = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-5).astype(np.float32), g)
    return g, e


@pytest.mark.parametrize("with_key", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_compress_grads_bit_equal(with_key, seed):
    """Three chained calls (the residual fed back), output and residual
    bit for bit; the bf16 leaf comes back in bf16."""
    g, e = _trees(seed)
    jg = jax.tree.map(jnp.asarray, g)
    jg["embed"] = jg["embed"].astype(jnp.bfloat16)
    tg = jax.tree.map(torch.from_numpy, g)
    tg["embed"] = tg["embed"].to(torch.bfloat16)
    js = JC.CompressState(error=jax.tree.map(jnp.asarray, e))
    ts = TC.CompressState(error=jax.tree.map(torch.from_numpy, e))
    for call in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), call) if with_key else None
        jout, js = JC.compress_grads(jg, js, key)
        tout, ts = TC.compress_grads(tg, ts, _pair(key) if with_key else None)
        assert tout["embed"].dtype == torch.bfloat16
        for a, b in zip(jax.tree.leaves(jout), tree_leaves(tout)):
            assert np.array_equal(_bits(a), _bits(b))
        for a, b in zip(jax.tree.leaves(js.error), tree_leaves(ts.error)):
            assert b.dtype == torch.float32
            assert np.array_equal(_bits(a), _bits(b))


def test_quantize_leaf_in_slices(monkeypatch):
    """A leaf drawn in flat slices of CHUNK elements has the bits of the
    whole draw (the reference draws it at once)."""
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((37, 29)).astype(np.float32))
    key = _pair(jax.random.PRNGKey(11))
    whole = TC._quantize_leaf(g, key)
    want = JC._quantize_leaf(jnp.asarray(g.numpy()), jax.random.PRNGKey(11))
    monkeypatch.setattr(TC, "CHUNK", 100)
    sliced = TC._quantize_leaf(g, key)
    assert torch.equal(sliced.view(torch.int32), whole.view(torch.int32))
    assert np.array_equal(_bits(want), _bits(whole))


def test_init_compress_state():
    _, tc = _cfgs()
    tt = TTrainConfig(compress_grads=True)
    st = t_init_train_state(0, tc, tt, device="cpu")
    errs, params = tree_leaves(st.compress.error), tree_leaves(st.params)
    assert len(errs) == len(params)
    for e, p in zip(errs, params):
        assert e.dtype == torch.float32 and e.shape == p.shape and not e.any()
    assert t_init_train_state(0, tc, TTrainConfig(), device="cpu").compress is None


def _cfgs():
    jc = dataclasses.replace(j_smoke("stablelm-3b"), dtype="float32")
    tc = dataclasses.replace(t_smoke("stablelm-3b"), dtype="float32")
    return jc, tc


@pytest.mark.parametrize("microbatches", [1, 4])
def test_compressed_steps_match(microbatches):
    """Two compressed steps from one bridged state (the reference's keys:
    ``fold_in(step_key, 13)``, per microbatch ``fold_in(kmb, 13)``)."""
    jc, tc = _cfgs()
    opt = dict(lr=1e-2, state_dtype="float32", stochastic_rounding=False)
    kw = dict(microbatches=microbatches, compress_grads=True, warmup_steps=2, total_steps=10)
    jt = JTrainConfig(opt=JADAM.AdamWConfig(**opt), **kw)
    tt = TTrainConfig(opt=TAdamWConfig(**opt), **kw)
    js = j_init_train_state(jax.random.PRNGKey(0), jc, jt)
    js = js._replace(step=jnp.asarray(1, jnp.int32))   # past step 0's zero learning rate
    st = jax.tree.map(np.asarray, js)
    ts = train_state_from_numpy(
        _np(st.params), _np(st.opt.m), _np(st.opt.v), int(st.opt.step), int(st.step),
        jax.random.key_data(js.rng), tc, tt, device="cpu", compress_error=_np(st.compress.error),
    )
    jstep, tstep = jax.jit(j_make_train_step(jc, jt)), t_make_train_step(tc, tt)
    for i in range(2):
        batch = j_lm_batch(jc, batch=4, seq=16, step=i)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= (LOSS_ATOL if i == 0 else LOSS_ATOL_NEXT)
        if i == 0:
            assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
            near = []
            for a, b in zip(jax.tree.leaves(js.compress.error), tree_leaves(ts.compress.error)):
                a = np.asarray(a)
                d = np.abs(b.numpy() - a)
                assert d.max() <= 2 * np.abs(a).max() + RESIDUAL_ATOL
                near.append((d <= RESIDUAL_ATOL).reshape(-1))
            assert np.concatenate(near).mean() >= RESIDUAL_EQUAL
    assert ts.step == int(js.step) == 3


def test_grad_compression_error_feedback_converges():
    """The reference's ``test_grad_compression_error_feedback_converges`` on
    the port: 15 steps compressed and not; both fall, and the last three
    losses stay within 0.25 of each other."""
    _, tc = _cfgs()
    opt = TAdamWConfig(lr=1e-2, state_dtype="float32", stochastic_rounding=False)
    t_plain, t_comp = TTrainConfig(opt=opt), TTrainConfig(opt=opt, compress_grads=True)
    sp = t_init_train_state(0, tc, t_plain, device="cpu")
    sc = t_init_train_state(0, tc, t_comp, device="cpu")
    step_p, step_c = t_make_train_step(tc, t_plain), t_make_train_step(tc, t_comp)
    lp, lc = [], []
    for i in range(15):
        b = t_lm_batch(tc, batch=8, seq=16, step=i, device="cpu")
        sp, mp = step_p(sp, b)
        sc, mc = step_c(sc, b)
        lp.append(float(mp["loss"]))
        lc.append(float(mc["loss"]))
    assert np.mean(lc[-3:]) < lc[0]
    assert abs(np.mean(lc[-3:]) - np.mean(lp[-3:])) < 0.25
