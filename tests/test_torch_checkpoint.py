"""Checkpoints across the two packages: the port's ``checkpoint/store.py``
writes the reference's format and reads what the reference writes.

- ``repro`` writes a ``TrainState``, the port reads it into its own tree:
  every leaf bit-equal to ``bridge.train_state_from_numpy`` of the same
  state, dtypes the port's, ints and keys the port's;
- the port writes, ``repro`` reads: bit-equal;
- both write the same state: manifests byte-equal, checksum included;
- ``latest_step``, ``keep=3`` retention, a leftover ``.tmp_step_*``;
- a tree of other shapes than the checkpoint's is refused;
- ``save_async`` copies before it returns (the step updates in place);
- ``serve.py --ckpt-dir`` reads a params-only checkpoint, and raises
  ``KeyError`` on a training loop's, in both packages.

All comparisons are exact: a checkpoint is a copy.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import checkpoint as JCK
from repro.configs import get_smoke_config as j_smoke
from repro.configs.fcnn_mnist import smoke_config as j_fcnn_smoke
from repro.data import lm_batch as j_lm_batch
from repro.data import mnist_batch as j_mnist_batch
from repro.models import get_model_fns as j_model_fns
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch import checkpoint as TCK
from repro_torch.bridge import params_from_numpy, train_state_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.fcnn_mnist import smoke_config as t_fcnn_smoke
from repro_torch.optim import AdamWConfig as TAdamWConfig
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainConfig as TTrainConfig
from repro_torch.train import init_train_state as t_init_train_state

CASES = ["lm", "lm_f32_compress", "fcnn"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small PyTorch ops, which
    only wait on each other's threads when the run's workers share the
    cores (the tier-1 run puts six on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    """(reference config, port config, reference TrainConfig, port
    TrainConfig, a batch of the reference's)."""
    if name == "fcnn":
        jc = dataclasses.replace(j_fcnn_smoke(), fcnn_layers=(64, 32, 16, 10))
        tc = dataclasses.replace(t_fcnn_smoke(), fcnn_layers=(64, 32, 16, 10))
        opt = dict(lr=5e-3, state_dtype="float32", stochastic_rounding=False)
        b = j_mnist_batch(batch=16, step=0)
        batch = {"image": b["image"][:, :64], "label": b["label"]}
        return jc, tc, JTrainConfig(opt=JAdamWConfig(**opt)), TTrainConfig(opt=TAdamWConfig(**opt)), batch
    jc, tc = j_smoke("stablelm-3b"), t_smoke("stablelm-3b")     # bf16 parameters
    compress = name == "lm_f32_compress"
    if compress:
        jc, tc = dataclasses.replace(jc, dtype="float32"), dataclasses.replace(tc, dtype="float32")
    jt = JTrainConfig(compress_grads=compress, warmup_steps=1)
    tt = TTrainConfig(compress_grads=compress, warmup_steps=1)
    return jc, tc, jt, tt, j_lm_batch(jc, batch=2, seq=16, step=0)


@functools.lru_cache(maxsize=None)
def _reference_state(name):
    """The reference's state after two steps (nonzero moments, residuals);
    jax arrays are immutable, so the tests share it."""
    jc, tc, jt, tt, batch = _case(name)
    js = j_init_train_state(jax.random.PRNGKey(0), jc, jt)
    step = jax.jit(j_make_train_step(jc, jt))
    for _ in range(2):
        js, _ = step(js, batch)
    return js, tc, tt


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, np.float32), tree)


def _bridged(js, tc, tt):
    st = jax.tree.map(np.asarray, js)
    return train_state_from_numpy(
        _np(st.params), _np(st.opt.m), _np(st.opt.v), int(st.opt.step), int(st.step),
        jax.random.key_data(js.rng), tc, tt, device="cpu",
        compress_error=None if st.compress is None else _np(st.compress.error),
    )


def _assert_port_states_equal(a, b):
    assert a.step == b.step and a.opt.step == b.opt.step and a.rng == b.rng
    assert type(a.step) is int and type(a.opt.step) is int
    assert (a.compress is None) == (b.compress is None)
    pairs = [(a.params, b.params), (a.opt.m, b.opt.m), (a.opt.v, b.opt.v)]
    if a.compress is not None:
        pairs.append((a.compress.error, b.compress.error))
    for ta, tb in pairs:
        for x, y in zip(tree_leaves(ta), tree_leaves(tb), strict=True):
            assert x.dtype == y.dtype and x.device == y.device
            assert x.requires_grad == y.requires_grad
            assert torch.equal(x.detach(), y.detach())


def _assert_reference_equals_port(js, ts):
    """The reference's state, leaf by leaf, bit-equal to the port's."""
    assert int(js.step) == ts.step and int(js.opt.step) == ts.opt.step
    key = np.asarray(jax.random.key_data(js.rng), np.uint32)
    assert (int(key[0]), int(key[1])) == ts.rng
    pairs = [(js.params, ts.params), (js.opt.m, ts.opt.m), (js.opt.v, ts.opt.v)]
    if js.compress is not None:
        pairs.append((js.compress.error, ts.compress.error))
    for jt_, tt_ in pairs:
        for x, y in zip(jax.tree.leaves(jt_), tree_leaves(tt_), strict=True):
            assert str(x.dtype) == str(y.dtype).replace("torch.", "")
            xa = np.asarray(jnp.asarray(x).astype(jnp.float32))
            assert np.array_equal(xa.view(np.uint32), y.detach().float().numpy().view(np.uint32))


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return f.read()


@pytest.mark.parametrize("name", CASES)
def test_repro_writes_port_reads(tmp_path, name):
    js, tc, tt = _reference_state(name)
    JCK.save_checkpoint(str(tmp_path), 2, js)
    assert TCK.latest_step(str(tmp_path)) == 2
    like = t_init_train_state(0, tc, tt, device="cpu")
    got = TCK.load_checkpoint(str(tmp_path), 2, like)
    _assert_port_states_equal(got, _bridged(js, tc, tt))
    _assert_reference_equals_port(js, got)


@pytest.mark.parametrize("name", CASES)
def test_port_writes_repro_reads(tmp_path, name):
    js, tc, tt = _reference_state(name)
    ts = _bridged(js, tc, tt)
    TCK.save_checkpoint(str(tmp_path), 2, ts)
    assert JCK.latest_step(str(tmp_path)) == 2
    got = JCK.load_checkpoint(str(tmp_path), 2, jax.eval_shape(lambda: js))
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(js), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("name", CASES)
def test_manifests_equal(tmp_path, name):
    """Both packages' manifests of one state, byte for byte: leaf names
    (``.params/...``, ``.opt/.m/...``, ``.opt/.step``, ``.step``, ``.rng``),
    shapes, dtype tags, checksum."""
    js, tc, tt = _reference_state(name)
    JCK.save_checkpoint(str(tmp_path / "j"), 2, js)
    TCK.save_checkpoint(str(tmp_path / "t"), 2, _bridged(js, tc, tt))
    want = _manifest(tmp_path / "j", 2)
    assert _manifest(tmp_path / "t", 2) == want
    leaves = json.loads(want)["leaves"]
    assert leaves[".rng"] == {"shape": [2], "dtype": "uint32"}
    assert leaves[".step"] == leaves[".opt/.step"] == {"shape": [], "dtype": "int32"}
    if name == "lm":
        assert len(leaves) == 39
        assert leaves[".params/embed/embedding"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "j" / "step_00000002" / "leaves.npz") as a, \
            np.load(tmp_path / "t" / "step_00000002" / "leaves.npz") as b:
        assert a.files == b.files
        for n in a.files:
            assert a[n].dtype == b[n].dtype and np.array_equal(a[n], b[n])


def test_port_roundtrip_on_its_own_init(tmp_path):
    """The port's own state (bf16 parameters, int counters, a key pair)
    through save and load, requires_grad kept on the parameters."""
    _, tc, _, tt, _ = _case("lm")
    ts = t_init_train_state(3, tc, tt, device="cpu")
    TCK.save_checkpoint(str(tmp_path), 0, ts)
    got = TCK.load_checkpoint(str(tmp_path), 0, t_init_train_state(4, tc, tt, device="cpu"))
    _assert_port_states_equal(got, ts)
    assert all(p.requires_grad for p in tree_leaves(got.params))


def test_latest_step_keep3_and_tmp_ignored(tmp_path):
    """``keep=3`` garbage collection after async saves, as the reference's
    manager leaves the same directory; a leftover ``.tmp_step_*`` is never
    a checkpoint, and a save over it replaces it."""
    assert TCK.latest_step(str(tmp_path / "none")) is None
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "n": 5}
    jtree = {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3), "n": jnp.asarray(5, jnp.int32)}
    listings = []
    for pkg, t, d in ((TCK, tree, tmp_path / "t"), (JCK, jtree, tmp_path / "j")):
        mgr = pkg.CheckpointManager(str(d), keep=3)
        for s in range(1, 6):
            mgr.save_async(s, t)
        mgr.wait()
        listings.append(sorted(os.listdir(d)))
        os.makedirs(d / ".tmp_step_00000009")
        assert pkg.latest_step(str(d)) == 5
    assert listings[0] == listings[1] == ["step_00000003", "step_00000004", "step_00000005"]
    (tmp_path / "t" / ".tmp_step_00000009" / "junk").write_text("partial")
    TCK.save_checkpoint(str(tmp_path / "t"), 9, tree)
    assert sorted(os.listdir(tmp_path / "t"))[-1] == "step_00000009"
    assert not (tmp_path / "t" / ".tmp_step_00000009").exists()
    got = TCK.load_checkpoint(str(tmp_path / "t"), 9, {"w": torch.zeros(2, 3), "n": 0})
    assert torch.equal(got["w"], tree["w"]) and got["n"] == 5


def test_save_async_copies_before_returning(tmp_path):
    """The training step overwrites parameters and moments in place right
    after ``save_async`` returns: the checkpoint must hold the values of the
    call, and the manager records the gather, the write and the bytes."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    mgr = TCK.CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    got = TCK.load_checkpoint(str(tmp_path), 1, {"w": torch.zeros_like(w)})
    assert torch.equal(got["w"], torch.arange(1 << 16, dtype=torch.float32))
    rec = mgr.saves[0]
    assert rec["step"] == 1 and rec["gather_s"] >= 0 and rec["write_s"] > 0
    assert rec["bytes"] > 4 << 16


SERVE_ARGS = ["--arch", "stablelm-3b", "--smoke", "--device", "cpu", "--requests", "3",
              "--new-tokens", "6", "--max-len", "64"]


def test_serve_reads_params_only_checkpoint(tmp_path, capsys, monkeypatch):
    """A params-only checkpoint written by the port (the smoke config's
    bf16 weights): the reference reads it bit for bit, and ``serve.py
    --ckpt-dir`` serves what the same parameters serve directly."""
    from repro_torch.launch import serve as LS

    jc, tc = j_smoke("stablelm-3b"), t_smoke("stablelm-3b")
    jp = j_model_fns(jc).init(jax.random.PRNGKey(5), jc)
    tp = params_from_numpy(_np(jp), tc, "cpu")
    TCK.save_checkpoint(str(tmp_path), 4, tp)
    got = JCK.load_checkpoint(str(tmp_path), 4, jax.eval_shape(lambda: jp))
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(jp), strict=True):
        assert x.dtype == y.dtype
        assert np.array_equal(np.asarray(x.astype(jnp.float32)), np.asarray(y.astype(jnp.float32)))
    served = LS.main([*SERVE_ARGS, "--ckpt-dir", str(tmp_path)])
    assert "loaded checkpoint step 4" in capsys.readouterr().out
    model_fns = LS.get_model_fns
    monkeypatch.setattr(LS, "get_model_fns", lambda cfg: model_fns(cfg)._replace(
        init=lambda seed, c, device=None: tp))
    assert LS.main(SERVE_ARGS) == served and sum(map(len, served)) == 18


def test_serve_keyerror_on_a_loop_checkpoint_in_both(tmp_path, monkeypatch):
    """The reference's quirk, kept: ``serve.py --ckpt-dir`` looks up
    params-only names (``embed/embedding``), so a training loop's
    checkpoint (``.params/embed/embedding``) raises ``KeyError`` in both
    launchers."""
    from repro.launch import serve as JS
    from repro_torch.launch import serve as LS

    js, tc, tt = _reference_state("lm")
    JCK.save_checkpoint(str(tmp_path), 2, js)
    with pytest.raises(KeyError, match="embed/embedding"):
        LS.main([*SERVE_ARGS, "--ckpt-dir", str(tmp_path)])
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "stablelm-3b", "--smoke",
                                     "--ckpt-dir", str(tmp_path)])
    with pytest.raises(KeyError, match="embed/embedding"):
        JS.main()


def test_load_into_a_tree_of_other_shapes_raises(tmp_path):
    """A checkpoint of one width restored into a tree of another (the FCNN
    example's --small run, then its full-width one) raises instead of
    handing back the checkpoint's shapes."""
    TCK.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(784, 128), "n": 3})
    with pytest.raises(ValueError, match="shape"):
        TCK.load_checkpoint(str(tmp_path), 1, {"w": torch.zeros(784, 500), "n": 0})
    got = TCK.load_checkpoint(str(tmp_path), 1, {"w": torch.ones(784, 128), "n": 0})
    assert got["w"].shape == (784, 128) and not got["w"].any() and got["n"] == 3
