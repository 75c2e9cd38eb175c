"""The port's vision-language family (``family="vlm"``, llava-next-34b: a
decoder LM with precomputed patch embeddings before the tokens) against
``repro`` on the CPU, at the smoke config (2 layers, d 64, GQA 4 / 2, 8
patches) in f32, on the reference's init (key 0) carried across by
``bridge``.

- ``lm_forward`` / ``lm_loss`` with patches: logits over P + S positions,
  the loss on the text positions; loss and gradients within
  ``LOSS_ATOL`` / ``GRAD_ATOL`` digitally and in ``analog_stochastic``
  (the reference's interpret-mode crossbar, ``use_pallas="on"``; the
  patches' gradient as well);
- ``lm_prefill`` with patches (the dense cache holds P + S rows, ``pos``
  is P + S) and decode steps, against the reference's within
  ``LOGIT_ATOL``, and against the port's own ``lm_forward``;
- ``lm_batch``'s patches: the reference's draw within the normal's ulps;
- the paged engine serves llava as a token LM without patches, as the
  reference's does: streams equal the reference engine's;
- ``launch.train --arch llava-next-34b --smoke`` trains on patches.

Both packages sum the same f32 products in another order: a few ulps of
the sums (the tolerances of ``tests/test_torch_archs.py``).
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

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core.analog import AnalogConfig as JAnalog
from repro.core.physics import DeviceParams as JDevice
from repro.core.physics import calibrate_v_read as j_calibrate
from repro.data import lm_batch as j_lm_batch
from repro.models import get_model_fns as j_model_fns
from repro.models import transformer as JTF
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.analog import AnalogConfig as TAnalog
from repro_torch.core.physics import DeviceParams as TDevice
from repro_torch.core.physics import calibrate_v_read as t_calibrate
from repro_torch.data import lm_batch
from repro_torch.models import get_model_fns
from repro_torch.models import transformer as TTF
from repro_torch.optim import tree_leaves
from repro_torch.serving import ServeConfig, ServingEngine

ARCH = "llava-next-34b"
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-5
LOGIT_ATOL = 1e-4
B, S, P = 2, 12, 8
SERVE = dict(max_batch=2, max_new_tokens=8, max_len=64, kv_block_size=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(mode: str = "digital"):
    jc = dataclasses.replace(jax_smoke(ARCH), dtype="float32")
    tc = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
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
def weights():
    jc, tc = _cfgs()
    jp = jax.jit(JTF.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jc)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    """Patches (B, P, d) at std 1 and tokens (B, S + 1), from numpy."""
    rng = np.random.default_rng(0)
    patches = rng.standard_normal((B, P, 64)).astype(np.float32)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    return patches, toks


def test_forward_with_patches_matches_reference(weights, inputs):
    """Logits over P + S positions; with no patches the forward is the
    plain token LM's."""
    jc, tc = _cfgs()
    jp, tp = weights
    patches, toks = inputs
    jl, _ = jax.jit(JTF.lm_forward, static_argnums=2)(jp, jnp.asarray(toks), jc, None,
                                                      jnp.asarray(patches))
    with torch.no_grad():
        tl, _ = TTF.lm_forward(tp, torch.from_numpy(toks).long(), tc, None, _t(patches))
        plain, _ = TTF.lm_forward(tp, torch.from_numpy(toks).long(), tc)
    assert tuple(tl.shape) == (B, P + S + 1, 256) and tuple(plain.shape) == (B, S + 1, 256)
    _close(tl.numpy(), jl, LOGIT_ATOL)
    assert np.abs(tl[:, P:].numpy() - plain.numpy()).max() > 10 * LOGIT_ATOL


@pytest.mark.parametrize("mode", ["digital", "analog_stochastic"])
def test_loss_and_gradients_with_patches_match_reference(weights, inputs, mode):
    """``lm_loss`` on the text positions: the loss, every parameter's
    gradient and the patches' gradient, against the reference's."""
    jc, tc = _cfgs(mode)
    jp, _ = weights
    patches, toks = inputs
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "patches": patches}
    key = None if mode == "digital" else jax.random.PRNGKey(2)

    def jloss(p, pa):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        return JTF.lm_loss(p, dict(jb, patches=pa), jc, key)[0]

    jl, (jg, jgp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(patches))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    leaves = tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tpatch = _t(patches).requires_grad_(True)
    tbatch = {"tokens": torch.from_numpy(batch["tokens"]),
              "labels": torch.from_numpy(batch["labels"]), "patches": tpatch}
    tl, _ = TTF.lm_loss(tp, tbatch, tc, None if key is None else _key_pair(key))
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_ATOL
    grads = torch.autograd.grad(tl, leaves + [tpatch])
    for a, b in zip(jax.tree.leaves(jg) + [jgp], grads, strict=True):
        _close(b.numpy(), a, GRAD_ATOL)


def test_prefill_with_patches_and_decode_match_reference(weights, inputs):
    """``get_model_fns(cfg).prefill`` with ``patches`` into a dense cache,
    then decode steps: the reference's prefill and steps, and the port's
    own ``lm_forward`` with the prefix."""
    jc, tc = _cfgs()
    jp, tp = weights
    patches, toks = inputs
    s0 = S - 2
    jfns, tfns = j_model_fns(jc), get_model_fns(tc)
    jcache, jlp = jfns.prefill(jp, {"tokens": jnp.asarray(toks[:, :s0]),
                                    "patches": jnp.asarray(patches)}, jc, 32)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        full, _ = TTF.lm_forward(tp, tt.long(), tc, None, _t(patches))
        tcache, tlp = tfns.prefill(tp, {"tokens": tt[:, :s0], "patches": _t(patches)}, tc, 32)
        assert tcache["pos"].tolist() == [P + s0] * B
        _close(tlp.numpy(), jlp, LOGIT_ATOL)
        _close(tlp.numpy(), full[:, P + s0 - 1].numpy(), LOGIT_ATOL)
        for name in ("k", "v"):
            _close(tcache[name].numpy(), jcache[name], LOGIT_ATOL)
        j_step = jax.jit(jfns.decode_step, static_argnums=3)
        for t in range(s0, S + 1):
            jcache, jld = j_step(jp, jcache, jnp.asarray(toks[:, t]), jc)
            tcache, tld = tfns.decode_step(tp, tcache, tt[:, t], tc)
            _close(tld.numpy(), jld, LOGIT_ATOL)
            _close(tld.numpy(), full[:, P + t].numpy(), LOGIT_ATOL)
    assert tcache["pos"].tolist() == [P + S + 1] * B


def test_lm_batch_patches_match_reference():
    jc, tc = jax_smoke(ARCH), get_smoke_config(ARCH)
    want = j_lm_batch(jc, batch=2, seq=12, step=3, seed=1)
    got = lm_batch(tc, batch=2, seq=12, step=3, seed=1, device="cpu")
    assert sorted(got) == sorted(want) == ["labels", "patches", "tokens"]
    assert got["patches"].dtype == torch.float32 and tuple(got["patches"].shape) == (2, 8, 64)
    # torch's log1p under the normal's erf_inv: a few ulps from XLA's
    # (tests/test_torch_wta.py's normal criteria)
    g, w = got["patches"].numpy(), np.asarray(want["patches"])
    assert (g == w).mean() >= 0.95
    np.testing.assert_array_max_ulp(g, w, maxulp=8)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def test_paged_engine_streams_equal_reference(weights):
    """The reference's engine serves llava as a token LM (no patches): the
    port's paged engine gives its streams, metrics and compile counts on
    three prompts, chunked prefill past one block."""
    jc, tc = _cfgs()
    jp, tp = weights
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).tolist() for n in (9, 20, 14)]
    j_eng = JServingEngine(jp, jc, JServeConfig(**SERVE, prefill_chunk=8))
    t_eng = ServingEngine(tp, tc, ServeConfig(**SERVE, prefill_chunk=8), device="cpu")
    outs = []
    for eng in (j_eng, t_eng):
        for p in prompts:
            eng.submit(p)
        outs.append(eng.run())
    assert outs[1] == outs[0]
    assert all(len(o) == SERVE["max_new_tokens"] for o in outs[1].values())
    jm, tm = j_eng.metrics(), t_eng.metrics()
    for k in ("completed", "total_tokens", "decode_steps", "prefill_tokens"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert t_eng.compile_counts() == j_eng.compile_counts()


def test_full_config_cut_in_depth():
    """The full config at 8 of 60 layers (the card's cut) keeps every
    width: 5.38 B parameters by its shapes, the reference's count."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=8)
    jcfg = dataclasses.replace(jax_config(ARCH), n_layers=8)
    shapes = jax.eval_shape(lambda: JTF.init_lm(jax.random.PRNGKey(0), jcfg))
    n = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes))
    assert 5.37e9 < n < 5.39e9, n
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_patches) == (
        7168, 56, 8, 128, 576)


def test_train_launcher_smoke(tmp_path):
    """``launch.train --arch llava-next-34b --smoke --device cpu`` for two
    steps on ``lm_batch``'s patches, with a checkpoint."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300, check=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    ).stdout
    assert "done: steps=2" in out, out
