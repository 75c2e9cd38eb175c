"""The port's other decoder-only configs against ``repro`` on the CPU:
``gemma2-2b`` (local + global units of two attention sublayers, both
soft-caps, post-block norms, tied and scaled embeddings),
``deepseek-coder-33b`` (GQA 56 / 8, RoPE base 1e5),
``nemotron-4-340b`` (GQA, squared-ReLU MLP), and the mixtures of experts
``granite-moe-3b-a800m`` (40 SwiGLU experts, top-8, Dh 64) and
``grok-1-314b`` (8 GeGLU experts, top-2, attention soft-cap 30), and
``llava-next-34b`` (the ``vlm`` family; its patch prefix is
``tests/test_torch_vlm.py``'s: here it runs as a token LM).

Each arch's full and smoke configs equal the reference's field for field;
the smoke loss of bridged f32 weights equals the reference's within
``LOSS_ATOL`` (both packages sum the same f32 products in another order),
and so does an MoE model's load-balancing ``aux`` (0 for a dense one);
and the port's own prefill + decode logits, over the dense cache and over
the paged pool, equal its ``lm_forward`` within ``LOGIT_ATOL`` (the
decode readouts sum in another order than ``attend_full``; on the paged
path the suffix chunk and the decode step run the kernels' plain
versions; the MoE smoke configs' capacity factors drop no token, so a
prefill, a chunk and a decode step route as the forward does).
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
from repro.models import transformer as JTF
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import SHAPES, get_config, get_smoke_config, skip_shapes
from repro_torch.models import transformer as TTF

ARCHS = ["gemma2-2b", "deepseek-coder-33b", "nemotron-4-340b", "granite-moe-3b-a800m",
         "grok-1-314b", "llava-next-34b"]
LOSS_ATOL = 1e-5
LOGIT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small PyTorch ops, run beside other test
    files on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32_pair(arch: str):
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jax.jit(JTF.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    for t, j in ((get_config(arch), jax_config(arch)),
                 (get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count() and t.n_units == j.n_units
    assert skip_shapes(arch) == jax_skip_shapes(arch)
    from repro.configs import SHAPES as JSHAPES

    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """The port's own init has the reference's leaves, shapes and dtypes,
    ``post_ln1`` / ``post_ln2`` included where the config asks for them;
    the bridge carries every leaf over unchanged."""
    cfg = get_smoke_config(arch)
    tp = TTF.init_lm(cfg, seed=0, device="cpu")
    jp = jax.eval_shape(lambda: JTF.init_lm(jax.random.PRNGKey(0), jax_smoke(arch)))
    flat_t = {"/".join(k): v for k, v in _flatten(tp)}
    flat_j = {"/".join(k): v for k, v in _flatten(jp)}
    assert sorted(flat_t) == sorted(flat_j)
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == tuple(v.shape), k
        assert str(flat_t[k].dtype).split(".")[-1] == str(v.dtype), k
    assert any("post_ln" in k for k in flat_t) == cfg.post_norms
    assert any("/moe/" in k for k in flat_t) == (cfg.n_experts > 0)
    assert any("/ffn/" in k for k in flat_t) == (cfg.n_experts == 0)
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(np.float32), jp)
    bridged = {"/".join(k): v for k, v in _flatten(params_from_numpy(tree, cfg, device="cpu"))}
    for k, v in _flatten(tree):
        np.testing.assert_array_equal(bridged["/".join(k)].float().numpy(),
                                      v.astype(jnp.bfloat16).astype(np.float32)
                                      if bridged["/".join(k)].dtype == torch.bfloat16 else v)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_loss_and_grads_match_reference(arch):
    jcfg, jp, tcfg, tp = _f32_pair(arch)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jm = jax.jit(lambda p, b: JTF.lm_loss(p, b, jcfg, None))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    tl, tm = TTF.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=LOSS_ATOL, rtol=0)
    np.testing.assert_allclose(float(tm["aux"].detach()), float(jm["aux"]), atol=LOSS_ATOL,
                               rtol=0)
    assert (float(jm["aux"]) > 0) == (jcfg.n_experts > 0)
    tl.backward()
    grads = [leaf.grad for _, leaf in _flatten(tp)]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert sum(float(g.square().sum()) for g in grads) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_forward(arch):
    """The port's dense prefill + decode steps, and its chunked paged
    prefill + paged decode steps, against its own full forward: the
    reference's ``test_prefill_decode_match_forward`` for the port, with
    prompts past gemma2's smoke window of 16."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tp = TTF.init_lm(cfg, seed=1, device="cpu")
    b, s, n_dec = 2, 20, 3
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (b, s + n_dec)).astype(np.int64))
    with torch.no_grad():
        full, _ = TTF.lm_forward(tp, toks, cfg)
        cache, lp = TTF.lm_prefill(tp, toks[:, :s], cfg, 32)
        np.testing.assert_allclose(lp.numpy(), full[:, s - 1].numpy(), atol=LOGIT_ATOL, rtol=0)
        for t in range(n_dec):
            cache, ld = TTF.lm_decode_step(tp, cache, toks[:, s + t].int(), cfg)
            np.testing.assert_allclose(ld.numpy(), full[:, s + t].numpy(), atol=LOGIT_ATOL,
                                       rtol=0)
        # paged: each row prefilled in two chunks into its own pages, past
        # the window of 16
        bs, wp = 8, 4
        pool = TTF.init_paged_decode_cache(cfg, b, 1 + b * wp, bs, device="cpu")
        table = torch.arange(1, 1 + b * wp, dtype=torch.int32).reshape(b, wp)
        for r in range(b):
            st = TTF.init_prefill_state(cfg, "cpu")
            for lo, hi in ((0, 16), (16, s)):  # chunks start on a block
                _, st, lp = TTF.lm_prefill_chunk(tp, toks[r:r + 1, lo:hi].int(), cfg, pool, st,
                                                 table[r], lo)
            np.testing.assert_allclose(lp[0].numpy(), full[r, s - 1].numpy(),
                                       atol=LOGIT_ATOL, rtol=0)
        pool["pos"].fill_(s)
        for t in range(n_dec):
            pool, ld = TTF.lm_decode_step(tp, pool, toks[:, s + t].int(), cfg, table)
            np.testing.assert_allclose(ld.numpy(), full[:, s + t].numpy(), atol=LOGIT_ATOL,
                                       rtol=0)
