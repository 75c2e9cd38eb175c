"""The port's model against the JAX reference on bridged parameters.

``repro``'s ``init_lm`` tree goes through numpy and ``repro_torch.bridge``
into the port; a two-chunk suffix prefill and three decode steps then run
in both packages from the same tokens and block tables.  On the CPU the
reference's prefill attends through ``attend_full`` while the port takes
the chunked-prefill kernel's plain version, so the two agree to rounding,
not bit for bit.  Tolerances: at f32 1e-5 absolute (observed ~2e-6 on
logits of magnitude ~3); at bf16 0.08 absolute, about five bf16 ulps at
that magnitude, because the packages round intermediate activations to
bf16 at different points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as JTF
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as TTF

ATOL = {"float32": 1e-5, "bfloat16": 0.08}


def bridged(dtype: str):
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype=dtype)
    jp = JTF.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp)
    return jcfg, jp, tcfg, params_from_numpy(tree, tcfg, device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def test_bridge_round_trip_is_lossless():
    jcfg, jp, tcfg, tp = bridged("bfloat16")
    w_j = np.asarray(jp["units"]["l0"]["attn"]["wq"].astype(jnp.float32))
    w_t = tp["units"]["l0"]["attn"]["wq"]
    assert w_t.dtype == torch.bfloat16 and w_t.shape == w_j.shape
    np.testing.assert_array_equal(w_t.float().numpy(), w_j)
    assert tp["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_chunks_and_decode_steps_match_reference(dtype):
    jcfg, jp, tcfg, tp = bridged(dtype)
    bs, n_pages = 16, 12
    toks = np.random.default_rng(0).integers(0, 256, (1, 40)).astype(np.int32)
    row = np.asarray([3, 7, 1, 9], np.int32)
    jc = JTF.init_paged_decode_cache(jcfg, 2, n_pages, bs)
    jpool = {k: jc[k] for k in ("k_pages", "v_pages")}
    jst = JTF.init_prefill_state(jcfg)
    tc = TTF.init_paged_decode_cache(tcfg, 2, n_pages, bs, device="cpu")
    tst = TTF.init_prefill_state(tcfg, "cpu")
    # two chunks: positions 0..31, then a mid-prompt suffix 32..39
    for lo, hi in [(0, 32), (32, 40)]:
        jpool, jst, jl = JTF.lm_prefill_chunk(
            jp, jnp.asarray(toks[:, lo:hi]), jcfg, jpool, jst,
            jnp.asarray(row), jnp.asarray(lo, jnp.int32), 64,
        )
        _, tst, tl = TTF.lm_prefill_chunk(
            tp, torch.from_numpy(toks[:, lo:hi]), tcfg, tc, tst,
            torch.from_numpy(row), lo,
        )
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=ATOL[dtype])
        assert int(tst["pos"][0]) == hi
    np.testing.assert_allclose(
        _f32(tc["k_pages"]), _f32(jpool["k_pages"]), atol=ATOL[dtype]
    )
    # slot 0 decodes over the prefilled row; slot 1 sits on the trash page
    table = np.asarray([[3, 7, 1, 9], [0, 0, 0, 0]], np.int32)
    jcache = dict(jc, **jpool, pos=jnp.asarray([40, 5], jnp.int32))
    tc["pos"] = torch.tensor([40, 5], dtype=torch.int32)
    tok = np.asarray([5, 9], np.int32)
    for _ in range(3):
        jcache, jl = JTF.lm_decode_step(jp, jcache, jnp.asarray(tok), jcfg, jnp.asarray(table))
        tc, tl = TTF.lm_decode_step(tp, tc, torch.from_numpy(tok), tcfg, torch.from_numpy(table))
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=ATOL[dtype])
        tok = _f32(jl).argmax(-1).astype(np.int32)
    assert tc["pos"].tolist() == [43, 8]
