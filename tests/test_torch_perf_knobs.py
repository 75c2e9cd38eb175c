"""The head-layout knobs of the port's ``attend_full`` against the
reference (``tests/test_perf_knobs.py:41``): ``attn_pad_heads``,
``gqa_repeat_kv``, both, and ``attn_kv_chunk`` are the identity on the
deepseek smoke config in f32 (H 4 over Hkv 2), so the forward with each
knob equals the port's knob-free forward and the reference's
``lm_forward`` with the same knob, within the reference test's
tolerance."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model_fns as jax_fns
from repro.models import transformer as JTF
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as TTF

ATOL, RTOL = 5e-5, 1e-4   # the reference test's
KNOBS = [
    {"attn_pad_heads": 8},
    {"gqa_repeat_kv": True},
    {"attn_pad_heads": 8, "gqa_repeat_kv": True},
    {"attn_kv_chunk": 4},
]


@pytest.fixture(scope="module")
def gqa_setup():
    jcfg = dataclasses.replace(jax_smoke("deepseek-coder-33b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("deepseek-coder-33b"), dtype="float32")
    jp = jax_fns(jcfg).init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 12)).astype(np.int32)
    with torch.no_grad():
        ref, _ = TTF.lm_forward(tp, torch.from_numpy(toks), tcfg)
    return jcfg, tcfg, jp, tp, toks, ref


def test_knobs_change_the_head_layout(gqa_setup):
    """The smoke config is grouped (so the repeat has work to do) and has
    fewer than 8 heads (so the padding does)."""
    _, tcfg, *_ = gqa_setup
    assert tcfg.n_kv_heads < tcfg.n_heads < 8


@pytest.mark.parametrize("kw", KNOBS, ids=lambda kw: "+".join(kw))
def test_knob_is_identity(gqa_setup, kw):
    jcfg0, tcfg0, jp, tp, toks, ref = gqa_setup
    tcfg = dataclasses.replace(tcfg0, **kw)
    with torch.no_grad():
        got, _ = TTF.lm_forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
    want, _ = JTF.lm_forward(jp, jax.numpy.asarray(toks), dataclasses.replace(jcfg0, **kw), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
