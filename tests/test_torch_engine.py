"""The port's serving engine against ``repro.serving.ServingEngine``.

Both engines serve the same shared-prefix trace at f32 with chunked
prefill on, from the same (bridged) parameters: cold prompts, partial-
prefix hits that prefill only their suffix, full hits that skip prefill
(one of them forking a shared unaligned boundary block copy-on-write),
and unrelated prompts that queue for slots.  The greedy token streams
must be byte-identical.  Because the two packages agree to rounding
(~2e-6 on logits here), the test also replays every stream through the
port's model and checks that each emitted token won by a top-1/top-2
logit margin far above that, so no near-tie decides the outcome.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as JTF
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as TTF
from repro_torch.models.transformer import init_lm
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.scheduler import left_pad

SERVE = dict(
    max_batch=4, max_new_tokens=6, max_len=64, kv_block_size=8,
    prefill_chunk=16, prefill_buckets=(12, 16, 32, 36, 48),
)
MIN_MARGIN = 1e-3  # 500x the observed f32 disagreement of the packages


def _trace():
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, 24).tolist()
    y = rng.integers(0, 256, 12).tolist()            # one chunk, bucket 12
    x = rng.integers(0, 256, 32).tolist()            # block-aligned bucket 32
    a = prefix + rng.integers(0, 256, 12).tolist()   # bucket 36, three chunks
    return [
        y,  # cold
        y,  # full hit in the same tick; both write into the shared
            # unaligned boundary block, so this one forks copy-on-write
        x,                                            # cold
        a,                                            # cold
        prefix + rng.integers(0, 256, 12).tolist(),   # partial hit, queues
        x,                                            # full hit, queues
        rng.integers(0, 256, 5).tolist(),             # unrelated, queues
        prefix + rng.integers(0, 256, 12).tolist(),   # partial hit, queues
        rng.integers(0, 256, 40).tolist(),            # unrelated, queues
    ]


def _replay_margins(tp, tcfg, prompt, bucket, out):
    """Teacher-force one stream through the port's model alone; return the
    top-1/top-2 logit margin at every emitted token."""
    bs, n_blocks = SERVE["kv_block_size"], SERVE["max_len"] // SERVE["kv_block_size"]
    cache = TTF.init_paged_decode_cache(tcfg, 1, n_blocks + 1, bs, device="cpu")
    row = torch.arange(1, n_blocks + 1, dtype=torch.int32)
    toks = torch.tensor([left_pad(prompt, bucket)], dtype=torch.int32)
    _, _, logits = TTF.lm_prefill_chunk(
        tp, toks, tcfg, cache, TTF.init_prefill_state(tcfg, "cpu"), row, 0
    )
    cache["pos"] = torch.tensor([bucket], dtype=torch.int32)
    margins = []
    for i, t in enumerate(out):
        top2 = torch.topk(logits[0], 2).values
        assert int(torch.argmax(logits[0])) == t
        margins.append(float(top2[0] - top2[1]))
        if i + 1 < len(out):
            cache, logits = TTF.lm_decode_step(
                tp, cache, torch.tensor([t], dtype=torch.int32), tcfg, row[None]
            )
    return margins


def test_greedy_streams_byte_identical_to_reference():
    jcfg = dataclasses.replace(jax_smoke("stablelm-3b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32")
    jp = JTF.init_lm(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    prompts = _trace()
    j_eng = JServingEngine(jp, jcfg, JServeConfig(**SERVE))
    t_eng = ServingEngine(tp, tcfg, ServeConfig(**SERVE), device="cpu")
    for p in prompts:
        j_eng.submit(p)
        t_eng.submit(p)
    j_out, t_out = j_eng.run(), t_eng.run()
    assert t_out == j_out
    assert sorted(t_out) == list(range(len(prompts)))
    m = t_eng.metrics()
    assert m.prefix_hits >= 2 and m.prefix_partial_hits >= 2 and m.cow_forks >= 1
    assert m.evictions == {"length": len(prompts)}
    for field in ("prefix_hits", "prefix_partial_hits", "cow_forks",
                  "prefill_tokens", "prefill_tokens_saved", "decode_steps"):
        assert getattr(m, field) == getattr(j_eng.metrics(), field), field
    for rid, p in enumerate(prompts):
        bucket = t_eng._bucket(len(p))
        assert min(_replay_margins(tp, tcfg, p, bucket, t_out[rid])) > MIN_MARGIN


def test_entry_points_refuse_to_run_silently_on_the_cpu():
    """Without a card, every entry point that defaults to the card raises;
    only an explicit device='cpu' runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config("stablelm-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TTF.init_paged_decode_cache(cfg, 2, 8, 16)
    params = init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg, ServeConfig())


def test_unported_knobs_are_refused():
    """Knobs the reference has and the port does not (the dense layout) are
    not fields of ``ServeConfig``; WTA sampling, int8 pools, degraded
    serving and speculation are served (``tests/test_torch_wta.py``,
    ``tests/test_torch_int8.py``, ``tests/test_torch_degraded.py``,
    ``tests/test_torch_spec.py``)."""
    cfg = get_smoke_config("stablelm-3b")
    params = init_lm(cfg, device="cpu")
    eng = ServingEngine(params, dataclasses.replace(cfg, wta_head=True),
                        ServeConfig(max_len=32), device="cpu")
    rid = eng.submit([1, 2, 3], 2)
    assert len(eng.run()[rid]) == 2
    with pytest.raises(TypeError):
        ServeConfig(kv_layout="dense")


def test_serve_step_sanity_codes():
    """The decode step flags non-finite rows, saturated rows and, with a
    positive entropy floor, collapsed distributions (``SANE_*`` codes)."""
    from repro_torch.launch import specs as SP

    cfg = get_smoke_config("stablelm-3b")
    table = torch.tensor([[1], [2]], dtype=torch.int32)
    token = torch.tensor([3, 4], dtype=torch.int32)

    def codes(params, **kw):
        cache = TTF.init_paged_decode_cache(cfg, 2, 3, 16, device="cpu")
        _, tok, sane = SP.make_paged_serve_step(cfg, **kw)(params, cache, table, token)
        assert tok.dtype == torch.int32 and tok.shape == (2,)
        return sane.tolist()

    params = init_lm(cfg, device="cpu")
    assert codes(params) == [SP.SANE_OK, SP.SANE_OK]
    assert codes(params, entropy_floor=100.0) == [SP.SANE_ENTROPY_COLLAPSE] * 2
    assert codes(params, sat_threshold=1e-3) == [SP.SANE_SATURATED] * 2
    params["embed"]["embedding"][4] = float("nan")
    assert codes(params) == [SP.SANE_OK, SP.SANE_NAN]
