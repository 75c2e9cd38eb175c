"""Sharded serving on the CPU: ``ServeConfig(mesh=...)`` and
``specs.make_sharded_paged_entry_points`` on gloo meshes.

In this process, a one-rank gloo group (``launch.mesh.process_group``)
and its 1 × 1 mesh, held against the port's ``mesh=None`` engine and the
unsharded reference (the reference's own mesh tests fail on the installed
jax, ROADMAP C, so its 1 × 1 contract is held through its unsharded
engine, as ``tests/test_serving.py:1215`` states it: byte identity):

* the mixed trace on stablelm-3b, recurrentgemma-2b, mamba2-1.3b and
  granite-moe-3b-a800m smoke at f32 (the recurrent families with
  ``tests/_block_gain.py``'s weights), streams, counters and
  ``compile_counts()`` equal;
* the speculative round at 1 × 1 (``:1611``), the entry points' compile
  discipline across a rebuild (``:1231``), the mesh refusals (``:1190``),
  the analog tallies (``tests/test_energy_accounting.py:118``) and
  ``bench_sharded_decode`` at 1 × 1.

Then four gloo ranks, spawned once for the module (``tests/_sharded_worker.py``,
one intra-op thread each), serve the reference's distribution trace
(``tests/test_distribution.py:277-330``, stablelm smoke f32) at 1 × 4,
2 × 1 and 2 × 2, the int8 pool (2 × 2, 2 × 1), WTA, speculation, sharing with a
copy-on-write fork, forced preemptions, recurrentgemma-2b at 2 × 1 and
1 × 2, and the bench with every rank on the data axis: each stream equal
to the unsharded engine's, and the 2 × 2 pool admitting more than one
device at the same blocks per device.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _sharded_worker as W
from _block_gain import gained_weights
from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model_fns as jax_fns
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.benchmarks import bench_serving as TBS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as LM
from repro_torch.models.transformer import init_lm
from repro_torch.serving import ServeConfig, ServingEngine

LAYOUT = dict(max_batch=3, max_new_tokens=8, max_len=64, kv_block_size=8)
ARCHS = ["stablelm-3b", "recurrentgemma-2b", "mamba2-1.3b", "granite-moe-3b-a800m"]
# the block gain of the recurrent families' engine tests (tests/_block_gain.py)
GAINED = {"recurrentgemma-2b": (), "mamba2-1.3b": ("d_skip",)}
WORLD = 4
STREAM_CASES = ["trace_1x4", "trace_2x1", "trace_2x2", "int8_2x2", "int8_2x1", "wta_2x2",
                "spec_2x2", "share_2x2", "preempt_2x2", "rg_2x1", "rg_1x2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh11():
    """A 1 × 1 mesh over a one-rank gloo group, for the module."""
    with LM.process_group("cpu"):
        yield LM.make_host_mesh(model=1, data=1, device="cpu")


def _serve(params, cfg, serve_kw, mesh=None, prompts=W.MIXED_PROMPTS, budgets=W.MIXED_BUDGETS):
    eng = ServingEngine(params, cfg, ServeConfig(**serve_kw, mesh=mesh), device="cpu")
    for p, b in zip(prompts, budgets):
        eng.submit(p, b)
    return eng, eng.run()


@pytest.fixture(scope="module")
def weights():
    """(repro's config and tree, the port's config and tree) per arch, f32."""
    out = {}
    for arch in ARCHS:
        jcfg = dataclasses.replace(jax_smoke(arch), dtype="float32")
        tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if arch in GAINED:
            jp, tp = gained_weights(jcfg, tcfg, zero=GAINED[arch])
        else:
            jp = jax_fns(jcfg).init(jax.random.PRNGKey(0), jcfg)
            tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        out[arch] = (jcfg, jp, tcfg, tp)
    return out


COUNTERS = ("completed", "total_tokens", "decode_steps", "prefills", "prefill_tokens",
            "prefix_hits", "prefix_partial_hits", "cow_forks")


@pytest.mark.parametrize("arch", ARCHS)
def test_1x1_mesh_byte_identity(weights, mesh11, arch):
    """A 1 × 1 mesh serves the mixed trace byte-identically to ``mesh=None``
    and to the reference's unsharded engine, with the same counters and
    compiles."""
    jcfg, jp, tcfg, tp = weights[arch]
    base_eng, base = _serve(tp, tcfg, LAYOUT)
    eng, got = _serve(tp, tcfg, LAYOUT, mesh11)
    assert got == base
    j_eng = JServingEngine(jp, jcfg, JServeConfig(**LAYOUT))
    for p, b in zip(W.MIXED_PROMPTS, W.MIXED_BUDGETS):
        j_eng.submit(p, b)
    assert got == j_eng.run()
    assert len(set(map(tuple, got.values()))) > 1   # the streams move
    m, m0 = eng.metrics(), base_eng.metrics()
    assert all(getattr(m, f) == getattr(m0, f) for f in COUNTERS)
    assert eng.compile_counts() == base_eng.compile_counts()


def test_spec_1x1_mesh_byte_identity(weights, mesh11):
    """The sharded speculative round and rollback at 1 × 1 give the
    unsharded round's streams."""
    _, _, tcfg, tp = weights["stablelm-3b"]
    kw = dict(LAYOUT, speculate_k=4)
    base_eng, base = _serve(tp, tcfg, kw)
    eng, got = _serve(tp, tcfg, kw, mesh11)
    assert got == base
    assert eng.metrics().spec_rounds == base_eng.metrics().spec_rounds > 0


def test_sharded_recompile_guard(weights, mesh11):
    """The mesh's entry points keep the unsharded compile discipline: one
    suffix prefill per bucket, one state insert, a few decode widths,
    nothing new on a repeated trace; a rebuild drops the entries and the
    same trace builds them again."""
    _, _, tcfg, tp = weights["stablelm-3b"]
    eng, _ = _serve(tp, tcfg, LAYOUT, mesh11)
    counts = eng.compile_counts()
    assert counts["suffix_prefill"] == len({eng._bucket(len(p)) for p in W.MIXED_PROMPTS})
    assert counts["state_insert"] == 1
    assert 1 <= counts["serve_step"] <= 4
    for p, b in zip(W.MIXED_PROMPTS, W.MIXED_BUDGETS):
        eng.submit(p, b)
    eng.run()
    assert eng.compile_counts() == counts
    eng._build_entry_points()
    assert eng.compile_counts()["serve_step"] == 0
    for p, b in zip(W.MIXED_PROMPTS, W.MIXED_BUDGETS):
        eng.submit(p, b)
    eng.run()
    assert eng.compile_counts() == counts


def test_mesh_validation_is_loud(weights, mesh11):
    _, _, tcfg, tp = weights["stablelm-3b"]
    with pytest.raises(ValueError, match="paged-layout knob"):
        ServingEngine(tp, tcfg, ServeConfig(max_batch=1, max_new_tokens=2, max_len=32,
                                            kv_layout="dense", mesh=mesh11), device="cpu")
    bad = torch.distributed.device_mesh.DeviceMesh("cpu", [0], mesh_dim_names=("x",))
    for mesh in (bad, object()):
        with pytest.raises(ValueError, match=r"\('data', 'model'\) axes"):
            ServingEngine(tp, tcfg, ServeConfig(max_batch=1, max_new_tokens=2, max_len=32,
                                                mesh=mesh), device="cpu")


def test_counts_invariant_to_1x1_mesh(weights, mesh11):
    """A 1 × 1 mesh computes the same tokens, so its analog tallies are
    the unsharded engine's."""
    _, _, tcfg, tp = weights["stablelm-3b"]
    plain, _ = _serve(tp, tcfg, LAYOUT)
    meshed, _ = _serve(tp, tcfg, LAYOUT, mesh11)
    a, b = plain.metrics().analog, meshed.metrics().analog
    assert a["counts"] == b["counts"] and a["counts"]
    assert a["tokens_computed"] == b["tokens_computed"]


def test_bench_sharded_decode_1x1(mesh11):
    """The bench's section on the open one-rank group: a 1 × 1 mesh with
    the reference's keys, identical streams and a capacity ratio of 1."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), n_layers=2)
    out = TBS.bench_sharded_decode(cfg, init_lm(cfg, seed=0, device="cpu"), n_req=4)
    TBS._check_sharded({"sharded_decode": out})
    assert set(out) == TBS._SHARDED_KEYS
    assert out["mesh"] == {"data": 1, "model": 1} and out["devices"] == 1
    assert out["capacity_ratio"] == 1.0 and out["admitted_single"] == out["admitted_sharded"]


# ---------------------------------------------------------------------------
# Four gloo ranks, spawned once.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Each rank's record of the worker's cases (``tests/_sharded_worker.py``)."""
    out = tmp_path_factory.mktemp("gloo")
    mp.spawn(W.serve, args=(WORLD, str(out / "store"), str(out)), nprocs=WORLD, join=True)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return ranks


@pytest.mark.parametrize("name", STREAM_CASES)
def test_gloo_streams_equal_unsharded(gloo, name):
    """Every rank of the mesh saw the unsharded engine's streams and
    counters; the ranks past a smaller mesh sat it out."""
    d, m = (int(n) for n in name.rsplit("_", 1)[1].split("x"))
    ran = [res[name] for res in gloo if name in res]
    assert len(ran) == d * m
    assert all(name not in res for res in gloo[d * m:])
    for rec in ran:
        assert rec["sharded"]["streams"] == rec["base"]["streams"]
        assert rec["sharded"]["counts"] == rec["base"]["counts"]
        assert rec["sharded"]["streams"] == ran[0]["sharded"]["streams"]
    assert sum(len(s) for s in ran[0]["base"]["streams"].values()) > 0


def test_gloo_paths_were_taken(gloo):
    """The cases reached what they are there for: copy-on-write and hits
    across shards, spills and restores, speculative rounds, and the
    recurrent state split over data, then over model."""
    res = gloo[0]
    share = res["share_2x2"]["sharded"]["counts"]
    assert share["cow_forks"] >= 1 and share["prefix_hits"] >= 1
    assert share["prefix_partial_hits"] >= 1
    pre = res["preempt_2x2"]["sharded"]["counts"]
    assert pre["preemptions"] == pre["restores"] == 2
    assert res["spec_2x2"]["sharded"]["counts"]["spec_rounds"] > 0
    split = {name: res[name]["sharded"]["split"] for name in STREAM_CASES}
    # the default pool is odd: the trace cases split the slots alone
    assert not any(split[f"trace_{s}"]["pages"] for s in ("2x1", "2x2"))
    assert split["trace_2x2"]["slots"] and split["trace_2x2"]["heads"]
    assert split["trace_1x4"]["heads"] and not split["trace_1x4"]["slots"]
    for name in ("wta_2x2", "spec_2x2", "share_2x2", "preempt_2x2"):
        assert split[name]["slots"] and split[name]["pages"] and split[name]["heads"], name
    # an int8 pool holds 2·num_kv_blocks − 1 pages: odd, whole on each data
    # rank; its kv heads split, so its codes go through the whole-row
    # quantization and this rank's heads
    assert split["int8_2x2"]["slots"] and split["int8_2x2"]["heads"]
    assert not split["int8_2x2"]["pages"]
    dx = split["rg_2x1"]
    assert dx["slots"] and dx["pages"] and not dx["heads"]   # one kv head
    mx = split["rg_1x2"]
    assert not mx["slots"] and mx["model_dim"]["rec_h"] == 3 and mx["model_dim"]["rec_conv"] == 4


def test_gloo_capacity_scales_with_data(gloo):
    """At 8 blocks a device, the 2 × 2 mesh's 16-block pool admits more
    requests on the first tick than one device's 8."""
    for res in gloo:
        cap = res["capacity"]
        assert cap["sharded"] > cap["single"] > 0
        assert cap == gloo[0]["capacity"]


def test_gloo_bench_sharded_decode(gloo):
    """``bench_sharded_decode`` with the four ranks on the data axis:
    identical streams, capacity four times the pages."""
    for res in gloo:
        out = res["bench"]
        TBS._check_sharded({"sharded_decode": out})
        assert out["mesh"] == {"data": WORLD, "model": 1}
        assert out["admitted_sharded"] > out["admitted_single"]
        assert out["capacity_ratio"] > 1.0


def test_gloo_mesh_refuses_deadlines(gloo):
    for res in gloo:
        assert "takes no deadlines" in res["deadline"]
