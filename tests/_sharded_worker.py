"""The gloo ranks of ``tests/test_torch_sharded_serving.py``: every rank
runs this module's :func:`serve` on the same traces (SPMD, as the serving
mesh wants it) and writes what it saw to ``rank{r}.json``.

Each case serves a trace through the port's unsharded engine and through
the engine on a ``(data, model)`` mesh laid over the first ranks of the
group (the others sit it out), on the CPU at f32, and records both
streams.  The cases:

* ``trace_1x4`` / ``trace_2x1`` / ``trace_2x2``: stablelm-3b smoke on
  ``tests/test_distribution.py:277-330``'s trace (B = 2, blocks of 8);
* ``capacity``: admissions on the first tick at 8 blocks unsharded and
  at 16 blocks on the 2 × 2 mesh (the same blocks per device);
* ``rg_2x1`` / ``rg_1x2``: recurrentgemma-2b smoke (block outputs × 8, as
  its engine tests serve it) on the mixed trace, its ``rec_conv`` /
  ``rec_h`` split over data, then over model;
* ``int8_2x2``, ``wta_2x2``, ``spec_2x2`` (k = 3): the int8 pool, WTA
  sampling and self-speculation on the 2 × 2 mesh; ``int8_2x1``: the
  int8 pool's fused write of every slot's rows (kv heads whole);
* ``share_2x2``: the shared-prefix trace of ``tests/test_torch_engine.py``
  (full and partial hits, a copy-on-write fork across shards);
* ``preempt_2x2``: two forced preemptions (spill and restore of pages
  that live on other ranks);
* ``bench``: ``bench_sharded_decode`` with every rank on the data axis;
* ``deadline``: a wider mesh refuses ``deadline_ms``.
"""

import dataclasses
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

TRACE = [[163, 131, 69, 79, 11, 20, 5, 45], [166, 233, 129, 155, 248, 187, 162, 139],
         [239, 71, 209, 172, 1, 101], [142, 9, 196, 187, 216, 45, 23, 221]]
TRACE_SERVE = dict(max_batch=2, max_new_tokens=8, max_len=64, kv_layout="paged",
                   kv_block_size=8)
MIXED_PROMPTS = [[5, 6, 7, 1, 2, 3, 4, 9], [1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2], [4] * 20,
                 [11, 12], [7] * 13]
MIXED_BUDGETS = [6, 9, 3, 12, 5, 7]
# an even pool, so that the data axis splits the pages (the default pool,
# a page per block of every slot plus the trash page, is odd: the trace
# cases keep it, and split the slots alone)
MIXED_SERVE = dict(max_batch=4, max_new_tokens=8, max_len=64, kv_block_size=8,
                   num_kv_blocks=32)
SHARE_SERVE = dict(max_batch=4, max_new_tokens=6, max_len=64, kv_block_size=8,
                   prefill_chunk=16, prefill_buckets=(12, 16, 32, 36, 48), num_kv_blocks=32)
PREEMPT_SERVE = dict(max_batch=2, max_new_tokens=10, max_len=64, kv_block_size=8,
                     prefill_buckets=(16,), num_kv_blocks=16)


def share_trace() -> list:
    """``tests/test_torch_engine.py``'s shared-prefix trace."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 256, 24).tolist()
    y = rng.integers(0, 256, 12).tolist()
    x = rng.integers(0, 256, 32).tolist()
    a = prefix + rng.integers(0, 256, 12).tolist()
    return [y, y, x, a, prefix + rng.integers(0, 256, 12).tolist(), x,
            rng.integers(0, 256, 5).tolist(), prefix + rng.integers(0, 256, 12).tolist(),
            rng.integers(0, 256, 40).tolist()]


def serve(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    res: dict = {}
    try:
        _cases(res)
    except Exception:   # recorded for the test to show; the rank still ends
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def _cases(res: dict) -> None:
    from repro_torch.benchmarks import bench_serving as TBS
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import specs as SP
    from repro_torch.models.transformer import init_lm, scale_block_outputs
    from repro_torch.serving import FaultInjector, RequestState, ServeConfig, ServingEngine

    meshes = {(d, m): LM.make_host_mesh(model=m, data=d, device="cpu")
              for d, m in ((1, 4), (2, 1), (1, 2), (2, 2))}

    def on(shape):
        return meshes[shape] if LM.in_mesh(meshes[shape]) else None

    def serve_trace(params, cfg, serve_kw, prompts, budgets=None, mesh=None, injector=None):
        eng = ServingEngine(params, cfg, ServeConfig(**serve_kw, mesh=mesh,
                                                     fault_injector=injector), device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(list(p), None if budgets is None else budgets[i])
        out = eng.run()
        m = eng.metrics()
        rec = {"streams": {str(k): v for k, v in sorted(out.items())},
               "counts": {k: getattr(m, k) for k in (
                   "decode_steps", "prefix_hits", "prefix_partial_hits", "cow_forks",
                   "preemptions", "restores", "spec_rounds")}}
        if mesh is not None:
            ms = SP.MeshSlots(mesh, eng._shardings["cache"], eng.cfg.max_batch)
            rec["split"] = {"slots": ms.ps.slots, "pages": ms.ps.pages, "heads": ms.ps.heads,
                            "model_dim": ms.model_dim}
        return rec

    def case(name, params, cfg, serve_kw, prompts, budgets=None, shape=(2, 2), inject=None):
        mesh = on(shape)
        if mesh is None:
            return
        base = serve_trace(params, cfg, serve_kw, prompts, budgets,
                           injector=inject() if inject else None)
        got = serve_trace(params, cfg, serve_kw, prompts, budgets, mesh,
                          injector=inject() if inject else None)
        res[name] = {"base": base, "sharded": got}

    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"), dtype="float32")
    params = init_lm(cfg, seed=0, device="cpu")
    for shape in ((1, 4), (2, 1), (2, 2)):
        case(f"trace_{shape[0]}x{shape[1]}", params, cfg, TRACE_SERVE, TRACE, shape=shape)

    def admitted(mesh, blocks):
        eng = ServingEngine(params, cfg, ServeConfig(
            **dict(TRACE_SERVE, max_batch=16), num_kv_blocks=blocks,
            enable_prefix_sharing=False, mesh=mesh), device="cpu")
        for _ in range(16):
            eng.submit([1, 2, 3], 8)
        eng.tick()
        return sum(1 for r in eng.sched.all_requests() if r.state is not RequestState.QUEUED)

    res["capacity"] = {"single": admitted(None, 8), "sharded": admitted(on((2, 2)), 16)}

    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    case("int8_2x2", params, int8, MIXED_SERVE, MIXED_PROMPTS, MIXED_BUDGETS)
    case("int8_2x1", params, int8, MIXED_SERVE, MIXED_PROMPTS, MIXED_BUDGETS, shape=(2, 1))
    wta = dataclasses.replace(cfg, wta_head=True)
    case("wta_2x2", params, wta, dict(MIXED_SERVE, seed=3), MIXED_PROMPTS, MIXED_BUDGETS)
    case("spec_2x2", params, cfg, dict(MIXED_SERVE, speculate_k=3), MIXED_PROMPTS,
         MIXED_BUDGETS)
    case("share_2x2", params, cfg, SHARE_SERVE, share_trace())
    case("preempt_2x2", params, cfg, PREEMPT_SERVE, [list(range(1, 10)), list(range(2, 14))],
         [10, 10], inject=lambda: FaultInjector().at(4, "preempt").at(8, "preempt"))

    rg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"), dtype="float32")
    rg_params = init_lm(rg, seed=0, device="cpu")
    scale_block_outputs(rg_params, 8.0)
    for shape in ((2, 1), (1, 2)):
        case(f"rg_{shape[0]}x{shape[1]}", rg_params, rg, MIXED_SERVE, MIXED_PROMPTS,
             MIXED_BUDGETS, shape=shape)

    mesh = on((2, 2))
    eng = ServingEngine(params, cfg, ServeConfig(**TRACE_SERVE, mesh=mesh), device="cpu")
    try:
        eng.submit([1, 2, 3], 4, deadline_ms=1e6)
        res["deadline"] = "accepted"
    except ValueError as err:
        res["deadline"] = str(err)

    bench_cfg = dataclasses.replace(
        get_smoke_config("stablelm-3b"), n_layers=4, d_model=128, d_ff=256, n_heads=4,
        n_kv_heads=4, d_head=32, max_seq=1024, wta_head=False)
    out = TBS.bench_sharded_decode(bench_cfg, init_lm(bench_cfg, seed=0, device="cpu"),
                                   n_req=6)
    TBS._check_sharded({"sharded_decode": out})
    res["bench"] = out
