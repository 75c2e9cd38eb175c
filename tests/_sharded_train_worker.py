"""The gloo ranks of ``tests/test_torch_sharded_train.py``: every rank runs
this module's :func:`train` (SPMD) and writes what it saw to
``rank{r}.pt``.

Each case trains stablelm-3b smoke at f32 (B = 4, S = 16, three steps of
``make_train_step``) on a ``(data, model)`` mesh over the group's two
ranks, and records the losses, the parameters after the last step
(whole, gathered) and, in the analog cases, every crossbar read of the
first step (its output, whole).  The test holds them against the same
runs without a mesh.  The cases, on ``1x2`` and ``2x1``:

* ``digital``, ``analog`` (``analog_stochastic``), ``compress`` (int8
  gradient compression, digital) and ``mb2`` (two microbatches, digital);
  ``analog_mb2`` (analog, two microbatches) on 2 × 1 alone, where the
  microbatches' rows are split over data;
* ``rg_1x2``: recurrentgemma-2b smoke, ``analog_stochastic``, on 1 × 2
  (its RG-LRU scan, conv and ``sigmoid_sample`` gates on a mesh);
* ``moe_1x2``: granite-moe-3b-a800m smoke, digital, on 1 × 2 (the
  dispatch and combine on a mesh);
* ``norms``: ``global_norm`` of a parameter tree placed on each mesh;
* ``ckpt``: a checkpoint saved unsharded loaded onto 1 × 2 (each rank's
  blocks against the unsharded leaves), one saved at 1 × 2 loaded
  unsharded, and ``loop.run(mesh=)`` at 1 × 2 with a fault injected
  before step 2 against the uninterrupted sharded run.
"""

from __future__ import annotations

import dataclasses
import os
import traceback

import torch
import torch.distributed as dist

STEPS = 3
B, S = 4, 16
MESHES = {"1x2": (1, 2), "2x1": (2, 1)}
CASES = {  # name: (arch, analog, TrainConfig overrides)
    "digital": ("stablelm-3b", False, {}),
    "analog": ("stablelm-3b", True, {}),
    "compress": ("stablelm-3b", False, {"compress_grads": True}),
    "mb2": ("stablelm-3b", False, {"microbatches": 2}),
}
EXTRA = {  # name: (mesh, arch, analog, overrides)
    "analog_mb2_2x1": ("2x1", "stablelm-3b", True, {"microbatches": 2}),
    "rg_1x2": ("1x2", "recurrentgemma-2b", True, {}),
    "moe_1x2": ("1x2", "granite-moe-3b-a800m", False, {}),
}


def config(arch: str, analog: bool):
    """The smoke config at f32, in ``analog_stochastic`` mode if asked."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.analog import AnalogConfig
    from repro_torch.core.physics import DeviceParams, calibrate_v_read

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if analog:
        cfg = dataclasses.replace(cfg, analog=AnalogConfig(
            mode="analog_stochastic", device=calibrate_v_read(DeviceParams(), cfg.d_model)))
    return cfg


def train_config(overrides: dict):
    from repro_torch.train import TrainConfig

    return TrainConfig(**overrides)


def run_steps(arch: str, analog: bool, overrides: dict, mesh=None, reads: bool = False) -> dict:
    """Three steps from the seeded init (placed on ``mesh`` when given):
    {"losses", "grad_norms", "params" (whole, after the last step),
    "reads" (the first step's crossbar outputs, whole, when asked)}."""
    from repro_torch.data import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.optim import tree_leaves
    from repro_torch.train import init_train_state, make_train_step

    cfg = config(arch, analog)
    tcfg = train_config(overrides)
    state = init_train_state(0, cfg, tcfg, "cpu", mesh=mesh)
    step = make_train_step(cfg, tcfg)
    seen: list = []
    sim = ops.crossbar_mac_sim

    def record(*args, **kw):
        y = sim(*args, **kw)
        seen.append(y.detach().clone())
        return y

    losses, norms = [], []
    for i in range(STEPS):
        ops.crossbar_mac_sim = record if reads and i == 0 else sim
        try:
            state, metrics = step(state, lm_batch(cfg, batch=B, seq=S, step=i, device="cpu"))
        finally:
            ops.crossbar_mac_sim = sim
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    whole = [p.full_tensor() if hasattr(p, "full_tensor") else p for p in tree_leaves(state.params)]
    return {"losses": losses, "grad_norms": norms, "params": [p.detach().clone() for p in whole],
            "reads": seen}


def _flat_state(state) -> list:
    """(name, tensor) of a TrainState's tensor leaves, in flatten order."""
    from repro_torch.checkpoint.store import _flatten_with_names

    return [(n, t) for n, t in _flatten_with_names(state) if isinstance(t, torch.Tensor)]


def _ckpt(res: dict, out_dir: str) -> None:
    """Re-shard both ways and a sharded restart, at 1 × 2."""
    from repro_torch import parallel as PX
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.data import lm_batch
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import sharding as SH
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train.loop import LoopConfig, run

    cfg = config("stablelm-3b", False)
    tcfg = TrainConfig(compress_grads=True)
    mesh = LM.make_host_mesh(model=2, device="cpu")
    d = os.path.join(out_dir, "ckpt_unsharded")
    whole = init_train_state(0, cfg, tcfg, "cpu")
    if dist.get_rank() == 0:
        save_checkpoint(d, 0, whole)
    dist.barrier()
    like = init_train_state(1, cfg, tcfg, "cpu", mesh=mesh)
    placed = load_checkpoint(d, 0, like, shardings=SH.state_shardings(like, mesh, cfg))
    equal = []
    for (name, a), (_, b) in zip(_flat_state(whole), _flat_state(placed)):
        sh = PX.Sharding(b.device_mesh, tuple(b.placements))
        equal.append(bool(torch.equal(a.detach()[PX.local_slices(sh, a.shape)], b.to_local())))
    res["ckpt_to_mesh"] = equal
    d2 = os.path.join(out_dir, "ckpt_sharded")
    sharded = init_train_state(2, cfg, tcfg, "cpu", mesh=mesh)
    save_checkpoint(d2, 0, sharded)
    back = load_checkpoint(d2, 0, init_train_state(3, cfg, tcfg, "cpu"))
    res["ckpt_from_mesh"] = [bool(torch.equal(a.full_tensor(), b))
                             for (_, a), (_, b) in zip(_flat_state(sharded), _flat_state(back))]

    def batch_fn(step):
        return lm_batch(cfg, batch=B, seq=S, step=step, device="cpu")

    runs = {}
    for name, fault in (("clean", None), ("fault", 2)):
        lcfg = LoopConfig(steps=STEPS + 1, ckpt_dir=os.path.join(out_dir, f"loop_{name}"),
                          ckpt_every=1, fault_inject_step=fault)
        _, stats = run(cfg, tcfg, lcfg, batch_fn, device="cpu", mesh=mesh)
        runs[name] = {"losses": stats["losses"], "restarts": stats["restarts"],
                      "rank": stats["rank"]}
    res["loop"] = runs


def _norms(meshes: dict) -> dict:
    """``global_norm`` of a seeded smoke parameter tree placed on each mesh
    against the unsharded tree's: {mesh: (sharded, unsharded)}."""
    from repro_torch.models import get_model_fns
    from repro_torch.optim import global_norm
    from repro_torch.train.step import _place_tree
    from repro_torch.launch import sharding as SH

    cfg = config("stablelm-3b", False)
    tree = get_model_fns(cfg).init(5, cfg, "cpu")
    want = float(global_norm(tree))
    return {name: (float(global_norm(_place_tree(tree, SH.param_shardings(tree, mesh, cfg)))), want)
            for name, mesh in meshes.items()}


def _cases(res: dict, out_dir: str) -> None:
    from repro_torch.launch import mesh as LM

    meshes = {name: LM.make_host_mesh(model=m, data=d, device="cpu")
              for name, (d, m) in MESHES.items()}
    for mname, mesh in meshes.items():
        for case, (arch, analog, ov) in CASES.items():
            res[f"{case}_{mname}"] = run_steps(arch, analog, ov, mesh, reads=analog)
    for name, (mname, arch, analog, ov) in EXTRA.items():
        res[name] = run_steps(arch, analog, ov, meshes[mname])
    res["norms"] = _norms(meshes)
    _ckpt(res, out_dir)


def train(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    res: dict = {}
    try:
        _cases(res, out_dir)
    except Exception:   # recorded for the test to show; the rank still ends
        res["error"] = traceback.format_exc()
    finally:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
