"""The dry run on one H100 (``repro/launch/dryrun.py``): every (architecture
× input shape) cell's step, run on the ``meta`` device as one rank of the
reference's two production meshes, with what each device holds, does and
sends.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh multi --out runs/dryrun.json

The reference lowers each cell on a 256- or 512-chip TPU mesh and reads
XLA's memory and cost analyses.  The port has no such compiler.  It
opens a fake process group (``FakeStore``, world 256 or 512, rank 0: no
devices, every collective a shape-only no-op) and lays the reference's
mesh over it, 16 × 16 (``data``, ``model``) or 2 × 16 × 16 (``pod``,
``data``, ``model``): read them as 32 or 64 hosts of 8 H100s.  The cell's
inputs are built on ``meta`` (``specs.input_specs``) and placed as
DTensors under the sharding policy (``launch/sharding.py``), and its step
runs there as rank 0 runs it under the reference's activation rules: the
train step through ``train.step`` (its mesh path), prefill and decode
under ``parallel.axis_rules``.  Shapes and dtypes only: nothing is
allocated, nothing drawn.  Each record holds:

* ``params``, ``active_params``;
* ``args_bytes``: the step's inputs whole and, under the sharding
  policy, per device;
* ``temp_bytes``: the step's own peak of live bytes on rank 0 (its local
  storages: the model axis split as the placements and rules split it;
  the train step with ``TrainConfig(microbatches=4)``, the reference's
  production pass), counted by :class:`LiveBytes`;
* ``cost``: ``flops``, rank 0's local ops under ``FlopCounterMode``
  (matrix products, convolutions and attention only; the reference's XLA
  counts every op), and ``bytes accessed``, its local ops' operand and
  result bytes, unfused (an upper bound);
* ``collectives``: what rank 0 sends, the reference's dict (bytes per
  kind, ``count``, ``total_bytes``): ``CommDebugMode``'s count of the
  ``_c10d_functional`` (and ``_dtensor``) collectives the step issues, and
  :class:`Collectives`' bytes over the same ops by the reference's
  formula (all-gather: the result; reduce-scatter: the operand;
  all-reduce: 2 × the operand; all-to-all: the operand);
* ``model_flops_global``, ``model_flops_per_chip`` and ``roofline``
  (``launch/roofline.py``, the H100's data-sheet peaks).

Results accumulate into a JSON keyed ``arch|shape|mesh[|tag]`` (skipped
cells ``arch|shape|skipped``); ``launch/report.py`` renders its tables.
``--override analog_mode=...`` runs the analog step, whose custom
Functions give an empty output of the right shape on meta, on whole
operands (``parallel.on_whole``: their weights gathered).  Nothing
touches a device but :func:`measure_step` on one the caller names (the
card check in ``chip_smoke.py`` holds a meta count against the card's
allocator there, unsharded and on a 1 × 1 mesh).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import sys
import threading
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import parallel as PX
from repro_torch.configs import SHAPES, ShapeSpec, cells, get_config, skip_shapes
from repro_torch.launch import roofline as RL
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.models import get_model_fns
from repro_torch.train import TrainConfig, make_train_step

PROD_TRAIN_MICROBATCHES = 4  # grad accumulation in the production pass

MESHES = {
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
}
MESH_NAMES = {"single": "single_pod_16x16", "multi": "multi_pod_2x16x16"}

NOTES = {
    "temp_bytes": "peak live bytes of rank 0's local storages over the DTensor step",
    "flops": "FlopCounterMode over rank 0's local ops: matrix products, convolutions and "
             "attention only",
    "bytes accessed": "rank 0's local ops' operand and result bytes, unfused: an upper bound",
    "per_device": "rank 0 of the fake process group, the step on DTensors at the policy's "
                  "placements",
    "collectives": "CommDebugMode counts; bytes by the reference's formula over the same ops",
}

# the collectives a DTensor step issues, by the reference's kinds
_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


def _is_dtensor_op(types) -> bool:
    """A DTensor op: a counting mode leaves it to DTensor, whose local ops
    on the shards come back to the mode."""
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def _planning() -> bool:
    """Whether ``torch.distributed`` code is on the call stack: DTensor
    planning a redistribution or a shard's offsets, with host tensors."""
    f = sys._getframe(2)
    while f is not None:
        if "torch/distributed/" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _propagating() -> bool:
    """Inside DTensor's sharding propagation, which runs an op on fake
    tensors of the global shape to learn its output's metadata: no rank's
    work, so a counting mode runs it uncounted."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


class LiveBytes(TorchDispatchMode):
    """Counts, within the mode, every storage an op creates until it is
    freed: ``peak`` is the most bytes live at once.  Storages that exist
    when the mode starts (``held``: the step's inputs) and views into any
    counted storage add nothing.  ``accessed`` sums every op's operand and
    result bytes, unfused (views and metadata ops move nothing).  With a
    ``device``, an op whose tensors lie elsewhere counts unless
    ``torch.distributed`` issued it (DTensor plans redistributions and
    offsets with small host tensors: no device's work); the step's own
    host scalars count, as without a mesh."""

    def __init__(self, held=(), device=None):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self.device = None if device is None else torch.device(device).type
        self._seen: dict[int, object] = {}
        for t in _pytree_leaves(PX.local(held)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self._seen[id(st)] = st  # held alive: its id is never reused meanwhile

    def _counts(self, t) -> bool:
        return isinstance(t, torch.Tensor) and (self.device is None or t.device.type == self.device
                                                or not _planning())

    def _freed(self, key: int, nbytes: int, _ref) -> None:
        self.live -= nbytes
        self._seen.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):   # let DTensor run: its local ops come back here
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _propagating():
            return out
        outs = [t for t in _pytree_leaves(out) if self._counts(t)]
        if not func.is_view:
            ins = [t for t in _pytree_leaves((args, kwargs)) if self._counts(t)]
            self.accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen[key] = weakref.ref(st, lambda r, key=key, n=n: self._freed(key, n, r))
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


class Collectives(TorchDispatchMode):
    """Bytes this rank sends, by the reference's formula
    (``repro/launch/roofline.py:8-13``), over the collectives the step's
    local ops issue: all-gather its result, reduce-scatter its operand,
    all-reduce twice its operand, all-to-all its operand.  ``record()``
    is the reference's dict (with ``count`` and ``total_bytes``)."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0 for k in RL.COLLECTIVE_OPS}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_op(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if _propagating():
            return out
        ns = getattr(func, "namespace", "")
        kind = _COLLECTIVE_KINDS.get(func._opname) if ns in ("_c10d_functional", "_dtensor") else None
        if kind is not None:
            nbytes = tree_bytes(out if kind == "all-gather" else args[0])
            self.bytes[kind] += 2 * nbytes if kind == "all-reduce" else nbytes
            self.count += 1
        return out

    def record(self) -> dict:
        return {**self.bytes, "count": self.count, "total_bytes": sum(self.bytes.values())}


class LocalFlops(FlopCounterMode):
    """``FlopCounterMode`` over a rank's local ops: a DTensor op is left to
    DTensor, whose local ops on the shards are the ones counted."""

    def __enter__(self):
        from torch.utils.flop_counter import _FlopCounterMode

        class _Local(_FlopCounterMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if _is_dtensor_op(types):
                    return NotImplemented
                if _propagating():
                    return func(*args, **(kwargs or {}))
                return super().__torch_dispatch__(func, types, args, kwargs)

        self.flop_counts.clear()
        self.mod_tracker.__enter__()
        self.mode = _Local(self)
        self.mode.__enter__()
        return self


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's Shard → Shard all-to-all as it runs on a CUDA mesh; on a
    CPU mesh DTensor falls back to an all-gather and a chunk (gloo has no
    all-to-all), which would count as the wrong collective."""
    import torch.distributed._functional_collectives as funcol

    group = funcol._resolve_group((mesh, mesh_dim))
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 funcol._group_or_group_name(group))


@contextlib.contextmanager
def fake_mesh(mesh: str):
    """The production mesh ``mesh`` ("single" or "multi") over a fake
    process group, as its rank 0; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as LM

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(MESHES[mesh].values()))
    try:
        yield LM.make_production_mesh(multi_pod=mesh == "multi", device="cpu")
    finally:
        dist.destroy_process_group()


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _state_tree(state) -> dict:
    """A TrainState's tensor leaves as a dict (step counters and the key
    are host values in the port)."""
    out = {"params": state.params, "m": state.opt.m, "v": state.opt.v}
    if state.compress is not None:
        out["error"] = state.compress.error
    return out


def per_device_batch(shape: ShapeSpec, sizes: dict) -> int:
    """The global batch over the product of the axes that shard it."""
    bax = SH.batch_axes(sizes, shape.global_batch) or ()
    return shape.global_batch // math.prod(sizes[a] for a in bax)


def make_step(cfg, shape: ShapeSpec, tcfg: TrainConfig):
    """The callable a cell's kind runs: (inputs dict) → outputs."""
    if shape.kind == "train":
        step = make_train_step(cfg, tcfg)
        return lambda ins: step(ins["state"], ins["batch"])
    if shape.kind == "prefill":
        step = SP.make_prefill_step(cfg, shape)

        def prefill(ins):
            with torch.no_grad():
                return step(ins["params"], ins["batch"])
        return prefill
    step = SP.make_serve_step(cfg)
    key = (0, 0) if cfg.wta_head else None

    def decode(ins):
        with torch.no_grad():
            return step(ins["params"], ins["cache"], ins["token"], key)
    return decode


def real_inputs(cfg, shape: ShapeSpec, tcfg: TrainConfig, device, seed: int = 0) -> dict:
    """The inputs ``specs.cell_inputs`` describes, allocated on ``device``: the
    seeded init (and zero moments), uniform random tokens, the model's
    dtype's N(0, 1) patches or frames, a zeroed cache."""
    from repro_torch.train import init_train_state

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    specs = SP.cell_inputs(cfg, shape, tcfg)

    def fill(t: torch.Tensor) -> torch.Tensor:
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, t.shape, generator=gen, device=dev,
                                 dtype=torch.int32)
        return torch.randn(t.shape, generator=gen, device=dev).to(t.dtype)

    out = {"batch": {k: fill(v) for k, v in specs["batch"].items()}} if "batch" in specs else {}
    if shape.kind == "train":
        out["state"] = init_train_state(seed, cfg, tcfg, device=dev)
        return out
    out["params"] = get_model_fns(cfg).init(seed, cfg, dev)
    if shape.kind == "decode":
        out["cache"] = SP.init_decode_cache(cfg, shape.global_batch, shape.seq_len, dev)
        out["token"] = fill(specs["token"])
    return out


def input_tree(ins: dict) -> dict:
    """The inputs as one tree of tensors (a TrainState unpacked)."""
    return {k: _state_tree(v) if k == "state" else v for k, v in ins.items()}


def place_inputs(cfg, shape: ShapeSpec, ins: dict, mesh) -> dict:
    """A cell's inputs (whole, as every rank would hold them) placed on
    ``mesh`` under the sharding policy: each rank keeps its blocks."""
    from repro_torch.train.step import place_state

    gb = shape.global_batch
    out = {}
    for k, v in ins.items():
        if k == "state":
            out[k] = place_state(v, mesh, cfg)
            continue
        if k == "params":
            sh = SH.param_shardings(v, mesh, cfg)
        elif k == "cache":
            sh = SH.cache_shardings(v, mesh, cfg, gb)
        elif k == "token":
            sh = SH.batch_shardings({k: v}, mesh, gb)[k]
        else:
            sh = SH.batch_shardings(v, mesh, gb)
        out[k] = _place(v, sh)
    return out


def _place(tree, sh):
    if isinstance(tree, dict):
        return {k: _place(v, sh[k]) for k, v in tree.items()}
    return PX.place(tree, sh)


@contextlib.contextmanager
def mesh_rules(cfg, shape: ShapeSpec, mesh):
    """A cell's step on ``mesh``: the reference's activation rules at the
    cell's global batch, plain tensors taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    with PX.axis_rules(mesh, SH.activation_rules(mesh, cfg, shape.global_batch)), \
            implicit_replication():
        yield


def count_step(cfg, shape: ShapeSpec, tcfg: TrainConfig, ins: dict, mesh=None) -> dict:
    """Run the step once on ``ins`` under :class:`LiveBytes` and
    ``FlopCounterMode``: {"temp_bytes", "flops", "bytes_accessed"}.  With
    a ``mesh``, ``ins`` are placed on it (:func:`place_inputs`) and the
    step runs on DTensors under the activation rules: the counts are this
    rank's local ones, and ``collectives`` (:class:`Collectives`, with
    ``CommDebugMode``'s count beside it as ``comm_debug_count``) is added."""
    step = make_step(cfg, shape, tcfg)
    dev = next(t for t in _pytree_leaves(input_tree(ins)) if isinstance(t, torch.Tensor)).device
    if mesh is None:
        live = LiveBytes(held=input_tree(ins), device=dev)
        flops = FlopCounterMode(display=False)
        with flops, live:
            out = step(ins)
            del out
        return {"temp_bytes": live.peak, "flops": float(flops.get_total_flops()),
                "bytes_accessed": float(live.accessed)}
    from torch.distributed.tensor import placement_types as PT
    from torch.distributed.tensor.debug import CommDebugMode

    ins = place_inputs(cfg, shape, ins, mesh)
    live = LiveBytes(held=input_tree(ins), device=dev)
    flops = LocalFlops(display=False)
    colls, comm = Collectives(), CommDebugMode()
    saved, PT.shard_dim_alltoall = PT.shard_dim_alltoall, _alltoall
    try:
        with comm, colls, flops, live, mesh_rules(cfg, shape, mesh):
            out = step(ins)
            del out
    finally:
        PT.shard_dim_alltoall = saved
    return {"temp_bytes": live.peak, "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(live.accessed),
            "collectives": {**colls.record(), "comm_debug_count": comm.get_total_counts()}}


def _cfg_with(arch: str, overrides: dict | None):
    cfg = get_config(arch)
    if not overrides:
        return cfg
    overrides = dict(overrides)
    mode = overrides.pop("analog_mode", None)
    if mode:
        from repro_torch.core.physics import DeviceParams, calibrate_v_read

        overrides["analog"] = dataclasses.replace(
            cfg.analog.with_mode(mode), device=calibrate_v_read(DeviceParams(), cfg.d_model))
    return dataclasses.replace(cfg, **overrides)


def run_cell(arch: str, shape_name: str, mesh: str, cfg_overrides: dict | None = None,
             microbatches: int | None = None) -> dict:
    """One cell on one mesh ("single" or "multi"), on meta."""
    cfg = _cfg_with(arch, cfg_overrides)
    shape = SHAPES[shape_name]
    sizes = MESHES[mesh]
    n_dev = math.prod(sizes.values())
    mb = microbatches or PROD_TRAIN_MICROBATCHES
    tcfg = TrainConfig(microbatches=mb)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": MESH_NAMES[mesh], "n_chips": n_dev,
        "kind": shape.kind, "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "overrides": {k: str(v) for k, v in (cfg_overrides or {}).items()},
        "notes": NOTES,
    }
    t0 = time.time()
    ins = SP.cell_inputs(cfg, shape, tcfg)
    gb = shape.global_batch
    if shape.kind == "train":
        specs = SH.state_partition_specs(ins["state"], sizes, cfg)
        specs = {"state": {k: v for k, v in specs.items() if v is not None},
                 "batch": SH.batch_partition_specs(ins["batch"], sizes, gb)}
        rec["prod_microbatches"] = mb
    else:
        specs = {"params": SH.param_partition_specs(ins["params"], sizes, cfg)}
        if shape.kind == "prefill":
            specs["batch"] = SH.batch_partition_specs(ins["batch"], sizes, gb)
        else:
            specs["cache"] = SH.cache_partition_specs(ins["cache"], sizes, cfg, gb)
            specs["token"] = SH.batch_partition_specs({"token": ins["token"]}, sizes, gb)["token"]
    tree = input_tree(ins)
    rec["args_bytes"] = {"whole": tree_bytes(tree),
                         "per_device": SH.per_device_bytes(tree, specs, sizes)}
    rec["per_device_batch"] = per_device_batch(shape, sizes)
    with fake_mesh(mesh) as dmesh:
        counts = count_step(cfg, shape, tcfg, ins, dmesh)
    rec["temp_bytes"] = counts["temp_bytes"]
    rec["cost"] = {"flops": counts["flops"], "bytes accessed": counts["bytes_accessed"]}
    rec["collectives"] = counts["collectives"]
    rec["model_flops_global"] = RL.model_flops(cfg, shape)
    rec["model_flops_per_chip"] = rec["model_flops_global"] / n_dev
    rec["roofline"] = RL.roofline_terms(rec)
    rec["run_s"] = round(time.time() - t0, 2)
    return rec


def measure_step(cfg, shape: ShapeSpec, tcfg: TrainConfig, device, iters: int = 3,
                 mesh=None) -> dict:
    """The card check of a meta count: the step on ``device`` on
    :func:`real_inputs`, beside the same step on meta.
    Returns the meta counts (``args_bytes``, ``temp_bytes``, ``flops``),
    the allocator's (``memory_allocated`` held by the inputs, the peak over
    the step less the allocation before it; the step runs once before, so
    one-time workspaces are not in it), ``FlopCounterMode`` on the card,
    and the step's ms (CUDA events, the mean of ``iters`` runs).  With a
    ``mesh`` (on ``device``'s type) the inputs are placed on it and the
    step runs on DTensors (:func:`mesh_rules`; rank 0's local FLOPs); the
    meta side, which needs a fake group of its own, is the caller's
    (:func:`count_step` with a mesh): ``meta`` is ``None``."""
    dev = torch.device(device)
    meta = None
    if mesh is None:
        meta_ins = SP.cell_inputs(cfg, shape, tcfg)
        meta = count_step(cfg, shape, tcfg, meta_ins)
        meta["args_bytes"] = tree_bytes(input_tree(meta_ins))
    step = make_step(cfg, shape, tcfg)
    ctx = contextlib.nullcontext if mesh is None else lambda: mesh_rules(cfg, shape, mesh)
    gc.collect()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    ins = real_inputs(cfg, shape, tcfg, dev)
    if mesh is not None:
        ins = place_inputs(cfg, shape, ins, mesh)
    torch.cuda.synchronize(dev)
    args = torch.cuda.memory_allocated(dev) - base
    with ctx():
        step(ins)  # warm-up: cuBLAS workspaces and first-use allocations
    flops = (FlopCounterMode if mesh is None else LocalFlops)(display=False)
    gc.collect()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with flops, ctx():
        out = step(ins)
    torch.cuda.synchronize(dev)
    temp = torch.cuda.max_memory_allocated(dev) - before
    del out
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    with ctx():
        for _ in range(iters):
            step(ins)
    end.record()
    torch.cuda.synchronize(dev)
    return {"meta": meta, "card": {"args_bytes": args, "temp_bytes": temp,
                                   "flops": float(flops.get_total_flops())},
            "ms": start.elapsed_time(end) / iters}


# a train step on the three-axis mesh nests DTensor's dispatch, the
# counting modes and the checkpointed backward deeper than a main thread's
# 8 MiB C stack holds (CPython crashes there): each cell runs on a thread
# with this stack
CELL_STACK_BYTES = 1 << 30


def on_big_stack(fn, *args):
    """``fn(*args)`` on a thread with a CELL_STACK_BYTES stack; its
    exception, if any, raised here."""
    out: dict = {}

    def work():
        try:
            out["value"] = fn(*args)
        except BaseException as e:   # re-raised in the caller's thread
            out["error"] = e

    old = threading.stack_size(CELL_STACK_BYTES)
    try:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    finally:
        threading.stack_size(old)
    if "error" in out:
        raise out["error"]
    return out["value"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="runs/dryrun.json")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (repeatable)")
    ap.add_argument("--tag", default="", help="suffix for result keys")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="grad-accumulation microbatches of the train step")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    if args.all:
        todo = [(a, s) for a, s, skip in cells()]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
    meshes = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    # the skipped cells are recorded too, as the reference's report lists them
    for arch, shape, skip in cells(include_skipped=True):
        if skip is not None and (args.all or (arch, shape) in todo):
            results[f"{arch}|{shape}|skipped"] = {"skipped": skip}
            print(f"[skip] {arch} × {shape}: {skip}", flush=True)
    for arch, shape in todo:
        if shape in skip_shapes(arch):
            continue
        for mesh in meshes:
            key = f"{arch}|{shape}|{mesh}" + (f"|{args.tag}" if args.tag else "")
            if key in results and "error" not in results[key] and not overrides:
                print(f"[cached] {key}", flush=True)
                continue
            print(f"[run] {key} ...", flush=True)
            try:
                rec = on_big_stack(run_cell, arch, shape, mesh, overrides or None,
                                   args.microbatches)
                results[key] = rec
                r = rec["roofline"]
                print(f"  ok {rec['run_s']}s args/dev {rec['args_bytes']['per_device']:.4e} B "
                      f"temp {rec['temp_bytes']:.4e} B flops/dev {rec['cost']['flops']:.4e} "
                      f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
                      f"dom={r['dominant']} frac={r['roofline_fraction']:.3f}", flush=True)
            except Exception as e:
                results[key] = {"error": f"{type(e).__name__}: {e}",
                                "traceback": traceback.format_exc()[-4000:]}
                print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("done.", flush=True)


if __name__ == "__main__":
    main()
