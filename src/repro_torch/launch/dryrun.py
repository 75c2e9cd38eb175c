"""The dry run on one H100 (``repro/launch/dryrun.py``): every (architecture
× input shape) cell's step, run on the ``meta`` device under the
reference's two logical meshes, with what each device would hold and do.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh multi --out runs/dryrun.json

The reference lowers each cell on a 256- or 512-chip TPU mesh and reads
XLA's memory and cost analyses.  The port has no such compiler, so each
cell's inputs are built on ``meta`` (``specs.input_specs``) and its step
runs there: shapes and dtypes only, nothing allocated, nothing drawn.
The meshes are the reference's, 16 × 16 (``data``, ``model``) and 2 × 16
× 16 (``pod``, ``data``, ``model``): read them as 32 or 64 hosts of 8
H100s.  Each record holds:

* ``params``, ``active_params``;
* ``args_bytes``: the step's inputs whole and, under the sharding
  policy (``launch/sharding.py``), per device;
* ``temp_bytes``: the step's own peak of live bytes at the per-device
  batch (the global batch over the batch axes' product; the train step
  with ``TrainConfig(microbatches=4)``, the reference's production pass),
  counted by :class:`LiveBytes`.  The model axis stays unsplit until the
  port runs on a DTensor mesh, so this is an upper bound;
* ``cost``: ``flops``, ``FlopCounterMode`` over forward, backward and
  optimizer (matrix products, convolutions and attention only; the
  reference's XLA counts every op), and ``bytes accessed``, every op's
  operand and result bytes, unfused (an upper bound); both of the step
  at the per-device batch, split evenly over the model axis.  The
  port's loop over units is unrolled by nature, so every unit is
  counted (the reference's 1-unit / 2-unit extrapolation has no
  counterpart);
* ``collectives``: ``None``, not measured until DTensor;
* ``model_flops_global``, ``model_flops_per_chip`` and ``roofline``
  (``launch/roofline.py``, the H100's data-sheet peaks).

Results accumulate into a JSON keyed ``arch|shape|mesh[|tag]`` (skipped
cells ``arch|shape|skipped``); ``launch/report.py`` renders its tables.
``--override analog_mode=...`` runs the analog step, whose custom
Functions give an empty output of the right shape on meta.  Nothing
touches a device but :func:`measure_step` on one the caller names (the
card check in ``chip_smoke.py`` holds a meta count against the card's
allocator there).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

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
    "temp_bytes": "peak live bytes of the step at the per-device batch, model axis unsplit: "
                  "an upper bound",
    "flops": "FlopCounterMode: matrix products, convolutions and attention only",
    "bytes accessed": "every op's operand and result bytes, unfused: an upper bound",
    "per_device": "the step's counts at the per-device batch over the model axis's size "
                  "(an even split, assumed until DTensor)",
    "collectives": "not measured",
}


class LiveBytes(TorchDispatchMode):
    """Counts, within the mode, every storage an op creates until it is
    freed: ``peak`` is the most bytes live at once.  Storages that exist
    when the mode starts (``held``: the step's inputs) and views into any
    counted storage add nothing.  ``accessed`` sums every op's operand and
    result bytes, unfused (views and metadata ops move nothing)."""

    def __init__(self, held=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.accessed = 0
        self._seen: dict[int, object] = {}
        for t in _pytree_leaves(held):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self._seen[id(st)] = st  # held alive: its id is never reused meanwhile

    def _freed(self, key: int, nbytes: int, _ref) -> None:
        self.live -= nbytes
        self._seen.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in _pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
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


def count_step(cfg, shape: ShapeSpec, tcfg: TrainConfig, ins: dict) -> dict:
    """Run the step once on ``ins`` under :class:`LiveBytes` and
    ``FlopCounterMode``: {"temp_bytes", "flops", "bytes_accessed"}."""
    step = make_step(cfg, shape, tcfg)
    live = LiveBytes(held=input_tree(ins))
    flops = FlopCounterMode(display=False)
    with flops, live:
        out = step(ins)
        del out
    return {"temp_bytes": live.peak, "flops": float(flops.get_total_flops()),
            "bytes_accessed": float(live.accessed)}


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
    b = per_device_batch(shape, sizes)
    rec["per_device_batch"] = b
    local = dataclasses.replace(shape, global_batch=b)
    counts = count_step(cfg, local, tcfg, SP.cell_inputs(cfg, local, tcfg))
    m = sizes.get("model", 1)
    rec["temp_bytes"] = counts["temp_bytes"]
    rec["cost"] = {"flops": counts["flops"] / m, "bytes accessed": counts["bytes_accessed"] / m}
    rec["step_counts"] = counts
    rec["collectives"] = None
    rec["model_flops_global"] = RL.model_flops(cfg, shape)
    rec["model_flops_per_chip"] = rec["model_flops_global"] / n_dev
    rec["roofline"] = RL.roofline_terms(rec)
    rec["run_s"] = round(time.time() - t0, 2)
    return rec


def measure_step(cfg, shape: ShapeSpec, tcfg: TrainConfig, device, iters: int = 3) -> dict:
    """The card check of a meta count: the step on ``device`` on
    :func:`real_inputs`, beside the same step on meta.
    Returns the meta counts (``args_bytes``, ``temp_bytes``, ``flops``),
    the allocator's (``memory_allocated`` held by the inputs, the peak over
    the step less the allocation before it; the step runs once before, so
    one-time workspaces are not in it), ``FlopCounterMode`` on the card,
    and the step's ms (CUDA events, the mean of ``iters`` runs)."""
    dev = torch.device(device)
    meta_ins = SP.cell_inputs(cfg, shape, tcfg)
    meta = count_step(cfg, shape, tcfg, meta_ins)
    meta["args_bytes"] = tree_bytes(input_tree(meta_ins))
    step = make_step(cfg, shape, tcfg)
    gc.collect()
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    ins = real_inputs(cfg, shape, tcfg, dev)
    torch.cuda.synchronize(dev)
    args = torch.cuda.memory_allocated(dev) - base
    step(ins)  # warm-up: cuBLAS workspaces and first-use allocations
    flops = FlopCounterMode(display=False)
    gc.collect()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with flops:
        out = step(ins)
    torch.cuda.synchronize(dev)
    temp = torch.cuda.max_memory_allocated(dev) - before
    del out
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        step(ins)
    end.record()
    torch.cuda.synchronize(dev)
    return {"meta": meta, "card": {"args_bytes": args, "temp_bytes": temp,
                                   "flops": float(flops.get_total_flops())},
            "ms": start.elapsed_time(end) / iters}


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
                rec = run_cell(arch, shape, mesh, overrides or None, args.microbatches)
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
