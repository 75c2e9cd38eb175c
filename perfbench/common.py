"""Paths, data files, percentiles and the result line shared by the drivers."""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import re
import sys
from pathlib import Path
from typing import Optional, Sequence

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_files(bench: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration entry, configuration file, traffic file) of a
    workload named in ``BENCHMARK.json``."""
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    return cell, conf, load_json(ROOT / conf["file"]), load_json(HERE / "traffic" / f"{cell['traffic']}.json")


def limits(workload: str) -> dict:
    return load_json(HERE / "limits" / f"{workload}.json")


def by_name(package: str, name: str):
    """The module ``perfbench.<package>.<name>``: a traffic kind's driver
    (``drivers``) or a configuration family's module (``families``)."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name) or not (HERE / package / f"{name}.py").is_file():
        raise SystemExit(f"no perfbench/{package}/{name}.py")
    return importlib.import_module(f"perfbench.{package}.{name}")


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    that only a checkout's first run builds.  The port's own kernels build
    into ``build/kernels/`` beside ``src/`` (``repro_torch/kernels/build.py``)."""
    cache = ROOT / "build" / "perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def put_src_on_path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100), linear between closest ranks; None of
    an empty sample."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def device_name(device: str) -> str:
    import torch

    if device == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"
