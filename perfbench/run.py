"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Needs as many CUDA cards as the cell asks
for, and exits non-zero without a result otherwise.  ``--trace 0`` prints
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics with
the device's busy time and a breakdown.  Standard error carries the run's
log and, last, each number the output check compared beside its limit.
"""

from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import common  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_proc: float,
             device: str = "cuda", overrides=None, fault=None) -> dict:
    """Everything of a run but the look for the card and the printing: the
    result line as a dict, plus ``compared``.  The traffic's ``kind`` names
    the driver (``drivers/<kind>.py``).  ``overrides(conf, traffic, limits)``
    and ``fault(engine)`` are for the tests."""
    bench = common.benchmark()
    cell, entry, conf, traffic = common.cell_files(bench, workload)
    lim = common.limits(workload)
    if overrides is not None:
        conf, traffic, lim = overrides(conf, traffic, lim)
    driver = common.by_name("drivers", traffic["kind"])
    res = driver.run(cell, conf, traffic, lim, seed, seconds, trace, t_proc, log,
                     device=device, fault=fault)
    end = {m["name"]: m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    per = {m["name"]: m for m in bench["per_layer"] if workload in m.get("workloads", [workload])}
    metrics = {}
    if not trace:
        values = dict(res["e2e"], setup_s=res["setup_s"])
        for name, m in end.items():
            if values.get(name) is not None:
                metrics[name] = common.metric(values[name], m["unit"])
    else:
        for name, m in per.items():
            v = common.metric_reader(name)(res["ctx"])
            if v is not None:
                metrics[name] = common.metric(v, m["unit"])
    n_dev = int(cell["chips"])
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": common.device_name(device), "count": n_dev,
                "memory_peak_bytes": res["peak"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev_info}
    if trace:
        st = res["stretch"]
        dev_info["busy_s"] = st["busy_s"]
        dev_info["window_s"] = st["window_s"]
        from perfbench.trace import top_ops

        line["breakdown"] = {"device_ops": top_ops(st), "idle_gaps": st["gaps"]}
    line["compared"] = res["compared"]
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    common.set_cache_dirs()
    common.put_src_on_path()
    bench = common.benchmark()
    cell = common.find(bench["workloads"], args.workload, "workload")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"cell {args.workload} needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.set_num_threads(4)
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_PROC)
    bad = common.forbidden_modules()
    if bad:
        log(f"loaded modules of JAX or the JAX package: {bad}")
        return 4
    for name, c in line["compared"].items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
