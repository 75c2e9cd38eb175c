"""The readings a cell's output limit is set from, on the card: for each
seed, one run of the cell with a short window (the program's reading),
then the control on the same prompts and served tokens (the reference in
fp8 e4m3 in the program's place, ``check.readings(control=True)``), all in
one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 --seconds 20 --control 3

Writes one JSON line per seed to ``chiprun_out/calibrate_<cell>.jsonl``
and prints the largest program reading and the smallest control reading
of the number compared (``check.number``).
"""

from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import common  # noqa: E402


def summary(sampler: dict, gaps: list) -> dict:
    """The number compared, with the widest and mean gap and the share of
    tokens that are not the reference's choice, over one run's sample."""
    from perfbench import check as CK

    flat = [g for r in gaps for g in r]
    name, value = CK.number(sampler, gaps)
    return {"name": name, "number": value, "widest": max(flat), "mean": sum(flat) / len(flat),
            "off_share": sum(g > 0 for g in flat) / len(flat), "tokens": len(flat)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = ap.parse_args()
    common.set_cache_dirs()
    common.put_src_on_path()
    import torch

    from perfbench import check as CK
    from perfbench.run import card_line, log

    log(f"card: {card_line()}")
    bench = common.benchmark()
    cell, _, conf, traffic = common.cell_files(bench, args.workload)
    lim = common.limits(args.workload)
    driver = common.by_name("drivers", traffic["kind"])
    ref = common.by_name("families", conf["family"]).reference
    out = common.ROOT / "chiprun_out" / f"calibrate_{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    prog, ctrl = [], []
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        res = driver.run(cell, conf, traffic, lim, seed, args.seconds, False, t, log, keep=True)
        rec = {"seed": seed, "program": summary(traffic["sampler"], res["readings"]), "e2e": res["e2e"],
               "tokens": sum(len(r["served"]) for r in res["picked"]), "pages": res["pages"],
               "peak": res["peak"]}
        prog.append(rec["program"]["number"])
        if i < args.control:
            t_c = time.perf_counter()
            gaps = CK.readings(res["params"], ref, conf, traffic, res["picked"], seed & 0xFFFFFFFF,
                               control=True)
            rec["control"] = summary(traffic["sampler"], gaps)
            rec["control_s"] = time.perf_counter() - t_c
            ctrl.append(rec["control"]["number"])
        log(json.dumps(rec))
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        del res
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": max(prog), "upper": min(ctrl) if ctrl else None,
                      "program": prog, "control": ctrl}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
