"""The knee of an open-loop serving cell, on the card: the cell's traffic
at each of a list of rates, one short window each in one process, without
the output check.  The knee is the highest rate at which the requests
waiting for their first token do not grow over the window.

    python3 perfbench/sweep.py --workload <cell> --rates 2 3 4 5 --seconds 30 --seed 1

Each line also gives the pool's pages and the most of them that admitted
requests held in the window, from which a pool is sized.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import common  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    common.set_cache_dirs()
    common.put_src_on_path()
    import torch

    from perfbench.run import card_line, log

    log(f"card: {card_line()}")
    cell, _, conf, traffic = common.cell_files(common.benchmark(), args.workload)
    driver = common.by_name("drivers", traffic["kind"])
    for rate in args.rates:
        tr = dict(traffic, rate_rps=rate)
        res = driver.run(cell, conf, tr, {}, args.seed, args.seconds, False,
                         time.perf_counter(), log, check=False)
        out = {"rate_rps": rate, **res["e2e"], "attempted": res["attempted"],
               "waiting_start_end": res["queued"], "pool_pages_held": res["pages"],
               "memory_peak_bytes": res["peak"]}
        print(json.dumps(out), flush=True)
        del res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
