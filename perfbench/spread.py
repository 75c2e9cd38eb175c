"""Spreads of a cell's repeated runs, from which the bounds are set:
for each metric and each set of runs (one run a seed, the same seeds in
each set), the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median, also with
the run farthest from the median left out; and the median of the second
set against the first's.

    python3 perfbench/spread.py chiprun_out/sets_<cell>_t0.jsonl ...

Each line of a file is ``{"pass": n, "seed": s, "line": <the run's result line>}``.
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(values: list[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def trimmed_spread(values: list[float]) -> float:
    """The spread with the run farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread(values[:far] + values[far + 1:])


def main(paths: list[str]) -> None:
    for path in paths:
        runs = defaultdict(lambda: defaultdict(list))
        correct = []
        with open(path) as f:
            for raw in f:
                rec = json.loads(raw)
                line = rec.get("line") or {}
                correct.append(line.get("correct"))
                for name, m in line.get("metrics", {}).items():
                    runs[name][rec["pass"]].append(m["value"])
        print(f"{path}: correct {correct}")
        for name, sets in sorted(runs.items()):
            parts = []
            for p in sorted(sets):
                v = sets[p]
                if len(v) >= 3:
                    parts.append(f"set {p}: n {len(v)} median {statistics.median(v):.6g} "
                                 f"spread {spread(v):.4%} trimmed {trimmed_spread(v):.4%}")
            meds = [statistics.median(sets[p]) for p in sorted(sets)]
            drift = f" second/first {meds[1] / meds[0] - 1:+.3%}" if len(meds) > 1 else ""
            print(f"  {name}: " + "; ".join(parts) + drift)


if __name__ == "__main__":
    main(sys.argv[1:])
