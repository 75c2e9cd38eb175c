"""The port's bench harness: one module per paper table or figure, and
the serving bench, as ``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--device cpu] [--dry-run]

Prints ``name,us_per_call,derived`` CSV rows under the reference's names
(fig4, fig5, fig6, table1, kernels, serving); exits 1 if any bench
raised.  ``--dry-run`` runs the serving bench's tiny protocol (the other
benches have one protocol).  On the card every kernel is built before
the first timed call.
"""

from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch.device import resolve_device

from . import (
    bench_cost_model,
    bench_fcnn_accuracy,
    bench_kernels,
    bench_serving,
    bench_sigmoid,
    bench_wta,
)

BENCHES = (
    ("fig4", bench_sigmoid),
    ("fig5", bench_wta),
    ("fig6", bench_fcnn_accuracy),
    ("table1", bench_cost_model),
    ("kernels", bench_kernels),
    ("serving", bench_serving),
)


def run_all(device=None, out=None, dry_run: bool = False,
            reports: dict | None = None) -> tuple[dict, bool]:
    """Run every bench, printing its rows to ``out`` (standard output) as
    they come; returns ({tag: rows}, whether any bench raised).  The
    serving bench runs its ``dry_run`` protocol when asked, and its report
    goes into ``reports["serving"]`` when a dict is given."""
    out = out or sys.stdout
    dev = resolve_device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build_all(build.sources())
    print("name,us_per_call,derived", file=out, flush=True)
    results, failed = {}, False
    for tag, mod in BENCHES:
        try:
            if mod is bench_serving:
                results[tag], report = mod.run(dev, dry_run=dry_run)
                report["dry_run"] = dry_run
                if reports is not None:
                    reports[tag] = report
            else:
                results[tag] = mod.run(dev)
            for name, us, derived in results[tag]:
                print(f"{tag}/{name},{us:.1f},{derived}", file=out, flush=True)
        except Exception:
            failed = True
            traceback.print_exc()
    return results, failed


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; the card when omitted, 'cpu' for the plain PyTorch path")
    ap.add_argument("--dry-run", action="store_true",
                    help="the serving bench's tiny protocol")
    args = ap.parse_args(argv)
    _, failed = run_all(args.device, dry_run=args.dry_run)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
