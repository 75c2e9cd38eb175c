"""The dry run's tables (``repro/launch/report.py``) from its JSON.

    PYTHONPATH=src python -m repro_torch.launch.report runs/dryrun.json [--compact]

Three tables, rows in the reference's arch order: per cell and mesh the
bytes a device holds (inputs under the sharding policy plus the step's
own peak, rank 0's local storages on the DTensor mesh) against one
H100's 80 GB; the single-pod roofline terms against the H100's
data-sheet peaks, where the FLOPs are the matrix operations
``FlopCounterMode`` counts over rank 0's local ops; and the bytes each
kind of collective moves a device a step (measured on the fake process
group; a record from before the mesh terms reads "not measured").
``--compact`` prints one row a cell instead, both meshes side by side,
with each mesh's collective term.  The counts come from a meta run, not
from a card.
"""

from __future__ import annotations

import json
import sys

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES
from repro_torch.launch import roofline as RL

NOT_MEASURED = "not measured"


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.2f}{unit}"
        b /= 1024
    return f"{b:.2f}PB"


def fmt_s(x) -> str:
    if x is None:
        return NOT_MEASURED
    if x >= 0.1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def device_bytes(r: dict) -> int:
    """A device's inputs under the policy plus the step's peak."""
    return r["args_bytes"]["per_device"] + r["temp_bytes"]


def dryrun_table(results: dict) -> str:
    """Per cell × mesh: the meta run, bytes per device, fits one H100."""
    lines = [
        "| arch | shape | mesh | meta run | HBM/dev (args+temp) | fits 80 GB |",
        "|---|---|---|---|---|---|",
    ]
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            skip_key = f"{arch}|{shape}|skipped"
            if skip_key in results:
                lines.append(f"| {arch} | {shape} | - | SKIP | "
                             f"{results[skip_key]['skipped'][:46]} | - |")
                continue
            for mesh in ("single", "multi"):
                r = results.get(f"{arch}|{shape}|{mesh}")
                if r is None:
                    continue
                if "error" in r:
                    lines.append(f"| {arch} | {shape} | {mesh} | **FAIL** | {r['error'][:46]} | - |")
                    continue
                hbm = device_bytes(r)
                fits = "yes" if hbm <= RL.HBM_PER_DEVICE else "**no**"
                lines.append(f"| {arch} | {shape} | {mesh} | {r.get('run_s', '-')}s | "
                             f"{fmt_bytes(hbm)} | {fits} |")
    return "\n".join(lines)


def roofline_table(results: dict, tag: str = "") -> str:
    """Single-pod terms per cell, per device."""
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "MODEL_FLOPs/FLOPs (matrix ops only) | roofline frac | what would move it |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            r = results.get(f"{arch}|{shape}|single" + (f"|{tag}" if tag else ""))
            if r is None or "error" in r or "roofline" not in r:
                continue
            ro = RL.roofline_terms(r)
            lines.append(
                f"| {arch} | {shape} | {fmt_s(ro['compute_s'])} | {fmt_s(ro['memory_s'])} | "
                f"{fmt_s(ro['collective_s'])} | {ro['dominant']} | "
                f"{ro['useful_flops_ratio']:.3f} | {ro['roofline_fraction']:.3f} | "
                f"{RL.improvement_hint(r, ro)} |")
    return "\n".join(lines)


def collective_table(results: dict) -> str:
    lines = [
        "| arch | shape | all-reduce | all-gather | reduce-scatter | all-to-all | permute | #ops |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            r = results.get(f"{arch}|{shape}|single")
            if not r or "error" in r:
                continue
            c = r.get("collectives")
            if c is None:
                cols = [NOT_MEASURED] * 6
            else:
                cols = [fmt_bytes(c[k]) for k in ("all-reduce", "all-gather", "reduce-scatter",
                                                  "all-to-all", "collective-permute")]
                cols.append(str(int(c["count"])))
            lines.append(f"| {arch} | {shape} | " + " | ".join(cols) + " |")
    return "\n".join(lines)


def compact_table(results: dict) -> str:
    """One row a cell: per device on the single / multi mesh, the inputs
    under the policy and the step's peak, whether they fit 80 GB; the
    single mesh's matrix FLOPs and roofline bound."""
    lines = [
        "| arch | shape | args/dev single · multi | temp single · multi | fits 80 GB | "
        "FLOPs/dev (matrix ops only) | collective single · multi | bound (dominant) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            rs = [results.get(f"{arch}|{shape}|{m}") for m in ("single", "multi")]
            if any(r is None or "error" in r for r in rs):
                continue
            s, m = rs
            ro = RL.roofline_terms(s)
            fits = " · ".join("yes" if device_bytes(r) <= RL.HBM_PER_DEVICE else "no"
                              for r in rs)
            coll = " · ".join(fmt_s(RL.roofline_terms(r)["collective_s"]) for r in rs)
            lines.append(
                f"| {arch} | {shape} | {fmt_bytes(s['args_bytes']['per_device'])} · "
                f"{fmt_bytes(m['args_bytes']['per_device'])} | {fmt_bytes(s['temp_bytes'])} "
                f"· {fmt_bytes(m['temp_bytes'])} | {fits} | {s['cost']['flops']:.3e} | "
                f"{coll} | {fmt_s(ro['bound_s'])} ({ro['dominant']}) |")
    return "\n".join(lines)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    compact = "--compact" in argv
    argv = [a for a in argv if a != "--compact"]
    path = argv[0] if argv else "runs/dryrun.json"
    with open(path) as f:
        results = json.load(f)
    if compact:
        print(compact_table(results))
        return
    done = sum(1 for v in results.values() if "error" not in v and "skipped" not in v)
    failed = {k: v["error"] for k, v in results.items() if "error" in v}
    print(f"## cells ok: {done}; failed: {len(failed)}\n")
    for k, e in failed.items():
        print(f"FAILED {k}: {e}")
    print("\n### Dry-run (counts from a meta run)\n")
    print(dryrun_table(results))
    print("\n### Roofline (single-pod, per device; H100 data-sheet peaks; FLOPs: matrix ops "
          "only)\n")
    print(roofline_table(results))
    print("\n### Collectives (single-pod, per device per step)\n")
    print(collective_table(results))


if __name__ == "__main__":
    main()
