"""The port's benchmark: one cell of ``BENCHMARK.json`` run once, on one H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout.  Everything a cell needs is found by name:
its configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json``, the driver of the mix's kind in
``drivers/<kind>.py``, the configuration family's model config, weights
and reference in ``families/<family>.py``, the limits of its output check
in ``limits/<cell>.json``, and each per-layer metric's reader in
``metrics/<metric>.py``.  ``reference/`` holds the plain PyTorch model the
check compares against; it imports nothing of the program.
"""
