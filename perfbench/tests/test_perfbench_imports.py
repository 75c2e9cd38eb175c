"""What a run loads, compared by top-level module names whole: a whole
smoke run on the CPU loads neither JAX, jaxlib, flax nor the JAX package
``repro`` (``repro_torch`` is another name), and the reference loads
nothing of the program either."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys, time
sys.path[:0] = [{tests!r}]
from _smoke import smoke
from perfbench import run as RUN
line = RUN.run_cell("stablelm-3b.chat_wta", 5, 0.5, False, time.perf_counter(), device="cpu",
                    overrides=smoke)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.model, perfbench.reference.wta, perfbench.reference.threefry
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_names(RUN.format(tests=str(ROOT / "perfbench" / "tests")))
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_names(REF.format(root=str(ROOT)))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
