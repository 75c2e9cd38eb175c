"""The port stands alone: no jax and nothing of ``repro`` in its package or
in ``chip_smoke.py``, checked statically and by importing every module in
a process where jax and repro cannot be imported."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "ml_dtypes"}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_port_imports_with_jax_and_repro_blocked():
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
    )
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
