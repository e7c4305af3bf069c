"""No module of the benchmark imports JAX, its libraries or the JAX
package; the references import nothing of the program. Top-level module
names are compared whole: ``projected_lmc_tpu_torch`` is the port and
``projected_lmc_tpu`` the JAX package."""

import ast
import subprocess
import sys

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "projected_lmc_tpu"}
PROGRAM = "projected_lmc_tpu_torch"


def _imported(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        assert not (_imported(path) & FORBIDDEN), path


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert PROGRAM not in _imported(path), path
        assert "harness" not in _imported(path), path


def test_a_run_loads_no_jax():
    """A whole small run in a fresh interpreter, then its modules, by whole
    top-level names (the harness's own check, which the chip run makes
    before printing)."""
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(BENCH.parent)!r}, {str(BENCH)!r}]
sys.path.insert(0, {str(BENCH / "tests")!r})
from conftest import small_cell, run_small
from harness import core
for w in ("lmc_exact_sarcos10k.train", "plmc_sarcos10k.serve"):
    run_small(small_cell(w))
print("FOUND", core.forbidden_modules())
print("PORT", "projected_lmc_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
    assert "PORT True" in out.stdout


def test_the_check_compares_whole_names(monkeypatch):
    from harness import core
    monkeypatch.setitem(sys.modules, "projected_lmc_tpu_torchx", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "projected_lmc_tpu.ops", sys)
    assert core.forbidden_modules() == ["projected_lmc_tpu"]
