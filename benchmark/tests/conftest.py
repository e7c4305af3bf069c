"""Tests of the benchmark, run with ``python -m pytest benchmark/tests`` from
the root of the repository. They run on the CPU at small sizes; those
marked ``chip`` need the card and skip without one (the card is looked for
inside a fixture, never while a module is imported)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (run on the machine with the chip)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size "
                    "on the chip")
    return torch.device("cuda")


SMALL = {"n": 240}
_HELD_OUT = {}


def held_out_root():
    """A checkout whose ``BENCHMARK.json`` also holds the cells kept out of
    the benchmark (``held_out_cells.json``: the exact LMC, whose program
    fault PERF.md records), so that their parts stay tested; made once, in
    a temporary directory."""
    import json
    import tempfile
    if "root" not in _HELD_OUT:
        root = Path(tempfile.mkdtemp(prefix="bench_held_out_"))
        (root / "benchmark").symlink_to(BENCH)
        spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
        extra = json.loads((BENCH / "tests" / "held_out_cells.json")
                           .read_text())
        spec["configs"] += extra["configs"]
        spec["workloads"] += extra["workloads"]
        names = [w["name"] for w in extra["workloads"]]
        for m in spec["end_to_end"] + spec["per_layer"]:
            if m["name"] == "setup_s" or m["name"].endswith(".train") \
                    or m["name"] == "train_step_ms":
                if "workloads" in m:
                    m["workloads"] = m["workloads"] + names
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        _HELD_OUT["root"] = root
    return _HELD_OUT["root"]


def small_cell(workload, root=None, bench=None):
    """The cell at a size the CPU runs in seconds: n = 240, rank-32 roots,
    4-step chunks, batches of 20-60 points."""
    from harness import core
    if root is None and workload.startswith("lmc_exact_sarcos10k."):
        root, bench = held_out_root(), BENCH
    kw = {} if root is None else dict(root=root, bench=bench)
    cell = core.Cell(workload, **kw)
    cell.config.update(SMALL)
    if "mll" in cell.config:
        cell.config["mll"]["precond_rank"] = 32
    cell.traffic.update(scan_steps=4, batch_min=20, batch_max=60,
                        pool_points=4000, profile_requests=3)
    return cell


def run_small(cell, seed=2 ** 33 + 5, variant=None, trace=False):
    import time

    import torch

    import projected_lmc_tpu_torch as pl
    from harness import core
    torch.manual_seed(0)
    out = cell.loop.run(cell, pl, seed, 0.5, trace, torch.device("cpu"),
                        time.time(), variant)
    return out, core.finish(cell, out, trace)
