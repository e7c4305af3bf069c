"""Finds a cell's parts by the names in ``BENCHMARK.json`` and runs it.

A workload names a configuration and a traffic mix. The configuration is
``configs/<config>/`` (``config.json``, the program's side in
``system.py``, the work of its mathematics in ``work.py``) with its plain
reference ``reference/<config>.py``; the traffic mix is
``traffic/<traffic>.json``, whose ``loop`` names the general loop that
drives it (``harness/<loop>.py``); the limits of the comparison are
``limits/<workload>.json``; a per-layer metric ``<name>`` is read by
``metrics/<name>.py``. Adding a cell or a metric adds files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
CHECKOUT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "projected_lmc_tpu")


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec(root: Path = CHECKOUT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it needs."""

    def __init__(self, workload: str, root: Path = CHECKOUT,
                 bench: Path = BENCH):
        self.spec = spec(root)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.name = workload
        cname = self.workload["config"]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config = json.loads((root / configs[cname]["file"]).read_text())
        folder = bench / "configs" / cname
        tag = cname.replace(".", "_").replace("-", "_")
        self.system = load_file(folder / "system.py", f"bench_system_{tag}")
        self.work = load_file(folder / "work.py", f"bench_work_{tag}")
        self.reference = load_file(bench / "reference" / f"{cname}.py",
                                   f"bench_reference_{tag}")
        self.traffic = json.loads(
            (bench / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.loop = importlib.import_module(f"harness.{self.traffic['loop']}")
        if self.traffic["loop"] not in self.system.LOOPS:
            raise ValueError(f"{cname} has no {self.traffic['loop']} loop")
        self.limits = json.loads(
            (bench / "limits" / f"{workload}.json").read_text())
        self.end_to_end = self._metrics("end_to_end")
        self.per_layer = self._metrics("per_layer")
        self.readers = {m["name"]: load_file(
            bench / "metrics" / f"{m['name']}.py",
            "bench_metric_" + m["name"].replace(".", "_"))
            for m in self.per_layer}

    def _metrics(self, key):
        return [m for m in self.spec[key]
                if self.name in m.get("workloads", [self.name])]


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (compared whole)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def finish(cell: Cell, out: dict, trace: bool) -> dict:
    """The result line from a loop's output: the cell's metrics for this
    kind of run, the device, the verdict and the checks (last)."""
    from .compare import verdict
    ok, checks = verdict(out["numbers"], cell.limits)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = dict(out["device"])
    result = {"correct": bool(ok and out["failed"] == 0),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace and out.get("breakdown"):
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    return result
