"""The least times of a training step's operations by name, for a per-layer
metric that holds a span's device stretch against part of the step's work.

A metric's reader is handed the loop's context alone. The cell is found
among the configurations of ``BENCHMARK.json`` by the least step time that
the loop put in it (``ctx["least_s"]``, from ``configs/<config>/work.py``):
the configuration whose work model gives that time is the cell's, and the
least times of its ``step_operations`` are summed by their names."""

from __future__ import annotations

import json
from collections import defaultdict

from . import core
from .peaks import least_seconds


def least_by_name(ctx) -> dict:
    """{operation name: least seconds a step} of the cell's configuration,
    or {} where no configuration gives the context's least step time."""
    for c in core.spec()["configs"]:
        work = core.load_file(core.BENCH / "configs" / c["name"] / "work.py",
                              "bench_stepwork_" + c["name"].replace(".", "_")
                              .replace("-", "_"))
        if not hasattr(work, "step_operations"):
            continue
        cfg = json.loads((core.CHECKOUT / c["file"]).read_text())
        if work.least_step_seconds(cfg) != ctx.get("least_s"):
            continue
        out = defaultdict(float)
        for o in work.step_operations(cfg):
            out[o["name"]] += least_seconds(o)
        return dict(out)
    return {}
