"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics read from a ``torch.profiler`` trace of part of the
window. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` when
traced), then ``checks``, each number compared with its limit, which are
also the last lines of standard error. Exits non-zero without a result when
there is no card (or fewer than the cell asks for), when the program is
missing, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The process's start on the wall clock (from /proc; now if absent)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T0 = process_start()
BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = CHECKOUT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    for p in (str(CHECKOUT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)

    from harness import core
    cell = core.Cell(args.workload)

    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import projected_lmc_tpu_torch as pl

    out = cell.loop.run(cell, pl, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda"), T0)
    bad = core.forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}; the port's process must "
              "load neither JAX nor the JAX package", file=sys.stderr)
        return 3
    result = core.finish(cell, out, bool(args.trace))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
