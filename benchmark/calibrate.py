"""Readings that the limits of ``limits/<workload>.json`` are set from, on
the chip at the cell's own sizes, several seeds in one process:

    python3 benchmark/calibrate.py --workload <name> --mode <mode> \
        --seeds 11,12,13 [--seconds 1]

``sound``: the program as the configuration states it (the lower
readings). ``control``: the configuration's control, the program's own
lower-precision path where it has one (``system.CONTROL``), else the
reference put in the program's place and computed in float32 with TF32
on, against the reference. ``half`` and ``altered``: a planted fault (half
of the rows or of each batch left out; each answer altered where it is
produced). One JSON line per seed: its numbers and whether the limits in
force pass them. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent


def reference_control(cell, seed, device):
    """The reference in float32 with TF32 on, in the program's place,
    against the reference itself."""
    import torch
    from harness import compare, data
    from harness.serve import request_sizes
    from reference.common import precision

    cfg = cell.config
    x, y = data.training_set(cfg, seed, device)
    start = cell.system.leaves_from_seed(cfg, seed, device)
    if cell.traffic["loop"] == "train":
        steps = cell.traffic["checked_steps"]
        with precision(tf32=False):
            ref = cell.reference.train(x, y, start, cfg, steps)
        with precision(tf32=True):
            low = cell.reference.train(x, y, start, cfg, steps,
                                       dtype=torch.float32)
        return compare.training_numbers(
            [-v for v in low[0]], [-v for v in ref[0]], low[1], ref[1],
            start, low[2], ref[2])
    tr = cell.traffic
    pool = data.serving_pool(tr["pool_points"], cfg["d"], seed, device)
    sizes = list(request_sizes(tr, seed)[:tr["check_requests"] - 1]) \
        + [tr["batch_max"]]
    with precision(tf32=False):
        ref = cell.reference.Posterior(x, y, start, cfg)
    with precision(tf32=True):
        low = cell.reference.Posterior(x, y, start, cfg, dtype=torch.float32)
        pairs, off = [], 0
        for size in sizes:
            xs = pool[off:off + int(size)]
            off += int(size)
            m, v = low(xs)
            with precision(tf32=False):
                rm, rv = ref(xs)
            pairs.append((m.cpu(), v.cpu(), rm.cpu(), rv.cpu()))
    return compare.serving_numbers(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True,
                    choices=("sound", "control", "half", "altered"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for p in (str(CHECKOUT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from harness import core
    from harness.compare import verdict
    import projected_lmc_tpu_torch as pl

    cell = core.Cell(args.workload)
    device = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        variant = None if args.mode == "sound" else args.mode
        if args.mode == "control":
            variant = getattr(cell.system, "CONTROL", None)
        if args.mode == "control" and variant is None:
            numbers = reference_control(cell, seed, device)
        else:
            out = cell.loop.run(cell, pl, seed, args.seconds, False, device,
                                t, variant)
            numbers = out["numbers"]
        ok, _ = verdict(numbers, cell.limits)
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "numbers": numbers,
                          "passes_limits": ok,
                          "seconds": round(time.time() - t, 1)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
