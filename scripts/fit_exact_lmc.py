#!/usr/bin/env python3
"""Train a benchmark configuration of the exact LMC with ``training.fit``
for a number of steps, started as the benchmark's training loop starts it
(the data, leaves and probes of ``--seed``; chunks of 16 steps, the roots
rebuilt at each chunk's start), with the PCG's counters on, and print each
chunk's losses and the right-hand sides the PCG froze at its breakdown
guard.

    python3 scripts/fit_exact_lmc.py --config lmc_exact_sarcos10k \\
        --seed 5000000006 --steps 224

Needs the card. The counters count only while a profiler records, so the
fit runs under ``torch.profiler`` on the host's activity alone. The last
line is one JSON object: the steps taken, whether every loss is finite,
the first and last loss, the frozen right-hand sides a step, the CG steps
a solve, peak memory and the error if ``fit`` raised (exit code 1).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    import projected_lmc_tpu_torch as pl
    from harness import data
    from harness.core import load_file
    from projected_lmc_tpu_torch.training import fit
    from projected_lmc_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("fit_exact_lmc: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    folder = BENCH / "configs" / args.config
    cfg = json.loads((folder / "config.json").read_text())
    system = load_file(folder / "system.py", "fit_exact_lmc_system")
    x, y = data.training_set(cfg, args.seed, dev)
    model = system.build(pl, cfg, x, y,
                         system.leaves_from_seed(cfg, args.seed, dev), dev)

    class Record:
        losses = []

        def probes(self, call, **tensors):
            pass

        def loss(self, value):
            self.losses.append(value.detach())

    rec = Record()
    loss_fn = system.objective(pl, cfg, rec)
    chunk = 16
    frozen_seen = [0]

    def on_chunk(_, i):
        counts = profiling.summary()["counts"]
        frozen = counts["cg.frozen"] - frozen_seen[0]
        frozen_seen[0] = counts["cg.frozen"]
        last = torch.stack(rec.losses[-chunk:]).tolist()
        print(f"steps {i - chunk}..{i - 1}: mll first {last[0]:.6f} last "
              f"{last[-1]:.6f}, all finite "
              f"{all(math.isfinite(v) for v in last)}, frozen {frozen}",
              flush=True)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card {card}; {args.config} n={cfg['n']} seed {args.seed}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    opt = cfg["optimizer"]
    error = None
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        try:
            fit(model, loss_fn, n_iter=args.steps, lr=opt["lr"],
                weight_decay=opt["weight_decay"], loss_thresh=0.0,
                scan_steps=chunk, seed=(args.seed * 8 + data.PROBES) % 2 ** 63,
                eval_every=chunk, eval_fn=on_chunk, device=dev)
        except Exception as exc:                     # noqa: BLE001
            error = f"{type(exc).__name__}: {exc}"[:300]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(rec.losses).tolist() if rec.losses else []
    counts = profiling.summary()["counts"]
    steps = len(losses)
    out = dict(config=args.config, n=cfg["n"], seed=args.seed, steps=steps,
               finite=all(math.isfinite(v) for v in losses),
               first_mll=losses[0] if losses else None,
               last_mll=losses[-1] if losses else None,
               pcg_frozen_per_step=counts["cg.frozen"] / max(steps, 1),
               cg_iters_per_solve=counts["cg.iters"]
               / max(counts["cg.solves"], 1),
               seconds=round(wall, 1),
               memory_peak_bytes=int(torch.cuda.max_memory_allocated()),
               device=torch.cuda.get_device_name(0), error=error)
    print(json.dumps(out))
    return 1 if error or not out["finite"] or steps < args.steps else 0


if __name__ == "__main__":
    sys.exit(main())
