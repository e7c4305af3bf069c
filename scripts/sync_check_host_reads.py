#!/usr/bin/env python3
"""The port's ``host_read`` counter against PyTorch's own view of the host
waiting on the card.

Builds the benchmark's ``plmc_sarcos10k`` model at the cell's size from a
seed (``benchmark/configs/plmc_sarcos10k``), then, under ``torch.profiler``
and ``torch.cuda.set_sync_debug_mode("warn")``, runs one ``fit`` step
(``scan_steps=1``, so its loss is read) and 40 served requests of the
serving cell's sizes. Every synchronizing CUDA operation PyTorch warns of
is listed by the Python line that made it, beside the ``host_read`` counts
of the spans it fell in. Prints one JSON object. Needs one NVIDIA card:

    python3 scripts/sync_check_host_reads.py [--seed 7] [--requests 40]
"""

from __future__ import annotations

import argparse
import json
import sys
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _site(w):
    path = Path(w.filename)
    try:
        path = path.relative_to(ROOT)
    except ValueError:
        path = Path(*path.parts[-2:])
    return f"{path}:{w.lineno}"


def traced(torch, profiling, work):
    """(warning sites, host_read count, spans) of ``work()`` under the
    profiler with the sync debug mode on."""
    profiling.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with torch.profiler.profile(activities=acts):
            torch.cuda.set_sync_debug_mode("warn")
            try:
                work()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    sites = Counter(_site(w) for w in seen
                    if "synchronizing CUDA operation" in str(w.message))
    reads = profiling.summary()["counts"]["host_read"]
    names = Counter(s["name"] for s in profiling.spans())
    return dict(sync_warnings=sum(sites.values()), sites=dict(sites),
                host_read=reads, spans=dict(names))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--requests", type=int, default=40)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]

    import torch

    import projected_lmc_tpu_torch as pl
    from harness import core, data
    from harness.serve import request_sizes
    from projected_lmc_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = core.Cell("plmc_sarcos10k.train")
    cfg, system = cell.config, cell.system
    x, y = data.training_set(cfg, args.seed, dev)
    model = system.build(pl, cfg, x, y,
                         system.leaves_from_seed(cfg, args.seed, dev), dev)

    def one_step():
        pl.fit(model, pl.projected_lmc_mll, n_iter=1, scan_steps=1,
               loss_thresh=0.0, device=dev)

    one_step()                                       # warm, untraced
    out = {"device": torch.cuda.get_device_name(0),
           "train_step": traced(torch, profiling, one_step)}

    serve = core.Cell("plmc_sarcos10k.serve").traffic
    pool = data.serving_pool(serve["batch_max"] * 4, cfg["d"], args.seed,
                             dev)
    sizes = request_sizes(serve, args.seed)[:args.requests]
    prepare, request = system.serving(model)
    cache = prepare()
    for size in sorted(set(sizes.tolist())):         # warm, untraced
        request(cache, pool[:size])
    torch.cuda.synchronize()

    def requests():
        off = 0
        for size in sizes.tolist():
            mean, var = request(cache, pool[off:off + size])
            mean.cpu(), var.cpu()                    # the client's reads
            off = (off + size) % (pool.shape[0] - serve["batch_max"])

    served = traced(torch, profiling, requests)
    served["host_read_in_predict"] = \
        profiling.summary("predict")["counts"]["host_read"]
    served["requests"] = len(sizes)
    out["requests"] = served
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
