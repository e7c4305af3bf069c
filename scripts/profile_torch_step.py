#!/usr/bin/env python3
"""Where the PyTorch port's exact-LMC training step spends its time on the card.

Runs the main path of ``chip_smoke.py`` (n = 10,000, T = 7, q = 4, d = 4,
Matérn-2.5, mll(max_cg_iters=16, cg_tol=2e-2, matvec_bf16=True,
precond_rank=256, num_probes=8) + AdamW, roots fixed for the window) and
first times ``--timed-steps`` steps without the profiler (median and fastest,
host clock around a synchronised step), then profiles a few steady steps with
``torch.profiler``. Prints the wall time per step, the device-busy share (sum
of kernel times over wall time) and the kernels by total device time. It runs
the package that lies beside it, so a copy inside an unpacked earlier commit
measures that commit on the same card. Needs one NVIDIA card:

    python3 scripts/profile_torch_step.py [--steps 8] [--timed-steps 32]
                                          [--out step_trace.json]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--timed-steps", type=int, default=32,
                    help="steps timed without the profiler first")
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--out", default="",
                    help="optional path for a chrome trace of the window")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_torch_step: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import projected_lmc_tpu_torch as pl

    n, T, q = args.n, 7, 4
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    Y = rng.standard_normal((n, T)).astype(np.float32)
    lik = pl.MultitaskGaussianLikelihood(num_tasks=T, rank=0, device="cuda")
    model = pl.MultitaskGPModel(X, Y, lik, n_tasks=T, n_latents=q,
                                model_type="LMC", kernel_type="matern",
                                mean_type="zero", fix_diagonal=True,
                                device="cuda")
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad],
                            lr=1e-2, weight_decay=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        roots = model._precond_roots(model.train_x, 256)
    kw = dict(iterative=True, max_cg_iters=16, cg_tol=2e-2, matvec_bf16=True,
              precond_rank=256, num_probes=8, precond_roots=roots,
              generator=gen)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = -model.mll(**kw)
        loss.backward()
        opt.step()

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(args.timed_steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if step_ms:
        print(f"unprofiled: {len(step_ms)} steps, median "
              f"{float(np.median(step_ms)):.3f} ms, fastest "
              f"{min(step_ms):.3f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in events) / 1e3      # ms
    print(f"card {torch.cuda.get_device_name(0)}; n={n}; {args.steps} steps; "
          f"wall {wall / args.steps:.3f} ms/step; device busy "
          f"{busy / args.steps:.3f} ms/step ({100 * busy / wall:.1f}%); "
          f"{sum(e.count for e in events) / args.steps:.0f} kernel launches "
          f"per step")
    events.sort(key=lambda e: -e.device_time_total)
    for e in events[:20]:
        print(f"  {e.device_time_total / 1e3 / args.steps:9.4f} ms/step "
              f"{e.count // args.steps:5d}x  {e.key[:110]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        prof.export_chrome_trace(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
