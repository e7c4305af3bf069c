#!/usr/bin/env python3
"""K1 and K2 of the PyTorch port on the card: a check, then their times.

K1 is ``scaled_kernel_stack_sym`` and K2 ``lowrank_stationary_reduce_sym``
(``projected_lmc_tpu_torch/ops/cuda_kernels.py``). The script first holds
both against their plain versions at a small ragged n, then times them with
CUDA events at the main path's widths (q = 4, d = 4, r = 17, Matérn-2.5) for
each n given, splits K2's time into its two launches with ``torch.profiler``,
and prints the compiler's register counts for the d = 4 kernels. It times
whatever package lies beside it, so a copy of it inside an unpacked earlier
commit times that commit's kernels on the same card. Needs one NVIDIA card:

    python3 scripts/bench_sym_kernels.py [--n 10000 20000] [--nvcc-flag=-DX=1]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

Q, D, R, KIND = 4, 4, 17, "matern25"


def cuda_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(torch, n, r, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa
    x = rng.standard_normal((n, D))
    u0 = rng.standard_normal((Q, n, 1))
    h = (r - 1) // 2
    U, V = rng.standard_normal((2, Q, n, h))
    # A Bfᵀ symmetric, as the fused backward's factors
    A = np.concatenate([u0, U, V], -1)
    Bf = np.concatenate([0.5 * u0, V, U], -1)
    return (t(x - x.mean(0)), t(rng.uniform(0.5, 1.5, (Q, 1, D))),
            t(rng.uniform(0.5, 2.0, (Q,))), t(A), t(Bf))


def check(torch, ck):
    """Both kernels against their plain versions at small n; 1.0 means the
    error equals the tolerance."""
    worst = 0.0
    for n in (50, 1237, 1240):
        x, ls, os_, A, Bf = inputs(torch, n, R, seed=n)
        for dt in (torch.bfloat16, torch.float32):
            got = ck.scaled_kernel_stack_sym(x, ls, os_, KIND, dt)
            want = ck.scaled_kernel_stack_sym_plain(x, ls, os_, KIND, dt)
            tol = 2.0 ** -7 * float(want.float().abs().max()) \
                if dt == torch.bfloat16 else 1e-4
            err = float((got.float() - want.float()).abs().max()) / tol
            sym = torch.equal(got, got.transpose(-1, -2))
            print(f"  K1 n={n} {str(dt)[6:]}: error/tolerance {err:.3f}, "
                  f"bitwise symmetric {sym}")
            worst = max(worst, err, 0.0 if sym else 2.0)
        got = ck.lowrank_stationary_reduce_sym(x, ls, A, Bf, KIND)
        rep = ck.lowrank_stationary_reduce_sym(x, ls, A, Bf, KIND)
        want = ck.lowrank_stationary_reduce_sym_plain(x, ls, A, Bf, KIND)
        tol = 1e-4 * max(float(w.abs().max()) for w in want)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want)) / tol
        same = all(torch.equal(a, b) for a, b in zip(got, rep))
        print(f"  K2 n={n} r={R}: error/tolerance {err:.3f}, repeat bitwise "
              f"equal {same}")
        worst = max(worst, err, 0.0 if same else 2.0)
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[10_000, 20_000])
    ap.add_argument("--nvcc-flag", action="append", default=[],
                    help="extra nvcc flag for the kernel build (repeatable)")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("bench_sym_kernels: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from projected_lmc_tpu_torch.ops import _build, cuda_kernels as ck
    _build.NVCC_FLAGS = tuple(_build.NVCC_FLAGS) + tuple(args.nvcc_flag)
    lib = _build.build()
    if args.build_only:
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card {card}; flags {args.nvcc_flag}; {lib.name}")
    log = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" in line and any(
                k in line for k in ("scaled_stack_sym", "lowrank_reduce_sym_kernel",
                                    "slot_reduce")) \
                and "kr_" not in line and ("Li4E" in line or "ILi" not in line):
            used = next((u for u in log[i + 1:i + 4] if "Used" in u), "")
            print("  ptxas:", line.split("'")[1][:70], "|",
                  used.replace("ptxas info    : ", ""))

    worst = check(torch, ck)
    for n in args.n:
        x, ls, os_, A, Bf = inputs(torch, n, R, seed=1)
        k1 = {str(dt)[6:]: cuda_ms(torch, lambda: ck.scaled_kernel_stack_sym(
            x, ls, os_, KIND, dt)) for dt in (torch.bfloat16, torch.float32)}
        torch.cuda.empty_cache()
        run_k2 = lambda: ck.lowrank_stationary_reduce_sym(x, ls, A, Bf, KIND)  # noqa
        k2 = cuda_ms(torch, run_k2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run_k2()
            torch.cuda.synchronize()
        parts = {name: e.device_time_total / 1e3 / 5
                 for e in prof.key_averages()
                 for name in ("lowrank_reduce_sym_kernel", "slot_reduce_kernel")
                 if name in e.key and "kr_" not in e.key
                 and getattr(e, "device_time_total", 0) > 0}
        print(f"n={n}: K1 bf16 {k1['bfloat16']:.4f} ms, fp32 "
              f"{k1['float32']:.4f} ms; K2 {k2:.4f} ms, by launch "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        torch.cuda.empty_cache()
    if worst > 1.0:
        print("bench_sym_kernels: a kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
