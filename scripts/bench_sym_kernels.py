#!/usr/bin/env python3
"""K1–K8 of the PyTorch port on the card: a check, then times.

K1 is ``scaled_kernel_stack_sym``, K2 ``lowrank_stationary_reduce_sym``, K3
``kernel_matrix``, K4 ``lowrank_stationary_reduce_sym_kr``, K5 ``..._krs``
on a bf16 stack, K6 ``scaled_kernel_stack`` (the full grid), K7
``lowrank_stationary_reduce`` (the full grid, here on factors whose A Bfᵀ
is not symmetric) and K8 ``quantized_kernel_stack`` on (x, x) at the int8
product's width (``projected_lmc_tpu_torch/ops/cuda_kernels.py``). The
script first holds each against its plain version at small n (50, and 1237
and 1240, whose rows do and do not start on 16 bytes in bf16) with a
bitwise repeat of the reductions and, for K8, a bitwise symmetric stack
equal to the one a copy of x gives (the full grid). K3 and K6 are held on
rectangles whose row width m does and does not allow 16-byte stores
(1237 × 907, 1237 × 904, 1240 × 906) and below one tile (333 × 50), K6 in
both types, and K6 on (x, x) against K1's stack and K3 against K6 at
os = 1 for bitwise equality. Then it times them with CUDA events at the
main path's widths (q = 4, r = 17, Matérn-2.5) for each n and d given (K3
also by its device time from ``torch.profiler``, at (4, n, 256), (4, 256,
256) and the dense (4, n, n)), splits the reductions' time into their
launches with ``torch.profiler`` (K4, K5, K7: the factor pack, the main
kernel and the second pass), and prints the compiler's register counts for
the d = 4, Matérn-2.5 kernels. It times whatever package lies beside it,
so a copy of it inside an unpacked earlier commit times that commit's
kernels on the same card (a d that commit does not take is reported as
such). Needs one NVIDIA card:

    python3 scripts/bench_sym_kernels.py [--n 10000 20000] [--d 4 21]
        [--kernels K3 K6] [--nvcc-flag=-DX=1]
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np

Q, R, KIND = 4, 17, "matern25"
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")


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


def inputs(torch, n, r, seed, d=4):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa
    x = rng.standard_normal((n, d))
    u0 = rng.standard_normal((Q, n, 1))
    h = (r - 1) // 2
    U, V = rng.standard_normal((2, Q, n, h))
    # A Bfᵀ symmetric, as the fused backward's factors
    A = np.concatenate([u0, U, V], -1)
    Bf = np.concatenate([0.5 * u0, V, U], -1)
    # lengthscales ∝ √d: distances of the same order at every d
    return (t(x - x.mean(0)), t(rng.uniform(0.5, 1.5, (Q, 1, d))
                                * np.sqrt(d / 4)),
            t(rng.uniform(0.5, 2.0, (Q,))), t(A), t(Bf))


def check_kr(torch, ck, x, ls, os_, A, Bf, Ks, n):
    """K4, and K5 on the bf16 stack ``Ks``, against their plain versions:
    rows and wx within 1e-4 of their largest entry, KA within 1e-4 of its,
    the tighter of ``chip_smoke.check_kr``'s two KA limits (its split bf16
    products); returns the worst error/tolerance."""
    worst = 0.0
    for key, run, plain in (
            ("K4", lambda: ck.lowrank_stationary_reduce_sym_kr(
                x, ls, os_, A, Bf, KIND),
             lambda: ck.lowrank_stationary_reduce_sym_kr_plain(
                 x, ls, os_, A, Bf, KIND)),
            ("K5", lambda: ck.lowrank_stationary_reduce_sym_krs(
                x, ls, os_, A, Bf, Ks, KIND),
             lambda: ck.lowrank_stationary_reduce_sym_krs_plain(
                 x, ls, os_, A, Bf, Ks, KIND))):
        got, rep, want = run(), run(), plain()
        scale = max(float(w.abs().max()) for w in want[:2])
        err = max(max(float((g - w).abs().max()) for g, w in
                      zip(got[:2], want[:2])) / (1e-4 * scale),
                  float((got[2] - want[2]).abs().max())
                  / (1e-4 * float(want[2].abs().max())))
        same = all(torch.equal(a, b) for a, b in zip(got, rep))
        print(f"  {key} n={n} r={R}: error/tolerance {err:.3f}, repeat "
              f"bitwise equal {same}")
        worst = max(worst, err, 0.0 if same else 2.0)
    return worst


def check_full_grid(torch, ck, kernels, x, ls, A, n):
    """K7 on factors whose A Bfᵀ is not symmetric (rows and wx within 1e-4
    of their largest entry, a bitwise repeat) and K8 on (x, x) at the int8
    product's width (counts within one of the plain version's in at most
    1e-4 of the entries, as ``chip_smoke.check_counts``; a bitwise
    symmetric stack, equal to the one from a copy of x, which takes the full
    grid); returns the worst error/tolerance."""
    from projected_lmc_tpu_torch.ops import iterative as it
    worst = 0.0
    if "K7" in kernels:
        C = torch.randn(A.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(n))
        got = ck.lowrank_stationary_reduce(x, ls, A, C, KIND)
        rep = ck.lowrank_stationary_reduce(x, ls, A, C, KIND)
        want = ck.lowrank_stationary_reduce_plain(x, ls, A, C, KIND)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want)) \
            / (1e-4 * max(float(w.abs().max()) for w in want))
        same = all(torch.equal(a, b) for a, b in zip(got, rep))
        print(f"  K7 n={n} d={x.shape[1]} r={R}: error/tolerance {err:.3f}, "
              f"repeat bitwise equal {same}")
        worst = max(worst, err, 0.0 if same else 2.0)
    if "K8" in kernels:
        w = it.int8_width(n)
        got = ck.quantized_kernel_stack(x, x, ls, KIND, (w, w))
        want = ck.quantized_kernel_stack_plain(x, x, ls, KIND, (w, w))
        rect = ck.quantized_kernel_stack(x, x.clone(), ls, KIND, (w, w))
        diff = (got.short() - want.short()).abs()
        share = float((diff > 0).sum()) / got.numel()
        err = max(float(diff.max()), share / 1e-4)
        sym = torch.equal(got, got.transpose(-1, -2))
        same = torch.equal(got, rect)
        print(f"  K8 n={n} d={x.shape[1]} padded to {w}: max |count "
              f"difference| {int(diff.max())}, share {share:.3e}; bitwise "
              f"symmetric {sym}, equal to the full grid's {same}")
        worst = max(worst, err, 0.0 if sym and same else 2.0)
    return worst


def check_grid(torch, ck, kernels, d):
    """K3 and K6 against their plain versions (fp32 within 1e-4, bf16 within
    2⁻⁷ of the largest entry, ``chip_smoke.py``'s tolerances) on rectangles
    with and without 16-byte rows and below one tile; K6 on (x, x) bitwise
    equal to K1's stack in both types, K3 bitwise equal to K6 at os = 1;
    returns the worst error/tolerance."""
    worst = 0.0
    rng = np.random.default_rng(d)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa
    ls = t(rng.uniform(0.5, 1.5, (Q, 1, d)) * np.sqrt(d / 4))
    os_ = t(rng.uniform(0.5, 2.0, (Q,)))
    for n, m in ((1237, 907), (1237, 904), (1240, 906), (333, 50)):
        x1, x2 = t(rng.standard_normal((n, d))), t(rng.standard_normal((m, d)))
        errs = []
        if "K6" in kernels:
            for dt in (torch.bfloat16, torch.float32):
                got = ck.scaled_kernel_stack(x1, x2, ls, os_, KIND, dt)
                want = ck.scaled_kernel_stack_plain(x1, x2, ls, os_, KIND, dt)
                tol = 2.0 ** -7 * float(want.float().abs().max()) \
                    if dt == torch.bfloat16 else 1e-4
                errs.append((f"K6 {str(dt)[6:]}", float(
                    (got.float() - want.float()).abs().max()) / tol))
        if "K3" in kernels:
            got = ck.kernel_matrix(x1, x2, ls, KIND)
            errs.append(("K3", float((got - ck.kernel_matrix_plain(
                x1, x2, ls, KIND)).abs().max()) / 1e-4))
        print(f"  n={n} m={m} d={d}: " + ", ".join(
            f"{k} error/tolerance {e:.3f}" for k, e in errs))
        worst = max([worst] + [e for _, e in errs])
    if "K6" in kernels:
        x = t(rng.standard_normal((1240, d)))
        same = {str(dt)[6:]: torch.equal(
            ck.scaled_kernel_stack(x, x, ls, os_, KIND, dt),
            ck.scaled_kernel_stack_sym(x, ls, os_, KIND, dt))
            for dt in (torch.bfloat16, torch.float32)}
        one = torch.ones_like(os_)
        same["K3 = K6 at os = 1"] = torch.equal(
            ck.kernel_matrix(x, x[:907], ls, KIND),
            ck.scaled_kernel_stack(x, x[:907], ls, one, KIND))
        print(f"  d={d}: K6 on (x, x) bitwise equal to K1's stack, and K3 to "
              f"K6: {same}")
        worst = max(worst, 0.0 if all(same.values()) else 2.0)
    return worst


def check(torch, ck, kernels, d=4):
    """The kernels against their plain versions at small n; 1.0 means the
    error equals the tolerance."""
    worst = 0.0
    if "K3" in kernels or "K6" in kernels:
        worst = check_grid(torch, ck, kernels, d)
    for n in (50, 1237, 1240):
        x, ls, os_, A, Bf = inputs(torch, n, R, seed=n, d=d)
        worst = max(worst, check_full_grid(torch, ck, kernels, x, ls, A, n))
        for dt in (torch.bfloat16, torch.float32):
            if "K1" not in kernels:
                break
            got = ck.scaled_kernel_stack_sym(x, ls, os_, KIND, dt)
            want = ck.scaled_kernel_stack_sym_plain(x, ls, os_, KIND, dt)
            tol = 2.0 ** -7 * float(want.float().abs().max()) \
                if dt == torch.bfloat16 else 1e-4
            err = float((got.float() - want.float()).abs().max()) / tol
            sym = torch.equal(got, got.transpose(-1, -2))
            print(f"  K1 n={n} {str(dt)[6:]}: error/tolerance {err:.3f}, "
                  f"bitwise symmetric {sym}")
            worst = max(worst, err, 0.0 if sym else 2.0)
        if "K2" in kernels:
            got = ck.lowrank_stationary_reduce_sym(x, ls, A, Bf, KIND)
            rep = ck.lowrank_stationary_reduce_sym(x, ls, A, Bf, KIND)
            want = ck.lowrank_stationary_reduce_sym_plain(x, ls, A, Bf, KIND)
            tol = 1e-4 * max(float(w.abs().max()) for w in want)
            err = max(float((g - w).abs().max())
                      for g, w in zip(got, want)) / tol
            same = all(torch.equal(a, b) for a, b in zip(got, rep))
            print(f"  K2 n={n} r={R}: error/tolerance {err:.3f}, repeat "
                  f"bitwise equal {same}")
            worst = max(worst, err, 0.0 if same else 2.0)
        if "K4" in kernels or "K5" in kernels:
            Ks = ck.scaled_kernel_stack_sym(x, ls, os_, KIND, torch.bfloat16)
            worst = max(worst, check_kr(torch, ck, x, ls, os_, A, Bf, Ks, n))
    return worst


def by_launch(torch, fn, names, reps=5):
    """Mean device ms of each named kernel that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        if getattr(e, "device_time_total", 0) <= 0:
            continue
        kernel = e.key.split("<")[0].split("(")[-1].split("::")[-1]
        for name in names:
            if name == kernel or name in e.key.split("<")[0].split("::")[-1]:
                parts[name] = parts.get(name, 0.0) \
                    + e.device_time_total / 1e3 / reps
    return ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) \
        or "not measured"


def registers(lib):
    """ptxas's report for the kernels timed here, at d = 4 and Matérn-2.5
    (template arguments Li4E and Li3E, in either order; K4/K5 and the
    K3/K6 kernel of earlier commits have no kind argument), the factor
    packs and the second passes."""
    log = lib.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(log):
        if "Compiling entry" not in line:
            continue
        name = line.split("'")[1]
        if "slot_reduce" in name or "quant_stack_kernelILi3E" in name or (
                "full_grid_kernel" in name and ("Li3E" in name or "Lb" in name)) or (
                ("Li4E" in name or "scaled_stack_sym" in name)
                and ("Li3E" in name or "kr_kernelILi4ELb" in name
                     or "pack_kernelILi4E" in name)):
            used = next((u for u in log[i + 1:i + 4] if "Used" in u), "")
            spill = next((u for u in log[i + 1:i + 5] if "spill" in u), "")
            short = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_stationary_cu_[0-9a-f]{8}",
                           "", name)
            print("  ptxas:", short[:70], "|",
                  used.replace("ptxas info    : ", ""), "|", spill.strip())


def time_kernels(torch, ck, kernels, n, d):
    """Each kernel's time at n and d, on one line."""
    from projected_lmc_tpu_torch.ops import iterative as it
    x, ls, os_, A, Bf = inputs(torch, n, R, seed=1, d=d)
    out = []
    if "K1" in kernels:
        k1 = {str(dt)[6:]: cuda_ms(torch, lambda: ck.scaled_kernel_stack_sym(
            x, ls, os_, KIND, dt)) for dt in (torch.bfloat16, torch.float32)}
        out.append(f"K1 bf16 {k1['bfloat16']:.4f} ms, fp32 "
                   f"{k1['float32']:.4f} ms")
        torch.cuda.empty_cache()
    if "K2" in kernels:
        run_k2 = lambda: ck.lowrank_stationary_reduce_sym(  # noqa
            x, ls, A, Bf, KIND)
        out.append(f"K2 {cuda_ms(torch, run_k2):.4f} ms, by launch "
                   + by_launch(torch, run_k2, ("lowrank_reduce_sym_kernel",
                                               "slot_reduce_kernel")))
    kr_names = ("kr_pack_kernel", "lowrank_reduce_kr_kernel",
                "kr_slot_reduce_kernel")
    if "K4" in kernels:
        run_k4 = lambda: ck.lowrank_stationary_reduce_sym_kr(  # noqa
            x, ls, os_, A, Bf, KIND)
        out.append(f"K4 {cuda_ms(torch, run_k4, reps=10):.4f} ms, by "
                   f"launch " + by_launch(torch, run_k4, kr_names))
    if "K5" in kernels:
        Ks = ck.scaled_kernel_stack_sym(x, ls, os_, KIND, torch.bfloat16)
        run_k5 = lambda: ck.lowrank_stationary_reduce_sym_krs(  # noqa
            x, ls, os_, A, Bf, Ks, KIND)
        out.append(f"K5 (bf16 stack) {cuda_ms(torch, run_k5, reps=10):.4f}"
                   f" ms, by launch " + by_launch(torch, run_k5, kr_names))
        del Ks
    if "K7" in kernels:
        run_k7 = lambda: ck.lowrank_stationary_reduce(  # noqa
            x, ls, A, Bf, KIND)
        out.append(f"K7 {cuda_ms(torch, run_k7, reps=10):.4f} ms, by launch "
                   + by_launch(torch, run_k7, ("k7_pack_kernel",
                                               "lowrank_reduce_kernel",
                                               "slot_reduce_kernel")))
    if "K6" in kernels:
        k6 = {str(dt)[6:]: cuda_ms(torch, lambda: ck.scaled_kernel_stack(
            x, x, ls, os_, KIND, dt)) for dt in (torch.bfloat16, torch.float32)}
        out.append(f"K6 ({Q}, {n}, {n}) bf16 {k6['bfloat16']:.4f} ms, fp32 "
                   f"{k6['float32']:.4f} ms")
        torch.cuda.empty_cache()
    if "K3" in kernels:
        # K3 at the Nyström blocks' shapes is short enough (~0.05 ms) for
        # the host's launch gaps to show in back-to-back events: its device
        # time from the profiler beside them
        z = x[::max(1, n // 256)][:256].contiguous()
        for a, b, reps in ((x, z, 200), (z, z, 200), (x, x, 10)):
            run_k3 = lambda: ck.kernel_matrix(a, b, ls, KIND)  # noqa
            out.append(f"K3 ({Q}, {a.shape[0]}, {b.shape[0]}) "
                       f"{cuda_ms(torch, run_k3, reps=reps):.4f} ms, device "
                       + by_launch(torch, run_k3, ("full_grid_kernel",),
                                   reps=reps))
        torch.cuda.empty_cache()
    if "K8" in kernels:
        w = it.int8_width(n)
        run_k8 = lambda: ck.quantized_kernel_stack(  # noqa
            x, x, ls, KIND, (w, w))
        share = "not measured"   # the plain version forms (q, n, n, d)
        if Q * n * n * d * 4 <= 16e9:
            share = f"{float((run_k8() != ck.quantized_kernel_stack_plain(x, x, ls, KIND, (w, w))).sum()) / (Q * w * w):.3e}"
        out.append(f"K8 ({w}, {w}) {cuda_ms(torch, run_k8):.4f} ms, share "
                   f"of counts unlike the plain version's {share}")
        torch.cuda.empty_cache()
    print(f"n={n} d={d}: " + "; ".join(out))
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[10_000, 20_000])
    ap.add_argument("--d", type=int, nargs="+", default=[4],
                    help="feature counts to check and time at")
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS),
                    choices=KERNELS)
    ap.add_argument("--nvcc-flag", action="append", default=[],
                    help="extra nvcc flag for the kernel build (repeatable)")
    ap.add_argument("--build-only", action="store_true")
    args = ap.parse_args()

    import torch
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
    registers(lib)

    worst = 0.0
    for d in args.d:
        try:
            worst = max(worst, check(torch, ck, args.kernels, d))
        except NotImplementedError as e:
            print(f"d={d}: not taken by this tree ({e})")
            continue
        for n in args.n:
            time_kernels(torch, ck, args.kernels, n, d)
    if worst > 1.0:
        print("bench_sym_kernels: a kernel disagrees with its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
