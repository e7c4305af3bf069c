#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``projected_lmc_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card (H100):

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and exits non-zero:

  1. the card's name and power limit (nvidia-smi) and the kernel build time
     (nvcc of ``projected_lmc_tpu_torch/csrc/stationary.cu``);
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     main path's shapes (and a ragged n), with its stated tolerance; K2's
     bitwise repeat; each kernel's time, its plain version's time and its
     bound (the least time the card could take for the same work);
  3. the fused MLL op, value and gradients, on the card with the kernels
     against the CPU with the plain versions (same eps, xi and roots, fp32
     stack, tight CG), n = 2048;
  4. the exact-LMC training step at full width — n = 10,000, T = 7, q = 4,
     d = 4, Matérn-2.5, mll(max_cg_iters=16, cg_tol=2e-2, matvec_bf16=True,
     precond_rank=256, num_probes=8) + AdamW(1e-2, weight decay 1e-4), Nyström
     roots rebuilt once per 16-step chunk, 2 chunks — with every kernel's
     launch count read from this run alone;
  5. a few iterations of ``training.fit`` at n = 2000.

The last lines are one JSON object with every kernel's numbers, the
nvidia-smi line, and ``{"ok": true, "device": {...}}``. Needs no network and
imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

N, T, Q, D = 10_000, 7, 4, 4             # the main path's widths
STEPS_PER_CHUNK, CHUNKS = 16, 2
PEAK_BYTES_PER_S = 3.35e12               # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12                  # H100 SXM fp32, non-tensor-core
MLL_KW = dict(iterative=True, max_cg_iters=16, cg_tol=2e-2, matvec_bf16=True,
              precond_rank=256, num_probes=8)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    import torch
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


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, "bytes" or "operations") at the published peaks."""
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(name: str, err: float, tol: float):
    ok = math.isfinite(err) and err <= tol
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")


def kernel_phase(torch, ck, dev):
    """Phase 2: each kernel against its plain version, and its times."""
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    ls = t(rng.uniform(0.5, 1.5, (Q, 1, D)))
    os_ = t(rng.uniform(0.5, 2.0, (Q,)))
    rows = {}

    # K1: fp32 tolerance covers the plain version's |a|²+|b|²−2⟨a,b⟩
    # cancellation (~1e-5 at |x/l|² ~ 50); bf16 one rounding of either side
    for n in (N, 1237):
        x = t(rng.standard_normal((n, D)))
        x = x - x.mean(0)
        for dt in (torch.bfloat16, torch.float32):
            got = ck.scaled_kernel_stack_sym(x, ls, os_, "matern25", dt,
                                             device=dev)
            want = ck.scaled_kernel_stack_sym_plain(x, ls, os_, "matern25", dt)
            err = float((got.float() - want.float()).abs().max())
            tol = 2.0 ** -7 * float(want.float().abs().max()) \
                if dt == torch.bfloat16 else 1e-4
            check(f"K1 scaled_kernel_stack_sym n={n} {str(dt)[6:]}", err, tol)
            if n == N and dt == torch.bfloat16:
                rows["K1"] = dict(max_abs_err=err)
            del got, want
    x = t(rng.standard_normal((N, D)))
    x = x - x.mean(0)
    rows["K1"]["ms"] = cuda_ms(lambda: ck.scaled_kernel_stack_sym(
        x, ls, os_, "matern25", torch.bfloat16, device=dev), reps=20)
    rows["K1"]["plain_ms"] = cuda_ms(lambda: ck.scaled_kernel_stack_sym_plain(
        x, ls, os_, "matern25", torch.bfloat16), reps=3, warmup=1)
    pairs = Q * N * (N + 1) / 2
    rows["K1"]["bound"] = bound_ms(
        Q * N * N * 2 + N * D * 4 + Q * (D + 1) * 4,
        pairs * (3 * D + 10))          # d² (3 flops/feature), sqrt, exp, poly
    torch.cuda.empty_cache()

    # K2: A Bfᵀ symmetric by construction, as the fused backward's factors;
    # sums over 10⁴ terms in another order, fast exp: 1e-4 of the largest
    r = 17
    u0 = rng.standard_normal((Q, N, 1))
    U = rng.standard_normal((Q, N, 8))
    V = rng.standard_normal((Q, N, 8))
    A = t(np.concatenate([u0, U, V], -1))
    Bf = t(np.concatenate([0.5 * u0, V, U], -1))
    got_r, got_w = ck.lowrank_stationary_reduce_sym(x, ls, A, Bf, "matern25",
                                                    device=dev)
    rep_r, rep_w = ck.lowrank_stationary_reduce_sym(x, ls, A, Bf, "matern25",
                                                    device=dev)
    bitwise = bool(torch.equal(got_r, rep_r) and torch.equal(got_w, rep_w))
    print(f"  K2 lowrank_stationary_reduce_sym repeat bitwise equal: {bitwise}")
    if not bitwise:
        raise SystemExit("chip_smoke: K2 is not deterministic")
    want_r, want_w = ck.lowrank_stationary_reduce_sym_plain(x, ls, A, Bf,
                                                            "matern25")
    err = max(float((got_r - want_r).abs().max()),
              float((got_w - want_w).abs().max()))
    tol = 1e-4 * max(float(want_r.abs().max()), float(want_w.abs().max()))
    check(f"K2 lowrank_stationary_reduce_sym n={N} r={r}", err, tol)
    del want_r, want_w
    torch.cuda.empty_cache()
    rows["K2"] = dict(max_abs_err=err)
    rows["K2"]["ms"] = cuda_ms(lambda: ck.lowrank_stationary_reduce_sym(
        x, ls, A, Bf, "matern25", device=dev), reps=20)
    rows["K2"]["plain_ms"] = cuda_ms(lambda: ck.lowrank_stationary_reduce_sym_plain(
        x, ls, A, Bf, "matern25"), reps=3, warmup=1)
    torch.cuda.empty_cache()
    rows["K2"]["bound"] = bound_ms(
        2 * Q * N * r * 4 + N * D * 4 + Q * N * (1 + D) * 4,
        # T (2r), d² (3d), g′ (~7 incl. sqrt, exp), row and column sums
        pairs * (2 * r + 3 * D + 7 + 2 * (1 + 2 * D)))

    # K3: the Nyström blocks of the main path, fp32 (tolerance as K1 fp32)
    idx = torch.as_tensor(np.linspace(0, N - 1, 256).astype(np.int32),
                          device=dev, dtype=torch.long)
    z = x[idx]
    for a, b in ((x, z), (z, z)):
        got = ck.kernel_matrix(a, b, ls, "matern25", device=dev)
        want = ck.kernel_matrix_plain(a, b, ls, "matern25")
        err = float((got - want).abs().max())
        check(f"K3 kernel_matrix ({Q},{a.shape[0]},{b.shape[0]})", err, 1e-4)
        if a.shape[0] == N:
            rows["K3"] = dict(max_abs_err=err)
    rows["K3"]["ms"] = cuda_ms(
        lambda: ck.kernel_matrix(x, z, ls, "matern25", device=dev), reps=50)
    rows["K3"]["plain_ms"] = cuda_ms(
        lambda: ck.kernel_matrix_plain(x, z, ls, "matern25"), reps=50)
    rows["K3"]["bound"] = bound_ms(Q * N * 256 * 4 + (N + 256) * D * 4,
                                   Q * N * 256 * (3 * D + 10))
    small = cuda_ms(
        lambda: ck.kernel_matrix(z, z, ls, "matern25", device=dev), reps=50)
    print(f"  K3 at ({Q},256,256): {small:.4f} ms")
    # every profile and several feature counts (kernel templates), small n
    for kind in ck.KINDS:
        for d in (1, 3, 8):
            n = 333
            xs = t(rng.standard_normal((n, d)))
            lss = t(rng.uniform(0.5, 1.5, (Q, 1, d)))
            U, V = rng.standard_normal((2, Q, n, 3))
            As, Bs = t(np.concatenate([U, V], -1)), t(np.concatenate([V, U], -1))
            e1 = float((ck.scaled_kernel_stack_sym(xs, lss, os_, kind,
                                                   device=dev)
                        - ck.scaled_kernel_stack_sym_plain(xs, lss, os_, kind)
                        ).abs().max())
            e3 = float((ck.kernel_matrix(xs, xs[:50], lss, kind, device=dev)
                        - ck.kernel_matrix_plain(xs, xs[:50], lss, kind)
                        ).abs().max())
            got = ck.lowrank_stationary_reduce_sym(xs, lss, As, Bs, kind,
                                                   device=dev)
            want = ck.lowrank_stationary_reduce_sym_plain(xs, lss, As, Bs, kind)
            e2 = max(float((g - w).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            check(f"K1+K3 {kind} d={d} n={n}", max(e1, e3), 1e-4)
            check(f"K2 {kind} d={d} n={n}", e2, 1e-4 * scale)
    for k, row in rows.items():
        b, by = row["bound"]
        print(f"  {k}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
              f"bound {b:.4f} ms by {by})")
    return rows


def bench_data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D)).astype(np.float32)
    Y = rng.standard_normal((n, T)).astype(np.float32)
    return X, Y


def make_model(pl, X, Y, device):
    lik = pl.MultitaskGaussianLikelihood(num_tasks=T, rank=0, device=device)
    return pl.MultitaskGPModel(X, Y, lik, n_tasks=T, n_latents=Q,
                               model_type="LMC", kernel_type="matern",
                               mean_type="zero", fix_diagonal=True,
                               device=device)


def fused_phase(torch, pl, fm, dev):
    """Phase 3: the fused op on the card (kernels) vs the CPU (plain)."""
    n = 2048
    X, Y = bench_data(n, seed=2)
    model = make_model(pl, X, Y, dev)
    with torch.no_grad():
        model.covar_module.raw_lengthscale.add_(torch.as_tensor(
            np.random.default_rng(3).uniform(-0.3, 0.3, (Q, 1, D)),
            dtype=torch.float32, device=dev))
        roots = model._precond_roots(model.train_x, 256)
    gen = torch.Generator(device=dev).manual_seed(0)
    eps = torch.randn((8, n, T), generator=gen, dtype=torch.float32,
                      device=dev)
    xi = torch.randn((8, Q, 256), generator=gen, dtype=torch.float32,
                     device=dev)
    H = model.covar_factor[..., 0].T.detach()
    St = (model.likelihood.task_covariance()
          + torch.diag(model._lmc_extra_diag())).detach()
    ls = model.covar_module.lengthscale.detach()
    os_ = torch.ones(Q, dtype=torch.float32, device=dev)
    Yd = model.train_y.T.contiguous()
    out = {}
    for where in (dev, torch.device("cpu")):
        leaves = [a.to(where).clone().requires_grad_(True)
                  for a in (ls, os_, H, St, Yd)]
        ll = fm.lmc_pcg_log_prob_stationary(
            model.train_x.to(where), *leaves, eps.to(where), xi.to(where),
            roots.to(where), "matern25", max_cg_iters=100, cg_tol=1e-5,
            matvec_bf16=False, precond_rank=256, device=where)
        ll.backward()
        out[where.type] = (float(ll.detach()), [a.grad.cpu() for a in leaves])
    (vg, gg), (vc, gc) = out["cuda"], out["cpu"]
    rel = abs(vg - vc) / abs(vc)
    print(f"  value cuda {vg:.6f} cpu {vc:.6f} rel {rel:.2e} (tolerance 1e-4)")
    if not (math.isfinite(vg) and rel <= 1e-4):
        raise SystemExit("chip_smoke: fused MLL value disagrees")
    for name, a, b in zip(("ls", "os", "H", "St", "Y"), gg, gc):
        e = float((a - b).abs().max() / b.abs().max())
        print(f"  grad {name}: max|Δ|/max|cpu| {e:.2e} (tolerance 2e-3)")
        if not (math.isfinite(e) and e <= 2e-3):
            raise SystemExit(f"chip_smoke: fused MLL gradient {name} disagrees")


def train_phase(torch, pl, ck, dev):
    """Phase 4: the full-width training loop; kernel counts of this run."""
    X, Y = bench_data(N, seed=0)
    model = make_model(pl, X, Y, dev)
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad],
                            lr=1e-2, weight_decay=1e-4)
    gen = torch.Generator(device=dev).manual_seed(0)
    wrappers = (ck.scaled_kernel_stack_sym, ck.lowrank_stationary_reduce_sym,
                ck.kernel_matrix)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    losses, step_ms, chunk_ms = [], [], []
    for _ in range(CHUNKS):
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        with torch.no_grad():
            roots = model._precond_roots(model.train_x, MLL_KW["precond_rank"])
        for _ in range(STEPS_PER_CHUNK):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = -model.mll(precond_roots=roots, generator=gen, **MLL_KW)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - s0) * 1e3)
            losses.append(loss.detach())
        chunk_ms.append((time.perf_counter() - c0) * 1e3)
    counts = [w.launches for w in wrappers]
    losses = torch.stack(losses).cpu().numpy()
    print(f"  losses: first {losses[0]:.6f} last {losses[-1]:.6f} "
          f"all finite {bool(np.all(np.isfinite(losses)))}")
    print(f"  median step {float(np.median(step_ms)):.3f} ms (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}); chunk of "
          f"{STEPS_PER_CHUNK} incl. roots {chunk_ms}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches K1 {counts[0]} K2 {counts[1]} K3 {counts[2]} "
          f"(expected {CHUNKS * STEPS_PER_CHUNK}, "
          f"{CHUNKS * STEPS_PER_CHUNK}, {2 * CHUNKS})")
    if not np.all(np.isfinite(losses)):
        raise SystemExit("chip_smoke: non-finite training loss")
    if counts != [CHUNKS * STEPS_PER_CHUNK] * 2 + [2 * CHUNKS]:
        raise SystemExit("chip_smoke: the main path missed a kernel")
    params = torch.cat([p.detach().flatten() for p in model.parameters()])
    if not bool(torch.isfinite(params).all()):
        raise SystemExit("chip_smoke: non-finite parameters after training")
    return counts


def fit_phase(torch, pl, dev):
    """Phase 5: the ``training.fit`` entry point at a smaller n."""
    X, Y = bench_data(2000, seed=4)
    model = make_model(pl, X, Y, dev)

    def loss_fn(m, generator):
        return m.mll(generator=generator, **MLL_KW)

    _, info = pl.fit(model, loss_fn, n_iter=4, lr=1e-2, device=dev)
    print(f"  fit losses {info['losses'].tolist()} in {info['train_time']:.2f} s")
    if len(info["losses"]) != 4 or not np.all(np.isfinite(info["losses"])):
        raise SystemExit("chip_smoke: training.fit gave non-finite losses")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import projected_lmc_tpu_torch as pl
    if not os.path.abspath(pl.__file__).startswith(here + os.sep):
        raise SystemExit(f"chip_smoke: {pl.__file__} is not this checkout's "
                         f"package")
    from projected_lmc_tpu_torch.ops import _build, cuda_kernels as ck
    from projected_lmc_tpu_torch.ops import fused_mll as fm
    from projected_lmc_tpu_torch.ops import iterative as it
    from projected_lmc_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"  kernel build {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    print(f"  bf16 stack product with fp32 result via "
          f"{'torch.bmm(out_dtype=float32)' if it._BMM_OUT_DTYPE else 'per-latent fp32 up-cast'}")

    print("phase 2: kernels against their plain versions")
    rows = kernel_phase(torch, ck, dev)
    print("phase 3: fused MLL, card with kernels vs CPU with plain versions, "
          "n=2048")
    fused_phase(torch, pl, fm, dev)
    print(f"phase 4: training loop n={N} T={T} q={Q} d={D}, "
          f"{CHUNKS}x{STEPS_PER_CHUNK} steps")
    counts = train_phase(torch, pl, ck, dev)
    print("phase 5: training.fit, n=2000, 4 iterations")
    fit_phase(torch, pl, dev)

    meta = [("K1", "scaled_kernel_stack_sym",
             "projected_lmc_tpu/ops/pallas_kernels.py:278"),
            ("K2", "lowrank_stationary_reduce_sym",
             "projected_lmc_tpu/ops/pallas_kernels.py:470"),
            ("K3", "kernel_matrix",
             "projected_lmc_tpu/ops/pallas_kernels.py:912")]
    kernels = []
    for (key, name, replaces), launches in zip(meta, counts):
        row = rows[key]
        b, by = row["bound"]
        kernels.append(dict(
            name=name, route="cuda",
            source="projected_lmc_tpu_torch/csrc/stationary.cu",
            replaces=replaces, launches=launches,
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=b, bound_by=by,
            library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
