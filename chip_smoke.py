#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``projected_lmc_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card (H100):

    python3 chip_smoke.py

(``python3 chip_smoke.py --only M``, ``--only N`` or ``--only P`` builds the
kernels and runs path M, N or P alone, ``--only O`` runs path O alone without a
build, each without the kernels line and the result line.) Phases, each
printing its own line(s); any failure raises and exits non-zero:

  1. the card's name and power limit (nvidia-smi) and the kernel build time
     (nvcc of ``projected_lmc_tpu_torch/csrc/stationary.cu``);
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     main path's shapes (and a ragged n), with its stated tolerance; the
     reductions' bitwise repeats; each kernel's time, its plain version's
     time and its bound (the least time the card could take for the same
     work). K1 also at n = 20,000, at an n whose rows do not start on 16
     bytes, at one that leaves a ragged tile and at one below a tile, each
     stack bitwise symmetric, and bitwise equal to K6 on (x, x) at n = 10,000
     in both types; K3 bitwise equal to K6 at os = 1, at the Nystrom block
     and at the dense (4, 10,000, 10,000), with its profiler device time; K2 also at
     n = 20,000 and a second rank, with its two launches timed apart; K4
     and K5 also timed at n = 20,000, with the bytes of their scratch; K8's
     symmetric stack bitwise symmetric and equal to the full grid's; K3
     and K6 on ragged rectangles (m not a multiple of 8; m a multiple of 8
     with a ragged n); K3 with a bf16 output equal to its fp32 result cast
     once. Every kernel at
     small n for each profile and d = 1, 3, 8, 9, 21, 32; K1, K2, K7 and K8
     timed at n = 10,000 with d = 21 beside d = 4. The int8 stack product
     beside the bf16 one, and the bf16 one by the layout of its right-hand
     sides;
  3. the fused MLL op, value and gradients, on the card with the kernels
     against the CPU with the plain versions (same eps, xi and roots, tight
     CG), n = 2048, on the default backward route, forced onto K4
     (``PLMC_KR_FUSED=1``) and K5 (``PLMC_KR_STREAM=1``), with the int8
     stack, and on the full grid (``PLMC_SYM_BUILD=0``, fp32 and bf16);
  4. the exact-LMC training step at full width — n = 10,000, T = 7, q = 4,
     d = 4, Matérn-2.5, mll(max_cg_iters=16, cg_tol=2e-2, matvec_bf16=True,
     precond_rank=256, num_probes=8) + AdamW(1e-2, weight decay 1e-4), Nyström
     roots rebuilt once per 16-step chunk, 2 chunks, on the default backward
     route — with every kernel's launch count read from this run alone;
  5. a few iterations of ``training.fit`` at n = 2000;
  A. path A: that step at n = 20,000, and at 5,000 and 10,000 for the
     routing rule, one 16-step chunk on each backward route (K2 + stack
     product, K4, K5): step times, peak memory, launch counts, each route's
     kernel times, the two tests of the rule that sets ``KR_MIN_N``, and the
     route the port takes by default;
  B. path B: ``ExactGPModel`` (T = 7, Matérn-2.5, outputscales) at
     n = 16,384, whose MLL auto-routes to the fused iterative op, 8 AdamW
     steps; and its value and gradients on the card against the CPU at
     n = 2048 through K4;
  C. path C: the int8 stack at full width: ``training.fit_two_phase`` with
     24 steps of mll(matvec_int8=True, max_cg_iters=16, cg_tol=2e-2) and 8
     fp32 steps of mll(max_cg_iters=64, cg_tol=1e-4) (K8 + K2, then K1 +
     K2), then one 16-step chunk of the int8 step with stale roots;
  D. path D: phase 4's step with ``PLMC_SYM_BUILD=0`` (K6 + K7), one
     16-step chunk;
  E. path E: phase 4's step at d = 21 (SARCOS's input features; the
     reductions run at a padded width of 24), one 16-step chunk, then one
     16-step chunk of mll(matvec_int8=True) at d = 21 (K1 + K2, then
     K8 + K2, with K3);
  F. path F: projected LMC (``ProjectedGPModel`` + ``projected_lmc_mll``,
     K3 and the dense batched Cholesky). F1: the paper's synthetic default
     (``generate_synthetic()``: n = 500, p = 100, d = 1) with q = 25, in
     each model configuration of the paper's experiments (PLMC,
     PLMC_fast, oilmm, oilmm with ``bulk=False``), 64 ``fit`` steps each:
     first and last losses, median step, launches and factorizations (one
     of each a step), the first step on the card against the CPU, the QR's
     orthogonality, and the QR's (or orthogonal map's) time in a profile.
     F2: the full-B̃ model on phase 4's data (n = 10,000, p = 7, d = 4)
     with q = 4, 16 ``fit`` steps: median step, the device time split by
     labelled ranges, peak memory, the ladder's one factorization against
     the old ladder's nine, K3 against its plain version at (4, n, n), and
     the card against the CPU at n = 2048;
  G. path G: prediction, served from a cache built once (K3 and the dense
     batched Cholesky, or K3's stack and PCG). G1: F2's model after 16 ``fit``
     steps: ``prediction_cache`` once, 8 ``predict`` calls on 2,500 held-out
     points (first and median), one cold ``predict``, one ``compute_loo``,
     peak memory and the 15 metrics of ``compute_metrics``. G2: the paper's
     synthetic default in F1's four configurations, ``fit`` for at most 2,000
     steps (to the plateau or the cap; the line says which),
     ``predict(observed=True)`` on its 2,500 test points and R², RMSE, PVA and
     α_CI beside the README's JAX figures. G3: phase 4's model trained as phase
     4, its "lmc_iter" cache (the dense K3 stack, Nyström roots, PCG to 1e-5,
     the residual's spectral bound, the inflated factors) timed by part with
     the PCG's iterations, its host time an iteration and peak memory,
     ``posterior`` on 2,500 points, and ``fit`` with the default (dense
     Woodbury) loss at q·n = 4,096. K3 at
     the path's cross-covariance shapes against its plain version and
     bitwise against K6; the card against the CPU (same leaves, moved off the
     init) at n = 2048 for G1 and G3 (both routes; the LOO at n = 512) and
     for G2's trained models: mean within 1e-4 of its largest entry (1e-3
     for "lmc_iter"), variance within 1e-3 of the largest prior variance,
     LOO σ² and residuals within 1e-3, each metric within 1e-3.
  H. path H: the exact ICM (``MultitaskGPModel(model_type="ICM")``, K3
     only). H1: the experiment driver's ICM (likelihood rank 25,
     n_latents 25) on the paper's synthetic default, ``fit`` for at most 2,000
     steps (to the plateau or the cap) on the dense route with its eigh's
     share, then the "icm" cache, ``posterior`` and ``compute_var`` on the
     2,500 test points and the metrics, held against the CPU's fp64 metrics on
     the same leaves (no farther than the CPU's fp32 ones, within 1e-3 where
     those are). H2: the matrix-free route at n = 16,384, T = 7, q = 4, d = 4,
     trained as phase 4 (2 chunks of 16 bf16 steps), the device split by
     labelled ranges, then the "icm_iter" cache timed by part, ``posterior``
     and ``compute_var`` on 2,500 points; K3 at its (1, n, n) fp32 and bf16
     and (1, 2,500, n) shapes against its plain version and K6. H3: the
     dense route at n = 8,192, 4 ``fit`` steps split into K3, potrf, the
     one-column triangular solve, the backward's eigh and its n³ products,
     and one "icm" cache. The card against the CPU at n = 2048 (the dense
     and the matrix-free MLL on the same probes and roots, value rel.
     ≤ 1e-4 and gradients ≤ 2e-3; both posteriors and ``compute_var``;
     the LOO at n = 512), with path G's limits.
  I. path I: variational LMC and SGPR (K3 only). I1: the driver's var
     model (likelihood rank 25, q = 25, m = 333) on the paper's synthetic
     default, ``fit`` on the ELBO for at most 1,000 steps (a cap it
     reaches short of the plateau; the line says where it stopped),
     ``model(x, observed=True)`` on the 2,500 test points and the metrics,
     then ``sgpr_em()`` from the same init and its metrics. I2: the ELBO at
     ``bench_var_elbo``'s shapes (n = 4,449, d = 21, T = q = 7, m = 500),
     16 AdamW steps, then 64 ``fit_svgp_minibatch`` steps (batch 256) at
     n = 44,484. I3: projected SGPR at ``bench_predict_p50``'s shapes
     (n = 44,480, 4,449 test points), 16 ``fit`` steps, the cache, 8 warm
     ``predict`` calls and a cold one. I4: LMC, ICM and ``ExactGPModel``
     SGPR on the headline's data (m = 500), 16 steps, the "sgpr" cache and
     ``posterior`` on 2,500 points each. Steps split by labelled profiler
     ranges; K3 at each new shape against its plain version and bitwise K6;
     the card against the CPU at n = 2048, m = 256 (the ELBO for each
     strategy and distribution, each SGPR MLL, value rel. ≤ 1e-4 and
     gradients ≤ 2e-3, the inducing points' included; the posteriors with
     path G's limits or, where the CPU's own fp32 result drifts that far,
     against its fp64 one; the E/M steps' float64 algebra within 1e-8).
  J. path J: the rest of the model surface (K3 only). J1: the composed
     route at the headline's width with ``decomp=[[0, 1], [2, 3]]`` (two
     Scale-wrapped Matérn groups, K3 on each group's sliced inputs), phase
     4's 2×16 steps beside phase 4's fused step, the device split by
     labelled ranges, peak memory, then the "lmc_iter" cache and
     ``posterior`` on 2,500 points. J2: the SLQ route (the LMC's default
     MLL above q·n = 4,096) on the same data, 8 ``fit`` steps at
     ``mll()``'s defaults and 8 with ``quad_method="slq"``, rank 256, bf16:
     CG iterations, the tridiagonal eigh's share, peak memory. J3: the
     tidal configuration on a seeded tidal-shaped series (the spectral
     mixture with its periodogram init), the ICM and PLMC ``fit`` for at
     most 500 steps (16-step chunks; a cap they reach short of the plateau,
     the line says where each stopped) with R², RMSE, PVA and α_CI
     on the held-out day. J4: ``ExactGPModel`` at n = 2,500 with a linear
     and a polynomial mean and a spline kernel, 16 ``fit`` steps with
     ``exponential_schedule``, one 16-step chunk, checkpoints and evals,
     ``load_model``'s MLL bit for bit, the complex-mean LOO. J5: the blocked
     bf16 Cholesky at n = 8,192, T = 7, against potrf. K3 at the groups'
     (4, n, n), (4, n, 256), (4, 256, 256) and J2's stack against its plain
     version and bitwise K6; the card against the CPU at n = 2048 (the
     composed MLL with its bf16 and int8 loops, both SLQ settings, the
     tidal ICM and PLMC, the exact models, ``chol_bf16``; posteriors and the
     complex-mean LOO), held to the CPU's fp64 result where the CPU's own
     fp32 result is as far from it.
  K. path K: the experiments around the models (K3 only). K1: the paper's
     study at full width, the port's ``experiments.driver.run_study`` at
     ``DEFAULT_PARAMS`` (n = 500, p = 100, q = 25, 2,500 test points) with
     the five models (ICM, var, PLMC, oilmm, PLMC_fast), 2 runs of at most
     128 steps a model, non-converged-run rejection, into a temporary
     directory: the landmark and final CSVs (5 model and 5 ``_conv`` rows,
     every metric finite), each model's train_time, t_per_iter, R², RMSE,
     PVA and α_CI; each trained model of the last run through
     ``predict_and_metrics`` on the card against the CPU on the same leaves
     and 500 test points (path G's limits; the ICM and the var model held
     to the CPU's fp64 result as H1 and path I are); K3 at the study's
     shapes against its plain version and bitwise K6. K2: ``training.fit_ensemble`` on 8 seeds of the
     paper's default PLMC (``build_models(seed=s)``), 128 steps in 16-step
     chunks, beside each seed's sequential ``fit`` on the card (32 steps;
     the losses within 1e-6, bitwise equality reported), with the launches
     a batch step. K3: ``realdata.load_tidal`` on a seeded bramblemet-format
     fixture (four ``.csv.gz`` stations, one clock 2 minutes late) →
     ``build_models`` (spectral mixture, 5 mixtures, likelihood rank 0) →
     ``train_and_eval(var_fit="warm_start")``, R², RMSE, PVA per model;
     ``load_ship`` and ``load_sarcos`` on small seeded files. K4: per-batch
     3-D kernel inputs on the card against the CPU (1e-6), ``profile_trace``
     writing a trace of a K3 launch, ``ensure_cuda()``.
  L. path L: the ('data', 'latent') mesh on ``torch.distributed``
     (``parallel``), 4 ranks spawned by ``parallel.launch`` (the kernels
     built once by this process, loaded by the ranks); they share the card
     over gloo when there are fewer cards than ranks, and take one each
     over NCCL otherwise. L1: F2's projected model (n = 10⁴, p = 7, q = 4,
     d = 4, full B̃, the init moved) on data 2 × latent 2, each rank K3
     (2, 10⁴, 10⁴) and potrf on its latents: 8 ``sharded_fit_step`` steps
     against 8 unsharded steps on this card (the first step's loss rel.
     ≤ 1e-5, each gradient within 1e-4 of its largest entry, the parameters
     within rtol 1e-4 + atol 1e-6, except entries in AdamW's ε regime,
     which are held to AdamW's step from the sharded gradient; every loss
     rel. ≤ 1e-4), then the sharded cache and ``predict`` on 2,500 points
     (path G's limits; each rank's own latents within 1e-6 of an unsharded
     model carrying its leaves restricted to the same latents) and
     ``save_orbax``/``load_orbax`` under the group. L2: I3's projected SGPR
     (n = 44,480, d = 21, q = 7, m = 500) and L3: the variational ELBO at
     n = 44,484 (I2's model), both on data 4 × latent 1 (each rank K3 on
     its 11,120 rows), compared as L1. L4: ``entry.dryrun_multichip(4)``
     and a one-rank NCCL group's ``dryrun_step`` on L1's model. Step times
     (ranks sharing one card: not a speed-up), peak memory a rank, the
     backend; each rank's K3 launches go into the totals; K3 at each new
     local shape against its plain version and bitwise K6.
  M. path M: the LMC and ICM families under the mesh, in path L's spawn.
     M1: the headline LMC (n = 10⁴, T = 7, q = 4, d = 4, the init moved)
     on data 2 × latent 2 and data 4 × latent 1, each rank's (2, 5,000,
     10⁴) or (4, 2,500, 10⁴) bf16 block built by K6 and the row-sharded
     PCG, K7's row-block form in the backward: 8 ``sharded_fit_step`` steps
     against 8 unsharded steps on this card on the full grid (the kernels
     the sharded op runs) at path L's limits, then one step with its world
     sums timed; M2: H2's matrix-free ICM (n = 16,384, the rows over every
     rank, K3's (1, 4,096, 16,384) block), 4 steps, held at path L's limits
     to the unsharded step with its products blocked as the ranks'
     (``blocked_products``) and to the plain one at the CG estimator's
     fp32 gradient limit (``M_CG_GRAD_TOL``, phase 3's);
     M3: the "lmc_iter" cache and ``posterior`` on 2,500 points at M1's
     model, the "icm_iter" cache, ``posterior`` and ``compute_var`` at M2's,
     the dense ICM MLL with its gradients, the "icm" cache and
     ``compute_var`` at n = 4,096, against unsharded at path G's limits;
     M4: path B's ``ExactGPModel`` (n = 16,384, T = 7), 4 steps, held as
     M2; M5: L4's
     ``dryrun_multichip(4)``, which runs JAX's whole dry run. Before the
     spawn, at a rank's shapes on M1's layouts: K6's block bitwise the
     rows of K1's stack and against its plain version; K7's row-block form
     against its plain version, bitwise on a repeat, timed with its bound;
     K3 at the roots' block. Step times, peak memory a rank, the time in
     the world sums; each rank's K3, K6 and K7 launches go into the totals.
     The routes that once raised under a mesh, each held at path L's
     limits to one process's same arithmetic: M6 the dense Woodbury LMC
     (n = 1,024, q·n = 4,096) with its "lmc" cache; M7 CG + SLQ on M1's
     model (2 steps); M8 the int8 stack (K8's block on (x[r0:r1], x)); M9
     the "kr" and "krs" backward (PLMC_KR_FUSED=1, PLMC_KR_STREAM=1)
     through K4's and K5's row-block forms, bitwise a one-rank mesh's run;
     M10 the LMC and ICM SGPR (n = 44,480, d = 21, m = 500, data 4 ×
     latent 1) with their "sgpr" caches; M11 ``ExactGPModel``'s composed
     route with J1's additive kernel; M12 ``fit`` bitwise
     ``sharded_fit_step``, every rank's leaves equal. K4's and K5's
     row-block forms are checked against their plain versions and for
     bitwise repeats at M1's (2, 5,000, 10⁴) block, where they are timed
     with their bounds, and at ``M_KR_BRANCHES`` (d = 21 padded to 32, n1
     below a tile, rows not on 16 bytes), K5 on bf16 and fp32 blocks.
  N. path N: K3 against its plain version and bitwise K6 at the shapes the
     examples give it (each example's seeded data and its model as built:
     01's (300, 300) and (400, 300) at d = 1, 02's SGPR blocks against
     m = 128 at d = 4, 03's rank row block (128, 512) and (512, 512) at
     d = 3, 04's (200, 200) at d = 2); then the four examples of
     ``examples_torch/`` (the JAX package's
     ``examples/``, ported), each run on the card as a subprocess
     (``python3 examples_torch/0k_….py``, no ``--cpu``) that loads the
     library this process built (the build directory is unchanged after
     them): each one's exit code and the markers the JAX examples' tests
     assert, every printed loss finite; each one's wall time and library
     load time, 02's serving batches' times, 01's R², RMSE and α_CI; the
     launches of each example's processes, read from
     ``PLMC_LAUNCH_COUNTS``: K3 at least once in each process that runs a
     model (01's, 02's and 04's script, each of 03's 8 ranks).
  O. path O: the Gaussian log-density's closed-form gradient at the main
     path's (4, 10,000, 10,000) on Matérn-2.5 matrices over SARCOS's 21
     features (``ops.cholesky``): the blocked K⁻¹ (``cholesky_inverse``)
     beside ``torch.cholesky_inverse`` (the library's, the yardstick only),
     the closed-form backward beside the generic Cholesky pullback's
     (``safe_cholesky`` + ``solve_triangular`` through autograd), each
     time beside the bound of K⁻¹ (potri's 2n³/3 operations a latent);
     the inverses' gap to each other, and each route's K̄ and δ̄ against
     float64's from the library's inverse: the closed form's gap at most
     twice the generic route's (``--only O`` runs it alone, no build).
  P. path P, run alone by ``--only P`` (not by the full run): K1, K2 and
     K3 at SARCOS's full n = 44,484 with d = 21 and q = 4, where the
     stack's q·n² = 7.9·10⁹ entries pass 2³¹. K1's bf16 stack and K2's
     reductions against their plain versions on the first, a middle and
     the last 128-row block (the last holds the ragged tile) of every
     latent, K1's rows against its columns there, K2 repeated bitwise, K3
     at the roots' (4, n, 256) against its plain version and K6; the bf16
     stack product against each latent's last rows in fp32; times, K2's
     slot buffer and peak memory.

Every training run sets the launch counts to 0 just before it and reads
them just after (path N's subprocesses start at 0 and report theirs at
exit). The last lines are one JSON object with every kernel's
numbers (launches summed over those runs), the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Needs no network and imports nothing of
JAX.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import math
import os
import re
import signal
import subprocess
import sys
import time
import warnings

import numpy as np

N, T, Q, D = 10_000, 7, 4, 4             # the main path's widths
DE = 21                                  # path E: SARCOS's input features
STEPS_PER_CHUNK, CHUNKS = 16, 2
N_A = 20_000                             # path A: the large-n exact-LMC step
ROUTING_N = (5_000, N, N_A)              # path A's sizes, for the routing rule
N_B, STEPS_B = 16_384, 8                 # path B: ExactGPModel, T = 7
PEAK_BYTES_PER_S = 3.35e12               # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12                  # H100 SXM fp32, non-tensor-core
PEAK_BF16_FLOPS = 989e12                 # H100 SXM bf16 tensor cores, dense
MLL_KW = dict(iterative=True, max_cg_iters=16, cg_tol=2e-2, matvec_bf16=True,
              precond_rank=256, num_probes=8)
INT8_KW = dict(MLL_KW, matvec_bf16=False, matvec_int8=True)   # path C, coarse
FINE_KW = dict(iterative=True, max_cg_iters=64, cg_tol=1e-4, precond_rank=256,
               num_probes=8)                                  # path C, fine
STEPS_C, FINE_FRAC = 32, 0.25
KIND = "matern25"


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


def bound_ms(nbytes: float, flops: float, bf16_flops: float = 0.0):
    """(least time in ms, "bytes" or "operations") at the published peaks:
    fp32 operations at the non-tensor rate, bf16 tensor-core operations at
    theirs. The two units run side by side, so the operations take the
    longer of the two times."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = max(flops / PEAK_FP32_FLOPS, bf16_flops / PEAK_BF16_FLOPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check(name: str, err: float, tol: float):
    ok = math.isfinite(err) and err <= tol
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")


def stack_error(torch, ck, got, x, ls, os_, dt, block=2500, x2=None):
    """K1's stack (or K6's rows x against the columns x2) against its plain
    version, a block of rows at a time (the plain formula forms a
    (q, rows, n, d) array): (largest absolute error, largest plain
    entry)."""
    err = top = 0.0
    for i0 in range(0, x.shape[0], block):
        want = ck.scaled_kernel_stack_plain(x[i0:i0 + block],
                                            x if x2 is None else x2, ls, os_,
                                            "matern25", dt).float()
        err = max(err, float((got[:, i0:i0 + block].float() - want)
                             .abs().max()))
        top = max(top, float(want.abs().max()))
    return err, top


def k3_is_k6(torch, ck, dev, got, x1, x2, ls, one):
    """K3's matrix ``got`` against K6's fp32 stack at os = 1 on the same
    inputs: one kernel, so the same bits."""
    same = torch.equal(got, ck.scaled_kernel_stack(x1, x2, ls, one, KIND,
                                                   device=dev))
    print(f"  K3 ({ls.shape[0]},{x1.shape[0]},{x2.shape[0]}) bitwise equal "
          f"to K6 at os = 1: {same}")
    if not same:
        raise SystemExit("chip_smoke: K3 is not K6's fp32 stack at os = 1")


def reduce_plain_by_blocks(torch, ck, x, ls, A, Bf, kind, block=2500):
    """``lowrank_stationary_reduce_sym_plain``'s formula a block of rows at a
    time, for an n whose (q, n, n, d) differences do not fit the card."""
    rows, wx = [], []
    for i0 in range(0, x.shape[0], block):
        d2 = ck._sqdist_scaled(x[i0:i0 + block], x, ls)
        W = torch.matmul(A[:, i0:i0 + block], Bf.transpose(-1, -2)) \
            * ck.dprofile(kind, d2)
        rows.append(W.sum(-1))
        wx.append(torch.matmul(W, x))
    return torch.cat(rows, 1), torch.cat(wx, 1)


def symmetric_factors(rng, t, n, r):
    """A, Bf (Q, n, r), r odd, with A Bfᵀ symmetric, as the fused backward
    builds them."""
    u0 = rng.standard_normal((Q, n, 1))
    U, V = rng.standard_normal((2, Q, n, (r - 1) // 2))
    return (t(np.concatenate([u0, U, V], -1)),
            t(np.concatenate([0.5 * u0, V, U], -1)))


def launch_split(torch, fn, reps=5) -> str:
    """Mean device time of each CUDA kernel that ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = [(e.key.split("::")[-1].split("<")[0].split("(")[0],
              e.device_time_total / 1e3 / reps) for e in prof.key_averages()
             if getattr(e, "device_time_total", 0) > 0]
    return ", ".join(f"{k} {v:.4f} ms" for k, v in parts) or "not measured"


def kernel_phase(torch, ck, dev):
    """Phase 2: each kernel against its plain version, and its times."""
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    ls = t(rng.uniform(0.5, 1.5, (Q, 1, D)))
    os_ = t(rng.uniform(0.5, 2.0, (Q,)))
    rows = {}

    # K1: the fp32 tolerance covers two exp implementations (the kernel's,
    # torch's) and d² summed with and without FMAs, each ~1e-7 relative;
    # bf16: one rounding of either side. The sizes are the main path's two,
    # rows that do not start on 16 bytes (1237), rows that do with a ragged
    # tile (1240), and one n below a tile; each stack is also held to be
    # bitwise symmetric
    for n in (N, N_A, 1237, 1240, 50):
        x = t(rng.standard_normal((n, D)))
        x = x - x.mean(0)
        for dt in (torch.bfloat16, torch.float32):
            got = ck.scaled_kernel_stack_sym(x, ls, os_, "matern25", dt,
                                             device=dev)
            if tuple(got.shape) != (Q, n, n) or got.dtype != dt:
                raise SystemExit(f"chip_smoke: K1 gave {tuple(got.shape)} "
                                 f"{got.dtype}")
            err, top = stack_error(torch, ck, got, x, ls, os_, dt)
            tol = 2.0 ** -7 * top if dt == torch.bfloat16 else 1e-4
            check(f"K1 scaled_kernel_stack_sym n={n} {str(dt)[6:]} (wide "
                  f"stores of {ck.wide_store_elements(n, dt)})", err, tol)
            if not torch.equal(got, got.transpose(-1, -2)):
                raise SystemExit(f"chip_smoke: K1's stack at n={n} "
                                 f"{str(dt)[6:]} is not bitwise symmetric")
            if n == N:
                if dt == torch.bfloat16:
                    rows["K1"] = dict(max_abs_err=err)
                # K6 sums the same d² and takes the same profile of the
                # output type: on (x, x) it must give K1's stack bit for bit
                same = torch.equal(got, ck.scaled_kernel_stack(
                    x, x, ls, os_, "matern25", dt, device=dev))
                print(f"  K1 {str(dt)[6:]} bitwise equal to K6 on (x, x): "
                      f"{same}")
                if not same:
                    raise SystemExit(f"chip_smoke: K6 on (x, x) is not K1's "
                                     f"{str(dt)[6:]} stack")
            del got
            torch.cuda.empty_cache()
    print("  K1 stacks bitwise symmetric at every n, both types: True")
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
    xa = t(rng.standard_normal((N_A, D)))
    for dt in (torch.bfloat16, torch.float32):
        ms = {n_: cuda_ms(lambda: ck.scaled_kernel_stack_sym(
            x_, ls, os_, "matern25", dt, device=dev), reps=10)
            for n_, x_ in ((N, x), (N_A, xa))}
        print(f"  K1 {str(dt)[6:]}: {ms[N]:.4f} ms at n={N}, {ms[N_A]:.4f} ms "
              f"at n={N_A} (write bounds "
              + ", ".join(f"{Q * n_ * n_ * (2 if dt == torch.bfloat16 else 4) / PEAK_BYTES_PER_S * 1e3:.4f}"
                          for n_ in (N, N_A)) + " ms)")
        torch.cuda.empty_cache()

    # K2: A Bfᵀ symmetric by construction, as the fused backward's factors;
    # sums over 10⁴ terms in another order, fast exp and reciprocal square
    # root: 1e-4 of the largest. Also at n = N_A, held against the plain
    # formula by row blocks, and at a second rank, r = 7; every case must
    # repeat bitwise
    r = 17
    for n_, r_, x_ in ((N, r, x), (N_A, r, xa), (N_A, 7, xa), (N, 7, x)):
        A, Bf = symmetric_factors(rng, t, n_, r_)
        run_k2 = lambda: ck.lowrank_stationary_reduce_sym(  # noqa
            x_, ls, A, Bf, "matern25", device=dev)
        got, rep = run_k2(), run_k2()
        bitwise = all(torch.equal(g, p) for g, p in zip(got, rep))
        print(f"  K2 lowrank_stationary_reduce_sym n={n_} r={r_} repeat "
              f"bitwise equal: {bitwise}")
        if not bitwise:
            raise SystemExit("chip_smoke: K2 is not deterministic")
        want = ck.lowrank_stationary_reduce_sym_plain(
            x_, ls, A, Bf, "matern25") if n_ == N else reduce_plain_by_blocks(
            torch, ck, x_, ls, A, Bf, "matern25")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(f"K2 lowrank_stationary_reduce_sym n={n_} r={r_}", err,
              1e-4 * max(float(w.abs().max()) for w in want))
        del got, rep, want
        torch.cuda.empty_cache()
        if r_ == r:
            ms = cuda_ms(run_k2, reps=20 if n_ == N else 10)
            print(f"  K2 at n={n_}: {ms:.4f} ms; by launch "
                  f"{launch_split(torch, run_k2)}")
        if (n_, r_) == (N, r):
            rows["K2"] = dict(max_abs_err=err, ms=ms, plain_ms=cuda_ms(
                lambda: ck.lowrank_stationary_reduce_sym_plain(
                    x_, ls, A, Bf, "matern25"), reps=3, warmup=1))
            torch.cuda.empty_cache()
    del xa
    rows["K2"]["bound"] = bound_ms(
        2 * Q * N * r * 4 + N * D * 4 + Q * N * (1 + D) * 4,
        # T (2r), d² (3d), g′ (~7 incl. sqrt, exp), row and column sums
        pairs * (2 * r + 3 * D + 7 + 2 * (1 + 2 * D)))

    # K3: the Nyström blocks of the main path, fp32 (tolerance as K1 fp32);
    # K6's kernel at os = 1, so K6's fp32 values bit for bit
    idx = torch.as_tensor(np.linspace(0, N - 1, 256).astype(np.int32),
                          device=dev, dtype=torch.long)
    z = x[idx]
    one = torch.ones(Q, dtype=torch.float32, device=dev)
    for a, b in ((x, z), (z, z)):
        got = ck.kernel_matrix(a, b, ls, "matern25", device=dev)
        want = ck.kernel_matrix_plain(a, b, ls, "matern25")
        err = float((got - want).abs().max())
        check(f"K3 kernel_matrix ({Q},{a.shape[0]},{b.shape[0]})", err, 1e-4)
        k3_is_k6(torch, ck, dev, got, a, b, ls, one)
        if a.shape[0] == N:
            rows["K3"] = dict(max_abs_err=err)
    run_k3 = lambda: ck.kernel_matrix(x, z, ls, "matern25", device=dev)  # noqa
    rows["K3"]["ms"] = cuda_ms(run_k3, reps=50)
    rows["K3"]["plain_ms"] = cuda_ms(
        lambda: ck.kernel_matrix_plain(x, z, ls, "matern25"), reps=50)
    rows["K3"]["bound"] = bound_ms(Q * N * 256 * 4 + (N + 256) * D * 4,
                                   Q * N * 256 * (3 * D + 10))
    print(f"  K3 ({Q},{N},256): {rows['K3']['ms']:.4f} ms by events, device "
          f"{launch_split(torch, run_k3, reps=50)}")
    small = cuda_ms(
        lambda: ck.kernel_matrix(z, z, ls, "matern25", device=dev), reps=50)
    print(f"  K3 at ({Q},256,256): {small:.4f} ms")
    # the dense (q, n, n) fp32 matrix that projected LMC's exact MLL builds
    dense = ck.kernel_matrix(x, x, ls, "matern25", device=dev)
    k3_is_k6(torch, ck, dev, dense, x, x, ls, one)
    del dense
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: ck.kernel_matrix(x, x, ls, "matern25", device=dev),
                 reps=10)
    b, by = bound_ms(Q * N * N * 4 + N * D * 4, Q * N * N * (3 * D + 10))
    print(f"  K3 at ({Q},{N},{N}): {ms:.4f} ms (bound {b:.4f} ms by {by})")
    del A, Bf
    torch.cuda.empty_cache()
    rows.update(kr_phase(torch, ck, dev, rng, t, ls, os_))
    rows.update(fullgrid_phase(torch, ck, dev, rng, t, ls, os_))
    # every profile and several feature counts (kernel templates), small n;
    # above 8 features the reductions run at a padded width (24, 32) and
    # the lengthscales grow with √d, so that the distances stay those of d=8
    for kind in ck.KINDS:
        for d in (1, 3, 8, 9, 21, 32):
            n = 333
            xs = t(rng.standard_normal((n, d)))
            lss = t(rng.uniform(0.5, 1.5, (Q, 1, d)) * max(1.0, (d / 8) ** 0.5))
            U, V = rng.standard_normal((2, Q, n, 3))
            As, Bs = t(np.concatenate([U, V], -1)), t(np.concatenate([V, U], -1))
            e1 = float((ck.scaled_kernel_stack_sym(xs, lss, os_, kind,
                                                   device=dev)
                        - ck.scaled_kernel_stack_sym_plain(xs, lss, os_, kind)
                        ).abs().max())
            e3 = float((ck.kernel_matrix(xs, xs[:50], lss, kind, device=dev)
                        - ck.kernel_matrix_plain(xs, xs[:50], lss, kind)
                        ).abs().max())
            e6 = float((ck.scaled_kernel_stack(xs, xs[:50], lss, os_, kind,
                                               device=dev)
                        - ck.scaled_kernel_stack_plain(xs, xs[:50], lss, os_,
                                                       kind)).abs().max())
            # K6 in bf16 below one tile: one bf16 rounding of either side
            want6 = ck.scaled_kernel_stack_plain(xs, xs[:50], lss, os_, kind,
                                                 torch.bfloat16).float()
            e6b = float((ck.scaled_kernel_stack(
                xs, xs[:50], lss, os_, kind, torch.bfloat16, device=dev).float()
                - want6).abs().max())
            got = ck.lowrank_stationary_reduce_sym(xs, lss, As, Bs, kind,
                                                   device=dev)
            want = ck.lowrank_stationary_reduce_sym_plain(xs, lss, As, Bs, kind)
            e2 = max(float((g - w).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            # K7 on non-symmetric factors: it assumes no symmetry
            Cs = t(rng.standard_normal((Q, n, 6)))
            got = ck.lowrank_stationary_reduce(xs, lss, As, Cs, kind,
                                               device=dev)
            want = ck.lowrank_stationary_reduce_plain(xs, lss, As, Cs, kind)
            e7 = max(float((g - w).abs().max()) for g, w in zip(got, want))
            scale7 = max(float(w.abs().max()) for w in want)
            check(f"K1+K3+K6 {kind} d={d} n={n}", max(e1, e3, e6), 1e-4)
            check(f"K6 bf16 {kind} d={d} ({Q},{n},50)", e6b,
                  2.0 ** -7 * float(want6.abs().max()))
            check(f"K2 {kind} d={d} n={n}", e2, 1e-4 * scale)
            check(f"K7 {kind} d={d} n={n}", e7, 1e-4 * scale7)
            check_counts(f"K8 {kind} d={d} n={n}",
                         ck.quantized_kernel_stack(xs, xs[:50], lss, kind,
                                                   padded_to=(336, 56),
                                                   device=dev),
                         ck.quantized_kernel_stack_plain(xs, xs[:50], lss,
                                                         kind, (336, 56)))
            # K8's symmetric call: lower tiles and their mirror
            Kq = ck.quantized_kernel_stack(xs, xs, lss, kind, (336, 336),
                                           device=dev)
            check_counts(f"K8 {kind} d={d} n={n} symmetric", Kq,
                         ck.quantized_kernel_stack_plain(xs, xs, lss, kind,
                                                         (336, 336)))
            if not torch.equal(Kq, Kq.transpose(-1, -2)):
                raise SystemExit(f"chip_smoke: K8's stack at d={d} is not "
                                 f"bitwise symmetric")
            Ks = ck.scaled_kernel_stack_sym(xs, lss, os_, kind, device=dev)
            check_kr(f"K4 {kind} d={d} n={n}",
                     ck.lowrank_stationary_reduce_sym_kr(
                         xs, lss, os_, As, Bs, kind, device=dev),
                     ck.lowrank_stationary_reduce_sym_kr_plain(
                         xs, lss, os_, As, Bs, kind))
            check_kr(f"K5 {kind} d={d} n={n} float32 stack",
                     ck.lowrank_stationary_reduce_sym_krs(
                         xs, lss, os_, As, Bs, Ks, kind, device=dev),
                     ck.lowrank_stationary_reduce_sym_krs_plain(
                         xs, lss, os_, As, Bs, Ks, kind))
    wide_phase(torch, ck, dev, rng, t, os_, rows)
    for k, row in rows.items():
        b, by = row["bound"]
        print(f"  {k}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f} ms, "
              f"bound {b:.4f} ms by {by})")
    return rows


def k8_bound(n, nw, d):
    """K8's least time on the call (x, x) padded to (nw, nw): the write of
    q·nw² counts, or the operations of the n(n+1)/2 unordered pairs the
    function needs (3d + 10 for g, 2 for the scale and rounding)."""
    return bound_ms(Q * nw * nw + n * d * 4 + Q * d * 4,
                    Q * n * (n + 1) / 2 * (3 * d + 12))


def reduce_bounds(n, d, r):
    """K2's and K7's least times at n, d, r (their operation counts, as in
    phase 2's rows)."""
    io = 2 * Q * n * r * 4 + n * d * 4 + Q * n * (1 + d) * 4
    k2 = bound_ms(io, Q * n * (n + 1) / 2
                  * (2 * r + 3 * d + 7 + 2 * (1 + 2 * d)))
    k7 = bound_ms(io, Q * n * n * (2 * r + 3 * d + 7 + (1 + 2 * d)))
    return k2, k7


def wide_phase(torch, ck, dev, rng, t, os_, rows):
    """K1, K2, K7 and K8 at n = N with d = DE (SARCOS's features; the
    reductions run at their padded width) beside d = D: times and bounds.
    At d = DE each, and K3 on path E's Nyström blocks, is first held
    against its plain version on the inputs it is timed on, at the
    tolerances of phase 2 at d = D (the plain versions a block of rows at a
    time)."""
    from projected_lmc_tpu_torch.ops import iterative as it
    r, nw = 17, it.int8_width(N)
    for d in (D, DE):
        x = t(rng.standard_normal((N, d)))
        x = x - x.mean(0)
        ls = t(rng.uniform(0.5, 1.5, (Q, 1, d)) * (d / D) ** 0.5)
        A, Bf = symmetric_factors(rng, t, N, r)
        if d == DE:
            wide_values(torch, ck, dev, x, ls, os_, A, Bf, nw)
        ms = {"K1": cuda_ms(lambda: ck.scaled_kernel_stack_sym(
                  x, ls, os_, KIND, torch.bfloat16, device=dev), reps=10),
              "K2": cuda_ms(lambda: ck.lowrank_stationary_reduce_sym(
                  x, ls, A, Bf, KIND, device=dev), reps=5),
              "K7": cuda_ms(lambda: ck.lowrank_stationary_reduce(
                  x, ls, A, Bf, KIND, device=dev), reps=5),
              "K8": cuda_ms(lambda: ck.quantized_kernel_stack(
                  x, x, ls, KIND, (nw, nw), device=dev), reps=10)}
        k2, k7 = reduce_bounds(N, d, r)
        bounds = {"K1": bound_ms(Q * N * N * 2 + N * d * 4 + Q * (d + 1) * 4,
                                 Q * N * (N + 1) / 2 * (3 * d + 10)),
                  "K2": k2, "K7": k7, "K8": k8_bound(N, nw, d)}
        print(f"  d={d} (K2 and K7 at {ck.reduce_width(d)} features), "
              f"n={N}: "
              + "; ".join(f"{k} {ms[k]:.4f} ms (bound {bounds[k][0]:.4f} by "
                          f"{bounds[k][1]})" for k in ms))
        del x, A, Bf
        torch.cuda.empty_cache()


def wide_values(torch, ck, dev, x, ls, os_, A, Bf, nw, block=1000):
    """K1 (bf16), K2, K7 and K8 on the (N, DE) inputs that ``wide_phase``
    times, against their plain versions a block of rows at a time (the plain
    formulas form (q, rows, N, d) differences): K1 within one bf16 step, K2
    and K7 within 1e-4 of the largest entry, K8's counts as
    ``check_counts`` holds them, its stack bitwise symmetric. K3 on the
    Nyström blocks that path E builds, (N, 256) with 16-byte stores over
    two column tiles and (256, 256), within phase 2's 1e-4, and bitwise
    K6's fp32 stack at os = 1."""
    got = ck.scaled_kernel_stack_sym(x, ls, os_, KIND, torch.bfloat16,
                                     device=dev)
    err, top = stack_error(torch, ck, got, x, ls, os_, torch.bfloat16, block)
    check(f"K1 bf16 d={DE} n={N}", err, 2.0 ** -7 * top)
    del got
    torch.cuda.empty_cache()
    idx = torch.as_tensor(np.linspace(0, N - 1, 256).astype(np.int32),
                          device=dev, dtype=torch.long)
    z = x[idx]
    one = torch.ones(Q, dtype=torch.float32, device=dev)
    for a in (x, z):
        got = ck.kernel_matrix(a, z, ls, KIND, device=dev)
        err = max(float((got[:, i0:i0 + block] - ck.kernel_matrix_plain(
            a[i0:i0 + block], z, ls, KIND)).abs().max())
            for i0 in range(0, a.shape[0], block))
        check(f"K3 kernel_matrix d={DE} ({Q},{a.shape[0]},256) (wide stores "
              f"of {ck.wide_store_elements(256, torch.float32)})", err, 1e-4)
        k3_is_k6(torch, ck, dev, got, a, z, ls, one)
        del got
    want = reduce_plain_by_blocks(torch, ck, x, ls, A, Bf, KIND, block)
    tol = 1e-4 * max(float(w.abs().max()) for w in want)
    for name, fn in (("K2", ck.lowrank_stationary_reduce_sym),
                     ("K7", ck.lowrank_stationary_reduce)):
        got = fn(x, ls, A, Bf, KIND, device=dev)
        check(f"{name} d={DE} n={N} r={A.shape[-1]} (at "
              f"{ck.reduce_width(DE)} features)",
              max(float((g - w).abs().max()) for g, w in zip(got, want)), tol)
    del got, want
    torch.cuda.empty_cache()
    Kq = ck.quantized_kernel_stack(x, x, ls, KIND, (nw, nw), device=dev)
    if not torch.equal(Kq, Kq.transpose(-1, -2)):
        raise SystemExit(f"chip_smoke: K8's stack at d={DE} is not bitwise "
                         f"symmetric")
    n = x.shape[0]
    worst = ndiff = 0
    for i0 in range(0, n, block):
        want = ck.quantized_kernel_stack_plain(x[i0:i0 + block], x, ls, KIND)
        diff = (Kq[:, i0:i0 + want.shape[1], :n].short() - want.short()).abs()
        worst, ndiff = max(worst, int(diff.max())), ndiff + int((diff > 0).sum())
    if bool(Kq[:, n:].any()) or bool(Kq[:, :, n:].any()):
        raise SystemExit(f"chip_smoke: K8's padding at d={DE} is not zero")
    count_verdict(f"K8 d={DE} ({Q},{nw},{nw}), bitwise symmetric",
                  worst, ndiff / Kq.numel())
    del Kq
    torch.cuda.empty_cache()


def check_counts(name: str, got, want) -> int:
    """K8 against its plain version: the int8 counts differ by at most one,
    in at most 1e-4 of the entries (where 127·g lies within the two
    sides' ~1e-5 rounding of a half). Returns the largest difference."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise SystemExit(f"chip_smoke: {name} has shape {tuple(got.shape)} "
                         f"{got.dtype}, expected {tuple(want.shape)} "
                         f"{want.dtype}")
    worst = int((got.short() - want.short()).abs().max())
    share = float((got != want).sum()) / got.numel()
    return count_verdict(name, worst, share)


def count_verdict(name: str, worst: int, share: float) -> int:
    """``check_counts``'s limits on the largest count difference and the
    share of differing entries; returns the largest difference."""
    ok = worst <= 1 and share <= 1e-4
    print(f"  {name}: max |count difference| {worst}, share of differing "
          f"entries {share:.3e} (tolerances 1, 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version")
    return worst


def check_kr(name: str, got, want) -> float:
    """K4/K5 against the plain version: rows and wx within 1e-4 of their
    largest magnitude (sums over n terms in another order, fast exp), KA
    within 2⁻⁷ of max|KA| (room for a bf16-rate product) and, since its
    products run as hi·hi + hi·lo + lo·hi of bf16 splits (~2⁻¹⁷ relative),
    within 1e-4 of max|KA|: one plain bf16 product, or one that lost a
    split, misses that. Returns the largest absolute error."""
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    scale = max(float(w.abs().max()) for w in want[:2])
    ka_scale = float(want[2].abs().max())
    check(f"{name} rows, wx", max(errs[:2]), 1e-4 * scale)
    check(f"{name} KA", errs[2], 2.0 ** -7 * ka_scale)
    check(f"{name} KA, split products", errs[2], 1e-4 * ka_scale)
    return max(errs)


def kr_phase(torch, ck, dev, rng, t, ls, os_):
    """K4 and K5 at the main path's widths (q=4, d=4, r=17, os ≠ 1), at
    n = N and a ragged n; K5 on fp32 and bf16 stacks built by K1 and held
    against its plain version on the same stack. Bitwise repeats, times
    (also at n = N_A), scratch bytes."""
    r, kind = 17, "matern25"
    rows = {}
    for n in (N, 1237):
        x = t(rng.standard_normal((n, D)))
        x = x - x.mean(0)
        A, Bf = symmetric_factors(rng, t, n, r)
        runs = [("K4", "kr", None)] + [
            ("K5", f"krs {str(dt)[6:]} stack",
             ck.scaled_kernel_stack_sym(x, ls, os_, kind, dt, device=dev))
            for dt in (torch.bfloat16, torch.float32)]
        for key, label, Ks in runs:
            if Ks is None:
                run = lambda: ck.lowrank_stationary_reduce_sym_kr(  # noqa
                    x, ls, os_, A, Bf, kind, device=dev)
                plain = lambda: ck.lowrank_stationary_reduce_sym_kr_plain(  # noqa
                    x, ls, os_, A, Bf, kind)
            else:
                run = lambda: ck.lowrank_stationary_reduce_sym_krs(  # noqa
                    x, ls, os_, A, Bf, Ks, kind, device=dev)
                plain = lambda: ck.lowrank_stationary_reduce_sym_krs_plain(  # noqa
                    x, ls, os_, A, Bf, Ks, kind)
            got, rep = run(), run()
            bitwise = all(torch.equal(a, b) for a, b in zip(got, rep))
            print(f"  {key} {label} n={n} repeat bitwise equal: {bitwise}")
            if not bitwise:
                raise SystemExit(f"chip_smoke: {key} is not deterministic")
            del rep
            err = check_kr(f"{key} {label} n={n} r={r}", got, plain())
            torch.cuda.empty_cache()
            # the main path's stack is bf16: K5's row is timed on it
            if n == N and label in ("kr", "krs bfloat16 stack"):
                rows[key] = dict(
                    max_abs_err=err, ms=cuda_ms(run, reps=10),
                    plain_ms=cuda_ms(plain, reps=2, warmup=1))
                torch.cuda.empty_cache()
        del runs, Ks
    # the main path's second size, and each kernel's scratch
    x = t(rng.standard_normal((N_A, D)))
    x = x - x.mean(0)
    A, Bf = symmetric_factors(rng, t, N_A, r)
    Ks = ck.scaled_kernel_stack_sym(x, ls, os_, kind, torch.bfloat16,
                                    device=dev)
    k4 = cuda_ms(lambda: ck.lowrank_stationary_reduce_sym_kr(
        x, ls, os_, A, Bf, kind, device=dev), reps=5)
    k5 = cuda_ms(lambda: ck.lowrank_stationary_reduce_sym_krs(
        x, ls, os_, A, Bf, Ks, kind, device=dev), reps=5)
    b4, b5 = kr_bounds(N_A, r)
    print(f"  K4 at n={N_A}: {k4:.4f} ms (bound {b4[0]:.4f} ms by {b4[1]}); "
          f"K5 (bf16 stack): {k5:.4f} ms (bound {b5[0]:.4f} ms by {b5[1]})")
    del x, A, Bf, Ks
    torch.cuda.empty_cache()
    for n in (N, N_A):
        pack, slots = (4 * math.prod(shape)
                       for shape in ck.kr_scratch_shapes(Q, n, D, r))
        print(f"  K4/K5 scratch at n={n} (q={Q}, d={D}, r={r}): slots "
              f"{slots / 1e9:.3f} GB + factor pack {pack / 1e6:.1f} MB")
    rows["K4"]["bound"], rows["K5"]["bound"] = kr_bounds(N, r)
    return rows


def kr_bounds(n, r):
    """K4's and K5's least times at n (d = D, bf16 stack for K5)."""
    pairs = Q * n * (n + 1) / 2
    io = 2 * Q * n * r * 4 + n * D * 4 + Q * (D + 1) * 4 \
        + Q * n * (1 + D + r) * 4        # A, Bf, x, l, os in; rows, wx, KA out
    k2_ops = 2 * r + 3 * D + 7 + 2 * (1 + 2 * D)   # K2's count, as above
    # + KA: K_ij A_j into row i and K_ij A_i into row j, a multiply-add each,
    # the function's one bf16 pass (as the TPU kernel's), at the tensor-core
    # rate; the kernel's split products are its own cost, not the function's
    # K5: no exp (one operation fewer), and the lower half of the bf16 stack
    return (bound_ms(io, pairs * k2_ops, pairs * 4 * r),
            bound_ms(io + pairs * 2, pairs * (k2_ops - 1), pairs * 4 * r))


def fullgrid_phase(torch, ck, dev, rng, t, ls, os_):
    """K6, K7 and K8 at the main path's widths (q=4, d=4, r=17): K6 in fp32
    and bf16 and K8 at n = m = N and at a ragged rectangle (n ≠ m, neither
    a multiple of the tile), K8 at the int8 product's padded width; K6 and
    K3 also at a rectangle whose rows start on 16 bytes with a ragged n
    (m % 8 = 0); K7 with a bitwise repeat. Times, bounds, and the int8
    stack product beside the bf16 one."""
    from projected_lmc_tpu_torch.ops import iterative as it
    rows = {}
    Nw = it.int8_width(N)
    x = t(rng.standard_normal((N, D)))
    x = x - x.mean(0)
    xr1, xr2 = t(rng.standard_normal((1237, D))), t(rng.standard_normal((907, D)))
    xr3 = t(rng.standard_normal((904, D)))
    for x1, x2 in ((xr1, xr3), (xr1, xr2)):
        # m % 8 = 0 (16-byte rows in both types) and m % 8 ≠ 0, ragged n
        err = float((ck.kernel_matrix(x1, x2, ls, KIND, device=dev)
                     - ck.kernel_matrix_plain(x1, x2, ls, KIND)).abs().max())
        check(f"K3 kernel_matrix ({Q},{x1.shape[0]},{x2.shape[0]}) (wide "
              f"stores of {ck.wide_store_elements(x2.shape[0], torch.float32)})",
              err, 1e-4)
    for x1, x2 in ((x, x), (xr1, xr2), (xr1, xr3)):
        shape = f"({Q},{x1.shape[0]},{x2.shape[0]})"
        for dt in (torch.bfloat16, torch.float32):
            got = ck.scaled_kernel_stack(x1, x2, ls, os_, KIND, dt, device=dev)
            want = ck.scaled_kernel_stack_plain(x1, x2, ls, os_, KIND, dt)
            err = float((got.float() - want.float()).abs().max())
            # as K1: one bf16 rounding of either side; fp32 two exps
            tol = 2.0 ** -7 * float(want.float().abs().max()) \
                if dt == torch.bfloat16 else 1e-4
            check(f"K6 scaled_kernel_stack {shape} {str(dt)[6:]} (wide "
                  f"stores of {ck.wide_store_elements(x2.shape[0], dt)})",
                  err, tol)
            if x1 is x and dt == torch.bfloat16:
                rows["K6"] = dict(max_abs_err=err)
            del got, want
        if x2 is xr3:
            continue
        pad = (Nw, Nw) if x1 is x else None
        Kq = ck.quantized_kernel_stack(x1, x2, ls, KIND, pad, device=dev)
        worst = check_counts(
            f"K8 quantized_kernel_stack {shape} padded to {pad}", Kq,
            ck.quantized_kernel_stack_plain(x1, x2, ls, KIND, pad))
        if x1 is x:
            rows["K8"] = dict(max_abs_err=float(worst))
            # the symmetric call mirrors lower tiles: bitwise symmetric, and
            # the same bits as the full grid over a copy of the points
            sym = torch.equal(Kq, Kq.transpose(-1, -2))
            same = torch.equal(Kq, ck.quantized_kernel_stack(
                x, x.clone(), ls, KIND, pad, device=dev))
            print(f"  K8 on (x, x): bitwise symmetric {sym}; equal to the "
                  f"full grid's stack {same}")
            if not (sym and same):
                raise SystemExit("chip_smoke: K8's symmetric stack is not "
                                 "the full grid's, mirrored")
        del Kq
        torch.cuda.empty_cache()
    bf16_kernel_matrix(torch, dev, x, ls)
    rows["K6"]["ms"] = cuda_ms(lambda: ck.scaled_kernel_stack(
        x, x, ls, os_, KIND, torch.bfloat16, device=dev), reps=20)
    rows["K6"]["plain_ms"] = cuda_ms(lambda: ck.scaled_kernel_stack_plain(
        x, x, ls, os_, KIND, torch.bfloat16), reps=3, warmup=1)
    rows["K8"]["ms"] = cuda_ms(lambda: ck.quantized_kernel_stack(
        x, x, ls, KIND, (Nw, Nw), device=dev), reps=20)
    rows["K8"]["plain_ms"] = cuda_ms(lambda: ck.quantized_kernel_stack_plain(
        x, x, ls, KIND, (Nw, Nw)), reps=3, warmup=1)
    torch.cuda.empty_cache()
    grid_pairs = Q * N * N                 # every ordered pair of the grid
    pair_ops = 3 * D + 10                  # d² (3 flops/feature), sqrt, exp, poly
    rows["K6"]["bound"] = bound_ms(Q * N * N * 2 + N * D * 4 + Q * (D + 1) * 4,
                                   grid_pairs * pair_ops)
    # the call measured is (x, x): its unordered pairs are the work
    rows["K8"]["bound"] = k8_bound(N, Nw, D)

    r = 17
    A, Bf = symmetric_factors(rng, t, N, r)
    run = lambda: ck.lowrank_stationary_reduce(x, ls, A, Bf, KIND,  # noqa
                                               device=dev)
    got, rep = run(), run()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, rep))
    print(f"  K7 lowrank_stationary_reduce repeat bitwise equal: {bitwise}")
    if not bitwise:
        raise SystemExit("chip_smoke: K7 is not deterministic")
    want = ck.lowrank_stationary_reduce_plain(x, ls, A, Bf, KIND)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # K2's: sums over n terms in another order, fast exp
    check(f"K7 lowrank_stationary_reduce n={N} r={r}", err,
          1e-4 * max(float(w.abs().max()) for w in want))
    del got, rep, want
    torch.cuda.empty_cache()
    rows["K7"] = dict(max_abs_err=err, ms=cuda_ms(run, reps=10),
                      plain_ms=cuda_ms(lambda: ck.lowrank_stationary_reduce_plain(
                          x, ls, A, Bf, KIND), reps=2, warmup=1))
    torch.cuda.empty_cache()
    # K2's per-pair count less the column sums, over n² ordered pairs
    rows["K7"]["bound"] = reduce_bounds(N, D, r)[1]
    int8_product(torch, ck, it, dev, rng, t, x, ls, os_)
    return rows


def bf16_kernel_matrix(torch, dev, x, ls):
    """K3's route with a bf16 output (``kernels.stationary_kernel_matrix``,
    the Nyström cross block's shape): K3 in fp32, cast once, as the JAX
    ``_skm_fwd`` does; equal to the fp32 route's matrix cast, bit for bit."""
    from projected_lmc_tpu_torch.kernels import stationary_kernel_matrix
    z = x[::max(1, x.shape[0] // 256)][:256]
    half = stationary_kernel_matrix(x, z, ls, KIND, torch.bfloat16,
                                    device=dev)
    full = stationary_kernel_matrix(x, z, ls, KIND, device=dev)
    same = half.dtype == torch.bfloat16 and torch.equal(
        half, full.to(torch.bfloat16))
    print(f"  K3 with a bf16 output {tuple(half.shape)}: equal to the fp32 "
          f"matrix cast once: {same}")
    if not same:
        raise SystemExit("chip_smoke: K3's bf16 output is not its fp32 "
                         "result cast")


def int8_product(torch, ck, it, dev, rng, t, x, ls, os_):
    """The int8 stack product (``iterative._int8_stack_matmul``: one
    ``torch._int_mm`` per latent) at (q, N, N) with the CG's r = 9 and the
    backward's 17 right-hand sides, exact against a float64 product of the
    same integers, timed beside the bf16 stack product with an fp32 result
    (``iterative._stack_matmul``), and each whole CG matvec beside the
    other."""
    Nw = it.int8_width(N)
    Kq = ck.quantized_kernel_stack(x, x, ls, KIND, (Nw, Nw), device=dev)
    Kb = ck.scaled_kernel_stack_sym(x, ls, os_, KIND, torch.bfloat16,
                                    device=dev)
    kscale = os_ / 127.0
    H = t(rng.standard_normal((T, Q)))
    St = t(np.eye(T))
    for r in (9, 17):
        Wq = t(rng.integers(-127, 128, (Q, N, r)))
        got = it._int8_stack_matmul(Kq, Wq)
        exact = torch.equal(got.double(),
                            torch.bmm(Kq[:, :N, :N].double(), Wq.double()))
        print(f"  int8 product ({Q},{N},{N}) r={r}: int32 result exact "
              f"against float64: {exact}")
        if not exact:
            raise SystemExit("chip_smoke: the int8 stack product is not exact")
        R = t(rng.standard_normal((r, N, Q)))
        ms_i8 = cuda_ms(lambda: it._int8_stack_matmul(Kq, Wq), reps=20)
        ms_row = cuda_ms(lambda: row_major_int8_product(torch, Kq, Wq),
                         reps=20)
        ms_bf = cuda_ms(lambda: it._stack_matmul(Kb, R), reps=20)
        Vr = t(rng.standard_normal((r, N, T)))
        mv_i8 = cuda_ms(lambda: it.lmc_matvec_int8(Kq, kscale, H, St, Vr),
                        reps=20)
        mv_bf = cuda_ms(lambda: it.lmc_matvec(Kb, H, St, Vr), reps=20)
        bf16_product_layouts(torch, it, Kb, rng, t, r)
        print(f"  r={r}: product int8 {ms_i8:.4f} ms (row-major right-hand "
              f"side {ms_row:.4f} ms), bf16 {ms_bf:.4f} ms "
              f"(bounds {Q * N * N / PEAK_BYTES_PER_S * 1e3:.4f} and "
              f"{2 * Q * N * N / PEAK_BYTES_PER_S * 1e3:.4f} ms to read the "
              f"stack); whole matvec int8 {mv_i8:.4f} ms, bf16 {mv_bf:.4f} ms")
    del Kq, Kb
    torch.cuda.empty_cache()


def bf16_product_layouts(torch, it, Kb, rng, t, r):
    """A measurement beside the port's bf16 stack product
    (``iterative._stack_matmul``, which it does not change): one
    ``torch.bmm`` of the (Q, N, N) bf16 stack with r bf16 right-hand sides
    and an fp32 result, the right-hand sides held row-major, column-major,
    and column-major zero-padded to a multiple of 8 columns: the layout that
    decided the int8 product's speed."""
    if not it._BMM_OUT_DTYPE:
        print(f"  r={r}: bf16 product by layout: not measured (this torch "
              f"has no bmm with out_dtype)")
        return
    W = t(rng.standard_normal((Q, N, r))).to(torch.bfloat16)
    rp = -(-r // 8) * 8
    Wp = torch.zeros((Q, rp, N), dtype=torch.bfloat16, device=W.device)
    Wp[:, :r] = W.transpose(1, 2)
    forms = {"row-major": W,
             "column-major": W.transpose(1, 2).contiguous().transpose(1, 2),
             f"column-major padded to {rp}": Wp.transpose(1, 2)}
    ref = torch.bmm(Kb, W, out_dtype=torch.float32)
    parts = []
    for name, w in forms.items():
        out = torch.bmm(Kb, w, out_dtype=torch.float32)[..., :r]
        # the same bf16 products, summed in fp32 in another order
        rel = float((out - ref).abs().max() / ref.abs().max())
        if not rel <= 1e-4:
            raise SystemExit(f"chip_smoke: the {name} bf16 product differs "
                             f"by {rel:.2e}")
        ms = cuda_ms(lambda: torch.bmm(Kb, w, out_dtype=torch.float32),
                     reps=20)
        parts.append(f"{name} {ms:.4f} ms")
    print(f"  r={r}: bf16 product (fp32 result) by right-hand-side layout: "
          + ", ".join(parts))


def row_major_int8_product(torch, Kq, Wq):
    """The int8 product with a row-major right-hand side: the layout that
    ``iterative._int8_stack_matmul`` does not take, timed beside it."""
    q, n, r = Wq.shape
    rp = -(-r // 8) * 8
    Wp = torch.zeros((q, Kq.shape[-1], rp), dtype=torch.int8, device=Kq.device)
    Wp[:, :n, :r] = Wq
    out = torch.empty_like(Wp, dtype=torch.int32)
    for b in range(q):
        torch._int_mm(Kq[b], Wp[b], out=out[b])
    return out[:, :n, :r]


def bench_data(n, seed=0, d=D):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = rng.standard_normal((n, T)).astype(np.float32)
    return X, Y


def make_model(pl, X, Y, device):
    lik = pl.MultitaskGaussianLikelihood(num_tasks=T, rank=0, device=device)
    return pl.MultitaskGPModel(X, Y, lik, n_tasks=T, n_latents=Q,
                               model_type="LMC", kernel_type="matern",
                               mean_type="zero", fix_diagonal=True,
                               device=device)


ROUTE_ENV = {"default": {}, "stack": {"PLMC_KR_FUSED": "0"},
             "kr": {"PLMC_KR_FUSED": "1"}, "krs": {"PLMC_KR_STREAM": "1"},
             "full": {"PLMC_SYM_BUILD": "0"}}
ROUTE_KERNEL = {"stack": "K2", "kr": "K4", "krs": "K5", "full": "K7"}


@contextlib.contextmanager
def routed(route):
    """The fused MLL's backward route for the block: "default" (the port's
    measured rule), or "stack", "kr", "krs" forced by its environment
    variables, or "full" (the full-grid kernels, ``PLMC_SYM_BUILD=0``); all
    are read at each call."""
    names = ("PLMC_KR_FUSED", "PLMC_KR_STREAM", "PLMC_SYM_BUILD")
    old = {k: os.environ.pop(k, None) for k in names}
    os.environ.update(ROUTE_ENV[route])
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
            if old[k] is not None:
                os.environ[k] = old[k]


def wrappers(ck):
    """{label: wrapper} of every counted kernel, the library's own list."""
    if tuple(ck.COUNTED) != KERNELS:
        raise SystemExit(f"chip_smoke: the library counts {tuple(ck.COUNTED)}"
                         f", this script knows {KERNELS}")
    return ck.COUNTED


KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K4r", "K5r")


def expect(**launches):
    """Expected launch counts: the given ones, 0 for every other kernel."""
    return {k: launches.get(k, 0) for k in KERNELS}


def zero_counts(ck):
    for w in wrappers(ck).values():
        w.launches = 0


def read_counts(ck):
    return {k: w.launches for k, w in wrappers(ck).items()}


def default_route(fm, n):
    with routed("default"):
        return "kr" if fm._use_kr_fused(n) else "stack"


def compare_grads(out, names, grad_tol=2e-3):
    """Card against CPU: value rel. ≤ 1e-4, each gradient ≤ ``grad_tol``
    (2e-3 unless stated) of its largest entry."""
    (vg, gg), (vc, gc) = out["cuda"], out["cpu"]
    rel = abs(vg - vc) / abs(vc)
    print(f"  value cuda {vg:.6f} cpu {vc:.6f} rel {rel:.2e} (tolerance 1e-4)")
    if not (math.isfinite(vg) and rel <= 1e-4):
        raise SystemExit("chip_smoke: MLL value disagrees")
    for name, a, b in zip(names, gg, gc):
        e = float((a - b).abs().max() / b.abs().max())
        print(f"  grad {name}: max|Δ|/max|cpu| {e:.2e} (tolerance {grad_tol:.0e})")
        if not (math.isfinite(e) and e <= grad_tol):
            raise SystemExit(f"chip_smoke: MLL gradient {name} disagrees")


# phase 3's cases: (label, route, extra op arguments, forward kernel,
# backward kernel or None for the route's, gradient tolerance). int8: the
# CG and the backward re-quantise their right-hand sides, and where card and
# CPU values differ by ~1e-7 next to a half, a count flips by 1/127; through
# 100 CG iterations that moved the H gradient by 2.9e-3 of its largest entry
# on an H100 80GB HBM3 at 700 W, so int8 is held to 1e-2, the int8
# operator's own noise class (~1% relative)
FUSED_CASES = (("default", "default", {}, "K1", None, 2e-3),
               ("kr", "kr", {}, "K1", None, 2e-3),
               ("krs", "krs", {}, "K1", None, 2e-3),
               ("int8 stack", "default", dict(matvec_int8=True), "K8", "K2",
                1e-2),
               ("full grid fp32", "full", {}, "K6", None, 2e-3),
               ("full grid bf16", "full", dict(matvec_bf16=True), "K6", None,
                2e-3))


def fused_phase(torch, pl, ck, fm, dev):
    """Phase 3: the fused op on the card (kernels) vs the CPU (plain), on
    the default backward route, forced onto K4 and onto K5, with the int8
    stack (K8, K2), and on the full grid (K6, K7) in fp32 and bf16."""
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
    for label, route, extra, fwd, bwd, grad_tol in FUSED_CASES:
        out = {}
        with routed(route):
            if bwd is None:
                bwd = ROUTE_KERNEL[route if route != "default"
                                   else default_route(fm, n)]
            expected = expect(**{fwd: 1, bwd: 1})
            for where in (dev, torch.device("cpu")):
                leaves = [a.to(where).clone().requires_grad_(True)
                          for a in (ls, os_, H, St, Yd)]
                zero_counts(ck)
                ll = fm.lmc_pcg_log_prob_stationary(
                    model.train_x.to(where), *leaves, eps.to(where),
                    xi.to(where), roots.to(where), KIND,
                    **dict(dict(max_cg_iters=100, cg_tol=1e-5,
                                matvec_bf16=False), **extra),
                    precond_rank=256, device=where)
                ll.backward()
                if where.type == "cuda" and read_counts(ck) != expected:
                    raise SystemExit(f"chip_smoke: the {label} case launched "
                                     f"{read_counts(ck)}, not {expected}")
                out[where.type] = (float(ll.detach()),
                                   [a.grad.cpu() for a in leaves])
        print(f"  {label} (through {fwd} and {bwd}):")
        compare_grads(out, ("ls", "os", "H", "St", "Y"), grad_tol)


def train_run(torch, ck, model, mll, chunks, steps, chunk_roots=True):
    """``chunks`` × ``steps`` AdamW(1e-2, wd 1e-4) steps on −mll(model,
    roots, generator), the roots rebuilt at each chunk's start when
    ``chunk_roots``; the kernel counts of this run alone."""
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad],
                            lr=1e-2, weight_decay=1e-4)
    gen = torch.Generator(device=model.device).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ck)
    losses, step_ms, chunk_ms = [], [], []
    for _ in range(chunks):
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        roots = None
        if chunk_roots:
            with torch.no_grad():
                roots = model._precond_roots(model.train_x,
                                             MLL_KW["precond_rank"])
        for _ in range(steps):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = -mll(model, roots, gen)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - s0) * 1e3)
            losses.append(loss.detach())
        chunk_ms.append((time.perf_counter() - c0) * 1e3)
    counts = read_counts(ck)
    losses = torch.stack(losses).cpu().numpy()
    params = torch.cat([p.detach().flatten() for p in model.parameters()])
    return dict(losses=losses, step_ms=step_ms, chunk_ms=chunk_ms,
                median_ms=float(np.median(step_ms)), counts=counts,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                finite=bool(np.all(np.isfinite(losses))
                            and torch.isfinite(params).all()))


def report(res, expected, totals):
    """Print a run, check its finiteness and launch counts, add the counts
    to ``totals``."""
    losses, step_ms = res["losses"], res["step_ms"]
    print(f"  losses: first {losses[0]:.6f} last {losses[-1]:.6f} "
          f"all finite {res['finite']}")
    print(f"  median step {res['median_ms']:.3f} ms (min {min(step_ms):.3f}, "
          f"max {max(step_ms):.3f}); chunks incl. roots "
          f"{[round(c, 1) for c in res['chunk_ms']]} ms; peak memory "
          f"{res['peak_gib']:.2f} GiB")
    print(f"  launches {res['counts']} (expected {expected})")
    if not res["finite"]:
        raise SystemExit("chip_smoke: non-finite loss or parameters")
    if res["counts"] != expected:
        raise SystemExit("chip_smoke: a path missed a kernel or took another "
                         "route")
    for k, v in res["counts"].items():
        totals[k] += v


def lmc_counts(route, chunks, steps):
    fwd = "K6" if route == "full" else "K1"
    return expect(**{fwd: chunks * steps, ROUTE_KERNEL[route]: chunks * steps,
                     "K3": 2 * chunks})


def lmc_mll(model, roots, gen):
    return model.mll(precond_roots=roots, generator=gen, **MLL_KW)


def train_phase(torch, pl, ck, fm, dev, totals):
    """Phase 4: the full-width training loop on the default route."""
    route = default_route(fm, N)
    X, Y = bench_data(N, seed=0)
    with routed("default"):
        res = train_run(torch, ck, make_model(pl, X, Y, dev), lmc_mll,
                        CHUNKS, STEPS_PER_CHUNK)
    print(f"  default backward route at n={N}: {route}")
    report(res, lmc_counts(route, CHUNKS, STEPS_PER_CHUNK), totals)
    return res["median_ms"]


def route_kernels_ms(torch, ck, it, dev, n):
    """Device times of each backward route's kernels at n (q=4, d=4,
    r=17, bf16 stack): K2 and the product of the stack with the 17
    right-hand sides, laid out as the backward lays them out; K4; K5."""
    rng = np.random.default_rng(8)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    x = t(rng.standard_normal((n, D)))
    ls, os_ = t(rng.uniform(0.5, 1.5, (Q, 1, D))), t(np.ones(Q))
    A, Bf = symmetric_factors(rng, t, n, 17)
    Ks = ck.scaled_kernel_stack_sym(x, ls, os_, "matern25", torch.bfloat16,
                                    device=dev)
    R3 = A.permute(2, 1, 0).contiguous()            # (r, n, q)
    ms = {"K2": cuda_ms(lambda: ck.lowrank_stationary_reduce_sym(
              x, ls, A, Bf, "matern25", device=dev), reps=10),
          "product": cuda_ms(lambda: it._stack_matmul(Ks, R3), reps=10),
          "K4": cuda_ms(lambda: ck.lowrank_stationary_reduce_sym_kr(
              x, ls, os_, A, Bf, "matern25", device=dev), reps=10),
          "K5": cuda_ms(lambda: ck.lowrank_stationary_reduce_sym_krs(
              x, ls, os_, A, Bf, Ks, "matern25", device=dev), reps=10)}
    del Ks
    torch.cuda.empty_cache()
    return ms


def path_a_phase(torch, pl, ck, fm, it, dev, totals):
    """Path A: one 16-step chunk of the exact-LMC step on each backward
    route at n = N_A, and at smaller n for the routing rule; each route's
    kernel times beside it."""
    times, peaks, kernels = {}, {}, {}
    for n in ROUTING_N:
        X, Y = bench_data(n, seed=0)
        for route in ("stack", "kr", "krs"):
            print(f"  n={n} route {route}:")
            with routed(route):
                res = train_run(torch, ck, make_model(pl, X, Y, dev),
                                lmc_mll, 1, STEPS_PER_CHUNK)
            report(res, lmc_counts(route, 1, STEPS_PER_CHUNK), totals)
            times[(n, route)] = res["median_ms"]
            peaks[(n, route)] = res["peak_gib"]
            torch.cuda.empty_cache()
        ms = kernels[n] = route_kernels_ms(torch, ck, it, dev, n)
        print(f"  n={n} kernels: K2 {ms['K2']:.4f} + stack product "
              f"{ms['product']:.4f} = {ms['K2'] + ms['product']:.4f} ms; "
              f"K4 {ms['K4']:.4f} ms; K5 (bf16 stack) {ms['K5']:.4f} ms")
    for n in ROUTING_N:
        ms = kernels[n]
        # the rule that sets KR_MIN_N: K4 beats K2 plus the stack product,
        # and the kr step's median is no slower than the stack step's
        beats = ms["K4"] < ms["K2"] + ms["product"]
        no_slower = times[(n, "kr")] <= times[(n, "stack")]
        print(f"  n={n}: median step stack {times[(n, 'stack')]:.3f} ms, kr "
              f"{times[(n, 'kr')]:.3f} ms, krs {times[(n, 'krs')]:.3f} ms; "
              f"peak GiB stack {peaks[(n, 'stack')]:.2f}, kr "
              f"{peaks[(n, 'kr')]:.2f}, krs {peaks[(n, 'krs')]:.2f}; K4 beats "
              f"K2 + product: {beats}; kr step no slower: {no_slower}; "
              f"default route {default_route(fm, n)} "
              f"(KR_MIN_N = {fm.KR_MIN_N})")


def path_b_phase(torch, pl, ck, fm, dev, totals):
    """Path B: ExactGPModel's auto-routed iterative MLL at n = N_B, T = 7,
    outputscales; then its value and gradients on the card against the CPU
    at n = 2048 through K4."""
    X, Y = bench_data(N_B, seed=5)
    # the measured default, unless that is the stack route: this path is
    # there to drive K4 at full width, so it is then forced onto K4
    route = default_route(fm, N_B)
    route = "kr" if route == "stack" else route
    model = pl.ExactGPModel(X, Y, pl.GaussianLikelihood(batch_shape=T,
                                                        device=dev),
                            n_tasks=T, kernel_type="matern",
                            outputscales=True, device=dev)
    kw = {k: v for k, v in MLL_KW.items() if k != "iterative"}
    with routed(route), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = train_run(torch, ck, model,
                        lambda m, _, g: m.mll(generator=g, **kw),
                        1, STEPS_B, chunk_roots=False)
    if not any("auto-routing" in str(w.message) for w in caught):
        raise SystemExit("chip_smoke: ExactGPModel did not auto-route")
    print(f"  auto-routed to the iterative MLL; backward route {route} "
          f"(default at n={N_B}: {default_route(fm, N_B)})")
    # the roots are rebuilt every call: K3 twice a step
    report(res, expect(**{"K1": STEPS_B, ROUTE_KERNEL[route]: STEPS_B,
                          "K3": 2 * STEPS_B}), totals)
    del model
    torch.cuda.empty_cache()

    n = 2048
    X, Y = bench_data(n, seed=6)
    rng = np.random.default_rng(7)
    out, state = {}, None
    with routed("kr"):
        for where in (dev, torch.device("cpu")):
            m = pl.ExactGPModel(X, Y, pl.GaussianLikelihood(batch_shape=T,
                                                            device=where),
                                n_tasks=T, kernel_type="matern",
                                outputscales=True, device=where)
            if state is None:
                with torch.no_grad():
                    for p in m.parameters():
                        p.add_(torch.as_tensor(
                            rng.uniform(-0.3, 0.3, tuple(p.shape)),
                            dtype=p.dtype, device=where))
                state = {k: v.cpu() for k, v in m.state_dict().items()}
                gen = torch.Generator(device=dev).manual_seed(1)
                eps = torch.randn((8, n, T), generator=gen, device=dev)
                xi = torch.randn((8, T, 256), generator=gen, device=dev)
            else:
                m.load_state_dict(state)
            zero_counts(ck)
            ll = m.mll(iterative=True, max_cg_iters=100, cg_tol=1e-5,
                       precond_rank=256, num_probes=8, eps=eps.to(where),
                       xi=xi.to(where))
            ll.backward()
            if where.type == "cuda" and read_counts(ck)["K4"] != 1:
                raise SystemExit("chip_smoke: ExactGPModel missed K4")
            names = [k for k, p in m.named_parameters() if p.requires_grad]
            out[where.type] = (float(ll.detach()),
                               [p.grad.cpu() for p in m.parameters()
                                if p.requires_grad])
    print(f"  ExactGPModel n={n}, card (K1, K3, K4) vs CPU:")
    compare_grads(out, names)


def path_c_phase(torch, pl, ck, dev, totals, bf16_median):
    """Path C: ``training.fit_two_phase`` at full width, 24 int8 steps then
    8 fp32 steps (roots rebuilt every call), each phase's losses, median
    step and launches; then one 16-step chunk of the int8 step with stale
    roots, beside phase 4's bf16 median."""
    X, Y = bench_data(N, seed=0)
    stamps = []

    def timed(kw):
        def loss_fn(m, generator):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return m.mll(generator=generator, **kw)
        return loss_fn
    model = make_model(pl, X, Y, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ck)
    _, info = pl.fit_two_phase(model, timed(INT8_KW), timed(FINE_KW),
                               scan_steps=1,
                               n_iter=STEPS_C, fine_frac=FINE_FRAC, lr=1e-2,
                               device=dev)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    counts = read_counts(ck)
    step_ms = np.diff(stamps) * 1e3
    n_coarse = int(STEPS_C * (1 - FINE_FRAC))
    params = torch.cat([p.detach().flatten() for p in model.parameters()])
    for name, ph, ms in zip(("int8 coarse", "fp32 fine"), info["phases"],
                            (step_ms[:n_coarse], step_ms[n_coarse:])):
        print(f"  {name}: {len(ph['losses'])} steps, losses "
              f"{np.round(ph['losses'], 6).tolist()}, median step "
              f"{float(np.median(ms)):.3f} ms")
    print(f"  fit_two_phase: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    expected = expect(K8=n_coarse, K1=STEPS_C - n_coarse, K2=STEPS_C,
                      K3=2 * STEPS_C)
    print(f"  launches {counts} (expected {expected})")
    if ([len(ph["losses"]) for ph in info["phases"]]
            != [n_coarse, STEPS_C - n_coarse]
            or not np.all(np.isfinite(info["losses"]))
            or not bool(torch.isfinite(params).all())):
        raise SystemExit("chip_smoke: fit_two_phase did not take its steps "
                         "with finite losses and parameters")
    if counts != expected:
        raise SystemExit("chip_smoke: fit_two_phase missed a kernel")
    for k, v in counts.items():
        totals[k] += v
    del model
    torch.cuda.empty_cache()

    print(f"  the int8 step, {STEPS_PER_CHUNK} steps with stale roots:")
    res = train_run(torch, ck, make_model(pl, X, Y, dev),
                    lambda m, r, g: m.mll(precond_roots=r, generator=g,
                                          **INT8_KW), 1, STEPS_PER_CHUNK)
    report(res, expect(K8=STEPS_PER_CHUNK, K2=STEPS_PER_CHUNK, K3=2), totals)
    print(f"  median step int8 {res['median_ms']:.3f} ms, bf16 (phase 4) "
          f"{bf16_median:.3f} ms")
    torch.cuda.empty_cache()


def path_d_phase(torch, pl, ck, dev, totals, sym_median):
    """Path D: phase 4's step on the full grid (``PLMC_SYM_BUILD=0``: K6
    builds the stack, K7 reduces), one 16-step chunk."""
    X, Y = bench_data(N, seed=0)
    with routed("full"):
        res = train_run(torch, ck, make_model(pl, X, Y, dev), lmc_mll, 1,
                        STEPS_PER_CHUNK)
    report(res, lmc_counts("full", 1, STEPS_PER_CHUNK), totals)
    print(f"  median step full grid {res['median_ms']:.3f} ms, symmetric "
          f"(phase 4) {sym_median:.3f} ms")
    torch.cuda.empty_cache()


def path_e_phase(torch, pl, ck, dev, totals, median_4):
    """Path E: phase 4's step at SARCOS's width, d = DE (the reductions at
    their padded width), one 16-step chunk; then one 16-step chunk of the
    int8 step (mll(matvec_int8=True)) at the same width. Inputs N(0, 1), the
    lengthscales started √(DE/D) times the default, so that the distances
    are those of the d = D step."""
    X, Y = bench_data(N, seed=9, d=DE)
    medians = {}
    for label, kw, fwd in (("bf16 stack", MLL_KW, "K1"),
                           ("int8 stack", INT8_KW, "K8")):
        model = make_model(pl, X, Y, dev)
        cov = model.covar_module
        cov.set_lengthscale(cov.lengthscale.detach() * (DE / D) ** 0.5)
        print(f"  {label}, {STEPS_PER_CHUNK} steps, roots once:")
        with routed("default"):
            res = train_run(torch, ck, model,
                            lambda m, r, g, kw=kw: m.mll(precond_roots=r,
                                                         generator=g, **kw),
                            1, STEPS_PER_CHUNK)
        report(res, expect(**{fwd: STEPS_PER_CHUNK, "K2": STEPS_PER_CHUNK,
                              "K3": 2}), totals)
        medians[label] = res["median_ms"]
        del model
        torch.cuda.empty_cache()
    print(f"  median step at d={DE}: bf16 {medians['bf16 stack']:.3f} ms, "
          f"int8 {medians['int8 stack']:.3f} ms; at d={D} (phase 4) "
          f"{median_4:.3f} ms")


def fit_phase(torch, pl, dev):
    """Phase 5: the ``training.fit`` entry point at a smaller n."""
    X, Y = bench_data(2000, seed=4)
    model = make_model(pl, X, Y, dev)

    def loss_fn(m, generator):
        return m.mll(generator=generator, **MLL_KW)

    _, info = pl.fit(model, loss_fn, n_iter=4, lr=1e-2, scan_steps=1,
                     device=dev)
    print(f"  fit losses {info['losses'].tolist()} in {info['train_time']:.2f} s")
    if len(info["losses"]) != 4 or not np.all(np.isfinite(info["losses"])):
        raise SystemExit("chip_smoke: training.fit gave non-finite losses")


# path F: projected LMC, the paper's model, in the model configurations of
# its experiments (projected_lmc_tpu/experiments/driver.py:45-49); F1 on the
# paper's synthetic default (generate_synthetic(): n = 500, p = 100, d = 1)
# with q = 25, F2 on phase 4's data (n = 10,000, p = 7, d = 4) with q = Q
PROJ_CONFIGS = {
    "PLMC": dict(BDN=False, diagonal_B=False, scalar_B=False,
                 diagonal_R=False),
    "oilmm": dict(BDN=True, diagonal_B=True, scalar_B=True, diagonal_R=True),
    "PLMC_fast": dict(BDN=True, diagonal_B=True, scalar_B=True,
                      diagonal_R=False),
}
F1_MODELS = (("PLMC", {}), ("PLMC_fast", {}), ("oilmm", {}),
             ("oilmm", dict(bulk=False)))
F1_Q, F1_STEPS, F2_STEPS, F_CHECK_N = 25, 64, 16, 2048
F_RANGES = ("F K3", "F K3 backward (plain)", "F potrf", "F Cholesky pullback",
            "F triangular solve", "F QR or orthogonal map")


def projected_model(pl, X, Y, q, name, extra, device):
    return pl.ProjectedGPModel(X, Y, Y.shape[1], q, init_lmc_coeffs=True,
                               mean_type="zero", kernel_type="matern",
                               device=device, **PROJ_CONFIGS[name], **extra)


@contextlib.contextmanager
def projected_probes(torch):
    """From outside the package: count the factorizations of the Cholesky
    ladder (its factor function ``ops.cholesky._factor``), and label for the
    profiler K3's forward and its plain backward, each factorization, the
    Cholesky pullback (the log-density's closed form), the log-density's
    triangular solves and the mixing matrix's QR (or orthogonal map)."""
    from torch.profiler import record_function
    from projected_lmc_tpu_torch import kernels as kern
    from projected_lmc_tpu_torch.models import projected
    from projected_lmc_tpu_torch.ops import cholesky as chol
    counts = {"factorizations": 0}

    def labelled(label, fn, counted=False):
        def wrapped(*args, **kwargs):
            counts["factorizations"] += counted
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    skm, gl = kern._StationaryKernelMatrix, chol._GaussianLogDensity
    mix = projected.LMCMixingMatrix
    patches = ((chol, "_factor", labelled("F potrf", chol._factor, True)),
               (skm, "forward", staticmethod(labelled("F K3", skm.forward))),
               (skm, "backward", staticmethod(labelled(
                   "F K3 backward (plain)", skm.backward))),
               (gl, "backward", staticmethod(labelled(
                   "F Cholesky pullback", gl.backward))),
               (chol, "solve_triangular", labelled(
                   "F triangular solve", chol.solve_triangular)),
               (mix, "QR", labelled("F QR or orthogonal map", mix.QR)))
    saved = [(owner, name, vars(owner)[name]) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        yield counts
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)


def carried(pl, model, where, make):
    """A model built by ``make`` on ``where`` carrying ``model``'s leaves
    (``load_jax_state``), in its own dtype."""
    from projected_lmc_tpu_torch.module import keyed_state
    out = make(where)
    pl.load_jax_state(out, {k: v.detach().cpu().double().numpy()
                            for k, v in keyed_state(model).items()})
    return out


def grads_of_mll(pl, model):
    """(value, {name: gradient}) of ``projected_lmc_mll`` over the trainable
    leaves, on the host in float64."""
    ll = pl.projected_lmc_mll(model)
    ll.backward()
    return float(ll.detach()), {k: p.grad.detach().cpu().double()
                                for k, p in model.named_parameters()
                                if p.requires_grad}


def card_against_cpu(torch, pl, ck, dev, make, label):
    """``projected_lmc_mll``'s value and gradients on the card (K3 once, one
    factorization) against the CPU (plain versions), the CPU model carrying
    the card model's leaves by ``load_jax_state``, at the SVD init
    moved by a seeded uniform(−0.3, 0.3) on every trainable leaf (as path
    B). At the init itself the SVD puts Q at a stationary point of ‖YQ‖²,
    where the mixing matrix's fp32 gradient is rounding noise on any device:
    the CPU's fp32 gradients against its fp64 ones there are printed
    beside. ``make(where, dtype)`` builds the model."""
    cpu = torch.device("cpu")
    start = make(cpu, np.float32)
    _, g32 = grads_of_mll(pl, start)
    _, g64 = grads_of_mll(pl, carried(pl, start, cpu,
                                      lambda w: make(w, np.float64)))
    noise = {k.split(".")[-1]: float((g32[k] - g64[k]).abs().max()
                                     / g64[k].abs().max()) for k in g64}
    print(f"  {label}: at the SVD init, CPU fp32 against fp64, "
          f"max|Δ|/max|fp64|: "
          + ", ".join(f"{k} {v:.1e}" for k, v in noise.items()))
    card = make(dev, np.float32)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for p in card.parameters():
            p.add_(torch.as_tensor(rng.uniform(-0.3, 0.3, tuple(p.shape)),
                                   dtype=p.dtype, device=p.device))
    out = {}
    zero_counts(ck)
    with projected_probes(torch) as probes:
        out["cuda"] = grads_of_mll(pl, card)
    if read_counts(ck) != expect(K3=1) or probes["factorizations"] != 1:
        raise SystemExit(f"chip_smoke: {label}'s MLL launched "
                         f"{read_counts(ck)} and factorized "
                         f"{probes['factorizations']} times, not K3 and one "
                         f"factorization")
    out["cpu"] = grads_of_mll(pl, carried(pl, card, cpu,
                                          lambda w: make(w, np.float32)))
    print(f"  {label}, moved off the init: card (K3, one factorization) vs "
          f"CPU:")
    names = list(out["cpu"][1])
    compare_grads({k: (v, [g[n] for n in names]) for k, (v, g) in out.items()},
                  names)


def orthogonality(torch, model) -> float:
    """max |QᵀQ − I| over the mixing matrix's Q and its complement."""
    with torch.no_grad():
        Q, _, Q_orth = model.lmc_coefficients.QR()
        Qf = Q if Q_orth is None else torch.cat([Q, Q_orth], 1)
        eye = torch.eye(Qf.shape[1], dtype=Qf.dtype, device=Qf.device)
        return float((Qf.T @ Qf - eye).abs().max())


def projected_fit(torch, pl, ck, model, steps, label, totals):
    """``steps`` of ``fit(model, projected_lmc_mll, lr=1e-2,
    schedule=lambda_lr_schedule(1e-2, 1e-3))``: first and last losses
    (finite and falling), median step, peak memory, K3 launches and
    factorizations (one of each a step)."""
    stamps = []

    def loss_fn(m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return pl.projected_lmc_mll(m)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ck)
    with projected_probes(torch) as probes:
        _, info = pl.fit(model, loss_fn, n_iter=steps, lr=1e-2,
                         schedule=pl.lambda_lr_schedule(1e-2, 1e-3),
                         scan_steps=1, device=model.device)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    counts = read_counts(ck)
    losses = info["losses"]
    step_ms = np.diff(stamps) * 1e3
    params = torch.cat([p.detach().flatten() for p in model.parameters()])
    finite = bool(np.all(np.isfinite(losses)) and torch.isfinite(params).all())
    median = float(np.median(step_ms))
    print(f"  {label}: {len(losses)} steps, loss first {losses[0]:.6f} last "
          f"{losses[-1]:.6f}, all finite {finite}; median step {median:.3f} "
          f"ms (min {step_ms.min():.3f}, max {step_ms.max():.3f}); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches {counts}; factorizations {probes['factorizations']}")
    if len(losses) != steps or not finite or not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: {label} did not take {steps} steps "
                         f"with finite, falling losses")
    if counts != expect(K3=steps) or probes["factorizations"] != steps:
        raise SystemExit(f"chip_smoke: {label} did not launch K3 and "
                         f"factorize once a step")
    totals["K3"] += counts["K3"]
    return median


def range_split(torch, step, reps=2, names=F_RANGES, kernel_names=()):
    """Profile ``reps`` calls of ``step`` (after one unprofiled): the wall
    time, the device-busy time (every kernel), for each range labelled with
    one of ``names`` its device span (from its first kernel's start to its
    last one's end, idle gaps included), host time and the device time of
    the kernels launched inside it (kernels launched through the kernel
    library's C interface are not, so each of ``kernel_names`` gets the
    device time of the kernels whose names contain it, as a third entry),
    all in ms a call, and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    avg = prof.key_averages()
    # a labelled range appears twice: on the host, and as a device
    # annotation spanning its kernels (not a kernel itself)
    kernels = sorted((e for e in avg if e.device_type.name == "CUDA"
                      and getattr(e, "device_time_total", 0) > 0
                      and e.key not in names),
                     key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in kernels) / 1e3 / reps
    ranges = {k: [float("nan")] * 3 for k in names}
    for e in avg:
        if e.key in names:
            if e.device_type.name == "CUDA":
                ranges[e.key][0] = e.device_time_total / 1e3 / reps
            else:       # the host event: its time, and its kernels' time
                ranges[e.key][1:] = [e.cpu_time_total / 1e3 / reps,
                                     e.device_time_total / 1e3 / reps]
    for k in kernel_names:
        ranges[k] = [float("nan")] * 2 + [sum(
            e.device_time_total for e in kernels if k in e.key) / 1e3 / reps]
    top = [(e.key.split("<")[0].split("(")[0][:60],
            e.device_time_total / 1e3 / reps) for e in kernels[:6]]
    return wall, busy, ranges, top


def mll_step(pl, model):
    def step():
        model.zero_grad(set_to_none=True)
        (-pl.projected_lmc_mll(model)).backward()
    return step


def k3_against_plain(ck, model, block=1000):
    """K3 at the model's (q, n, n) against its plain version, a block of
    rows at a time; returns the largest absolute error."""
    x = model.train_x
    ls = model.covar_module.lengthscale.detach()
    got = ck.kernel_matrix(x, x, ls, KIND, device=x.device)
    err = 0.0
    for i0 in range(0, x.shape[0], block):
        want = ck.kernel_matrix_plain(x[i0:i0 + block], x, ls, KIND)
        err = max(err, float((got[:, i0:i0 + block] - want).abs().max()))
    return err


def old_ladder(torch, A, max_tries=8):
    """The port's ladder before slice 8: the plain factor and all eight
    jittered ones, chosen on the device by masked selects."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)

    def nan_factor(M):
        L, info = torch.linalg.cholesky_ex(M)
        return torch.where((info != 0)[..., None, None],
                           torch.full_like(L, float("nan")), L)
    L = nan_factor(A)
    ok = torch.isfinite(L).all()
    jitter = 1e-6
    for _ in range(max_tries):
        Lj = nan_factor(A + jitter * eye)
        L = torch.where(ok, L, Lj)
        ok = ok | torch.isfinite(Lj).all()
        jitter *= 10.0
    return L


def path_f_phase(torch, pl, ck, dev, totals):
    """Path F: projected LMC. F1: the paper's synthetic default in each of
    the experiments' model configurations, 64 ``fit`` steps each, the
    first step against the CPU, the QR's orthogonality, and the QR (or orthogonal map)
    in a profile of the step. F2: the full-B̃ model at phase 4's data, 16
    ``fit`` steps, the device time split, the ladder's factorizations
    against the old ladder's, and the card against the CPU at n = 2048."""
    from projected_lmc_tpu_torch.experiments import generate_synthetic
    from projected_lmc_tpu_torch.ops import cholesky as chol
    t0 = time.perf_counter()
    data = generate_synthetic()
    X, Y = data["X"], data["Y"]
    print(f"  F1 data: generate_synthetic() X {X.shape} Y {Y.shape} "
          f"{Y.dtype} in {time.perf_counter() - t0:.1f} s")
    for name, extra in F1_MODELS:
        label = name + "".join(f" {k}={v}" for k, v in extra.items())
        card_against_cpu(
            torch, pl, ck, dev, lambda where, dt, name=name, extra=extra:
            projected_model(pl, X.astype(dt), Y.astype(dt), F1_Q, name,
                            extra, where), label)
        model = projected_model(pl, X, Y, F1_Q, name, extra, dev)
        if name == "PLMC":
            check(f"K3 kernel_matrix ({F1_Q},{X.shape[0]},{X.shape[0]}) "
                  f"d=1", k3_against_plain(ck, model), 1e-4)
        ortho = [orthogonality(torch, model)]
        projected_fit(torch, pl, ck, model, F1_STEPS, label, totals)
        ortho.append(orthogonality(torch, model))
        print(f"  {label}: max|QᵀQ − I| {ortho[0]:.2e} at the start, "
              f"{ortho[1]:.2e} after training (tolerance 1e-5)")
        if not max(ortho) <= 1e-5:
            raise SystemExit(f"chip_smoke: {label}'s Q is not orthogonal")
        if name == "PLMC" or not extra.get("bulk", True):
            with projected_probes(torch):
                wall, busy, ranges, _ = range_split(
                    torch, mll_step(pl, model), reps=3)
            dev_ms, host_ms = ranges["F QR or orthogonal map"][:2]
            print(f"  {label} profile: MLL forward and backward {wall:.3f} "
                  f"ms (device busy {busy:.3f}); QR or orthogonal map "
                  f"{host_ms:.3f} ms of host time, {dev_ms:.3f} ms of device "
                  f"time a step")
        del model
        torch.cuda.empty_cache()

    n = N
    Xb, Yb = bench_data(n, seed=0)
    model = projected_model(pl, Xb, Yb, Q, "PLMC", {}, dev)
    check(f"K3 kernel_matrix ({Q},{n},{n}) d={D}",
          k3_against_plain(ck, model), 1e-4)
    torch.cuda.empty_cache()
    median = projected_fit(torch, pl, ck, model, F2_STEPS,
                           f"F2 PLMC n={n} p={T} q={Q}", totals)
    with projected_probes(torch):
        wall, busy, ranges, top = range_split(torch, mll_step(pl, model))
    split = {k: v[0] for k, v in ranges.items()}
    parts = ("F K3", "F K3 backward (plain)", "F potrf", "F Cholesky pullback",
             "F triangular solve")
    rest = busy - sum(split.get(k, 0.0) for k in parts)
    print(f"  F2 profile, MLL forward and backward: wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms: " + ", ".join(
              f"{k[2:]} {split.get(k, float('nan')):.3f}" for k in parts)
          + f", rest {rest:.3f} ms; median fit step {median:.3f} ms")
    print("  F2 kernels by device time: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in top))
    with torch.no_grad():
        A = model.likelihood.add_to_covar(model.covar_module(model.train_x))
    with projected_probes(torch) as probes:
        L = chol.safe_cholesky(A)
    same = torch.equal(L, old_ladder(torch, A))
    del L
    new_ms = cuda_ms(lambda: chol.safe_cholesky(A), reps=3, warmup=1)
    old_ms = cuda_ms(lambda: old_ladder(torch, A), reps=2, warmup=1)
    print(f"  F2 ladder on ({Q},{n},{n}): {probes['factorizations']} "
          f"factorization, {new_ms:.3f} ms; the old ladder 9 factorizations, "
          f"{old_ms:.3f} ms; same factor: {same}")
    if probes["factorizations"] != 1 or not same:
        raise SystemExit("chip_smoke: the ladder did not factorize once, or "
                         "its factor differs from the old ladder's")
    del A, model
    torch.cuda.empty_cache()

    Xc, Yc = bench_data(F_CHECK_N, seed=10)
    card_against_cpu(torch, pl, ck, dev, lambda where, dt: projected_model(
        pl, Xc.astype(dt), Yc.astype(dt), Q, "PLMC", {}, where),
        f"F2 PLMC n={F_CHECK_N}")


# path G: prediction served from a cache built once. G1: projected LMC at F2's
# widths; G2: the paper's synthetic default in the experiments' four model
# configurations, trained to the plateau or the cap; G3: the exact-LMC model
# of phase 4.
# Card against CPU at F_CHECK_N (the multitask LOO, which factorizes the
# dense (n·T)² system, at G_LOO_N).
# G2's and H1's plateau cap. At 1,000 steps G2's PLMC_fast mean parts from
# the CPU's by 1.08e-4 (limit 1e-4; 9.29e-5 at 2,000) and H1's metrics from
# the fp64 ones by more than the CPU's fp32 metrics do, so both keep 2,000.
N_TEST, G_STEPS, G_PREDICTS, G2_MAX_ITER = 2500, 16, 8, 2000
I1_MAX_ITER = 1000          # I1's cap, short of its plateau: finite metrics


def stop_note(steps, cap):
    """Where a fit capped at ``cap`` steps stopped: at the cap (its metrics
    are those of a fit cut short of the plateau) or at the plateau."""
    return (f"stopped at its cap of {cap} steps, short of the plateau"
            if steps >= cap else f"stopped at the plateau, below its cap "
            f"of {cap} steps")


G_DENSE_N = 1024            # q·n = 4096, the dense Woodbury MLL's largest
G_CHECK_TEST, G_LOO_N = 500, 512
# README.md's JAX figures for the synthetic default under the fully
# converged protocol (R²; context, not limits)
README_R2 = {"PLMC": 0.923, "PLMC_fast": 0.981, "oilmm": 0.981}


def timed(torch, fn):
    """(fn(), host ms) with the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def served(torch, ck, label, k3, fn, totals):
    """``fn`` (calls through the port's entry points) with the launch counts
    set to 0 just before and read just after: it must launch K3 ``k3``
    times and no other kernel; the counts go into ``totals``. Returns
    (result, host ms)."""
    zero_counts(ck)
    out, ms = timed(torch, fn)
    if read_counts(ck) != expect(K3=k3):
        raise SystemExit(f"chip_smoke: {label} launched {read_counts(ck)}, "
                         f"not K3 {k3} times")
    totals["K3"] += k3
    return out, ms


def k3_at(torch, ck, dev, x1, x2, ls, block=500):
    """K3 at path G's shape (q, len(x1), len(x2)) against its plain version,
    a block of rows at a time (1e-4, as phase 2), and bitwise against K6 at
    os = 1."""
    got = ck.kernel_matrix(x1, x2, ls, KIND, device=dev)
    err = 0.0
    for i0 in range(0, x1.shape[0], block):
        want = ck.kernel_matrix_plain(x1[i0:i0 + block], x2, ls, KIND)
        err = max(err, float((got[:, i0:i0 + block] - want).abs().max()))
    check(f"K3 kernel_matrix {tuple(got.shape)} d={x1.shape[1]}", err, 1e-4)
    k3_is_k6(torch, ck, dev, got, x1, x2, ls,
             torch.ones(ls.shape[0], dtype=torch.float32, device=dev))


def held(name, got, want, scale, tol):
    """max |card − CPU| / scale ≤ tol."""
    err = float((got.detach().cpu().double() - want.detach().cpu().double())
                .abs().max()) / scale
    print(f"  {name}: max|card − cpu| / {scale:.4g} = {err:.2e} "
          f"(tolerance {tol:.0e})")
    if not (math.isfinite(err) and err <= tol):
        raise SystemExit(f"chip_smoke: {name} disagrees between the card and "
                         f"the CPU")


def scale_of(t) -> float:
    return float(t.detach().abs().max())


def prior_var_max(torch, model, x) -> float:
    """The largest prior variance with noise at x: Σ_b k_b(x, x) H[t,b]² +
    Σ[t,t] for the projected and the LMC model, k(x, x) B[t,t] + Σ[t,t]
    for the ICM."""
    with torch.no_grad():
        kss = model.covar_module(x, diag=True)                  # (q, n*)
        if getattr(model, "icm", False):
            B = torch.diagonal(model.task_covar_matrix())
            St = torch.diagonal(model.likelihood.task_covariance())
            return float((kss[0][:, None] * B + St).max())
        if hasattr(model, "full_likelihood"):
            H2 = model.lmc_coefficients() ** 2                  # (q, p)
            noise = model.full_likelihood().task_covariance()
        else:
            H, noise = model._mixing()
            H2 = (H * H).T
        return float((kss.T @ H2 + torch.diagonal(noise)).max())


def moved(torch, model, seed):
    """Every trainable leaf moved by a seeded uniform(−0.3, 0.3)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            if p.requires_grad:
                p.add_(torch.as_tensor(rng.uniform(-0.3, 0.3, tuple(p.shape)),
                                       dtype=p.dtype, device=p.device))
    return model


def predictions_held(torch, label, card, cpu, x, cache=True):
    """``predict(observed=True)`` (through ``prediction_cache`` when
    ``cache``) and ``compute_loo`` of a projected model on the card against
    the CPU model carrying its leaves:
    mean within 1e-4 of its largest entry, variance within 1e-3 of the
    largest prior variance, LOO σ² and residuals within 1e-3. Returns the
    CPU's (mean, variance, σ², residual)."""
    out = []
    for m in (card, cpu):
        with torch.no_grad():
            c = m.prediction_cache() if cache else None
            out.append((*m.predict(x.to(m.device), observed=True, cache=c),
                        *m.compute_loo()))
    (g, c) = out
    held(f"{label} mean", g[0], c[0], scale_of(c[0]), 1e-4)
    held(f"{label} variance", g[1], c[1], prior_var_max(torch, cpu, x), 1e-3)
    held(f"{label} LOO sigma2", g[2], c[2], scale_of(c[2]), 1e-3)
    held(f"{label} LOO residual", g[3], c[3], scale_of(c[3]), 1e-3)
    return c


def path_g1(torch, pl, ck, fm, dev, totals):
    """G1: PLMC at n = 10⁴, p = 7, q = 4 on phase 4's data, 16 ``fit`` steps,
    then served: the cache once, 8 warm ``predict`` calls on 2,500 held-out
    points, one cold, one ``compute_loo``, the 15 metrics; the card against
    the CPU at n = 2048."""
    Xb, Yb = bench_data(N, seed=0)
    Xt, Yt = bench_data(N_TEST, seed=20)
    model = projected_model(pl, Xb, Yb, Q, "PLMC", {}, dev)
    t0 = time.perf_counter()
    projected_fit(torch, pl, ck, model, G_STEPS, f"G1 PLMC n={N} p={T} "
                  f"q={Q}, {G_STEPS} fit steps", totals)
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        loss = float(-pl.projected_lmc_mll(model))
    x_test = torch.as_tensor(Xt, device=dev)
    ls = model.covar_module.lengthscale.detach()
    k3_at(torch, ck, dev, model.train_x, x_test, ls)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), projected_probes(torch) as probes:
        cache, cache_ms = served(torch, ck, "G1 prediction_cache", 1,
                                 model.prediction_cache, totals)
        cache_reads = probes["factorizations"]
        warm = []
        for _ in range(G_PREDICTS):
            (mean, var), ms = served(
                torch, ck, "G1 predict", 1,
                lambda: model.predict(x_test, cache=cache), totals)
            warm.append(ms)
        predict_reads = (probes["factorizations"] - cache_reads) / G_PREDICTS
        _, cold_ms = served(torch, ck, "G1 cold predict", 2,
                            lambda: model.predict(x_test), totals)
        _, loo_ms = served(torch, ck, "G1 compute_loo", 1, model.compute_loo,
                           totals)
        H_hid = model.full_likelihood().task_noise_covar_factor
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        for what, fn in (("prediction_cache", model.prediction_cache),
                         ("predict", lambda: model.predict(x_test,
                                                           cache=cache)),
                         ("compute_loo", model.compute_loo)):
            wall, busy, _, top = range_split(torch, fn, reps=1)
            print(f"  G1 {what} profiled: wall {wall:.3f} ms, device busy "
                  f"{busy:.3f} ms; " + ", ".join(f"{k} {v:.3f} ms"
                                                 for k, v in top))
    print(f"  G1 served: prediction_cache {cache_ms:.3f} ms; predict "
          f"({N_TEST} points, cached) first {warm[0]:.3f} ms, median "
          f"{np.median(warm):.3f} ms of {G_PREDICTS}; cold predict "
          f"{cold_ms:.3f} ms; compute_loo {loo_ms:.3f} ms; peak memory "
          f"{peak:.2f} GiB; factorizations (one host read each): cache "
          f"{cache_reads}, predict {predict_reads:g}")
    ok = bool(torch.isfinite(mean).all() and torch.isfinite(var).all()
              and (var > 0).all() and mean.shape == (N_TEST, T))
    if not ok:
        raise SystemExit("chip_smoke: G1's prediction is not finite and "
                         "positive, or not (n*, p)")
    metrics = pl.compute_metrics(Yt, mean, torch.sqrt(var), loss, H_hid,
                                 G_STEPS, train_s, np.median(warm) / 1e3,
                                 print_metrics=False)
    print("  G1 metrics (noise targets): " + ", ".join(
        f"{k} {v:.6g}" for k, v in metrics.items()))
    del model, cache, mean, var
    torch.cuda.empty_cache()

    Xc, Yc = bench_data(F_CHECK_N, seed=10)
    xc = torch.as_tensor(bench_data(G_CHECK_TEST, seed=12)[0])
    make = lambda w: projected_model(pl, Xc, Yc, Q, "PLMC", {}, w)  # noqa
    card = moved(torch, make(dev), 11)
    predictions_held(torch, f"G1 n={F_CHECK_N}", card,
                     carried(pl, card, torch.device("cpu"), make), xc)


def path_g2(torch, pl, ck, fm, dev, totals):
    """G2: the paper's synthetic default in the experiments' four model
    configurations, ``fit`` for at most ``G2_MAX_ITER`` steps (to the plateau
    or the cap, which the line says), ``predict(observed=True)`` on the 2,500
    test points and the metrics, beside the README's fully converged JAX
    figures; the card against the CPU on each trained model."""
    from projected_lmc_tpu_torch.experiments import generate_synthetic
    data = generate_synthetic()
    X, Y, Xt, Yt = data["X"], data["Y"], data["X_test"], data["Y_test"]
    x_test = torch.as_tensor(Xt, device=dev)
    for name, extra in F1_MODELS:
        label = "G2 " + name + "".join(f" {k}={v}" for k, v in extra.items())
        model = projected_model(pl, X, Y, F1_Q, name, extra, dev)
        zero_counts(ck)
        _, info = pl.fit(model, pl.projected_lmc_mll, n_iter=G2_MAX_ITER,
                         lr=1e-2, schedule=pl.lambda_lr_schedule(1e-2, 1e-3),
                         scan_steps=1, device=dev)
        steps = len(info["losses"])         # K3 once a step
        if read_counts(ck) != expect(K3=steps):
            raise SystemExit(f"chip_smoke: {label}'s fit launched "
                             f"{read_counts(ck)}, not K3 {steps} times")
        totals["K3"] += steps
        if name == "PLMC" and not extra:
            k3_at(torch, ck, dev, model.train_x, x_test,
                  model.covar_module.lengthscale.detach())
        with torch.no_grad():
            (mean, var), pred_ms = served(
                torch, ck, f"{label} predict", 2,
                lambda: model.predict(x_test, observed=True), totals)
            H_hid = model.full_likelihood().task_noise_covar_factor
        args = (info["loss"], H_hid, info["n_iter"], info["train_time"],
                pred_ms / 1e3)
        got = pl.compute_metrics(Yt, mean, torch.sqrt(var), *args,
                                 print_metrics=False)
        print(f"  {label}: {steps} steps ({stop_note(steps, G2_MAX_ITER)}) "
              f"in {info['train_time']:.1f} s, loss {info['loss']:.6f}; R2 "
              f"{got['R2']:.4f} (README, JAX, fully converged: "
              f"{README_R2[name]}), RMSE {got['RMSE']:.4f}, PVA "
              f"{got['PVA']:.4f}, alpha_CI {got['alpha_CI']:.4f}; predict "
              f"{pred_ms:.3f} ms")
        if not all(math.isfinite(v) for v in got.values()):
            raise SystemExit(f"chip_smoke: {label}'s metrics are not finite")
        cpu = carried(pl, model, torch.device("cpu"), lambda w, n=name,
                      e=extra: projected_model(pl, X, Y, F1_Q, n, e, w))
        cm, cv, _, _ = predictions_held(torch, label, model, cpu,
                                        torch.as_tensor(Xt), cache=False)
        cpu64 = carried(pl, model, torch.device("cpu"), lambda w, n=name,
                        e=extra: projected_model(pl, X.astype(np.float64),
                                                 Y.astype(np.float64), F1_Q,
                                                 n, e, w))
        with torch.no_grad():
            m64, _ = cpu64.predict(torch.as_tensor(Xt, dtype=torch.float64),
                                   observed=True)
        print(f"  {label}: the CPU's fp32 mean against its fp64 one, "
              f"max|Δ|/max|fp64| {float((cm - m64).abs().max()) / scale_of(m64):.2e}"
              f" (the fp32 rounding of the solve, beside the limit above)")
        want = pl.compute_metrics(Yt, cm, torch.sqrt(cv), *args,
                                  print_metrics=False)
        err = max(abs(got[k] - want[k]) / max(1.0, abs(want[k]))
                  for k in want)
        print(f"  {label}: the 15 metrics, card against CPU, max|Δ|/max(1, "
              f"|cpu|) {err:.2e} (tolerance 1e-3)")
        if not (math.isfinite(err) and err <= 1e-3):
            raise SystemExit(f"chip_smoke: {label}'s metrics disagree "
                             f"between the card and the CPU")
        del model, cpu
        torch.cuda.empty_cache()


@contextlib.contextmanager
def cache_probes(torch, names, product):
    """From outside the package: the host time (synchronised) of each part
    of a matrix-free cache, ``names`` ((module, function, part) triples;
    a part called inside another is timed with the outer one), the count
    of ``product`` ((module, function), the PCG's products, so its
    iterations) and the PCG's arguments."""
    parts = {key: 0.0 for _, _, key in names}
    parts.update(products=0, pcg_call=None)
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in names]
    depth = [0]

    def timing(fn, key):
        def wrapped(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            if key == "PCG":
                parts["pcg_call"] = (fn, args, kwargs)
            depth[0] += 1
            try:
                out, ms = timed(torch, lambda: fn(*args, **kwargs))
            finally:
                depth[0] -= 1
            parts[key] += ms
            return out
        return wrapped

    owner, name = product
    matvec = getattr(owner, name)

    def counted(*args):
        parts["products"] += 1
        return matvec(*args)
    for o, n, key in names:
        setattr(o, n, timing(getattr(o, n), key))
    setattr(owner, name, counted)
    try:
        yield parts
    finally:
        setattr(owner, name, matvec)
        for o, n, old in saved:
            setattr(o, n, old)


@contextlib.contextmanager
def lmc_iter_probes(torch):
    """The parts of the "lmc_iter" cache (:func:`cache_probes`)."""
    from projected_lmc_tpu_torch.ops import iterative as it_ops
    from projected_lmc_tpu_torch.ops import woodbury as wb_ops
    with cache_probes(torch, (
            (it_ops, "nystrom_roots_from_covar", "roots"),
            (it_ops, "nystrom_precond", "preconditioner"),
            (it_ops, "batched_pcg", "PCG"),
            (it_ops, "residual_spectral_bound", "spectral bound"),
            (wb_ops, "lmc_factors_from_roots", "factors")),
            (it_ops, "lmc_matvec")) as parts:
        yield parts


def lmc_posteriors_held(torch, pl, dev, n, iterative, label):
    """The LMC posterior (``iterative`` False: "lmc", True: "lmc_iter") at n
    on the card against the CPU (same leaves and start vector): mean within
    1e-4 of its largest entry (1e-3 for "lmc_iter"), variance within 1e-3
    of the largest prior variance."""
    X, Y = bench_data(n, seed=15)
    xs = torch.as_tensor(bench_data(G_CHECK_TEST, seed=16)[0])
    v0 = np.random.default_rng(17).standard_normal((n, T))
    card = moved(torch, make_model(pl, X, Y, dev), 18)
    cpu = carried(pl, card, torch.device("cpu"),
                  lambda w: make_model(pl, X, Y, w))
    out = []
    for m in (card, cpu):
        with torch.no_grad():
            c = m.precompute_posterior(
                iterative=iterative, v0=torch.as_tensor(
                    v0, dtype=torch.float32, device=m.device))
            p = m.posterior(xs.to(m.device), cache=c)
        out.append((p.mean, p.variance))
    (g, c) = out
    kind = "lmc_iter" if iterative else "lmc"
    held(f"{label} {kind} mean", g[0], c[0], scale_of(c[0]),
         1e-3 if iterative else 1e-4)
    held(f"{label} {kind} variance", g[1], c[1],
         prior_var_max(torch, cpu, xs), 1e-3)


def path_g3(torch, pl, ck, fm, dev, totals):
    """G3: the exact-LMC model of phase 4 (n = 10⁴, T = 7, q = 4), trained
    as phase 4, its "lmc_iter" cache timed by part, ``posterior`` on 2,500
    points; ``fit`` with the default (dense Woodbury) loss at q·n = 4096;
    the posteriors and the LOO on the card against the CPU."""
    X, Y = bench_data(N, seed=0)
    route = default_route(fm, N)
    model = make_model(pl, X, Y, dev)
    with routed("default"):
        res = train_run(torch, ck, model, lmc_mll, CHUNKS, STEPS_PER_CHUNK)
    print(f"  G3 the exact-LMC model, trained as phase 4 ({CHUNKS}x"
          f"{STEPS_PER_CHUNK} steps):")
    report(res, lmc_counts(route, CHUNKS, STEPS_PER_CHUNK), totals)
    x_test = torch.as_tensor(bench_data(N_TEST, seed=20)[0], device=dev)
    k3_at(torch, ck, dev, x_test, model.train_x,
          model.covar_module.lengthscale.detach())
    torch.cuda.empty_cache()
    v0 = torch.as_tensor(np.random.default_rng(19).standard_normal((N, T)),
                         dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), lmc_iter_probes(torch) as parts, \
            projected_probes(torch) as probes:
        cache, cache_ms = served(
            torch, ck, "G3 precompute_posterior", 3,
            lambda: model.precompute_posterior(v0=v0), totals)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    iters = parts["products"]
    fn, args, kwargs = parts["pcg_call"]
    with torch.no_grad():
        wall, busy, _, _ = range_split(torch, lambda: fn(*args, **kwargs),
                                       reps=1)
    rest = cache_ms - sum(parts[k] for k in ("roots", "preconditioner", "PCG",
                                             "spectral bound", "factors"))
    print(f"  G3 precompute_posterior ({cache['kind']}): {cache_ms:.3f} ms = "
          + ", ".join(f"{k} {parts[k]:.3f}" for k in (
              "roots", "preconditioner", "PCG", "spectral bound", "factors"))
          + f", the dense K3 stack and the rest {rest:.3f} ms; PCG "
          f"{iters} iterations (tol 1e-5, at most 400), {busy:.3f} ms of "
          f"them on the device (profiled, {wall:.3f} ms wall under the "
          f"profiler): {(parts['PCG'] - busy) / max(iters, 1):.4f} ms an "
          f"iteration off the device (its residual read and launches); "
          f"host reads: {iters + 1} of PCG's residuals, "
          f"{probes['factorizations']} of factorizations; peak memory "
          f"{peak:.2f} GiB")
    if cache["kind"] != "lmc_iter" or not 0 < iters <= 400:
        raise SystemExit("chip_smoke: G3 did not take the lmc_iter route")
    del fn, args, kwargs, parts
    with torch.no_grad():
        post, post_ms = served(torch, ck, "G3 posterior", 1,
                               lambda: model.posterior(x_test, cache=cache),
                               totals)
    finite = bool(torch.isfinite(post.mean).all()
                  and torch.isfinite(post.variance).all()
                  and (post.variance > 0).all())
    print(f"  G3 posterior ({N_TEST} points): {post_ms:.3f} ms; finite and "
          f"positive: {finite}")
    if not finite:
        raise SystemExit("chip_smoke: G3's posterior is not finite")
    del model, cache, post
    torch.cuda.empty_cache()

    Xd, Yd = bench_data(G_DENSE_N, seed=14)
    dense = make_model(pl, Xd, Yd, dev)
    zero_counts(ck)
    _, info = pl.fit(dense, n_iter=4, lr=1e-2, scan_steps=1, device=dev)
    losses = info["losses"]
    print(f"  G3 fit with the default loss (the dense Woodbury MLL) at "
          f"n={G_DENSE_N} q={Q}: losses {np.round(losses, 6).tolist()} in "
          f"{info['train_time']:.2f} s; launches {read_counts(ck)}")
    if len(losses) != 4 or not np.all(np.isfinite(losses)) \
            or read_counts(ck) != expect(K3=4):
        raise SystemExit("chip_smoke: the dense Woodbury MLL did not take 4 "
                         "finite steps through K3")
    totals["K3"] += 4
    del dense

    for iterative in (False, True):
        lmc_posteriors_held(torch, pl, dev, F_CHECK_N, iterative,
                            f"G3 n={F_CHECK_N}")
    Xl, Yl = bench_data(G_LOO_N, seed=21)
    card = moved(torch, make_model(pl, Xl, Yl, dev), 22)
    cpu = carried(pl, card, torch.device("cpu"),
                  lambda w: make_model(pl, Xl, Yl, w))
    with torch.no_grad():
        g, c = card.compute_loo(), cpu.compute_loo()
    held(f"G3 n={G_LOO_N} LOO sigma2", g[0], c[0], scale_of(c[0]), 1e-3)
    held(f"G3 n={G_LOO_N} LOO residual", g[1], c[1], scale_of(c[1]), 1e-3)


def path_g_phase(torch, pl, ck, fm, dev, totals):
    """Path G: prediction (G1, G2, G3), each with its wall time."""
    for label, part in (("G1", path_g1), ("G2", path_g2), ("G3", path_g3)):
        t0 = time.perf_counter()
        part(torch, pl, ck, fm, dev, totals)
        print(f"  {label} took {time.perf_counter() - t0:.1f} s")


# path H: the exact ICM (``MultitaskGPModel(model_type="ICM")``). H1: the
# paper's synthetic default, built as the experiment driver builds ICM
# (projected_lmc_tpu/experiments/driver.py:78-84: a likelihood of rank
# q_noise_guess = 25, n_latents = 25, Matérn, zero mean), fit to the
# plateau; H2: the matrix-free route at n = 16,384 (path B's n), T = 7,
# q = 4, d = 4, trained as phase 4; H3: the dense route at its ceiling,
# n = ICM_DENSE_N_MAX = 8,192. Card against CPU at F_CHECK_N (the LOO at
# G_LOO_N).
N_H2, N_H3, H3_STEPS = 16_384, 8_192, 4
README_ICM_R2 = 0.921        # README.md: JAX ICM, fully converged (context)
H_RANGES = ("H K3", "H K3 backward (plain)", "H potrf", "H eigh",
            "H triangular solve", "H analytic backward", "H CG products",
            "H M^-1 apply", "H dK GEMM", "H K stream for dB")


def icm_model(pl, X, Y, device, fix_diagonal=True):
    lik = pl.MultitaskGaussianLikelihood(num_tasks=T, rank=0, device=device)
    return pl.MultitaskGPModel(X, Y, lik, n_tasks=T, n_latents=Q,
                               model_type="ICM", kernel_type="matern",
                               mean_type="zero", fix_diagonal=fix_diagonal,
                               device=device)


def driver_model(name, X, Y, device, q=F1_Q, **kwargs):
    """The model ``name`` as the port's experiment driver builds it
    (``experiments.driver.build_models`` with q latents and a rank-q task
    noise: H1's ICM and I1's var model at q = 25)."""
    from projected_lmc_tpu_torch.experiments.driver import build_models
    return build_models(X, Y, q, q, [name], device=device, **kwargs)[name]


def noise_matrix(lik):
    """The driver's estimated task-noise matrix
    (``experiments.driver._noise_matrix``)."""
    from projected_lmc_tpu_torch.experiments.driver import _noise_matrix
    return _noise_matrix(lik)


@contextlib.contextmanager
def icm_probes(torch):
    """From outside the package: count the ladder's factorizations, and
    label for the profiler K3's forward and plain backward, each
    factorization, every eigh, the ICM's triangular solves and analytic
    backward (dense route), and the CG products, M⁻¹ applies, dense dK GEMM
    and K stream for dB (matrix-free route)."""
    from torch.profiler import record_function
    from projected_lmc_tpu_torch import kernels as kern
    from projected_lmc_tpu_torch.ops import cholesky as chol
    from projected_lmc_tpu_torch.ops import iterative as it_ops
    from projected_lmc_tpu_torch.ops import kron
    counts = {"factorizations": 0}

    def labelled(label, fn, counted=False):
        def wrapped(*args, **kwargs):
            counts["factorizations"] += counted
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    nystrom_parts = it_ops._icm_nystrom_parts

    def labelled_parts(*args, **kwargs):
        R, P, gam, minv, logdet_M = nystrom_parts(*args, **kwargs)
        return R, P, gam, labelled("H M^-1 apply", minv), logdet_M

    skm, icb = kern._StationaryKernelMatrix, kron._IcmLogProbChol
    patches = (
        (chol, "_factor", labelled("H potrf", chol._factor, True)),
        (skm, "forward", staticmethod(labelled("H K3", skm.forward))),
        (skm, "backward", staticmethod(labelled("H K3 backward (plain)",
                                                skm.backward))),
        (torch.linalg, "eigh", labelled("H eigh", torch.linalg.eigh)),
        (kron, "solve_triangular", labelled("H triangular solve",
                                            kron.solve_triangular)),
        (icb, "backward", staticmethod(labelled("H analytic backward",
                                                icb.backward))),
        (it_ops, "icm_matvec", labelled("H CG products", it_ops.icm_matvec)),
        (it_ops, "_icm_nystrom_parts", labelled_parts),
        (it_ops, "_icm_pcg_dk", labelled("H dK GEMM", it_ops._icm_pcg_dk)),
        (it_ops, "_icm_pcg_dtasks", labelled("H K stream for dB",
                                             it_ops._icm_pcg_dtasks)))
    saved = [(owner, name, vars(owner)[name]) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        yield counts
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)


@contextlib.contextmanager
def icm_iter_probes(torch):
    """The parts of the "icm_iter" cache (:func:`cache_probes`); the
    preconditioner's own whitened parts are timed with it."""
    from projected_lmc_tpu_torch.ops import iterative as it_ops
    with cache_probes(torch, (
            (it_ops, "nystrom_roots_from_kernels", "roots"),
            (it_ops, "_icm_nystrom_parts", "preconditioner"),
            (it_ops, "batched_pcg", "PCG"),
            (it_ops, "icm_residual_spectral_bound", "spectral bound"),
            (it_ops, "icm_whitened_parts", "inflated parts")),
            (it_ops, "icm_matvec")) as parts:
        yield parts


def timed_fit(torch, pl, model, steps, loss=None, **kwargs):
    """``fit`` with ``loss`` (the default ``model.mll()``) for at most
    ``steps``, each step's host time taken around a synchronize: (info,
    step ms). One host read of the loss a step (``scan_steps=1``) unless
    asked otherwise, so that every step taken has its loss."""
    kwargs.setdefault("scan_steps", 1)
    stamps = []
    loss = loss or (lambda m: m.mll())

    def loss_fn(m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return loss(m)
    _, info = pl.fit(model, loss_fn, n_iter=steps, lr=1e-2,
                     device=model.device, **kwargs)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    return info, np.diff(stamps) * 1e3


def icm_step(model, **kwargs):
    def step():
        model.zero_grad(set_to_none=True)
        (-model.mll(**kwargs)).backward()
    return step


def icm_metrics(pl, torch, model, x_test, Yt, info, pred_s):
    """(the 15 metrics, mean, variance) of ``posterior(observed=True)``'s
    mean and ``compute_var`` on the test points, as the driver computes them
    for ICM (driver.py:172-177)."""
    with torch.no_grad():
        cache = model.precompute_posterior()
        mean = model.posterior(x_test, cache=cache, observed=True).mean
        var = model.compute_var(x_test)
    return pl.compute_metrics(Yt, mean, torch.sqrt(var), info["loss"],
                              noise_matrix(model.likelihood),
                              info["n_iter"], info["train_time"], pred_s,
                              print_metrics=False), mean, var


def path_h1(torch, pl, ck, dev, totals):
    """H1: the driver's ICM on the paper's synthetic default, ``fit`` for at
    most ``G2_MAX_ITER`` steps (to the plateau or the cap, which the line says)
    on the dense route; the "icm" cache, ``posterior`` and ``compute_var`` on
    the 2,500 test points and the metrics; the card against the CPU on the
    trained model."""
    from projected_lmc_tpu_torch.experiments import generate_synthetic
    data = generate_synthetic()
    X, Y, Xt, Yt = data["X"], data["Y"], data["X_test"], data["Y_test"]
    x_test = torch.as_tensor(Xt, device=dev)
    model = driver_model("ICM", X, Y, dev)
    zero_counts(ck)
    with icm_probes(torch) as probes:
        info, step_ms = timed_fit(
            torch, pl, model, G2_MAX_ITER,
            schedule=pl.lambda_lr_schedule(1e-2, 1e-3))
    steps = len(info["losses"])
    if read_counts(ck) != expect(K3=steps) or not np.all(
            np.isfinite(info["losses"])):
        raise SystemExit(f"chip_smoke: H1's fit launched {read_counts(ck)}, "
                         f"not K3 {steps} times, or lost finiteness")
    totals["K3"] += steps
    median = float(np.median(step_ms))
    factorizations = probes["factorizations"] / steps
    with icm_probes(torch):
        wall, busy, ranges, top = range_split(torch, icm_step(model), reps=3,
                                              names=H_RANGES)
    _, eigh_host, eigh_dev = ranges["H eigh"]
    print(f"  H1 driver ICM (n={X.shape[0]}, p={Y.shape[1]}, q={F1_Q}, "
          f"likelihood rank {F1_Q}): {steps} steps "
          f"({stop_note(steps, G2_MAX_ITER)}) in "
          f"{info['train_time']:.1f} s, loss first {info['losses'][0]:.6f} "
          f"last {info['loss']:.6f}; median step {median:.3f} ms; K3 once "
          f"and {factorizations:g} factorizations a step; profiled MLL "
          f"forward and backward {wall:.3f} ms (device busy {busy:.3f}): "
          f"eigh {eigh_host:.3f} ms of host time ({eigh_host / wall:.1%}), "
          f"its kernels {eigh_dev:.3f} ms; potrf {ranges['H potrf'][1]:.3f} "
          f"ms host, its kernels {ranges['H potrf'][2]:.3f} ms; kernels: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in top))
    with torch.no_grad():
        cache, cache_ms = served(torch, ck, "H1 precompute_posterior", 1,
                                 model.precompute_posterior, totals)
        post, first_ms = served(
            torch, ck, "H1 posterior", 1,
            lambda: model.posterior(x_test, cache=cache, observed=True),
            totals)
        post, post_ms = served(
            torch, ck, "H1 posterior", 1,
            lambda: model.posterior(x_test, cache=cache, observed=True),
            totals)
        var, var_ms = served(torch, ck, "H1 compute_var", 2,
                             lambda: model.compute_var(x_test), totals)
    if cache["kind"] != "icm":
        raise SystemExit("chip_smoke: H1's cache is not the dense 'icm' one")
    pred_s = (post_ms + var_ms) / 1e3
    got = pl.compute_metrics(Yt, post.mean, torch.sqrt(var), info["loss"],
                             noise_matrix(model.likelihood),
                             info["n_iter"], info["train_time"], pred_s,
                             print_metrics=False)
    print(f"  H1 served: icm cache {cache_ms:.3f} ms, posterior "
          f"({N_TEST} points) {post_ms:.3f} ms (the first {first_ms:.3f}), "
          f"compute_var {var_ms:.3f} "
          f"ms; R2 {got['R2']:.4f} (README, JAX ICM fully converged: "
          f"{README_ICM_R2}), RMSE {got['RMSE']:.4f}, PVA {got['PVA']:.4f}, "
          f"alpha_CI {got['alpha_CI']:.4f}")
    if not all(math.isfinite(v) for v in got.values()):
        raise SystemExit("chip_smoke: H1's metrics are not finite")
    # The trained model is ill-conditioned for fp32: Σt's smallest
    # eigenvalue sits near the likelihood's 1e-4 floor, so γ (the whitened
    # task covariance's eigenvalues) reaches ~1e5 and multiplies K's
    # eigenvalues below fp32's resolution. Two fp32 computations (cuSOLVER
    # and MKL, K3 and its plain version) need not agree there, so the card's
    # metrics are held against the CPU's in float64 on the same leaves: no
    # farther from them than the CPU's own fp32 metrics are, and within 1e-3
    # wherever those are.
    cpu = carried(pl, model, torch.device("cpu"),
                  lambda w: driver_model("ICM", X, Y, w))
    cpu64 = carried(pl, model, torch.device("cpu"), lambda w: driver_model(
        "ICM", X.astype(np.float64), Y.astype(np.float64), w))
    xt = torch.as_tensor(Xt)
    want, cm, cv = icm_metrics(pl, torch, cpu, xt, Yt, info, pred_s)
    want64, m64, v64 = icm_metrics(pl, torch, cpu64, xt.double(), Yt, info,
                                   pred_s)
    vscale = prior_var_max(torch, cpu64, xt.double())
    with torch.no_grad():
        fac = cpu64.precompute_posterior()["fac"]
        lam, gam = fac["lam"], fac["gam"]
        ev = torch.linalg.eigvalsh(cpu64.likelihood.task_covariance())
    below = int((lam.abs() < float(lam.max()) * 2.0 ** -23).sum())

    def gap(a, b, scale):
        return float((a.cpu().double() - b.double()).abs().max()) / scale

    def rel(a, b):
        return abs(a - b) / max(1.0, abs(b))
    mscale = scale_of(m64)
    print(f"  H1 trained model (fp64 on the CPU): Σt eigenvalues "
          f"{float(ev[0]):.3e} to {float(ev[-1]):.3e}, γ up to "
          f"{float(gam.max()):.3e}, {below} of K's {lam.numel()} eigenvalues "
          f"below its largest × 2^-23, S = λγ + 1 up to "
          f"{float(fac['S'].max()):.3e}; R2 {want64['R2']:.4f}")
    print(f"  H1 mean max|Δ|/max|fp64|: card against CPU fp32 "
          f"{gap(post.mean, cm, mscale):.2e}, CPU fp32 against fp64 "
          f"{gap(cm, m64, mscale):.2e}, card against fp64 "
          f"{gap(post.mean, m64, mscale):.2e}; compute_var max|Δ|/max prior "
          f"variance: card against CPU fp32 {gap(var, cv, vscale):.2e}, CPU "
          f"fp32 against fp64 {gap(cv, v64, vscale):.2e}, card against fp64 "
          f"{gap(var, v64, vscale):.2e}")
    keys = [k for k in want64 if k not in ("train_time", "pred_time")]
    card_cpu = max(rel(got[k], want[k]) for k in keys)
    print("  H1 metrics, max|Δ|/max(1, |fp64|) of card / CPU fp32 against "
          "the CPU's fp64: " + ", ".join(
              f"{k} {rel(got[k], want64[k]):.1e} / {rel(want[k], want64[k]):.1e}"
              for k in keys) + f"; card against CPU fp32 {card_cpu:.2e}")
    bad = [k for k in keys if not rel(got[k], want64[k])
           <= max(1e-3, rel(want[k], want64[k]))]
    if bad:
        raise SystemExit(f"chip_smoke: H1's metrics {bad} are farther from "
                         f"the fp64 ones than the CPU's fp32 metrics are")


def path_h2(torch, pl, ck, dev, totals):
    """H2: the matrix-free ICM at n = 16,384: K3 at the path's shapes, the
    step trained as phase 4 (2 chunks of 16) with the device split by
    labelled ranges, then the "icm_iter" cache timed by part, ``posterior``
    and ``compute_var`` on 2,500 held-out points."""
    X, Y = bench_data(N_H2, seed=0)
    model = icm_model(pl, X, Y, dev)
    x = model.train_x
    x_test = torch.as_tensor(bench_data(N_TEST, seed=20)[0], device=dev)
    ls = model.covar_module.lengthscale.detach()
    k3_at(torch, ck, dev, x, x, ls)
    with torch.no_grad():
        same = torch.equal(model.covar_module(x, out_dtype=torch.bfloat16),
                           model.covar_module(x).to(torch.bfloat16))
    print(f"  K3 (1,{N_H2},{N_H2}) with a bf16 output equal to its fp32 "
          f"result cast once: {same}")
    if not same:
        raise SystemExit("chip_smoke: K3's bf16 output is not its fp32 "
                         "result cast")
    k3_at(torch, ck, dev, x_test, x, ls)
    torch.cuda.empty_cache()
    res = train_run(torch, ck, model, icm_mll, CHUNKS, STEPS_PER_CHUNK)
    print(f"  H2 matrix-free ICM n={N_H2} T={T} q={Q} d={D}, {CHUNKS}x"
          f"{STEPS_PER_CHUNK} steps:")
    report(res, expect(K3=CHUNKS * STEPS_PER_CHUNK + 2 * CHUNKS), totals)
    with torch.no_grad():
        roots = model._precond_roots(x, MLL_KW["precond_rank"])
    gen = torch.Generator(device=dev).manual_seed(1)
    with icm_probes(torch):
        wall, busy, ranges, top = range_split(
            torch, icm_step(model, precond_roots=roots, generator=gen,
                            **MLL_KW), names=H_RANGES,
            kernel_names=("full_grid_kernel",))
    parts = ("H K3", "H CG products", "H M^-1 apply", "H dK GEMM",
             "H K stream for dB", "H K3 backward (plain)")
    split = {k: ranges[k][2] for k in parts}
    split["H K3"] += ranges["full_grid_kernel"][2]      # K3 and its cast
    print(f"  H2 profile, MLL forward and backward: wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms, by the kernels inside each labelled "
          f"range: " + ", ".join(
              f"{k[2:]} {split[k]:.3f}" for k in parts)
          + f", rest {busy - sum(split.values()):.3f} ms")
    print("  H2 kernels by device time: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in top))
    del roots
    torch.cuda.empty_cache()
    v0 = torch.as_tensor(np.random.default_rng(28).standard_normal((N_H2, 1)),
                         dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), icm_iter_probes(torch) as cparts:
        cache, cache_ms = served(
            torch, ck, "H2 precompute_posterior", 1,
            lambda: model.precompute_posterior(v0=v0), totals)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    iters = cparts["products"]
    fn, args, kwargs = cparts["pcg_call"]
    with torch.no_grad():
        pwall, pbusy, _, _ = range_split(torch, lambda: fn(*args, **kwargs),
                                         reps=1)
    keys = ("roots", "preconditioner", "PCG", "spectral bound",
            "inflated parts")
    rest = cache_ms - sum(cparts[k] for k in keys)
    print(f"  H2 precompute_posterior ({cache['kind']}): {cache_ms:.3f} ms = "
          + ", ".join(f"{k} {cparts[k]:.3f}" for k in keys)
          + f", K3's (n, n) matrix and the rest {rest:.3f} ms; PCG {iters} "
          f"iterations (tol 1e-5, at most 400), {pbusy:.3f} ms of them on "
          f"the device (profiled, {pwall:.3f} ms wall under the profiler): "
          f"{(cparts['PCG'] - pbusy) / max(iters, 1):.4f} ms an iteration "
          f"off the device; peak memory {peak:.2f} GiB")
    if cache["kind"] != "icm_iter" or not 0 < iters <= 400:
        raise SystemExit("chip_smoke: H2 did not take the icm_iter route")
    del fn, args, kwargs, cparts
    with torch.no_grad():
        post, post_ms = served(torch, ck, "H2 posterior", 1,
                               lambda: model.posterior(x_test, cache=cache),
                               totals)
        var, var_ms = served(torch, ck, "H2 compute_var", 2,
                             lambda: model.compute_var(x_test), totals)
    finite = bool(torch.isfinite(post.mean).all()
                  and torch.isfinite(post.variance).all()
                  and (post.variance > 0).all() and torch.isfinite(var).all()
                  and post.mean.shape == (N_TEST, T))
    print(f"  H2 posterior ({N_TEST} points) {post_ms:.3f} ms, compute_var "
          f"(its own cache) {var_ms:.3f} ms; finite and positive: {finite}")
    if not finite:
        raise SystemExit("chip_smoke: H2's posterior is not finite")


def path_h3(torch, pl, ck, dev, totals):
    """H3: the dense route at n = 8,192: 4 ``fit`` steps, the step's device
    time split (K3, potrf, the one-column batched triangular solve, the
    backward's n×n eigh, the backward's n³ products), one "icm" cache."""
    X, Y = bench_data(N_H3, seed=0)
    model = icm_model(pl, X, Y, dev)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(ck)
    with icm_probes(torch) as probes:
        info, step_ms = timed_fit(torch, pl, model, H3_STEPS)
    counts = read_counts(ck)
    if counts != expect(K3=H3_STEPS) or not np.all(
            np.isfinite(info["losses"])):
        raise SystemExit(f"chip_smoke: H3's fit launched {counts}, not K3 "
                         f"{H3_STEPS} times, or lost finiteness")
    totals["K3"] += H3_STEPS
    print(f"  H3 dense ICM n={N_H3} T={T}: losses "
          f"{np.round(info['losses'], 6).tolist()}; median step "
          f"{np.median(step_ms):.3f} ms; factorizations "
          f"{probes['factorizations'] / H3_STEPS:g} a step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    with icm_probes(torch):
        wall, busy, ranges, top = range_split(
            torch, icm_step(model), reps=1, names=H_RANGES,
            kernel_names=("full_grid_kernel",))
    dev_ms = {k: v[2] for k, v in ranges.items()}
    dev_ms["H K3"] += dev_ms["full_grid_kernel"]
    products = dev_ms["H analytic backward"] - dev_ms["H eigh"]
    print(f"  H3 profile, MLL forward and backward: wall {wall:.3f} ms, "
          f"device busy {busy:.3f} ms, by the kernels inside each labelled "
          f"range: K3 {dev_ms['H K3']:.3f}, potrf "
          f"{dev_ms['H potrf']:.3f}, triangular solves (the one-column "
          f"batched one) {dev_ms['H triangular solve']:.3f}, eigh (the "
          f"backward's {N_H3}x{N_H3}, and the {T}x{T} ones) "
          f"{dev_ms['H eigh']:.3f} ({ranges['H eigh'][1]:.3f} host), the "
          f"analytic backward {dev_ms['H analytic backward']:.3f} (less its "
          f"eigh: the n^3 products MK, MB and the rest, {products:.3f}), "
          f"K3's plain backward {dev_ms['H K3 backward (plain)']:.3f} ms")
    print("  H3 kernels by device time: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in top))
    with torch.no_grad():
        cache, cache_ms = served(torch, ck, "H3 precompute_posterior", 1,
                                 model.precompute_posterior, totals)
    print(f"  H3 icm cache (K3, an {N_H3}x{N_H3} eigh, the solve): "
          f"{cache_ms:.3f} ms; kind {cache['kind']}")
    if cache["kind"] != "icm":
        raise SystemExit("chip_smoke: H3's cache is not the dense 'icm' one")


def icm_mll_held(torch, pl, ck, dev):
    """The dense and the matrix-free MLL, value and gradients, on the card
    against the CPU (same leaves, moved off the init; same eps, xi and
    roots; CG to 1e-5). The task diagonal is trained here: with
    ``fix_diagonal`` the whitened B has a cluster of eigenvalues ~1e-5
    apart, whose fp32 eigenvectors (the probes' basis) no two LAPACKs
    share."""
    n = F_CHECK_N
    X, Y = bench_data(n, seed=23)
    make = lambda w: icm_model(pl, X, Y, w, fix_diagonal=False)  # noqa
    card = moved(torch, make(dev), 24)
    cpu = carried(pl, card, torch.device("cpu"), make)
    with torch.no_grad():
        roots = card._precond_roots(card.train_x, 256)
    gen = torch.Generator(device=dev).manual_seed(0)
    eps = torch.randn((8, n, T), generator=gen, device=dev)
    xi = torch.randn((8, 256, T), generator=gen, device=dev)
    names = [k for k, p in card.named_parameters() if p.requires_grad]
    for label, kw in (("dense", dict(iterative=False)),
                      ("matrix-free", dict(iterative=True, max_cg_iters=100,
                                           cg_tol=1e-5, precond_rank=256,
                                           num_probes=8))):
        out = {}
        for m in (card, cpu):
            w = m.device
            m.zero_grad(set_to_none=True)
            if kw["iterative"]:
                kw.update(precond_roots=roots.to(w), eps=eps.to(w),
                          xi=xi.to(w))
            zero_counts(ck)
            ll = m.mll(**kw)
            ll.backward()
            if w.type == "cuda" and read_counts(ck) != expect(K3=1):
                raise SystemExit(f"chip_smoke: the {label} ICM MLL launched "
                                 f"{read_counts(ck)}, not K3 once")
            params = dict(m.named_parameters())
            out["cuda" if m is card else "cpu"] = (float(ll.detach()),
                           [params[k].grad.cpu().double() for k in names])
        print(f"  H n={n} {label} MLL, card (K3) against CPU:")
        compare_grads(out, names)


def icm_posteriors_held(torch, pl, dev, n, label):
    """The ICM posteriors ("icm" and "icm_iter", same leaves and start
    vector) and ``compute_var`` on the card against the CPU: mean within
    1e-4 of its largest entry (1e-3 for "icm_iter"), variance within 1e-3
    of the largest prior variance."""
    X, Y = bench_data(n, seed=25)
    xs = torch.as_tensor(bench_data(G_CHECK_TEST, seed=26)[0])
    v0 = np.random.default_rng(27).standard_normal((n, 1))
    card = moved(torch, icm_model(pl, X, Y, dev), 29)
    cpu = carried(pl, card, torch.device("cpu"),
                  lambda w: icm_model(pl, X, Y, w))
    scale = prior_var_max(torch, cpu, xs)
    for iterative in (False, True):
        out = []
        for m in (card, cpu):
            with torch.no_grad():
                c = m.precompute_posterior(
                    iterative=iterative, v0=torch.as_tensor(
                        v0, dtype=torch.float32, device=m.device))
                p = m.posterior(xs.to(m.device), cache=c)
                out.append((p.mean, p.variance, c["kind"]))
        (g, c) = out
        held(f"{label} {c[2]} mean", g[0], c[0], scale_of(c[0]),
             1e-3 if iterative else 1e-4)
        held(f"{label} {c[2]} variance", g[1], c[1], scale, 1e-3)
    with torch.no_grad():
        g, c = card.compute_var(xs.to(dev)), cpu.compute_var(xs)
    held(f"{label} compute_var", g, c, scale, 1e-3)


def path_h_checks(torch, pl, ck, dev, totals):
    """The card against the CPU at n = 2048 (MLL both routes, posteriors,
    ``compute_var``) and the LOO at n = 512."""
    icm_mll_held(torch, pl, ck, dev)
    icm_posteriors_held(torch, pl, dev, F_CHECK_N, f"H n={F_CHECK_N}")
    Xl, Yl = bench_data(G_LOO_N, seed=30)
    card = moved(torch, icm_model(pl, Xl, Yl, dev), 31)
    cpu = carried(pl, card, torch.device("cpu"),
                  lambda w: icm_model(pl, Xl, Yl, w))
    with torch.no_grad():
        g, c = card.compute_loo(), cpu.compute_loo()
    held(f"H n={G_LOO_N} LOO sigma2", g[0], c[0], scale_of(c[0]), 1e-3)
    held(f"H n={G_LOO_N} LOO residual", g[1], c[1], scale_of(c[1]), 1e-3)


def icm_mll(model, roots, gen):
    return model.mll(precond_roots=roots, generator=gen, **MLL_KW)


def path_h_phase(torch, pl, ck, dev, totals):
    """Path H: the exact ICM (H1, H2, H3, the card against the CPU), each
    with its wall time."""
    t0 = time.perf_counter()
    for label, part in (("H1", path_h1), ("H2", path_h2), ("H3", path_h3),
                        ("H checks", path_h_checks)):
        t1 = time.perf_counter()
        part(torch, pl, ck, dev, totals)
        torch.cuda.empty_cache()
        print(f"  {label} took {time.perf_counter() - t1:.1f} s")
    print(f"  path H took {time.perf_counter() - t0:.1f} s")


# -- path I: variational LMC and SGPR -------------------------------------------

I_RANGES = ("I K3", "I K3 backward (plain)", "I potrf", "I triangular solve",
            "I cho_solve")
README_VAR_R2 = 0.909       # README.md: JAX var, fully converged (context)
I_D, I_M, I_STEPS = 21, 500, 16          # SARCOS's features, bench.py's m
I2_N, I2_FULL_N, I2_MB_STEPS, I2_BATCH = 4_449, 44_484, 64, 256
I3_N, I3_TEST = 44_480, 4_449
I_CHECK_M = 256


@contextlib.contextmanager
def sgpr_probes(torch):
    """From outside the package: count the ladder's factorizations, and
    label for the profiler K3's forward and plain backward, each
    factorization, the triangular solves and the ``cho_solve`` calls of the
    variational, SGPR and Woodbury code."""
    from torch.profiler import record_function
    from projected_lmc_tpu_torch import kernels as kern
    from projected_lmc_tpu_torch.models import exact, multitask, variational
    from projected_lmc_tpu_torch.ops import cholesky as chol
    from projected_lmc_tpu_torch.ops import woodbury
    counts = {"factorizations": 0}

    def labelled(label, fn, counted=False):
        def wrapped(*args, **kwargs):
            counts["factorizations"] += counted
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    skm = kern._StationaryKernelMatrix
    patches = [(chol, "_factor", labelled("I potrf", chol._factor, True)),
               (skm, "forward", staticmethod(labelled("I K3", skm.forward))),
               (skm, "backward", staticmethod(labelled(
                   "I K3 backward (plain)", skm.backward)))]
    for mod in (exact, multitask, variational, woodbury):
        patches.append((mod, "solve_triangular", labelled(
            "I triangular solve", mod.solve_triangular)))
        if hasattr(mod, "cho_solve"):
            patches.append((mod, "cho_solve", labelled("I cho_solve",
                                                       mod.cho_solve)))
    saved = [(owner, name, vars(owner)[name]) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        yield counts
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)


def loss_step(model, loss):
    def step():
        model.zero_grad(set_to_none=True)
        (-loss(model)).backward()
    return step


def split_line(label, wall, busy, ranges, top):
    """One line of a profiled step: wall and device-busy time, each labelled
    range's device time, the largest kernels."""
    parts = ", ".join(f"{k[2:]} {v[2]:.3f}" for k, v in ranges.items()
                      if math.isfinite(v[2]))
    print(f"  {label}: profiled step {wall:.3f} ms, device busy {busy:.3f} "
          f"ms ({busy / wall:.0%}); device ms by range: {parts}; kernels: "
          + ", ".join(f"{k} {v:.3f}" for k, v in top))


def sgpr_fit(torch, pl, ck, model, steps, label, totals, loss=None,
             factorizations=2, **kwargs):
    """``steps`` of ``fit`` on ``loss`` (the model's MLL): K3 twice a step
    (K(z, z) and K(x, z)) and no other kernel, at least ``factorizations``
    a step (more where the jitter ladder climbs), finite losses; the median
    step, then one step profiled by labelled ranges. Returns (info, median
    ms)."""
    loss = loss or (lambda m: m.mll())
    zero_counts(ck)
    with sgpr_probes(torch) as probes:
        info, step_ms = timed_fit(torch, pl, model, steps, loss=loss,
                                  **kwargs)
    n = len(info["losses"])
    if read_counts(ck) != expect(K3=2 * n) or not np.all(
            np.isfinite(info["losses"])):
        raise SystemExit(f"chip_smoke: {label}'s fit launched "
                         f"{read_counts(ck)}, not K3 {2 * n} times, or lost "
                         f"finiteness")
    if probes["factorizations"] < factorizations * n:
        raise SystemExit(f"chip_smoke: {label} factorized "
                         f"{probes['factorizations']} times in {n} steps, "
                         f"fewer than {factorizations} a step")
    totals["K3"] += 2 * n
    median = float(np.median(step_ms))
    print(f"  {label}: {n} steps in {info['train_time']:.2f} s, loss first "
          f"{info['losses'][0]:.6f} last {info['losses'][-1]:.6f}; median "
          f"step {median:.3f} ms (range {float(np.min(step_ms)):.3f}–"
          f"{float(np.max(step_ms)):.3f}); K3 twice and "
          f"{probes['factorizations'] / n:g} factorizations a step")
    with sgpr_probes(torch):
        split_line(label, *range_split(torch, loss_step(model, loss),
                                       reps=3, names=I_RANGES))
    return info, median


def var_metrics(pl, torch, model, x_test, Yt, info, pred_s):
    """The 15 metrics of ``model(x_test, observed=True)``, as the driver
    computes them for "var" (driver.py:185-188)."""
    with torch.no_grad():
        pred = model(x_test, observed=True)
    return pl.compute_metrics(Yt, pred.mean, pred.stddev, info["loss"],
                              noise_matrix(model.likelihood),
                              info["n_iter"], info["train_time"], pred_s,
                              print_metrics=False)


def k3_shapes(torch, ck, dev, pairs, ls):
    """K3 against its plain version and bitwise K6 at each (x1, x2)."""
    for x1, x2 in pairs:
        k3_at(torch, ck, dev, x1, x2, ls)


def path_i1(torch, pl, ck, dev, totals):
    """I1: the driver's "var" model on the paper's synthetic default (n = 500,
    p = 100, q = 25, d = 1, m = 333), ``fit`` on the ELBO for at most
    ``I1_MAX_ITER`` steps (a cap it reaches short of the plateau, so the
    metrics are those of the capped fit; the line says where it stopped);
    ``model(x_test, observed=True)`` on the 2,500 test points and the metrics;
    then ``sgpr_em()`` from the same initial model (the driver's
    ``var_fit="em"``) and its metrics. K3 at the path's shapes against its
    plain version."""
    from projected_lmc_tpu_torch.experiments import generate_synthetic
    data = generate_synthetic()
    X, Y, Xt, Yt = data["X"], data["Y"], data["X_test"], data["Y_test"]
    x_test = torch.as_tensor(Xt, device=dev)
    model = driver_model("var", X, Y, dev)
    z = model.inducing_points.detach()
    print(f"  I1 driver var: n={X.shape[0]}, p={Y.shape[1]}, q={F1_Q}, "
          f"m={z.shape[0]}, likelihood rank {F1_Q}")
    k3_shapes(torch, ck, dev, ((model.train_x, z), (z, z), (x_test, z)),
              model.covar_module.lengthscale.detach())
    info, _ = sgpr_fit(torch, pl, ck, model, I1_MAX_ITER, "I1 fit (ELBO)",
                       totals, loss=lambda m: m.elbo(),
                       schedule=pl.lambda_lr_schedule(1e-2, 1e-3))
    with torch.no_grad():
        _, first_ms = served(torch, ck, "I1 forward", 2,
                             lambda: model(x_test, observed=True), totals)
        _, pred_ms = served(torch, ck, "I1 forward", 2,
                            lambda: model(x_test, observed=True), totals)
    got = var_metrics(pl, torch, model, x_test, Yt, info, pred_ms / 1e3)
    print(f"  I1 served (the fit {stop_note(len(info['losses']), I1_MAX_ITER)}"
          f"): forward ({len(Xt)} points, observed) {pred_ms:.3f} "
          f"ms (the first {first_ms:.3f}); R2 {got['R2']:.4f} (README, JAX "
          f"var fully converged: {README_VAR_R2}), RMSE {got['RMSE']:.4f}, "
          f"PVA {got['PVA']:.4f}, alpha_CI {got['alpha_CI']:.4f}")
    em = driver_model("var", X, Y, dev)
    with torch.no_grad():
        _, em_ms = served(torch, ck, "I1 sgpr_em", 15, em.sgpr_em, totals)
        em_loss, _ = served(torch, ck, "I1 ELBO", 2,
                            lambda: float(-em.elbo()), totals)
    em_info = dict(n_iter=0, train_time=em_ms / 1e3, loss=em_loss)
    got_em = var_metrics(pl, torch, em, x_test, Yt, em_info, pred_ms / 1e3)
    print(f"  I1 sgpr_em (3 E- and M-steps, float64 on the card): "
          f"{em_ms:.3f} ms, -ELBO {em_loss:.6f}; R2 {got_em['R2']:.4f}, "
          f"RMSE {got_em['RMSE']:.4f}, PVA {got_em['PVA']:.4f}, alpha_CI "
          f"{got_em['alpha_CI']:.4f}")
    for name, g in (("fit", got), ("sgpr_em", got_em)):
        if not all(math.isfinite(v) for v in g.values()):
            raise SystemExit(f"chip_smoke: I1's {name} metrics are not "
                             f"finite")


def var_model(pl, X, Y, m, device, **kwargs):
    """``bench_var_elbo``'s variational model (bench.py:434): q = T, the SVD
    init, Matérn, m inducing points."""
    return pl.VariationalMultitaskGPModel(
        X, n_latents=Y.shape[1], n_tasks=Y.shape[1], train_y=Y,
        init_lmc_coeffs=True, kernel_type="matern",
        train_ind_ratio=X.shape[0] / m, seed=0, device=device, **kwargs)


def path_i2(torch, pl, ck, dev, totals):
    """I2: the SVGP ELBO at ``bench_var_elbo``'s shapes (n = 4,449, d = 21,
    T = q = 7, m = 500): 16 full-batch ELBO + AdamW(1e-2, weight decay
    1e-4) steps with peak memory and the device split; then 64
    ``fit_svgp_minibatch`` steps (batch 256) at SARCOS's full n = 44,484."""
    X, Y = bench_data(I2_N, seed=0, d=I_D)
    model = var_model(pl, X, Y, I_M, dev)
    if model.inducing_points.shape[0] != I_M:
        raise SystemExit("chip_smoke: I2's model has not 500 inducing points")
    torch.cuda.reset_peak_memory_stats()
    sgpr_fit(torch, pl, ck, model, I_STEPS, f"I2 ELBO n={I2_N} d={I_D} "
             f"q={T} m={I_M}", totals, loss=lambda m: m.elbo(),
             schedule=lambda i: 1e-2, weight_decay=1e-4)
    print(f"  I2 peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    del model
    torch.cuda.empty_cache()
    X, Y = bench_data(I2_FULL_N, seed=0, d=I_D)
    model = var_model(pl, X, Y, I_M, dev)
    zero_counts(ck)
    torch.cuda.synchronize()
    _, info = pl.fit_svgp_minibatch(model, batch_size=I2_BATCH,
                                    n_iter=I2_MB_STEPS, lr=1e-2,
                                    scan_steps=1, device=dev)
    torch.cuda.synchronize()
    n = len(info["losses"])
    if read_counts(ck) != expect(K3=2 * n) or not np.all(
            np.isfinite(info["losses"])):
        raise SystemExit(f"chip_smoke: I2's minibatch fit launched "
                         f"{read_counts(ck)}, not K3 {2 * n} times, or lost "
                         f"finiteness")
    totals["K3"] += 2 * n
    print(f"  I2 fit_svgp_minibatch n={I2_FULL_N} batch {I2_BATCH}: {n} "
          f"steps in {info['train_time']:.3f} s "
          f"({info['train_time'] * 1e3 / n:.3f} ms a step), loss first "
          f"{info['losses'][0]:.6f} last {info['losses'][-1]:.6f}")
    with sgpr_probes(torch):
        idx = torch.randint(I2_FULL_N, (I2_BATCH,), device=dev)
        split_line("I2 minibatch step", *range_split(
            torch, loss_step(model, lambda m: m.elbo(
                x=m.train_x[idx], y=m.train_y[idx], num_data=I2_FULL_N)),
            reps=3, names=I_RANGES))


def path_i3(torch, pl, ck, dev, totals):
    """I3: projected SGPR at ``bench_predict_p50``'s shapes (n = 44,480,
    d = 21, T = q = 7, m = 500; its BDN, scalar and diagonal B̃, the
    driver's PLMC_fast configuration): 16 ``fit`` steps
    on ``projected_lmc_mll`` split by labelled ranges, then the serving path
    of the SARCOS full-scale row: ``prediction_cache`` once, 8 warm
    ``predict`` calls on 4,449 points and a cold one. K3 at the path's
    shapes against its plain version."""
    rng = np.random.default_rng(1)
    X = rng.standard_normal((I3_N, I_D)).astype(np.float32)
    Y = rng.standard_normal((I3_N, T)).astype(np.float32)
    Xt = rng.standard_normal((I3_TEST, I_D)).astype(np.float32)
    x_test = torch.as_tensor(Xt, device=dev)
    model = pl.ProjectedGPModel(X, Y, T, T, init_lmc_coeffs=True,
                                kernel_type="matern", n_inducing_points=I_M,
                                device=dev, **PROJ_CONFIGS["PLMC_fast"])
    z = model.inducing_points.detach()
    k3_shapes(torch, ck, dev, ((model.train_x, z), (x_test, z)),
              model.covar_module.lengthscale.detach())
    torch.cuda.reset_peak_memory_stats()
    sgpr_fit(torch, pl, ck, model, I_STEPS, f"I3 projected SGPR n={I3_N} "
             f"d={I_D} q={T} m={I_M}", totals, loss=pl.projected_lmc_mll,
             schedule=pl.lambda_lr_schedule(1e-2, 1e-3))
    fit_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        cache, cache_ms = served(torch, ck, "I3 prediction_cache", 2,
                                 model.prediction_cache, totals)
        warm = []
        for _ in range(G_PREDICTS):
            (mean, var), ms = served(
                torch, ck, "I3 predict", 2,
                lambda: model.predict(x_test, observed=True, cache=cache),
                totals)
            warm.append(ms)
        _, cold_ms = served(torch, ck, "I3 cold predict", 4,
                            lambda: model.predict(x_test, observed=True),
                            totals)
        with sgpr_probes(torch):
            wall, busy, ranges, top = range_split(
                torch, lambda: model.prediction_cache(), reps=3,
                names=I_RANGES)
    if cache["kind"] != "sgpr" or not (torch.isfinite(mean).all()
                                       and (var > 0).all()):
        raise SystemExit("chip_smoke: I3's cache is not 'sgpr' or its "
                         "prediction is not finite and positive")
    print(f"  I3 served: prediction_cache {cache_ms:.3f} ms, predict "
          f"({I3_TEST} points) first {warm[0]:.3f} median "
          f"{float(np.median(warm)):.3f} ms (range {min(warm):.3f}–"
          f"{max(warm):.3f}), cold {cold_ms:.3f} ms; peak memory fit "
          f"{fit_peak:.2f} GiB, serving "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    split_line("I3 prediction_cache", wall, busy, ranges, top)


def sgpr_models(pl, X, Y, device, m):
    """Path I4's three SGPR models on the headline's data: LMC
    (``fix_diagonal``), ICM and ``ExactGPModel`` over the T tasks."""
    import torch
    dt = torch.float64 if X.dtype == np.float64 else torch.float32

    def lik():
        return pl.MultitaskGaussianLikelihood(num_tasks=T, rank=0, dtype=dt,
                                              device=device)
    kw = dict(n_tasks=T, n_latents=Q, kernel_type="matern", mean_type="zero",
              n_inducing_points=m, device=device)
    return {"LMC": pl.MultitaskGPModel(X, Y, lik(), model_type="LMC",
                                       fix_diagonal=True, **kw),
            "ICM": pl.MultitaskGPModel(X, Y, lik(), model_type="ICM", **kw),
            "exact": pl.ExactGPModel(
                X, Y, pl.GaussianLikelihood(batch_shape=T, dtype=dt,
                                            device=device),
                n_tasks=T, kernel_type="matern", mean_type="zero",
                n_inducing_points=m, device=device)}


# ladder calls of an SGPR MLL: L_zz and the capacitance (exact); L_zz, Σt
# twice (ICM: its B's factor too) and the capacitance (LMC, ICM)
SGPR_FACTORIZATIONS = {"LMC": 4, "ICM": 5, "exact": 2}


def sgpr_posterior(model, x, cache):
    """The posterior's mean and variance diagonal at x from ``cache``."""
    if hasattr(model, "icm"):
        return model.posterior(x, cache=cache, observed=True)
    return model.posterior(x, cache=cache, full_cov=False)


def path_i4(torch, pl, ck, dev, totals):
    """I4: the multitask and exact SGPR routes on the headline's data
    (n = 10⁴, T = 7, q = 4, d = 4, m = 500): 16 ``fit`` steps each, the
    "sgpr" cache and ``posterior`` on 2,500 points."""
    X, Y = bench_data(N, seed=0)
    x_test = torch.as_tensor(bench_data(N_TEST, seed=20)[0], device=dev)
    for name, model in sgpr_models(pl, X, Y, dev, I_M).items():
        sgpr_fit(torch, pl, ck, model, I_STEPS, f"I4 {name} SGPR n={N} "
                 f"m={I_M}", totals,
                 factorizations=SGPR_FACTORIZATIONS[name])
        with torch.no_grad():
            cache, cache_ms = served(torch, ck, f"I4 {name} cache", 2,
                                     model.precompute_posterior, totals)
            post, post_ms = served(
                torch, ck, f"I4 {name} posterior", 2,
                lambda: sgpr_posterior(model, x_test, cache), totals)
        if cache["kind"] != "sgpr" or not torch.isfinite(post.mean).all():
            raise SystemExit(f"chip_smoke: I4 {name}'s cache is not "
                             f"'sgpr' or its posterior is not finite")
        print(f"  I4 {name} served: sgpr cache {cache_ms:.3f} ms, posterior "
              f"({N_TEST} points) {post_ms:.3f} ms")


def moved_var(torch, model, seed):
    """Every trainable leaf moved by a seeded uniform(−0.3, 0.3), the
    variational factor's by ±0.05: at the standard init (m = 0, S at the
    prior) the ELBO is stationary in every interpolant-only parameter, so
    fp32 gradients there are rounding noise."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.requires_grad:
                w = 0.05 if name.startswith("var_chol") else 0.3
                p.add_(torch.as_tensor(rng.uniform(-w, w, tuple(p.shape)),
                                       dtype=p.dtype, device=p.device))
    return model


def grads_of(model, loss):
    """(value, [gradient of each trainable leaf]) on the host in float64."""
    model.zero_grad(set_to_none=True)
    v = loss(model)
    v.backward()
    return float(v.detach()), [p.grad.detach().cpu().double()
                               for p in model.parameters() if p.requires_grad]


def held_against_cpu(torch, pl, ck, label, make, loss, dev, k3):
    """``loss``'s value and gradients on the card (K3 ``k3`` times) against
    the CPU model carrying the card model's (moved) leaves; the CPU's fp32
    gradients against its fp64 ones printed beside. Returns the three
    models (card, CPU, CPU in float64)."""
    card = moved_var(torch, make(dev, np.float32), 41)
    names = [k for k, p in card.named_parameters() if p.requires_grad]
    zero_counts(ck)
    out = {"cuda": grads_of(card, loss)}
    if read_counts(ck) != expect(K3=k3):
        raise SystemExit(f"chip_smoke: {label} launched {read_counts(ck)}, "
                         f"not K3 {k3} times")
    cpu = carried(pl, card, torch.device("cpu"),
                  lambda w: make(w, np.float32))
    cpu64 = carried(pl, card, torch.device("cpu"),
                    lambda w: make(w, np.float64))
    out["cpu"] = grads_of(cpu, loss)
    v64, g64 = grads_of(cpu64, loss)
    print(f"  {label}: CPU fp32 against fp64, value rel "
          f"{abs(out['cpu'][0] - v64) / abs(v64):.1e}, max|Δ|/max|fp64| "
          + ", ".join(f"{k.split('.')[-1]} "
                      f"{float((a - b).abs().max() / b.abs().max()):.1e}"
                      for k, a, b in zip(names, out["cpu"][1], g64)))
    print(f"  {label}, card (K3) against CPU:")
    compare_grads(out, names)
    return card, cpu, cpu64


def held_to_fp64(name, card, cpu, cpu64, scale, tol):
    """The card against the CPU on the same leaves, max|Δ| / ``scale`` ≤
    ``tol``; or, where the CPU's own fp32 result is that unstable, the card
    no farther from the CPU's float64 result than twice the CPU's fp32 one
    is (two fp32 roundings of an ill-conditioned solve need not agree)."""
    def gap(a, b):
        return float((a.detach().cpu().double() - b.detach().cpu().double())
                     .abs().max()) / scale
    g, g64, c64 = gap(card, cpu), gap(card, cpu64), gap(cpu, cpu64)
    print(f"  {name}: max|Δ| / {scale:.4g}: card against CPU {g:.2e} "
          f"(tolerance {tol:.0e}), card against CPU fp64 {g64:.2e}, CPU "
          f"fp32 against fp64 {c64:.2e}")
    if not (math.isfinite(g) and (g <= tol or g64 <= 2 * c64)):
        raise SystemExit(f"chip_smoke: {name} disagrees between the card and "
                         f"the CPU")


def mean_var_held(label, card, cpu, cpu64, scale):
    """Mean within 1e-4 of its largest entry, variance within 1e-3 of the
    largest prior variance (:func:`held_to_fp64`)."""
    held_to_fp64(f"{label} mean", card[0], cpu[0], cpu64[0],
                 scale_of(cpu64[0]), 1e-4)
    held_to_fp64(f"{label} variance", card[1], cpu[1], cpu64[1], scale, 1e-3)


def task_prior_var_max(kss, W2, noise) -> float:
    """max over (x, t) of Σ_b kss_b(x) W2[b, t] + noise[t]."""
    return float((kss.T @ W2 + noise).max())


def e_step_inputs(torch, model):
    """The float64 inputs of ``sgpr_optimal_q`` and of the M-step, taken
    from ``model`` as its E- and M-steps take them."""
    f64 = torch.float64
    with torch.no_grad():
        H = model.lmc_coeffs.to(f64)
        z = model.inducing_points
        mean_l, var_l = model.compute_latent_distrib(model.train_x)
        return dict(
            Kzz=model.covar_module(z).to(f64),
            Kzx=model.covar_module(z, model.train_x).to(f64),
            Lzz=model._kernel_factors().to(f64),
            L_t=torch.linalg.pinv(H.T) @ model.train_y.to(f64).T,
            Y=model.train_y.to(f64), mean=mean_l.to(f64).T @ H, H=H,
            var_l=var_l.to(f64),
            noise=float(torch.diagonal(
                model.likelihood.task_covariance().to(f64)).mean()))


def em_algebra_held(torch, card):
    """The E- and M-steps' float64 algebra (``sgpr_optimal_q``,
    ``optimal_task_noise``, ``ppca_task_noise``) on the card against the
    CPU on the same float64 inputs, within 1e-8 of the largest entry (the
    fp32 kernel matrices they start from are held above)."""
    from projected_lmc_tpu_torch.models import variational as var_mod
    inp = e_step_inputs(torch, card)
    out = []
    for where in (card.device, torch.device("cpu")):
        a = {k: v.to(where) if torch.is_tensor(v) else v
             for k, v in inp.items()}
        with torch.no_grad():
            m_u, S_chol = var_mod.sgpr_optimal_q(
                a["Kzz"], a["Kzx"], a["Lzz"], a["L_t"], a["noise"], 1e-6,
                card.whitened)
            S = var_mod.optimal_task_noise(a["Y"], a["mean"], a["var_l"],
                                           a["H"])
            F, sigma2 = var_mod.ppca_task_noise(S, 3, 1e-4)
        out.append((m_u, S_chol @ S_chol.transpose(-1, -2), S, F @ F.T,
                    sigma2))
    (g, c) = out
    for name, a, b in zip(("E-step mean", "E-step S", "M-step target",
                           "M-step F Fᵀ"), g, c):
        held(f"I {name} (float64)", a, b, scale_of(b), 1e-8)
    if not abs(g[4] - c[4]) <= 1e-8 * abs(c[4]):
        raise SystemExit("chip_smoke: the M-step's σ² disagrees")


def path_i_checks(torch, pl, ck, dev, totals):
    """The card against the CPU at n = 2048, m = 256: the ELBO (whitened and
    unwhitened; Cholesky, mean-field and delta) and each SGPR MLL (exact,
    LMC, ICM, projected), value rel. ≤ 1e-4 and gradients ≤ 2e-3, the
    inducing points' included; the posteriors (mean 1e-4 of its largest
    entry, variance 1e-3 of the largest prior variance, or where the CPU's
    own fp32 result is that far from its fp64 one, held against the fp64
    one: :func:`held_to_fp64`); the E/M steps' float64 algebra within
    1e-8."""
    n = F_CHECK_N
    X, Y = bench_data(n, seed=40)
    xs = torch.as_tensor(bench_data(G_CHECK_TEST, seed=41)[0])
    for strat in ("whitened", "unwhitened"):
        for distrib in ("cholesky", "mean_field", "delta"):
            def make(w, dt, strat=strat, distrib=distrib):
                return var_model(pl, X.astype(dt), Y.astype(dt), I_CHECK_M,
                                 w, var_strat=strat, distrib=distrib)
            # unwhitened, the KL factors K(z, z) again: K3 three times
            card, cpu, cpu64 = held_against_cpu(
                torch, pl, ck, f"I n={n} m={I_CHECK_M} ELBO {strat} "
                f"{distrib}", make, lambda m: m.elbo(), dev,
                2 if strat == "whitened" else 3)
            with torch.no_grad():
                g, c, c64 = (m(x, observed=True) for m, x in (
                    (card, xs.to(dev)), (cpu, xs), (cpu64, xs.double())))
                scale = task_prior_var_max(
                    cpu64.covar_module(xs.double(), diag=True),
                    cpu64.lmc_coeffs ** 2,
                    torch.diagonal(cpu64.likelihood.task_covariance()))
            mean_var_held(f"I {strat} {distrib} forward",
                          *((p.mean, p.variance) for p in (g, c, c64)),
                          scale)
            if strat == "whitened" and distrib == "cholesky":
                em_algebra_held(torch, card)
    for name in ("exact", "LMC", "ICM"):
        def make(w, dt, name=name):
            return sgpr_models(pl, X.astype(dt), Y.astype(dt), w,
                               I_CHECK_M)[name]
        models = held_against_cpu(
            torch, pl, ck, f"I n={n} m={I_CHECK_M} {name} SGPR MLL", make,
            lambda m: m.mll(), dev, 2)
        with torch.no_grad():
            posts = [sgpr_posterior(m, x, m.precompute_posterior())
                     for m, x in zip(models, (xs.to(dev), xs, xs.double()))]
            cpu64 = models[2]
            if name == "exact":
                scale = float((cpu64.covar_module(xs.double(), diag=True)
                               + cpu64.likelihood.noise).max())
            else:
                scale = prior_var_max(torch, cpu64, xs.double())
        mean_var_held(f"I {name} sgpr posterior",
                      *((p.mean, p.variance) for p in posts), scale)

    def make(w, dt):
        return pl.ProjectedGPModel(
            X.astype(dt), Y.astype(dt), T, Q, init_lmc_coeffs=True,
            kernel_type="matern", n_inducing_points=I_CHECK_M, device=w,
            **PROJ_CONFIGS["PLMC"])
    models = held_against_cpu(
        torch, pl, ck, f"I n={n} m={I_CHECK_M} projected SGPR MLL", make,
        pl.projected_lmc_mll, dev, 2)
    with torch.no_grad():
        preds = [m.predict(x, cache=m.prediction_cache())
                 for m, x in zip(models, (xs.to(dev), xs, xs.double()))]
        scale = prior_var_max(torch, models[2], xs.double())
    mean_var_held("I projected sgpr predict", *preds, scale)


def path_i_phase(torch, pl, ck, dev, totals):
    """Path I: variational LMC and SGPR (I1, I2, I3, I4, the card against
    the CPU), each with its wall time."""
    t0 = time.perf_counter()
    for label, part in (("I1", path_i1), ("I2", path_i2), ("I3", path_i3),
                        ("I4", path_i4), ("I checks", path_i_checks)):
        t1 = time.perf_counter()
        part(torch, pl, ck, dev, totals)
        torch.cuda.empty_cache()
        print(f"  {label} took {time.perf_counter() - t1:.1f} s")
    print(f"  path I took {time.perf_counter() - t0:.1f} s")


# -- path J: the rest of the model surface -------------------------------------

J_RANGES = ("J K3", "J K3 backward (plain)", "J CG products",
            "J bf16 stack product", "J dense dK", "J Hutchinson backward",
            "J M^-1 apply", "J potrf", "J eigh", "J SLQ")
J_DECOMP = [[0, 1], [2, 3]]
J_STEPS = 8                              # J2's steps per setting
J_SLQ_KW = dict(quad_method="slq", precond_rank=256, matvec_bf16=True,
                max_cg_iters=16, cg_tol=2e-2, num_probes=8)
# J3's cap, short of its plateau: its checks are finite metrics
J3_DAYS, J3_SAMPLE_S, J3_EVERY, J3_MAX_ITER = 14, 300, 4, 500
J4_N, J5_N = 2500, 8192
README_TIDAL_R2 = (0.920, 0.923)        # README.md: real bramblemet (context)


@contextlib.contextmanager
def surface_probes(torch):
    """From outside the package: count each ``batched_pcg`` call's
    iterations (its products), and label for the profiler K3's forward and
    plain backward, the CG products, the bf16 stack products, the
    estimators' dense dK and their whole Hutchinson backward, the M⁻¹
    applies, each factorization, the tridiagonal eigh and the SLQ pass."""
    from torch.profiler import record_function
    from projected_lmc_tpu_torch import kernels as kern
    from projected_lmc_tpu_torch.ops import cholesky as chol
    from projected_lmc_tpu_torch.ops import iterative as it_ops
    counts = {"cg": []}

    def labelled(label, fn):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    parts = it_ops._nystrom_precond_parts

    def labelled_parts(*args, **kwargs):
        R, Lt, minv, logdet_M = parts(*args, **kwargs)
        return R, Lt, labelled("J M^-1 apply", minv), logdet_M

    pcg = it_ops.batched_pcg

    def counted_pcg(matvec, *args, **kwargs):
        counts["cg"].append(0)

        def mv(V):
            counts["cg"][-1] += 1
            return matvec(V)
        return pcg(mv, *args, **kwargs)

    skm = kern._StationaryKernelMatrix
    patches = (
        (skm, "forward", staticmethod(labelled("J K3", skm.forward))),
        (skm, "backward", staticmethod(labelled("J K3 backward (plain)",
                                                skm.backward))),
        (chol, "_factor", labelled("J potrf", chol._factor)),
        (it_ops, "lmc_matvec", labelled("J CG products", it_ops.lmc_matvec)),
        (it_ops, "_bf16_stack_bmm", labelled("J bf16 stack product",
                                             it_ops._bf16_stack_bmm)),
        (it_ops, "_lmc_dk", labelled("J dense dK", it_ops._lmc_dk)),
        (it_ops, "_lmc_hutchinson_bwd", labelled(
            "J Hutchinson backward", it_ops._lmc_hutchinson_bwd)),
        (it_ops, "_nystrom_precond_parts", labelled_parts),
        (it_ops, "_tridiag_quadrature", labelled(
            "J eigh", it_ops._tridiag_quadrature)),
        (it_ops, "slq_logdet", labelled("J SLQ", it_ops.slq_logdet)),
        (it_ops, "batched_pcg", counted_pcg))
    saved = [(owner, name, vars(owner)[name]) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        yield counts
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)


def surface_model(pl, X, Y, device, **kw):
    """Phase 4's LMC model (Matérn-2.5, ``fix_diagonal``, zero mean), with
    ``kw`` (J1: ``decomp``, two Scale-wrapped Matérn groups)."""
    lik = pl.MultitaskGaussianLikelihood(num_tasks=Y.shape[1], rank=0,
                                         device=device)
    return pl.MultitaskGPModel(X, Y, lik, n_tasks=Y.shape[1], n_latents=Q,
                               model_type="LMC", kernel_type="matern",
                               mean_type="zero", fix_diagonal=True,
                               device=device, **kw)


def ms_range(ms) -> str:
    ms = np.asarray(ms)
    return (f"median {np.median(ms):.3f} ms (range {ms.min():.3f}–"
            f"{ms.max():.3f})")


def device_split(label, torch, step):
    """One profiled step split by :data:`J_RANGES` (device time of the
    kernels inside each labelled range, ms; K3's own kernel, launched
    through the library's C interface, added to "J K3"), with wall and busy
    time."""
    with surface_probes(torch):
        wall, busy, ranges, top = range_split(
            torch, step, reps=1, names=J_RANGES,
            kernel_names=("full_grid_kernel",))
    dev_ms = {k: v[2] for k, v in ranges.items()}
    dev_ms["J K3"] += dev_ms.pop("full_grid_kernel")
    parts = ", ".join(f"{k[2:]} {v:.3f}" for k, v in dev_ms.items()
                      if math.isfinite(v) and k in J_RANGES)
    print(f"  {label}: profiled step {wall:.3f} ms, device busy {busy:.3f} "
          f"ms ({busy / wall:.0%}); device ms by labelled range: {parts}; "
          f"kernels: " + ", ".join(f"{k} {v:.3f}" for k, v in top))
    return dev_ms


def path_j1(torch, pl, ck, dev, totals, median_4=float("nan")):
    """J1: the composed route at the headline's full width (n = 10⁴, T = 7,
    q = 4, d = 4) with ``decomp=[[0, 1], [2, 3]]``: two Scale-wrapped
    Matérn-2.5 groups, each batched over the q latents. Phase 4's step
    (bf16 CG loop, rank-256 roots once per 16-step chunk), 2 × 16 steps;
    the device split; then the "lmc_iter" cache and ``posterior`` on 2,500
    points. K3 at the groups' shapes against its plain version."""
    X, Y = bench_data(N, seed=0)
    model = surface_model(pl, X, Y, dev, decomp=J_DECOMP)
    x = model.train_x
    idx = torch.as_tensor(np.linspace(0, N - 1, 256).astype(np.int32),
                          device=dev, dtype=torch.long)
    for k, g in zip(model.covar_module.kernels, J_DECOMP):
        ls, xg = k.base_kernel.lengthscale.detach(), x[:, g].contiguous()
        zg = xg[idx].contiguous()
        for a, b in ((xg, xg), (xg, zg), (zg, zg)):
            k3_at(torch, ck, dev, a, b, ls)
    res = train_run(torch, ck, model, lmc_mll, CHUNKS, STEPS_PER_CHUNK)
    steps = CHUNKS * STEPS_PER_CHUNK
    print(f"  J1 composed route n={N} T={T} q={Q} d={D}, "
          f"decomp={J_DECOMP}, {CHUNKS}x{STEPS_PER_CHUNK} steps (phase 4's "
          f"fused step on the same data: {median_4:.3f} ms):")
    # K3 twice a step (one stack per group), and four times a chunk for the
    # roots (K(z, z) and K(x, z) of each group); no other kernel
    report(res, expect(K3=2 * steps + 4 * CHUNKS), totals)
    print(f"  J1 step {ms_range(res['step_ms'])}, "
          f"{res['median_ms'] / median_4:.2f}x phase 4's fused step; "
          f"PCG iterations a step: {MLL_KW['max_cg_iters']} (fixed, masked)")
    with torch.no_grad():
        roots = model._precond_roots(x, 256)
    gen = torch.Generator(device=dev).manual_seed(1)
    device_split("J1 composed step", torch,
                 loss_step(model, lambda m: lmc_mll(m, roots, gen)))
    del roots, res
    torch.cuda.empty_cache()
    x_test = torch.as_tensor(bench_data(N_TEST, seed=20)[0], device=dev)
    v0 = torch.as_tensor(np.random.default_rng(19).standard_normal((N, T)),
                         dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), surface_probes(torch) as counts:
        cache, cache_ms = served(torch, ck, "J1 precompute_posterior", 6,
                                 lambda: model.precompute_posterior(v0=v0),
                                 totals)
        post, post_ms = served(torch, ck, "J1 posterior", 2,
                               lambda: model.posterior(x_test, cache=cache),
                               totals)
    finite = bool(torch.isfinite(post.mean).all()
                  and (post.variance > 0).all())
    print(f"  J1 lmc_iter cache {cache_ms:.3f} ms (PCG {counts['cg'][0]} "
          f"iterations to 1e-5), posterior ({N_TEST} points) {post_ms:.3f} "
          f"ms; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; finite and positive: {finite}")
    if cache["kind"] != "lmc_iter" or not finite:
        raise SystemExit("chip_smoke: J1's cache is not lmc_iter or its "
                         "posterior is not finite")


def path_j2(torch, pl, ck, dev, totals):
    """J2: the SLQ route, the LMC model's own default MLL above q·n = 4,096,
    on the headline's data with the plain Matérn-2.5 model: 8 ``fit`` steps
    of ``mll()`` at its defaults (Jacobi CG + SLQ, 10 Rademacher probes,
    20 Lanczos steps), then 8 of mll(quad_method="slq", precond_rank=256,
    matvec_bf16=True, max_cg_iters=16, cg_tol=2e-2, num_probes=8): median
    step, CG iterations, the tridiagonal eigh's share, peak memory. K3 at
    the stack's shape against its plain version."""
    X, Y = bench_data(N, seed=0)
    model = surface_model(pl, X, Y, dev)
    x = model.train_x
    k3_at(torch, ck, dev, x, x, model.covar_module.lengthscale.detach())
    for label, kw in (("defaults", {}), ("slq rank 256 bf16", J_SLQ_KW)):
        torch.cuda.reset_peak_memory_stats()
        zero_counts(ck)
        with surface_probes(torch) as counts:
            info, step_ms = timed_fit(torch, pl, model, J_STEPS,
                                      loss=lambda m: m.mll(**kw),
                                      scan_steps=1)
        n = len(info["losses"])
        if read_counts(ck) != expect(K3=n) or not np.all(
                np.isfinite(info["losses"])):
            raise SystemExit(f"chip_smoke: J2 {label} launched "
                             f"{read_counts(ck)}, not K3 {n} times, or lost "
                             f"finiteness")
        totals["K3"] += n
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        dev_ms = device_split(f"J2 {label}", torch,
                              loss_step(model, lambda m: m.mll(**kw)))
        cg = counts["cg"]
        print(f"  J2 {label}: {n} steps, loss first {info['losses'][0]:.6f} "
              f"last {info['losses'][-1]:.6f}; step {ms_range(step_ms)}; CG "
              f"iterations a step {cg} (at most "
              f"{kw.get('max_cg_iters', 256)}); eigh {dev_ms['J eigh']:.3f} "
              f"ms of the SLQ pass's {dev_ms['J SLQ']:.3f} ms on the device "
              f"({dev_ms['J eigh'] / max(dev_ms['J SLQ'], 1e-9):.1%}); peak "
              f"memory {peak:.2f} GiB")


def tidal_series(seed=0):
    """A tidal-shaped series made from a seed, cut as ``load_tidal`` cuts the
    bramblemet data (realdata.py:24-73): 14 days of 5-minute samples from
    2020-06-01, time normalized as the loader does; 4 stations, each an M2
    (12.42 h) plus an S2 (12.00 h) tide of its own amplitude and phase on a
    slow quadratic trend, detrended by a degree-2 fit and with N(0, 0.05²)
    noise; every 4th sample (n = 1,008); the middle day held out (936
    training points, 72 test points); float32."""
    rng = np.random.default_rng(seed)
    t = 1_590_969_600.0 + J3_SAMPLE_S * np.arange(J3_DAYS * 86_400
                                                 // J3_SAMPLE_S)
    tn = t / t.max()
    tn = tn - tn[0]
    hours = (t - t[0]) / 3600.0
    cols = [tn]
    for _ in range(4):
        a, b = rng.uniform(0.8, 1.6), rng.uniform(0.2, 0.6)
        y = (a * np.cos(2 * np.pi * hours / 12.42 + rng.uniform(0, 2 * np.pi))
             + b * np.cos(2 * np.pi * hours / 12.0
                          + rng.uniform(0, 2 * np.pi))
             + np.polyval(rng.standard_normal(3), hours / hours.max()))
        y = y - np.polyval(np.polyfit(tn, y, 2), tn)
        cols.append(y + 0.05 * rng.standard_normal(len(t)))
    frame = np.stack(cols, 1).astype(np.float32)[::J3_EVERY]
    n = len(frame)
    test = np.arange(n // 2, n // 2 + n // J3_DAYS)
    X, Y = frame[:, :1], frame[:, 1:]
    return (np.delete(X, test, 0), np.delete(Y, test, 0), X[test], Y[test])


def tidal_models(pl, X, Y, device):
    """The port's experiment driver's tidal ICM (likelihood rank 4) and
    PLMC (``build_models``: q = 4, zero mean, a 5-mixture spectral mixture
    kernel initialized by ``initialize_from_data_empspect``)."""
    from projected_lmc_tpu_torch.experiments.driver import build_models
    p = Y.shape[1]
    return build_models(X, Y, p, p, ["ICM", "PLMC"],
                        kernel_type="spectral_mixture",
                        ker_kwargs={"num_mixtures": 5}, device=device)


def tidal_predict(torch, name, model, x):
    """(mean, variance) on the held-out day, observed, as the driver
    predicts each model."""
    with torch.no_grad():
        if name == "ICM":
            mean = model.posterior(x, observed=True).mean
            return mean, model.compute_var(x)
        return model.predict(x, observed=True)


def path_j3(torch, pl, ck, dev, totals):
    """J3: the tidal configuration (spectral mixture, no K3): the ICM and
    PLMC, each ``fit`` for at most ``J3_MAX_ITER`` steps at the loader's
    loss_thresh 1e-7 (a cap they reach short of the plateau, so the metrics
    are those of the capped fits; the line says where each stopped), median
    step, and R², RMSE, PVA and α_CI on
    the held-out day."""
    X, Y, Xt, Yt = tidal_series()
    x_test = torch.as_tensor(Xt, device=dev)
    models = tidal_models(pl, X, Y, dev)
    mu = models["ICM"].covar_module.mixture_means.detach()
    print(f"  J3 tidal-shaped series: n={len(X)} training, {len(Xt)} test "
          f"points, T={Y.shape[1]}, d=1; initial frequencies (cycles per "
          f"unit of normalized time) {np.round(mu.flatten().cpu().numpy(), 1)}")
    for name, model in models.items():
        loss = pl.projected_lmc_mll if name == "PLMC" else (lambda m: m.mll())
        zero_counts(ck)
        info, step_ms = timed_fit(torch, pl, model, J3_MAX_ITER, loss=loss,
                                  loss_thresh=1e-7, scan_steps=16)
        if read_counts(ck) != expect() or not np.all(
                np.isfinite(info["losses"])):
            raise SystemExit(f"chip_smoke: J3 {name} launched "
                             f"{read_counts(ck)} or lost finiteness")
        (mean, var), pred_ms = timed(
            torch, lambda: tidal_predict(torch, name, model, x_test))
        noise = noise_matrix(model.likelihood) if name == "ICM" else \
            model.full_likelihood().task_noise_covar_factor.detach()
        got = pl.compute_metrics(Yt, mean, torch.sqrt(var), info["loss"],
                                 noise, info["n_iter"], info["train_time"],
                                 pred_ms / 1e3, print_metrics=False)
        print(f"  J3 {name}: {len(info['losses'])} steps (n_iter "
              f"{info['n_iter']}, {stop_note(info['n_iter'], J3_MAX_ITER)}) "
              f"in {info['train_time']:.2f} s, step {ms_range(step_ms)}; R2 "
              f"{got['R2']:.4f} (README, real bramblemet data, JAX: "
              f"{README_TIDAL_R2}, context only), RMSE "
              f"{got['RMSE']:.4f}, PVA {got['PVA']:.4f}, alpha_CI "
              f"{got['alpha_CI']:.4f}")
        if not all(math.isfinite(v) for v in got.values()):
            raise SystemExit(f"chip_smoke: J3 {name}'s metrics are not "
                             f"finite")


def exact_surface(pl, X, Y, device, mean_type="constant",
                  kernel_type="matern"):
    """J4's ``ExactGPModel`` over T tasks (outputscales)."""
    import torch
    dt = torch.float64 if X.dtype == np.float64 else torch.float32
    return pl.ExactGPModel(
        X, Y, pl.GaussianLikelihood(batch_shape=Y.shape[1], dtype=dt,
                                    device=device),
        n_tasks=Y.shape[1], kernel_type=kernel_type, mean_type=mean_type,
        outputscales=True, seed=0, device=device)


J4_MODELS = {"linear": dict(mean_type="linear"),
             "polynomial": dict(mean_type="polynomial"),
             "spline": dict(kernel_type="spline")}


def j4_data(n, seed):
    """Phase 4's features (the spline kernel's on [0, 1], its domain)."""
    X, Y = bench_data(n, seed=seed)
    return X, Y, (1.0 / (1.0 + np.exp(-X))).astype(X.dtype)


def path_j4(torch, pl, ck, dev, totals):
    """J4: the surface on ``ExactGPModel`` (n = 2,500, T = 7, d = 4): a
    linear and a polynomial mean (K3), a spline kernel (no K3); 16 ``fit``
    steps each with ``exponential_schedule``, ``scan_steps=16``,
    ``checkpoint_every=8``, ``eval_every=8``; ``compute_loo(complex_mean=
    True)`` (the polynomial mean has no basis and raises, as in JAX); the
    spline model's ``posterior``; each checkpoint loaded with
    ``load_model``, its MLL equal bit for bit to the trained model's."""
    import tempfile
    X, Y, Xs = j4_data(J4_N, 0)
    x_test = torch.as_tensor(bench_data(N_TEST, seed=20)[0], device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        for name, kw in J4_MODELS.items():
            Xm = Xs if name == "spline" else X
            model = exact_surface(pl, Xm, Y, dev, **kw)
            k3 = 0 if name == "spline" else 1
            path = os.path.join(tmp, f"{name}.npz")
            zero_counts(ck)
            info, step_ms = timed_fit(
                torch, pl, model, 16, loss=lambda m: m.mll(),
                schedule=pl.exponential_schedule(1e-2, 1e-3, 16),
                scan_steps=16, checkpoint_every=8, checkpoint_path=path,
                eval_every=8,
                eval_fn=lambda m, i: float(m.mll().detach()))
            evals = info.get("evals", [])
            want = expect(K3=k3 * (16 + len(evals)))
            if read_counts(ck) != want or len(info["losses"]) != 16 \
                    or not np.all(np.isfinite(info["losses"])):
                raise SystemExit(f"chip_smoke: J4 {name}'s fit launched "
                                 f"{read_counts(ck)}, not {want}, or did not "
                                 f"take 16 finite steps")
            totals["K3"] += want["K3"]
            back = pl.load_model(exact_surface(pl, Xm, Y, dev, **kw), path)
            with torch.no_grad():
                (a, b), _ = served(torch, ck, f"J4 {name} load_model MLL",
                                   2 * k3, lambda: (model.mll(), back.mll()),
                                   totals)
            print(f"  J4 {name}: 16 steps in one chunk, loss first "
                  f"{info['losses'][0]:.6f} last {info['losses'][-1]:.6f}, "
                  f"step {ms_range(step_ms)}; evals "
                  f"{[(i, round(v, 6)) for i, v in evals]}; load_model's "
                  f"MLL equal bit for bit: {bool(torch.equal(a, b))}")
            if not torch.equal(a, b) or [i for i, _ in evals] != [16]:
                raise SystemExit(f"chip_smoke: J4 {name}'s checkpoint or "
                                 f"evals are not the trained model's")
            with torch.no_grad():
                if name == "linear":
                    (s2, r), ms = served(
                        torch, ck, "J4 complex-mean LOO", 1,
                        lambda: model.compute_loo(complex_mean=True), totals)
                    print(f"  J4 linear compute_loo(complex_mean=True): "
                          f"{ms:.3f} ms, finite "
                          f"{bool(torch.isfinite(s2).all() and (s2 > 0).all())}")
                elif name == "polynomial":
                    try:
                        model.compute_loo(complex_mean=True)
                        raise SystemExit("chip_smoke: the polynomial mean's "
                                         "complex-mean LOO did not raise")
                    except ValueError:
                        pass
                    (s2, r), ms = served(torch, ck, "J4 LOO", 1,
                                         model.compute_loo, totals)
                    print(f"  J4 polynomial: compute_loo(complex_mean=True) "
                          f"raises ValueError (no basis matrix, as in JAX); "
                          f"compute_loo() {ms:.3f} ms")
                else:
                    xs = torch.sigmoid(x_test)
                    post, ms = served(
                        torch, ck, "J4 spline posterior", 0,
                        lambda: model.posterior(xs, full_cov=False), totals)
                    print(f"  J4 spline posterior ({N_TEST} points): "
                          f"{ms:.3f} ms, finite "
                          f"{bool(torch.isfinite(post.mean).all())}")


def path_j5(torch, pl, ck, dev, totals):
    """J5: the blocked Cholesky at H3's shape (n = 8,192, T = 7):
    ``icm_log_prob_chol(chol_bf16=True)`` and its backward against the
    default potrf route (the MLL within 1e-4 rel; gradient gaps and times
    in turns), the
    factor alone, and ``cholesky_blocked_f32`` against
    ``torch.linalg.cholesky`` on the same (7, 8192, 8192)."""
    from projected_lmc_tpu_torch.ops import blocked_cholesky as blk
    from projected_lmc_tpu_torch.ops import kron
    X, Y = bench_data(J5_N, seed=0)
    model = icm_model(pl, X, Y, dev)
    with torch.no_grad():
        K = served(torch, ck, "J5 K3", 1,
                   lambda: model.covar_module(model.train_x)[0], totals)[0]
        B = model.task_covar_matrix()
        St = model.likelihood.task_covariance()
    args = [a.detach().contiguous() for a in (K, B, St, model.train_y.T)]

    def run(bf16):
        leaves = [a.clone().requires_grad_(True) for a in args]
        ll = kron.icm_log_prob_chol(*leaves, chol_bf16=bf16)
        ll.backward()
        return float(ll.detach()), [a.grad for a in leaves]

    times = {False: [], True: []}
    out = {}
    for bf16 in (False, True, True, False):
        out[bf16], ms = timed(torch, lambda: run(bf16))
        times[bf16].append(ms)
    (v0, g0), (v1, g1) = out[False], out[True]
    gaps = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g1, g0)]
    print(f"  J5 icm_log_prob_chol n={J5_N} T={T}, forward and backward: "
          f"potrf route {times[False]} ms, chol_bf16 {times[True]} ms; MLL "
          f"{v0:.6f} vs {v1:.6f} (rel {abs(v1 - v0) / abs(v0):.2e}); "
          f"gradient gaps (K, B, St, Y) "
          + ", ".join(f"{g:.1e}" for g in gaps))
    # the sound reading is 2.0e-6; a clearly wrong factor moves the logdet
    if not (math.isfinite(v1) and abs(v1 - v0) <= 1e-4 * abs(v0)):
        raise SystemExit("chip_smoke: J5's chol_bf16 MLL is off the fp32 "
                         "route's")
    del out, g0, g1
    with torch.no_grad():
        Rt, gam, _ = kron._whitened_task_eig(B, St)
        eye = torch.eye(J5_N, device=dev)
        A = gam[:, None, None] * (K + 1e-8 * eye)[None] + eye[None]
        del eye
        ft = {}
        for name, fn in (("potrf", torch.linalg.cholesky),
                         ("blocked bf16", blk.cholesky_bf16_blocked),
                         ("blocked fp32", blk.cholesky_blocked_f32),
                         ("potrf again", torch.linalg.cholesky)):
            torch.cuda.synchronize()
            L, ft[name] = timed(torch, lambda: fn(A))
            if name == "potrf":
                L0 = L
            elif name == "blocked fp32":
                err = float((L - L0).abs().max() / L0.abs().max())
            elif name == "blocked bf16":
                # over the batch: tasks of γ ≈ 0 have no off-diagonal energy
                off = float(torch.linalg.vector_norm(L @ L.transpose(-1, -2)
                                                     - A)
                            / torch.linalg.vector_norm(torch.tril(A, -1))
                            / math.sqrt(2))
            del L
    print(f"  J5 factor alone ({T}, {J5_N}, {J5_N}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ft.items())
          + f"; cholesky_blocked_f32 against torch.linalg.cholesky max|ΔL|/"
          f"max|L| {err:.2e}; blocked bf16 ‖LLᵀ − A‖_F / A's off-diagonal "
          f"energy {off:.2e} (the stated noise level: about 4e-3)")
    if not (err <= 1e-3 and off <= 1e-2):
        raise SystemExit("chip_smoke: J5's blocked factors are off "
                         "torch.linalg.cholesky's or their noise level")


def held_or_fp64(name, card, cpu, cpu64, scale, tol):
    """:func:`held_to_fp64` for a scalar or a tensor."""
    t = lambda v: v if hasattr(v, "detach") else np.float64(v)  # noqa: E731
    import torch
    held_to_fp64(name, *(torch.as_tensor(t(v)) for v in (card, cpu, cpu64)),
                 scale, tol)


def mll_held(torch, pl, ck, label, make, loss, dev, k3, grad_tol=2e-3):
    """``loss``'s value and gradients on the card (K3 ``k3`` times) against
    the CPU model carrying the card model's (moved) leaves, value rel
    ≤ 1e-4 and each gradient ≤ ``grad_tol`` of its largest entry; where the
    CPU's own fp32 result is that far from its fp64 one, the card no
    farther from the fp64 result than twice the CPU's fp32 one is
    (:func:`held_to_fp64`). Returns the three models."""
    card = moved(torch, make(dev, np.float32), 43)
    names = [k for k, p in card.named_parameters() if p.requires_grad]
    zero_counts(ck)
    vg, gg = grads_of(card, loss)
    if read_counts(ck) != expect(K3=k3):
        raise SystemExit(f"chip_smoke: {label} launched {read_counts(ck)}, "
                         f"not K3 {k3} times")
    cpu = carried(pl, card, torch.device("cpu"), lambda w: make(w, np.float32))
    cpu64 = carried(pl, card, torch.device("cpu"),
                    lambda w: make(w, np.float64))
    vc, gc = grads_of(cpu, loss)
    v64, g64 = grads_of(cpu64, loss)
    print(f"  {label}, card against CPU:")
    held_or_fp64(f"{label} value", vg, vc, v64, abs(v64), 1e-4)
    for k, a, b, c in zip(names, gg, gc, g64):
        if c.numel():
            held_or_fp64(f"{label} grad {k}", a, b, c, float(c.abs().max()),
                         grad_tol)
    return card, cpu, cpu64


@contextlib.contextmanager
def composed_spied(torch, replay=None):
    """From outside the package, wrap the composed route's estimator
    (``ops.iterative.lmc_pcg_log_prob``, which the model calls through its
    module) for the calls made inside. Without ``replay`` it runs as it is
    and records the tensors its backward saved (stack, H, α, W, z̃), the
    cotangent ``g`` it was handed and the cotangents it returned for
    (stack, H, Σt, Y). With ``replay`` (those four cotangents) it computes
    nothing and returns them, so the model's gradient is its VJP of
    exactly these through the rest of the route."""
    from projected_lmc_tpu_torch.ops import iterative as it_ops
    orig = it_ops.lmc_pcg_log_prob
    rec = {}

    class Replay(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *xs):
            ctx.like = [(x.device, x.dtype) for x in xs]
            return torch.zeros((), dtype=xs[1].dtype, device=xs[1].device)

        @staticmethod
        def backward(ctx, g):
            return tuple(c.to(*like) if c is not None and need else None
                         for c, like, need in zip(replay, ctx.like,
                                                  ctx.needs_input_grad))

    def spy(Ks, H, St, Ydelta, *rest, **kwargs):
        if replay is not None:
            return Replay.apply(Ks, H, St, Ydelta)
        ll = orig(Ks, H, St, Ydelta, *rest, **kwargs)
        rec["saved"] = ll.grad_fn.saved_tensors

        def hook(grad_inputs, grad_outputs):
            rec["cots"] = [None if c is None else c.detach()
                           for c in grad_inputs[:4]]
            rec["g"] = grad_outputs[0].detach()
        ll.grad_fn.register_hook(hook)
        return ll

    it_ops.lmc_pcg_log_prob = spy
    try:
        yield rec
    finally:
        it_ops.lmc_pcg_log_prob = orig


def composed_held(torch, pl, ck, label, make, loss, dev, k3, tol):
    """The composed route's MLL (a bf16 or int8 CG loop) on the card (K3
    ``k3`` times) against the CPU, held stage by stage on the same inputs.

    End to end the two sides' gradients cannot meet ``tol``: the dense dK
    is rounded to bf16 (JAX's dtype), which turns last-bit fp32 differences
    into whole bf16 steps on a few entries of each n² sum, and the estimator
    cancels most of what it sums; so the CPU's own fp32 gradients miss its
    fp64 twin's by 0.5–3e-2 of their largest entry (the int8 loop's, which
    re-quantize the CG directions, by as much). Those gaps are printed, and
    what is held is:

    * the value, card against the CPU model carrying the card's leaves,
      rel ≤ 1e-4;
    * the estimator's backward on the tensors the card's run saved (stack,
      H, α, W, z̃ and its cotangent g): the card's dH, dΣt, dY within
      ``tol`` of their largest entry of the CPU's; dK within ``tol``, or
      within one bf16 step at its largest entry (2⁻⁷) for a bf16 stack,
      the two roundings of one fp32 value being at most a step apart;
    * the rest of the route (the covariance module's backward — K3's plain
      backward per group — the mixing, the noise and the priors) on the
      card's cotangents: the card's model gradients within ``tol`` of
      their largest entry of the CPU model's, whose estimator hands back
      the card's four cotangents (:func:`composed_spied`).

    Each run also reads a 3% fault planted in the card's dK through both
    checks, and fails unless both see it. Returns the card, CPU and CPU float64 models."""
    from projected_lmc_tpu_torch.ops import iterative as it_ops
    card = moved(torch, make(dev, np.float32), 43)
    names = [k for k, p in card.named_parameters() if p.requires_grad]
    zero_counts(ck)
    with composed_spied(torch) as rec:
        vg, gg = grads_of(card, loss)
    if read_counts(ck) != expect(K3=k3):
        raise SystemExit(f"chip_smoke: {label} launched {read_counts(ck)}, "
                         f"not K3 {k3} times")
    cpu = carried(pl, card, torch.device("cpu"), lambda w: make(w, np.float32))
    cpu64 = carried(pl, card, torch.device("cpu"),
                    lambda w: make(w, np.float64))
    vc, gc = grads_of(cpu, loss)
    print(f"  {label}, card against CPU:")
    held(f"{label} value", torch.as_tensor(vg), torch.as_tensor(vc),
         abs(vc), 1e-4)
    print(f"  {label} gradients end to end, max|Δ| / largest entry (printed, "
          f"not held): "
          + ", ".join(f"{k} {float((a - b).abs().max()) / scale_of(b):.1e}"
                      for k, a, b in zip(names, gg, gc) if b.numel()))
    saved = [t.detach().cpu() for t in rec["saved"]]
    with torch.no_grad():
        want = it_ops._lmc_hutchinson_bwd(*saved, rec["g"].cpu())
    for what, a, b in zip(("dK", "dH", "dSt", "dY"), rec["cots"], want):
        lim = max(tol, 2.0 ** -7) if b.dtype == torch.bfloat16 else tol
        held(f"{label} estimator backward {what} ({b.dtype})", a.cpu(), b,
             scale_of(b.float()), lim)
    replayed = carried(pl, card, torch.device("cpu"),
                       lambda w: make(w, np.float32))
    with composed_spied(torch, replay=rec["cots"]):
        _, gr = grads_of(replayed, loss)
    for k, a, b in zip(names, gg, gr):
        if b.numel():
            held(f"{label} grad {k} on the card's cotangents", a, b,
                 scale_of(b), tol)
    # the checks' power: a 3% fault planted in the card's dK
    dK = rec["cots"][0].cpu() * 1.03
    p1 = float((dK.float() - want[0].float()).abs().max()) \
        / scale_of(want[0].float())
    with composed_spied(torch, replay=[dK] + rec["cots"][1:]):
        _, gp = grads_of(replayed, loss)
    p2 = max(float((a - b).abs().max()) / scale_of(b)
             for a, b in zip(gg, gp) if b.numel())
    lim = max(tol, 2.0 ** -7) if dK.dtype == torch.bfloat16 else tol
    print(f"  {label}: a 3% fault planted in the card's dK reads {p1:.2e} "
          f"in the estimator's backward (tolerance {lim:.1e}), {p2:.2e} in "
          f"the gradients (tolerance {tol:.0e})")
    if not (p1 > lim and p2 > tol):
        raise SystemExit(f"chip_smoke: {label}'s checks do not see a 3% "
                         f"fault in dK")
    return card, cpu, cpu64


def path_j_checks(torch, pl, ck, dev, totals):
    """The card against the CPU at n = 2048 (the same eps, xi and probes,
    CG to 1e-5): the composed MLL (J1's model; and its int8 loop, held to
    1e-2), stage by stage (:func:`composed_held`), both SLQ settings, the tidal ICM and PLMC, the spline and mean
    models, and ``chol_bf16`` (1e-2); posteriors (J1's "lmc_iter", the tidal
    models', the spline model's) with path G's limits and the complex-mean
    LOO within 1e-3, each held to the CPU's fp64 result where the CPU's
    fp32 one is that far from it."""
    n = F_CHECK_N
    X, Y = bench_data(n, seed=40)
    xs = torch.as_tensor(bench_data(G_CHECK_TEST, seed=41)[0])
    g = torch.Generator().manual_seed(5)
    eps = torch.randn((8, n, T), generator=g)
    xi = torch.randn((8, Q, min(256, n)), generator=g)
    probes = (2 * torch.randint(0, 2, (10, n, T), generator=g) - 1).float()
    tight = dict(max_cg_iters=200, cg_tol=1e-5)

    def on(t, m):
        return t.to(m.device, m.train_x.dtype)

    def make_j1(w, dt):
        return surface_model(pl, X.astype(dt), Y.astype(dt), w,
                             decomp=J_DECOMP)
    for label, kw, tol in (("bf16", dict(matvec_bf16=True), 2e-3),
                           ("int8", dict(matvec_int8=True), 1e-2)):
        cases = composed_held(torch, pl, ck, f"J n={n} composed MLL {label}",
                              make_j1, lambda m: m.mll(
                                  iterative=True, precond_rank=256,
                                  num_probes=8, eps=on(eps, m), xi=on(xi, m),
                                  **tight, **kw),
                              dev, 6, tol)
    v0 = torch.as_tensor(np.random.default_rng(19).standard_normal((n, T)),
                         dtype=torch.float32)
    with torch.no_grad():
        posts = [m.posterior(xs.to(m.device, m.train_x.dtype),
                             cache=m.precompute_posterior(v0=on(v0, m)))
                 for m in cases]
        scale = prior_var_max(torch, cases[2], xs.double())
    mean_var_held("J composed lmc_iter posterior",
                  *((p.mean, p.variance) for p in posts), scale)
    del cases, posts

    def make_plain(w, dt):
        return surface_model(pl, X.astype(dt), Y.astype(dt), w)
    for label, kw in (("defaults", {}), ("slq rank 256", dict(
            J_SLQ_KW, matvec_bf16=False, num_probes=10))):
        kw = dict(kw, **tight) if kw else dict(tight, max_cg_iters=512)
        mll_held(torch, pl, ck, f"J n={n} SLQ {label}", make_plain,
                 lambda m: m.mll(probes=on(probes, m), **kw), dev, 1)

    Xt_, Yt_, Xh, _ = tidal_series()
    for name in ("ICM", "PLMC"):
        def make_tidal(w, dt, name=name):
            return tidal_models(pl, Xt_.astype(dt), Yt_.astype(dt), w)[name]
        loss = pl.projected_lmc_mll if name == "PLMC" else (
            lambda m: m.mll())
        cases = mll_held(torch, pl, ck, f"J tidal {name} MLL", make_tidal,
                         loss, dev, 0)
        with torch.no_grad():
            preds = [tidal_predict(torch, name, m, torch.as_tensor(
                Xh, device=m.device, dtype=m.train_x.dtype)) for m in cases]
        var_scale = float(preds[2][1].max())
        mean_var_held(f"J tidal {name} prediction", *preds, var_scale)

    Xj, Yj, Xs = j4_data(n, 42)
    for name, kw in J4_MODELS.items():
        Xm = Xs if name == "spline" else Xj

        def make_exact(w, dt, kw=kw, Xm=Xm):
            return exact_surface(pl, Xm.astype(dt), Yj.astype(dt), w, **kw)
        cases = mll_held(torch, pl, ck, f"J n={n} exact {name} MLL",
                         make_exact, lambda m: m.mll(), dev,
                         0 if name == "spline" else 1)
        with torch.no_grad():
            if name == "linear":
                loos = [m.compute_loo(complex_mean=True) for m in cases]
                for i, what in enumerate(("sigma2", "residual")):
                    held_to_fp64(f"J complex-mean LOO {what}",
                                 *(lo[i] for lo in loos),
                                 scale_of(loos[2][i]), 1e-3)
            elif name == "spline":
                xsp = torch.sigmoid(xs)
                posts = [m.posterior(xsp.to(m.device, m.train_x.dtype),
                                     full_cov=False) for m in cases]
                scale = float((cases[2].covar_module(xsp.double(), diag=True)
                               + cases[2].likelihood.noise).max())
                mean_var_held("J spline posterior",
                              *((p.mean, p.variance) for p in posts), scale)

    from projected_lmc_tpu_torch.ops import kron
    model = icm_model(pl, X, Y, "cpu")
    with torch.no_grad():
        base = [model.covar_module(model.train_x)[0],
                model.task_covar_matrix(), model.likelihood.task_covariance(),
                model.train_y.T.contiguous()]
    out = []
    for where, dt in ((dev, torch.float32), ("cpu", torch.float32),
                      ("cpu", torch.float64)):
        leaves = [a.to(where, dt).clone().requires_grad_(True)
                  for a in base]
        ll = kron.icm_log_prob_chol(*leaves, chol_bf16=True)
        ll.backward()
        out.append((ll.detach(), [a.grad for a in leaves]))
    held_to_fp64("J chol_bf16 value", *(o[0] for o in out),
                 float(out[2][0].abs()), 1e-4)
    for i, k in enumerate(("K", "B", "St", "Y")):
        held_to_fp64(f"J chol_bf16 grad {k}", *(o[1][i] for o in out),
                     float(out[2][1][i].abs().max()), 1e-2)


def path_j_phase(torch, pl, ck, dev, totals, median_4=float("nan")):
    """Path J: the rest of the model surface (J1–J5, the card against the
    CPU), each with its wall time."""
    t0 = time.perf_counter()
    for label, part in (("J1", lambda *a: path_j1(*a, median_4=median_4)),
                        ("J2", path_j2), ("J3", path_j3), ("J4", path_j4),
                        ("J5", path_j5), ("J checks", path_j_checks)):
        t1 = time.perf_counter()
        part(torch, pl, ck, dev, totals)
        torch.cuda.empty_cache()
        print(f"  {label} took {time.perf_counter() - t1:.1f} s")
    print(f"  path J took {time.perf_counter() - t0:.1f} s")


# -- path K: the experiments around the models ---------------------------------

K_MODELS = ["ICM", "var", "PLMC", "oilmm", "PLMC_fast"]   # the driver's five
K_STEPS = 128                    # K1's and K3's cap on a model's fit steps
K1_RUNS = 2
K2_B, K2_STEPS, K2_SEQ, K2_TEST = 8, 128, 32, 100
K4_B, K4_N, K4_M, K4_D = 4, 1000, 800, 3
K_METRICS = ("n_iter", "train_time", "pred_time", "loss", "noise", "R2",
             "RMSE", "mean_err_abs", "max_err_abs", "mean_err_quant05",
             "mean_err_quant95", "mean_err_quant99", "mean_sigma", "PVA",
             "alpha_CI")


@contextlib.contextmanager
def driver_captured(drv):
    """From outside the package: the arguments of the driver's last
    ``build_models`` call, and the results and trained models of its last
    ``train_and_eval``."""
    seen = {}
    build, train = drv.build_models, drv.train_and_eval

    def build_spy(X, Y, *args, **kwargs):
        seen["build"] = (X, Y, args, kwargs)
        return build(X, Y, *args, **kwargs)

    def train_spy(models, X_test, Y_test, **kwargs):
        res, trained = train(models, X_test, Y_test, **kwargs)
        seen.update(results=res, trained=trained, test=(X_test, Y_test))
        return res, trained
    drv.build_models, drv.train_and_eval = build_spy, train_spy
    try:
        yield seen
    finally:
        drv.build_models, drv.train_and_eval = build, train


def driver_predictions(torch, drv, name, model, info, Xt, Yt):
    """``predict_and_metrics``' metrics and the mean and variance it
    computed (read from outside, at its ``compute_metrics`` call)."""
    got = {}
    real = drv.compute_metrics

    def spy(y, mean, sigma, *args, **kwargs):
        got.update(mean=torch.as_tensor(mean),
                   var=torch.as_tensor(sigma).double() ** 2)
        return real(y, mean, sigma, *args, **kwargs)
    drv.compute_metrics = spy
    try:
        metrics = drv.predict_and_metrics(name, model, info, Xt, Yt,
                                          print_metrics=False)
    finally:
        drv.compute_metrics = real
    return metrics, got["mean"], got["var"]


def driver_prior_var_max(torch, pl, model, x) -> float:
    """The largest prior variance with noise at x, the variational model's
    from its mixing weights."""
    if not isinstance(model, pl.VariationalMultitaskGPModel):
        return prior_var_max(torch, model, x)
    with torch.no_grad():
        return task_prior_var_max(
            model.covar_module(x, diag=True), model.lmc_coeffs ** 2,
            torch.diagonal(model.likelihood.task_covariance()))


def read_study(path):
    """{row label: {column: field}} of a study CSV (the csv module: the
    card's host has no pandas)."""
    with open(path, newline="") as f:
        return {r[""]: r for r in csv.DictReader(f)}


def path_k1(torch, pl, ck, dev, totals):
    """K1: the paper's study at full width (``DEFAULT_PARAMS``), the port's
    ``run_study`` on the card: five models, 2 runs, non-converged-run
    rejection, at most ``K_STEPS`` steps a model; its landmark and final
    CSVs; then each trained model of the last run through
    ``predict_and_metrics`` on the card against the CPU on the same leaves,
    on 500 of the test points (path G's limits; the ICM held to the CPU's fp64 result as H1 is, the
    variational model, whose trained fp32 posterior is as far from its
    fp64 one on the CPU, as :func:`held_to_fp64` holds path I's), and K3
    at the study's shapes."""
    import tempfile
    from projected_lmc_tpu_torch.experiments import driver as drv
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "parameter_study_void_void.csv")
        zero_counts(ck)
        t0 = time.perf_counter()
        with driver_captured(drv) as seen:
            drv.run_study(n_random_runs=K1_RUNS, models_to_run=K_MODELS,
                          path=path, n_iter=K_STEPS,
                          reject_nonconverged_runs=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # a step: K3 once for the ICM and each projected model, twice for
        # the variational one; serving: 2 a projected model, 4 the ICM
        # (its cache, posterior, compute_var's cache and posterior), 2 var
        k3 = K1_RUNS * (6 * K_STEPS + 12)
        if read_counts(ck) != expect(K3=k3):
            raise SystemExit(f"chip_smoke: K1's study launched "
                             f"{read_counts(ck)}, not K3 {k3} times")
        totals["K3"] += k3
        files = [path[:-4] + f"_{k}runs.csv" for k in (1, K1_RUNS)] + [path]
        labels = [f"{m}_void_void_0_0" for m in K_MODELS]
        for f in files:
            rows = read_study(f)
            bad = [(label, k) for label, r in rows.items()
                   for k in K_METRICS + ("n_sucess_runs",)
                   if not math.isfinite(float(r[k]))]
            if list(rows) != labels + [lab + "_conv" for lab in labels] \
                    or bad:
                raise SystemExit(f"chip_smoke: K1's {os.path.basename(f)} "
                                 f"has rows {list(rows)}, non-finite {bad}")
        final = read_study(path)
    print(f"  K1 run_study (n={drv.DEFAULT_PARAMS['n']}, p="
          f"{drv.DEFAULT_PARAMS['p']}, q={drv.DEFAULT_PARAMS['q']}, "
          f"{K1_RUNS} runs, {K_STEPS} steps a model): {wall:.1f} s, K3 {k3} "
          f"launches; {', '.join(os.path.basename(f) for f in files)} each "
          f"with 5 model and 5 _conv rows, every metric finite")
    for name, label in zip(K_MODELS, labels):
        r, c = final[label], final[label + "_conv"]
        t = float(r["train_time"])
        print(f"  K1 {name} (mean of {K1_RUNS} runs): train_time {t:.2f} s, "
              f"t_per_iter {t / float(r['n_iter']) * 1e3:.3f} ms; R2 "
              f"{float(r['R2']):.4f}, RMSE {float(r['RMSE']):.4f}, PVA "
              f"{float(r['PVA']):.4f}, alpha_CI {float(r['alpha_CI']):.4f}; "
              f"converged runs {float(c['n_sucess_runs']):g}")

    X, Y, args, kwargs = seen["build"]
    Xt, Yt = (a[:G_CHECK_TEST] for a in seen["test"])
    cpu = torch.device("cpu")

    def rel(a, b):
        return abs(a - b) / max(1.0, abs(b))
    for name in K_MODELS:
        model, r = seen["trained"][name], seen["results"][name]
        info = dict(n_iter=r["n_iter"], train_time=r["train_time"],
                    loss=r["loss"])

        def make(w, dt=np.float32, name=name):
            return drv.build_models(X.astype(dt), Y.astype(dt), *args[:2],
                                    [name], seed=kwargs["seed"],
                                    device=w)[name]
        got, gm, gv = driver_predictions(torch, drv, name, model, info, Xt,
                                         Yt)
        host = carried(pl, model, cpu, make)
        want, cm, cv = driver_predictions(torch, drv, name, host, info, Xt,
                                          Yt)
        keys = [k for k in K_METRICS if k != "pred_time"]
        label = f"K1 {name}"
        if name not in ("ICM", "var"):
            scale = driver_prior_var_max(torch, pl, host, torch.as_tensor(Xt))
            held(f"{label} mean", gm, cm, scale_of(cm), 1e-4)
            held(f"{label} variance", gv, cv, scale, 1e-3)
            err = max(rel(got[k], want[k]) for k in keys)
            print(f"  {label}: the metrics, card against CPU, max|Δ|/max(1, "
                  f"|cpu|) {err:.2e} (tolerance 1e-3)")
            if not (math.isfinite(err) and err <= 1e-3):
                raise SystemExit(f"chip_smoke: {label}'s metrics disagree "
                                 f"between the card and the CPU")
            continue
        host64 = carried(pl, model, cpu, lambda w: make(w, np.float64))
        want64, m64, v64 = driver_predictions(torch, drv, name, host64,
                                              info, Xt, Yt)
        scale = driver_prior_var_max(torch, pl, host64,
                                     torch.as_tensor(Xt, dtype=torch.float64))
        held_to_fp64(f"{label} mean", gm, cm, m64, scale_of(m64), 1e-4)
        held_to_fp64(f"{label} variance", gv, cv, v64, scale, 1e-3)
        print(f"  {label} metrics, max|Δ|/max(1, |·|) of card against CPU "
              f"fp32 / card against CPU fp64 / CPU fp32 against fp64: "
              + ", ".join(f"{k} {rel(got[k], want[k]):.1e} / "
                          f"{rel(got[k], want64[k]):.1e} / "
                          f"{rel(want[k], want64[k]):.1e}" for k in keys))
        if name == "ICM":      # H1's rule
            bad = [k for k in keys if not rel(got[k], want64[k])
                   <= max(1e-3, rel(want[k], want64[k]))]
        else:                  # held_to_fp64's rule, as the mean above
            bad = [k for k in keys if not (
                rel(got[k], want[k]) <= 1e-3
                or rel(got[k], want64[k]) <= 2 * rel(want[k], want64[k]))]
        if bad:
            raise SystemExit(f"chip_smoke: {label}'s metrics {bad} disagree "
                             f"with the CPU's beyond the fp32 rounding of "
                             f"its own result")
    icm, plmc, var = (seen["trained"][k] for k in ("ICM", "PLMC", "var"))
    x_test = torch.as_tensor(seen["test"][0], device=dev)  # all 2,500
    z = var.inducing_points.detach()
    for model, pairs in ((icm, ((icm.train_x, icm.train_x),
                                (x_test, icm.train_x))),
                         (plmc, ((plmc.train_x, plmc.train_x),)),
                         (var, ((z, z), (var.train_x, z)))):
        k3_shapes(torch, ck, dev, pairs,
                  model.covar_module.lengthscale.detach())


def path_k2(torch, pl, ck, dev, totals):
    """K2: the seeded study, ``fit_ensemble`` on B = 8 seeds of the paper's
    default PLMC (``build_models(seed=s)`` on ``generate_synthetic(seed=s)``,
    its test split cut to 100 points, unused here), 128 steps in 16-step
    chunks, beside each seed's own sequential ``fit`` (32 steps, the same
    chunks) on the card, whose losses the batch's must equal to 1e-6."""
    from projected_lmc_tpu_torch.experiments import driver as drv
    from projected_lmc_tpu_torch.experiments import generate_synthetic
    v = drv.DEFAULT_PARAMS
    datas = [generate_synthetic(
        n=v["n"], p=v["p"], q=v["q"], q_noise=v["q_noise"],
        mu_noise=v["mu_noise"], mu_str=v["mu_str"],
        max_scale=v["max_scale"], n_test=K2_TEST, seed=s)
        for s in range(K2_B)]

    def seeded(s):
        return drv.build_models(datas[s]["X"], datas[s]["Y"], v["q"], v["p"],
                                ["PLMC"], seed=s, device=dev)["PLMC"]
    kw = dict(lr=1e-2, schedule=pl.lambda_lr_schedule(1e-2, 1e-3),
              scan_steps=STEPS_PER_CHUNK, device=dev)
    models = [seeded(s) for s in range(K2_B)]
    zero_counts(ck)
    _, info = pl.fit_ensemble(models, pl.projected_lmc_mll, n_iter=K2_STEPS,
                              **kw)
    k3 = K2_STEPS * K2_B                       # K3 once a model a step
    if read_counts(ck) != expect(K3=k3) or info["losses"].shape != (
            K2_STEPS, K2_B) or not np.all(np.isfinite(info["losses"])):
        raise SystemExit(f"chip_smoke: K2's fit_ensemble launched "
                         f"{read_counts(ck)}, not K3 {k3} times, or lost "
                         f"finiteness")
    totals["K3"] += k3
    del models
    batch_ms = info["train_time"] / K2_STEPS * 1e3
    seq_ms, worst, bitwise = [], 0.0, True
    for s in range(K2_B):
        zero_counts(ck)
        _, si = pl.fit(seeded(s), pl.projected_lmc_mll, n_iter=K2_SEQ, **kw)
        if read_counts(ck) != expect(K3=K2_SEQ):
            raise SystemExit(f"chip_smoke: K2's sequential fit launched "
                             f"{read_counts(ck)}, not K3 {K2_SEQ} times")
        totals["K3"] += K2_SEQ
        seq_ms.append(si["train_time"] / K2_SEQ * 1e3)
        a = info["losses"][:K2_SEQ, s].astype(np.float64)
        b = np.asarray(si["losses"], np.float64)
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
        bitwise = bitwise and np.array_equal(a, b)
    print(f"  K2 fit_ensemble, B={K2_B} PLMC seeds (n={v['n']}, p={v['p']}, "
          f"q={v['q']}), {K2_STEPS} steps in {STEPS_PER_CHUNK}-step chunks: "
          f"{info['train_time']:.2f} s, {batch_ms:.3f} ms a batch step "
          f"({K2_B} K3 launches a batch step); {K2_B} sequential fit steps "
          f"(one a seed, {K2_SEQ}-step runs) {sum(seq_ms):.3f} ms "
          f"(per seed {min(seq_ms):.3f}–{max(seq_ms):.3f} ms): batch / "
          f"sequential {batch_ms / sum(seq_ms):.3f}")
    print(f"  K2 each seed's first {K2_SEQ} losses against its own "
          f"sequential fit on the card: max rel {worst:.2e} (tolerance "
          f"1e-6); bitwise equal: {bitwise}")
    if not worst <= 1e-6:
        raise SystemExit("chip_smoke: K2's batched losses disagree with the "
                         "sequential fits")


def write_tidal_fixture(root, seed=0):
    """Four bramblemet-format ``<station>.csv.gz`` files: ``Date``
    (dd/mm/YYYY), ``Time`` (HH:MM), ``DEPTH`` and a spare column, on a
    5-minute clock over ``load_tidal``'s window (2020-06-01 to 2020-06-15),
    each station an M2 (12.42 h) plus an S2 (12.00 h) tide of its own
    amplitude and phase on a slow quadratic trend with N(0, 0.05²) noise;
    the third station's clock 2 minutes late, so that the loader's
    interp1d moves it onto the first one's."""
    import gzip
    from datetime import datetime, timedelta
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "bramblemet")
    os.makedirs(d)
    n = J3_DAYS * 86_400 // J3_SAMPLE_S
    for k, station in enumerate(("bramblemet", "cambermet", "chimet",
                                 "sotonmet")):
        late = 120 if k == 2 else 0
        t0 = datetime(2020, 6, 1) + timedelta(seconds=late)
        hours = (np.arange(n) * J3_SAMPLE_S + late) / 3600.0
        a, b = rng.uniform(0.8, 1.6), rng.uniform(0.2, 0.6)
        depth = (2.0 + a * np.cos(2 * np.pi * hours / 12.42
                                  + rng.uniform(0, 2 * np.pi))
                 + b * np.cos(2 * np.pi * hours / 12.0
                              + rng.uniform(0, 2 * np.pi))
                 + np.polyval(rng.standard_normal(3), hours / hours.max())
                 + 0.05 * rng.standard_normal(n))
        with gzip.open(os.path.join(d, f"{station}.csv.gz"), "wt",
                       newline="") as f:
            w = csv.writer(f)
            w.writerow(["Date", "Time", "DEPTH", "WSPD"])
            for i in range(n):
                t = t0 + timedelta(seconds=J3_SAMPLE_S * i)
                w.writerow([t.strftime("%d/%m/%Y"), t.strftime("%H:%M"),
                            f"{depth[i]:.3f}", f"{rng.uniform(0, 20):.1f}"])


def path_k3(torch, pl, ck, dev, totals):
    """K3: the real-data entry point on fixture files in each source's
    format: ``load_tidal`` → ``build_models`` (the loader's spectral
    mixture, 5 mixtures, likelihood rank 0, ``var_ind_range="data"``,
    ``oilmm_bulk=False``) → ``train_and_eval(var_fit="warm_start")`` with
    K1's cap on steps (no K3: the spectral mixture is plain torch); then
    ``load_ship`` and ``load_sarcos`` (with and without the training file)
    on small seeded files."""
    import tempfile
    from scipy.io import savemat
    from projected_lmc_tpu_torch.experiments import driver as drv
    from projected_lmc_tpu_torch.experiments import realdata
    rng = np.random.default_rng(80)
    with tempfile.TemporaryDirectory() as root:
        write_tidal_fixture(root)
        t0 = time.perf_counter()
        d = realdata.load_tidal(root)
        load_s = time.perf_counter() - t0
        models = drv.build_models(
            d["X"], d["Y"], d["q"], 0, K_MODELS,
            kernel_type=d["kernel_type"], mean_type="zero",
            n_ind_points=d["n_ind_points"], ker_kwargs=d["ker_kwargs"],
            var_ind_range="data", oilmm_bulk=False, device=dev)
        zero_counts(ck)
        t0 = time.perf_counter()
        res, _ = drv.train_and_eval(models, d["X_test"], d["Y_test"],
                                    n_iter=K_STEPS,
                                    loss_thresh=d["loss_thresh"],
                                    print_metrics=False,
                                    var_fit="warm_start", device=dev)
        wall = time.perf_counter() - t0
        if read_counts(ck) != expect():
            raise SystemExit(f"chip_smoke: K3's tidal study launched "
                             f"{read_counts(ck)}")
        print(f"  K3 load_tidal on the fixture: {load_s:.2f} s, n="
              f"{len(d['X'])} training and {len(d['X_test'])} test points, "
              f"T={d['Y'].shape[1]}, {d['dates'][0]} to {d['dates'][-1]}; "
              f"train_and_eval (at most {K_STEPS} steps, var by sgpr_em) "
              f"{wall:.1f} s")
        for name, r in res.items():
            print(f"  K3 tidal {name}: n_iter {r['n_iter']}, train_time "
                  f"{r['train_time']:.2f} s; R2 {r['R2']:.4f}, RMSE "
                  f"{r['RMSE']:.4f}, PVA {r['PVA']:.4f}")
            if not all(math.isfinite(r[k]) for k in K_METRICS):
                raise SystemExit(f"chip_smoke: K3's tidal {name} metrics "
                                 f"are not finite")
        os.makedirs(os.path.join(root, "ship"))
        with open(os.path.join(root, "ship", "data.txt"), "w") as f:
            for row in rng.standard_normal((1000, 18)) * rng.uniform(
                    0.1, 100.0, 18):
                f.write("   " + "   ".join(f"{v:.3e}" for v in row) + "\n")
        ship = realdata.load_ship(root)
        sarcos = os.path.join(root, "SARCOS")
        os.makedirs(sarcos)
        savemat(os.path.join(sarcos, "sarcos_inv_test.mat"),
                {"sarcos_inv_test": rng.standard_normal((500, 28))})
        split = realdata.load_sarcos(root)
        savemat(os.path.join(sarcos, "sarcos_inv.mat"),
                {"sarcos_inv": rng.standard_normal((2000, 28))})
        full = realdata.load_sarcos(root)
    for label, out, want in (
            ("load_ship", ship, ((100, 3), (100, 12), False)),
            ("load_sarcos (split fallback)", split, ((100, 21), (100, 7), True)),
            ("load_sarcos", full, ((500, 21), (500, 7), False))):
        shapes = (out["X_test"].shape, out["Y_test"].shape,
                  bool(out.get("split_fallback", False)))
        finite = all(np.all(np.isfinite(out[k]))
                     for k in ("X", "Y", "X_test", "Y_test"))
        print(f"  K3 {label}: X {out['X'].shape}, Y {out['Y'].shape}, test "
              f"{shapes[0]} / {shapes[1]}, split_fallback {shapes[2]}, "
              f"finite {finite}")
        if shapes != want or not finite:
            raise SystemExit(f"chip_smoke: K3's {label} gave {shapes}")


def path_k4(torch, pl, ck, dev, totals):
    """K4: the utilities. Per-batch 3-D kernel inputs on the card against
    the CPU (1e-6 of the largest entry; plain torch on both, no kernel),
    ``profile_trace`` writing a Chrome trace that holds the region's kernel
    launches on the card (its device kernel records are printed beside
    them: run after paths 1–J, the profiler has recorded the runtime calls
    but no device activity, while in a process of its own, and after
    dozens of large profiles, it records both; the cause is not found),
    and ``ensure_cuda()``."""
    import glob
    import tempfile
    from projected_lmc_tpu_torch import kernels as tker
    from projected_lmc_tpu_torch.module import keyed_state
    from projected_lmc_tpu_torch.utils.device import ensure_cuda
    from projected_lmc_tpu_torch.utils.profiling import profile_trace
    rng = np.random.default_rng(90)

    def inputs(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, shape), dtype=torch.float32)
    x1 = inputs(K4_B, K4_N, K4_D)
    x2 = inputs(K4_B, K4_M, K4_D)
    shared = inputs(K4_M, K4_D)
    for label, kw in (("matern", dict(kernel_type="matern")),
                      ("rbf", dict(kernel_type="rbf")),
                      ("additive", dict(kernel_type="matern",
                                        decomp=[[0, 1], [2]])),
                      ("spline", dict(kernel_type="spline")),
                      ("spectral_mixture", dict(
                          kernel_type="spectral_mixture",
                          ker_kwargs={"num_mixtures": 3}))):
        card = moved(torch, tker.handle_covar(dim=K4_D, n_funcs=K4_B,
                                              device=dev, **kw), 91)
        host = tker.handle_covar(dim=K4_D, n_funcs=K4_B, device="cpu", **kw)
        pl.load_jax_state(host, {k: v.detach().cpu().numpy()
                                 for k, v in keyed_state(card).items()})
        err = 0.0
        zero_counts(ck)
        with torch.no_grad():
            for a, b, diag in ((x1, x2, False), (x1, shared, False),
                               (x1, x2, True)):
                want = host(a, b, diag=diag)
                got = card(a.to(dev), b.to(dev), diag=diag).cpu()
                err = max(err, float((got - want).abs().max())
                          / scale_of(want))
        if read_counts(ck) != expect():
            raise SystemExit(f"chip_smoke: K4's 3-D {label} kernel launched "
                             f"{read_counts(ck)}")
        check(f"K4 {label} 3-D inputs ({K4_B}, {K4_N}, {K4_D}) against "
              f"({K4_B}, {K4_M}, {K4_D}), against a shared ({K4_M}, {K4_D}) "
              f"and the diagonal, card against CPU (relative)", err, 1e-6)
    kernel = tker.handle_covar("matern", K4_D, n_funcs=K4_B, device=dev)
    with tempfile.TemporaryDirectory() as logdir, torch.no_grad():
        x = shared.to(dev)
        with profile_trace(logdir) as prof:   # a 2-D forward: K3 once
            served(torch, ck, "K4 profile_trace", 1, lambda: kernel(x),
                   totals)
        files = glob.glob(os.path.join(logdir, "*.json"))
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    device_us = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type.name == "CUDA")
    cats = {}
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    launches = [e for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")]
    kernels = sorted({e["name"][:40] for e in events
                      if e.get("cat") == "kernel"})
    print(f"  K4 profile_trace: {len(files)} trace file, {len(events)} "
          f"events by category {cats}: {len(launches)} kernel launches on "
          f"the host's CUDA runtime; device kernels {kernels}, the "
          f"profiler's device time {device_us:.1f} us")
    if len(files) != 1 or not launches:
        raise SystemExit("chip_smoke: K4's profile_trace holds no kernel "
                         "launch")
    up = ensure_cuda()
    print(f"  K4 ensure_cuda(): {up}")
    if up is not True:
        raise SystemExit("chip_smoke: ensure_cuda() is not True on the card")


def path_k_phase(torch, pl, ck, dev, totals):
    """Path K: the experiments around the models (K1–K4), each with its
    wall time, and K3's launches on the path."""
    t0 = time.perf_counter()
    before = totals["K3"]
    for label, part in (("K1", path_k1), ("K2", path_k2), ("K3", path_k3),
                        ("K4", path_k4)):
        t1 = time.perf_counter()
        part(torch, pl, ck, dev, totals)
        torch.cuda.empty_cache()
        print(f"  {label} took {time.perf_counter() - t1:.1f} s")
    print(f"  path K launched K3 {totals['K3'] - before} times and took "
          f"{time.perf_counter() - t0:.1f} s")


# -- path L: the mesh on torch.distributed ----------------------------------------

L_RANKS, L_STEPS = 4, 8
L1_MESH, L2_MESH = (2, 2), (4, 1)        # (data, latent)
L_TIMEOUT = 600                          # seconds for a spawn of ranks
L_LOSS_RTOL, L_GRAD_TOL = 1e-5, 1e-4     # the first step, sharded vs not
L_PARAM_RTOL, L_PARAM_ATOL = 1e-4, 1e-6
L_STEPS_RTOL = 1e-4                      # each of the 8 steps' losses
L_EPS_REGIME = 10.0                      # |g| < 10·ε: AdamW's ε regime
L_EPS_GRAD_RTOL = 1e-2                   # such a gradient, sharded vs not
L_WITNESS_TOL = 1e-6                     # a rank's latents vs the same batch


def _peak_gib(torch, dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def _l_model(pl, case, device):
    """A path-L model on ``device``, carrying the case's leaves once
    :func:`l_cases` has set them."""
    if case["kind"] == "variational":
        model = var_model(pl, case["X"], case["Y"], case["m"], device)
    else:
        model = pl.ProjectedGPModel(
            case["X"], case["Y"], case["Y"].shape[1], case["q"],
            init_lmc_coeffs=True, mean_type="zero", kernel_type="matern",
            n_inducing_points=case["m"], device=device,
            **PROJ_CONFIGS[case["config"]])
    if "arrays" in case:
        pl.load_jax_state(model, case["arrays"])
    return model


def _l_loss(pl, case):
    if case["kind"] == "variational":
        return lambda m: m.elbo()
    return pl.projected_lmc_mll


def _l_train(torch, model, opt_step, steps, params):
    """``steps`` AdamW steps by ``opt_step()`` (returns −loss): every loss,
    each step's host ms around a synchronize, and the first step's
    gradients and the parameters after it."""
    losses, ms = [], []
    for i in range(steps):
        loss, t = timed(torch, lambda: float(opt_step()))
        ms.append(t)
        losses.append(loss)
        if i == 0:
            grads = {n: np.zeros(tuple(p.shape)) if p.grad is None
                     else p.grad.detach().cpu().numpy().copy()
                     for n, p in params}
            after = {n: p.detach().cpu().numpy().copy() for n, p in params}
    return dict(losses=losses, ms=ms, grads=grads, params=after)


def l_reference(torch, pl, case, dev, steps):
    """The unsharded run on this process's card: the same AdamW(1e-2,
    weight decay 1e-2) as ``sharded_fit_step``, ``steps`` steps."""
    from projected_lmc_tpu_torch.module import trainable_parameters
    model = _l_model(pl, case, dev)
    params = trainable_parameters(model)
    opt = torch.optim.AdamW([p for _, p in params], lr=1e-2,
                            weight_decay=1e-2)
    loss_fn = _l_loss(pl, case)

    def opt_step():
        opt.zero_grad(set_to_none=False)
        loss = -loss_fn(model)
        loss.backward()
        opt.step()
        return loss.detach()

    torch.cuda.reset_peak_memory_stats(dev)
    out = _l_train(torch, model, opt_step, steps, params)
    out["peak_gib"] = _peak_gib(torch, dev)
    return model, out


def l_restricted(model, x, lo, hi):
    """The unsharded projected model restricted to latents lo..hi − 1, the
    batch a rank of the latent axis holds (its covariance, likelihood and
    mean modules sliced by ``module.latent_slice``, its own cache of the
    projected targets' rows lo..hi − 1): the latent posterior at x."""
    from projected_lmc_tpu_torch.module import latent_slice
    q = model.n_funcs
    view = copy.copy(model)
    view._modules = dict(model._modules)
    for name in ("covar_module", "likelihood", "mean_module"):
        view._modules[name] = latent_slice(model._modules[name], lo, hi, q)
    view.n_funcs = hi - lo
    y = model._targets(model.project_data(model.train_y_tasks), "tn")
    cache = view.precompute_posterior(y[lo:hi], "tn")
    return view.posterior(x, cache, full_cov=False)


def l_witness(torch, pl, case, state, x, lo, hi):
    """An unsharded model carrying a rank's leaves ``state``: its latent
    posterior mean and variance at x restricted to latents lo..hi − 1
    (:func:`l_restricted`), and rows lo..hi − 1 of its whole batch's."""
    model = _l_model(pl, dict(case, arrays=state), x.device)
    with torch.no_grad():
        part = l_restricted(model, x, lo, hi)
        whole = model.compute_latent_distrib(x, full_cov=False)
        out = ((part.mean.cpu().numpy(), part.variance.cpu().numpy()),
               (whole.mean[lo:hi].cpu().numpy(),
                whole.variance[lo:hi].cpu().numpy()))
    del model, part, whole
    torch.cuda.empty_cache()
    return out


def path_l_rank(rank, spec):
    """One rank of path L's world: L1 (data 2 × latent 2), then L2 and L3
    (data 4 × latent 1), each a sharded ``sharded_fit_step`` run with the
    launch counts set to 0 just before and read just after; L1's sharded
    cache and ``predict``, and ``save_orbax``/``load_orbax`` under the
    group; then path M (:func:`path_m_rank`) when the spec holds it. A
    spec without L1–L3 runs path M alone. Loads the kernel library the
    parent built."""
    import torch

    import projected_lmc_tpu_torch as pl
    from projected_lmc_tpu_torch import parallel
    from projected_lmc_tpu_torch.module import keyed_state, \
        trainable_parameters
    from projected_lmc_tpu_torch.ops import _build, cuda_kernels as ck
    t0 = time.perf_counter()
    dev = parallel.distributed.current_device()
    _build.library()
    out = {"backend": parallel.distributed.backend(), "device": str(dev),
           "seconds": {}}
    for label in (lb for lb in ("L1", "L2", "L3") if lb in spec):
        t1 = time.perf_counter()
        case = spec[label]
        mesh = parallel.make_mesh(L_RANKS, data=case["mesh"][0],
                                  latent=case["mesh"][1])
        model = _l_model(pl, case, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(ck)
        step, model, _ = parallel.sharded_fit_step(model, mesh,
                                                   _l_loss(pl, case))
        res = _l_train(torch, model, step, spec["steps"],
                       trainable_parameters(model))
        if label == "L1":
            x_test = torch.as_tensor(case["X_test"], device=dev)

            def serve():
                cache = model.prediction_cache()
                return cache, model.predict(x_test, observed=True,
                                            cache=cache)

            with torch.no_grad():
                (cache, (mean, var)), serve_ms = timed(torch, serve)
        res.update(counts=read_counts(ck), peak_gib=_peak_gib(torch, dev),
                   mesh=dict(mesh.shape))
        if label == "L1":
            # the rank's own latents before the gather: a witness, after
            # the counts are read
            with torch.no_grad():
                own = model.compute_latent_distrib(x_test, full_cov=False,
                                                   cache=cache)
            res.update(mean=mean.cpu().numpy(), var=var.cpu().numpy(),
                       serve_ms=serve_ms, latents=cache["latents"],
                       own_mean=own.mean.cpu().numpy(),
                       own_var=own.variance.cpu().numpy(),
                       state={k: v.detach().cpu().numpy()
                              for k, v in keyed_state(model).items()})
            del cache, own
        out[label] = res
        if label == "L1":
            pl.save_orbax(model, spec["ckpt"])
            loaded = pl.load_orbax(_l_model(pl, case, dev), spec["ckpt"])
            a, b = keyed_state(model), keyed_state(loaded)
            out["ckpt_max_diff"] = max(float((a[k] - b[k]).abs().max()
                                             .detach())
                                       for k in a if a[k].numel())
        out["seconds"][label] = time.perf_counter() - t1
        del model, step
        torch.cuda.empty_cache()
    if "M" in spec:
        out["M"] = path_m_rank(torch, pl, ck, spec["M"], dev)
    out["seconds"]["all"] = time.perf_counter() - t0
    return out


def l_one_rank(pl, ck, case, dev):
    """This process as a one-rank group (a card of its own: NCCL):
    ``dryrun_step`` on L1's model, the launch counts set to 0 just before
    and read just after; the group is left at the end."""
    import tempfile

    from projected_lmc_tpu_torch import parallel
    with tempfile.TemporaryDirectory(prefix="plmc_one_") as tmp:
        parallel.initialize("file://" + os.path.join(tmp, "rendezvous"), 1,
                            0, device=dev.type, timeout=300)
        try:
            model = _l_model(pl, case, dev)
            zero_counts(ck)
            loss = parallel.dryrun_step(model, parallel.make_mesh(1),
                                        pl.projected_lmc_mll)
            return dict(loss=loss, counts=read_counts(ck),
                        backend=parallel.distributed.backend())
        finally:
            parallel.distributed.shutdown()


def l_cases(torch, pl, dev):
    """Path L's three configurations, each a dict a rank can rebuild: its
    data, its leaves moved off the init (uniform(−0.3, 0.3), as path F),
    its mesh. L1: F2's full-B̃ projected model (n = 10⁴, p = 7, q = 4,
    d = 4); L2: I3's projected SGPR (n = 44,480, d = 21, q = 7, m = 500,
    PLMC_fast); L3: the variational model at SARCOS's n = 44,484 (I2's,
    m = 500)."""
    from projected_lmc_tpu_torch.module import keyed_state

    X, Y = bench_data(N, seed=0)
    Xt, _ = bench_data(N_TEST, seed=5)
    cases = {"L1": dict(kind="projected", config="PLMC", X=X, Y=Y, q=Q,
                        m=None, X_test=Xt, mesh=L1_MESH)}
    rng = np.random.default_rng(1)
    X = rng.standard_normal((I3_N, I_D)).astype(np.float32)
    Y = rng.standard_normal((I3_N, T)).astype(np.float32)
    cases["L2"] = dict(kind="projected", config="PLMC_fast", X=X, Y=Y, q=T,
                       m=I_M, mesh=L2_MESH)
    X, Y = bench_data(I2_FULL_N, seed=0, d=I_D)
    cases["L3"] = dict(kind="variational", X=X, Y=Y, q=T, m=I_M,
                       mesh=L2_MESH)
    for seed, case in zip((14, 15, 16), cases.values()):
        model = moved(torch, _l_model(pl, case, dev), seed)
        case["arrays"] = {k: v.detach().cpu().numpy()
                          for k, v in keyed_state(model).items()}
    return cases


def _l_param_err(got, want):
    """{leaf: |got − want| / (atol + rtol·|want|)} over every entry."""
    return {k: np.abs(got[k] - v) / (L_PARAM_ATOL + L_PARAM_RTOL * np.abs(v))
            for k, v in want.items() if v.size}


def _worst(errs, masks=None):
    """(worst entry, its leaf, its index) of ``errs``, over the entries
    ``masks`` selects (every entry without it); (0, None, None) if none."""
    worst = (-1.0, None, None)
    for k, e in errs.items():
        e = e if masks is None else np.where(masks[k], e, -1.0)
        i = np.unravel_index(int(e.argmax()), e.shape)
        worst = max(worst, (float(e[i]), k, i), key=lambda w: w[0])
    return worst if worst[1] is not None and worst[0] >= 0 \
        else (0.0, None, None)


def l_held(label, got, want, start, lr=1e-2, weight_decay=1e-2, eps=1e-8):
    """A sharded run against the unsharded one: the first step's loss,
    gradients and parameters at L1's limits, then every step's loss.

    Every parameter entry is held to the unsharded step's at rtol + atol,
    with one exception. In fp32 an entry whose gradient sits in AdamW's ε
    regime moves by lr·g/(|g| + ε) on the first step, so a gradient
    difference at the fp32 floor moves it by up to 1e6 times that. An entry
    beyond the limit is excused only when its unsharded gradient is below
    ``L_EPS_REGIME``·ε and its sharded one has the same sign and lies
    within ``L_EPS_GRAD_RTOL`` of it; it is then held instead to AdamW's
    first step taken from its sharded gradient from the same start,
    p·(1 − lr·wd) − lr·g/(|g| + ε), at the same limit. Any other entry
    beyond the limit fails the run."""
    rel = abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])
    grad = max(float(np.abs(got["grads"][k] - g).max()
                     / max(np.abs(g).max(), 1e-30))
               for k, g in want["grads"].items() if g.size)
    errs = _l_param_err(got["params"], want["params"])
    raw = _worst(errs)[0]
    excused = {}
    for k, e in errs.items():
        g_u, g_s = want["grads"][k], got["grads"][k]
        excused[k] = ((e > 1.0) & (np.abs(g_u) < L_EPS_REGIME * eps)
                      & (np.sign(g_u) == np.sign(g_s))
                      & (np.abs(g_s - g_u) <= L_EPS_GRAD_RTOL * np.abs(g_u)))
    par, p_leaf, p_idx = _worst(errs, {k: ~m for k, m in excused.items()})
    at = "" if p_leaf is None else (
        f" at {p_leaf}{[int(j) for j in p_idx]} (gradient "
        f"{want['grads'][p_leaf][p_idx]:.3e} unsharded, "
        f"{got['grads'][p_leaf][p_idx]:.3e} sharded)")
    e_worst, leaf, idx = _worst(errs, excused)
    adam = {k: start[k] * (1 - lr * weight_decay)
            - lr * g / (np.abs(g) + eps) for k, g in got["grads"].items()}
    own, o_leaf, o_idx = _worst(_l_param_err(got["params"], adam), excused)
    n_exc = sum(int(m.sum()) for m in excused.values())
    steps = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                    want["losses"]))
    print(f"  {label} sharded against unsharded: first loss rel "
          f"{rel:.2e} (tolerance {L_LOSS_RTOL:.0e}), worst gradient "
          f"{grad:.2e} of its largest entry ({L_GRAD_TOL:.0e}), worst "
          f"parameter {raw:.2e} of rtol {L_PARAM_RTOL:.0e} + atol "
          f"{L_PARAM_ATOL:.0e}, {par:.2e} outside the ε regime (≤ 1){at}, "
          f"{len(got['losses'])} losses worst rel {steps:.2e} "
          f"({L_STEPS_RTOL:.0e})")
    if n_exc:
        i = tuple(o_idx)
        print(f"  {label}: {n_exc} parameter entries beyond the limit lie in "
              f"AdamW's ε regime (|g| < {L_EPS_REGIME:.0f}·ε = "
              f"{L_EPS_REGIME * eps:.0e}, the sharded gradient of its sign "
              f"within {L_EPS_GRAD_RTOL:.0e}); the worst of them "
              f"{leaf}{[int(j) for j in idx]} reads {e_worst:.2e} of the "
              f"limit; "
              f"AdamW's first step from the sharded gradient holds them to "
              f"{own:.2e} of the limit (≤ 1), worst at "
              f"{o_leaf}{[int(j) for j in i]} (gradient "
              f"{want['grads'][o_leaf][i]:.3e} unsharded, "
              f"{got['grads'][o_leaf][i]:.3e} sharded, the leaf's largest "
              f"{float(np.abs(want['grads'][o_leaf]).max()):.3e})")
    if not (rel <= L_LOSS_RTOL and grad <= L_GRAD_TOL and par <= 1.0
            and own <= 1.0 and steps <= L_STEPS_RTOL
            and len(got["losses"]) == len(want["losses"])):
        raise SystemExit(f"chip_smoke: {label}'s sharded run disagrees with "
                         f"the unsharded one")


L_K3_A_STEP = {"L1": 1, "L2": 2, "L3": 2}   # K(x, x); or K(z, z) and K(x, z)


def path_l_phase(torch, pl, ck, dev, totals):
    """Path L: the ('data', 'latent') mesh on ``torch.distributed``, 4
    ranks spawned with the kernels built once by this process (the ranks
    load the library). Ranks share the card over gloo when there are fewer
    cards than ranks, and take one each over NCCL otherwise. L1: F2's
    projected model on data 2 × latent 2 (each rank K3 (2, 10⁴, 10⁴) and
    potrf), 8 sharded steps against 8 unsharded ones on this card, the
    sharded cache and ``predict`` on 2,500 points; L2: I3's projected SGPR
    and L3: the variational ELBO at n = 44,484, both on data 4 × latent 1;
    L4: ``dryrun_multichip(4)``, a one-rank NCCL group's ``dryrun_step``,
    ``save_orbax``/``load_orbax`` under the 4-rank group. K3 at each new
    local shape against its plain version and bitwise K6."""
    import tempfile

    from projected_lmc_tpu_torch.entry import dryrun_multichip
    from projected_lmc_tpu_torch.module import keyed_state
    from projected_lmc_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    cases = l_cases(torch, pl, dev)
    refs = {}
    for label, case in cases.items():
        model, refs[label] = l_reference(torch, pl, case, dev, L_STEPS)
        ls = model.covar_module.lengthscale.detach()
        x = model.train_x
        lo, hi = 0, case["q"] // case["mesh"][1]
        r1 = x.shape[0] // case["mesh"][0]
        if label == "L1":
            x_test = torch.as_tensor(case["X_test"], device=dev)
            k3_shapes(torch, ck, dev, ((x, x), (x, x_test)), ls[lo:hi])
            with torch.no_grad():
                cache = model.prediction_cache()
                refs[label]["mean"], refs[label]["var"] = (
                    t.cpu().numpy() for t in model.predict(
                        x_test, observed=True, cache=cache))
                del cache
            refs[label]["state"] = {k: v.detach().cpu().numpy() for k, v in
                                    keyed_state(model).items()}
            refs[label]["prior_var"] = prior_var_max(torch, model, x_test)
        else:
            k3_shapes(torch, ck, dev, ((x[:r1], model.inducing_points
                                        .detach()),), ls[lo:hi])
        del model
        torch.cuda.empty_cache()
    print(f"  unsharded references on this card: " + ", ".join(
        f"{k} median step {float(np.median(r['ms'][1:])):.3f} ms, peak "
        f"{r['peak_gib']:.2f} GiB" for k, r in refs.items()))
    # path M runs in the same spawn: its kernels at a rank's shapes and its
    # unsharded references first, on this card
    m_case = m_cases(torch, pl, dev)
    m_rows = m_kernel_checks(torch, pl, ck, dev, m_case["M1"])
    m_refs = m_references(torch, pl, ck, dev, m_case)

    with tempfile.TemporaryDirectory(prefix="plmc_ckpt_") as tmp:
        spec = dict(cases, steps=L_STEPS, ckpt=os.path.join(tmp, "ckpt"),
                    M=m_case)
        t1 = time.perf_counter()
        out = run_ranks(path_l_rank, L_RANKS, (spec,), device=dev.type,
                        timeout=L_TIMEOUT, collective_timeout=300,
                        threads=max(1, (os.cpu_count() or 1) // L_RANKS))
        spawn_s = time.perf_counter() - t1
    backend = out[0]["backend"]
    note = "ranks sharing one card: not a speed-up" \
        if len({o["device"] for o in out}) < L_RANKS else "a card a rank"
    sec = out[0]["seconds"]
    print(f"  {L_RANKS} ranks over {backend} on "
          f"{sorted({o['device'] for o in out})} ({note}), {spawn_s:.1f} s: "
          f"start-up and rendezvous {spawn_s - sec['all']:.1f} s, then rank "
          f"0's L1 {sec['L1']:.1f} s (with its cache, predict and "
          f"checkpoint), L2 {sec['L2']:.1f} s, L3 {sec['L3']:.1f} s, each "
          f"with its groups and model; path M " + ", ".join(
              f"{k} {v:.1f} s" for k, v in out[0]["M"]["seconds"].items()))
    for label in ("L1", "L2", "L3"):
        want = refs[label]
        k3 = L_K3_A_STEP[label] * L_STEPS + (2 if label == "L1" else 0)
        for r, o in enumerate(out):
            got = o[label]
            l_held(f"{label} rank {r} mesh {got['mesh']}", got, want,
                   {k: cases[label]["arrays"]["." + k]
                    for k in want["params"]})
            if got["counts"] != expect(K3=k3):
                raise SystemExit(f"chip_smoke: {label} rank {r} launched "
                                 f"{got['counts']}, not K3 {k3} times")
            totals["K3"] += got["counts"]["K3"]
        meds = [float(np.median(o[label]["ms"][1:])) for o in out]
        print(f"  {label} step median, sharded by rank "
              + " / ".join(f"{m:.3f}" for m in meds)
              + f" ms ({note}); unsharded {float(np.median(want['ms'][1:])):.3f}"
              f" ms; peak memory by rank " + " / ".join(
                  f"{o[label]['peak_gib']:.2f}" for o in out)
              + f" GiB (unsharded {want['peak_gib']:.2f}); K3 {k3} a rank")
    ref = refs["L1"]
    x_test = torch.as_tensor(cases["L1"]["X_test"], device=dev)

    def rel_to(a, b, scale):
        return float(np.abs(a - b).max() / max(float(scale), 1e-30))

    for r, o in enumerate(out):
        got = o["L1"]
        lo, hi = got["latents"]
        mean_err = rel_to(got["mean"], ref["mean"], np.abs(ref["mean"]).max())
        var_err = rel_to(got["var"], ref["var"], ref["prior_var"])
        # the witness: the rank's latents against an unsharded model with
        # the rank's leaves restricted to the same latents (the same batch
        # shape), held; for the reading only, against rows lo..hi − 1 of
        # that model's whole batch, and the rank's leaves against the
        # unsharded run's after the 8 steps
        (w_mean, w_var), (b_mean, b_var) = l_witness(
            torch, pl, cases["L1"], got["state"], x_test, lo, hi)
        wit = (rel_to(got["own_mean"], w_mean, np.abs(w_mean).max()),
               rel_to(got["own_var"], w_var, np.abs(w_var).max()))
        whole = (rel_to(got["own_mean"], b_mean, np.abs(w_mean).max()),
                 rel_to(got["own_var"], b_var, np.abs(w_var).max()))
        drift = max(rel_to(v, ref["state"][k], np.abs(ref["state"][k]).max())
                    for k, v in got["state"].items() if v.size)
        print(f"  L1 rank {r} latents {got['latents']}: cache + predict "
              f"({len(got['mean'])} points) {got['serve_ms']:.3f} ms; mean "
              f"{mean_err:.2e} of its largest entry (1e-4), variance "
              f"{var_err:.2e} of the largest prior variance (1e-3); its "
              f"latents' mean and variance against the unsharded model "
              f"restricted to them {wit[0]:.2e}, {wit[1]:.2e} of their "
              f"largest entries ({L_WITNESS_TOL:.0e}), against those rows "
              f"of the whole batch {whole[0]:.2e}, {whole[1]:.2e}; its "
              f"leaves after {L_STEPS} steps {drift:.2e} of each leaf's "
              f"largest entry from the unsharded run's; checkpoint round "
              f"trip max diff {o['ckpt_max_diff']:.1e}")
        if not (mean_err <= 1e-4 and var_err <= 1e-3
                and max(wit) <= L_WITNESS_TOL
                and o["ckpt_max_diff"] == 0.0):
            raise SystemExit("chip_smoke: L1's sharded prediction or "
                             "checkpoint disagrees")

    print(f"path M: the LMC and ICM families under the mesh (the same "
          f"spawn), M1 the headline LMC n={N} on data {M1_MESHES[0][0]} x "
          f"latent {M1_MESHES[0][1]} and data {M1_MESHES[1][0]} x latent "
          f"{M1_MESHES[1][1]} ({M1_STEPS} steps), M2 the matrix-free ICM "
          f"n={N_H2} ({M2_STEPS} steps), M3 serving (\"lmc_iter\", "
          f"\"icm_iter\", the dense ICM n={N_M3}, M6's \"lmc\" and M10's "
          f"\"sgpr\"), M4 ExactGPModel n={N_B} ({M4_STEPS} steps), M5 "
          f"dryrun_multichip({L_RANKS}), M6 the dense Woodbury LMC n={N_M6} "
          f"({M6_STEPS} steps), M7 CG + SLQ n={N} ({M7_STEPS} steps), M8 the "
          f"int8 stack ({M8_STEPS} steps), M9 the \"kr\" and \"krs\" "
          f"routes ({M9_STEPS} steps each), M10 the LMC and ICM SGPR n={I3_N} "
          f"d={I_D} m={I_M} on data {M10_MESH[0]} x latent {M10_MESH[1]} "
          f"({M10_STEPS} steps each), M11 ExactGPModel's composed route "
          f"n={N} ({M11_STEPS} steps), M12 fit against sharded_fit_step "
          f"({M12_STEPS} steps)")
    path_m_check(torch, out, m_refs, m_case, totals, note)
    t1 = time.perf_counter()
    dryrun_multichip(L_RANKS, device=dev.type, timeout=L_TIMEOUT)
    dry_s = time.perf_counter() - t1
    one = l_one_rank(pl, ck, cases["L1"], dev)
    rel = abs(one["loss"] - refs["L1"]["losses"][0]) / abs(
        refs["L1"]["losses"][0])
    print(f"  L4/M5 dryrun_multichip({L_RANKS}) {dry_s:.1f} s; a one-rank "
          f"{one['backend']} group's dryrun_step on L1's model: loss "
          f"{one['loss']:.6f}, rel {rel:.2e} from the unsharded step "
          f"({L_LOSS_RTOL:.0e}), launches {one['counts']}")
    if not rel <= L_LOSS_RTOL or one["counts"] != expect(K3=1):
        raise SystemExit("chip_smoke: the one-rank group's step disagrees")
    totals["K3"] += one["counts"]["K3"]
    print(f"  paths L and M took {time.perf_counter() - t0:.1f} s")
    return m_rows


def path_m_phase(torch, pl, ck, dev, totals):
    """Path M alone (``chip_smoke.py --only M``): its kernels at a rank's
    shapes and its unsharded references on this card, then one spawn of
    path L's ranks with path M's spec alone, held by :func:`path_m_check`.
    Returns :func:`m_kernel_checks`'s rows."""
    from projected_lmc_tpu_torch.parallel.launch import run_ranks
    t0 = time.perf_counter()
    m_case = m_cases(torch, pl, dev)
    m_rows = m_kernel_checks(torch, pl, ck, dev, m_case["M1"])
    m_refs = m_references(torch, pl, ck, dev, m_case)
    out = run_ranks(path_l_rank, L_RANKS, (dict(M=m_case),),
                    device=dev.type, timeout=L_TIMEOUT, collective_timeout=300,
                    threads=max(1, (os.cpu_count() or 1) // L_RANKS))
    note = "ranks sharing one card: not a speed-up" \
        if len({o["device"] for o in out}) < L_RANKS else "a card a rank"
    print(f"  {L_RANKS} ranks over {out[0]['backend']}; path M " + ", ".join(
        f"{k} {v:.1f} s" for k, v in out[0]["M"]["seconds"].items()))
    path_m_check(torch, out, m_refs, m_case, totals, note)
    print(f"  path M took {time.perf_counter() - t0:.1f} s")
    return m_rows


# -- path M: the LMC and ICM families under the mesh ---------------------------

M1_MESHES = ((2, 2), (4, 1))             # (data, latent): M1's two layouts
M_MESH = (2, 2)                          # M2–M4 (the ICM's rows split over
                                         # every rank on either layout)
M1_STEPS, M2_STEPS, M4_STEPS = 8, 4, 4
N_M3 = 4_096                             # M3's dense ICM (≤ ICM_DENSE_N_MAX)
N_M6 = 1_024                             # M6: q·n = 4,096 = DENSE_QN_MAX
M6_STEPS, M7_STEPS, M8_STEPS, M9_STEPS = 4, 2, 4, 4
M10_STEPS, M11_STEPS, M12_STEPS = 4, 4, 8
M10_MESH = (4, 1)                        # the SGPR rows split over every rank
M9_ROUTES = ("kr", "krs")
M_R = 2 * MLL_KW["num_probes"] + 1       # the fused backward's factor rank
# the CG estimator's fp32 gradient limit, card against CPU (phase 3, path H)
M_CG_GRAD_TOL = 2e-3


def _m_model(pl, case, device):
    """A path-M model on ``device`` (M1 the headline LMC, M2/M3 the ICM, M4
    path B's ``ExactGPModel``), carrying the case's leaves once
    :func:`m_cases` has set them."""
    X, Y = case["X"], case["Y"]
    if case["kind"] == "lmc":
        model = make_model(pl, X, Y, device)
    elif case["kind"] == "icm":
        model = icm_model(pl, X, Y, device)
    elif case["kind"].startswith("sgpr"):
        model = sgpr_models(pl, X, Y, device, I_M)[case["kind"][5:]]
    else:
        # path B's ExactGPModel; M11's with J1's additive kernel
        model = pl.ExactGPModel(X, Y, pl.GaussianLikelihood(
            batch_shape=T, device=device), n_tasks=T, kernel_type="matern",
            outputscales=True, device=device,
            **(dict(decomp=J_DECOMP) if case["kind"] == "exact_add" else {}))
    if "arrays" in case:
        pl.load_jax_state(model, case["arrays"])
    return model


def m_cases(torch, pl, dev):
    """Path M's configurations, each a dict a rank can rebuild, the leaves
    moved off the init (uniform(−0.3, 0.3)): M1 the headline LMC (n = 10⁴,
    T = 7, q = 4, d = 4), M2 H2's matrix-free ICM (n = 16,384), M3 the dense
    ICM at n = 4,096, M4 path B's ``ExactGPModel`` (n = 16,384, T = 7)."""
    from projected_lmc_tpu_torch.module import keyed_state
    X, Y = bench_data(N, seed=0)
    cases = {"M1": dict(kind="lmc", X=X, Y=Y, steps=M1_STEPS,
                        X_test=bench_data(N_TEST, seed=5)[0])}
    X, Y = bench_data(N_H2, seed=0)
    cases["M2"] = dict(kind="icm", X=X, Y=Y, steps=M2_STEPS,
                       X_test=bench_data(N_TEST, seed=20)[0])
    X, Y = bench_data(N_M3, seed=2)
    cases["M3"] = dict(kind="icm", X=X, Y=Y, steps=0,
                       X_test=bench_data(N_TEST, seed=21)[0])
    X, Y = bench_data(N_B, seed=5)
    cases["M4"] = dict(kind="exact", X=X, Y=Y, steps=M4_STEPS)
    X, Y = bench_data(N_M6, seed=6)
    cases["M6"] = dict(kind="lmc", X=X, Y=Y, steps=M6_STEPS, mll={},
                       X_test=bench_data(N_TEST, seed=23)[0])
    X, Y = bench_data(I3_N, seed=7, d=I_D)
    Xt = bench_data(N_TEST, seed=24, d=I_D)[0]
    for name in ("LMC", "ICM"):
        cases[f"M10 {name}"] = dict(kind=f"sgpr_{name}", X=X, Y=Y,
                                    steps=M10_STEPS, mll={}, X_test=Xt,
                                    mesh=M10_MESH)
    X, Y = bench_data(N, seed=8)
    cases["M11"] = dict(kind="exact_add", X=X, Y=Y, steps=M11_STEPS)
    for seed, case in enumerate(cases.values(), 30):
        model = moved(torch, _m_model(pl, case, dev), seed)
        case["arrays"] = {k: v.detach().cpu().numpy()
                          for k, v in keyed_state(model).items()}
        del model
    # M7–M9 and M12 train M1's model: CG + SLQ at mll()'s defaults (J2's
    # route), path C's int8 stack, and M1's step on the "kr" and "krs"
    # backward routes
    cases["M7"] = dict(cases["M1"], steps=M7_STEPS, mll={})
    cases["M8"] = dict(cases["M1"], steps=M8_STEPS, mll=INT8_KW)
    for route in M9_ROUTES:
        cases[f"M9 {route}"] = dict(cases["M1"], steps=M9_STEPS, route=route)
    torch.cuda.empty_cache()
    return cases


def m_train(torch, pl, ck, case, dev, mesh=None):
    """``case["steps"]`` AdamW(1e-2, weight decay 1e-2) steps of the case's
    MLL (:func:`m_loss`), sharded over ``mesh`` by ``sharded_fit_step`` or
    unsharded, the probes drawn from a generator seeded 0, under the
    case's backward ``route`` if it names one; the launch counts set to 0
    just before and read just after. Returns (model, step, the run's
    record)."""
    from projected_lmc_tpu_torch import parallel
    from projected_lmc_tpu_torch.module import trainable_parameters
    with (routed(case["route"]) if "route" in case
          else contextlib.nullcontext()):
        model = _m_model(pl, case, dev)
        if mesh is not None:
            parallel.shard_model(model, mesh)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts(ck)
        loss_fn = m_loss(torch, case, model, gen, mesh)
        if mesh is not None:
            step, model, _ = parallel.sharded_fit_step(model, mesh, loss_fn)
        else:
            opt = torch.optim.AdamW(
                [p for _, p in trainable_parameters(model)], lr=1e-2,
                weight_decay=1e-2)

            def step():
                opt.zero_grad(set_to_none=False)
                loss = -loss_fn(model)
                loss.backward()
                opt.step()
                return loss.detach()
        res = _l_train(torch, model, step, case["steps"],
                       trainable_parameters(model))
        res.update(counts=read_counts(ck), peak_gib=_peak_gib(torch, dev))
    return model, step, res


def m_loss(torch, case, model, gen, mesh=None):
    """The case's MLL, ``case["mll"]`` (``MLL_KW`` unless given), the probes
    drawn from ``gen``; on the LMC's and ICM's PCG routes with the Nyström
    roots built once (from the rank's rows under ``mesh``), as a 16-step
    chunk does; the exact model rebuilds its own at every call, as path
    B."""
    kw = case.get("mll", MLL_KW)
    if case["kind"] not in ("lmc", "icm") or not kw.get("precond_rank"):
        return lambda m: m.mll(generator=gen, **kw)
    rows = None if mesh is None else model._rows(model.train_x.shape[0])
    with torch.no_grad():
        roots = model._precond_roots(model.train_x, kw["precond_rank"],
                                     rows=rows)
    return lambda m: m.mll(precond_roots=roots, generator=gen, **kw)


def m_allreduce(torch, mesh, step):
    """One more step with every world sum of the solvers (``world_sum_``)
    and every forward one of the SGPR's partial sums (``world_sum``; its
    backward's is not seen) timed on the host around a synchronize: (that
    step's ms, the sums' ms, their number)."""
    spans = []

    def timed_sum(own):
        def call(x):
            out, ms = timed(torch, lambda: own(x))
            spans.append(ms)
            return out
        return call

    names = ("world_sum_", "world_sum")
    for name in names:
        setattr(mesh, name, timed_sum(getattr(mesh, name)))
    try:
        _, ms = timed(torch, lambda: float(step()))
    finally:
        for name in names:
            delattr(mesh, name)
    return dict(sum_step_ms=ms, sum_ms=float(sum(spans)), sums=len(spans))


# (the cache's name, the case, the start vector's columns)
M_SERVED = (("lmc_iter", "M1", T), ("icm_iter", "M2", 1), ("icm", "M3", 0),
            ("lmc", "M6", 0), ("sgpr LMC", "M10 LMC", 0),
            ("sgpr ICM", "M10 ICM", 0))


def m_serve(torch, pl, ck, cases, dev, mesh=None):
    """M3, sharded over ``mesh`` or not: the "lmc_iter" cache and
    ``posterior`` at M1's model, the "icm_iter" cache, ``posterior`` and
    ``compute_var`` at M2's, and at M3's the dense ICM MLL with its
    gradients (averaged over the ranks), the "icm" cache, ``posterior`` and
    ``compute_var``; M6's dense "lmc" cache and M10's "sgpr" caches (LMC,
    ICM) with their ``posterior``; on 2,500 test points, the start vectors
    and the ``compute_var`` draws seeded alike. Each part's launch
    counts."""
    from projected_lmc_tpu_torch import parallel
    out = {}
    for name, label, c in M_SERVED:
        case = cases[label]
        model = _m_model(pl, case, dev)
        if mesh is not None:
            parallel.shard_model(model, mesh)
        n = model.train_x.shape[0]
        kw = {} if not c else dict(v0=torch.as_tensor(
            np.random.default_rng(40).standard_normal((n, c)),
            dtype=torch.float32, device=dev))
        x = torch.as_tensor(case["X_test"], device=dev)
        zero_counts(ck)
        with torch.no_grad():
            cache, cache_ms = timed(torch,
                                    lambda: model.precompute_posterior(**kw))
            pred, pred_ms = timed(torch, lambda: model.posterior(x,
                                                                 cache=cache))
            r = dict(kind=cache["kind"], mean=pred.mean.cpu().numpy(),
                     var=pred.variance.cpu().numpy(), cache_ms=cache_ms,
                     pred_ms=pred_ms)
            if model.icm and not model.sgpr:
                torch.manual_seed(41)
                var, r["var_ms"] = timed(torch, lambda: model.compute_var(x))
                r["compute_var"] = var.cpu().numpy()
        r["counts"] = read_counts(ck)
        r["prior_var"] = prior_var_max(torch, model, x)
        if name == "icm":
            zero_counts(ck)
            params = [(k, p) for k, p in model.named_parameters()
                      if p.requires_grad]
            loss, r["mll_ms"] = timed(torch, lambda: model.mll())
            loss.backward()
            grads = [p.grad for _, p in params]
            if mesh is not None:
                mesh.average_(grads)
            r.update(loss=float(loss.detach()), grads={
                k: g.cpu().numpy() for (k, _), g in zip(params, grads)},
                mll_counts=read_counts(ck))
        out[name] = r
        del model, cache, pred
        torch.cuda.empty_cache()
    return out


def m_layouts(label, cases):
    """The (data, latent) layouts a path-M case runs on."""
    if label == "M1":
        return M1_MESHES
    return (cases[label].get("mesh", M_MESH),)


def m_fit(torch, pl, ck, case, dev, mesh):
    """M12: ``training.fit`` (``M12_STEPS`` steps in one chunk, a constant
    learning rate of 1e-2, weight decay 1e-2) on M1's model sharded over
    ``mesh``, then ``M12_STEPS`` steps of ``sharded_fit_step`` (the same
    AdamW) from the same leaves; the probes from a generator seeded 0 and
    the roots built once, each run alike. Each run's losses, final leaves
    and launch counts (set to 0 just before the run, read just after)."""
    from projected_lmc_tpu_torch import parallel
    from projected_lmc_tpu_torch.module import keyed_state
    out = {}
    for name in ("fit", "step"):
        model = parallel.shard_model(_m_model(pl, case, dev), mesh)
        gen = torch.Generator(device=dev).manual_seed(0)
        zero_counts(ck)
        loss_fn = m_loss(torch, case, model, gen, mesh)
        t0 = time.perf_counter()
        if name == "fit":
            _, info = pl.fit(model, loss_fn, n_iter=M12_STEPS,
                             schedule=lambda i: 1e-2, scan_steps=M12_STEPS,
                             device=dev)
            losses = [float(v) for v in info["losses"]]
        else:
            step, model, _ = parallel.sharded_fit_step(model, mesh, loss_fn)
            losses = [float(step()) for _ in range(M12_STEPS)]
        torch.cuda.synchronize(dev)
        out[name] = dict(losses=losses, counts=read_counts(ck),
                         seconds=time.perf_counter() - t0,
                         leaves={k: v.detach().cpu().numpy() for k, v in
                                 keyed_state(model).items()})
        del model
    torch.cuda.empty_cache()
    return out


def path_m_rank(torch, pl, ck, cases, dev):
    """One rank's path M (in path L's spawn): M1 on both layouts, M2, M4,
    M6–M9 and M11 on data 2 × latent 2 and M10 on data 4 × latent 1, each
    a ``sharded_fit_step`` run with the launch counts set to 0 just before
    and read just after, then a step with its world sums timed; M12's
    ``fit`` and ``sharded_fit_step``; M3's sharded serving."""
    from projected_lmc_tpu_torch import parallel
    out, seconds = {}, {}
    for label in ("M1", "M2", "M4") + M_NEW:
        for layout in m_layouts(label, cases):
            t1 = time.perf_counter()
            mesh = parallel.make_mesh(L_RANKS, data=layout[0],
                                      latent=layout[1])
            model, step, res = m_train(torch, pl, ck, cases[label], dev,
                                       mesh)
            with (routed(cases[label]["route"]) if "route" in cases[label]
                  else contextlib.nullcontext()):
                res.update(m_allreduce(torch, mesh, step),
                           mesh=dict(mesh.shape))
            out[(label, layout)] = res
            del model, step
            torch.cuda.empty_cache()
            seconds[f"{label} {layout}"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["M12"] = m_fit(torch, pl, ck, cases["M1"], dev, parallel.make_mesh(
        L_RANKS, data=M_MESH[0], latent=M_MESH[1]))
    seconds["M12"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["M3"] = m_serve(torch, pl, ck, cases, dev, parallel.make_mesh(
        L_RANKS, data=M_MESH[0], latent=M_MESH[1]))
    seconds["M3"] = time.perf_counter() - t1
    out["seconds"] = seconds
    return out


def k7_rows_bound(q, n1, n2, d, r):
    """K7's row-block form's least time: K7's per-pair count over the
    block's q·n1·n2 ordered pairs, and its inputs and outputs once."""
    io = q * (n1 + n2) * r * 4 + (n1 + n2) * d * 4 + q * n1 * (1 + d) * 4
    return bound_ms(io, q * n1 * n2 * (2 * r + 3 * d + 7 + (1 + 2 * d)))


def m_kernel_checks(torch, pl, ck, dev, case):
    """The kernels at a rank's shapes on M1's two layouts (rank 0's block):
    K6's (q_l, n_l, n) bf16 block bitwise the rows of K1's stack and
    against its plain version; K7's row-block form (r = 17) against its
    plain version at K7's phase-2 limit, bitwise on a repeat and bitwise
    those rows of K7's square call (each row's sum runs over the same
    column tiles in the same order), timed beside its plain version with
    its bound; K3 at the rank's roots block; at the first layout's block,
    M8's K8 block and M9's row-block K4 and K5 (:func:`m_kr_rows_checks`).
    Returns the kernel-line rows of K7's, K4's and K5's row-block forms
    (``K7r``, ``K4r``, ``K5r``) at M1's (2, 5,000, 10⁴) block."""
    from projected_lmc_tpu_torch.parallel.mesh import Mesh
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,      # noqa: E731
                                  device=dev)
    model = _m_model(pl, case, dev)
    x = model.train_x
    xc = x - x.mean(0)
    ls = model.covar_module.lengthscale.detach()
    os_ = torch.ones(Q, dtype=torch.float32, device=dev)
    del model
    full = ck.scaled_kernel_stack_sym(xc, ls, os_, KIND, torch.bfloat16,
                                      device=dev)
    rng = np.random.default_rng(44)
    A, Bf = symmetric_factors(rng, t, N, M_R)
    k7 = None
    for data, latent in M1_MESHES:
        mesh = Mesh(data, latent, 0)
        lo, hi = mesh.latent_range(Q)
        r0, r1 = mesh.data_range(N)
        shape = f"({hi - lo},{r1 - r0},{N})"
        block = ck.scaled_kernel_stack(xc[r0:r1], xc, ls[lo:hi], os_[lo:hi],
                                       KIND, torch.bfloat16, device=dev)
        same = torch.equal(block, full[lo:hi, r0:r1])
        err, top = stack_error(torch, ck, block, xc[r0:r1], ls[lo:hi],
                               os_[lo:hi], torch.bfloat16, x2=xc)
        print(f"  M K6 block {shape} bf16 bitwise the rows of K1's stack: "
              f"{same}")
        check(f"M K6 scaled_kernel_stack {shape} bf16", err, 2.0 ** -7 * top)
        if not same:
            raise SystemExit("chip_smoke: the rank's K6 block is not the rows "
                             "of K1's stack")
        del block
        args = (xc, ls[lo:hi].contiguous(), A[lo:hi, r0:r1].contiguous(),
                Bf[lo:hi].contiguous(), KIND)
        run = lambda: ck.lowrank_stationary_reduce(              # noqa: E731
            *args, device=dev, row_x=xc[r0:r1])
        got, rep = run(), run()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, rep))
        want = m_rows_plain(torch, ck, xc[r0:r1], *args)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        square = ck.lowrank_stationary_reduce(
            xc, ls[lo:hi].contiguous(), A[lo:hi].contiguous(), args[3], KIND,
            device=dev)
        rows_of = all(torch.equal(g, w[:, r0:r1])
                      for g, w in zip(got, square))
        del square
        print(f"  M K7 row-block form {shape} r={M_R} repeat bitwise equal: "
              f"{bitwise}; bitwise those rows of K7's square call: "
              f"{rows_of}")
        if not rows_of:
            raise SystemExit("chip_smoke: K7's row-block form is not the "
                             "rows of its square call")
        check(f"M K7 lowrank_stationary_reduce(row_x=) {shape} r={M_R}", err,
              1e-4 * max(float(w.abs().max()) for w in want))
        if not bitwise:
            raise SystemExit("chip_smoke: K7's row-block form is not "
                             "deterministic")
        del got, rep, want
        if (data, latent) == M1_MESHES[0]:
            k7 = dict(max_abs_err=err, ms=cuda_ms(run, reps=10),
                      plain_ms=cuda_ms(lambda: m_rows_plain(
                          torch, ck, xc[r0:r1], *args), reps=2, warmup=1),
                      bound=k7_rows_bound(hi - lo, r1 - r0, N, D, M_R),
                      shape=shape)
            print(f"  M K7 row-block form {shape}: {k7['ms']:.4f} ms, plain "
                  f"{k7['plain_ms']:.3f} ms, bound {k7['bound'][0]:.4f} ms "
                  f"({k7['bound'][1]})")
            rows = m_kr_rows_checks(torch, ck, t, rng, xc, ls, lo, hi, r0,
                                    r1, A, Bf)
            m_k8_block_check(torch, ck, xc, ls, lo, hi, r0, r1)
        idx = np.linspace(0, N - 1, MLL_KW["precond_rank"]).astype(np.int64)
        k3_shapes(torch, ck, dev, ((x[r0:r1], x[idx]),), ls[lo:hi])
        torch.cuda.empty_cache()
    del full
    torch.cuda.empty_cache()
    rows["K7r"] = k7
    return rows


def kr_rows_bounds(q, n1, n2, d, r):
    """K4's and K5's row-block forms' least times: K7's per-pair count over
    the block's q·n1·n2 ordered pairs plus one KA multiply-add a pair at the
    tensor cores' bf16 rate (the function's one product, as the square
    bound counts it); K5's without the exp and with the bf16 block read.
    Inputs (x1, x2, l, os, Bf's rows, A's columns) and outputs (rows, wx,
    KA) once."""
    pairs = q * n1 * n2
    io = q * (n1 + n2) * r * 4 + (n1 + n2) * d * 4 + q * (d + 1) * 4 \
        + q * n1 * (1 + d + r) * 4
    ops = 2 * r + 3 * d + 7 + (1 + 2 * d)
    return (bound_ms(io, pairs * ops, pairs * 2 * r),
            bound_ms(io + pairs * 2, pairs * (ops - 1), pairs * 2 * r))


def m_kr_rows_checks(torch, ck, t, rng, xc, ls, lo, hi, r0, r1, A, Bf):
    """M9's kernels at rank 0's block of M1's data 2 × latent 2 layout,
    (2, 5,000, 10⁴), r = 17, os ≠ 1: K4's row-block form, and K5's on the
    rank's bf16 K6 block, each against its plain version at K4's phase-2
    limits (``check_kr``), bitwise on a repeat, timed by CUDA events beside
    its plain version, with its bound. Returns their kernel-line rows."""
    os_ = t(rng.uniform(0.5, 2.0, Q))
    lsl, osl = ls[lo:hi].contiguous(), os_[lo:hi].contiguous()
    args = (xc[r0:r1], xc, lsl, osl, Bf[lo:hi, r0:r1].contiguous(),
            A[lo:hi].contiguous())
    block = ck.scaled_kernel_stack(xc[r0:r1], xc, lsl, osl, KIND,
                                   torch.bfloat16, device=xc.device)
    shape = f"({hi - lo},{r1 - r0},{N})"
    bounds = kr_rows_bounds(hi - lo, r1 - r0, N, D, M_R)
    rows = {}
    for key, Ks, bound in (("K4r", None, bounds[0]),
                           ("K5r", block, bounds[1])):
        extra = () if Ks is None else (Ks,)
        fn = ck.lowrank_stationary_reduce_rows_kr if Ks is None \
            else ck.lowrank_stationary_reduce_rows_krs
        run = lambda: fn(*args, *extra, KIND, device=xc.device)  # noqa: E731

        def plain(b=1250):
            """The plain version a block of rows at a time."""
            parts = []
            plain_fn = ck.lowrank_stationary_reduce_rows_kr_plain \
                if Ks is None else ck.lowrank_stationary_reduce_rows_krs_plain
            for i0 in range(0, r1 - r0, b):
                sub = (args[0][i0:i0 + b],) + args[1:4] + (
                    args[4][:, i0:i0 + b],) + args[5:]
                parts.append(plain_fn(*sub, *(() if Ks is None else (
                    Ks[:, i0:i0 + b],)), KIND))
            return tuple(torch.cat(p, 1) for p in zip(*parts))

        got, again = run(), run()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"  M {key} row-block form {shape} r={M_R} repeat bitwise "
              f"equal: {bitwise}")
        if not bitwise:
            raise SystemExit(f"chip_smoke: {key} is not deterministic")
        err = check_kr(f"M {key} {shape} r={M_R}", got, plain())
        del got, again
        rows[key] = dict(max_abs_err=err, ms=cuda_ms(run, reps=10),
                         plain_ms=cuda_ms(plain, reps=1, warmup=1),
                         bound=bound, shape=shape)
        print(f"  M {key} row-block form {shape}: {rows[key]['ms']:.4f} ms, "
              f"plain {rows[key]['plain_ms']:.3f} ms, bound "
              f"{bound[0]:.4f} ms ({bound[1]})")
        torch.cuda.empty_cache()
    del block
    m_kr_rows_branches(torch, ck, t, rng)
    return rows


# (d, n1, n2) of the row-block K4/K5 branches M1's block does not reach:
# d = 21 at the padded width 32, 16-byte loads of bf16 and fp32 blocks;
# n1 below one tile, n2 % 8 = 5 (element loads of both); n2 % 8 = 4 (fp32
# rows on 16 bytes, bf16 rows not)
M_KR_BRANCHES = ((21, 1000, 2000), (4, 37, 1237), (3, 100, 1236))


def m_kr_rows_branches(torch, ck, t, rng):
    """K4's and K5's row-block forms on ``M_KR_BRANCHES``, q = 2, r = 17,
    os ≠ 1, K5 on a bf16 and on an fp32 K6 block: each against its plain
    version (``check_kr``) and bitwise on a repeat."""
    q = 2
    for d, n1, n2 in M_KR_BRANCHES:
        x2 = t(rng.standard_normal((n2, d)))
        x1 = t(rng.standard_normal((n1, d)))
        ls = t(rng.uniform(0.5, 2.0, (q, 1, d)))
        os_ = t(rng.uniform(0.5, 2.0, q))
        A, Bf = (t(rng.standard_normal((q, n, M_R))) for n in (n2, n1))
        args = (x1, x2, ls, os_, Bf, A)
        runs = [("K4r", None)] + [
            (f"K5r {str(dt)[6:]} block", ck.scaled_kernel_stack(
                x1, x2, ls, os_, KIND, dt, device=x1.device))
            for dt in (torch.bfloat16, torch.float32)]
        for label, Ks in runs:
            if Ks is None:
                run = lambda: ck.lowrank_stationary_reduce_rows_kr(  # noqa
                    *args, KIND, device=x1.device)
                want = ck.lowrank_stationary_reduce_rows_kr_plain(*args,
                                                                   KIND)
            else:
                run = lambda: ck.lowrank_stationary_reduce_rows_krs(  # noqa
                    *args, Ks, KIND, device=x1.device)
                want = ck.lowrank_stationary_reduce_rows_krs_plain(
                    *args, Ks, KIND)
            got, again = run(), run()
            shape = f"({q},{n1},{n2}) d={d}"
            bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"  M {label} row-block form {shape} repeat bitwise "
                  f"equal: {bitwise}")
            if not bitwise:
                raise SystemExit(f"chip_smoke: {label} is not deterministic")
            check_kr(f"M {label} {shape} r={M_R}", got, want)
            del got, again, want
        del runs
        torch.cuda.empty_cache()


def m_k8_block_check(torch, ck, xc, ls, lo, hi, r0, r1):
    """M8's K8 block, the rank's rows (x[r0:r1], x) padded to the int8
    product's shape: bitwise those rows of the whole symmetric stack with
    zero padding, and against its plain version (``check_counts``)."""
    from projected_lmc_tpu_torch.ops import iterative as it
    lsl, nl = ls[lo:hi].contiguous(), r1 - r0
    pad = (it.int8_width(nl), it.int8_width(N))
    block = ck.quantized_kernel_stack(xc[r0:r1], xc, lsl, KIND, padded_to=pad,
                                      device=xc.device)
    whole = ck.quantized_kernel_stack(xc, xc, lsl, KIND,
                                      padded_to=(it.int8_width(N),) * 2,
                                      device=xc.device)
    same = torch.equal(block[:, :nl, :N], whole[:, r0:r1, :N]) and not bool(
        block[:, nl:].any() or block[..., N:].any())
    del whole
    shape = f"({hi - lo},{nl},{N}) padded to {pad}"
    print(f"  M K8 block {shape} bitwise the rows of the symmetric stack, "
          f"zero padded: {same}")
    if not same:
        raise SystemExit("chip_smoke: the rank's K8 block is not the rows of "
                         "the symmetric stack")
    plain = torch.cat([ck.quantized_kernel_stack_plain(
        xc[r0 + i:min(r0 + i + 1250, r1)], xc, lsl, KIND)
        for i in range(0, nl, 1250)], 1)
    check_counts(f"M K8 quantized_kernel_stack {shape}", block[:, :nl, :N],
                 plain)
    del block, plain
    torch.cuda.empty_cache()


def m_rows_plain(torch, ck, x1, x2, ls, A, Bf, kind, block=1250):
    """K7's row-block plain version a block of rows at a time (its formula
    forms a (q, rows, n, d) array)."""
    rows, wx = [], []
    for i0 in range(0, x1.shape[0], block):
        r, w = ck.lowrank_stationary_reduce_rows_plain(
            x1[i0:i0 + block], x2, ls, A[:, i0:i0 + block], Bf, kind)
        rows.append(r)
        wx.append(w)
    return torch.cat(rows, 1), torch.cat(wx, 1)


@contextlib.contextmanager
def blocked_products(torch, data, latent):
    """One process computing the stack's products as the ranks of a (data,
    latent) mesh do: each product (``iterative._stack_matmul``, the ICM's
    ``_kernel_product``) as one call a rank's block, of the block's shape
    (cuBLAS picks its order of summation, split-K or not, from the shape),
    and the ICM's K built a rank's rows at a time (``rows=``), and
    ``ExactGPModel``'s composed stack a rank's block at a time, so that
    K3's backward (and a Scale kernel's bf16 sum) runs on each block apart.
    A witness of the sharded runs' plumbing: the same arithmetic, no
    mesh."""
    from projected_lmc_tpu_torch.models.exact import ExactGPModel
    from projected_lmc_tpu_torch.models.multitask import MultitaskGPModel
    from projected_lmc_tpu_torch.ops import iterative as it
    from projected_lmc_tpu_torch.parallel.mesh import Mesh
    meshes = [Mesh(data, latent, r) for r in range(data * latent)]
    own = (it._stack_matmul, it._kernel_product, MultitaskGPModel._block,
           ExactGPModel._block)

    def stack_matmul(Ks, W):
        single = W.dim() == 2
        Wt = W[None] if single else W                       # (r, n, q)
        q, n = Ks.shape[0], Ks.shape[1]
        out = Wt.new_zeros(Wt.shape[:-2] + (n, q), dtype=torch.float32
                           if Ks.dtype == torch.bfloat16 else Wt.dtype)
        for m in meshes:
            (lo, hi), (r0, r1) = m.latent_range(q), m.data_range(n)
            out[..., r0:r1, lo:hi] = own[0](
                Ks[lo:hi, r0:r1].contiguous(), Wt[..., lo:hi])
        return out[0] if single else out

    def kernel_product(K, V):
        n = K.shape[0]
        return torch.cat([own[1](K[r0:r1].contiguous(), V) for r0, r1 in
                          (m.world_range(n) for m in meshes)], -2)

    def block(self, x, rows, **kw):
        if rows is not None or not self.icm:
            return own[2](self, x, rows, **kw)
        n = x.shape[0]
        return torch.cat([self.covar_module(x, x, rows=m.world_range(n), **kw)
                          for m in meshes], -2)

    def exact_block(self, x, rows, **kw):
        if rows is not None:
            return own[3](self, x, rows, **kw)
        n, T = x.shape[0], self.n_funcs
        return torch.cat([torch.cat([
            own[3](self, x, m.row_block(n, T), **kw) for m in meshes
            if m.latent_index == li], -2) for li in range(latent)], 0)

    it._stack_matmul, it._kernel_product = stack_matmul, kernel_product
    MultitaskGPModel._block, ExactGPModel._block = block, exact_block
    try:
        yield
    finally:
        it._stack_matmul, it._kernel_product = own[:2]
        MultitaskGPModel._block, ExactGPModel._block = own[2:]


M_NEW = ("M6", "M7", "M8") + tuple(f"M9 {r}" for r in M9_ROUTES) + (
    "M10 LMC", "M10 ICM", "M11")


def m_references(torch, pl, ck, dev, cases):
    """Path M's unsharded runs on this card (not counted): M1, M2, M4 and
    M6–M11's steps, M12's ``fit`` on a one-rank mesh and M3's serving. The fused cases (M1, M4) run on the full grid
    (``PLMC_SYM_BUILD=0``: K6 and K7), the kernels the sharded op runs on
    its blocks; and on the default route (K1 and K2), for the reading
    :func:`path_m_check` prints. M2 and M4 also with the products of
    :func:`blocked_products` on their mesh, the witness their sharded runs
    are held to bit for bit (M1's products give the same bits at its
    blocks' shapes)."""
    refs = {}
    for label in ("M1", "M2", "M4"):
        fused = cases[label]["kind"] != "icm"
        runs = [(label, "full" if fused else "default", False)]
        if fused:
            runs.append((label + " default", "default", False))
        if label != "M1":
            runs.append((label + " blocked", runs[0][1], True))
        for key, route, blocked in runs:
            with routed(route), (blocked_products(torch, *M_MESH) if blocked
                                 else contextlib.nullcontext()):
                model, _, refs[key] = m_train(torch, pl, ck, cases[label],
                                              dev)
            del model
            torch.cuda.empty_cache()
    # M6–M11: the plain unsharded run; M7 and M11 (a fp32 Jacobi CG and a
    # bf16 composed stack) also with their products blocked as the ranks',
    # M8 on the full grid (K7 in the backward, as the ranks' int8 stack),
    # M9 on a one-rank mesh in this process (the row-block K4 and K5 on the
    # whole stack), their witnesses
    from projected_lmc_tpu_torch import parallel
    for label in M_NEW:
        case = cases[label]
        with routed("full") if label == "M8" else contextlib.nullcontext():
            model, _, refs[label] = m_train(torch, pl, ck, case, dev)
        del model
        if label in ("M7", "M11"):
            with blocked_products(torch, *M_MESH):
                model, _, refs[label + " witness"] = m_train(
                    torch, pl, ck, case, dev)
            del model
        if label.startswith("M9"):
            model, _, refs[label + " witness"] = m_train(
                torch, pl, ck, case, dev, parallel.make_mesh(1))
            del model
        torch.cuda.empty_cache()
    refs["M12"] = m_fit(torch, pl, ck, cases["M1"], dev,
                        parallel.make_mesh(1))
    refs["M3"] = m_serve(torch, pl, ck, cases, dev)
    print(f"  path M unsharded references on this card: " + ", ".join(
        f"{k} median step {float(np.median(refs[k]['ms'][1:])):.3f} ms, "
        f"peak {refs[k]['peak_gib']:.2f} GiB" for k in refs
        if k not in ("M3", "M12"))
        + " (M1, M4 and M8 on the full grid, M1 and M4 also on the default "
        "route; M2, M4, M7 and M11 also with their products blocked as the "
        "ranks' are; M9 also on a one-rank mesh)")
    return refs


def _m_against(got, want):
    """(first loss rel, worst gradient of its leaf's largest entry, worst
    loss rel) of a run against another."""
    rel = abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])
    grad = max(float(np.abs(got["grads"][k] - g).max()
                     / max(np.abs(g).max(), 1e-30))
               for k, g in want["grads"].items() if g.size)
    steps = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                    want["losses"]))
    return rel, grad, steps


M_COUNTS = {"M1": lambda s: expect(K6=s, K7=s, K3=2),
            "M2": lambda s: expect(K3=s + 2),
            "M4": lambda s: expect(K6=s, K7=s, K3=2 * s),
            "M6": lambda s: expect(K3=s),
            "M7": lambda s: expect(K3=s),
            "M8": lambda s: expect(K8=s, K7=s, K3=2),
            "M9 kr": lambda s: expect(K6=s, K4r=s, K3=2),
            "M9 krs": lambda s: expect(K6=s, K5r=s, K3=2),
            # K(z, z) and the rank's rows of K(x, z)
            "M10 LMC": lambda s: expect(K3=2 * s),
            "M10 ICM": lambda s: expect(K3=2 * s),
            # each additive group: K(z, z), the rows of K(x, z), the block
            "M11": lambda s: expect(K3=6 * s)}
# held bitwise against their witness: the same arithmetic on every rank
M_BITWISE = ("M1", "M8") + tuple(f"M9 {r}" for r in M9_ROUTES)
# against the plain run, the later losses' limit where it is not path L's
# L_STEPS_RTOL: M11's Scale kernels sum their outputscale gradients over the
# bf16 stack in bf16, so the plain run and the blocked witness (bitwise the
# sharded run) part by 5.69e-4 in the losses once AdamW has taken those
# gradients (an H100 80GB HBM3 at 700 W, PERF.md §6); held at the CG
# estimator's gradient limit
M_STEPS_RTOL = {"M11": M_CG_GRAD_TOL}


def path_m_check(torch, out, refs, cases, totals, note):
    """Every rank's path M against the unsharded runs: each case by
    ``l_held`` (path L's limits) against one process's same arithmetic, its
    witness (M1 and M8 the unsharded run on the full grid; M2, M4, M7 and
    M11 the run with its products blocked as the ranks'; M9 the run on a
    one-rank mesh; M6 and M10 the plain run), M1, M8 and M9 also bitwise in
    every loss and the first step's leaves; the cases with another witness
    also against the plain unsharded run at the CG estimator's fp32 limits
    (first loss 1e-5, gradients ``M_CG_GRAD_TOL``, losses 1e-4, M11's
    ``M_STEPS_RTOL``); their
    launch counts; M12's ``fit`` bitwise against ``sharded_fit_step`` and
    every rank's leaves equal; M3's, M6's and M10's predictions at path G's
    limits, the dense ICM MLL at path L's first-step limits."""
    from projected_lmc_tpu_torch.module import jax_key
    for label in ("M1", "M2", "M4") + M_NEW:
        want = refs.get(label + " witness",
                        refs.get(label + " blocked", refs[label]))
        if want is not refs[label]:
            rel, grad, worst = _m_against(want, refs[label])
            print(f"  {label} unsharded, its witness against the plain run "
                  f"(the estimator's own sensitivity to the order of "
                  f"summation; a reading): first loss rel {rel:.2e}, worst "
                  f"gradient {grad:.2e} of its largest entry, losses worst "
                  f"rel {worst:.2e}")
        steps = cases[label]["steps"]
        start = {k: cases[label]["arrays"][jax_key(k)]
                 for k in want["params"]}
        for layout in m_layouts(label, cases):
            for r, o in enumerate(out):
                got = o["M"][(label, layout)]
                l_held(f"{label} rank {r} mesh {got['mesh']}", got, want,
                       start)
                if label in M_BITWISE:
                    same = got["losses"] == want["losses"] and all(
                        np.array_equal(got["params"][k], v)
                        for k, v in want["params"].items())
                    print(f"  {label} rank {r} mesh {got['mesh']} bitwise its "
                          f"witness in every loss and the first step's "
                          f"leaves: {same}")
                    if not same:
                        raise SystemExit(f"chip_smoke: {label} rank {r} is "
                                         f"not bitwise its witness")
                if want is not refs[label]:
                    rel, grad, worst = _m_against(got, refs[label])
                    steps_tol = M_STEPS_RTOL.get(label, L_STEPS_RTOL)
                    print(f"  {label} rank {r} against the plain unsharded "
                          f"run: first loss rel {rel:.2e} ({L_LOSS_RTOL:.0e}),"
                          f" worst gradient {grad:.2e} of its largest entry "
                          f"({M_CG_GRAD_TOL:.0e}), losses worst rel "
                          f"{worst:.2e} ({steps_tol:.0e})")
                    if not (rel <= L_LOSS_RTOL and grad <= M_CG_GRAD_TOL
                            and worst <= steps_tol):
                        raise SystemExit(f"chip_smoke: {label} rank {r} "
                                         f"disagrees with the plain "
                                         f"unsharded run")
                if got["counts"] != M_COUNTS[label](steps):
                    raise SystemExit(f"chip_smoke: {label} rank {r} launched "
                                     f"{got['counts']}, not "
                                     f"{M_COUNTS[label](steps)}")
                for k, v in got["counts"].items():
                    totals[k] += v
            runs = [o["M"][(label, layout)] for o in out]
            if label + " default" in refs:
                rel, grad, worst = _m_against(runs[0],
                                              refs[label + " default"])
                print(f"  {label} rank 0 mesh {runs[0]['mesh']} against the "
                      f"unsharded default route (K1 and K2; a reading, not "
                      f"held): first loss rel {rel:.2e}, worst gradient "
                      f"{grad:.2e} of its largest entry, losses worst rel "
                      f"{worst:.2e}")
            print(f"  {label} data {layout[0]} x latent {layout[1]}: step "
                  f"median by rank " + " / ".join(
                      f"{float(np.median(g['ms'][1:])):.3f}" for g in runs)
                  + f" ms ({note}); unsharded "
                  f"{float(np.median(refs[label]['ms'][1:])):.3f} ms; peak "
                  f"memory by rank " + " / ".join(f"{g['peak_gib']:.2f}"
                                                  for g in runs)
                  + f" GiB (unsharded {refs[label]['peak_gib']:.2f}); "
                  f"launches a "
                  f"rank {runs[0]['counts']}; a step with its world sums "
                  f"timed: " + " / ".join(
                      f"{g['sum_ms']:.1f} of {g['sum_step_ms']:.1f} ms in "
                      f"{g['sums']} sums" for g in runs))
    m12_check(out, refs["M12"], totals)
    want = refs["M3"]
    for r, o in enumerate(out):
        got = o["M"]["M3"]
        for name, _, _ in M_SERVED:
            g, w = got[name], want[name]
            mtol = 1e-3 if name.endswith("_iter") else 1e-4
            errs = [float(np.abs(g["mean"] - w["mean"]).max()
                          / np.abs(w["mean"]).max()),
                    float(np.abs(g["var"] - w["var"]).max() / w["prior_var"])]
            if "compute_var" in w:
                errs.append(float(np.abs(g["compute_var"] - w["compute_var"])
                                  .max() / w["prior_var"]))
            bad = (g["kind"] != name.split()[0] or errs[0] > mtol
                   or max(errs[1:]) > 1e-3
                   or any(v for k, v in g["counts"].items() if k != "K3")
                   or g["counts"]["K3"] < 1)
            print(f"  M3 rank {r} {name} ({g['kind']}): cache "
                  f"{g['cache_ms']:.3f} ms, posterior ({N_TEST} points) "
                  f"{g['pred_ms']:.3f} ms; mean {errs[0]:.2e} of its largest "
                  f"entry ({mtol:.0e}), variance {max(errs[1:]):.2e} of the "
                  f"largest prior variance (1e-3); K3 {g['counts']['K3']}")
            if bad:
                raise SystemExit(f"chip_smoke: M3's sharded {name} disagrees "
                                 f"with the unsharded one")
            totals["K3"] += g["counts"]["K3"]
        g, w = got["icm"], want["icm"]
        rel = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        grad = max(float(np.abs(g["grads"][k] - v).max()
                         / max(np.abs(v).max(), 1e-30))
                   for k, v in w["grads"].items())
        print(f"  M3 rank {r} dense ICM MLL n={N_M3} ({g['mll_ms']:.3f} ms): "
              f"loss rel {rel:.2e} ({L_LOSS_RTOL:.0e}), worst gradient "
              f"{grad:.2e} of its largest entry ({L_GRAD_TOL:.0e}), launches "
              f"{g['mll_counts']}")
        if not (rel <= L_LOSS_RTOL and grad <= L_GRAD_TOL
                and g["mll_counts"] == expect(K3=1)):
            raise SystemExit("chip_smoke: M3's sharded dense ICM MLL "
                             "disagrees with the unsharded one")
        totals["K3"] += 1


M12_COUNTS = expect(K6=M12_STEPS, K7=M12_STEPS, K3=2)


def m12_check(out, one_rank, totals):
    """M12 on every rank: ``fit`` on the sharded model bitwise
    ``sharded_fit_step`` (every loss and every leaf), every rank's leaves
    bitwise rank 0's, the launch counts of each run; beside the one-rank
    mesh's ``fit`` in this process (a reading)."""
    lead = out[0]["M"]["M12"]["fit"]["leaves"]
    for r, o in enumerate(out):
        fit, step = o["M"]["M12"]["fit"], o["M"]["M12"]["step"]
        same = fit["losses"] == step["losses"] and all(
            np.array_equal(v, step["leaves"][k])
            for k, v in fit["leaves"].items())
        ranks = all(np.array_equal(v, lead[k])
                    for k, v in fit["leaves"].items())
        gap = max(float(np.abs(v - one_rank["fit"]["leaves"][k]).max()
                        / max(np.abs(one_rank["fit"]["leaves"][k]).max(),
                              1e-30))
                  for k, v in fit["leaves"].items() if v.size)
        print(f"  M12 rank {r}: fit ({M12_STEPS} steps, one chunk, "
              f"{fit['seconds']:.1f} s) bitwise sharded_fit_step "
              f"({step['seconds']:.1f} s) in every loss and leaf: {same}; "
              f"its leaves bitwise rank 0's: {ranks}; losses "
              f"{np.round(fit['losses'], 6).tolist()}; against the one-rank "
              f"mesh's fit (a reading) worst leaf {gap:.2e} of its largest "
              f"entry")
        for run in (fit, step):
            if run["counts"] != M12_COUNTS:
                raise SystemExit(f"chip_smoke: M12 rank {r} launched "
                                 f"{run['counts']}, not {M12_COUNTS}")
            for k, v in run["counts"].items():
                totals[k] += v
        if not (same and ranks):
            raise SystemExit("chip_smoke: fit on a sharded model is not "
                             "sharded_fit_step's run on every rank")


# Path N: the examples, each as a subprocess on the card
N_EXAMPLES = (
    ("01_quickstart_projected.py", ("R2=", "alpha_CI=")),
    ("02_sgpr_serving.py", ("cache == self-contained: True",)),
    ("03_multichip_sharding.py", ("match: True", "'data': 4", "'latent': 2")),
    ("04_checkpoint_resume.py", ("matches phase-1 final: True",
                                 "improved: True")),
)
N_RANKS = {"03_multichip_sharding.py": 8}   # spawned ranks (else none)
N_KERNELS = ("K3",)              # launched in every process that runs a model
N_ARGS = ()                              # an example's arguments (no --cpu)
N_TIMEOUT = 420                          # seconds for one example
N_START = ("import torch, projected_lmc_tpu_torch; "
           "torch.ones(1, device='cuda').sum().item()")
N_LOSS = re.compile(r"\bloss (\S+?)[,\s]")


def _build_listing(build_dir) -> dict:
    return {p.name: p.stat().st_mtime_ns for p in build_dir.iterdir()}


def run_example(args, env, timeout):
    """(returncode, stdout, stderr, seconds, pid) of ``python3 *args`` in its
    own process group, the whole group killed at ``timeout`` (03's ranks
    with it)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise SystemExit(f"chip_smoke: {args[0]} passed its {timeout} s"
                         f"\n{out}\n{err}")
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)   # no process outlives it
    return proc.returncode, out, err, time.perf_counter() - t0, proc.pid


def example_counts(path) -> list:
    """[(pid, {label: launches})], one for each process that wrote a line to
    the ``PLMC_LAUNCH_COUNTS`` file of one example."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [(r["pid"], r["launches"]) for r in map(json.loads, f)]


def n_sines(rng, n, d, p, q):
    """02's and 04's data: q sines of random projections of x mixed to p
    tasks, with noise 0.05, drawn from ``rng`` in the examples' order."""
    X = rng.standard_normal((n, d)).astype(np.float32)
    F = np.stack([np.sin(X @ w) for w in rng.standard_normal((q, d))], axis=1)
    H = rng.standard_normal((q, p)).astype(np.float32)
    return X, (F @ H + 0.05 * rng.standard_normal((n, p))).astype(np.float32)


def n_k3_checks(torch, pl, dev, ck):
    """K3 against its plain version and bitwise K6 at the (x1, x2) shapes
    the examples give it, on each example's own seeded data and its model as
    built (its lengthscales and inducing points before the fit)."""
    from projected_lmc_tpu_torch.experiments.synthetic import (
        generate_synthetic)

    def model(X, Y, p, q, **kw):
        m = pl.ProjectedGPModel(X, Y, p, q, init_lmc_coeffs=True,
                                kernel_type="matern", device=dev, **kw)
        return m, m.train_x, m.covar_module.lengthscale.detach()

    # 01: K(x, x) in the fit, K(x_test, x) in predict
    data = generate_synthetic(n=300, p=12, q=3, q_noise=3, mu_noise=0.1,
                              mu_str=0.9, max_scale=0.5, n_test=400, seed=0)
    _, x, ls = model(data["X"], data["Y"], 12, 3, BDN=False,
                     diagonal_B=False, scalar_B=False)
    x_test = torch.as_tensor(data["X_test"], device=dev)
    k3_shapes(torch, ck, dev, ((x, x), (x_test, x)), ls)
    # 02: SGPR, m = 128 at d = 4: the fit's K(x, z) and K(z, z), a serving
    # batch of 256 and the 64 points of the cache check against z
    rng = np.random.default_rng(0)
    X, Y = n_sines(rng, 4000, 4, 6, 3)
    xb = torch.as_tensor(rng.standard_normal((256, 4)).astype(np.float32),
                         device=dev)
    m, x, ls = model(X, Y, 6, 3, BDN=True, scalar_B=True, diagonal_B=True,
                     n_inducing_points=128)
    z = m.inducing_points.detach()
    k3_shapes(torch, ck, dev, ((x, z), (z, z), (xb, z), (x[:64], z)), ls)
    # 03: n = 512 at d = 3 on data 4 x latent 2: a rank's row block and all
    # rows at its one latent, and the unsharded model's (2, n, n)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((512, 3)).astype(np.float32)
    Y = rng.standard_normal((512, 8)).astype(np.float32)
    _, x, ls = model(X, Y, 8, 2, BDN=True, scalar_B=True, diagonal_B=True)
    k3_shapes(torch, ck, dev, ((x[:512 // 4], x), (x, x)), ls[:1])
    k3_shapes(torch, ck, dev, ((x, x),), ls)
    # 04: n = 200 at d = 2, K(x, x) in both fits and in predict
    X, Y = n_sines(np.random.default_rng(0), 200, 2, 5, 2)
    _, x, ls = model(X, Y, 5, 2, BDN=True, scalar_B=True)
    k3_shapes(torch, ck, dev, ((x, x),), ls)


def o_matrices(torch, dev, n, q, seed=0):
    """(q, n, n) Matérn-2.5 kernel matrices on n points of N(0, I_21),
    lengthscales 2 to 5, plus 0.09 I (SARCOS's features and noise)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, DE), generator=g, device=dev)
    d2 = torch.cdist(x, x).square_()
    K = torch.empty((q, n, n), device=dev)
    for b, ls in enumerate(torch.linspace(2.0, 5.0, q).tolist()):
        r = (d2 / ls ** 2).sqrt_().mul_(math.sqrt(5.0))
        torch.mul(r + r * r / 3 + 1, torch.exp(-r), out=K[b])
        K[b].diagonal().add_(0.09)
    return K


def o_routes(torch, chol, K, delta, cot):
    """The closed-form route and the generic one, each its graph built
    once: (backward, K, δ) where ``backward`` runs that route's backward
    again and leaves K̄ and δ̄ in K.grad and δ.grad."""
    def generic(K, d):
        L = chol.safe_cholesky(K)
        z = chol.solve_triangular(L, d[..., None], lower=True)[..., 0]
        return -0.5 * ((z * z).sum(-1) + chol.logdet_from_chol(L)
                       + K.shape[-1] * math.log(2 * math.pi))

    out = []
    for fn in (chol.gaussian_log_density, generic):
        Kc, dc = K.clone().requires_grad_(), delta.clone().requires_grad_()
        v = fn(Kc, dc)

        def backward(v=v, Kc=Kc, dc=dc):
            Kc.grad = dc.grad = None
            v.backward(cot, retain_graph=True)
        out.append((backward, Kc, dc))
    return out


def path_o_phase(torch, dev):
    from projected_lmc_tpu_torch.ops import cholesky as chol
    n, q = N, Q
    K = o_matrices(torch, dev, n, q)
    L = torch.linalg.cholesky(K)
    bound, by = bound_ms(q * n * (n + 1) * 4.0, q * 2.0 * n ** 3 / 3)
    blocked = chol.cholesky_inverse(L)
    library = torch.cholesky_inverse(L)
    gap = float(((blocked - library).abs().max() / library.abs().max()))
    symmetric = torch.equal(blocked, blocked.transpose(-1, -2))
    del blocked, library
    blocked_ms = cuda_ms(lambda: chol.cholesky_inverse(L), reps=3, warmup=1)
    library_ms = cuda_ms(lambda: torch.cholesky_inverse(L), reps=2, warmup=1)
    print(f"  O K^-1 ({q},{n},{n}): blocked {blocked_ms:.3f} ms, "
          f"torch.cholesky_inverse (library_ms) {library_ms:.3f} ms; bound "
          f"{bound:.3f} ms by {by} (blocked at {100 * bound / blocked_ms:.1f}"
          f"%); exactly symmetric {symmetric}")
    check("O blocked K^-1 against torch.cholesky_inverse, over its largest "
          "entry", gap, 2e-5)
    if not symmetric:
        raise SystemExit("chip_smoke: the blocked K^-1 is not symmetric")
    g = torch.Generator(device=dev).manual_seed(1)
    delta = torch.randn((q, n), generator=g, device=dev)
    cot = torch.full((q,), 1.0 / n, device=dev)
    # float64 truth: ½ g (ααᵀ − K⁻¹) from the library's inverse
    L64 = torch.linalg.cholesky(K.double())
    alpha = torch.linalg.solve_triangular(
        L64.transpose(-1, -2), torch.linalg.solve_triangular(
            L64, delta.double()[..., None], upper=False), upper=True)
    truth = torch.cholesky_inverse(L64).mul_(-1.0).baddbmm_(
        alpha, alpha.transpose(-1, -2)).mul_(0.5 / n)
    d_truth = -alpha[..., 0] / n
    del L64, alpha
    (closed, Kc, dc), (generic, Kg, dg) = o_routes(torch, chol, K, delta,
                                                   cot)
    del K, L
    torch.cuda.synchronize()
    closed_ms = cuda_ms(closed, reps=3, warmup=1)
    generic_ms = cuda_ms(generic, reps=2, warmup=1)
    print(f"  O backward: closed form {closed_ms:.3f} ms, generic pullback "
          f"{generic_ms:.3f} ms ({generic_ms / closed_ms:.2f}x); bound "
          f"{bound:.3f} ms (closed form at {100 * bound / closed_ms:.1f}%)")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    gaps = dict(K=rel(Kc.grad, Kg.grad), delta=rel(dc.grad, dg.grad))
    to64 = {k: (rel(a.grad.double(), t), rel(b.grad.double(), t))
            for k, a, b, t in (("K", Kc, Kg, truth), ("delta", dc, dg,
                                                      d_truth))}
    print("  O gradients, largest entrywise gap over the largest entry: "
          + ", ".join(f"{k}bar closed vs generic {gaps[k]:.3e} (to float64: "
                      f"closed {to64[k][0]:.3e}, generic {to64[k][1]:.3e})"
                      for k in gaps))
    for k, (c, gen) in to64.items():
        if not (math.isfinite(c) and c <= 2 * gen + 1e-7):
            raise SystemExit(f"chip_smoke: the closed form's {k}bar is "
                             f"farther from float64's than the generic "
                             f"route's ({c:.3e} > 2 x {gen:.3e})")
    if not torch.equal(Kc.grad, Kc.grad.transpose(-1, -2)):
        raise SystemExit("chip_smoke: the closed form's Kbar is not "
                         "symmetric")
    return dict(blocked_ms=blocked_ms, library_ms=library_ms,
                closed_ms=closed_ms, generic_ms=generic_ms, bound_ms=bound)


N_P = 44_484                             # path P: SARCOS's full training set
P_BLOCK = 128                            # rows of a plain check's block


def p_blocks(n):
    """Row blocks of path P's plain checks: the first, one in the middle
    and the last (which holds the ragged last 128-row tile)."""
    mid = (n // 2) // P_BLOCK * P_BLOCK
    return ((0, P_BLOCK), (mid, mid + P_BLOCK), (n - P_BLOCK, n))


def path_p_phase(torch, ck, it, dev):
    """K1, K2 and K3 at (4, 44,484) with d = 21, where the stack's q·n²
    entries pass 2³¹: each against its plain version on row blocks, the
    first, a middle and the last, in every latent (latents 2 and 3 start
    past 2³¹ entries); the bf16 stack product against one latent's rows
    in fp32; memory and times."""
    n, q, d = N_P, Q, DE
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa
    x = t(rng.standard_normal((n, d)))
    x = x - x.mean(0)
    ls = t(np.sqrt(d / 4.0) * np.exp(rng.uniform(-0.2, 0.2, (q, 1, d))))
    os_ = t(rng.uniform(0.5, 2.0, (q,)))
    print(f"  entries of the (q, n, n) stack: {q * n * n:,} (2^31 = "
          f"{2 ** 31:,}); latent b starts at entry b·n² = "
          f"{', '.join(f'{b * n * n:,}' for b in range(q))}")
    torch.cuda.reset_peak_memory_stats()
    Ks = ck.scaled_kernel_stack_sym(x, ls, os_, KIND, torch.bfloat16,
                                    device=dev)
    torch.cuda.synchronize()
    print(f"  K1 bf16 stack {tuple(Ks.shape)}: "
          f"{Ks.numel() * Ks.element_size() / 1e9:.2f} GB")
    for i0, i1 in p_blocks(n):
        err, top = stack_error(torch, ck, Ks[:, i0:i1], x[i0:i1], ls, os_,
                               torch.bfloat16, block=P_BLOCK, x2=x)
        check(f"K1 n={n} rows {i0}..{i1 - 1}, every latent", err,
              2.0 ** -7 * top)
        if not torch.equal(Ks[:, i0:i1], Ks[:, :, i0:i1].transpose(1, 2)):
            raise SystemExit(f"chip_smoke: K1's rows {i0}..{i1 - 1} are not "
                             "its columns")
    print("  K1 rows equal to their columns in the three blocks: True")
    ms = cuda_ms(lambda: ck.scaled_kernel_stack_sym(
        x, ls, os_, KIND, torch.bfloat16, device=dev), reps=3, warmup=1)
    print(f"  K1 at n={n} d={d}: {ms:.3f} ms (write bound "
          f"{q * n * n * 2 / PEAK_BYTES_PER_S * 1e3:.3f} ms)")

    # the bf16 stack product (aten::bmm with an fp32 result) against each
    # latent's last rows in float64, over Σ_j |K_ij||W_j|: fp32 sums of
    # n = 44,484 terms in any order stay far below 1e-4 of it, while rows
    # read from a wrong offset (another latent's, or past the stack) are
    # off by its whole size
    W = t(rng.standard_normal((q, n, 17)))
    got = it._bf16_stack_bmm(Ks, W)
    Wb = W.to(torch.bfloat16).double()
    worst = 0.0
    for b in range(q):
        Kr = Ks[b, n - P_BLOCK:].double()
        gap = (got[b, n - P_BLOCK:].double() - Kr @ Wb[b]).abs().max()
        worst = max(worst, float(gap / (Kr.abs() @ Wb[b].abs()).max()))
    check("bf16 stack product, each latent's last rows, over sum |K||W|",
          worst, 1e-4)
    del got
    ms = cuda_ms(lambda: it._bf16_stack_bmm(Ks, W[..., :9]), reps=5)
    read_ms = q * n * n * 2 / PEAK_BYTES_PER_S * 1e3
    print(f"  bf16 stack product, 9 right-hand sides: {ms:.3f} ms (read "
          f"bound of the whole stack {read_ms:.3f} ms)")
    print(f"  peak memory with the stack: "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del Ks, W, Wb
    torch.cuda.empty_cache()

    # K2 on factors of rank 17 with A Bfᵀ symmetric
    A, Bf = symmetric_factors(rng, t, n, 17)
    tile = ck._build.library().plmc_tile_size()
    slots = ck.reduce_sym_slots_shape(q, n, ck.reduce_width(d), tile)
    print(f"  K2 slot buffer {slots}: {math.prod(slots) * 4 / 1e9:.2f} GB "
          f"({math.prod(slots):,} floats)")
    torch.cuda.reset_peak_memory_stats()
    run_k2 = lambda: ck.lowrank_stationary_reduce_sym(  # noqa: E731
        x, ls, A, Bf, KIND, device=dev)
    rows, wx = run_k2()
    rep = run_k2()
    torch.cuda.synchronize()
    print(f"  K2 peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB; repeat bitwise equal: "
          f"{torch.equal(rows, rep[0]) and torch.equal(wx, rep[1])}")
    for i0, i1 in p_blocks(n):
        d2 = ck._sqdist_scaled(x[i0:i1], x, ls)
        Wm = torch.matmul(A[:, i0:i1], Bf.transpose(-1, -2)) \
            * ck.dprofile(KIND, d2)
        want = (Wm.sum(-1), torch.matmul(Wm, x))
        del d2, Wm
        err = max(float((g[:, i0:i1] - w).abs().max())
                  for g, w in zip((rows, wx), want))
        check(f"K2 n={n} rows {i0}..{i1 - 1}, every latent", err,
              1e-4 * max(float(w.abs().max()) for w in want))
    ms = cuda_ms(run_k2, reps=3, warmup=1)
    print(f"  K2 at n={n} d={d} r=17: {ms:.3f} ms")
    del A, Bf, rows, wx, rep
    torch.cuda.empty_cache()

    # K3: the Nyström roots' K(x, z) at the full n
    idx = torch.as_tensor(np.linspace(0, n - 1, 256).astype(np.int64),
                          device=dev)
    got = ck.kernel_matrix(x, x[idx], ls, KIND, device=dev)
    err = float((got - ck.kernel_matrix_plain(x, x[idx], ls, KIND))
                .abs().max())
    check(f"K3 kernel_matrix ({q},{n},256)", err, 1e-4)
    k3_is_k6(torch, ck, dev, got, x, x[idx], ls,
             torch.ones(q, dtype=torch.float32, device=dev))


def path_n_phase(torch, pl, ck, dev, build_dir, card, totals):
    """Path N: K3 at the examples' shapes against its plain version, then
    each example of ``examples_torch/`` on the card as a subprocess, with
    the launches of each of its processes (K3 in every process that runs a
    model: the script, or each of 03's ranks), its markers, its finite
    losses, its wall and library load times; the build directory unchanged
    by them (they load the library this process built)."""
    import tempfile
    t0 = time.perf_counter()
    n_k3_checks(torch, pl, dev, ck)
    torch.cuda.empty_cache()
    print(f"  N: K3 at the examples' shapes checked in "
          f"{time.perf_counter() - t0:.1f} s")
    here = os.path.dirname(os.path.abspath(__file__))
    before = _build_listing(build_dir)
    rc, _, err, start, _ = run_example(["-c", N_START], dict(os.environ), 120)
    if rc != 0:
        raise SystemExit(f"chip_smoke: a bare process failed to start\n{err}")
    print(f"  N: a bare process (import the port, one op on the card) "
          f"{start:.1f} s, the floor of each example's wall")
    walls = {}
    with tempfile.TemporaryDirectory(prefix="plmc_path_n_") as tmp:
        for script, markers in N_EXAMPLES:
            counts_file = os.path.join(tmp, script + ".jsonl")
            env = dict(os.environ, PLMC_LAUNCH_COUNTS=counts_file)
            rc, out, err, wall, pid = run_example(
                [os.path.join(here, "examples_torch", script), *N_ARGS], env,
                N_TIMEOUT)
            walls[script] = wall
            for line in out.splitlines():
                print(f"    | {line}")
            if rc != 0:
                print(err, file=sys.stderr)
                raise SystemExit(f"chip_smoke: {script} exited with {rc}")
            missing = [m for m in markers if m not in out]
            losses = [float(v) for v in N_LOSS.findall(out + "\n")]
            if missing or not losses or not all(map(math.isfinite, losses)):
                print(err, file=sys.stderr)
                raise SystemExit(f"chip_smoke: {script} lacks {missing} or "
                                 f"printed a loss that is not finite "
                                 f"({losses})")
            lines = example_counts(counts_file)
            own = [c for p, c in lines if p == pid]
            ranks = [c for p, c in lines if p != pid]
            want = N_RANKS.get(script, 0)
            # the processes that run a model: each rank, or the script
            runners = ranks if want else own
            idle = [i for i, c in enumerate(runners)
                    if any(c[k] < 1 for k in N_KERNELS)]
            if len(own) != 1 or len(ranks) != want or idle:
                raise SystemExit(
                    f"chip_smoke: {script}: {len(own)} script and "
                    f"{len(ranks)} rank line(s) of launches (want 1 and "
                    f"{want}); {N_KERNELS} not launched in process(es) "
                    f"{idle} of {len(runners)}")
            counts = {k: sum(c[k] for _, c in lines) for k in KERNELS}
            for k, c in counts.items():
                totals[k] += c
            load = re.search(r"kernel library loaded in (\S+) s", out)
            extra = ""
            if script.startswith("01"):
                m = {k: re.search(rf"{k}=(\S+)", out).group(1)
                     for k in ("R2", "RMSE", "alpha_CI")}
                extra = (f"; R2 {m['R2']}, RMSE {m['RMSE']}, alpha_CI "
                         f"{m['alpha_CI']}")
            elif script.startswith("02"):
                batches = re.findall(r"batch \d: .*?, (\S+) ms", out)
                extra = f"; serving batches {' / '.join(batches)} ms"
            elif want:
                extra = ("; K3 by rank " + " / ".join(
                    str(c["K3"]) for c in ranks) + f", the script "
                    f"{own[0]['K3']}")
            print(f"  N {script}: wall {wall:.1f} s, kernel library loaded "
                  f"in {load.group(1) if load else '?'} s, "
                  f"{len(losses)} losses finite, launches "
                  + ", ".join(f"{k} {c}" for k, c in counts.items() if c)
                  + f" in {len(lines)} process(es){extra}; {card}")
    if _build_listing(build_dir) != before:
        raise SystemExit("chip_smoke: an example built the kernel library "
                         "again")
    print(f"  N: the {len(walls)} examples in {sum(walls.values()):.1f} s, "
          f"the library this process built loaded by each; {card}")


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--only", choices=("M", "N", "O", "P"),
        help="build the kernels and run path M (its kernel checks, "
             "references and spawn), path N (the examples) or path P (the "
             "kernels at n = 44,484) alone, or path O (the log-density's "
             "gradient; no build) alone; prints no kernels line or result "
             "line")
    only = parser.parse_args().only
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
    start = time.perf_counter()
    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    if only == "O":
        print("path O alone: the Gaussian log-density's gradient")
        path_o_phase(torch, dev)
        print(f"chip_smoke: path O passed in "
              f"{time.perf_counter() - start:.1f} s")
        return 0
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"  kernel build {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        entry = ""
        for line in log.read_text().splitlines():
            if "Compiling entry" in line:   # the kernel the lines below are for
                entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_stationary_cu_[0-9a-f]{8}",
                               "", line.split("'")[1])[:60]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {entry}:", line.replace("ptxas info    :", "")
                      .strip())
    print(f"  bf16 stack product with fp32 result via "
          f"{'torch.bmm(out_dtype=float32)' if it._BMM_OUT_DTYPE else 'per-latent fp32 up-cast'}")

    if only == "M":
        print("path M alone: the LMC and ICM families under the mesh")
        path_m_phase(torch, pl, ck, dev, {k: 0 for k in wrappers(ck)})
        print(f"chip_smoke: path M passed in "
              f"{time.perf_counter() - start:.1f} s")
        return 0
    if only == "P":
        print(f"path P alone: K1, K2 and K3 at n={N_P}, d={DE}, q={Q}")
        path_p_phase(torch, ck, it, dev)
        print(f"chip_smoke: path P passed in "
              f"{time.perf_counter() - start:.1f} s")
        return 0
    if only == "N":
        print("path N alone: the four examples on the card")
        path_n_phase(torch, pl, ck, dev, _build.BUILD_DIR, card,
                     {k: 0 for k in wrappers(ck)})
        print(f"chip_smoke: path N passed in "
              f"{time.perf_counter() - start:.1f} s")
        return 0
    print("phase 2: kernels against their plain versions")
    rows = kernel_phase(torch, ck, dev)
    print("phase 3: fused MLL, card with kernels vs CPU with plain versions, "
          "n=2048")
    fused_phase(torch, pl, ck, fm, dev)
    totals = {k: 0 for k in wrappers(ck)}
    print(f"phase 4: training loop n={N} T={T} q={Q} d={D}, "
          f"{CHUNKS}x{STEPS_PER_CHUNK} steps")
    median_4 = train_phase(torch, pl, ck, fm, dev, totals)
    print("phase 5: training.fit, n=2000, 4 iterations")
    fit_phase(torch, pl, dev)
    print(f"path A: the exact-LMC step at n={ROUTING_N}, "
          f"{STEPS_PER_CHUNK} steps on each backward route")
    path_a_phase(torch, pl, ck, fm, it, dev, totals)
    print(f"path B: ExactGPModel n={N_B} T={T}, auto-routed iterative MLL, "
          f"{STEPS_B} steps")
    path_b_phase(torch, pl, ck, fm, dev, totals)
    print(f"path C: fit_two_phase n={N}, {STEPS_C} steps ({FINE_FRAC} fp32), "
          f"and the int8 step")
    path_c_phase(torch, pl, ck, dev, totals, median_4)
    print(f"path D: the step on the full grid (PLMC_SYM_BUILD=0), n={N}, "
          f"{STEPS_PER_CHUNK} steps")
    path_d_phase(torch, pl, ck, dev, totals, median_4)
    print(f"path E: the step at d={DE} (SARCOS's features), n={N}, "
          f"{STEPS_PER_CHUNK} steps on a bf16 stack, then {STEPS_PER_CHUNK} "
          f"on an int8 stack")
    path_e_phase(torch, pl, ck, dev, totals, median_4)
    print(f"path F: projected LMC, F1 the paper's synthetic default "
          f"(q={F1_Q}, {F1_STEPS} fit steps in each model configuration), "
          f"F2 n={N} p={T} q={Q} ({F2_STEPS} fit steps)")
    path_f_phase(torch, pl, ck, dev, totals)
    print(f"path G: prediction served from a cache, G1 projected LMC n={N} "
          f"p={T} q={Q}, G2 the paper's synthetic default (fit for at "
          f"most {G2_MAX_ITER} steps), G3 the exact-LMC model n={N}; "
          f"{N_TEST} test points")
    path_g_phase(torch, pl, ck, fm, dev, totals)
    print(f"path H: the exact ICM, H1 the driver's ICM on the paper's "
          f"synthetic default (fit for at most {G2_MAX_ITER} steps), "
          f"H2 the matrix-free route n={N_H2} T={T} q={Q}, H3 the "
          f"dense route n={N_H3}; {N_TEST} test points")
    path_h_phase(torch, pl, ck, dev, totals)
    print(f"path I: variational LMC and SGPR, I1 the driver's var model on "
          f"the paper's synthetic default (fit for at most {I1_MAX_ITER} "
          f"steps, short of the plateau, and sgpr_em), I2 the SVGP ELBO "
          f"n={I2_N} d={I_D} m={I_M} ({I_STEPS} steps) and {I2_MB_STEPS} "
          f"minibatch steps at n={I2_FULL_N}, I3 projected SGPR n={I3_N} "
          f"({I_STEPS} steps, {I3_TEST} test points), I4 LMC, ICM and exact "
          f"SGPR n={N} ({I_STEPS} steps each)")
    path_i_phase(torch, pl, ck, dev, totals)
    print(f"path J: the rest of the model surface, J1 the composed route "
          f"n={N} decomp={J_DECOMP}, J2 the SLQ route n={N}, J3 the tidal "
          f"spectral-mixture ICM and PLMC, J4 ExactGPModel's means, spline "
          f"kernel, schedules, checkpoints and evals n={J4_N}, J5 the blocked "
          f"Cholesky n={J5_N}")
    path_j_phase(torch, pl, ck, dev, totals, median_4)
    print(f"path K: the experiments around the models, K1 the paper's study "
          f"(run_study, {K1_RUNS} runs of the five models, at most {K_STEPS} "
          f"steps each), K2 fit_ensemble on {K2_B} seeds, K3 the real-data "
          f"loaders on fixture files and the tidal study, K4 3-D kernel "
          f"inputs, profile_trace and ensure_cuda")
    path_k_phase(torch, pl, ck, dev, totals)
    print(f"path L: the mesh on torch.distributed, {L_RANKS} spawned ranks, "
          f"L1 F2's projected model on data {L1_MESH[0]} x latent "
          f"{L1_MESH[1]}, L2 I3's projected SGPR and L3 the variational ELBO "
          f"n={I2_FULL_N} on data {L2_MESH[0]} x latent {L2_MESH[1]} "
          f"({L_STEPS} sharded steps each against unsharded ones), L4 "
          f"dryrun_multichip, a one-rank NCCL group and the DCP checkpoint; "
          f"path M (the LMC and ICM families) in the same spawn")
    m_rows = path_l_phase(torch, pl, ck, dev, totals)
    k7_rows = m_rows.pop("K7r")
    print(f"path N: the four examples of examples_torch/ on the card, each "
          f"a subprocess ({', '.join(s for s, _ in N_EXAMPLES)})")
    path_n_phase(torch, pl, ck, dev, _build.BUILD_DIR, card, totals)
    print(f"path O: the Gaussian log-density's closed-form gradient at "
          f"({Q}, {N}, {N})")
    path_o_phase(torch, dev)

    meta = [("K1", "scaled_kernel_stack_sym",
             "projected_lmc_tpu/ops/pallas_kernels.py:278"),
            ("K2", "lowrank_stationary_reduce_sym",
             "projected_lmc_tpu/ops/pallas_kernels.py:470"),
            ("K3", "kernel_matrix",
             "projected_lmc_tpu/ops/pallas_kernels.py:912"),
            ("K4", "lowrank_stationary_reduce_sym_kr",
             "projected_lmc_tpu/ops/pallas_kernels.py:630"),
            ("K5", "lowrank_stationary_reduce_sym_krs",
             "projected_lmc_tpu/ops/pallas_kernels.py:798"),
            ("K6", "scaled_kernel_stack",
             "projected_lmc_tpu/ops/pallas_kernels.py:130"),
            ("K7", "lowrank_stationary_reduce",
             "projected_lmc_tpu/ops/pallas_kernels.py:364"),
            ("K8", "quantized_kernel_stack",
             "projected_lmc_tpu/ops/pallas_kernels.py:190"),
            ("K4r", "lowrank_stationary_reduce_rows_kr",
             "projected_lmc_tpu/ops/pallas_kernels.py:630"),
            ("K5r", "lowrank_stationary_reduce_rows_krs",
             "projected_lmc_tpu/ops/pallas_kernels.py:798")]
    rows.update(m_rows)
    kernels = []
    for key, name, replaces in meta:
        row = rows[key]
        b, by = row["bound"]
        kernels.append(dict(
            name=name, route="cuda",
            source="projected_lmc_tpu_torch/csrc/stationary.cu",
            replaces=replaces, launches=totals[key],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=b, bound_by=by,
            library_ms=None))
    print(f"  K7's row-block form at M1's {k7_rows['shape']} block: "
          f"{k7_rows['ms']:.4f} ms (plain {k7_rows['plain_ms']:.3f} ms, "
          f"bound {k7_rows['bound'][0]:.4f} ms by {k7_rows['bound'][1]}, "
          f"max_abs_err {k7_rows['max_abs_err']:.3e}); its launches are "
          f"K7's")
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
