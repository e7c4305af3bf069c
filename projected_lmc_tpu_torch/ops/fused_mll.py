"""Fused stationary-kernel exact-LMC MLL: kernel-stack build → Nyström-
preconditioned CG → Lanczos quadrature as ONE autograd op whose backward
never materializes the (q, n, n) kernel cotangent (port of
``projected_lmc_tpu/ops/fused_mll.py``).

The backward uses that the kernel cotangent is low-rank by construction,

    dK_b = g·[½ (αh_b)(αh_b)ᵀ − (1/4s) Σ_i ((W_i h_b)(Z̃_i h_b)ᵀ + sym)]
         = A_b Bf_bᵀ,     rank 1 + 2s (s probes; 17 on the main path),

so the lengthscale gradient reduces through one pass over the pair grid
that reads only the factors. The backward takes one of three routes
(``_backward_route``):

  * "stack": kernel K2 (``cuda_kernels.lowrank_stationary_reduce_sym``)
    for the reductions, and one batched product with the stack for dH, dΣt
    and the outputscale gradient;
  * "kr": kernel K4 (``lowrank_stationary_reduce_sym_kr``) gives the
    reductions AND KA = (os·K)·A in one pass, so the backward never reads
    the stack and the forward does not keep it; "krs" is K5, the same pass
    reading the stored stack instead of recomputing it (opt-in).

The forward builds the os-scaled stack with kernel K1
(``cuda_kernels.scaled_kernel_stack_sym``). ``matvec_int8`` builds an int8
stack round(127·g) with K8 (``quantized_kernel_stack``), dequantised by
os_b/127; the CG products and the backward's stack product then run
int8 × int8 → int32, and the backward takes the stack route. With
``PLMC_SYM_BUILD=0`` the full-grid kernels replace the symmetric ones: K6
(``scaled_kernel_stack``) builds the stack and K7
(``lowrank_stationary_reduce``) gives the reductions, always on the stack
route.

Spans (``utils.profiling``): the CG loop is ``mll.pcg`` and each stack
product ``mll.stack_product`` (``ops.iterative``); the stack route's
reduction (K2, or K7 on the full grid) is ``mll.ls_reduce``.

Under a mesh (``rows``, a ``parallel.mesh.RowBlock``) a rank builds only
its block of the stack, its latents' rows r0..r1 − 1 against all n points:
K6 (``scaled_kernel_stack``) on (xc[r0:r1], xc), bitwise those rows of K1's
stack, or with ``matvec_int8`` K8 on the same points, padded to the int8
product's shape (the scale os_b/127 is every rank's). The CG products sum
the ranks' rows over the world (``iterative.lmc_matvec``,
``lmc_matvec_int8``). The backward's routes keep their kernels in a
row-block form: "stack" (and every int8 stack) K7's
(``lowrank_stationary_reduce(row_x=)``) with the block product for its rows
of KR; "kr" K4's (``lowrank_stationary_reduce_rows_kr``), which recomputes
the block and gives its rows of KA; "krs" K5's
(``lowrank_stationary_reduce_rows_krs``), which reads the stored block. It
gathers the rows' products whole in ONE world ``all_reduce`` and runs one
process's formulas on them (``_rows_products``), so that every rank
carries the whole gradient, summed in one process's order, and the
backward's one collective lies on the loss's chain. (The mesh always
builds on the full grid: ``PLMC_SYM_BUILD`` does not apply.)

Scope: symmetric training evaluations of a bare or Scale-wrapped stationary
kernel (RBF / Matérn) over all input features. The input locations get no
gradient (training data is constant).
"""

from __future__ import annotations

import os

import torch

from ..utils.device import check_device
from ..utils.profiling import span
from . import cuda_kernels as ck
from . import iterative as it

# The n from which the "kr" backward (K4) is the default, None for no n: the
# smallest n at which, in each of two runs of chip_smoke.py path A (the
# exact-LMC training step, T=7, q=4, d=4, r=17, bf16 stack; median of 16
# steps), K4 beat K2 plus the stack product and the kr step was no slower
# than the stack step. On an H100 80GB HBM3 at 700 W K4 won at every n, but
# the kr step lost at every n in one of the two runs (step medians move by
# more between runs than the ~0.6 ms the kernels save):
#   n =  5,000: kernels 0.450 / 0.439 vs 0.320 / 0.317 ms;
#               steps stack 46.196 / 30.910, kr 48.812 / 30.664 ms
#   n = 10,000: kernels 1.691 / 1.707 vs 1.115 / 1.120 ms;
#               steps stack 47.155 / 39.013, kr 49.713 / 38.053 ms
#   n = 20,000: kernels 5.431 / 5.467 vs 4.220 / 4.203 ms;
#               steps stack 76.882 / 75.399, kr 77.143 / 74.718 ms
# The kr route keeps ~0.4 GB less at n=20k; it is taken by PLMC_KR_FUSED=1.
KR_MIN_N = None


def _sym_build() -> bool:
    """The symmetric kernels (K1 and K2) unless PLMC_SYM_BUILD=0, read at
    each call (the JAX package reads it once, at import); with 0 the
    full-grid ones (K6 and K7)."""
    return os.environ.get("PLMC_SYM_BUILD", "1") == "1"


def _use_kr_fused(n: int) -> bool:
    """K4 for the backward: PLMC_KR_FUSED=1/0 if set (read at each call),
    else from ``KR_MIN_N`` points on."""
    env = os.environ.get("PLMC_KR_FUSED")
    if env is not None:
        return env == "1"
    return KR_MIN_N is not None and n >= KR_MIN_N


def _use_kr_stream(Ks) -> bool:
    """K5 (the stack read back in place of its recomputation): only with
    PLMC_KR_STREAM=1, read at each call, and never for an int8 stack."""
    return os.environ.get("PLMC_KR_STREAM") == "1" and Ks.dtype != torch.int8


def _backward_route(Ks, rows=None) -> str:
    """"krs", "kr" or "stack" for a (q, n, n) stack (or a rank's block with
    ``rows``), as the JAX package's ``_fused_bwd`` picks: an int8 stack and
    the full grid (PLMC_SYM_BUILD=0; a rank's block is always K6's or K8's,
    so the variable does not apply to it) take the stack route, whatever
    PLMC_KR_*; otherwise streaming wins over the n rule."""
    if Ks.dtype == torch.int8 or (rows is None and not _sym_build()):
        return "stack"
    if _use_kr_stream(Ks):
        return "krs"
    return "kr" if _use_kr_fused(Ks.shape[-1]) else "stack"


def _lowrank_reduce_kr(xc, ls, os_, A, Bf, kind, Ks=None, device="cuda"):
    """(rows, wx, KA) in one pass: K5 reading ``Ks`` when it is given, K4
    recomputing the stack otherwise."""
    if Ks is not None:
        return ck.lowrank_stationary_reduce_sym_krs(xc, ls, os_, A, Bf, Ks,
                                                    kind, device=device)
    return ck.lowrank_stationary_reduce_sym_kr(xc, ls, os_, A, Bf, kind,
                                               device=device)


class _FusedStationaryLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ls, os_, H, St, Ydelta, eps, xi, roots, kind,
                max_cg_iters, cg_tol, matvec_bf16, precond_rank, matvec_int8,
                device, rows):
        # translation-invariant centering (exact), as kernels._skm_fwd
        xc = x - x.mean(0)
        ctx.rows = rows
        if rows is not None:
            return _FusedStationaryLogProb._rows_forward(
                ctx, xc, ls, os_, H, St, Ydelta, eps, xi, roots, kind,
                max_cg_iters, cg_tol, matvec_bf16, precond_rank, matvec_int8,
                device, rows)
        sym = _sym_build()
        kscale = None
        if matvec_int8:
            # no outputscale in the tiles: it folds into the scale os_b/127
            N = it.int8_width(xc.shape[0])
            Ks = ck.quantized_kernel_stack(xc, xc, ls, kind, padded_to=(N, N),
                                           device=device)
            kscale = os_.to(torch.float32) / 127.0
        else:
            out_dtype = torch.bfloat16 if matvec_bf16 else None
            if sym:
                Ks = ck.scaled_kernel_stack_sym(xc, ls, os_, kind, out_dtype,
                                                device=device)
            else:
                Ks = ck.scaled_kernel_stack(xc, xc, ls, os_, kind, out_dtype,
                                            device=device)
        ll, (alpha, W, Ztilde) = it._pcg_fwd_impl(
            Ks, H, St, Ydelta, eps, xi, roots, max_cg_iters, cg_tol,
            matvec_bf16, precond_rank, matvec_int8, kscale)
        ctx.route = _backward_route(Ks)
        # the kr backward recomputes the stack, so it is not kept for it
        ctx.save_for_backward(xc, ls, os_, None if ctx.route == "kr" else Ks,
                              H, alpha, W, Ztilde)
        ctx.kind, ctx.device, ctx.sym = kind, device, sym
        return ll

    @staticmethod
    def _rows_forward(ctx, xc, ls, os_, H, St, Ydelta, eps, xi, roots, kind,
                      max_cg_iters, cg_tol, matvec_bf16, precond_rank,
                      matvec_int8, device, rows):
        """The forward on the rank's block: K6 on (xc[r0:r1], xc) for its
        latents (K8 for an int8 stack, padded to the int8 product's shape),
        the row-sharded PCG."""
        lo, hi, r0, r1 = rows.lo, rows.hi, rows.r0, rows.r1
        n = xc.shape[0]
        kscale = None
        if matvec_int8:
            Ks = ck.quantized_kernel_stack(
                xc[r0:r1], xc, ls[lo:hi].contiguous(), kind,
                padded_to=(it.int8_width(r1 - r0), it.int8_width(n)),
                device=device)
            kscale = os_[lo:hi].to(torch.float32) / 127.0
        else:
            Ks = ck.scaled_kernel_stack(
                xc[r0:r1], xc, ls[lo:hi].contiguous(),
                os_[lo:hi].contiguous(), kind,
                torch.bfloat16 if matvec_bf16 else None, device=device)
        ll, (alpha, W, Ztilde) = it._pcg_fwd_impl(
            Ks, H, St, Ydelta, eps, xi, roots, max_cg_iters, cg_tol,
            matvec_bf16, precond_rank, matvec_int8, kscale, rows=rows)
        ctx.route = _backward_route(Ks, rows)
        # the kr backward recomputes the block, so it is not kept for it
        ctx.save_for_backward(xc, ls, os_, None if ctx.route == "kr" else Ks,
                              H, alpha, W, Ztilde)
        ctx.kind, ctx.device = kind, device
        return ll

    @staticmethod
    def backward(ctx, g):
        xc, ls, os_, Ks, H, alpha, W, Zt = ctx.saved_tensors
        s = max(W.shape[0], 1)
        Ah = alpha @ H                                      # (n, q)
        WH = W @ H                                          # (s, n, q)
        ZH = Zt @ H
        # dK_base = A Bfᵀ with os and the scalar coefficients folded into Bf;
        # it is symmetric, so rows == cols and wx serves both cross terms
        WHq, ZHq = WH.permute(2, 1, 0), ZH.permute(2, 1, 0)  # (q, n, s)
        Afac = torch.cat([Ah.T[:, :, None], WHq, ZHq], -1)
        Bfac = torch.cat([(0.5 * g) * Ah.T[:, :, None],
                          (-g / (4 * s)) * ZHq,
                          (-g / (4 * s)) * WHq], -1) * os_[:, None, None]

        Afac, Bfac = Afac.contiguous(), Bfac.contiguous()
        if ctx.rows is not None:
            KR, rows, wx = _rows_products(ctx, xc, ls, os_, Ks, Ah, WH, ZH,
                                          Afac, Bfac, alpha)
        elif ctx.route == "stack":
            # ONE batched stack product serves dH and the outputscale gradient
            R3 = torch.cat([Ah[None], WH, ZH], 0)
            if Ks.dtype == torch.int8:
                # R3 quantised per (probe, latent) column, os_b/127 the
                # stack's scale
                KR = it._int8_stack_product(Ks, os_.to(torch.float32) / 127.0,
                                            R3)
            else:
                KR = it._stack_matmul(Ks, R3)
            reduce = ck.lowrank_stationary_reduce_sym if ctx.sym \
                else ck.lowrank_stationary_reduce
            with span("mll.ls_reduce"):
                rows, wx = reduce(xc, ls, Afac, Bfac, ctx.kind,
                                  device=ctx.device)
        else:
            # Afac's columns are those of [Ah, WH, ZH]: KA (q, n, r) is the
            # stack product, transposed
            rows, wx, KA = _lowrank_reduce_kr(
                xc, ls, os_, Afac, Bfac, ctx.kind, Ks=Ks, device=ctx.device)
            KR = KA.permute(2, 1, 0)
        KR = KR.to(alpha.dtype)
        KAh, KWH, KZH = KR[0], KR[1:1 + s], KR[1 + s:]
        dH_a = alpha.T @ KAh
        dH_s = 0.5 * (torch.einsum("snt,snb->tb", Zt, KWH)
                      + torch.einsum("snt,snb->tb", W, KZH))
        dH = g * (dH_a - dH_s / s)

        dSt_wz = torch.einsum("snt,snu->tu", W, Zt)
        dSt = g * 0.5 * (alpha.T @ alpha - (dSt_wz + dSt_wz.T) / (2 * s))
        dY = -g * alpha

        # dos_b = Σ_ij dK ⊙ K_base, free from KR
        dos_quad = (Ah * KAh).sum(0)
        dos_tr = (ZH * KWH).sum((0, 1)) + (WH * KZH).sum((0, 1))
        dos = (g * (0.5 * dos_quad - dos_tr / (4 * s)) / os_).to(os_.dtype)

        lsq = ls[:, 0, :]                                   # (q, d)
        sq = rows @ (xc * xc)
        crossd = torch.einsum("bid,id->bd", wx, xc)
        dls = -4.0 * (sq - crossd)
        if lsq.shape[-1] == 1 and dls.shape[-1] != 1:
            dls = dls.sum(-1, keepdim=True)
        dls = (dls / (lsq * lsq * lsq))[:, None, :].to(ls.dtype)
        return (None, dls, dos, dH, dSt, dY, None, None, None, None, None,
                None, None, None, None, None, None)


def _rows_products(ctx, xc, ls, os_, Ks, Ah, WH, ZH, Afac, Bfac, alpha):
    """The backward's products on the rank's block, gathered whole, by the
    route's row-block kernel: K7's for its rows' (rows, wx) with the block
    product (int8 for an int8 block, its right-hand sides quantised over
    the whole R3) for its rows of KR; or K4's, or K5's on the stored block,
    for its rows of (rows, wx, KA) in one pass (A Bfᵀ is symmetric, so the
    rows' reductions take Bf's rows against A's columns, and KA's columns
    are A's). They are written into one zero buffer and summed over the
    world in ONE call. The backward then runs one process's formulas on the
    whole products, so that dls = −4(Σ rows·x² − Σ wx·x), which cancels,
    sums in one process's order."""
    rows = ctx.rows
    lo, hi, r0, r1 = rows.lo, rows.hi, rows.r0, rows.r1
    lsl = ls[lo:hi].contiguous()
    R3 = torch.cat([Ah[None], WH, ZH], 0)
    if ctx.route == "stack":
        part_rows, part_wx = ck.lowrank_stationary_reduce(
            xc, lsl, Afac[lo:hi, r0:r1].contiguous(),
            Bfac[lo:hi].contiguous(), ctx.kind, device=ctx.device,
            row_x=xc[r0:r1])
        if Ks.dtype == torch.int8:
            part_KR = it._int8_stack_product(
                Ks, os_[lo:hi].to(torch.float32) / 127.0, R3[..., lo:hi],
                r1 - r0)
        else:
            part_KR = it._stack_matmul(Ks, R3[..., lo:hi])
    else:
        args = (xc[r0:r1], xc, lsl, os_[lo:hi].contiguous(),
                Bfac[lo:hi, r0:r1].contiguous(), Afac[lo:hi].contiguous())
        if ctx.route == "krs":
            part_rows, part_wx, part_KA = ck.lowrank_stationary_reduce_rows_krs(
                *args, Ks, ctx.kind, device=ctx.device)
        else:
            part_rows, part_wx, part_KA = ck.lowrank_stationary_reduce_rows_kr(
                *args, ctx.kind, device=ctx.device)
        part_KR = part_KA.permute(2, 1, 0)                  # (1+2s, n_l, q_l)
    q, n, d, r = rows.q, rows.n, part_wx.shape[-1], R3.shape[0]
    buf = alpha.new_zeros(q * n * (1 + d) + r * n * q)
    full_rows = buf[:q * n].view(q, n)
    full_wx = buf[q * n:q * n * (1 + d)].view(q, n, d)
    full_KR = buf[q * n * (1 + d):].view(r, n, q)
    full_rows[lo:hi, r0:r1] = part_rows
    full_wx[lo:hi, r0:r1] = part_wx
    full_KR[:, r0:r1, lo:hi] = part_KR
    rows.mesh.world_sum_(buf)
    return full_KR, full_rows, full_wx


def lmc_pcg_log_prob_stationary(x, ls, os_, H, St, Ydelta, eps, xi, roots,
                                kind, max_cg_iters=32, cg_tol=1e-2,
                                matvec_bf16=False, precond_rank=256,
                                matvec_int8=False, device="cuda", rows=None):
    """log N(vec(Y); 0, Σ_b os_b K_b(x; ls_b) ⊗ h_b h_bᵀ + I ⊗ Σt), the stack
    built inside the op.

    x (n, d) training inputs (no gradient); ls (q, 1, d) lengthscales; os_
    (q,) outputscales (ones for a bare kernel); H (T, q); St (T, T); Ydelta
    (n, T); eps (s, n, T) and xi (s, q, m) standard normals; roots (q, n, m)
    Nyström roots or None (then sliced from the stack); kind one of
    ``cuda_kernels.KINDS``. ``matvec_bf16`` builds the stack in bf16 (the CG
    products keep fp32 results). ``matvec_int8`` (over ``matvec_bf16``)
    builds the int8 stack and runs every stack product int8 × int8 → int32
    (operator noise ~1% relative; a training-tolerance mode). All tensors
    lie on ``device``. ``rows`` (a
    ``parallel.mesh.RowBlock``): the rank builds and multiplies its block of
    the stack only, and every rank returns the whole value and, in the
    backward, the whole gradient; the given ``roots`` are whole."""
    check_device(device, x, ls, os_, H, St, Ydelta, eps, xi, roots)
    return _FusedStationaryLogProb.apply(
        x.detach(), ls, os_, H, St, Ydelta, eps, xi, roots, kind,
        int(max_cg_iters), float(cg_tol), bool(matvec_bf16),
        int(precond_rank), bool(matvec_int8), device, rows)
