"""Fused stationary-kernel exact-LMC MLL: kernel-stack build → Nyström-
preconditioned CG → Lanczos quadrature as ONE autograd op whose backward
never materializes the (q, n, n) kernel cotangent (port of
``projected_lmc_tpu/ops/fused_mll.py``).

The backward uses that the kernel cotangent is low-rank by construction,

    dK_b = g·[½ (αh_b)(αh_b)ᵀ − (1/4s) Σ_i ((W_i h_b)(Z̃_i h_b)ᵀ + sym)]
         = A_b Bf_bᵀ,     rank 1 + 2s (s probes; 17 on the main path),

so the lengthscale gradient reduces through one pass over the pair grid
(kernel K2, ``cuda_kernels.lowrank_stationary_reduce_sym``) that reads only
the factors, and dH, dΣt and the outputscale gradient share one batched
product with the stack. The forward builds the os-scaled stack with kernel
K1 (``cuda_kernels.scaled_kernel_stack_sym``).

Scope: symmetric training evaluations of a bare or Scale-wrapped stationary
kernel (RBF / Matérn) over all input features. The input locations get no
gradient (training data is constant); ``matvec_int8`` and the TPU's
fully-fused ``kr``/``krs`` backward passes are later slices.
"""

from __future__ import annotations

import torch

from ..utils.device import check_device
from . import cuda_kernels as ck
from . import iterative as it


class _FusedStationaryLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ls, os_, H, St, Ydelta, eps, xi, roots, kind,
                max_cg_iters, cg_tol, matvec_bf16, precond_rank, device):
        # translation-invariant centering (exact), as kernels._skm_fwd
        xc = x - x.mean(0)
        Ks = ck.scaled_kernel_stack_sym(
            xc, ls, os_, kind,
            out_dtype=torch.bfloat16 if matvec_bf16 else None, device=device)
        ll, (alpha, W, Ztilde) = it._pcg_fwd_impl(
            Ks, H, St, Ydelta, eps, xi, roots, max_cg_iters, cg_tol,
            matvec_bf16, precond_rank)
        ctx.save_for_backward(xc, ls, os_, Ks, H, alpha, W, Ztilde)
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

        # ONE batched stack product serves dH and the outputscale gradient
        KR = it._stack_matmul(Ks, torch.cat([Ah[None], WH, ZH], 0)) \
            .to(alpha.dtype)
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

        rows, wx = ck.lowrank_stationary_reduce_sym(
            xc, ls, Afac.contiguous(), Bfac.contiguous(), ctx.kind,
            device=ctx.device)
        lsq = ls[:, 0, :]                                   # (q, d)
        sq = rows @ (xc * xc)
        crossd = torch.einsum("bid,id->bd", wx, xc)
        dls = -4.0 * (sq - crossd)
        if lsq.shape[-1] == 1 and dls.shape[-1] != 1:
            dls = dls.sum(-1, keepdim=True)
        dls = (dls / (lsq * lsq * lsq))[:, None, :].to(ls.dtype)
        return (None, dls, dos, dH, dSt, dY, None, None, None, None, None,
                None, None, None, None)


def lmc_pcg_log_prob_stationary(x, ls, os_, H, St, Ydelta, eps, xi, roots,
                                kind, max_cg_iters=32, cg_tol=1e-2,
                                matvec_bf16=False, precond_rank=256,
                                matvec_int8=False, device="cuda"):
    """log N(vec(Y); 0, Σ_b os_b K_b(x; ls_b) ⊗ h_b h_bᵀ + I ⊗ Σt), the stack
    built inside the op.

    x (n, d) training inputs (no gradient); ls (q, 1, d) lengthscales; os_
    (q,) outputscales (ones for a bare kernel); H (T, q); St (T, T); Ydelta
    (n, T); eps (s, n, T) and xi (s, q, m) standard normals; roots (q, n, m)
    Nyström roots or None (then sliced from the stack); kind one of
    ``cuda_kernels.KINDS``. ``matvec_bf16`` builds the stack in bf16 (the CG
    products keep fp32 results). All tensors lie on ``device``."""
    if matvec_int8:
        raise NotImplementedError(
            "matvec_int8 (the int8 stack, TPU kernel quantized_kernel_stack) "
            "is ported in a later slice")
    check_device(device, x, ls, os_, H, St, Ydelta, eps, xi, roots)
    return _FusedStationaryLogProb.apply(
        x.detach(), ls, os_, H, St, Ydelta, eps, xi, roots, kind,
        int(max_cg_iters), float(cg_tol), bool(matvec_bf16),
        int(precond_rank), device)
