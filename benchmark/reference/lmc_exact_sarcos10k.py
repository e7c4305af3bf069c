"""Plain reference of the exact LMC's training step: the one-pass
Nyström-preconditioned CG estimator of the marginal likelihood, its
Hutchinson gradient, and AdamW, in plain PyTorch.

Σ = Σ_b K_b ⊗ h_b h_bᵀ + I ⊗ Σt over n points and T tasks. With probes
z_i ~ N(0, M) drawn through the preconditioner M = Σ_b R_b R_bᵀ ⊗ h_b h_bᵀ
+ I ⊗ Σt (R_b Nyström roots at strided landmarks), one batched PCG solve
of [Y, z_1..z_s] gives α = Σ⁻¹Y, w_i = Σ⁻¹z_i and the Lanczos
tridiagonals of the preconditioned operator, so that

    log p(Y) ≈ −½ (Yᵀα + log det M + (1/s) Σ_i ‖z_i‖²_{M⁻¹} e₁ᵀ log(T_i) e₁
               + nT log 2π)

(Gardner et al. 2018, GPyTorch, §4; Wenger et al. 2022). The gradient uses
dℓ/dΣ = ½ (ααᵀ − Σ̂⁻¹) with Σ̂⁻¹ = (1/2s) Σ_i (w_i z̃_iᵀ + z̃_i w_iᵀ),
z̃_i = M⁻¹ z_i. The stack products take bf16 operands and accumulate in
fp32, as the configuration states; everything else is fp32 with TF32 off.
The CG runs the configuration's ``max_cg_iters`` iterations, a right-hand
side frozen once its relative residual is below ``cg_tol`` or when pᵀAp ≤ 0
(then restarted from its preconditioned residual).

It reads only what the benchmark made: the data, the starting leaves and
the probes; it computes the kernels, the roots, the preconditioner and the
steps itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.common import kernel, lengthscale_grad, softplus, train_steps

NOISE_FLOOR = 1e-4


def parameters(leaves, frozen):
    """(ls (q, d), H (T, q), Σt (T, T)) from the raw leaves."""
    ls = softplus(leaves["covar_module.raw_lengthscale"])[:, 0, :]
    H = leaves["covar_factor"][..., 0].T
    noise = softplus(leaves["likelihood.raw_noise"]) + NOISE_FLOOR
    tasks = softplus(leaves["likelihood.raw_task_noises"]) + NOISE_FLOOR
    extra = softplus(frozen["raw_var"]).sum(0)
    St = torch.diag(tasks + extra) + noise[0] * torch.eye(
        H.shape[0], dtype=H.dtype, device=H.device)
    return ls, H, St


def nystrom_roots(x, ls, rank, jitter):
    """R_b = K_b(x, z) L_b⁻ᵀ with L_b L_bᵀ = K_b(z, z) + jitter·I at the
    landmarks z = x[⌊linspace(0, n − 1, rank)⌋], (q, n, rank)."""
    n = x.shape[0]
    idx = torch.as_tensor(np.linspace(0, n - 1, min(rank, n)).astype(np.int64),
                          device=x.device)
    z = x[idx]
    out = []
    for l in ls:
        Kzz = kernel(z, z, l)
        eye = torch.eye(len(idx), dtype=x.dtype, device=x.device)
        L = torch.linalg.cholesky(Kzz + jitter * eye)
        Kxz = kernel(x, z, l)
        out.append(torch.linalg.solve_triangular(L, Kxz.T, upper=False).T)
    return torch.stack(out)


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


class Operator:
    """Σ, its preconditioner M and M⁻¹, for one set of parameters."""

    def __init__(self, x, ls, H, St, R):
        xc = x - x.mean(0)
        # the configuration's stack: each kernel rounded once to bf16
        self.K = [kernel(xc, xc, l).to(torch.bfloat16) for l in ls]
        self.H, self.St, self.R = H, St, R
        q, n, m = R.shape
        t = St.shape[0]
        self.Lt = torch.linalg.cholesky(St)
        self.Sinv = torch.cholesky_inverse(self.Lt)
        SinvH = self.Sinv @ H
        C = H.T @ SinvH                                     # (q, q)
        flat = R.permute(1, 0, 2).reshape(n, q * m)
        gram = (flat.T @ flat).reshape(q, m, q, m)
        cap = (C[:, None, :, None] * gram).reshape(q * m, q * m) \
            + torch.eye(q * m, dtype=R.dtype, device=R.device)
        Lc = torch.linalg.cholesky(cap)
        self.capinv = torch.cholesky_inverse(Lc)
        self.SinvH = SinvH
        self.logdet_M = 2.0 * n * torch.log(torch.diagonal(self.Lt)).sum() \
            + 2.0 * torch.log(torch.diagonal(Lc)).sum()

    def stack(self, W):
        """K_b W[..., b] for every latent, W (r, n, q): bf16 operands, fp32
        sums."""
        cols = [(self.K[b].to(torch.float32) @ _bf16(W[..., b]).T).T
                for b in range(len(self.K))]
        return torch.stack(cols, -1)

    def matvec(self, V):
        return self.stack(V @ self.H) @ self.H.T + V @ self.St

    def minv(self, V):
        """M⁻¹V by Woodbury: S⁻¹V − S⁻¹U (I + UᵀS⁻¹U)⁻¹ UᵀS⁻¹V."""
        q, n, m = self.R.shape
        W = V @ self.Sinv
        u = torch.einsum("bnk,rnb->rbk", self.R, W @ self.H)
        z = (u.reshape(-1, q * m) @ self.capinv).reshape(-1, q, m)
        return W - torch.einsum("bnk,rbk->rnb", self.R, z) @ self.SinvH.T


def pcg(op, B, iters, tol):
    """Masked PCG on the columns B (r, n, T); returns X and the Lanczos
    coefficients (alphas, betas, active) and r₀ᵀM⁻¹r₀."""
    dot = lambda a, b: (a * b).sum((-2, -1))            # noqa: E731
    r = B.shape[0]
    bnorm = dot(B, B).clamp_min(1e-30).sqrt()
    X = torch.zeros_like(B)
    Res = B
    Z = op.minv(Res)
    P = Z
    rz = dot(Res, Z)
    rz0 = rz
    alphas, betas, active = [], [], []
    done = torch.zeros(r, dtype=torch.bool, device=B.device)
    for _ in range(iters):
        AP = op.matvec(P)
        pAp = dot(P, AP)
        brk = (pAp <= 0) & ~done
        skip = done | brk
        a = torch.where(skip, torch.ones_like(rz), rz / pAp.clamp_min(1e-30))
        upd = (~skip)[:, None, None]
        X = torch.where(upd, X + a[:, None, None] * P, X)
        Rn = torch.where(upd, Res - a[:, None, None] * AP, Res)
        Zn = op.minv(Rn)
        rzn = dot(Rn, Zn)
        b = torch.where(skip, torch.zeros_like(rz), rzn / rz.clamp_min(1e-30))
        P = torch.where(upd, Zn + b[:, None, None] * P,
                        torch.where(brk[:, None, None], Zn, P))
        alphas.append(a)
        betas.append(b)
        active.append(~skip)
        done = done | (dot(Rn, Rn).clamp_min(0).sqrt() / bnorm < tol)
        rz = torch.where(done, rz, rzn)
        Res = Rn
    return X, torch.stack(alphas), torch.stack(betas), torch.stack(active), rz0


def log_quadrature(alphas, betas, active):
    """e₁ᵀ log(T) e₁ for each column's Lanczos tridiagonal T (entries
    1/α_j + β_{j−1}/α_{j−1} and √β_j/α_j); steps after a column froze add
    an identity block. Ritz values are floored at 1e-10 of the largest."""
    one = torch.ones_like(alphas[:1])
    a_prev = torch.cat([one, alphas[:-1]])
    b_prev = torch.cat([torch.zeros_like(one), betas[:-1]])
    diag = torch.where(active, 1.0 / alphas.clamp_min(1e-30)
                       + b_prev / a_prev.clamp_min(1e-30), 1.0)
    nxt = torch.cat([active[1:], torch.zeros_like(active[:1])])
    off = torch.where(nxt & active,
                      betas.clamp_min(0).sqrt() / alphas.clamp_min(1e-30), 0.0)
    T = torch.diag_embed(diag.T) + torch.diag_embed(off[:-1].T, 1) \
        + torch.diag_embed(off[:-1].T, -1)
    ev, vec = torch.linalg.eigh(T)
    ev = torch.maximum(ev, 1e-10 * ev.abs().amax(-1, keepdim=True))
    return (vec[:, 0, :] ** 2 * torch.log(ev)).sum(-1)


def mll_and_grads(x, Y, ls, H, St, eps, xi, R, cfg):
    """(ℓ/(nT), ∂/∂ls (q, d), ∂/∂H, ∂/∂Σt) of the estimator."""
    n, t = Y.shape
    s = eps.shape[0]
    mll_kw = cfg["mll"]
    op = Operator(x, ls, H, St, R)
    z = eps @ op.Lt.T + torch.einsum("bnk,sbk->snb", R, xi) @ H.T
    X, al, be, act, rz0 = pcg(op, torch.cat([Y[None], z]),
                              mll_kw["max_cg_iters"], mll_kw["cg_tol"])
    alpha, W = X[0], X[1:]
    logquad = log_quadrature(al[:, 1:], be[:, 1:], act[:, 1:])
    ll = -0.5 * ((Y * alpha).sum() + op.logdet_M + (rz0[1:] * logquad).mean()
                 + n * t * math.log(2 * math.pi))
    g = 1.0 / (n * t)
    Zt = op.minv(z)
    Ah, WH, ZH = alpha @ H, W @ H, Zt @ H
    KR = op.stack(torch.cat([Ah[None], WH, ZH]))
    KAh, KWH, KZH = KR[0], KR[1:1 + s], KR[1 + s:]
    dH = g * (alpha.T @ KAh - 0.5 / s * (
        torch.einsum("snt,snb->tb", Zt, KWH)
        + torch.einsum("snt,snb->tb", W, KZH)))
    wz = torch.einsum("snt,snu->tu", W, Zt)
    dSt = g * 0.5 * (alpha.T @ alpha - (wz + wz.T) / (2 * s))
    xc = x - x.mean(0)
    dls = []
    for b, l in enumerate(ls):
        dK = 0.5 * torch.outer(Ah[:, b], Ah[:, b]) \
            - 0.25 / s * (WH[..., b].T @ ZH[..., b] + ZH[..., b].T @ WH[..., b])
        dls.append(lengthscale_grad(xc, l, g * dK))
    return ll * g, torch.stack(dls), dH, dSt


def train(x, Y, leaves, frozen, probes, cfg, steps):
    """``steps`` AdamW steps from ``leaves`` on the probes of each step
    (``probes[i]`` = (eps, xi)), the roots built from the starting leaves
    and kept, as at the start of a chunk. Returns (losses, first gradients,
    leaves after the steps) of the minimised −ℓ/(nT)."""
    with torch.no_grad():
        ls0, _, _ = parameters(leaves, frozen)
        R = nystrom_roots(x, ls0, cfg["mll"]["precond_rank"],
                          cfg["roots_jitter"])

    def loss_and_grads(cur, i):
        leaf = {k: v.detach().clone().requires_grad_(True)
                for k, v in cur.items()}
        ls, H, St = parameters(leaf, frozen)
        with torch.no_grad():
            mll, dls, dH, dSt = mll_and_grads(x, Y, ls, H, St, *probes[i], R,
                                              cfg)
        # chain the estimator's cotangents through the parametrization
        surrogate = -((dls * ls).sum() + (dH * H).sum() + (dSt * St).sum())
        grads = torch.autograd.grad(surrogate, list(leaf.values()))
        return -mll, dict(zip(leaf, grads))

    opt = cfg["optimizer"]
    return train_steps(leaves, loss_and_grads, steps, opt["lr"],
                       opt["weight_decay"])
