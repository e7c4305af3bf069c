"""Plain reference of the exact LMC's training step at SARCOS's full n, the
mathematics of ``lmc_exact_sarcos10k.py`` computed in row blocks so that it
fits on one card at n = 44,484.

The estimator, its gradient and AdamW are that file's, with its stated
departures (the stack products take bf16 operands and sum in fp32;
everything else is fp32 with TF32 off). What changes is only where the
n × n arrays live:

- each latent's kernel is built ``rows`` rows at a time, each block rounded
  straight to bf16, so that the stack is held once, in bf16 (q·n² entries,
  15.8 GB at n = 44,484), and never in fp32;
- a stack product converts one block of rows to fp32 at a time;
- the lengthscale gradient forms dK's rows block by block from its
  rank-(1 + 2s) factors, with the kernel's derivative, and sums their row
  and feature sums in float64.

One departure of its own: the PCG runs the breakdown guard of the program's
loop. A right-hand side whose step α = rᵀz/pᵀAp is NaN, infinite or
≤ 1e-30 is frozen at its last iterate as a converged one, and its later
steps are inactive; a step whose tridiagonal entry would not be finite is
left out of the quadrature with every later step of its column. Where the
10k file's loop has no such step the two agree.

It reads only what the benchmark made: the data, the starting leaves and
the probes; it computes the kernels, the roots, the preconditioner and the
steps itself, and imports nothing of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference.common import (kernel, matern25, matern25_dd2, softplus,
                              sqdist, train_steps)

NOISE_FLOOR = 1e-4
ROWS = 4096          # rows of an n × n block: 729 MB in fp32 at n = 44,484
# the stack's entries and the products' operands: bf16, as the
# configuration states (float32 gives the same estimator on fp32 products)
STACK = torch.bfloat16


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


def kernel_rows(x1, x2, ls, mu):
    """Matérn-2.5 rows K(x1, x2) of one latent on inputs centred on ``mu``
    (the mean of the whole x, so that a block's rows are those of the
    whole matrix)."""
    return matern25(sqdist((x1 - mu) / ls, (x2 - mu) / ls))


def nystrom_roots(x, ls, rank, jitter):
    """R_b = K_b(x, z) L_b⁻ᵀ with L_b L_bᵀ = K_b(z, z) + jitter·I at the
    landmarks z = x[⌊linspace(0, n − 1, rank)⌋], (q, n, rank): (n, rank)
    blocks, built whole."""
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


def _operand(t):
    """``t`` rounded once to the stack's type, in float32."""
    return t.to(STACK).to(torch.float32)


class Operator:
    """Σ, its preconditioner M and M⁻¹, for one set of parameters, the
    kernels held in bf16 and used ``rows`` rows at a time."""

    def __init__(self, x, ls, H, St, R, rows=None):
        xc = x - x.mean(0)
        mu = xc.mean(0)
        n = x.shape[0]
        self.rows = rows = rows or ROWS
        # the configuration's stack: each kernel rounded once to bf16
        self.K = []
        for l in ls:
            Kb = torch.empty((n, n), dtype=STACK, device=x.device)
            for i0 in range(0, n, rows):
                Kb[i0:i0 + rows] = kernel_rows(xc[i0:i0 + rows], xc, l, mu) \
                    .to(STACK)
            self.K.append(Kb)
        self.H, self.St, self.R = H, St, R
        q, n, m = R.shape
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
        sums, one block of rows converted to fp32 at a time."""
        out = torch.empty_like(W)
        n = W.shape[1]
        for b, Kb in enumerate(self.K):
            Wb = _operand(W[..., b]).T                     # (n, r)
            for i0 in range(0, n, self.rows):
                out[:, i0:i0 + self.rows, b] = \
                    (Kb[i0:i0 + self.rows].to(torch.float32) @ Wb).T
        return out

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
    coefficients (alphas, betas, active) and r₀ᵀM⁻¹r₀. A column restarts
    from its preconditioned residual when pᵀAp ≤ 0, and is frozen when
    its step is NaN, infinite or ≤ 1e-30 (the breakdown guard)."""
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
        step = rz / pAp.clamp_min(1e-30)
        brk = (pAp <= 0) & ~done
        frz = ~(done | brk) & ~(torch.isfinite(step) & (step > 1e-30))
        done = done | frz
        skip = done | brk
        a = torch.where(skip, torch.ones_like(rz), step)
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
    an identity block, and so do a step with α ≤ 1e-30 or a diagonal entry
    that is not finite and every later step of its column. Ritz values are
    floored at 1e-10 of the largest."""
    one = torch.ones_like(alphas[:1])
    a_prev = torch.cat([one, alphas[:-1]])
    b_prev = torch.cat([torch.zeros_like(one), betas[:-1]])
    diag = 1.0 / alphas.clamp_min(1e-30) + b_prev / a_prev.clamp_min(1e-30)
    bad = active & ~(torch.isfinite(diag) & (alphas > 1e-30))
    active = active & (torch.cumsum(bad.int(), 0) == 0)
    diag = torch.where(active, diag, 1.0)
    nxt = torch.cat([active[1:], torch.zeros_like(active[:1])])
    off = torch.where(nxt & active,
                      betas.clamp_min(0).sqrt() / alphas.clamp_min(1e-30), 0.0)
    T = torch.diag_embed(diag.T) + torch.diag_embed(off[:-1].T, 1) \
        + torch.diag_embed(off[:-1].T, -1)
    ev, vec = torch.linalg.eigh(T)
    ev = torch.maximum(ev, 1e-10 * ev.abs().amax(-1, keepdim=True))
    return (vec[:, 0, :] ** 2 * torch.log(ev)).sum(-1)


def lengthscale_grad(xc, ls, left, right, rows=None):
    """∂/∂l_d of Σ_ij dK_ij k(x_i, x_j) for one latent on centred inputs xc
    (n, d), dK = left rightᵀ (n, k) × (n, k) symmetric, formed ``rows`` rows
    at a time: −2/l_d³ Σ_ij G_ij (x_id − x_jd)² with G = dK ⊙ k′(r²), the
    sum expanded into row sums and one product, in float64."""
    rows = rows or ROWS
    a = xc / ls
    x = xc.double()
    sq = torch.zeros(xc.shape[1], dtype=torch.float64, device=xc.device)
    for i0 in range(0, xc.shape[0], rows):
        i1 = i0 + rows
        dK = left[i0:i1] @ right.T
        G = (dK * matern25_dd2(sqdist(a[i0:i1], a))).double()
        xb = x[i0:i1]
        sq += 2.0 * (G.sum(1) @ (xb * xb)) - 2.0 * ((G @ x) * xb).sum(0)
    return (-2.0 * sq / ls.double() ** 3).to(xc.dtype)


def mll_and_grads(x, Y, ls, H, St, eps, xi, R, cfg, rows=None):
    """(ℓ/(nT), ∂/∂ls (q, d), ∂/∂H, ∂/∂Σt) of the estimator, its n × n
    arrays ``rows`` rows at a time (``ROWS`` when None)."""
    n, t = Y.shape
    s = eps.shape[0]
    mll_kw = cfg["mll"]
    op = Operator(x, ls, H, St, R, rows)
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
    del op
    KAh, KWH, KZH = KR[0], KR[1:1 + s], KR[1 + s:]
    dH = g * (alpha.T @ KAh - 0.5 / s * (
        torch.einsum("snt,snb->tb", Zt, KWH)
        + torch.einsum("snt,snb->tb", W, KZH)))
    wz = torch.einsum("snt,snu->tu", W, Zt)
    dSt = g * 0.5 * (alpha.T @ alpha - (wz + wz.T) / (2 * s))
    xc = x - x.mean(0)
    dls = []
    for b, l in enumerate(ls):
        # g·dK = left rightᵀ: ½ (αh_b)(αh_b)ᵀ − ¼/s Σ_i (W_i h_b (Z_i h_b)ᵀ
        # + Z_i h_b (W_i h_b)ᵀ), scaled by g
        left = torch.cat([(0.5 * g) * Ah[:, b, None],
                          (-0.25 / s * g) * WH[..., b].T,
                          (-0.25 / s * g) * ZH[..., b].T], 1)
        right = torch.cat([Ah[:, b, None], ZH[..., b].T, WH[..., b].T], 1)
        dls.append(lengthscale_grad(xc, l, left, right, rows))
    return ll * g, torch.stack(dls), dH, dSt


def train(x, Y, leaves, frozen, probes, cfg, steps, rows=None):
    """``steps`` AdamW steps from ``leaves`` on the probes of each step
    (``probes[i]`` = (eps, xi)), the roots built from the starting leaves
    and kept, as at the start of a chunk. Returns (losses, first gradients,
    leaves after the steps) of the minimised −ℓ/(nT). ``rows``: the rows
    of an n × n block (``ROWS`` when None)."""
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
                                              cfg, rows)
        # chain the estimator's cotangents through the parametrization
        surrogate = -((dls * ls).sum() + (dH * H).sum() + (dSt * St).sum())
        grads = torch.autograd.grad(surrogate, list(leaf.values()))
        return -mll, dict(zip(leaf, grads))

    opt = cfg["optimizer"]
    return train_steps(leaves, loss_and_grads, steps, opt["lr"],
                       opt["weight_decay"])
