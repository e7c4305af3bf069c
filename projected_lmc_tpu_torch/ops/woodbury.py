"""Exact LMC marginal likelihood and posterior by the matrix-determinant
lemma (port of ``projected_lmc_tpu/ops/woodbury.py``).

With f = (H ⊗ I) u the LMC covariance is

    Cov = D + A G Aᵀ,   D = I_n ⊗ Σt,   G = blockdiag(K_b),   A[(i,t),(b,j)] = H[t,b] δ_ij

and with G = L Lᵀ (one batched Cholesky over the q latents, or low-rank
roots) the capacitance Cap = I_{qr} + L_Gᵀ (C ⊗ I) L_G, C = Hᵀ Σt⁻¹ H (q×q),
gives logdet Cov = n·logdet Σt + logdet Cap and Woodbury solves. Every step
is a batched Cholesky, a triangular solve or a large product (true fp32 on
the card, see ``utils.device``). The posterior variance runs over test
points a chunk at a time, in a Python loop; with low-rank (SGPR) roots,
``lmc_sgpr_posterior`` gives it through the capacitance alone.
"""

from __future__ import annotations

import math

import torch

from .cholesky import (add_jitter, cho_solve, logdet_from_chol,
                       safe_cholesky, solve_triangular)


def lmc_factors(Ks, H, Sigma_t, jitter: float = 1e-6):
    """The Woodbury factors from dense latent kernels Ks (q, n, n), H (t, q)
    and Σt (t, t): the roots are the n×n Cholesky factors."""
    return lmc_factors_from_roots(safe_cholesky(add_jitter(Ks, jitter)), H,
                                  Sigma_t)


def lmc_gram(roots):
    """The capacitance Gram Ltallᵀ Ltall, (q·r, q·r), of roots R (q, n, r),
    Ltall[m, (c,l)] = R[c,m,l]: one (q·r, n)·(n, q·r) product. Over a
    rank's rows under a mesh it is a partial sum."""
    q, n, r = roots.shape
    Ltall = roots.permute(1, 0, 2).reshape(n, q * r)
    return Ltall.T @ Ltall


def lmc_factors_from_roots(roots, H, Sigma_t, gram=None, n: int = None):
    """Woodbury factors for Σ = Σ_b (R_b R_bᵀ) ⊗ h_b h_bᵀ + I ⊗ Σt, roots
    R (q, n, r): dict with L_G = R, Rt = chol(Σt), C, SinvH, L_cap, H and
    the sizes q, n, r. The capacitance's blocks C[b,c]·L_bᵀL_c come from
    ``lmc_gram`` of the roots, or from the given ``gram`` of all n rows
    when ``roots`` holds some of them (a rank's rows under a mesh, whose
    partial Grams are summed)."""
    q, rows, r = roots.shape
    n = rows if n is None else n
    Rt = safe_cholesky(Sigma_t)
    SinvH = cho_solve(Rt, H)                        # Σt⁻¹ H  (t, q)
    C = H.T @ SinvH                                 # (q, q)
    P = (lmc_gram(roots) if gram is None else gram).reshape(q, r, q, r)
    cap = (C[:, None, :, None] * P).reshape(q * r, q * r) \
        + torch.eye(q * r, dtype=roots.dtype, device=roots.device)
    return dict(L_G=roots, Rt=Rt, C=C, SinvH=SinvH, L_cap=safe_cholesky(cap),
                H=H, q=q, n=n, r=r)


def lmc_sums(Ydelta, roots, H, Rt):
    """W = Y Σt⁻¹ (n, t), s = L_Gᵀ u (q, r) with u = Aᵀ D⁻¹ vec(Y) as
    (q, n), and Σ Y·W, over the rows of Ydelta (n, t) and of the roots
    L_G (q, n, r); Rt = chol(Σt). Over a rank's rows under a mesh, s and
    Σ Y·W are partial sums."""
    W = cho_solve(Rt, Ydelta.T).T
    s = torch.einsum("bnk,bn->bk", roots, (W @ H).T)
    return W, s, (Ydelta * W).sum()


def lmc_log_prob(Ks, H, Sigma_t, Ydelta, jitter: float = 1e-6, fac=None,
                 sums=None):
    """log N(vec(Y); 0, Σ_b K_b ⊗ h_b h_bᵀ + I ⊗ Σt), exact and dense;
    Ydelta (n, t). ``sums``: (s, Σ Y·W) of ``lmc_sums`` summed over all n
    rows when the caller has them (a mesh's ranks), Ydelta then unread."""
    if fac is None:
        fac = lmc_factors(Ks, H, Sigma_t, jitter)
    n, t = fac["n"], H.shape[0]
    s, yw = lmc_sums(Ydelta, fac["L_G"], H, fac["Rt"])[1:] \
        if sums is None else sums
    v = solve_triangular(fac["L_cap"], s.reshape(-1, 1), lower=True)
    quad = yw - (v * v).sum()
    logdet = n * logdet_from_chol(fac["Rt"]) + logdet_from_chol(fac["L_cap"])
    return -0.5 * (quad + logdet + n * t * math.log(2 * math.pi))


def lmc_solve(Ydelta, fac, s=None):
    """α (n, t) with vec(α) = Cov⁻¹ vec(Y). With ``s`` = L_Gᵀ u summed over
    all n rows (``lmc_sums`` over a mesh's ranks), α for the rows of
    Ydelta and of fac's L_G."""
    W, s_rows, _ = lmc_sums(Ydelta, fac["L_G"], fac["H"], fac["Rt"])
    s = s_rows if s is None else s
    z = cho_solve(fac["L_cap"], s.reshape(-1, 1)).reshape(fac["q"], fac["r"])
    t2 = torch.einsum("bnk,bk->bn", fac["L_G"], z)             # L_G z (q, n)
    return W - t2.T @ fac["SinvH"].T


def lmc_sgpr_posterior(roots_star, fac, alpha, mean_star, noise: bool = True,
                       chunk: int = 512, kss_star=None, u=None):
    """Posterior (mean, variance diagonal), both (n*, t), of the low-rank
    (Nyström) LMC/ICM model from its Woodbury factors ``fac`` (roots
    (q, n, m)) and α (n, t) = Σ⁻¹ vec(Y).

    With Σ = U Uᵀ + I ⊗ Σt, U = [R_b ⊗ h_b], and U* = [R*_b ⊗ h_b] at the
    test points (``roots_star`` (q, n*, m)), Uᵀ Σ⁻¹ U = I − Cap⁻¹, so the
    posterior covariance is U* Cap⁻¹ U*ᵀ: one triangular solve against the
    (q·m)² capacitance factor for each chunk of ``chunk`` test points (a
    Python loop), and no (n, n*) cross-covariance. Mean U*(Uᵀα) + m(x*).
    ``kss_star`` (q, n*) adds the low-rank gap Σ_b clip(kss_b −
    diag(R*_b R*_bᵀ), 0)·H[t,b]², so that the variance reverts to the prior
    away from the inducing points; ``noise`` adds diag(Σt). Clipped at
    1e-12. ``u`` (q, m): R_bᵀ(α h_b) when the caller has it (the models'
    "sgpr" caches, whose fac holds no roots), else computed from fac's."""
    H, L_cap = fac["H"], fac["L_cap"]
    q, n_star, r = roots_star.shape
    t = H.shape[0]
    if u is None:
        u = torch.einsum("bnk,nb->bk", fac["L_G"], alpha @ H)   # R_bᵀ(αh_b)
    mean = torch.einsum("bik,bk->ib", roots_star, u) @ H.T + mean_star

    def chunk_var(Rc):                                          # (q, c, m)
        c = Rc.shape[1]
        W = torch.einsum("bik,tb->bkit", Rc, H).reshape(q * r, c * t)
        V = solve_triangular(L_cap, W, lower=True)
        return (V * V).sum(0).reshape(c, t)

    var = torch.cat([chunk_var(roots_star[:, i:i + chunk])
                     for i in range(0, n_star, chunk)])
    if kss_star is not None:
        gap = torch.clamp(kss_star - (roots_star * roots_star).sum(-1),
                          min=0.0)                              # (q, n*)
        var = var + gap.T @ (H * H).T
    if noise:
        Rt = fac["Rt"]
        var = var + torch.diagonal(Rt @ Rt.T)[None, :]
    return mean, torch.clamp(var, min=1e-12)


def lmc_posterior_mean(Kstars, H, alpha, mean_star):
    """mean (n*, t) = Σ_b (K*_b (α h_b)) h_bᵀ + m(x*); Kstars (q, n*, n)."""
    proj = torch.einsum("bmi,ib->mb", Kstars, alpha @ H)       # (n*, q)
    return proj @ H.T + mean_star


def lmc_posterior_variance(Kstars, Kstar_diag, H, Sigma_t, fac,
                           noise: bool = True, chunk: int = 256):
    """Posterior variance diagonal (n*, t) of the LMC model (+ observation
    noise), clipped at 1e-6:

      prior       Σ_b diag(K**_b)[i] H[t,b]² (+ Σt[t,t])
      correction  diag(Cross Cov⁻¹ Crossᵀ) by the same Woodbury split,
                  ``chunk`` test points at a time (the chunk's (q, n, c, t)
                  intermediate is its largest object)."""
    q, n_star, n = Kstars.shape
    t = H.shape[0]
    prior = Kstar_diag.T @ (H * H).T                            # (n*, t)
    if noise:
        prior = prior + torch.diagonal(Sigma_t)[None, :]
    C, L_G, L_cap = fac["C"], fac["L_G"], fac["L_cap"]
    CH = C[:, None, :] * H[None]                    # CH[b,t,d] = C[b,d] H[t,d]
    CHH = (CH * H.T[:, :, None]).transpose(1, 2)    # C[b,d] H[t,b] H[t,d]

    def chunk_corr(Kc):                                         # (q, c, n)
        c = Kc.shape[1]
        # term1[(i,t)] = Σ_{b,d} C[b,d] H[t,b] H[t,d] Σ_j Kc_b[i,j] Kc_d[i,j]
        rowdot = torch.einsum("bij,dij->bdi", Kc, Kc)           # (q, q, c)
        term1 = rowdot.reshape(q * q, c).T @ CHH.reshape(q * q, t)
        # E[(b,j),(i,t)] = Σ_d C[b,d] K_d[i,j] H[t,d] = Aᵀ D⁻¹ Crossᵀ
        E = torch.einsum("btd,dij->bjit", CH, Kc)               # (q, n, c, t)
        Nmat = torch.einsum("bnk,bnit->bkit", L_G, E)           # L_Gᵀ E
        V = solve_triangular(L_cap, Nmat.reshape(q * L_G.shape[-1], c * t),
                             lower=True)
        return term1 - (V * V).sum(0).reshape(c, t)

    corr = torch.cat([chunk_corr(Kstars[:, i:i + chunk])
                      for i in range(0, n_star, chunk)])
    return torch.clamp(prior - corr, min=1e-6)
