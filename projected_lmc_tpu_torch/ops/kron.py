"""Kronecker joint-diagonalization solvers for the exact ICM (port of
``projected_lmc_tpu/ops/kron.py``).

The ICM covariance is K ⊗ B + I_n ⊗ Σt (task-interleaved layout). With
Σt = Rt Rtᵀ, K = U Λ Uᵀ and Rt⁻¹ B Rt⁻ᵀ = V Γ Vᵀ,

    K ⊗ B + I ⊗ Σt = (I⊗Rt)(U⊗V)(Λ⊗Γ + I)(U⊗V)ᵀ(I⊗Rt)ᵀ,

so two small eigendecompositions (n×n and t×t) replace any (nt)³
factorization. The training MLL, :func:`icm_log_prob_chol`, eigendecomposes
only the t×t factor and factors the t blocks γ_j K + I by one batched
Cholesky; its backward is analytic (no gradient ever passes through
``eigh``). Every contraction is a plain product that the JAX package left
to XLA, so it goes to torch/cuBLAS.

Under a mesh (``icm_log_prob_chol(mesh=)``) the forward's t Cholesky
blocks split over the ranks (``Mesh.world_range``: T = 7 on 4 ranks is
2/2/2/1) and their partial quadratic forms and log-determinants are summed
in one ``all_reduce``; every rank holds the whole K and runs the whole
backward, its n×n ``eigh`` included (no distributed eigensolver), so every
rank carries the whole gradient.
"""

from __future__ import annotations

import math

import torch

from .blocked_cholesky import cholesky_bf16_blocked
from .cholesky import logdet_from_chol, safe_cholesky, solve_triangular


def symmetrize(A):
    return 0.5 * (A + A.transpose(-1, -2))


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _whitened_task_eig(B, Sigma_t):
    """Rt = chol(Σt) and the eigenpairs (γ clipped at 0, V) of
    B̃ = Rt⁻¹ B Rt⁻ᵀ. B̃ ⪰ 0; eigh's rounding can dip a hair below 0, which
    would make γK + I indefinite or an S entry λγ + 1 reach ~0."""
    Rt = safe_cholesky(Sigma_t)
    tmp = solve_triangular(Rt, B, lower=True)
    B_tilde = solve_triangular(Rt, tmp.T, lower=True).T
    gam, V = torch.linalg.eigh(symmetrize(B_tilde))
    return Rt, torch.clamp(gam, min=0.0), V


def icm_eig_factors(K, B, Sigma_t, jitter: float = 1e-8):
    """Joint diagonalization factors of K ⊗ B + I ⊗ Σt: a dict with Rt
    (chol Σt), U, lam (eig K + jitter·I), V, gam (eig of the whitened B)
    and S = lam ⊗ gam + 1 as an (n, t) grid."""
    Rt, gam, V = _whitened_task_eig(B, Sigma_t)
    lam, U = torch.linalg.eigh(symmetrize(K + jitter * _eye(K.shape[-1], K)))
    S = lam[:, None] * gam[None, :] + 1.0
    return dict(Rt=Rt, U=U, lam=lam, V=V, gam=gam, S=S)


def icm_whiten(Y, fac):
    """Z = (U⊗V)ᵀ (I⊗Rt)⁻¹ vec(Y), computed as Uᵀ (Y Rt⁻ᵀ) V for Y (n, t)."""
    W = solve_triangular(fac["Rt"], Y.T, lower=True).T     # Y Rt^{-T}
    return fac["U"].T @ W @ fac["V"]


def icm_log_prob(K, B, Sigma_t, Ydelta, jitter: float = 1e-8):
    """log N(vec(Y); 0, K⊗B + I⊗Σt), exact, by the joint diagonalization
    (autograd passes through both ``eigh``; training uses
    :func:`icm_log_prob_chol`)."""
    n, t = Ydelta.shape
    fac = icm_eig_factors(K, B, Sigma_t, jitter)
    Z = icm_whiten(Ydelta, fac)
    quad = (Z * Z / fac["S"]).sum()
    logdet = n * logdet_from_chol(fac["Rt"]) + torch.log(fac["S"]).sum()
    return -0.5 * (quad + logdet + n * t * math.log(2 * math.pi))


class _IcmLogProbChol(torch.autograd.Function):
    """Forward: one t×t eigh and the batched (t, n, n) Cholesky of
    γ_j (K + jitter·I) + I. Backward: the JAX package's analytic
    ``_icm_chol_bwd``, the ½(αᵀ dΣ α − tr(Σ⁻¹ dΣ)) split evaluated in the
    joint eigenbasis, where only eigen-projections enter (degenerate
    eigenvalues are harmless)."""

    @staticmethod
    def forward(ctx, K, B, Sigma_t, Ydelta, jitter, chol_bf16, chol_block,
                mesh):
        n, t = Ydelta.shape
        Rt, gam, V = _whitened_task_eig(B, Sigma_t)
        W = solve_triangular(Rt, Ydelta.T, lower=True).T     # Y Rt^{-T}
        Z = W @ V                                            # (n, t)
        # the rank's blocks j0..j1 − 1 (all t without a mesh)
        j0, j1 = (0, t) if mesh is None else mesh.world_range(t)
        eye = _eye(n, K)
        A = gam[j0:j1, None, None] * (K + jitter * eye)[None] + eye[None]
        L = cholesky_bf16_blocked(A, chol_block) if chol_bf16 \
            else safe_cholesky(A, agree=None if mesh is None
                               else mesh.world_any)         # (t, n, n)
        del A
        sol = solve_triangular(L, Z.T[j0:j1, :, None], lower=True)[..., 0]
        quad = (sol * sol).sum()
        logdet_L = logdet_from_chol(L).sum()
        if mesh is not None:
            parts = mesh.world_sum_(torch.stack([quad, logdet_L]))
            quad, logdet_L = parts[0], parts[1]
        logdet = n * logdet_from_chol(Rt) + logdet_L
        ctx.save_for_backward(K, B, Sigma_t, Ydelta)
        ctx.jitter = jitter
        return -0.5 * (quad + logdet + n * t * math.log(2 * math.pi))

    @staticmethod
    def backward(ctx, g):
        K, B, Sigma_t, Ydelta = ctx.saved_tensors
        # mixed-precision callers (an fp32 likelihood on an fp64 model):
        # compute in the promoted dtype, return each cotangent in its
        # primal's own dtype
        ct = K.dtype
        for a in (B, Sigma_t, Ydelta):
            ct = torch.promote_types(ct, a.dtype)
        Kp, Bp, Stp, Yp = (a.to(ct) for a in (K, B, Sigma_t, Ydelta))
        g = g.to(ct)
        fac = icm_eig_factors(Kp, Bp, Stp, jitter=ctx.jitter)
        A = icm_solve(Yp, fac)                               # (n, t)
        lam, gam, S = fac["lam"], fac["gam"], fac["S"]
        U, V, Rt = fac["U"], fac["V"], fac["Rt"]
        Sinv = 1.0 / S
        w = Sinv @ gam                                       # (n,)
        v = lam @ Sinv                                       # (t,)
        u = Sinv.sum(0)                                      # (t,)
        MK = (U * w[None, :]) @ U.T
        P = solve_triangular(Rt.T, V, lower=False)           # Rt^{-T} V
        MB = (P * v[None, :]) @ P.T
        MS = (P * u[None, :]) @ P.T
        Kj = Kp + ctx.jitter * _eye(K.shape[-1], Kp)
        dK = ((0.5 * g) * (A @ Bp @ A.T - MK)).to(K.dtype)
        dB = ((0.5 * g) * (A.T @ Kj @ A - MB)).to(B.dtype)
        dSt = ((0.5 * g) * (A.T @ A - MS)).to(Sigma_t.dtype)
        dY = (-g * A).to(Ydelta.dtype)
        return dK, dB, dSt, dY, None, None, None, None


def icm_log_prob_chol(K, B, Sigma_t, Ydelta, jitter: float = 1e-8,
                      chol_bf16: bool = False, chol_block: int = 1024,
                      mesh=None):
    """log N(vec(Y); 0, K⊗B + I⊗Σt) by the batched Cholesky — the training
    variant of :func:`icm_log_prob`, with its analytic backward:

        K⊗B + I⊗Σt = (I⊗Rt)(I⊗V)[K⊗Γ + I](I⊗V)ᵀ(I⊗Rt)ᵀ.

    Only the t×t whitened task covariance is eigendecomposed in the forward;
    the backward recomputes the eigen factors (an n×n ``eigh``) as forward
    factorizations. ``chol_bf16`` factors the t blocks by the blocked
    Cholesky with bf16 trailing updates (``ops/blocked_cholesky``, blocks of
    ``chol_block``): opt-in, for well-conditioned operators (condition
    ≲ 250), as its noise is a ~4e-3 perturbation of the operator. The
    backward stays the exact analytic one, as in the JAX package. With
    ``mesh`` the rank factors its share of the t blocks (the value is the
    same on every rank); K, B, Σt and Y are whole on every rank."""
    return _IcmLogProbChol.apply(K, B, Sigma_t, Ydelta, float(jitter),
                                 bool(chol_bf16), int(chol_block), mesh)


def icm_solve(Ydelta, fac):
    """α with vec(α) = (K⊗B + I⊗Σt)⁻¹ vec(Y); α has shape (n, t)."""
    Zt = icm_whiten(Ydelta, fac) / fac["S"]
    A = fac["U"] @ Zt @ fac["V"].T
    # (I ⊗ Rt^{-T}): right-multiply by Rt^{-1}, i.e. solve Rtᵀ Xᵀ = Aᵀ
    return solve_triangular(fac["Rt"].T, A.T, lower=False).T


def icm_posterior_mean(K_star, B, alpha, mean_star):
    """Posterior mean (n*, t): K_* α B + m(x*)."""
    return K_star @ alpha @ B + mean_star


def icm_posterior_variance(K_star_diag, K_star_train, B, fac, noise_diag=None,
                           chunk: int = 1024):
    """Posterior variance diagonal (n*, t) of the ICM model:

      first  = diag(K** ⊗ B [+ Σ_noise])
      second[(i,t)] = Σ_{j,s} k̂²[i,j] Ĉ²[t,s] / S[j,s]

    with k̂ = K_*x U and Ĉ = B Rt⁻ᵀ V, over ``chunk`` test points at a time
    (rows are independent, so the chunking leaves the result as it is).
    Clipped at 1e-6."""
    U, V, Rt, S = fac["U"], fac["V"], fac["Rt"], fac["S"]
    first = K_star_diag[:, None] * torch.diagonal(B)[None, :]
    if noise_diag is not None:
        first = first + noise_diag[None, :]
    C_hat = solve_triangular(Rt, B, lower=True).T @ V       # B Rt^{-T} V
    M = (C_hat * C_hat) @ (1.0 / S).T                       # (t, n)
    second = []
    for start in range(0, K_star_train.shape[0], chunk):
        k_hat = K_star_train[start:start + chunk] @ U
        second.append((k_hat * k_hat) @ M.T)
    return torch.clamp(first - torch.cat(second), min=1e-6)
