"""PSD-safe Cholesky with an escalating jitter ladder and a hand-written
backward (port of ``projected_lmc_tpu/ops/cholesky.py``).

The JAX ladder is a ``lax.while_loop`` that stops at the first factor that
succeeds: a failed factorization there yields NaNs, which is the loop's
predicate. Here ``torch.linalg.cholesky_ex`` reports failure in ``info``;
the ladder reads it on the host (one sync a rung) and factorizes again, with
jitter 1e-6·10^k (fp32), only when a batch element failed. The jitter
picked is the first that factors every batch element, as in JAX.
"""

from __future__ import annotations

import torch

# gpytorch.settings.cholesky_jitter defaults: 1e-6 (float32) / 1e-8 (float64)
_BASE_JITTER = {torch.float32: 1e-6, torch.float64: 1e-8, torch.bfloat16: 1e-3}
MAX_TRIES = 8


def cholesky_nan(A):
    """Lower Cholesky factor; NaN where a batch element is not positive
    definite (JAX's failure mode), with no host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _factor(A):
    """(L, bad): the lower factor and, per batch element, whether it failed
    (``info`` ≠ 0 or a non-finite diagonal, which a NaN anywhere in a row
    reaches)."""
    L, info = torch.linalg.cholesky_ex(A)
    diag_ok = torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)
    return L, (info != 0) | ~diag_ok


def _jittered_cholesky(A, max_tries: int, agree=None):
    """(L, jitter): the factor and the jitter of the rung that gave it (0
    when A factored as it is; the last rung's when every rung failed).
    ``agree`` (a mesh's ``latent_any``) turns this rank's "some element
    failed" into the latent group's, so that the ranks holding one batch
    between them climb the ladder together, as one batch would."""
    L, bad = _factor(A)
    jitter = _BASE_JITTER.get(A.dtype, 1e-6)
    used = 0.0
    for _ in range(max_tries):
        failed = bad.any() if agree is None else agree(bad.any())
        if not bool(failed):
            return L, used
        Aj = A.clone()
        Aj.diagonal(dim1=-2, dim2=-1).add_(jitter)
        L, bad = _factor(Aj)
        used = jitter
        jitter *= 10.0
    if bool(bad.any()):     # every rung failed: NaN where it did, as in JAX
        L = torch.where(bad[..., None, None], torch.full_like(L, float("nan")),
                        L)
    return L, used


def _phi(X):
    """tril with halved diagonal — the Cholesky pullback projector."""
    return torch.tril(X) - 0.5 * torch.diag_embed(
        torch.diagonal(X, dim1=-2, dim2=-1))


class _SafeCholesky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, max_tries, agree):
        L, _ = _jittered_cholesky(A, max_tries, agree)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, L_bar):
        (L,) = ctx.saved_tensors
        # A_bar = L^{-T} Φ(Lᵀ L̄) L^{-1}, symmetrized (callers build A
        # symmetrically)
        Lt = L.transpose(-1, -2)
        P = _phi(Lt @ L_bar)
        X = torch.linalg.solve_triangular(Lt, P, upper=True)
        A_bar = torch.linalg.solve_triangular(
            Lt, X.transpose(-1, -2), upper=True).transpose(-1, -2)
        return 0.5 * (A_bar + A_bar.transpose(-1, -2)), None, None


def safe_cholesky(A, max_tries: int = MAX_TRIES, agree=None):
    """Lower Cholesky factor of ``A`` (+ escalating jitter on failure),
    batched over leading dimensions; ``agree`` as in
    :func:`_jittered_cholesky`."""
    return _SafeCholesky.apply(A, max_tries, agree)


def safe_cholesky_with_jitter(A, max_tries: int = MAX_TRIES):
    """Like :func:`safe_cholesky`, but also returns the jitter the ladder
    added, as a 0-d tensor of A's dtype. The jitter is found on a detached
    A and carries no gradient; L is the factor of A + jitter·I, with the
    Cholesky pullback to A."""
    with torch.no_grad():
        _, jitter = _jittered_cholesky(A.detach(), max_tries)
    L = safe_cholesky(add_jitter(A, jitter), 1)
    return L, torch.tensor(jitter, dtype=A.dtype, device=A.device)


def solve_triangular(L, B, *, lower=True, trans=False):
    """Batched triangular solve op(L) X = B."""
    if trans:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), B,
                                             upper=lower)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def cho_solve(L, B):
    """Solve (L Lᵀ) X = B given the lower factor L; batched."""
    return torch.cholesky_solve(B, L, upper=False)


def logdet_from_chol(L):
    """log det(L Lᵀ) = 2 Σ log diag(L); batched."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def chol_inverse_diag(L):
    """diag((L Lᵀ)⁻¹) from the full inverse of the factor, batched; the
    exact LOO identities σᵢ² = 1/[K⁻¹]ᵢᵢ. Differentiable (the LOO
    pseudo-likelihood trains through it)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return (Linv * Linv).sum(-2)


def add_jitter(A, jitter):
    return A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def symmetrize(A):
    """½ (A + Aᵀ) over the last two axes; batched."""
    return 0.5 * (A + A.transpose(-1, -2))
