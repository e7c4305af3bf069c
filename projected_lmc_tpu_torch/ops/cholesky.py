"""PSD-safe Cholesky with an escalating jitter ladder and a hand-written
backward (port of ``projected_lmc_tpu/ops/cholesky.py``).

The JAX ladder is a ``lax.while_loop`` that stops at the first factor that
succeeds: a failed factorization there yields NaNs, which is the loop's
predicate. Here ``torch.linalg.cholesky_ex`` reports failure in ``info``;
the ladder reads it on the host (one sync a rung) and factorizes again, with
jitter 1e-6·10^k (fp32), only when a batch element failed. The jitter
picked is the first that factors every batch element, as in JAX.

A Gaussian log-density on a dense covariance (:func:`gaussian_log_density`)
takes the ladder's factor and differentiates in closed form, from K⁻¹ by a
blocked inverse of the factor (:func:`cholesky_inverse`); every other
caller of the factor keeps the generic Cholesky pullback.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import count, span

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
    count("cholesky.try")
    L, info = torch.linalg.cholesky_ex(A)
    diag_ok = torch.isfinite(torch.diagonal(L, dim1=-2, dim2=-1)).all(-1)
    return L, (info != 0) | ~diag_ok


def _jittered_cholesky(A, max_tries: int, agree=None):
    """(L, jitter): the factor and the jitter of the rung that gave it (0
    when A factored as it is; the last rung's when every rung failed).
    ``agree`` (a mesh's ``latent_any``) turns this rank's "some element
    failed" into the latent group's, so that the ranks holding one batch
    between them climb the ladder together, as one batch would."""
    with span("cholesky.factor"):
        count("cholesky.factor")
        L, bad = _factor(A)
        jitter = _BASE_JITTER.get(A.dtype, 1e-6)
        used = 0.0
        for _ in range(max_tries):
            if agree is None:
                count("host_read")
                failed = bool(bad.any())
            else:
                failed = agree(bad.any())
            if not failed:
                return L, used
            Aj = A.clone()
            Aj.diagonal(dim1=-2, dim2=-1).add_(jitter)
            L, bad = _factor(Aj)
            used = jitter
            jitter *= 10.0
        count("host_read")
        if bool(bad.any()):     # every rung failed: NaN where it did (JAX)
            L = torch.where(bad[..., None, None],
                            torch.full_like(L, float("nan")), L)
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
        with span("cholesky.pullback"):
            count("cholesky.pullback")
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


# Rows of the diagonal blocks that the blocked inverse hands to the
# library's triangular solve; a larger block is halved (at least 128, so
# that both halves of a split have rows).
INVERSE_LEAF = 512
# Rows of a triangular factor that a product takes whole, its zero
# triangle included; a larger factor is halved and its zero corner skipped.
# Both measured on an H100 at (4, 10⁴, 10⁴): 92.0 ms, flat within 1.5 ms
# from leaves of 256 to 1,024 and products of 512 to 1,024 rows.
TRI_MM_LEAF = 1024


def _halve(n: int) -> int:
    """Where a block of n > 128 rows splits: near the middle, on a
    multiple of 128 rows."""
    return (n // 2 + 64) // 128 * 128


def _tri_mm_(out, T, B, upper: bool, alpha: float = 1.0, beta: float = 0.0):
    """out ← β out + α T B for a batch of triangular T (B, m, m) whose
    other triangle is zero, B (B, m, k): by halves of T down to
    ``TRI_MM_LEAF`` rows, so that its zero corner costs nothing; the
    blocks' products are batched GEMMs. β = 0 reads nothing of out."""
    m = T.shape[-1]
    if m <= TRI_MM_LEAF:
        out.baddbmm_(T, B, beta=beta, alpha=alpha)
        return
    h = _halve(m)
    top, bot = out[:, :h], out[:, h:]
    _tri_mm_(top, T[:, :h, :h], B[:, :h], upper, alpha, beta)
    _tri_mm_(bot, T[:, h:, h:], B[:, h:], upper, alpha, beta)
    if upper:
        top.baddbmm_(T[:, :h, h:], B[:, h:], alpha=alpha)
    else:
        bot.baddbmm_(T[:, h:, :h], B[:, :h], alpha=alpha)


def _syrk_lower_(out, B):
    """out += BᵀB on and below the diagonal, for B (B, k, m) and out
    (B, m, m), by halves down to ``TRI_MM_LEAF`` rows (the blocks above
    the diagonal of a leaf are written too; those of a split are not)."""
    m = out.shape[-1]
    if m <= TRI_MM_LEAF:
        out.baddbmm_(B.transpose(-1, -2), B)
        return
    h = _halve(m)
    B1, B2 = B[:, :, :h], B[:, :, h:]
    out[:, h:, :h].baddbmm_(B2.transpose(-1, -2), B1)
    _syrk_lower_(out[:, :h, :h], B1)
    _syrk_lower_(out[:, h:, h:], B2)


def _tri_inverse_(W):
    """W ← W⁻¹ in place, for a batch (B, n, n) of lower triangular W whose
    upper triangle is zero; it stays zero. By halves: the inverse of
    [A 0; B C] is [A⁻¹ 0; −C⁻¹ B A⁻¹ C⁻¹], the diagonal blocks first."""
    n = W.shape[-1]
    if n <= INVERSE_LEAF:
        eye = torch.eye(n, dtype=W.dtype, device=W.device)
        W.copy_(torch.linalg.solve_triangular(W, eye.expand_as(W),
                                              upper=False))
        return
    h = _halve(n)
    A, B, C = W[:, :h, :h], W[:, h:, :h], W[:, h:, h:]
    _tri_inverse_(A)
    _tri_inverse_(C)
    BA = torch.empty_like(B)
    # B A⁻¹ = (A⁻ᵀ Bᵀ)ᵀ: a product with an upper triangular factor
    _tri_mm_(BA.transpose(-1, -2), A.transpose(-1, -2),
             B.transpose(-1, -2), upper=True)
    _tri_mm_(B, C, BA, upper=False, alpha=-1.0)


def _lauum_(W):
    """W ← the lower triangle of WᵀW in place, for a batch (B, n, n) of
    lower triangular W with a zero upper triangle; what lands above the
    diagonal is left for :func:`_mirror_`. By halves, top-left first:
    [A 0; B C]ᵀ[A 0; B C] = [AᵀA + BᵀB, ·; CᵀB, CᵀC]."""
    n = W.shape[-1]
    if n <= INVERSE_LEAF:
        W.copy_(W.transpose(-1, -2) @ W)
        return
    h = _halve(n)
    A, B, C = W[:, :h, :h], W[:, h:, :h], W[:, h:, h:]
    _lauum_(A)
    _syrk_lower_(A, B)
    CB = torch.empty_like(B)
    _tri_mm_(CB, C.transpose(-1, -2), B, upper=True)
    B.copy_(CB)
    del CB
    _lauum_(C)


def _mirror_(X):
    """Copy the lower triangle of X (B, n, n) onto its upper one, in place,
    block by block as :func:`_lauum_` laid it out."""
    n = X.shape[-1]
    if n <= INVERSE_LEAF:
        X.copy_(torch.tril(X) + torch.tril(X, -1).transpose(-1, -2))
        return
    h = _halve(n)
    X[:, :h, h:].copy_(X[:, h:, :h].transpose(-1, -2))
    _mirror_(X[:, :h, :h])
    _mirror_(X[:, h:, h:])


def cholesky_inverse(L):
    """(L Lᵀ)⁻¹ from its lower factor, batched over leading dimensions,
    exactly symmetric, in L's precision: a blocked triangular inverse and
    the product WᵀW of W = L⁻¹ by halves (LAPACK's potri, 2n³/3
    operations a matrix, and the zero triangles of the leaves' products),
    the blocks' products batched GEMMs, in one new buffer. Not
    differentiable."""
    n = L.shape[-1]
    W = L.detach().reshape(-1, n, n).clone()
    _tri_inverse_(W)
    _lauum_(W)
    _mirror_(W)
    return W.reshape(L.shape)


class _GaussianLogDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, delta, agree):
        L, _ = _jittered_cholesky(K, MAX_TRIES, agree)
        z = solve_triangular(L, delta[..., None], lower=True)
        alpha = solve_triangular(L, z, lower=True, trans=True)[..., 0]
        ctx.save_for_backward(L, alpha)
        z = z[..., 0]
        return -0.5 * ((z * z).sum(-1) + logdet_from_chol(L)
                       + K.shape[-1] * math.log(2 * math.pi))

    @staticmethod
    def backward(ctx, g):
        L, alpha = ctx.saved_tensors
        K_bar = delta_bar = None
        # ∂ℓ/∂K = ½ (ααᵀ − K⁻¹), ∂ℓ/∂δ = −α, with α = K⁻¹δ
        with span("cholesky.pullback"):
            count("cholesky.pullback")
            count("cholesky.pullback.closed_form")
            if ctx.needs_input_grad[0]:
                n = L.shape[-1]
                K_bar = cholesky_inverse(L)
                a = alpha.reshape(-1, n, 1)
                K_bar.view(-1, n, n).baddbmm_(a, a.transpose(-1, -2),
                                              beta=-1.0)
                K_bar.mul_(0.5 * g[..., None, None])
            if ctx.needs_input_grad[1]:
                delta_bar = -g[..., None] * alpha
        return K_bar, delta_bar, None


def gaussian_log_density(K, delta, agree=None):
    """log N(δ; 0, K) over the batch, (…,) for K (…, n, n) and δ (…, n): the
    factor from :func:`safe_cholesky`'s ladder (its jitter, counts and host
    reads; NaN where every rung failed), and the closed-form gradient
    K̄ = ½ g (ααᵀ − K⁻¹), δ̄ = −g α (α = K⁻¹δ, K⁻¹ by
    :func:`cholesky_inverse`) in place of the Cholesky pullback. The
    gradient is to K as given; a rung's jitter is in the factor, as with
    :func:`safe_cholesky`."""
    return _GaussianLogDensity.apply(K, delta, agree)


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
