"""Blocked Cholesky with bf16 trailing updates (port of
``projected_lmc_tpu/ops/blocked_cholesky.py``).

A right-looking blocked factorization that keeps everything
accuracy-critical in the input's precision — the diagonal blocks' factors,
the panel solves and every accumulation — and runs only the O(n³/3)
trailing updates with bf16 inputs and fp32 accumulation:

    for each block column k:
        L_kk   = chol(A_kk)                   (safe_cholesky's ladder)
        L_21   = A_21 · L_kk⁻ᵀ                (a product with the small
                                               triangular inverse)
        A_22  -= L_21 · L_21ᵀ                 (bf16 in, fp32 accumulated)

The bf16 rounding of L_21 perturbs each update by ~2⁻⁸ relative: the factor
of A + E with ‖E‖/‖A‖ ≈ 4e-3 of the off-diagonal energy, the noise class of
the bf16 stack product. For training-tolerance factorizations only. Two
guards keep GP-shaped spectra (low rank plus a small ridge) from going
indefinite: each update's diagonal is recomputed exactly (row sums of L_21²),
and the diagonal blocks factor through ``safe_cholesky``'s jitter ladder.

Plain torch, as the JAX package leaves it to XLA; batched over leading
dimensions; differentiable by autograd (the ICM MLL that calls it has its
own analytic backward).
"""

from __future__ import annotations

import torch

from .cholesky import safe_cholesky
from .iterative import _bf16_stack_bmm


def _bf16_syrk(L21):
    """L21 L21ᵀ from bf16 copies of L21, accumulated in fp32
    (:func:`iterative._bf16_stack_bmm`), in L21's dtype."""
    Lb = L21.to(torch.bfloat16)
    flat = Lb.reshape((-1,) + tuple(Lb.shape[-2:]))
    out = _bf16_stack_bmm(flat, flat.transpose(1, 2))
    return out.reshape(Lb.shape[:-2] + out.shape[-2:]).to(L21.dtype)


def _blocked(A, block, diag_factor, update):
    n = A.shape[-1]
    A = A.clone()
    L = torch.zeros_like(A)
    for s in range(0, n, block):
        e = min(s + block, n)
        Lkk = diag_factor(A[..., s:e, s:e])
        L[..., s:e, s:e] = Lkk
        if e >= n:
            break
        # the small triangular inverse once, then the panel is one product
        eye = torch.eye(e - s, dtype=A.dtype, device=A.device)
        Lkk_inv = torch.linalg.solve_triangular(Lkk, eye.expand_as(Lkk),
                                                upper=False)
        L21 = A[..., e:, s:e] @ Lkk_inv.transpose(-1, -2)
        L[..., e:, s:e] = L21
        A[..., e:, e:] -= update(L21)
    return L


def _bf16_update(L21):
    """L21 L21ᵀ with bf16 products off the diagonal and the diagonal's
    exact row sums of L21²."""
    upd = _bf16_syrk(L21)
    upd.diagonal(dim1=-2, dim2=-1).copy_((L21 * L21).sum(-1))
    return upd


def cholesky_bf16_blocked(A, block: int = 1024):
    """Lower Cholesky factor of SPD ``A`` (..., n, n) with bf16 trailing
    updates (exact update diagonals, jitter-laddered diagonal blocks);
    ``torch.linalg.cholesky`` when n ≤ ``block``."""
    if A.shape[-1] <= block:
        return torch.linalg.cholesky(A)
    return _blocked(A, block, safe_cholesky, _bf16_update)


def cholesky_blocked_f32(A, block: int = 1024):
    """The same blocking with full-precision trailing updates and plain
    diagonal-block factors: isolates the blocking from the precision."""
    if A.shape[-1] <= block:
        return torch.linalg.cholesky(A)
    return _blocked(A, block, torch.linalg.cholesky,
                    lambda L21: L21 @ L21.transpose(-1, -2))
