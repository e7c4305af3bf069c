"""Operations and bytes of the mathematics the configurations need, counted
from their shapes (never from the kernels a program happens to launch).

Per-pair costs of a stationary kernel follow the repository's published
bound arithmetic for its kernels: a squared distance over d features and
the profile cost 3d + 10 operations a pair; the derivative with respect to
the lengthscales on a rank-r cotangent factor costs 2r + 3d + 7 + 2(1 + 2d).
A symmetric matrix is counted on its lower triangle, n(n + 1)/2 entries.
"""

from __future__ import annotations

from .peaks import op

F32, BF16 = 4, 2


def tri(n: int) -> float:
    return n * (n + 1) / 2.0


def kernel_eval(name, pairs, d, out_bytes_per_entry, in_points):
    """``pairs`` evaluations of a stationary kernel over d features, writing
    each entry once and reading the ``in_points`` input points once."""
    return op(name, in_points * d * F32 + pairs * out_bytes_per_entry,
              fp32=pairs * (3 * d + 10))


def kernel_lengthscale_grad(name, pairs, d, r, in_points):
    """The lengthscale gradient of Σ dK ⊙ K with dK of rank r given by its
    (n, r) factors, recomputing the kernel: it reads the points and the
    factors, writes (n, d) partial sums."""
    return op(name, in_points * (d + 2 * r) * F32 + in_points * d * F32,
              fp32=pairs * (2 * r + 3 * d + 7 + 2 * (1 + 2 * d)))


def stack_product(name, q, n, r, stack_bytes_per_entry, precision):
    """Σ_b K_b V_b for a symmetric (q, n, n) stack stored on its lower
    triangle and r right-hand sides a latent."""
    return op(name, q * tri(n) * stack_bytes_per_entry + 2 * q * n * r * F32,
              **{precision: 2.0 * q * n * n * r})


def gemm(name, m, n, k):
    """An fp32 (m, k) × (k, n) product."""
    return op(name, (m * k + k * n + m * n) * F32, fp32=2.0 * m * n * k)


def cholesky(name, n, batch=1):
    """potrf: n³/3 operations, the lower triangle read and written."""
    return op(name, batch * 2 * tri(n) * F32, fp32=batch * n ** 3 / 3.0)


def cholesky_inverse(name, n, batch=1):
    """(L Lᵀ)⁻¹ from its factor (potri): 2n³/3 operations."""
    return op(name, batch * 2 * tri(n) * F32, fp32=batch * 2.0 * n ** 3 / 3.0)


def triangular_solve(name, n, rhs, batch=1):
    """L⁻¹ B with B (n, rhs): n²·rhs operations; reads L and B, writes X."""
    return op(name, batch * (tri(n) + 2 * n * rhs) * F32,
              fp32=batch * float(n) * n * rhs)
