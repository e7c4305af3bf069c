"""The work of the projected LMC at the configuration's shapes, from its
mathematics. A training step: the q latent kernels (symmetric), their
factorization, the solve with the projected data, and the backward, which
needs each latent system's inverse (tr(K⁻¹ ∂K)) and the lengthscale
reduction over its dense cotangent. A served request of n* points: the
(q, n, n*) cross-covariance, the mean, the triangular solve with n*
right-hand sides and the variance. The T × T projection algebra is left
out."""

from __future__ import annotations

from harness import work
from harness.peaks import least_total, op


def step_operations(cfg):
    n, d, q = cfg["n"], cfg["d"], cfg["q"]
    pairs = q * work.tri(n)
    F32 = work.F32
    return [work.kernel_eval("latent kernels", pairs, d, F32, n),
            work.cholesky("potrf", n, q),
            work.triangular_solve("solve with the projected data", n, 1, q),
            work.cholesky_inverse("latent inverses", n, q),
            op("lengthscale reduction", pairs * F32 + n * d * F32,
               fp32=pairs * (3 * d + 7 + 2 * (1 + 2 * d)))]


def request_operations(cfg, n_star):
    n, d, q, t = cfg["n"], cfg["d"], cfg["q"], cfg["T"]
    F32 = work.F32
    return [op("cross-covariance", (n + n_star) * d * F32,
               fp32=q * n * n_star * (3 * d + 10)),
            op("mean", q * n * F32, fp32=2.0 * q * n * n_star),
            work.triangular_solve("L^-1 K*", n, n_star, q),
            op("variance", 2 * n_star * t * F32,
               fp32=2.0 * q * n * n_star + 4.0 * n_star * q * t)]


def least_step_seconds(cfg) -> float:
    return least_total(step_operations(cfg))


def least_request_seconds(cfg, n_star) -> float:
    return least_total(request_operations(cfg, n_star))
