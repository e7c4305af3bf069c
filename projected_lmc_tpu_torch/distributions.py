"""Multivariate normals with structured covariances (port of
``projected_lmc_tpu/distributions.py``).

  * DenseCov          (n·t, n·t) dense
  * BatchIndepCov     (t, n, n) batch-independent tasks (``from_batch_mvn``)
  * KronCov           K ⊗ B (the ICM prior)
  * SumKronRank1Cov   Σ_b K_b ⊗ h_b h_bᵀ (the LMC prior, the projected LMC's
                      posterior)

Task layout is gpytorch's interleaving: vec index (point i, task t) = i·T + t.
Sampling takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

from .ops import kron as kron_ops
from .ops import woodbury as wb_ops
from .ops.cholesky import logdet_from_chol, safe_cholesky, solve_triangular


class MultivariateNormal:
    """(Batched) dense-covariance MVN: mean (..., n), covariance
    (..., n, n)."""

    def __init__(self, mean, covariance):
        self.mean = mean
        self.covariance_matrix = covariance

    @property
    def variance(self):
        return torch.diagonal(self.covariance_matrix, dim1=-2, dim2=-1)

    @property
    def stddev(self):
        return torch.sqrt(self.variance)

    @property
    def batch_shape(self):
        return self.mean.shape[:-1]

    @property
    def event_shape(self):
        return self.mean.shape[-1:]

    def log_prob(self, value):
        """Batched Gaussian log-density; value (..., n)."""
        n = self.mean.shape[-1]
        L = safe_cholesky(self.covariance_matrix)
        z = solve_triangular(L, (value - self.mean)[..., None],
                             lower=True)[..., 0]
        return -0.5 * ((z * z).sum(-1) + logdet_from_chol(L)
                       + n * math.log(2 * math.pi))

    def confidence_region(self, k: float = 2.0):
        s = self.stddev
        return self.mean - k * s, self.mean + k * s

    def add_noise_diag(self, noise):
        """A new MVN with ``noise`` (broadcastable to (..., n), or a scalar)
        added to the covariance's diagonal."""
        cov = self.covariance_matrix
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        noise = torch.as_tensor(noise, dtype=cov.dtype, device=cov.device)
        return MultivariateNormal(self.mean, cov + noise[..., None] * eye)

    def sample(self, generator, sample_shape=()):
        """Draws of shape sample_shape + mean.shape, from the standard
        normals of ``generator``."""
        L = safe_cholesky(self.covariance_matrix)
        eps = torch.randn(tuple(sample_shape) + tuple(self.mean.shape),
                          generator=generator, dtype=self.mean.dtype,
                          device=self.mean.device)
        return self.mean + (L @ eps[..., None])[..., 0]


class DenseCov:
    """Dense (n·t, n·t) interleaved covariance."""

    def __init__(self, matrix, n, t):
        self.matrix = matrix
        self.n, self.t = int(n), int(t)

    def diag(self):
        return torch.diagonal(self.matrix).reshape(self.n, self.t)

    def dense(self):
        return self.matrix

    def log_prob_centered(self, delta):
        L = safe_cholesky(self.matrix)
        z = solve_triangular(L, delta.reshape(-1, 1), lower=True)
        return -0.5 * ((z * z).sum() + logdet_from_chol(L)
                       + self.n * self.t * math.log(2 * math.pi))


class BatchIndepCov:
    """Block covariance of t independent tasks: covs (t, n, n)."""

    def __init__(self, covs):
        self.covs = covs
        self.t, self.n = covs.shape[0], covs.shape[-1]

    def diag(self):
        return torch.diagonal(self.covs, dim1=-2, dim2=-1).T      # (n, t)

    def dense(self):
        n, t = self.n, self.t
        out = self.covs.new_zeros((n * t, n * t))
        ii = torch.arange(n, device=self.covs.device) * t
        for task in range(t):
            idx = ii + task
            out[idx[:, None], idx[None, :]] = self.covs[task]
        return out

    def log_prob_centered(self, delta):
        """delta (n, t): t independent Gaussians."""
        L = safe_cholesky(self.covs)
        z = solve_triangular(L, delta.T[..., None], lower=True)[..., 0]
        return -0.5 * ((z * z).sum() + logdet_from_chol(L).sum()
                       + self.n * self.t * math.log(2 * math.pi))


class KronCov:
    """K ⊗ B (+ I ⊗ Σt when given): the exact ICM covariance. K (n, n),
    B (t, t). ``dense()`` forms the (n·t)² matrix: for small n only."""

    def __init__(self, K, B, Sigma_t=None):
        self.K, self.B, self.Sigma_t = K, B, Sigma_t
        self.n, self.t = K.shape[-1], B.shape[-1]

    def diag(self):
        d = torch.diagonal(self.K)[:, None] * torch.diagonal(self.B)[None, :]
        if self.Sigma_t is not None:
            d = d + torch.diagonal(self.Sigma_t)[None, :]
        return d

    def dense(self):
        out = torch.kron(self.K, self.B)
        if self.Sigma_t is not None:
            eye = torch.eye(self.n, dtype=out.dtype, device=out.device)
            out = out + torch.kron(eye, self.Sigma_t)
        return out

    def with_noise(self, Sigma_t):
        return KronCov(self.K, self.B, Sigma_t)

    def log_prob_centered(self, delta):
        if self.Sigma_t is None:
            raise ValueError("Kronecker log_prob requires task noise "
                             "(singular otherwise)")
        return kron_ops.icm_log_prob(self.K, self.B, self.Sigma_t, delta)


class SumKronRank1Cov:
    """Σ_b K_b ⊗ h_b h_bᵀ (+ I ⊗ Σt when given): the LMC prior and the
    projected LMC's posterior. Ks (q, n, n), H (t, q). ``dense()`` forms the
    (n·t)² matrix: for small n only."""

    def __init__(self, Ks, H, Sigma_t=None):
        self.Ks, self.H, self.Sigma_t = Ks, H, Sigma_t
        self.n, self.t = Ks.shape[-1], H.shape[0]

    def diag(self):
        kd = torch.diagonal(self.Ks, dim1=-2, dim2=-1)              # (q, n)
        d = kd.T @ (self.H * self.H).T                              # (n, t)
        if self.Sigma_t is not None:
            d = d + torch.diagonal(self.Sigma_t)[None, :]
        return d

    def dense(self):
        out = sum(torch.kron(self.Ks[b], torch.outer(self.H[:, b],
                                                      self.H[:, b]))
                  for b in range(self.Ks.shape[0]))
        if self.Sigma_t is not None:
            eye = torch.eye(self.n, dtype=out.dtype, device=out.device)
            out = out + torch.kron(eye, self.Sigma_t)
        return out

    def with_noise(self, Sigma_t):
        return SumKronRank1Cov(self.Ks, self.H, Sigma_t)

    def log_prob_centered(self, delta):
        if self.Sigma_t is None:
            raise ValueError("LMC log_prob requires task noise (singular "
                             "otherwise)")
        return wb_ops.lmc_log_prob(self.Ks, self.H, self.Sigma_t, delta)


class MultitaskMultivariateNormal:
    """Multitask MVN: mean (n, t) and one of the covariances above."""

    def __init__(self, mean, covar):
        self.mean = mean
        self.covar = covar

    @classmethod
    def from_batch_mvn(cls, mvn: MultivariateNormal):
        """A batch (t, n) of independent MVNs as one multitask MVN."""
        return cls(mvn.mean.T, BatchIndepCov(mvn.covariance_matrix))

    @property
    def variance(self):
        return self.covar.diag()

    @property
    def stddev(self):
        return torch.sqrt(self.variance)

    def log_prob(self, Y):
        return self.covar.log_prob_centered(
            torch.as_tensor(Y, dtype=self.mean.dtype, device=self.mean.device)
            - self.mean)

    def confidence_region(self, k: float = 2.0):
        s = self.stddev
        return self.mean - k * s, self.mean + k * s

    def to_dense(self) -> MultivariateNormal:
        return MultivariateNormal(self.mean.reshape(-1), self.covar.dense())
