"""Gaussian likelihoods (port of ``projected_lmc_tpu/likelihoods.py``):
the batched ``GaussianLikelihood``, the ``MultitaskGaussianLikelihood``
whose Σt = F Fᵀ (rank > 0) or diag(task_noises) (rank 0), plus σ²_global I,
as gpytorch's MultitaskGaussianLikelihood(num_tasks, rank), and the
parameter-free ``FixedTaskNoise`` that ``ProjectedGPModel.full_likelihood``
returns."""

from __future__ import annotations

import numpy as np
import torch

from . import constraints
from .module import Module
from .utils.device import resolve_device


class GaussianLikelihood(Module):
    """Batched homoskedastic Gaussian likelihood: ``noise`` has shape
    (batch, 1), gpytorch's convention, through GreaterThan(1e-4)."""

    def __init__(self, batch_shape=1, noise_constraint=None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.batch = int(batch_shape)
        self.constraint = noise_constraint or constraints.GreaterThan(1e-4)
        # gpytorch's default raw_noise = 0
        self.register_raw("raw_noise", torch.zeros((self.batch, 1)), dtype,
                          resolve_device(device))

    @property
    def noise(self):
        return self.constraint.forward(self.raw_noise)

    def set_noise(self, value):
        """Set the noise to ``value`` (broadcast to (batch, 1)) in place;
        returns the likelihood."""
        with torch.no_grad():
            self.raw_noise.copy_(self.constraint.inverse(torch.as_tensor(
                value, dtype=self.raw_noise.dtype,
                device=self.raw_noise.device).expand_as(self.raw_noise)))
        return self

    def add_to_covar(self, K):
        """K (batch, n, n) → K + noise_b · I for each batch element."""
        n = K.shape[-1]
        return K + self.noise[..., None] * torch.eye(n, dtype=K.dtype,
                                                     device=K.device)


class MultitaskGaussianLikelihood(Module):
    """Multitask noise Σt = F Fᵀ (rank > 0) or diag(task_noises) (rank 0),
    plus σ²_global I, (T, T)."""

    def __init__(self, num_tasks: int, rank: int = 0,
                 has_global_noise: bool = True, has_task_noise: bool = True,
                 noise_constraint=None, seed: int = 0, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.num_tasks = int(num_tasks)
        self.rank = int(rank)
        self.has_global_noise = bool(has_global_noise)
        self.has_task_noise = bool(has_task_noise)
        self.constraint = noise_constraint or constraints.GreaterThan(1e-4)
        rng = np.random.default_rng(seed)
        if self.has_global_noise:
            self.register_raw("raw_noise", torch.zeros((1,)), dtype, dev)
        if self.has_task_noise:
            if self.rank > 0:
                self.register_raw(
                    "task_noise_covar_factor",
                    rng.standard_normal((self.num_tasks, self.rank)), dtype, dev)
            else:
                self.register_raw("raw_task_noises",
                                  torch.zeros((self.num_tasks,)), dtype, dev)

    def _ref(self):
        """A parameter, for the likelihood's dtype and device."""
        return next(self.parameters())

    @property
    def noise(self):
        """The global noise σ², (1,); zeros without a global noise."""
        if not self.has_global_noise:
            ref = self._ref()
            return torch.zeros((1,), dtype=ref.dtype, device=ref.device)
        return self.constraint.forward(self.raw_noise)

    def set_noise(self, value):
        """Set the global noise σ² to ``value`` in place; returns the
        likelihood."""
        with torch.no_grad():
            self.raw_noise.copy_(self.constraint.inverse(torch.as_tensor(
                value, dtype=self.raw_noise.dtype,
                device=self.raw_noise.device).expand(1)))
        return self

    @property
    def task_noises(self):
        if not (self.has_task_noise and self.rank == 0):
            raise AttributeError("task_noises only defined for rank=0 "
                                 "likelihoods")
        return self.constraint.forward(self.raw_task_noises)

    def task_covariance(self):
        """Dense (T, T) noise covariance Σt."""
        p = self.num_tasks
        ref = self._ref()
        sigma = torch.zeros((p, p), dtype=ref.dtype, device=ref.device)
        if self.has_task_noise:
            if self.rank > 0:
                F = self.task_noise_covar_factor
                sigma = sigma + F @ F.T
            else:
                sigma = sigma + torch.diag(self.task_noises)
        if self.has_global_noise:
            sigma = sigma + self.noise[0] * torch.eye(p, dtype=ref.dtype,
                                                      device=ref.device)
        return sigma


class FixedTaskNoise(Module):
    """A fully specified p×p task noise covariance with no free parameters,
    given by its Cholesky factor ``chol`` (a buffer)."""

    def __init__(self, chol):
        super().__init__()
        self.register_buffer("chol", torch.as_tensor(chol))
        self.num_tasks = int(self.chol.shape[-1])

    def task_covariance(self):
        return self.chol @ self.chol.T

    @property
    def task_noise_covar_factor(self):
        return self.chol
