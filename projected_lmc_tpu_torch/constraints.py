"""Parameter constraints as bijective transforms, and the matrix
parametrizations of the projected model's mixing matrix and noise factor
(port of ``projected_lmc_tpu/constraints.py``).

Models store raw (unconstrained) parameters and map them through these
transforms in their property accessors, as gpytorch does.
"""

from __future__ import annotations

import torch


def softplus(x):
    """log(1 + e^x), exact for every x (jax.nn.softplus); its gradient is
    sigmoid(x) everywhere, including x = 0."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    """Stable inverse of softplus: log(exp(y) - 1)."""
    y = torch.as_tensor(y)
    return y + torch.log(-torch.expm1(-y))


class _ValueEq:
    """Value equality by __dict__ (two models built alike compare equal)."""

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))


class Positive(_ValueEq):
    """y = softplus(x); gpytorch's default Positive constraint."""

    def forward(self, x):
        return softplus(x)

    def inverse(self, y):
        return inv_softplus(y)


class GreaterThan(_ValueEq):
    """y = softplus(x) + lower_bound (gpytorch GreaterThan)."""

    def __init__(self, lower_bound: float):
        self.lower_bound = float(lower_bound)

    def forward(self, x):
        return softplus(x) + self.lower_bound

    def inverse(self, y):
        return inv_softplus(torch.clamp(torch.as_tensor(y) - self.lower_bound,
                                        min=1e-20))


class Interval(_ValueEq):
    """y = lower + (upper - lower) * sigmoid(x) (gpytorch Interval)."""

    def __init__(self, lower: float, upper: float):
        self.lower, self.upper = float(lower), float(upper)

    def forward(self, x):
        return self.lower + (self.upper - self.lower) * torch.sigmoid(x)

    def inverse(self, y):
        t = (torch.as_tensor(y) - self.lower) / (self.upper - self.lower)
        t = torch.clamp(t, 1e-12, 1 - 1e-12)
        return torch.log(t) - torch.log1p(-t)


# Matrix parametrizations (the torch.nn.utils.parametrize modules of the
# reference): each maps a raw matrix to a constrained one; its inverse
# initializes the raw matrix from a target.

def _with_diagonal(mat, d):
    """``mat`` with its (batched) diagonal replaced by ``d``."""
    return mat - torch.diag_embed(torch.diagonal(mat, dim1=-2, dim2=-1)) \
        + torch.diag_embed(d)


def scalar_param(raw, bounds=(-1e16, 1e16)):
    """Scalar matrix: every entry = clamp(mean(raw), bounds)."""
    return torch.ones_like(raw) * torch.clamp(raw.mean(), bounds[0], bounds[1])


def positive_diagonal_param(raw):
    """diag(exp(diag(raw)))."""
    return torch.diag_embed(torch.exp(torch.diagonal(raw, dim1=-2, dim2=-1)))


def positive_diagonal_param_inverse(mat):
    return torch.diag_embed(torch.log(torch.diagonal(mat, dim1=-2, dim2=-1)))


def upper_triangular_param(raw, bounds=None):
    """triu(raw) with an exp diagonal, clamped to ``bounds`` before exp."""
    d = torch.diagonal(raw, dim1=-2, dim2=-1)
    if bounds is not None:
        d = torch.clamp(d, bounds[0], bounds[1])
    return _with_diagonal(torch.triu(raw), torch.exp(d))


def upper_triangular_param_inverse(mat):
    return _with_diagonal(mat, torch.log(torch.diagonal(mat, dim1=-2,
                                                        dim2=-1)))


def lower_triangular_param(raw, bounds=(-1e16, 1e16)):
    """tril(raw) with exp(clamp(diag, bounds)) on the diagonal: a Cholesky
    factor."""
    d = torch.clamp(torch.diagonal(raw, dim1=-2, dim2=-1), bounds[0],
                    bounds[1])
    return _with_diagonal(torch.tril(raw), torch.exp(d))


lower_triangular_param_inverse = upper_triangular_param_inverse
