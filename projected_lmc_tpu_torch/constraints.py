"""Parameter constraints as bijective transforms (port of
``projected_lmc_tpu/constraints.py``, the scalar constraints).

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
