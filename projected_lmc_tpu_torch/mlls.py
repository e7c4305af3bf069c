"""Marginal log-likelihood objectives (port of ``projected_lmc_tpu/mlls.py``;
so far ``exact_mll``)."""

from __future__ import annotations


def exact_mll(model, x=None, y=None):
    """Exact MLL scaled by 1/num_data (gpytorch ExactMarginalLogLikelihood)."""
    return model.mll(x=x, y=y)
