"""Marginal log-likelihood objectives (port of ``projected_lmc_tpu/mlls.py``:
``exact_mll``, the projected model's ``projected_lmc_mll`` and the LOO
pseudo-likelihood ``loo_pseudo_likelihood``)."""

from __future__ import annotations

import math

import torch


def exact_mll(model, x=None, y=None):
    """Exact MLL scaled by 1/num_data (gpytorch ExactMarginalLogLikelihood)."""
    return model.mll(x=x, y=y)


def projected_lmc_mll(model, with_terms: bool = False):
    """The projected LMC's MLL, term for term as the JAX package's:

    latent term:  (1/n)·Σ_b log N(T(Y)_b ; 0, K_b + σ_b² I)
    projection terms (returned with ``with_terms``):
      [0] −½·2·Σ log diag(B̃^{1/2})
      [1] −½·‖B̃^{-1/2} Q⊥ᵀ Y‖² / n   (scalar B̃ with BDN: the cached
          ‖Y‖² − ‖YQ‖² identity)
      [2] −½·Σ log R_ii²
    plus the constant −½ (p−q) log 2π.
    """
    Y = model.train_y_tasks
    n = Y.shape[0]
    p, q = model.n_tasks, model.n_latents
    Q, R, Q_orth = model.lmc_coefficients.QR()

    proj_target = model._project(Y, Q, R, Q_orth)               # (q, n)
    latent_ll = model.log_marginal(y=proj_target, orientation="tn").sum()
    latent_res = (latent_ll + model.covar_module.prior_log_prob()) / n

    zero = Y.new_zeros(())
    terms = [zero, zero, zero]
    if model.BDN and model.scalar_B:
        if model.log_B_tilde_raw.numel() > 0:
            log_B = model.log_B_tilde
            log_B_root_diag = log_B / 2
            YQ = Y @ Q
            terms[1] = -0.5 * torch.exp(-log_B[0]) * (
                model.Y_squared_norm - (YQ ** 2).sum()) / n
        else:
            log_B_root_diag = Y.new_zeros((1,))
    else:
        if model.diagonal_B:
            log_B = model.log_B_tilde
            log_B_root_diag = log_B / 2
            rot = Y @ Q_orth
            disc = ((rot * torch.exp(-log_B)[None, :]) * rot).sum()
        else:
            Binv_chol = model.B_tilde_inv_chol
            log_B_root_diag = -torch.log(torch.diagonal(Binv_chol))
            root = (Y @ Q_orth) @ Binv_chol
            disc = (root * root).sum()
        terms[1] = -0.5 * disc / n

    terms[0] = -0.5 * 2.0 * log_B_root_diag.sum()
    if model.lmc_coefficients.bulk:
        terms[2] = -0.5 * torch.log(torch.diagonal(R)[:q] ** 2).sum()
    else:
        terms[2] = -0.5 * 2.0 * model.lmc_coefficients.r_raw_diag_sum()

    projection_term = terms[0] + terms[1] + terms[2] \
        - 0.5 * (p - q) * math.log(2 * math.pi)
    res = latent_res + projection_term
    if with_terms:
        return res, terms
    return res


def loo_pseudo_likelihood(model, targets=None):
    """LOO pseudo-likelihood (projected_lmc.py:86-105):
    (1/n)·Σᵢ [−½ log σᵢ² − ½ (yᵢ−μᵢ)²/σᵢ²] − ½ log 2π from the model's
    ``compute_loo``; differentiable for a single-output ``ExactGPModel``."""
    sigma2, yminusmu = model.compute_loo() if targets is None \
        else model.compute_loo(targets=targets)
    res = (-0.5 * torch.log(sigma2) - 0.5 * yminusmu ** 2 / sigma2).sum(0)
    return res.sum() / sigma2.shape[0] - 0.5 * math.log(2 * math.pi)
