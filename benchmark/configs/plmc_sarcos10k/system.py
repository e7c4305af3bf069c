"""The projected LMC of ``config.json`` as the port runs it: the model, its
starting leaves drawn from the seed, the training objective
(``mlls.projected_lmc_mll``) and the served prediction from the cached
factorization."""

from __future__ import annotations

import math

import torch

from harness import data

LOOPS = ("train", "serve")


def leaves_from_seed(cfg, seed, device):
    """The trainable raw leaves, by the program's names."""
    g = data.generator(seed, data.LEAVES, device)
    q, t = cfg["q"], cfg["T"]
    k = t - q
    floor = math.exp(cfg["noise_thresh"])
    sigma = 0.1 * torch.exp(data.uniform(g, (q, 1), -0.5, 0.5, device))
    braw = 0.1 * torch.tril(torch.randn((k, k), generator=g, device=device),
                            -1)
    braw = braw + torch.diag(math.log(1.0 / 0.1)
                             + data.uniform(g, (k,), -0.3, 0.3, device))
    return {
        "covar_module.raw_lengthscale": data.lengthscale_leaf(cfg, g, device),
        "lmc_coefficients.H": torch.randn((t, t), generator=g, device=device),
        "likelihood.raw_noise": data.inv_softplus(sigma - floor),
        "B_tilde_inv_chol_raw": braw,
        "M": 0.1 * torch.randn((q, k), generator=g, device=device),
    }


def build(pl, cfg, x, y, leaves, device):
    model = pl.ProjectedGPModel(
        x.cpu().numpy(), y.cpu().numpy(), cfg["T"], cfg["q"],
        mean_type=cfg["mean_type"], kernel_type=cfg["kernel_type"],
        noise_thresh=cfg["noise_thresh"], device=device, **cfg["options"])
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in leaves.items():
            params[k].copy_(v)
    return model


def objective(pl, cfg, record, variant=None):
    """``loss_fn(model)`` for ``training.fit``: ``projected_lmc_mll``.
    ``variant`` "half" trains on the first half of the rows alone (a
    planted fault)."""
    def loss_fn(model):
        mll = _half_rows_mll(pl, model) if variant == "half" \
            else pl.projected_lmc_mll(model)
        record.loss(mll)
        return mll
    return loss_fn


def _half_rows_mll(pl, model):
    n = model.train_x.shape[0] // 2
    full = (model.train_x, model.train_y, model.train_y_tasks)
    model.train_x, model.train_y = full[0][:n], full[1][:, :n]
    model.train_y_tasks = full[2][:n]
    try:
        return pl.projected_lmc_mll(model)
    finally:
        model.train_x, model.train_y, model.train_y_tasks = full


def serving(model):
    """(prepare, request): the cache built once, then one request's mean and
    variance with the observation noise, each (n*, T), on the device; no
    autograd graph, as a served model is asked."""
    def prepare():
        with torch.no_grad():
            return model.prediction_cache()

    def request(cache, x_star):
        with torch.no_grad():
            return model.predict(x_star, observed=True, cache=cache)
    return prepare, request
