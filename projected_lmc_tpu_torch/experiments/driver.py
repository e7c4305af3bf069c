"""Parametric-study driver (port of ``projected_lmc_tpu/experiments/driver.py``,
the rebuild of experiments.py:119-380).

Builds the five reference model variants (ICM / var / PLMC / oilmm /
PLMC_fast, experiments.py:183-216 + realdata_experiments.py:99-118), trains
each with :func:`training.fit` (AdamW + LambdaLR + plateau stop), predicts,
computes the 15-metric dict, and accumulates CSV results with incremental
export at run landmarks 1, 10, 20, … (experiments.py:71,367-380).

The CSVs are written with the ``csv`` module, not pandas, so that the study
runs where pandas is not installed; ``pd.read_csv`` reads them back equal
to the JAX driver's (same index column, column order and values).
"""

from __future__ import annotations

import csv
import math
import os
import sys
import time

import numpy as np
import torch

from ..likelihoods import MultitaskGaussianLikelihood
from ..metrics import compute_metrics
from ..mlls import projected_lmc_mll
from ..models import (MultitaskGPModel, ProjectedGPModel,
                      VariationalMultitaskGPModel)
from ..training import fit, lambda_lr_schedule
from ..utils.device import resolve_device
from .synthetic import generate_synthetic

DEFAULT_PARAMS = {  # experiments.py:16-27
    "n": 500, "p": 100, "q": 25, "q_guess": 25, "q_noise": 25,
    "q_noise_guess": 25, "mu_noise": 1e-1, "mu_str": 0.9,
    "max_scale": 0.5, "void": 0.0,
}

DEFAULT_SWEEPS = {  # experiments.py:29-40
    "n": list(range(200, 1001, 100)),
    "p": list(range(50, 201, 25)),
    "q": list(range(10, 91, 10)),
    "q_guess": list(range(10, 91, 10)),
    "q_noise": list(range(10, 91, 10)),
    "q_noise_guess": list(range(10, 91, 10)),
    "mu_noise": list(np.logspace(-3, np.log10(0.5), 10)),
    "mu_str": list(np.linspace(1e-3, 1.0, 10)),
    "max_scales": list(np.linspace(0.1, 2.0, 10)),
    "void": [0.0],
}

MODEL_CONFIGS = {  # experiments.py:196-216, realdata_experiments.py:99-118
    "PLMC": dict(BDN=False, diagonal_B=False, scalar_B=False, diagonal_R=False),
    "oilmm": dict(BDN=True, diagonal_B=True, scalar_B=True, diagonal_R=True),
    "PLMC_fast": dict(BDN=True, diagonal_B=True, scalar_B=True, diagonal_R=False),
}


def _maybe_init_sm(model, X, Y, seed=0):
    """SpectralMixture kernels REQUIRE data-driven initialization before
    training (realdata_experiments.py:130-140 calls initialize_from_data;
    without it the mixture frequencies are arbitrary and the model collapses
    to mean prediction on periodic data like the tidal series). The
    kernel's inits write its leaves in place."""
    cm = getattr(model, "covar_module", None)
    if cm is not None and hasattr(cm, "initialize_from_data"):
        X, Y = np.asarray(X), np.asarray(Y)
        if hasattr(cm, "initialize_from_data_empspect"):
            # 1-D near-regular series: spectral-peak init (falls back to the
            # Unif-below-Nyquist heuristic internally when inapplicable)
            cm.initialize_from_data_empspect(X, Y, seed=seed)
        else:
            cm.initialize_from_data(X, Y, seed=seed)
    return model


def build_models(X, Y, q_model, q_noise_guess, models_to_run,
                 kernel_type="matern", mean_type="zero", decomp=None,
                 train_ind_ratio=1.5, n_ind_points=None, ker_kwargs=None,
                 oilmm_bulk=True, seed=0, var_ind_range=None, device="cuda"):
    """Instantiate the reference's five model variants on ``device``.

    As in the JAX driver, the variational model is built with ``seed=0``
    whatever ``seed`` is, and the projected models with a zero mean
    whatever ``mean_type`` is. The likelihoods take the data's dtype (the
    JAX driver's are float32 whatever the data, which JAX promotes and
    torch does not)."""
    dev = resolve_device(device)
    p = Y.shape[1]
    lik_dtype = torch.float64 if np.asarray(X).dtype == np.float64 \
        else torch.float32
    models = {}
    if "ICM" in models_to_run:
        lik = MultitaskGaussianLikelihood(num_tasks=p, rank=q_noise_guess,
                                          seed=seed, dtype=lik_dtype,
                                          device=dev)
        models["ICM"] = MultitaskGPModel(
            X, Y, lik, n_tasks=p, n_latents=q_model, model_type="ICM",
            init_lmc_coeffs=True, mean_type=mean_type, kernel_type=kernel_type,
            decomp=decomp, n_inducing_points=n_ind_points, ker_kwargs=ker_kwargs,
            seed=seed, device=dev)
    if "var" in models_to_run:
        lik = MultitaskGaussianLikelihood(num_tasks=p, rank=q_noise_guess,
                                          seed=seed, dtype=lik_dtype,
                                          device=dev)
        TI_rat = train_ind_ratio if n_ind_points is None else X.shape[0] / n_ind_points
        models["var"] = VariationalMultitaskGPModel(
            X, n_latents=q_model, n_tasks=p, train_y=Y, init_lmc_coeffs=True,
            mean_type=mean_type, kernel_type=kernel_type, decomp=decomp,
            train_ind_ratio=TI_rat, seed=0, likelihood=lik,
            ker_kwargs=ker_kwargs, ind_point_range=var_ind_range, device=dev)
    for name in ("PLMC", "oilmm", "PLMC_fast"):
        if name in models_to_run:
            cfg = dict(MODEL_CONFIGS[name])
            if name == "oilmm" and not oilmm_bulk:
                cfg["bulk"] = False
            models[name] = ProjectedGPModel(
                X, Y, p, q_model, proj_likelihood=None, init_lmc_coeffs=True,
                mean_type="zero", kernel_type=kernel_type, decomp=decomp,
                n_inducing_points=n_ind_points, ker_kwargs=ker_kwargs,
                seed=seed, device=dev, **cfg)
    return {k: _maybe_init_sm(m, X, Y, seed=seed) for k, m in models.items()}


def _loss_fn_for(name, model):
    if name in MODEL_CONFIGS:
        return projected_lmc_mll
    if name == "var":
        return lambda m: m.elbo()
    # MultitaskGPModel: thread the step's generator so that the large-scale
    # LMC CG+SLQ path redraws its Hutchinson probes every iteration (ICM and
    # the dense LMC path ignore it).
    return lambda m, generator: m.mll(generator=generator)


def train_and_eval(models, X_test, Y_test, n_iter=100000, lr=1e-2, lr_min=1e-3,
                   loss_thresh=2.5e-6, patience=500, criterion="max",
                   print_metrics=True, print_loss=False, test_mask=None,
                   block_every=1, scan_steps=None, var_fit="adam",
                   device="cuda"):
    """Shared training + prediction + metrics (experiments.py:256-347).
    Models train in place; returns (results, trained) as the JAX driver.

    ``var_fit="warm_start"`` (or ``"em"``) replaces ELBO gradient training
    of the variational model with the closed-form coordinate ascent
    (``VariationalMultitaskGPModel.sgpr_em``: E-steps on q(u) and exact
    noise M-steps), recorded as ``n_iter=0`` and ``loss = -elbo()``; the
    data-driven kernel initialization supplies the hyperparameters. On real
    data with spectral-mixture kernels this is the configuration that
    works: Adam ELBO training collapses from the whitened init (the ELBO is
    stationary in all interpolant-only parameters there) and the raw
    mixture bandwidths are too step-size-sensitive for scale-free
    optimizers.
    """
    dev = resolve_device(device)
    results = {}
    trained = {}
    for name, model in models.items():
        if (var_fit in ("warm_start", "em") and name == "var"
                and hasattr(model, "sgpr_warm_start")):
            start = time.time()
            model_t = model.sgpr_em()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            train_time = time.time() - start
            with torch.no_grad():
                loss = float(-model_t.elbo())
            info = dict(n_iter=0, train_time=train_time, losses=[], loss=loss)
        else:
            loss_fn = _loss_fn_for(name, model)
            schedule = lambda_lr_schedule(lr_max=lr, lr_min=lr_min)
            model_t, info = fit(model, loss_fn, n_iter=n_iter, lr=lr,
                                schedule=schedule, loss_thresh=loss_thresh,
                                patience=patience, criterion=criterion,
                                print_loss=print_loss, block_every=block_every,
                                scan_steps=scan_steps, device=dev)
        trained[name] = model_t
        results[name] = predict_and_metrics(
            name, model_t, info, X_test, Y_test,
            print_metrics=print_metrics, test_mask=test_mask)
    return results, trained


def predict_and_metrics(name, model_t, info, X_test, Y_test,
                        print_metrics=True, test_mask=None):
    """Prediction + the 15-metric block for one trained model
    (experiments.py:286-347), on the model's device: projected models
    through ``predict(observed=True)`` and their full likelihood's factor,
    the ICM through its cache's posterior mean and ``compute_var``, the
    others through ``model(x, observed=True)``."""
    start = time.time()
    with torch.no_grad():
        if hasattr(model_t, "full_likelihood"):           # projected models
            mean, var = model_t.predict(X_test, observed=True)
            H_guess_hid = model_t.full_likelihood().task_noise_covar_factor
        elif name == "ICM":
            cache = model_t.precompute_posterior()
            mean = model_t.posterior(X_test, cache=cache, observed=True).mean
            var = model_t.compute_var(X_test)         # reference uses compute_var
            H_guess_hid = _noise_matrix(model_t.likelihood)
        else:
            pred = model_t(X_test, observed=True)
            mean, var = pred.mean, pred.variance
            H_guess_hid = _noise_matrix(model_t.likelihood)
        sigma = torch.sqrt(var).cpu().numpy()             # waits for the card
        mean = mean.cpu().numpy()
    pred_time = time.time() - start

    metrics = compute_metrics(Y_test, mean, sigma, info["loss"],
                              H_guess_hid, info["n_iter"], info["train_time"],
                              pred_time, print_metrics=print_metrics,
                              test_mask=test_mask)
    metrics["model"] = name
    return metrics


def _noise_matrix(lik):
    """The estimated task-noise matrix H_guess_hid (experiments.py:333-340):
    a rank > 0 likelihood's factor with the global noise added to its
    diagonal, else sqrt(task noises + global noise). (The JAX driver writes
    the diagonal as ``H[range(p), range(p)]``, which needs rank ≥ p; here
    the factor's min(p, rank) diagonal entries take the noise.)"""
    with torch.no_grad():
        global_noise = lik.noise[0] if lik.has_global_noise else 0.0
        if lik.rank > 0:
            H = lik.task_noise_covar_factor.detach().clone()
            H.diagonal().add_(global_noise)
            return H
        return torch.sqrt(lik.task_noises + global_noise)


# -- CSV accumulation (pandas-free) -------------------------------------------

def _columns(rows):
    """Union of the rows' keys in order of first appearance (the column
    order of ``pd.DataFrame.from_dict(rows, orient="index")``)."""
    cols = {}
    for row in rows.values():
        cols.update(dict.fromkeys(row))
    return list(cols)


def _cell(v, as_float):
    """One CSV field as pandas writes it: empty for a missing or NaN value,
    the shortest round-trip repr for floats (``as_float``: a float64 column
    whatever the value's Python type)."""
    if v is None:
        return ""
    if isinstance(v, str):
        return v
    if as_float or isinstance(v, (float, np.floating)):
        v = float(v)
        return "" if math.isnan(v) else repr(v)
    return str(v)


def _write_csv(path, table, columns, float_cols):
    """``table`` ({row label: {column: value}}) as ``DataFrame.to_csv``
    writes it: an unnamed index column, then ``columns``, those in
    ``float_cols`` as float64."""
    float_cols = set(float_cols)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(columns))
        for label, row in table.items():
            w.writerow([label] + [_cell(row.get(c), c in float_cols)
                                  for c in columns])


def run_study(v_test: str = "void", v_test_2: str = "void",
              n_random_runs: int = 1, models_to_run=None, params=None,
              sweeps=None, path: str = None, n_iter: int = 100000,
              lr: float = 1e-2, lr_min: float = 1e-3,
              loss_thresh: float = 2.5e-6, patience: int = 500,
              print_metrics: bool = False, export_results: bool = True,
              reject_nonconverged_runs: bool = False, block_every: int = 1,
              n_test: int = 2500, dtype=np.float32, device="cuda"):
    """The full parametric study loop (experiments.py:119-380), with the same
    incremental landmark CSV export and optional non-converged-run rejection
    (err > max(0.2, 5·μ_noise), experiments.py:360-365): at runs 1, 10,
    20, … and at the last run, ``<path>_<k>runs.csv`` holds each model's
    metrics averaged over the runs so far (with ``_conv`` rows averaged over
    the converged runs and an ``n_sucess_runs`` column when
    ``reject_nonconverged_runs``), and at the last run ``path`` itself."""
    dev = resolve_device(device)
    v = dict(DEFAULT_PARAMS, **(params or {}))
    v_vals = dict(DEFAULT_SWEEPS, **(sweeps or {}))
    models_to_run = models_to_run or ["ICM", "PLMC", "oilmm", "var", "PLMC_fast"]
    landmarks = [1] + list(range(10, n_random_runs + 1, 10))
    if path is None:
        path = f"results/parameter_study_{v_test}_{v_test_2}.csv"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    results = {}
    table = conv = n_success = columns = updated_cols = None
    for i_run in range(n_random_runs):
        for i_v, vval in enumerate(v_vals[v_test]):
            for i_v2, vval2 in enumerate(v_vals[v_test_2]):
                v[v_test] = vval
                v[v_test_2] = vval2
                run_key = f"_{v_test}_{v_test_2}_{i_v}_{i_v2}"
                print(f"[run_study] run {i_run + 1}/{n_random_runs} "
                      f"{v_test}={vval}"
                      + (f" {v_test_2}={vval2}" if v_test_2 != "void" else ""),
                      file=sys.stderr, flush=True)
                q_noise_guess = v["q_noise_guess"] if v_test == "q_noise_guess" \
                    else v["p"]
                q_mod = v["q"] if v_test != "q_guess" else v["q_guess"]

                data = generate_synthetic(
                    n=v["n"], p=v["p"], q=v["q"], q_noise=v["q_noise"],
                    mu_noise=v["mu_noise"], mu_str=v["mu_str"],
                    max_scale=v["max_scale"], n_test=n_test, seed=i_run,
                    dtype=dtype)
                models = build_models(data["X"], data["Y"], q_mod,
                                      q_noise_guess, models_to_run, seed=i_run,
                                      device=dev)
                run_results, _ = train_and_eval(
                    models, data["X_test"], data["Y_test"], n_iter=n_iter,
                    lr=lr, lr_min=lr_min, loss_thresh=loss_thresh,
                    patience=patience, print_metrics=print_metrics,
                    block_every=block_every, device=dev)
                for name, metrics in run_results.items():
                    metrics.update(v)
                    metrics["model"] = name
                    results[name + run_key] = metrics

        if i_run == 0:
            # the first run fixes rows and columns; the averaged columns
            # (sorted, as pandas' Index.difference) accumulate from 0.0
            columns = _columns(results)
            updated_cols = sorted(set(columns) - set(v) - {"model"})
            table = {label: dict(row, **dict.fromkeys(updated_cols, 0.0))
                     for label, row in results.items()}
            if reject_nonconverged_runs:
                # separate accumulator over converged runs only
                # (experiments.py:353-365)
                conv = {label + "_conv": dict(row) for label, row in
                        table.items()}
                n_success = dict.fromkeys(conv, 0)
        for label, row in table.items():
            for c in updated_cols:
                row[c] = row[c] + float(results[label].get(c, np.nan))
        if reject_nonconverged_runs:
            thresh = max(0.2, 5.0 * float(v["mu_noise"]))
            for label in table:
                if results[label]["mean_err_abs"] < thresh:
                    for c in updated_cols:
                        conv[label + "_conv"][c] += float(
                            results[label].get(c, np.nan))
                    n_success[label + "_conv"] += 1

        # landmarks as in experiments.py:71, plus always at the final run so
        # short studies (n_runs not a multiple of 10) still export
        if ((i_run + 1) in landmarks or i_run + 1 == n_random_runs) \
                and export_results:
            part = {label: dict(row, **{c: row[c] / (i_run + 1)
                                        for c in updated_cols})
                    for label, row in table.items()}
            cols = list(columns)
            if reject_nonconverged_runs:
                cols.append("n_sucess_runs")
                for row in part.values():
                    row["n_sucess_runs"] = float(i_run + 1)
                for label, row in conv.items():
                    count = n_success[label]
                    part[label] = dict(row, n_sucess_runs=float(count), **{
                        c: row[c] / max(count, 1) for c in updated_cols})
            float_cols = updated_cols + (["n_sucess_runs"]
                                         if reject_nonconverged_runs else [])
            _write_csv(path[:-4] + f"_{i_run + 1}runs.csv", part, cols,
                       float_cols)
            if i_run + 1 == n_random_runs:
                # also the requested path itself: callers expect it to
                # exist; the reference writes only suffixed landmarks
                # (experiments.py:367-380)
                _write_csv(path, part, cols, float_cols)
    return results
