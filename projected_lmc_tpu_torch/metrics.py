"""Performance metrics (port of ``projected_lmc_tpu/metrics.py``): the
reference's 15-metric dict (experiments.py:89-115,
realdata_experiments.py:42-72) with the same names and definitions, in
numpy on the host. Tensors are read with ``.cpu().numpy()``."""

from __future__ import annotations

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def compute_metrics(y_test, y_pred, sigma_pred, loss, H_guess_hid, n_iter,
                    train_time, pred_time, print_metrics: bool = True,
                    test_mask=None):
    y_test = _host(y_test)
    y_pred = _host(y_pred)
    sigma_pred = _host(sigma_pred)
    H_guess_hid = _host(H_guess_hid)
    if test_mask is not None:
        test_mask = _host(test_mask)
        y_test = y_test[test_mask]
        y_pred = y_pred[test_mask]
        sigma_pred = sigma_pred[test_mask]

    delta = y_test - y_pred
    errs_abs = np.abs(delta).squeeze()
    sigma_pred = sigma_pred.squeeze()
    alpha_CI = np.mean((errs_abs < 2 * sigma_pred).astype(float))
    err2 = errs_abs**2
    # ddof=1: torch.var's unbiased default, as the reference
    R2_list = 1 - np.mean(err2, axis=0) / np.var(y_test, axis=0, ddof=1)
    PVA_list = np.log(np.mean(err2 / sigma_pred**2, axis=0))
    noise_full = (H_guess_hid**2).sum() / y_test.shape[1]  # mean diag coefficient

    metrics = {}
    metrics["n_iter"] = n_iter
    metrics["train_time"] = train_time
    metrics["pred_time"] = pred_time
    metrics["loss"] = float(loss)
    metrics["noise"] = float(noise_full)
    metrics["R2"] = float(R2_list.mean())
    metrics["RMSE"] = float(np.sqrt(err2.mean()))
    metrics["mean_err_abs"], metrics["max_err_abs"] = float(errs_abs.mean()), float(errs_abs.max())
    (metrics["mean_err_quant05"], metrics["mean_err_quant95"],
     metrics["mean_err_quant99"]) = [float(v) for v in
                                     np.quantile(errs_abs, np.array([0.05, 0.95, 0.99]))]
    metrics["mean_sigma"] = float(sigma_pred.mean())
    metrics["PVA"] = float(PVA_list.mean())
    metrics["alpha_CI"] = float(alpha_CI.mean())
    if print_metrics:
        for key, value in metrics.items():
            print(key, value)
    return metrics
