"""Synthetic multitask data generator, numpy only (the port's own copy of
``projected_lmc_tpu/experiments/synthetic.py``, the paper's data).

q latent Matern-2.5 GPs with lengthscales linspace(min_scale, max_scale, q),
sampled on X = linspace(-1,1,n) ∪ n_test uniform points, mixed by a random
H (q×p) and scaled by (1−μ_noise); plus structured noise
H_hid(q_noise×p)ᵀ·N(0,1)·μ_str and heteroskedastic unstructured noise
(1−μ_str), both scaled by μ_noise.
"""

from __future__ import annotations

import numpy as np


def generate_synthetic(n: int = 500, p: int = 100, q: int = 25,
                       q_noise: int = 25, mu_noise: float = 0.1,
                       mu_str: float = 0.9, max_scale: float = 0.5,
                       min_scale: float = 0.01, n_test: int = 2500,
                       seed: int = 0, dtype=np.float32):
    """Returns dict(X, Y, X_test, Y_test, H_true, sigma_true, lscales)."""
    rng = np.random.default_rng(seed)
    lscales = np.linspace(min_scale, max_scale, q)
    lscales_hid = np.linspace(min_scale, max_scale, q_noise)

    X_train = np.linspace(-1, 1, n)
    X_test = 2 * rng.random(n_test) - 1
    X = np.concatenate([X_train, X_test])[:, None].astype(dtype)

    # latent Matern-2.5 draws: host-side fp64 kernel + Cholesky sampling
    # (an fp32 kernel leaves the near-singular long-lengthscale kernels with
    # fp32-scale negative eigenvalues no reasonable jitter fixes at N ≈ 3000)
    N = X.shape[0]
    absdiff = np.abs(X[:, 0].astype(np.float64)[:, None]
                     - X[:, 0].astype(np.float64)[None, :])
    gp_vals = np.empty((q, N))
    for i in range(q):
        r = absdiff / float(lscales[i])
        c = np.sqrt(5.0) * r
        K = (1.0 + c + (5.0 / 3.0) * r**2) * np.exp(-c)
        jitter = 1e-10
        while True:
            try:
                L = np.linalg.cholesky(K + jitter * np.eye(N))
                break
            except np.linalg.LinAlgError:
                jitter *= 10.0
                if jitter > 1e-2:
                    raise
        gp_vals[i] = L @ rng.standard_normal(N)

    H_true = rng.standard_normal((q, p))
    Y_sig = gp_vals.T @ H_true * (1 - mu_noise)

    # structured noise (experiments.py:156-158)
    H_true_hid = rng.standard_normal((q_noise, p))
    gp_vals_hid_com = rng.standard_normal((q_noise, N))
    Y_noise_com = gp_vals_hid_com.T @ H_true_hid * mu_str

    # unstructured heteroskedastic noise (:161-163)
    noise_levels = rng.random(p) + 0.1
    gp_vals_hid_spec = np.sqrt(noise_levels)[:, None] * rng.standard_normal((p, N))
    Y_noise_spec = gp_vals_hid_spec.T * (1 - mu_str)

    Y_noise = (Y_noise_com + Y_noise_spec) * mu_noise
    sigma_true = H_true_hid.T @ H_true_hid * mu_str + np.diag(noise_levels) * (1 - mu_str)
    Y = (Y_sig + Y_noise).astype(dtype)

    return dict(
        X=X[:n], Y=Y[:n], X_test=X[n:], Y_test=Y[n:],
        H_true=H_true, H_true_hid=H_true_hid,
        sigma_true=sigma_true, lscales=lscales,
        F_test=(gp_vals.T @ H_true * (1 - mu_noise))[n:],
    )
