"""Host-side initialization (port of ``projected_lmc_tpu/ops/init_ops.py``):
the LMC mixing matrix from the labels (``randomized_svd``,
``init_lmc_coefficients``) and the quasi-Monte Carlo samples that place the
variational model's inducing points (``latin_hypercube``, ``sobol``). Runs
once at model construction, in numpy."""

from __future__ import annotations

import numpy as np


def randomized_svd(M, n_components: int, random_state: int = 0):
    """Randomized truncated SVD with sklearn semantics; the exact numpy SVD
    where scikit-learn is not installed."""
    try:
        from sklearn.utils.extmath import randomized_svd as _rsvd
    except ImportError:
        U, S, Vt = np.linalg.svd(np.asarray(M), full_matrices=False)
        return U[:, :n_components], S[:n_components], Vt[:n_components]
    return _rsvd(np.asarray(M), n_components=n_components,
                 random_state=random_state)


def init_lmc_coefficients(train_y, n_latents: int, QR_form: bool = False):
    """SVD-based init of the LMC mixing matrix (projected_lmc.py:183-201):
    coefficients (q, n_tasks) = (U·S/√(n−1))ᵀ, or (U, S) with ``QR_form``.
    Fewer data than latents: a complete QR with a 1e-3 singular-value floor."""
    Y = np.asarray(train_y)
    n_data, n_tasks = Y.shape
    if n_data >= n_latents:
        U, S, _ = randomized_svd(Y.T, n_components=n_latents, random_state=0)
    else:
        Q, R = np.linalg.qr(Y.T, mode="complete")
        S = 1e-3 * np.ones(n_latents, dtype=Y.dtype)
        S[:n_data] = np.diag(R).copy()
        U = Q[:, :n_latents]
    if QR_form:
        return U, S
    return (U * S / np.sqrt(n_data - 1)).T


def latin_hypercube(n: int, dim: int, seed: int = 0):
    """Scrambled Latin hypercube sample in [0, 1)^dim,
    ``scipy.stats.qmc.LatinHypercube(d=dim, seed=seed)``; a numpy one
    from ``default_rng(seed)`` where scipy is not installed."""
    try:
        from scipy.stats import qmc
        return qmc.LatinHypercube(d=dim, seed=seed).random(n=n)
    except Exception:
        rng = np.random.default_rng(seed)
        return (rng.permuted(np.tile(np.arange(n), (dim, 1)), axis=1).T
                + rng.random((n, dim))) / n


def sobol(n: int, dim: int, seed: int = 0):
    """Scrambled Sobol' sample in [0, 1)^dim,
    ``scipy.stats.qmc.Sobol(d=dim, seed=seed, scramble=True)``; uniform
    draws from ``default_rng(seed)`` where scipy is not installed."""
    try:
        from scipy.stats import qmc
        return qmc.Sobol(d=dim, seed=seed, scramble=True).random(n=n)
    except Exception:
        return np.random.default_rng(seed).random((n, dim))
