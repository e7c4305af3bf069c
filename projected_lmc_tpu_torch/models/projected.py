"""Projected LMC, the paper's model (port of
``projected_lmc_tpu/models/projected.py``).

q batch-independent exact latent GPs on the projected data
T(Y) = R⁻¹QᵀYᵀ, coupled by the mixing matrix H = QR: the p-coupled LMC
becomes one batched Cholesky of the (q, n, n) latent covariances (built by
kernel K3 on the card) plus p×p projection algebra.

Mixing-matrix parametrizations:
  * bulk=True: one dense parameter H; Q and R from ``torch.linalg.qr`` at
    each call, in true fp32 on the card;
  * bulk=False: Q_plus = Q_base · map(X − Xᵀ) under ``matrix_exp`` (a
    Padé approximant with scaling and squaring, as JAX's) or the Cayley
    map (Q_base a frozen buffer), R upper triangular or positive
    diagonal.

Noise coupling: BDN (block-diagonal noise; else the learned cross term M),
and a scalar, diagonal or full (Cholesky-parametrized) B̃ for the
discarded-noise factor.

Prediction re-targets the latent exact GP to the projected data:
``prediction_cache`` factorizes the (q, n, n) training system once (K3 and
one batched Cholesky), and each ``predict`` then costs the (q, n, n*)
cross-covariance (K3) and one triangular solve. With
``n_inducing_points`` the latent GPs take ``ExactGPModel``'s Titsias SGPR
route (K3 builds K(z, z) and K(x, z)), and ``projected_lmc_mll``,
``prediction_cache``, ``predict`` and ``compute_loo`` run on it unchanged.

Under a mesh (``parallel.shard_model``) the projection and its terms are
computed whole on every rank (the (n, p) targets are small), each rank
keeps its latents' rows of the (q, n) projected target and factorizes
only its latents (``ExactGPModel`` under a mesh); ``predict`` and
``forward`` gather the latents' means and (co)variances over the latent
group (a sum of zero-padded buffers, exact: q·n* numbers where mixing
first would sum p·n*) and mix them with H as one process does, so the
mixing rounds as the unsharded model's, then add the noise diagonal once.
"""

from __future__ import annotations

import bisect
import functools
import math
import operator

import numpy as np
import torch

from ..constraints import (GreaterThan, lower_triangular_param,
                           positive_diagonal_param,
                           positive_diagonal_param_inverse, scalar_param,
                           upper_triangular_param,
                           upper_triangular_param_inverse)
from ..distributions import MultitaskMultivariateNormal, SumKronRank1Cov
from ..likelihoods import FixedTaskNoise, GaussianLikelihood
from ..module import Module
from ..ops.cholesky import safe_cholesky, solve_triangular
from ..ops.init_ops import init_lmc_coefficients
from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .exact import ExactGPModel


# Padé approximants of exp and the 1-norms below which each degree is
# accurate (then the largest norm before squaring), by dtype: those of
# jax.scipy.linalg.expm (Higham 2005). torch.linalg.matrix_exp is not used:
# on rotations by small angles it was 6e-11 off in float64 (at 0.03 rad) and
# 2.5e-5 in float32 (at 0.5 rad)
_PADE = {3: (120., 60., 12., 1.),
         5: (30240., 15120., 3360., 420., 30., 1.),
         7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
         9: (17643225600., 8821612800., 2075673600., 302702400., 30270240.,
             2162160., 110880., 3960., 90., 1.),
         13: (64764752532480000., 32382376266240000., 7771770303897600.,
              1187353796428800., 129060195264000., 10559470521600.,
              670442572800., 33522128640., 1323241920., 40840800., 960960.,
              16380., 182., 1.)}
_EXPM_DEGREES = {
    torch.float64: ((3, 5, 7, 9, 13), (1.495585217958292e-2,
                                       2.539398330063230e-1,
                                       9.504178996162932e-1,
                                       2.097847961257068), 5.371920351148152),
    torch.float32: ((3, 5, 7), (4.258730016922831e-1, 1.880152677804762),
                    3.925724783138660)}


def _expm(A):
    """exp(A) by scaling and squaring a Padé approximant, as
    jax.scipy.linalg.expm; the 1-norm that picks the degree is read on the
    host."""
    degrees, bounds, maxnorm = _EXPM_DEGREES[A.dtype]
    count("host_read")
    norm = float(torch.linalg.matrix_norm(A.detach(), 1))
    squarings = max(0, math.floor(math.log2(norm / maxnorm))) if norm > 0 \
        else 0
    A = A / 2.0 ** squarings
    m = degrees[bisect.bisect_right(bounds, norm)]
    b = _PADE[m]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2 = A @ A
    if m == 13:
        A4 = A2 @ A2
        A6 = A4 @ A2
        U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2) + b[7] * A6
                 + b[5] * A4 + b[3] * A2 + b[1] * eye)
        V = A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2) + b[6] * A6 \
            + b[4] * A4 + b[2] * A2 + b[0] * eye
    else:
        powers = [eye, A2]                  # A^0, A^2, A^4, ...
        while len(powers) <= m // 2:
            powers.append(powers[-1] @ A2)
        odd = [b[2 * k + 1] * powers[k] for k in range(m // 2, -1, -1)]
        even = [b[2 * k] * powers[k] for k in range(m // 2, -1, -1)]
        U = A @ functools.reduce(operator.add, odd)
        V = functools.reduce(operator.add, even)
    R = torch.linalg.solve(-U + V, U + V)
    for _ in range(squarings):
        R = R @ R
    return R


def _skew(X):
    A = torch.tril(X, -1)
    return A - A.T


def _expm_skew(X):
    return _expm(_skew(X))


def _cayley_skew(X):
    A = _skew(X)
    eye = torch.eye(A.shape[-1], dtype=X.dtype, device=X.device)
    return torch.linalg.solve(eye - 0.5 * A, eye + 0.5 * A)


_ORTHO_MAPS = {"matrix_exp": _expm_skew, "cayley": _cayley_skew}


class LMCMixingMatrix(Module):
    """Parametrized mixing matrix H = Q·R; ``forward()`` returns Hᵀ,
    (n_latents, n_tasks)."""

    def __init__(self, Q_plus, R, bulk: bool = True, diagonal_R: bool = False,
                 ortho_param: str = "matrix_exp"):
        super().__init__()
        Q_plus = torch.as_tensor(Q_plus)
        dtype, dev = Q_plus.dtype, Q_plus.device
        R = torch.as_tensor(R, dtype=dtype, device=dev)
        if Q_plus.shape[1] == Q_plus.shape[0]:
            self.mode = "Q_plus"
        elif Q_plus.shape[1] == R.shape[0]:
            self.mode = "Q"
        else:
            raise ValueError("Wrong dimensions for Q_plus: should be "
                             "n_tasks x n_tasks or n_tasks x n_latents")
        self.n_latents = int(R.shape[0])
        self.n_tasks = int(Q_plus.shape[0])
        self.bulk = bool(bulk)
        self.diagonal_R = bool(diagonal_R)
        self.ortho_param = str(ortho_param)
        q = self.n_latents

        if bulk:
            if self.mode == "Q_plus":
                R_padded = torch.eye(self.n_tasks, dtype=dtype, device=dev)
                R_padded[:q, :q] = R
                H = Q_plus @ R_padded
            else:
                H = Q_plus @ R
            self.register_raw("H", H, dtype, dev)
        else:
            self.register_buffer("Q_base", Q_plus.clone())
            k = Q_plus.shape[1]
            self.register_raw("ortho_raw", torch.zeros((k, k)), dtype, dev)
            Rc = R.clone()
            Rc.diagonal().clamp_(min=1e-12)
            R_raw = positive_diagonal_param_inverse(Rc) if diagonal_R \
                else upper_triangular_param_inverse(torch.triu(Rc))
            self.register_raw("R_raw", R_raw, dtype, dev)

    def _Q_plus(self):
        if self.bulk:
            raise RuntimeError("bulk mode has no explicit Q_plus")
        return self.Q_base @ _ORTHO_MAPS[self.ortho_param](self.ortho_raw)

    def _R(self):
        if self.diagonal_R:
            return positive_diagonal_param(self.R_raw)
        return upper_triangular_param(self.R_raw)

    def QR(self):
        """(Q, R, Q_orth): Q (p, q), R (q, q), and Q_orth (p, p − q), the
        complement, or None when Q_plus is (p, q)."""
        q = self.n_latents
        if self.bulk:
            Q_plus, R_padded = torch.linalg.qr(
                self.H, mode="complete" if self.mode == "Q_plus"
                else "reduced")
            if self.mode == "Q_plus":
                return Q_plus[:, :q], R_padded[:q, :q], Q_plus[:, q:]
            return Q_plus, R_padded, None
        Q_plus = self._Q_plus()
        if self.mode == "Q_plus":
            return Q_plus[:, :q], self._R(), Q_plus[:, q:]
        return Q_plus, self._R(), None

    def forward(self):
        """Hᵀ, (n_latents, n_tasks)."""
        q = self.n_latents
        if self.bulk:
            return self.H.T if self.mode == "Q" else self.H[:, :q].T
        Q, R, _ = self.QR()
        return (Q @ R).T

    def size(self, i=None):
        s = (self.n_latents, self.n_tasks)
        return s if i is None else s[i]

    def r_raw_diag_sum(self):
        """Σ log R_ii through the raw parametrization (the factored mode's
        MLL term)."""
        return torch.diagonal(self.R_raw).sum()


class ProjectedGPModel(ExactGPModel):
    """The projected LMC: an ``ExactGPModel`` batched over the q latents
    (``n_funcs``), trained on the projected data, with ``n_tasks`` = p.
    ``device`` defaults to ``"cuda"``; ``device="cpu"`` runs the kernels'
    plain versions. Parameters and buffers keep the JAX package's names
    (``utils.checkpoint.load_jax_state``)."""

    def __init__(self, train_x, train_y, n_tasks: int, n_latents: int,
                 proj_likelihood=None, init_lmc_coeffs: bool = True,
                 BDN: bool = True, diagonal_B: bool = False,
                 scalar_B: bool = False, diagonal_R: bool = False,
                 mean_type="zero", ortho_param: str = "matrix_exp",
                 bulk: bool = True, noise_thresh: float = -9.0,
                 noise_init: float = 1e-2, outputscales: bool = False,
                 eps: float = 1e-3, kernel_type="rbf", decomp=None,
                 ker_kwargs=None, n_inducing_points=None, seed: int = 0,
                 device="cuda", **kwargs):
        dev = resolve_device(device)
        x_host = np.array(train_x)
        if x_host.ndim == 1:
            x_host = x_host[:, None]
        y_host = np.array(train_y, x_host.dtype)
        n_data, p = y_host.shape
        if p != n_tasks:
            raise ValueError("train_y must be (n, n_tasks)")
        if mean_type not in ("zero", None):
            raise ValueError("Projected GP model does not support non-zero "
                             "output-wise means for now!")
        dtype = torch.as_tensor(x_host).dtype
        q = int(n_latents)
        if proj_likelihood is None or proj_likelihood.batch != q:
            proj_likelihood = GaussianLikelihood(
                batch_shape=q,
                noise_constraint=GreaterThan(float(np.exp(noise_thresh))),
                dtype=dtype, device=dev)

        super().__init__(x_host, np.zeros((q, n_data), x_host.dtype),
                         proj_likelihood, n_tasks=q, mean_type="zero",
                         outputscales=outputscales, kernel_type=kernel_type,
                         decomp=decomp, ker_kwargs=ker_kwargs,
                         n_inducing_points=n_inducing_points, seed=seed,
                         device=dev, **kwargs)
        self.register_buffer("train_y_tasks", torch.as_tensor(y_host,
                                                              device=dev))

        # mixing matrix: the labels' SVD, or a random orthogonal basis
        if init_lmc_coeffs:
            if scalar_B and BDN:
                Q_plus, R = init_lmc_coefficients(y_host, n_latents=q,
                                                  QR_form=True)
            else:
                Q_plus, R_padded = init_lmc_coefficients(y_host,
                                                         n_latents=p,
                                                         QR_form=True)
                R = np.asarray(R_padded)[:q]
        else:
            rng = np.random.default_rng(seed)
            Q_plus, R_padded, _ = np.linalg.svd(
                rng.standard_normal((p, q)), full_matrices=True)
            R = R_padded[:q]
            if scalar_B and BDN:
                Q_plus = Q_plus[:, :q]
        R = np.diag(np.asarray(R)) / np.sqrt(n_data - 1)
        self.lmc_coefficients = LMCMixingMatrix(
            torch.as_tensor(np.asarray(Q_plus), dtype=dtype, device=dev),
            torch.as_tensor(R, dtype=dtype, device=dev), bulk=bulk,
            diagonal_R=diagonal_R, ortho_param=ortho_param)

        # discarded-noise factor B̃, (p − q) wide
        self.noise_thresh = float(noise_thresh)
        k = p - q
        if scalar_B:
            diagonal_B = True
            self.register_raw("log_B_tilde_raw",
                              np.full(k, math.log(noise_init)), dtype, dev)
            self.B_mode = "scalar"
            if BDN:
                self.register_buffer("Y_squared_norm",
                                     (self.train_y_tasks ** 2).sum())
        elif diagonal_B:
            self.register_raw(
                "log_B_tilde_raw", GreaterThan(noise_thresh).inverse(
                    torch.as_tensor(np.full(k, math.log(noise_init)))),
                dtype, dev)
            self.B_mode = "diagonal"
        else:
            self.register_raw(
                "B_tilde_inv_chol_raw",
                np.diag(np.full(k, math.log(1.0 / noise_init))), dtype, dev)
            self.B_mode = "full"
        self.diagonal_B, self.scalar_B = bool(diagonal_B), bool(scalar_B)
        self.BDN = bool(BDN)
        if not BDN:
            self.register_raw("M", torch.zeros((q, k)), dtype, dev)

        self.n_tasks = int(p)       # the ExactGPModel batch stays n_funcs = q
        self.n_latents = q
        self.latent_dim = -1
        self.eps = float(eps)

    # -- parametrized noise components ----------------------------------------
    @property
    def log_B_tilde(self):
        """(p − q,) log of B̃'s diagonal under the active parametrization."""
        if self.B_mode == "scalar":
            if self.log_B_tilde_raw.numel() == 0:
                return self.log_B_tilde_raw
            return scalar_param(self.log_B_tilde_raw,
                                (self.noise_thresh, -self.noise_thresh))
        if self.B_mode == "diagonal":
            return GreaterThan(self.noise_thresh).forward(self.log_B_tilde_raw)
        raise AttributeError("log_B_tilde undefined for full B̃ "
                             "parametrization")

    @property
    def B_tilde_inv_chol(self):
        """Lower-triangular factor of B̃⁻¹ (full mode)."""
        return lower_triangular_param(self.B_tilde_inv_chol_raw,
                                      (self.noise_thresh, -self.noise_thresh))

    def projected_noise(self):
        """σ_P, (q,)."""
        return self.likelihood.noise[..., 0]

    def B_tilde(self):
        """The discarded-noise factor B̃, (p − q, p − q)."""
        if self.diagonal_B:
            return torch.diag(torch.exp(self.log_B_tilde))
        L = self.B_tilde_inv_chol
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        L_inv = solve_triangular(L, eye, lower=True)
        return L_inv.T @ L_inv

    # -- projection algebra ---------------------------------------------------
    def projection_matrix(self):
        """T = Q R⁻ᵀ (+ Q⊥ Mᵀ Σ_P without BDN), (p, q): Y T is the projected
        data, transposed."""
        Q, R, Q_orth = self.lmc_coefficients.QR()
        H_pinv = solve_triangular(R, Q.T, lower=False).T
        if not self.BDN:
            return H_pinv \
                + (Q_orth @ self.M.T) * self.projected_noise()[None, :]
        return H_pinv

    def project_data(self, data):
        """(q, n) projected data R⁻¹Qᵀ dataᵀ (+ the M cross term without
        BDN), for data (n, p)."""
        return self._project(data, *self.lmc_coefficients.QR())

    def _project(self, data, Q, R, Q_orth):
        proj = solve_triangular(R, Q.T @ data.T, lower=False)
        if not self.BDN:
            cross = self.M @ (Q_orth.T @ data.T)
            proj = proj + self.projected_noise()[:, None] * cross
        return proj

    def full_likelihood(self, differentiable: bool = False) -> FixedTaskNoise:
        """The p×p task noise Σ = (QR)Σ_P(QR)ᵀ + Q⊥B̃Q⊥ᵀ (+ cross terms),
        factorized by the jitter ladder. The factor is detached unless
        ``differentiable``: the noise parameters train through
        ``projected_lmc_mll``, not through this reconstruction."""
        Q, R, Q_orth = self.lmc_coefficients.QR()
        QR = Q @ R
        sigma_p = self.projected_noise()
        p, q = self.n_tasks, self.n_latents
        eye_p = torch.eye(p, dtype=QR.dtype, device=QR.device)
        if not self.BDN:
            B_tilde = self.B_tilde()
            SM = sigma_p[:, None] * self.M
            B_term = Q_orth @ B_tilde @ Q_orth.T
            M_term = -QR @ SM @ B_tilde @ Q_orth.T
            D_rot = torch.diag(sigma_p) + SM @ B_tilde \
                @ (self.M.T * sigma_p[None, :])
            Sigma = QR @ D_rot @ QR.T + M_term + M_term.T + B_term
        else:
            if self.scalar_B:
                if self.log_B_tilde_raw.numel() > 0:
                    B_term = torch.exp(self.log_B_tilde[0]) * (eye_p - Q @ Q.T)
                else:
                    B_term = torch.zeros_like(eye_p)
            elif self.diagonal_B:
                root = Q_orth @ torch.diag(torch.exp(self.log_B_tilde / 2))
                B_term = root @ root.T
            else:
                Binv_chol = self.B_tilde_inv_chol
                eye_k = torch.eye(p - q, dtype=QR.dtype, device=QR.device)
                root = Q_orth @ solve_triangular(Binv_chol, eye_k,
                                                 lower=True).T
                B_term = root @ root.T
            D_root = QR * torch.sqrt(sigma_p)[None, :]
            Sigma = D_root @ D_root.T + B_term
        chol = safe_cholesky(Sigma + 1e-6 * eye_p)
        return FixedTaskNoise(chol if differentiable else chol.detach())

    # -- latent and task posteriors ------------------------------------------
    def prediction_cache(self):
        """Factorize the training system once for repeated posterior
        queries: project the task targets and factorize K + Σ_P. Pass the
        returned dict as ``cache=`` to :meth:`predict` or
        :meth:`compute_latent_distrib`; each call then costs only the
        (q, n, n*) cross-covariance and its solve."""
        proj = self.project_data(self.train_y_tasks)
        return self.precompute_posterior(targets=proj, orientation="tn")

    def compute_latent_distrib(self, x, full_cov: bool = True, cache=None):
        """Batched latent posterior at x, the exact GP re-targeted to the
        projected data."""
        if cache is None:
            cache = self.prediction_cache()
        return self.posterior(x, cache=cache, full_cov=full_cov)

    def latent_prior(self, x):
        """Training-mode forward: the batched latent prior."""
        return self.prior(x)

    def compute_loo(self):
        """LOO in latent space: (σ², y − μ), both (n, q), detached when
        q > 1."""
        proj = self.project_data(self.train_y_tasks)
        return super().compute_loo(targets=proj, orientation="tn")

    def forward(self, x, observed: bool = False, full_cov: bool = False):
        """Eval-mode full posterior: the latent posterior mixed up to the
        tasks, covariance Σ_b K_b ⊗ h_b h_bᵀ (+ I ⊗ Σ when ``observed``)."""
        latent = self.compute_latent_distrib(x, full_cov=True)
        mean, cov = latent.mean, latent.covariance_matrix
        if self.mesh is not None:
            q = self.n_latents
            lo, hi = self.mesh.latent_range(q)
            both = self.mesh.gather_latents(
                torch.cat([mean, cov.flatten(1)], 1), lo, hi, q)
            mean = both[:, :mean.shape[1]]
            cov = both[:, mean.shape[1]:].reshape(q, *cov.shape[1:])
        H = self.lmc_coefficients()                             # (q, p)
        Sigma = self.full_likelihood().task_covariance() if observed else None
        return MultitaskMultivariateNormal(mean.T @ H,
                                           SumKronRank1Cov(cov, H.T, Sigma))

    def predict(self, x, observed: bool = True, cache=None):
        """(mean, variance), both (n*, p), at x, with the observation noise
        when ``observed``. Pass ``cache=model.prediction_cache()`` to reuse
        the training system's factorization across calls."""
        with span("predict"):
            latent = self.compute_latent_distrib(x, full_cov=False,
                                                 cache=cache)
            mean, var = latent.mean, latent.variance
            if self.mesh is not None:
                lo, hi = self.mesh.latent_range(self.n_latents)
                mean, var = self.mesh.gather_latents(
                    torch.cat([mean, var], 1), lo, hi, self.n_latents).split(
                    mean.shape[1], 1)
            H = self.lmc_coefficients()
            mean = mean.T @ H
            var = var.T @ (H * H)
            if observed:
                with span("predict.noise"):
                    Sigma = self.full_likelihood().task_covariance()
                var = var + torch.diagonal(Sigma)[None, :]
            return mean, var
