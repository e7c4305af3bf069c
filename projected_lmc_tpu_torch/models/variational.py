"""Variational multitask (LMC) GP: SVGP over q latents that share their
inducing points (port of ``projected_lmc_tpu/models/variational.py``).

  whitened (default):   q(f_b) = N(A_b m_b, K_b − A_b A_bᵀ + A_b S_b A_bᵀ),
                        A_b = K_xz,b L_zz,b⁻ᵀ,  KL = KL(N(m,S) ‖ N(0,I))
  unwhitened:           q(u) in function space, KL = KL(N(m,S) ‖ N(0,K_zz));
                        forced when ``train_ind_ratio == 1``, with the
                        inducing points frozen at the training inputs

The inducing points, ⌊n / train_ind_ratio⌋ of them, start at a scrambled
Latin hypercube (or Sobol') sample of [−1, 1]^d (or of the data's box, or
a given one). Deterministic means live on the tasks; the latents' are zero.
K(z, z) and K(x, z) are kernel K3 on the card (``kernels``). The
closed-form SGPR E-step (``sgpr_warm_start``) and noise M-step
(``noise_mstep``) run once, in float64 on the model's device, and write
the model in place.

Under a mesh (``parallel.shard_model``) the ELBO takes the rank's rows
(data axis) and its latents (latent axis, ``var_mean``, ``var_chol`` and
the kernel's leaves sliced), and sums by ``parallel.sharded``'s rule: μ·W
and the trace term Σ_b var_b·(WΣt⁻¹Wᵀ)_bb and the KL over the latent group
in one call, the expected log-likelihood over the data group; its n·logdet
term counts the rank's rows, ``num_data`` stays the global n.
``model(x, observed=True)`` mixes the rank's latents and sums over the
latent group. The E/M steps are not sharded.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import KERNEL_REGISTRY, handle_covar
from ..likelihoods import MultitaskGaussianLikelihood
from ..means import MEAN_REGISTRY
from ..module import Module, latent_slice
from ..ops.cholesky import (cho_solve, logdet_from_chol, safe_cholesky,
                            solve_triangular)
from ..ops.init_ops import init_lmc_coefficients, latin_hypercube, sobol
from ..utils.device import resolve_device
from ..utils.profiling import count
from .exact import _as_inputs, _resolve, inducing_factor
from .multitask import _MeanVarMT


def _chol_ladder(A, jitter):
    """(chol(A_b + j_b I), j_b) for each batch element, j_b the first of
    jitter·10^k whose factorization succeeds (one host read a rung); raises
    past 1e2·max(1, max|A_b|)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    j = torch.full(A.shape[:-2], float(jitter), dtype=A.dtype,
                   device=A.device)
    limit = 1e2 * torch.clamp(A.abs().amax((-2, -1)), min=1.0)
    while True:
        L, info = torch.linalg.cholesky_ex(A + j[..., None, None] * eye)
        bad = info != 0
        count("host_read")
        if not bool(bad.any()):
            return L, j
        j = torch.where(bad, j * 10, j)
        count("host_read")
        if bool((bad & (j > limit)).any()):
            raise torch.linalg.LinAlgError(
                "Cholesky failed up to a jitter of 1e2·max|A|")


def sgpr_optimal_q(Kzz, Kzx, Lzz, L_t, noise: float, jitter: float,
                   whitened: bool):
    """The float64 algebra of the SGPR E-step: (m*, chol(S*)), (q, m) and
    (q, m, m), from K_zz (q, m, m), K_zx (q, m, n), the runtime whitening
    factor L_zz, the latent targets L_t (q, n) and the noise σ²:

        K_b = K_zz + j_b I (j_b from the jitter ladder),
        Σ_b = K_b + σ⁻² K_zx K_xz,
        m*_b = σ⁻² K_b Σ_b⁻¹ K_zx ỹ_b,   S*_b = K_b Σ_b⁻¹ K_b,

    whitened by L_zz when ``whitened``; S*'s factor from the ladder."""
    eye = torch.eye(Kzz.shape[-1], dtype=Kzz.dtype, device=Kzz.device)
    Kb = Kzz + _chol_ladder(Kzz, jitter)[1][:, None, None] * eye
    Sig = Kb + Kzx @ Kzx.transpose(-1, -2) / noise
    m_u = (Kb @ torch.linalg.solve(Sig, Kzx @ L_t[..., None]))[..., 0] / noise
    S_u = Kb @ torch.linalg.solve(Sig, Kb)
    S_u = 0.5 * (S_u + S_u.transpose(-1, -2))
    if whitened:
        m_u = solve_triangular(Lzz, m_u[..., None], lower=True)[..., 0]
        S_w = solve_triangular(Lzz, solve_triangular(Lzz, S_u, lower=True)
                               .transpose(-1, -2), lower=True)
        S_u = 0.5 * (S_w + S_w.transpose(-1, -2))
    return m_u, _chol_ladder(S_u, jitter)[0]


def optimal_task_noise(Y, mean, var_l, W):
    """The ELBO's maximizer over the task noise, Σt* = (ΔᵀΔ + Wᵀ diag(Σₙ
    var_l) W)/n, (T, T), symmetrized: Δ = Y − mean (n, T), var_l (q, n) the
    latent variances, W (q, T) the mixing."""
    delta = Y - mean
    S = (delta.T @ delta + (W.T * var_l.sum(1)) @ W) / Y.shape[0]
    return 0.5 * (S + S.T)


def ppca_task_noise(S, rank: int, floor: float):
    """Σt* projected onto a rank-``rank`` factor plus a global noise,
    probabilistic-PCA style: (F (T, rank), σ²), σ² the mean of the
    trailing eigenvalues (at least ``floor``), F = V_r·√(λ_r − σ²)."""
    p = S.shape[0]
    lam, V = torch.linalg.eigh(S)                               # ascending
    lam = torch.clamp(lam.flip(0), min=0.0)
    V = V.flip(1)
    r = min(rank, p - 1) if p > 1 else rank
    count("host_read")
    sigma2 = max(float(lam[r:].mean()) if r < p else floor, floor)
    return V[:, :rank] * torch.sqrt(torch.clamp(lam[:rank] - sigma2,
                                                min=0.0))[None, :], sigma2


class VariationalMultitaskGPModel(Module):
    """SVGP LMC with a Cholesky, mean-field or delta variational
    distribution over the q latents (projected_lmc.py:659-813).

    ``device`` defaults to ``"cuda"``; ``device="cpu"`` runs the kernels'
    plain versions. Parameters keep the JAX package's raw leaves and names
    (``utils.checkpoint.load_jax_state``): ``inducing_points``,
    ``var_mean``, ``var_chol`` (the full (q, m, m) leaf, of which the
    lower triangle is used) or ``var_chol_diag``, ``lmc_coeffs`` (q, T),
    ``output_mean_module.*``, ``covar_module.*``, ``likelihood.*``.
    ``train_y`` is stored (n, T)."""

    # under a mesh, the latent group's vote on each rung of the ladder
    _agree = None

    def __init__(self, train_x, n_latents: int, n_tasks: int = None,
                 train_ind_ratio: float = 1.5, seed: int = 0,
                 init_lmc_coeffs: bool = False, train_y=None,
                 prior_scales=None, prior_width=None, mean_type="constant",
                 kernel_type="rbf", outputscales: bool = False, decomp=None,
                 likelihood: MultitaskGaussianLikelihood = None,
                 ker_kwargs=None, distrib: str = "cholesky",
                 var_strat: str = "default", ind_point_method: str = "lhc",
                 ind_point_range=None, device="cuda", **kwargs):
        super().__init__()
        dev = resolve_device(device)
        x_host = np.asarray(train_x)
        if x_host.ndim == 1:
            x_host = x_host[:, None]
        x = torch.as_tensor(x_host, device=dev)
        dtype = x.dtype
        self.register_buffer("train_x", x)
        self.dim = int(x.shape[1])
        n = int(x.shape[0])
        y_host = None
        if train_y is not None:
            y_host = np.asarray(train_y, x_host.dtype)
            if n_tasks is None or y_host.shape[1] != n_tasks:
                n_tasks = y_host.shape[1]
            self.register_buffer("train_y", torch.as_tensor(y_host,
                                                            device=dev))
        else:
            self.register_buffer("train_y", None)
        self.n_tasks, self.n_latents = int(n_tasks), int(n_latents)

        # "whitened" (the reference's VariationalStrategy), "unwhitened", or
        # "default": whitened unless train_ind_ratio == 1, where the
        # reference fixes the inducing points at the training inputs and
        # forces the unwhitened strategy with a Cholesky distribution
        if var_strat not in ("default", "whitened", "unwhitened"):
            raise ValueError(f"unknown variational strategy {var_strat!r}")
        ratio_one = float(train_ind_ratio) == 1.0
        self.whitened = (not ratio_one if var_strat == "default"
                         else var_strat == "whitened")
        if ratio_one:
            self.whitened = False
            self._frozen_params_ = ("inducing_points",)
            inducing = x_host
            distrib = "cholesky"
        else:
            n_ind = int(np.floor(n / float(train_ind_ratio)))
            qmc = sobol if ind_point_method == "sobol" else latin_hypercube
            u = qmc(n_ind, self.dim, seed=seed)                 # [0, 1)^d
            if ind_point_range is None:
                lo, hi = -1.0, 1.0
            elif isinstance(ind_point_range, str) \
                    and ind_point_range == "data":
                lo, hi = x_host.min(axis=0), x_host.max(axis=0)
            else:
                lo, hi = (np.asarray(v, np.float64) for v in ind_point_range)
            inducing = (lo + (hi - lo) * u).astype(x_host.dtype)
        self.register_raw("inducing_points", inducing, dtype, dev)
        m = int(self.inducing_points.shape[0])

        # q(u_b): mean 0, covariance at the prior (I whitened, K_zz not)
        if distrib not in ("cholesky", "mean_field", "delta"):
            raise ValueError(f"unknown variational distribution {distrib!r}")
        self.distrib = str(distrib)
        q = self.n_latents
        self.register_raw("var_mean", torch.zeros((q, m)), dtype, dev)
        if distrib == "cholesky":
            self.register_raw("var_chol", torch.eye(m).expand(q, m, m),
                              dtype, dev)
        elif distrib == "mean_field":
            self.register_raw("var_chol_diag", torch.ones((q, m)), dtype, dev)

        self.covar_module = handle_covar(
            _resolve(KERNEL_REGISTRY, kernel_type, "rbf"),
            dim=self.dim, decomp=decomp, prior_scales=prior_scales,
            prior_width=prior_width, outputscales=outputscales, n_funcs=q,
            ker_kwargs=ker_kwargs, dtype=dtype, device=dev)
        mean_cls = _resolve(MEAN_REGISTRY, mean_type, "constant")
        self.output_mean_module = mean_cls(
            input_size=self.dim, batch_shape=self.n_tasks, dtype=dtype,
            seed=seed, device=dev)
        if likelihood is None:
            likelihood = MultitaskGaussianLikelihood(
                num_tasks=self.n_tasks, rank=0, seed=seed, dtype=dtype,
                device=dev)
        self.likelihood = likelihood

        if init_lmc_coeffs and y_host is not None:
            coeffs = np.asarray(init_lmc_coefficients(y_host, q))
        else:
            coeffs = np.random.default_rng(seed).standard_normal(
                (q, self.n_tasks))
        self.register_raw("lmc_coeffs", coeffs, dtype, dev)      # (q, T)

        if not self.whitened and self.distrib != "delta":
            # the unwhitened prior is N(0, K_zz): start q(u) there, the
            # factor's ladder starting at the runtime jitter of
            # _kernel_factors (S = K_zz + 1e-6 I, so the first KL is zero)
            with torch.no_grad():
                Kzz = self.covar_module(self.inducing_points).double()
                if self.distrib == "mean_field":
                    self.var_chol_diag.copy_(torch.sqrt(torch.clamp(
                        torch.diagonal(Kzz, dim1=-2, dim2=-1), min=1e-12)))
                else:
                    # one jitter for the whole stack, raising past 1e2
                    eye = torch.eye(m, dtype=Kzz.dtype, device=Kzz.device)
                    jitter = 1e-6
                    while True:
                        L, info = torch.linalg.cholesky_ex(Kzz + jitter * eye)
                        count("host_read")
                        if not bool((info != 0).any()):
                            break
                        jitter *= 10
                        if jitter > 1e2:
                            raise torch.linalg.LinAlgError(
                                "K_zz's Cholesky failed up to a jitter of "
                                "1e2")
                    self.var_chol.copy_(L)
        self.mesh = None

    @property
    def device(self):
        return self.train_x.device

    def lmc_coefficients(self):
        """(q, T) mixing coefficients, as a numpy array."""
        return self.lmc_coeffs.detach().cpu().numpy()

    # -- closed-form E and M steps ----------------------------------------------
    def sgpr_warm_start(self, noise=None, jitter: float = 1e-6):
        """Set q(u) to the closed-form SGPR optimum given the current kernel
        (Titsias 2009), in place; returns the model.

        At the standard init the ELBO is stationary in every parameter that
        enters only through K_xz K_zz⁻¹ (it cancels when S equals the
        prior), so gradient descent can reach the collapsed optimum before
        the variational mean fits anything. With per-latent targets
        ỹ_b = Y H_b⁺ (the minimum-norm solution of Hᵀ L = Yᵀ, by the
        pseudo-inverse) and σ² = ``noise`` (default: the mean diagonal of
        the task covariance):

            Σ_b = K_zz + σ⁻² K_zx K_xz,
            m*_b = σ⁻² K_zz Σ_b⁻¹ K_zx ỹ_b,   S*_b = K_zz Σ_b⁻¹ K_zz,

        whitened against the runtime factor of :meth:`_kernel_factors`.
        Runs once in float64 on the model's device: O(q·(m³ + m²n)), K3
        for K(z, z) and K(z, x). Call it after any data-driven kernel
        initialization."""
        if self.train_y is None:
            raise ValueError("sgpr_warm_start requires train_y")
        f64 = torch.float64
        with torch.no_grad():
            H = self.lmc_coeffs.to(f64)                         # (q, T)
            L_t = torch.linalg.pinv(H.T) @ self.train_y.to(f64).T  # (q, n)
            if noise is None:
                count("host_read")
                noise = float(torch.diagonal(
                    self.likelihood.task_covariance().to(f64)).mean())
            z = self.inducing_points
            Kzz = self.covar_module(z).to(f64)                  # (q, m, m)
            Kzx = self.covar_module(z, self.train_x).to(f64)    # (q, m, n)
            m_u, S_chol = sgpr_optimal_q(
                Kzz, Kzx, self._kernel_factors().to(f64), L_t, noise, jitter,
                self.whitened)
            self.var_mean.copy_(m_u)
            if self.distrib == "cholesky":
                self.var_chol.copy_(S_chol)
            elif self.distrib == "mean_field":
                self.var_chol_diag.copy_(torch.sqrt(torch.clamp(
                    (S_chol * S_chol).sum(-1), min=1e-12)))
        return self

    def noise_mstep(self, floor: float = 1e-4):
        """Maximize the ELBO over the task noise Σt given q(u), in place;
        returns the model.

        The expected log-likelihood is −½[tr(Σt⁻¹ C) + n·logdet Σt] + const
        with C = ΔᵀΔ + Wᵀ diag(Σₙ var_l) W, so Σt* = C/n, projected onto the
        likelihood's parametrization: for rank r > 0 probabilistic-PCA
        style (σ²_global the mean of the trailing eigenvalues, F =
        V_r·√(λ_r − σ²)); for rank 0 the per-task diagonal, σ²_global at
        ``floor``. Alternate with the E-step through :meth:`sgpr_em`."""
        if self.train_y is None:
            raise ValueError("noise_mstep requires train_y")
        f64 = torch.float64
        lik = self.likelihood
        with torch.no_grad():
            X = self.train_x
            Y = self.train_y.to(f64)
            mean_l, var_l = self.compute_latent_distrib(X, full_cov=False)
            W = self.lmc_coeffs.to(f64)                          # (q, T)
            S = optimal_task_noise(
                Y, mean_l.to(f64).T @ W
                + self.output_mean_module(X).to(f64).T, var_l.to(f64), W)
            if lik.rank > 0:
                F, sigma2 = ppca_task_noise(S, lik.rank, floor)
                lik.task_noise_covar_factor.copy_(F)
                if lik.has_global_noise:
                    lik.set_noise(sigma2)
            else:
                diag = torch.clamp(torch.diagonal(S), min=floor)
                if lik.has_task_noise:
                    sigma2 = floor
                else:
                    count("host_read")
                    sigma2 = max(float(diag.mean()), floor)
                if lik.has_global_noise:
                    lik.set_noise(sigma2)
                if lik.has_task_noise:
                    lik.raw_task_noises.copy_(lik.constraint.inverse(
                        torch.clamp(diag - sigma2, min=floor)))
        return self

    def sgpr_em(self, n_steps: int = 3, jitter: float = 1e-6,
                floor: float = 1e-4):
        """Coordinate ascent on the ELBO with no gradient steps:
        ``n_steps`` rounds of the E-step (:meth:`sgpr_warm_start`) and the
        M-step (:meth:`noise_mstep`), ending on the M-step so that the noise
        explains what q(u) leaves unexplained. In place; returns the
        model."""
        for _ in range(max(int(n_steps), 1)):
            self.sgpr_warm_start(jitter=jitter)
            self.noise_mstep(floor=floor)
        return self

    # -- variational machinery ----------------------------------------------------
    def _S_chol(self, lo: int = 0, hi: int = None):
        """(hi − lo, m, m) lower factor of S for latents lo..hi − 1 (all by
        default), or None for the delta distribution."""
        if self.distrib == "cholesky":
            return torch.tril(self.var_chol[lo:hi])
        if self.distrib == "mean_field":
            return torch.diag_embed(self.var_chol_diag[lo:hi])
        return None

    def _kernel_factors(self, covar=None):
        """L_zz, the lower factor of K_zz + 1e-6 I, (q, m, m), for
        ``covar`` (default: the covariance module)."""
        return inducing_factor(
            self.covar_module if covar is None else covar,
            self.inducing_points,
            None if self.mesh is None else self.mesh.latent_any)

    def _latents(self):
        """(lo, hi, covar): the latents lo..hi − 1 this rank computes and
        the covariance module restricted to them; every latent and the
        module itself without a mesh."""
        q = self.n_latents
        if self.mesh is None:
            return 0, q, self.covar_module
        lo, hi = self.mesh.latent_range(q)
        return lo, hi, latent_slice(self.covar_module, lo, hi, q)

    def compute_latent_distrib(self, x, full_cov: bool = False,
                               prior: bool = False):
        """q(f_b(x)) for the q latents: (mean (q, n), var (q, n)), the
        variance clipped at 1e-12, or (mean, cov (q, n, n)) with
        ``full_cov``. ``prior=True`` gives the latent prior at x."""
        x = _as_inputs(x, self.train_x)
        if prior:
            mean = torch.zeros((self.n_latents, x.shape[0]), dtype=x.dtype,
                               device=x.device)
            if full_cov:
                return mean, self.covar_module(x)
            return mean, torch.clamp(self.covar_module(x, diag=True),
                                     min=1e-12)
        lo, hi, covar = self._latents()
        mean, cov = self._latent_distrib(x, full_cov, lo, hi, covar)
        if self.mesh is None:
            return mean, cov
        q = self.n_latents
        both = self.mesh.gather_latents(
            torch.cat([mean, cov.flatten(1)], 1), lo, hi, q)
        return (both[:, :mean.shape[1]],
                both[:, mean.shape[1]:].reshape(q, *cov.shape[1:]))

    def _latent_distrib(self, x, full_cov, lo, hi, covar):
        """q(f_b(x)) for latents lo..hi − 1, ``covar`` their covariance
        module (:meth:`_latents`)."""
        Lzz = self._kernel_factors(covar)
        Kxz = covar(x, self.inducing_points)                    # (q, n, m)
        S_chol = self._S_chol(lo, hi)
        if self.whitened:
            A = solve_triangular(Lzz, Kxz.transpose(-1, -2),
                                 lower=True).transpose(-1, -2)  # (q, n, m)
            B = A
        else:
            # interp = K_xz K_zz⁻¹; cov = Kxx − (interp Lzz)(interp Lzz)ᵀ
            # + (interp S)(interp S)ᵀ
            A = cho_solve(Lzz, Kxz.transpose(-1, -2)).transpose(-1, -2)
            B = A @ Lzz
        mean = (A @ self.var_mean[lo:hi, :, None])[..., 0]
        AS = None if S_chol is None else A @ S_chol
        if full_cov:
            cov = covar(x) - B @ B.transpose(-1, -2)
            if AS is not None:
                cov = cov + AS @ AS.transpose(-1, -2)
            return mean, cov
        var = covar(x, diag=True) - (B * B).sum(-1)
        if AS is not None:
            var = var + (AS * AS).sum(-1)
        return mean, torch.clamp(var, min=1e-12)

    def kl_divergence(self):
        """Σ_b KL(q(u_b) ‖ p(u_b)); the whitened prior is N(0, I). The
        delta distribution's KL is −log p(m), gpytorch's MAP convention.
        Under a mesh each rank sums its latents' and the latent group the
        rest."""
        lo, hi, covar = self._latents()
        kl = self._kl(lo, hi, covar)
        return kl if self.mesh is None else self.mesh.latent_sum(kl)

    def _kl(self, lo, hi, covar):
        """Σ_b KL(q(u_b) ‖ p(u_b)) over latents lo..hi − 1."""
        S_chol = self._S_chol(lo, hi)
        var_mean = self.var_mean[lo:hi]
        m = var_mean.shape[-1]
        log2pi = m * math.log(2 * math.pi)
        if self.whitened:
            quad = (var_mean * var_mean).sum(-1)
            if S_chol is None:
                return (0.5 * (quad + log2pi)).sum()
        else:
            Lzz = self._kernel_factors(covar)
            w = solve_triangular(Lzz, var_mean[..., None],
                                 lower=True)[..., 0]
            quad = (w * w).sum(-1)
            logdet_K = logdet_from_chol(Lzz)
            if S_chol is None:
                return (0.5 * (quad + logdet_K + log2pi)).sum()
        diag = torch.diagonal(S_chol, dim1=-2, dim2=-1)
        logdet_S = torch.log(diag * diag).sum(-1)
        if self.whitened:
            tr = (S_chol * S_chol).sum((-2, -1))
            return (0.5 * (tr + quad - m - logdet_S)).sum()
        iL_S = solve_triangular(Lzz, S_chol, lower=True)
        tr = (iL_S * iL_S).sum((-2, -1))
        return (0.5 * (tr + quad - m + logdet_K - logdet_S)).sum()

    # -- task-level predictions -----------------------------------------------------
    def forward(self, x, observed: bool = False):
        """Task-level posterior mean and variance, (n, T) each: the LMC
        mixing of the latents plus the task means (and diag(Σt) when
        ``observed``)."""
        x = _as_inputs(x, self.train_x)
        lo, hi, covar = self._latents()
        mean_l, var_l = self._latent_distrib(x, False, lo, hi, covar)
        W = self.lmc_coeffs[lo:hi]
        mean, var = mean_l.T @ W, var_l.T @ (W * W)
        if self.mesh is not None:
            mean, var = self.mesh.latent_sum(torch.cat([mean, var], 1)).split(
                W.shape[1], 1)
        mean = mean + self.output_mean_module(x).T
        if observed:
            var = var + torch.diagonal(self.likelihood.task_covariance())[
                None, :]
        return _MeanVarMT(mean, var)

    def elbo(self, x=None, y=None, num_data: int = None):
        """gpytorch's VariationalELBO: (E_q[log p(y|f)] − KL + hyper-priors)
        / num_data, the expected log-likelihood under the multitask
        Gaussian noise Σt in closed form. ``x``, ``y`` (n, T) default to
        the training data, ``num_data`` to their n (a minibatch passes the
        full n). Under a mesh each rank takes its rows of x and y and its
        latents, and the sums run over the groups."""
        x = self.train_x if x is None else _as_inputs(x, self.train_x)
        y = self.train_y if y is None else torch.as_tensor(
            y, dtype=x.dtype, device=x.device)
        num_data = x.shape[0] if num_data is None else num_data
        if self.mesh is not None:
            r0, r1 = self.mesh.data_range(x.shape[0])
            x, y = x[r0:r1], y[r0:r1]
        n = x.shape[0]
        lo, hi, covar = self._latents()
        mean_l, var_l = self._latent_distrib(x, False, lo, hi, covar)
        W = self.lmc_coeffs[lo:hi]                              # (q, T)
        Sigma_t = self.likelihood.task_covariance()
        Rt = safe_cholesky(Sigma_t)
        T = Sigma_t.shape[-1]
        # trace term: Σ_n Σ_b var_b(x_n) (W Σt⁻¹ Wᵀ)_bb
        wsw = (W.T * cho_solve(Rt, W.T)).sum(0)                 # (q,)
        mix, trace = mean_l.T @ W, (var_l * wsw[:, None]).sum()
        kl = self._kl(lo, hi, covar)
        if self.mesh is not None:
            packed = self.mesh.latent_sum(torch.cat(
                [mix.reshape(-1), trace[None], kl[None]]))
            mix, trace, kl = packed[:-2].reshape(mix.shape), packed[-2], \
                packed[-1]
        delta = y - (mix + self.output_mean_module(x).T)        # (n, T)
        z = solve_triangular(Rt, delta.T, lower=True)           # (T, n)
        exp_ll = -0.5 * ((z * z).sum() + trace
                         + n * (logdet_from_chol(Rt)
                                + T * math.log(2 * math.pi)))
        if self.mesh is not None:
            exp_ll = self.mesh.data_sum(exp_ll)
        return (exp_ll - kl + self.covar_module.prior_log_prob()) / num_data

    # -- introspection ---------------------------------------------------------------
    def lscales(self, unpacked: bool = True):
        """Learned lengthscales, (q, dims), as a numpy array (a list of one
        when not ``unpacked``)."""
        scales = np.squeeze(self.covar_module.lengthscale.detach().cpu()
                            .numpy())
        return scales if unpacked else [scales]

    def outputscale(self, unpacked: bool = False):
        """Learned outputscales, (q, 1) (ones without a ScaleKernel), as a
        numpy array; squeezed when ``unpacked``."""
        cm = self.covar_module
        if hasattr(cm, "outputscale"):
            res = cm.outputscale.detach().cpu().numpy()[:, None]
        else:
            res = np.ones((self.n_latents, 1))
        return res.squeeze() if unpacked else res
