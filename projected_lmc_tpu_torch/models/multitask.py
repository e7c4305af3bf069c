"""Exact multitask GP, LMC coregionalization (port of the LMC part of
``projected_lmc_tpu/models/multitask.py``).

Σ = Σ_b K_b ⊗ h_b h_bᵀ + I ⊗ Σt with one stationary kernel per latent and
rank-1 task factors h_b (``covar_factor``, SVD-initialized from the labels).
The marginal likelihood is, up to q·n = ``DENSE_QN_MAX``, the dense Woodbury
one of ``ops/woodbury.py`` (K3, batched Cholesky), and above it the fused op
of ``ops/fused_mll.py``: stack build (kernel K1; K8 for an int8 stack, K6
under ``PLMC_SYM_BUILD=0``), Nyström-preconditioned CG with Lanczos
quadrature, and a backward through kernel K2 (or K4/K5/K7, the routes of
``ops/fused_mll``); the preconditioner's landmark blocks are kernel K3.

The posterior factorizes once (``precompute_posterior``, a plain dict):
the dense Woodbury factors ("lmc"), or above ``DENSE_QN_MAX`` a PCG solve
on the K3 stack with a conservative variance through Nyström factors
inflated by the residual's spectral bound ("lmc_iter").
"""

from __future__ import annotations

import numpy as np
import torch

from ..constraints import softplus
from ..distributions import MultitaskMultivariateNormal, SumKronRank1Cov
from ..kernels import KERNEL_REGISTRY, ScaleKernel, handle_covar
from ..likelihoods import MultitaskGaussianLikelihood
from ..means import MEAN_REGISTRY
from ..module import Module
from ..ops import fused_mll
from ..ops import iterative as it_ops
from ..ops import woodbury as wb_ops
from ..ops.cholesky import cho_solve, safe_cholesky, solve_triangular
from ..ops.init_ops import init_lmc_coefficients
from ..utils.device import resolve_device
from .exact import _as_inputs, _canon_targets, _resolve


def _fused_stationary_spec(cov, dim):
    """(kind, lengthscale (q, 1, d), outputscale (q,)) when ``cov`` is a bare
    or Scale-wrapped stationary kernel over all ``dim`` features — what the
    fused MLL builds internally; None otherwise."""
    base, os_ = cov, None
    if isinstance(cov, ScaleKernel):
        base, os_ = cov.base_kernel, cov.outputscale
    kind = getattr(base, "_kind", None)
    full_slice = (base.active_dims is None
                  or tuple(base.active_dims) == tuple(range(int(dim))))
    if kind is None or not full_slice:
        return None
    if os_ is None:
        os_ = torch.ones((base.batch,), dtype=base.lengthscale.dtype,
                         device=base.device)
    return kind, base.lengthscale, os_


class MultitaskGPModel(Module):
    """Exact LMC multitask GP (projected_lmc.py:438-656), fused iterative MLL.

    ``device`` defaults to ``"cuda"``; pass ``device="cpu"`` for the plain
    PyTorch versions of the kernels. Parameters keep the JAX package's raw
    leaves and names, so ``utils.checkpoint.load_jax_state`` carries a JAX
    model's state over."""

    DENSE_QN_MAX = 4096

    def __init__(self, train_x, train_y, likelihood=None, n_tasks=None,
                 n_latents: int = 1, model_type: str = "ICM",
                 init_lmc_coeffs: bool = True, fix_diagonal: bool = False,
                 mean_type="constant", kernel_type="rbf", decomp=None,
                 prior_scales=None, prior_width=None, ker_kwargs=None,
                 n_inducing_points=None, seed: int = 0, device="cuda",
                 **kwargs):
        super().__init__()
        if model_type not in ("ICM", "LMC"):
            raise ValueError("Wrong specified model type, should be ICM or LMC")
        if model_type == "ICM":
            raise NotImplementedError("the ICM model is ported with slice 4")
        if n_inducing_points is not None:
            raise NotImplementedError("the SGPR path (n_inducing_points) is "
                                      "ported with slice 5")
        dev = resolve_device(device)
        x_host = np.asarray(train_x)
        y_host = np.asarray(train_y, x_host.dtype)
        x = torch.as_tensor(x_host, device=dev)
        if x.dim() == 1:
            x = x[:, None]
        dtype = x.dtype
        y = torch.as_tensor(y_host, dtype=dtype, device=dev)
        if n_tasks is None:
            n_tasks = y.shape[-1]
        self.register_buffer("train_x", x)
        self.register_buffer("train_y", _canon_targets(y, n_tasks).contiguous())
        if likelihood is None:
            likelihood = MultitaskGaussianLikelihood(
                num_tasks=n_tasks, rank=0, seed=seed, dtype=dtype, device=dev)
        self.likelihood = likelihood
        self.n_tasks, self.n_latents = int(n_tasks), int(n_latents)
        self.model_type = model_type
        self.dim = int(x.shape[1])

        mean_cls = _resolve(MEAN_REGISTRY, mean_type, "constant", "mean")
        self.mean_module = mean_cls(input_size=self.dim, batch_shape=n_tasks,
                                    dtype=dtype, device=dev)
        self.covar_module = handle_covar(
            _resolve(KERNEL_REGISTRY, kernel_type, "rbf", "kernel"),
            dim=self.dim, decomp=decomp, prior_scales=prior_scales,
            prior_width=prior_width, outputscales=False, n_funcs=n_latents,
            ker_kwargs=ker_kwargs, dtype=dtype, device=dev)

        rng = np.random.default_rng(seed)
        if init_lmc_coeffs:
            yh = y_host
            if yh.ndim == 1:
                yh = yh[:, None]
            elif yh.shape[0] == n_tasks and yh.shape[1] != n_tasks:
                yh = yh.T                                       # (n, T)
            factor = np.asarray(init_lmc_coefficients(yh, n_latents)).T
        else:
            factor = rng.standard_normal((n_tasks, n_latents))
        # q rank-1 coregionalizations, each with its own kernel copy
        self.register_raw("covar_factor", factor.T[..., None], dtype, dev)
        # diagonal of the task covariances; fix_diagonal freezes it at −10
        shape = (n_latents, n_tasks)
        if fix_diagonal:
            self._frozen_params_ = ("raw_var",)
            self.register_raw("raw_var", np.full(shape, -10.0), dtype, dev)
        else:
            self.register_raw("raw_var", rng.standard_normal(shape), dtype, dev)

    @property
    def device(self):
        return self.train_x.device

    def task_covar_matrix(self):
        """Per-latent rank-1 B_b = h_b h_bᵀ + diag(softplus(raw_var_b)),
        (q, T, T)."""
        F = self.covar_factor
        return F @ F.transpose(-1, -2) + torch.diag_embed(
            softplus(self.raw_var))

    def lmc_coefficients(self):
        """(q, T) mixing coefficients, as a numpy array."""
        return self.covar_factor[..., 0].detach().cpu().numpy()

    def _mixing(self):
        """H (T, q) and the LMC's task noise Σt + Σ_b diag(softplus(raw_var_b))."""
        return (self.covar_factor[..., 0].T,
                self.likelihood.task_covariance()
                + torch.diag(self._lmc_extra_diag()))

    def _train_delta(self):
        """Y − m(x), (n, T), at the training inputs."""
        return self.train_y.T - self.mean_module(self.train_x).T

    def forward(self, x):
        """Prior multitask distribution at x: mean (n, T), covariance
        Σ_b K_b ⊗ h_b h_bᵀ."""
        x = _as_inputs(x, self.train_x)
        return MultitaskMultivariateNormal(
            self.mean_module(x).T,
            SumKronRank1Cov(self.covar_module(x), self.covar_factor[..., 0].T))

    def _lmc_extra_diag(self):
        """Σ_b diag(softplus(raw_var_b)): the per-task variance capacity,
        carried as a white task-covariance term (see the JAX model)."""
        return softplus(self.raw_var).sum(0)

    def _precond_roots(self, x, rank: int, jitter: float = 1e-4):
        """Nyström roots of the latent kernels at strided landmarks,
        (q, n, rank) (ops.iterative.nystrom_roots_from_covar)."""
        return it_ops.nystrom_roots_from_covar(self.covar_module, x, rank,
                                               jitter)

    def mll(self, x=None, y=None, iterative: bool = None, num_probes: int = 10,
            max_cg_iters: int = 256, cg_tol: float = 1e-2,
            matvec_bf16: bool = False, precond_rank: int = 0,
            quad_method: str = "pcg", precond_roots=None,
            matvec_int8: bool = False, eps=None, xi=None, generator=None):
        """Exact multitask MLL / (n·T), plus hyper-prior terms: the dense
        Woodbury log-density up to q·n = ``DENSE_QN_MAX`` (or with
        ``iterative=False``), above it the fused PCG estimator
        (``precond_rank > 0``, ``quad_method="pcg"``).

        eps (num_probes, n, T) and xi (num_probes, q, rank) are the standard
        normals of the probes; when not given they are drawn from
        ``generator`` (a fresh ``torch.Generator`` seeded 0 when None, as the
        JAX model draws from ``PRNGKey(0)`` without a key).
        ``precond_roots`` (q, n, rank): caller-supplied, possibly stale,
        Nyström roots; the estimator is exact for any SPD preconditioner.
        ``matvec_int8`` (over ``matvec_bf16``): the int8 stack (kernel K8)
        and int8 × int8 → int32 stack products (``ops/fused_mll``)."""
        x = self.train_x if x is None else x
        y = self.train_y if y is None else _canon_targets(
            torch.as_tensor(y, dtype=x.dtype, device=x.device), self.n_tasks)
        n = x.shape[0]
        Ydelta = y.T - self.mean_module(x).T                    # (n, T)
        H, St = self._mixing()
        if iterative is None:
            iterative = self.n_latents * n > self.DENSE_QN_MAX
        if not iterative:
            ll = wb_ops.lmc_log_prob(self.covar_module(x), H, St, Ydelta)
            return (ll + self.covar_module.prior_log_prob()) \
                / (n * self.n_tasks)
        if precond_rank <= 0 or quad_method != "pcg":
            raise NotImplementedError(
                "the unpreconditioned SLQ route (precond_rank <= 0 or "
                "quad_method='slq') is ported with slice 6; pass "
                "precond_rank > 0")
        spec = _fused_stationary_spec(self.covar_module, self.dim)
        if spec is None:
            raise NotImplementedError("the composed kernel→log-prob route is "
                                      "ported in a later slice")
        kind, ls, os_ = spec
        if eps is None or xi is None:
            if generator is None:
                generator = torch.Generator(device=x.device).manual_seed(0)
            draw = dict(generator=generator, dtype=Ydelta.dtype,
                        device=x.device)
            eps = torch.randn((num_probes, n, self.n_tasks), **draw)
            xi = torch.randn((num_probes, self.n_latents,
                              min(precond_rank, n)), **draw)
        if precond_roots is None:
            with torch.no_grad():
                precond_roots = self._precond_roots(x, precond_rank)
        ll = fused_mll.lmc_pcg_log_prob_stationary(
            x, ls, os_, H, St, Ydelta, eps, xi, precond_roots, kind,
            max_cg_iters, cg_tol, matvec_bf16, precond_rank, matvec_int8,
            device=x.device)
        return (ll + self.covar_module.prior_log_prob()) / (n * self.n_tasks)

    # -- posterior ---------------------------------------------------------------
    def precompute_posterior(self, iterative: bool = None,
                             max_cg_iters: int = 400, cg_tol: float = 1e-5,
                             precond_rank: int = 256, v0=None,
                             generator=None):
        """Factorize the training system once, a dict for :meth:`posterior`.

        Up to q·n = ``DENSE_QN_MAX`` (or with ``iterative=False``) the dense
        Woodbury factors ("lmc"). Above it ("lmc_iter"): the mean from a
        tight PCG solve on the materialized (q, n, n) stack (kernel K3),
        Nyström-preconditioned at ``precond_rank``, and a conservative
        variance through M_up = Σ_b Q_b ⊗ h_bh_bᵀ + I ⊗ (Σt + c·I) ⪰ Σ,
        c the residual's λmax from power iteration started at ``v0``
        (n, T), or at a draw from ``generator``."""
        x = self.train_x
        n = x.shape[0]
        Ydelta = self._train_delta()
        H, St = self._mixing()
        if iterative is None:
            iterative = self.n_latents * n > self.DENSE_QN_MAX
        Ks = self.covar_module(x)
        if not iterative:
            fac = wb_ops.lmc_factors(Ks, H, St)
            return dict(kind="lmc", fac=fac, alpha=wb_ops.lmc_solve(Ydelta, fac),
                        H=H, Sigma_t=St)
        roots = self._precond_roots(x, precond_rank)
        minv = it_ops.nystrom_precond(Ks, H, St, precond_rank, roots=roots)
        Md = torch.clamp(it_ops._jacobi_diag(Ks, H, St), min=1e-10)
        alpha = it_ops.batched_pcg(
            lambda V: it_ops.lmc_matvec(Ks, H, St, V), Ydelta[None], Md,
            max_iters=max_cg_iters, tol=cg_tol, minv=minv)[0]
        c = it_ops.residual_spectral_bound(Ks, roots, H, v0=v0,
                                           generator=generator)
        eye = torch.eye(self.n_tasks, dtype=St.dtype, device=St.device)
        fac_up = wb_ops.lmc_factors_from_roots(roots, H, St + c * eye)
        return dict(kind="lmc_iter", alpha=alpha, H=H, Sigma_t=St, fac=fac_up)

    def posterior(self, x_star, cache=None, observed: bool = True):
        """Posterior mean and variance diagonal (n*, T) at x_star, with the
        observation noise when ``observed``. The (q, n*, n) cross-covariance
        is kernel K3 on the card; the prior and noise use the true Σt, the
        "lmc_iter" correction the inflated factors."""
        if cache is None:
            cache = self.precompute_posterior()
        x_star = _as_inputs(x_star, self.train_x)
        Kstars = self.covar_module(x_star, self.train_x)        # (q, n*, n)
        mean = wb_ops.lmc_posterior_mean(Kstars, cache["H"], cache["alpha"],
                                         self.mean_module(x_star).T)
        var = wb_ops.lmc_posterior_variance(
            Kstars, self.covar_module(x_star, diag=True), cache["H"],
            cache["Sigma_t"], cache["fac"], noise=observed)
        return _MeanVarMT(mean, var)

    def compute_var(self, x_star):
        """The ICM's memory-safe posterior variance; not defined for LMC."""
        raise ValueError("This method is only available for ICM models")

    def _dense_cov(self):
        H, St = self._mixing()
        return SumKronRank1Cov(self.covar_module(self.train_x), H, St).dense()

    def compute_loo(self):
        """Multitask LOO on the dense (n·T)² system: (σ², y − μ), both
        (n, T), detached."""
        n = self.train_x.shape[0]
        dense = self._dense_cov()
        L = safe_cholesky(dense)
        eye = torch.eye(dense.shape[-1], dtype=dense.dtype,
                        device=dense.device)
        Linv = solve_triangular(L, eye, lower=True)
        sigma2 = 1.0 / (Linv * Linv).sum(0)
        alpha = cho_solve(L, self._train_delta().reshape(-1, 1))[:, 0]
        return (sigma2.reshape(n, self.n_tasks).detach(),
                (alpha * sigma2).reshape(n, self.n_tasks).detach())

    def kernel_cond(self):
        """Condition number of the dense (n·T, n·T) training covariance with
        its noise."""
        return torch.linalg.cond(self._dense_cov())


class _MeanVarMT:
    """A multitask prediction: mean and variance diagonals, (n*, T)."""

    def __init__(self, mean, var):
        self.mean = mean
        self._var = var

    @property
    def variance(self):
        return self._var

    @property
    def stddev(self):
        return torch.sqrt(self._var)

    def confidence_region(self, k: float = 2.0):
        s = self.stddev
        return self.mean - k * s, self.mean + k * s
