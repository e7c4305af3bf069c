"""Exact GP regression, batched over independent tasks (port of the
marginal-likelihood part of ``projected_lmc_tpu/models/exact.py``).

``n_tasks`` independent single-output GPs, evaluated as one batched
Cholesky, or, above the dense ceiling (T·n² > ``ITER_TN2_MAX``), through
the fused iterative MLL of ``ops/fused_mll.py``: the batch IS the LMC
Σ_b K_b ⊗ e_b e_bᵀ + I ⊗ diag(σ²) with identity mixing. The posterior
factorizes the training system once (``precompute_posterior``, a plain
dict) for any number of ``posterior`` calls; ``compute_loo`` gives the exact
leave-one-out residuals; ``lscales``/``outputscale`` read the learned
hyperparameters.

With ``n_inducing_points`` the model takes the Titsias SGPR route: m
trainable inducing points z, the low-rank roots R = K_xz L_zz⁻ᵀ (kernel K3
for K(z, z) and K(x, z) on the card), an MLL that is the Titsias bound with
its −tr(K − Q)/2σ² term, and posteriors through the (m, m) capacitance
R ᵀR + σ²I, whose variance adds the gap k(x*, x*) − diag(R* R*ᵀ)
(``sgpr_titsias_var``).

Under a mesh (``parallel.shard_model``) a rank computes its latents' share
of the task batch (``module.latent_slice``) and the group sums, by
``parallel.sharded``'s rule: the dense route factorizes only the rank's
(T/L, n, n) block (the ranks of one data group hold replicas of it, since
the n×n factorization is not split by rows), and the SGPR route builds its
rows' K_xz, (T/L, n/D, m), and sums RᵀR, Rᵀδ, δᵀδ and the trace gap over
the data group before the m×m Cholesky. The iterative route is the fused
op with H = I, the T functions its latents: the rank builds its functions'
rows over the data axis (K6) and runs the row-sharded PCG
(``ops/fused_mll``); its composed route (a kernel the fused op does not
take) takes the rank's block of the covariance module's stack (K3
``rows=``, its functions restricted by ``module.latent_slice``) into the
row-sharded PCG of ``iterative.lmc_pcg_log_prob``, as
``MultitaskGPModel``'s composed route does. ``log_marginal``, ``mll``
and ``compute_loo`` return the whole batch on every rank; the cache of
``precompute_posterior`` and ``posterior`` hold the rank's latents.
"""

from __future__ import annotations

import copy
import math
import warnings

import numpy as np
import torch

from ..distributions import MultivariateNormal, MultitaskMultivariateNormal
from ..kernels import KERNEL_REGISTRY, AdditiveKernel, handle_covar
from ..likelihoods import GaussianLikelihood
from ..means import MEAN_REGISTRY
from ..module import Module, latent_slice
from ..ops import fused_mll
from ..ops import iterative as it_ops
from ..ops.cholesky import (cho_solve, chol_inverse_diag,
                            gaussian_log_density, logdet_from_chol,
                            safe_cholesky, solve_triangular)
from ..utils.device import resolve_device
from ..utils.profiling import span


def _canon_targets(y, n_tasks, orientation: str = "auto"):
    """(n,), (n, T) or (T, n) targets as (T, n).

    ``orientation`` resolves the square case (n == n_tasks): "tn" asserts
    (T, n), "nt" asserts (n, T), and "auto" infers by shape and takes a
    square input as (n, T), the user-facing convention."""
    if y.dim() == 1:
        if n_tasks != 1:
            raise ValueError("1-d targets require n_tasks == 1")
        return y[None, :]
    if orientation == "tn":
        if y.shape[0] != n_tasks:
            raise ValueError(f"expected (T={n_tasks}, n) targets, got "
                             f"{tuple(y.shape)}")
        return y
    if orientation == "nt":
        if y.shape[1] != n_tasks:
            raise ValueError(f"expected (n, T={n_tasks}) targets, got "
                             f"{tuple(y.shape)}")
        return y.T
    if y.shape[0] == n_tasks and y.shape[1] != n_tasks:
        return y
    return y.T


def _np(t):
    """A tensor as a squeezed numpy array."""
    return np.squeeze(t.detach().cpu().numpy())


def _as_inputs(x, ref):
    """``x`` (n, d), or 1-D for one feature, as a tensor in ``ref``'s dtype
    on its device."""
    x = torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    return x[:, None] if x.dim() == 1 else x


def _resolve(registry, spec, default):
    """The class ``spec`` names in ``registry`` (``default`` for None), or
    ``spec`` itself when it is not a name."""
    spec = default if spec is None else spec
    return registry[spec] if isinstance(spec, str) else spec


def inducing_factor(covar_module, z, agree=None):
    """L_zz, the lower factor of K_zz + 1e-6 I, (k, m, m) (K3 on the
    card); ``agree`` as in ``ops.cholesky.safe_cholesky``."""
    Kzz = covar_module(z)
    return safe_cholesky(Kzz + 1e-6 * torch.eye(
        Kzz.shape[-1], dtype=Kzz.dtype, device=Kzz.device), agree=agree)


def nystrom_roots(covar_module, z, x, agree=None, rows=None):
    """R = K_xz L_zz⁻ᵀ, (k, n, m): the Nyström factors of gpytorch's
    InducingPointKernel at inducing points z, one set per kernel of the
    batch; K(z, z) and K(x, z) are kernel K3 on the card. ``rows`` =
    (r0, r1): the roots of x's rows r0..r1 − 1 alone (K3's rows)."""
    Lzz = inducing_factor(covar_module, z, agree)
    kw = {} if rows is None else dict(rows=rows)
    return solve_triangular(Lzz, covar_module(x, z, **kw).transpose(-1, -2),
                            lower=True).transpose(-1, -2)


class ExactGPModel(Module):
    """Exact GP (projected_lmc.py:264-436); batch dimension = independent
    tasks. ``device`` defaults to ``"cuda"``; ``device="cpu"`` runs the
    kernels' plain versions. Parameters keep the JAX package's raw leaves
    and names (``utils.checkpoint.load_jax_state``). ``n_inducing_points``
    selects the SGPR route, its inducing points drawn from
    ``default_rng(seed)``; ``sgpr_titsias_var=False`` drops the variance's
    low-rank gap (the reference's subset-of-regressors variance)."""

    # dense batched-Cholesky ceiling of the auto-routing: T·n² elements
    ITER_TN2_MAX = 2 ** 30
    # under a mesh, the latent group's vote on each rung of the ladder
    _agree = None

    def __init__(self, train_x, train_y, likelihood, n_tasks: int = 1,
                 prior_scales=None, prior_width=None, mean_type="constant",
                 decomp=None, outputscales: bool = False, kernel_type="rbf",
                 ker_kwargs=None, n_inducing_points=None, seed: int = 0,
                 sgpr_titsias_var: bool = True, device="cuda", **kwargs):
        super().__init__()
        dev = resolve_device(device)
        x = torch.as_tensor(np.asarray(train_x), device=dev)
        if x.dim() == 1:
            x = x[:, None]
        dtype = x.dtype
        y = torch.as_tensor(np.asarray(train_y), dtype=dtype, device=dev)
        self.register_buffer("train_x", x)
        self.register_buffer("train_y", _canon_targets(y, n_tasks).contiguous())
        self.likelihood = likelihood
        self.n_tasks = int(n_tasks)
        self.n_funcs = int(n_tasks)
        self.dim = int(x.shape[1])
        mean_cls = _resolve(MEAN_REGISTRY, mean_type, "constant")
        self.mean_module = mean_cls(input_size=self.dim, batch_shape=n_tasks,
                                    dtype=dtype, seed=seed, device=dev)
        self.covar_module = handle_covar(
            _resolve(KERNEL_REGISTRY, kernel_type, "rbf"),
            dim=self.dim, decomp=decomp, prior_scales=prior_scales,
            prior_width=prior_width, outputscales=outputscales,
            n_funcs=n_tasks, ker_kwargs=ker_kwargs, dtype=dtype, device=dev)
        if n_inducing_points is not None:
            rng = np.random.default_rng(seed)
            self.register_raw("inducing_points", rng.standard_normal(
                (int(n_inducing_points), self.dim)), dtype, dev)
        else:
            self.inducing_points = None
        self.sgpr_titsias_var = bool(sgpr_titsias_var)
        self.mesh = None

    @property
    def device(self):
        return self.train_x.device

    def _latent_part(self):
        """(view, lo, hi): under the mesh, this model restricted to its
        rank's latents lo..hi − 1 (the covariance, likelihood and mean
        modules sliced by ``module.latent_slice``), with no mesh of its own
        and its Cholesky ladders climbing with the latent group's."""
        q = self.n_funcs
        lo, hi = self.mesh.latent_range(q)
        view = copy.copy(self)
        view._modules = dict(self._modules)
        for name in ("covar_module", "likelihood", "mean_module"):
            view._modules[name] = latent_slice(self._modules[name], lo, hi, q)
        view.n_funcs = hi - lo
        view.mesh = None
        view._agree = self.mesh.latent_any
        return view, lo, hi

    @property
    def sgpr(self) -> bool:
        return self.inducing_points is not None

    def _targets(self, targets, orientation):
        if targets is None:
            return self.train_y
        return _canon_targets(torch.as_tensor(
            targets, dtype=self.train_x.dtype, device=self.device),
            self.n_funcs, orientation)

    def prior(self, x) -> MultivariateNormal:
        """Prior p(f(x)): batched MVN with mean (T, n), covariance
        (T, n, n); on the SGPR route the Nyström Q = K_xz K_zz⁻¹ K_zx, as
        gpytorch's InducingPointKernel."""
        x = _as_inputs(x, self.train_x)
        if self.sgpr:
            R = self._low_rank_root(x)
            return MultivariateNormal(self.mean_module(x),
                                      R @ R.transpose(-1, -2))
        return MultivariateNormal(self.mean_module(x), self.covar_module(x))

    def forward(self, x):
        """Train-mode forward (the prior), multitask-wrapped when the
        likelihood is not a batched Gaussian."""
        mvn = self.prior(x)
        if self.n_funcs > 1 and not isinstance(self.likelihood,
                                               GaussianLikelihood):
            return MultitaskMultivariateNormal.from_batch_mvn(mvn)
        return mvn

    def _train_covar(self):
        """K + σ²I at the training inputs, (T, n, n)."""
        return self.likelihood.add_to_covar(self.covar_module(self.train_x))

    def _low_rank_root(self, x):
        """R = K_xz L_zz⁻ᵀ, (T, n, m)."""
        return nystrom_roots(self.covar_module, self.inducing_points, x,
                             self._agree)

    def _sgpr_capacitance(self, gram):
        """The lower factor of RᵀR + σ²I, (T, m, m), from the Gram RᵀR."""
        s2 = self.likelihood.noise[..., 0][:, None, None]
        eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
        return safe_cholesky(gram + s2 * eye, agree=self._agree)

    def _sgpr_sums(self, x, delta, reduce=None, gap: bool = True):
        """RᵀR (T, m, m), Rᵀδ (T, m, 1), δᵀδ (T,) and, with ``gap``, the
        trace gap Σᵢ max(k_ii − ‖rᵢ‖², 0) (T,) over the rows of x; with
        ``reduce`` (a mesh's ``data_sum``) summed over the data group in one
        call."""
        R = self._low_rank_root(x)                               # (T, n, m)
        Rt = R.transpose(-1, -2)
        sums = [Rt @ R, Rt @ delta[..., None], (delta * delta).sum(-1)]
        if gap:
            sums.append(torch.clamp(self.covar_module(x, diag=True)
                                    - (R * R).sum(-1), min=0.0).sum(-1))
        if reduce is None:
            return sums
        T = R.shape[0]
        packed = reduce(torch.cat([t.reshape(T, -1) for t in sums], 1))
        parts = packed.split([t[0].numel() for t in sums], 1)
        return [p.reshape(t.shape) for p, t in zip(parts, sums)]

    def _sgpr_log_prob(self, x, delta, reduce=None, n: int = None):
        """Titsias bound per task: log N(y; m, Q + σ²I) − tr(K − Q)/(2σ²),
        (T,). Under a mesh x and δ are the rank's rows, ``reduce`` sums the
        Gram and row sums over the data group, and n is the global n."""
        n = x.shape[0] if n is None else n
        gram, Rty, dd, gap = self._sgpr_sums(x, delta, reduce)
        m = gram.shape[-1]
        Lc = self._sgpr_capacitance(gram)
        w = solve_triangular(Lc, Rty, lower=True)[..., 0]
        s2 = self.likelihood.noise[..., 0]                       # (T,)
        quad = (dd - (w * w).sum(-1)) / s2
        logdet = (n - m) * torch.log(s2) + logdet_from_chol(Lc)
        trace_term = gap / (2 * s2)
        return -0.5 * (quad + logdet + n * math.log(2 * math.pi)) - trace_term

    def log_marginal(self, y=None, x=None, orientation: str = "auto"):
        """Per-task log N(y_t; m_t, K_t + σ_t² I), shape (T,), by a batched
        Cholesky with the log-density's closed-form gradient
        (``ops.cholesky.gaussian_log_density``); on the SGPR route the
        Titsias bound with its −tr(K − Q)/2σ² term."""
        x = self.train_x if x is None else x
        y = self.train_y if y is None else _canon_targets(
            torch.as_tensor(y, dtype=x.dtype, device=x.device), self.n_funcs,
            orientation)
        if self.mesh is not None:
            return self._sharded_log_marginal(x, y)
        delta = y - self.mean_module(x)
        if self.sgpr:
            return self._sgpr_log_prob(x, delta)
        return gaussian_log_density(
            self.likelihood.add_to_covar(self.covar_module(x)), delta,
            agree=self._agree)

    def _sharded_log_marginal(self, x, y):
        """``log_marginal`` under the mesh: this rank's latents (and, on the
        SGPR route, its rows), the whole (T,) gathered over the latent
        group."""
        view, lo, hi = self._latent_part()
        if self.sgpr:
            n = x.shape[0]
            r0, r1 = self.mesh.data_range(n)
            delta = self.mesh.block(y, (slice(lo, hi), slice(r0, r1))) \
                - view.mean_module(x[r0:r1])
            ll = view._sgpr_log_prob(x[r0:r1], delta, self.mesh.data_sum, n)
        else:
            ll = view.log_marginal(y=self.mesh.block(y, slice(lo, hi)), x=x,
                                   orientation="tn")
        return self.mesh.gather_latents(ll, lo, hi, self.n_funcs)

    def mll(self, x=None, y=None, iterative: bool = None,
            num_probes: int = 10, max_cg_iters: int = 256,
            cg_tol: float = 1e-2, matvec_bf16: bool = False,
            precond_rank: int = 256, eps=None, xi=None, generator=None):
        """Exact MLL summed over the task batch, plus hyper-prior terms, over
        n (gpytorch ExactMarginalLogLikelihood).

        Above the dense ceiling (T·n² > ``ITER_TN2_MAX``, with a warning) or
        with ``iterative=True`` it is the Nyström-preconditioned PCG
        estimator with identity mixing: fused for one stationary kernel over
        all the features, else on the kernels' materialized stack (the
        composed route, ``iterative.lmc_pcg_log_prob``). eps (num_probes, n, T) and xi
        (num_probes, T, rank) are its standard normals; when not given they
        are drawn from ``generator`` (a fresh one seeded 0 when None, as the
        JAX model draws from ``PRNGKey(0)`` without a key). The roots are
        rebuilt at every call. ``precond_rank <= 0`` means min(256, n).
        On the SGPR route the MLL is the Titsias bound, never iterative:
        ``iterative=True`` raises."""
        x_ = self.train_x if x is None else x
        n = x_.shape[0]
        if iterative and self.sgpr:
            raise ValueError(
                "iterative=True is not available on an SGPR model: the "
                "Titsias bound is already matrix-free in n (its dense work "
                "is m×m), and the CG/probe kwargs would be silently "
                "ignored. Drop iterative/num_probes/max_cg_iters/... or "
                "build the model without n_inducing_points.")
        if iterative is None:
            iterative = (not self.sgpr
                         and self.n_funcs * n * n > self.ITER_TN2_MAX)
            if iterative and self.mesh is None:
                warnings.warn(
                    "ExactGPModel.mll: T·n² exceeds the dense-Cholesky "
                    "ceiling — auto-routing to the matrix-free PCG/SLQ "
                    "estimator. The MLL becomes stochastic: pass a "
                    "`generator` whose state advances from step to step "
                    "(without one the probes are drawn from a generator "
                    "seeded 0, a fixed-realization objective); pass "
                    "iterative=False to force the dense path.", stacklevel=2)
        if not iterative:
            ll = self.log_marginal(y=y, x=x)
            return (ll.sum() + self.covar_module.prior_log_prob()) / n
        from .multitask import _fused_stationary_spec
        y_ = self.train_y if y is None else _canon_targets(
            torch.as_tensor(y, dtype=x_.dtype, device=x_.device), self.n_funcs)
        Ydelta = (y_ - self.mean_module(x_)).T                  # (n, T)
        T = self.n_funcs
        H = torch.eye(T, dtype=x_.dtype, device=x_.device)
        St = torch.diag(self.likelihood.noise[..., 0])
        if precond_rank <= 0:
            precond_rank = min(256, n)
        spec = _fused_stationary_spec(self.covar_module, self.dim)
        rows = None if self.mesh is None else self.mesh.row_block(n, T)
        with torch.no_grad():
            roots = self._precond_roots(x_, precond_rank, rows=rows)
        m_rank = int(roots.shape[-1])
        if eps is None or xi is None:
            if generator is None:
                generator = torch.Generator(device=x_.device).manual_seed(0)
            draw = dict(generator=generator, dtype=Ydelta.dtype,
                        device=x_.device)
            eps = torch.randn((num_probes, n, T), **draw)
            xi = torch.randn((num_probes, T, m_rank), **draw)
        if spec is None:
            # the composed route: the task kernels' materialized stack, or
            # under the mesh the rank's block of it (its functions' rows)
            Ks = self._block(
                x_, rows, out_dtype=torch.bfloat16 if matvec_bf16 else None)
            ll = it_ops.lmc_pcg_log_prob(Ks, H, St, Ydelta, eps, xi, roots,
                                         max_cg_iters, cg_tol, matvec_bf16,
                                         m_rank, rows=rows)
        else:
            kind, ls, os_ = spec
            ll = fused_mll.lmc_pcg_log_prob_stationary(
                x_, ls, os_, H, St, Ydelta, eps, xi, roots, kind,
                max_cg_iters, cg_tol, matvec_bf16, m_rank, device=x_.device,
                rows=rows)
        return (ll + self.covar_module.prior_log_prob()) / n

    def lscales(self, unpacked: bool = True):
        """Learned lengthscales, (n_funcs, dims), as a numpy array (a list of
        one when not ``unpacked``); for an additive kernel, a list with one
        array per group."""
        cm = self.covar_module
        if isinstance(cm, AdditiveKernel):
            return [_np(k.lengthscale) for k in cm.kernels]
        scales = _np(cm.lengthscale)
        return scales if unpacked else [scales]

    def outputscale(self, unpacked: bool = False):
        """Learned outputscales, (n_funcs, n_kernels) (ones without a
        ScaleKernel), as a numpy array; squeezed when ``unpacked`` (an
        additive kernel's, one column per group, never)."""
        cm = self.covar_module
        if isinstance(cm, AdditiveKernel):
            return np.stack([_np(k.outputscale) for k in cm.kernels], axis=1)
        if hasattr(cm, "outputscale"):
            res = cm.outputscale.detach().cpu().numpy()[:, None]
        else:
            res = np.ones((self.n_funcs, 1))
        return res.squeeze() if unpacked else res

    def kernel_cond(self):
        """Condition number of the training covariance with its noise,
        (T,)."""
        return torch.linalg.cond(self._train_covar())

    # -- posterior -------------------------------------------------------------
    def precompute_posterior(self, targets=None, orientation: str = "auto"):
        """Factorize the training system once: dict(kind="exact", L, alpha)
        for :meth:`posterior`, or on the SGPR route dict(kind="sgpr", Lc,
        beta, noise) with Lc the capacitance's factor and β = (RᵀR +
        σ²I)⁻¹Rᵀ(y − m), (T, m). ``targets`` re-targets the model (the
        projected data of ``ProjectedGPModel``). Under a mesh the cache
        holds the rank's latents lo..hi − 1, ``latents=(lo, hi)``, the
        SGPR route's sums taken over the data group."""
        y = self._targets(targets, orientation)
        if self.mesh is not None:
            view, lo, hi = self._latent_part()
            if self.sgpr:
                x = self.train_x
                r0, r1 = self.mesh.data_range(x.shape[0])
                delta = y[lo:hi, r0:r1] - view.mean_module(x[r0:r1])
                cache = view._sgpr_cache(x[r0:r1], delta, self.mesh.data_sum)
            else:
                cache = view.precompute_posterior(y[lo:hi], "tn")
            return dict(cache, latents=(lo, hi))
        delta = y - self.mean_module(self.train_x)
        if self.sgpr:
            return self._sgpr_cache(self.train_x, delta)
        L = safe_cholesky(self._train_covar(), agree=self._agree)
        alpha = cho_solve(L, delta[..., None])[..., 0]          # (T, n)
        return dict(kind="exact", L=L, alpha=alpha)

    def _sgpr_cache(self, x, delta, reduce=None):
        gram, Rty, _ = self._sgpr_sums(x, delta, reduce, gap=False)
        Lc = self._sgpr_capacitance(gram)
        beta = cho_solve(Lc, Rty)
        return dict(kind="sgpr", Lc=Lc, beta=beta[..., 0],
                    noise=self.likelihood.noise)

    def posterior(self, x_star, cache=None, full_cov: bool = True,
                  targets=None) -> MultivariateNormal:
        """Latent posterior p(f* | data), a batched MVN (T, n*): dense
        covariance with ``full_cov``, else its diagonal, clipped at 1e-12.
        The (T, n, n*) cross-covariance is kernel K3 on the card; on the
        SGPR route the (T, n*, m) K(x*, z) is. Under a mesh, the rank's
        latents (the cache's ``latents``)."""
        if cache is None:
            cache = self.precompute_posterior(targets)
        if self.mesh is not None:
            return self._latent_part()[0].posterior(x_star, cache, full_cov)
        x_star = _as_inputs(x_star, self.train_x)
        if cache["kind"] == "sgpr":
            return self._sgpr_posterior(x_star, cache, full_cov)
        Ks = self.covar_module(self.train_x, x_star)            # (T, n, n*)
        mean = self.mean_module(x_star) + torch.einsum(
            "tns,tn->ts", Ks, cache["alpha"])
        with span("predict.solve"):
            Vs = solve_triangular(cache["L"], Ks, lower=True)
        if full_cov:
            covar = self.covar_module(x_star) - Vs.transpose(-1, -2) @ Vs
            return MultivariateNormal(mean, covar)
        var = self.covar_module(x_star, diag=True) - (Vs * Vs).sum(-2)
        return _DiagMVN(mean, torch.clamp(var, min=1e-12))

    def _sgpr_posterior(self, x_star, cache, full_cov):
        """Titsias predictive: mean m(x*) + R*β, covariance σ²R* cap⁻¹ R*ᵀ
        plus the low-rank gap kss − diag(R* R*ᵀ), clipped at 0 like the
        bound's trace term (without it, ``sgpr_titsias_var=False``, the
        variance is the subset-of-regressors one, which collapses to 0 far
        from the inducing points)."""
        Rs = self._low_rank_root(x_star)                         # (T, n*, m)
        mean = self.mean_module(x_star) + (Rs @ cache["beta"][..., None])[
            ..., 0]
        V = solve_triangular(cache["Lc"], Rs.transpose(-1, -2), lower=True)
        if self.sgpr_titsias_var:
            gap = torch.clamp(self.covar_module(x_star, diag=True)
                              - (Rs * Rs).sum(-1), min=0.0)
        else:
            gap = torch.zeros(Rs.shape[:-1], dtype=Rs.dtype, device=Rs.device)
        s2 = cache["noise"][..., 0]
        if full_cov:
            return MultivariateNormal(
                mean, s2[:, None, None] * (V.transpose(-1, -2) @ V)
                + torch.diag_embed(gap))
        return _DiagMVN(mean, s2[:, None] * (V * V).sum(-2) + gap)

    def compute_loo(self, targets=None, complex_mean: bool = False,
                    orientation: str = "auto"):
        """Exact LOO variances and residuals by σᵢ² = 1/[K⁻¹]ᵢᵢ, both (n, T).
        Detached when the model has more than one output; a single output
        stays differentiable (``mlls.loo_pseudo_likelihood`` trains through
        it).

        ``complex_mean`` applies the universal-kriging correction
        K⁻ = K⁻¹ − K⁻¹H(HᵀK⁻¹H)⁻¹HᵀK⁻¹ with H the mean's basis matrix
        (projected_lmc.py:417-430; HᵀK⁻¹H factored with a 1e-6 ridge), and
        residuals K⁻y·σ² of the targets themselves, as the JAX model; a mean
        without ``basis_matrix`` raises ``ValueError``. Under a mesh each
        rank computes its latents' columns, gathered over the latent
        group."""
        y = self._targets(targets, orientation)
        if self.mesh is not None:
            view, lo, hi = self._latent_part()
            out = view.compute_loo(y[lo:hi], complex_mean, "tn")
            out = [self.mesh.gather_latents(t, lo, hi, self.n_funcs, dim=1)
                   for t in out]
            return tuple(t.detach() for t in out) if self.n_funcs > 1 \
                else tuple(out)
        L = safe_cholesky(self._train_covar(), agree=self._agree)
        if complex_mean:
            try:
                H = self.mean_module.basis_matrix(self.train_x)  # (n, k)
            except AttributeError as e:
                raise ValueError("A complex mean treatment was required, but "
                                 "the model mean function doesn't allow "
                                 "it!") from e
            eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
            K_inv = cho_solve(L, eye.expand_as(L))               # (T, n, n)
            KiH = K_inv @ H
            M = KiH.transpose(-1, -2) @ H
            Lm = safe_cholesky(M + 1e-6 * torch.eye(
                M.shape[-1], dtype=M.dtype, device=M.device))
            K_minus = K_inv - KiH @ cho_solve(Lm, KiH.transpose(-1, -2))
            sigma2 = 1.0 / torch.diagonal(K_minus, dim1=-2, dim2=-1)
            yminusmu = (K_minus @ y[..., None])[..., 0] * sigma2
        else:
            delta = y - self.mean_module(self.train_x)
            sigma2 = 1.0 / chol_inverse_diag(L)                  # (T, n)
            yminusmu = cho_solve(L, delta[..., None])[..., 0] * sigma2
        if self.n_funcs > 1:
            return sigma2.T.detach(), yminusmu.T.detach()
        return sigma2.T, yminusmu.T

    def _block(self, x, rows, **kw):
        """The task kernels' stack K(x, x) (T, n, n), or under the mesh the
        rank's block K(x[r0:r1], x) of its functions (K3 ``rows=``, the
        covariance module restricted by ``module.latent_slice``), bitwise
        those rows of the whole."""
        if rows is None:
            return self.covar_module(x, **kw)
        return latent_slice(self.covar_module, rows.lo, rows.hi,
                            self.n_funcs)(x, x, rows=(rows.r0, rows.r1), **kw)

    def _precond_roots(self, x, rank: int, jitter: float = 1e-4, rows=None):
        """Nyström roots of the batched task kernels at strided landmarks
        (ops.iterative.nystrom_roots_from_covar), (T, n, rank); with
        ``rows`` (under the mesh) from the rank's rows of K(x, z), gathered
        whole."""
        return it_ops.nystrom_roots_from_covar(self.covar_module, x, rank,
                                               jitter, rows)


class _DiagMVN(MultivariateNormal):
    """An MVN that carries only the diagonal of its covariance."""

    def __init__(self, mean, var):
        self.mean = mean
        self._var = var

    @property
    def variance(self):
        return self._var

    @property
    def covariance_matrix(self):
        return torch.diag_embed(self._var)

    def log_prob(self, value):
        z2 = (value - self.mean) ** 2 / self._var
        return -0.5 * (z2 + torch.log(self._var)
                       + math.log(2 * math.pi)).sum(-1)
