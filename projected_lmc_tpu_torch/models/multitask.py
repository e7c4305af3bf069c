"""Exact multitask GP, ICM and LMC coregionalization (port of
``projected_lmc_tpu/models/multitask.py``).

ICM: Σ = K ⊗ B + I ⊗ Σt with one stationary kernel and B = F Fᵀ +
diag(softplus(raw_var)), F the rank-q ``covar_factor`` (T, q). Its MLL is,
up to n = ``ICM_DENSE_N_MAX``, the Kronecker one of ``ops/kron.py`` (K3, a
t×t eigh, the batched (t, n, n) Cholesky, an analytic backward), and above
it the matrix-free PCG estimator (``ops/iterative.icm_pcg_log_prob``: K3's
(n, n) matrix, one stream a CG product). Its posterior is the joint
diagonalization ("icm") or, above the ceiling, PCG with a conservative
Kronecker-factored variance ("icm_iter").

LMC: Σ = Σ_b K_b ⊗ h_b h_bᵀ + I ⊗ Σt with one stationary kernel per latent
and rank-1 task factors h_b (``covar_factor``, SVD-initialized from the
labels). The marginal likelihood is, up to q·n = ``DENSE_QN_MAX``, the
dense Woodbury one of ``ops/woodbury.py`` (K3, batched Cholesky), and above
it the fused op of ``ops/fused_mll.py``: stack build (kernel K1; K8 for an
int8 stack, K6 under ``PLMC_SYM_BUILD=0``), Nyström-preconditioned CG with
Lanczos quadrature, and a backward through kernel K2 (or K4/K5/K7, the
routes of ``ops/fused_mll``); the preconditioner's landmark blocks are
kernel K3.

The LMC posterior factorizes once (``precompute_posterior``, a plain dict):
the dense Woodbury factors ("lmc"), or above ``DENSE_QN_MAX`` a PCG solve
on the K3 stack with a conservative variance through Nyström factors
inflated by the residual's spectral bound ("lmc_iter").

SGPR (``n_inducing_points``, both types): Nyström roots R_b = K_xz L_zz⁻ᵀ
(K3 for K(z, z) and K(x, z)) in the low-rank Woodbury MLL with the
Titsias trace term; the ICM is an LMC of T pseudo-latents, the columns of
chol(B), sharing one root set. Its cache ("sgpr") is the (q·m)²
capacitance, its posterior ``woodbury.lmc_sgpr_posterior``.

Under a mesh (``parallel.shard_model``) every rank holds every leaf and
returns the whole value, by ``parallel.sharded``'s rule; every route runs.
The LMC's rank builds its block of the stack, its latents' rows over the
data axis (K6, or K8 for an int8 stack, in the fused op; the covariance
module's K3 on the composed and SLQ routes and in the "lmc_iter" cache),
and runs the row-sharded solvers of ``ops/iterative``: PCG, or CG + SLQ
with the Jacobi diagonal gathered whole and the Lanczos basis replicated;
an int8 loop quantises its block by the world max of each latent's
absmax. The roots come from its rows of K(x, z) and one gather. The ICM's
one kernel splits its rows over every rank on the matrix-free route and in
"icm_iter"; its dense MLL splits the t Cholesky blocks over the ranks and
keeps K whole, and its "icm" cache (the n×n eigh) is computed whole on
every rank. The dense Woodbury LMC (its MLL and "lmc" cache, q·n ≤
``DENSE_QN_MAX``) is small by definition and computed whole on every rank.
Both SGPR routes split the training rows over every rank (the LMC's
capacitance couples the latents, so not over the latent axis): a rank's
roots for every latent from its rows of K(x, z), their partial sums (the
capacitance Gram, the roots' products with u, Σ Y·W and the Titsias
traces) in one differentiable world sum, then the (q·m)² capacitance,
its Cholesky and the Titsias term replicated; the "sgpr" cache gathers α
and the roots' product with αH whole. ``posterior`` and ``compute_var``
split the test points over the ranks (each rank's K3 cross-covariance
rows) and gather the mean and variance, so that every rank returns the
whole (n*, T). ``compute_loo``, ``kernel_cond`` and the prior
(``forward``) are computed whole on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constraints import softplus
from ..distributions import (KronCov, MultitaskMultivariateNormal,
                             SumKronRank1Cov)
from ..kernels import (KERNEL_REGISTRY, AdditiveKernel, ScaleKernel,
                       handle_covar)
from ..likelihoods import MultitaskGaussianLikelihood
from ..means import MEAN_REGISTRY
from ..module import Module, latent_slice
from ..ops import fused_mll
from ..ops import iterative as it_ops
from ..ops import kron as kron_ops
from ..ops import woodbury as wb_ops
from ..ops.cholesky import cho_solve, safe_cholesky, solve_triangular
from ..ops.init_ops import init_lmc_coefficients
from ..utils.device import resolve_device
from .exact import (_as_inputs, _canon_targets, _np, _resolve,
                    nystrom_roots)


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
    """Exact ICM / LMC multitask GP (projected_lmc.py:438-656).

    ``device`` defaults to ``"cuda"``; pass ``device="cpu"`` for the plain
    PyTorch versions of the kernels. Parameters keep the JAX package's raw
    leaves and names, so ``utils.checkpoint.load_jax_state`` carries a JAX
    model's state over."""

    DENSE_QN_MAX = 4096
    # ICM's dense route factors t (n, n) blocks of ONE kernel, so its
    # matrix-free switchover sits above the LMC's q·n ceiling
    ICM_DENSE_N_MAX = 8192

    def __init__(self, train_x, train_y, likelihood=None, n_tasks=None,
                 n_latents: int = 1, model_type: str = "ICM",
                 init_lmc_coeffs: bool = True, fix_diagonal: bool = False,
                 mean_type="constant", kernel_type="rbf", decomp=None,
                 prior_scales=None, prior_width=None, ker_kwargs=None,
                 n_inducing_points=None, seed: int = 0,
                 sgpr_titsias_var: bool = True, device="cuda", **kwargs):
        super().__init__()
        if model_type not in ("ICM", "LMC"):
            raise ValueError("Wrong specified model type, should be ICM or LMC")
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

        mean_cls = _resolve(MEAN_REGISTRY, mean_type, "constant")
        self.mean_module = mean_cls(input_size=self.dim, batch_shape=n_tasks,
                                    dtype=dtype, seed=seed, device=dev)
        self.covar_module = handle_covar(
            _resolve(KERNEL_REGISTRY, kernel_type, "rbf"),
            dim=self.dim, decomp=decomp, prior_scales=prior_scales,
            prior_width=prior_width, outputscales=False,
            n_funcs=1 if model_type == "ICM" else n_latents,
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
        # ICM: one (T, q) factor; LMC: q rank-1 coregionalizations, each
        # with its own kernel copy
        self.register_raw("covar_factor", factor if model_type == "ICM"
                          else factor.T[..., None], dtype, dev)
        # diagonal of the task covariance(s); fix_diagonal freezes it at −10
        shape = (n_tasks,) if model_type == "ICM" else (n_latents, n_tasks)
        if fix_diagonal:
            self._frozen_params_ = ("raw_var",)
            self.register_raw("raw_var", np.full(shape, -10.0), dtype, dev)
        else:
            self.register_raw("raw_var", rng.standard_normal(shape), dtype, dev)
        # SGPR: the inducing points come from the same rng, after the draws
        # above
        if n_inducing_points is not None:
            self.register_raw("inducing_points", rng.standard_normal(
                (int(n_inducing_points), self.dim)), dtype, dev)
        else:
            self.inducing_points = None
        self.sgpr_titsias_var = bool(sgpr_titsias_var)
        self.mesh = None

    @property
    def device(self):
        return self.train_x.device

    def _rows(self, n: int):
        """Under the mesh, this rank's ``parallel.mesh.RowBlock`` of the
        (q, n, n) stack: the LMC's latents and rows over the data axis, the
        ICM's one kernel's rows over every rank; None without a mesh."""
        if self.mesh is None:
            return None
        if self.icm:
            return self.mesh.row_block(n, 1, over="world")
        return self.mesh.row_block(n, self.n_latents)

    def _block(self, x, rows, **kw):
        """The stack K(x, x) (q, n, n), or under the mesh the rank's block
        K(x[r0:r1], x) of its latents (K3 on the card; the LMC's covariance
        module restricted by ``module.latent_slice``), bitwise those rows
        of the whole."""
        if rows is None:
            return self.covar_module(x, **kw)
        cm = self.covar_module if self.icm else latent_slice(
            self.covar_module, rows.lo, rows.hi, self.n_latents)
        return cm(x, x, rows=(rows.r0, rows.r1), **kw)

    @property
    def icm(self) -> bool:
        return self.model_type == "ICM"

    @property
    def sgpr(self) -> bool:
        return self.inducing_points is not None

    def _nystrom_roots(self, x, rows=None):
        """R_b = K_xz L_zz⁻ᵀ, (n_kernels, n, m), or x's rows r0..r1 − 1
        alone for ``rows`` = (r0, r1)."""
        return nystrom_roots(self.covar_module, self.inducing_points, x,
                             rows=rows)

    def _sgpr_mixing(self, roots):
        """(roots, H, Σt) of the low-rank Woodbury form. ICM: Q ⊗ B = Σ_b Q ⊗
        s_b s_bᵀ with s_b the columns of chol(B + 1e-10·I), so T
        pseudo-latents share the one root set, broadcast to (T, n, m). LMC:
        the latents' roots with H (T, q) and the task noise with the
        per-latent diagonals (:meth:`_mixing`)."""
        if not self.icm:
            return (roots,) + self._mixing()
        B = self.task_covar_matrix()
        eye = torch.eye(self.n_tasks, dtype=B.dtype, device=B.device)
        return (roots[0].expand((self.n_tasks,) + roots.shape[1:]),
                safe_cholesky(B + 1e-10 * eye),
                self.likelihood.task_covariance())

    def _sgpr_structure(self, x, y):
        """The low-rank Woodbury MLL's pieces over x's rows r0..r1 − 1:
        every row without a mesh, the rank's rows over every rank under one
        (``mesh.world_range``; the LMC's capacitance couples the latents, so
        not over the latent axis).

        The rows' roots R_b for every kernel (K3's rows of K(x, z), the L_zz
        solve) give the sums over the rows — the capacitance Gram
        (``woodbury.lmc_gram``), s = Σ_b R_bᵀ u_b and Σ Y·W
        (``woodbury.lmc_sums``), the Titsias traces Σ clip(k_ii − q_ii, 0) —
        packed into one differentiable world sum under the mesh. The
        Titsias term is −½ Σᵢ (Kᵢᵢ − Qᵢᵢ)·tr(Σt⁻¹B) for the ICM, per latent
        with h_bᵀ Σt⁻¹ h_b for the LMC — the multitask analog of gpytorch's
        InducingPointKernelAddedLossTerm.

        Returns a dict: ``fac``, the Woodbury factors of all n rows
        (``woodbury.lmc_factors_from_roots`` on the summed Gram; its L_G the
        rows' roots); ``sums`` (s, Σ Y·W) of all n rows; ``titsias``; Σt
        (``St``); the rows' ``Yd`` = Y − m and ``rows`` (r0, r1)."""
        n = x.shape[0]
        r0, r1 = (0, n) if self.mesh is None else self.mesh.world_range(n)
        roots = self._nystrom_roots(
            x, None if self.mesh is None else (r0, r1))         # (k, n_l, m)
        gap = self.covar_module(x[r0:r1], diag=True) - (roots * roots).sum(-1)
        traces = torch.clamp(gap, min=0.0).sum(-1)              # (k,)
        Yd = y.T[r0:r1] - self.mean_module(x[r0:r1]).T          # (n_l, T)
        roots, H, St = self._sgpr_mixing(roots)
        _, s, yw = wb_ops.lmc_sums(Yd, roots, H, safe_cholesky(St))
        parts = [wb_ops.lmc_gram(roots).reshape(-1), s.reshape(-1),
                 yw[None], traces]
        total = torch.cat(parts)
        if self.mesh is not None:
            total = self.mesh.world_sum(total)
        P, s, yw, traces = total.split([p.numel() for p in parts])
        fac = wb_ops.lmc_factors_from_roots(roots, H, St, gram=P, n=n)
        V = solve_triangular(fac["Rt"], H, lower=True)
        titsias = -0.5 * (traces[0] * (V * V).sum() if self.icm
                          else (traces * (V * V).sum(0)).sum())
        return dict(fac=fac, sums=(s.reshape(fac["q"], fac["r"]), yw[0]),
                    titsias=titsias, St=St, Yd=Yd, rows=(r0, r1))

    def task_covar_matrix(self):
        """ICM: B = F Fᵀ + diag(softplus(raw_var)), (T, T). LMC: per-latent
        rank-1 B_b = h_b h_bᵀ + diag(softplus(raw_var_b)), (q, T, T)."""
        F = self.covar_factor
        return F @ F.transpose(-1, -2) + torch.diag_embed(
            softplus(self.raw_var))

    def lmc_coefficients(self):
        """(q, T) mixing coefficients, as a numpy array."""
        F = self.covar_factor.T if self.icm else self.covar_factor[..., 0]
        return F.detach().cpu().numpy()

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
        K ⊗ B (ICM) or Σ_b K_b ⊗ h_b h_bᵀ (LMC)."""
        x = _as_inputs(x, self.train_x)
        mean = self.mean_module(x).T
        if self.icm:
            return MultitaskMultivariateNormal(
                mean, KronCov(self.covar_module(x)[0],
                              self.task_covar_matrix()))
        return MultitaskMultivariateNormal(
            mean,
            SumKronRank1Cov(self.covar_module(x), self.covar_factor[..., 0].T))

    def _lmc_extra_diag(self):
        """Σ_b diag(softplus(raw_var_b)): the per-task variance capacity,
        carried as a white task-covariance term (see the JAX model)."""
        return softplus(self.raw_var).sum(0)

    def _precond_roots(self, x, rank: int, jitter: float = 1e-4, rows=None):
        """Nyström roots of the latent kernels at strided landmarks,
        (q, n, rank) (ops.iterative.nystrom_roots_from_covar); with ``rows``
        from the rank's rows of K(x, z), gathered whole."""
        return it_ops.nystrom_roots_from_covar(self.covar_module, x, rank,
                                               jitter, rows)

    def mll(self, x=None, y=None, iterative: bool = None, num_probes: int = 10,
            max_cg_iters: int = 256, cg_tol: float = 1e-2, slq_steps: int = 20,
            matvec_bf16: bool = False, precond_rank: int = 0,
            quad_method: str = "pcg", precond_roots=None,
            matvec_int8: bool = False, eps=None, xi=None, probes=None,
            generator=None):
        """Exact multitask MLL / (n·T), plus hyper-prior terms.

        SGPR (both types; the routing kwargs are ignored): the low-rank
        Woodbury log-density of :meth:`_sgpr_structure` plus its Titsias
        term. ICM: the Kronecker log-density (``kron.icm_log_prob_chol``) up to
        n = ``ICM_DENSE_N_MAX`` (or with ``iterative=False``), above it (or
        with ``iterative=True``) the matrix-free PCG estimator
        (``iterative.icm_pcg_log_prob``; ``precond_rank`` ≤ 0 becomes
        min(256, n)). LMC: the dense Woodbury log-density up to q·n =
        ``DENSE_QN_MAX`` (or with ``iterative=False``); above it, with
        ``precond_rank > 0`` and ``quad_method="pcg"``, the one-pass PCG
        estimator: fused (``ops/fused_mll``) for one stationary kernel over
        all the features, else the composed route
        (``iterative.lmc_pcg_log_prob`` on the covariance module's
        materialized stack: additive, spline and spectral-mixture kernels,
        a kernel over a proper subset of the features); otherwise (the
        default ``precond_rank=0``, or ``quad_method="slq"``) CG + SLQ on
        Rademacher ``probes`` (``iterative.lmc_iterative_log_prob``,
        ``slq_steps`` Lanczos steps, Nyström-preconditioned from the stack
        when ``precond_rank > 0``).

        eps (num_probes, n, T) and xi are the standard normals of the
        probes, xi (num_probes, q, rank) for LMC and (num_probes, m, T) for
        ICM, m the rank of the roots used; when not given they are drawn
        from ``generator`` (a fresh ``torch.Generator`` seeded 0 when None,
        as the JAX model draws from ``PRNGKey(0)`` without a key); the SLQ
        route's ``probes`` (num_probes, n, T) likewise
        (``iterative.draw_probes``). ``precond_roots``: caller-supplied, possibly stale, Nyström roots,
        (q, n, rank) for LMC, (k, n, m) or (n, m) for ICM; the estimator is
        exact for any SPD preconditioner. ``matvec_bf16``: the CG products
        on K3's matrix cast to bf16, fp32 accumulation. ``matvec_int8``
        (LMC, over ``matvec_bf16``): the int8 stack (kernel K8) and
        int8 × int8 → int32 stack products (``ops/fused_mll``)."""
        x = self.train_x if x is None else x
        y = self.train_y if y is None else _canon_targets(
            torch.as_tensor(y, dtype=x.dtype, device=x.device), self.n_tasks)
        n = x.shape[0]
        Ydelta = y.T - self.mean_module(x).T                    # (n, T)
        if self.sgpr:
            sg = self._sgpr_structure(x, y)
            ll = wb_ops.lmc_log_prob(None, sg["fac"]["H"], sg["St"], None,
                                     fac=sg["fac"], sums=sg["sums"])
            return (ll + sg["titsias"] + self.covar_module.prior_log_prob()) \
                / (n * self.n_tasks)
        if self.icm:
            ll = self._icm_log_prob(
                x, Ydelta, iterative, num_probes, max_cg_iters, cg_tol,
                matvec_bf16, precond_rank, precond_roots, eps, xi, generator)
            return (ll + self.covar_module.prior_log_prob()) \
                / (n * self.n_tasks)
        H, St = self._mixing()
        if iterative is None:
            iterative = self.n_latents * n > self.DENSE_QN_MAX
        if not iterative:
            # small by definition (q·n ≤ DENSE_QN_MAX): whole on every rank
            ll = wb_ops.lmc_log_prob(self.covar_module(x), H, St, Ydelta)
            return (ll + self.covar_module.prior_log_prob()) \
                / (n * self.n_tasks)
        if precond_rank <= 0 or quad_method != "pcg":
            # CG + SLQ on Rademacher probes over the materialized stack (the
            # rank's block under the mesh), the preconditioner
            # (precond_rank > 0) from the stack's columns
            if probes is None:
                if generator is None:
                    generator = torch.Generator(device=x.device).manual_seed(0)
                probes = it_ops.draw_probes(generator, n, self.n_tasks,
                                            num_probes, Ydelta.dtype)
            rows = self._rows(n)
            ll = it_ops.lmc_iterative_log_prob(
                self._block(x, rows), H, St, Ydelta, probes, max_cg_iters,
                cg_tol, slq_steps, matvec_bf16, precond_rank, rows=rows)
            return (ll + self.covar_module.prior_log_prob()) \
                / (n * self.n_tasks)
        eps, xi = self._draw_probes(n, Ydelta.dtype, x.device, eps, xi,
                                    generator, num_probes,
                                    (self.n_latents, min(precond_rank, n)))
        rows = self._rows(n)
        if precond_roots is None:
            with torch.no_grad():
                precond_roots = self._precond_roots(x, precond_rank,
                                                    rows=rows)
        spec = _fused_stationary_spec(self.covar_module, self.dim)
        if spec is None:
            # the composed route: any kernel, the (q, n, n) stack (the
            # rank's block under the mesh) materialized (in bf16 for a bf16
            # CG loop, its cotangent too)
            Ks = self._block(
                x, rows, out_dtype=torch.bfloat16 if matvec_bf16 else None)
            ll = it_ops.lmc_pcg_log_prob(
                Ks, H, St, Ydelta, eps, xi, precond_roots, max_cg_iters,
                cg_tol, matvec_bf16, precond_rank, matvec_int8, rows=rows)
            return (ll + self.covar_module.prior_log_prob()) \
                / (n * self.n_tasks)
        kind, ls, os_ = spec
        ll = fused_mll.lmc_pcg_log_prob_stationary(
            x, ls, os_, H, St, Ydelta, eps, xi, precond_roots, kind,
            max_cg_iters, cg_tol, matvec_bf16, precond_rank, matvec_int8,
            device=x.device, rows=rows)
        return (ll + self.covar_module.prior_log_prob()) / (n * self.n_tasks)

    def _draw_probes(self, n, dtype, device, eps, xi, generator, num_probes,
                     xi_shape):
        """(eps, xi): the given ones, or eps (num_probes, n, T) then xi
        (num_probes, *xi_shape) from ``generator`` (seeded 0 when None)."""
        if eps is not None and xi is not None:
            return eps, xi
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        draw = dict(generator=generator, dtype=dtype, device=device)
        return (torch.randn((num_probes, n, self.n_tasks), **draw),
                torch.randn((num_probes, *xi_shape), **draw))

    def _icm_log_prob(self, x, Ydelta, iterative, num_probes, max_cg_iters,
                      cg_tol, matvec_bf16, precond_rank, precond_roots, eps,
                      xi, generator):
        """The ICM log-density of :meth:`mll` (without the prior terms)."""
        n = x.shape[0]
        B = self.task_covar_matrix()
        St = self.likelihood.task_covariance()
        if iterative is None:
            iterative = n > self.ICM_DENSE_N_MAX
        if not iterative:
            return kron_ops.icm_log_prob_chol(self.covar_module(x)[0], B, St,
                                              Ydelta, mesh=self.mesh)
        # above the dense ceiling the t parallel (n, n) Choleskys are
        # O(t·n²) memory; the estimator is exact for any SPD preconditioner,
        # so a default Nyström rank is always safe
        if precond_rank <= 0:
            precond_rank = min(256, n)
        rows = self._rows(n)
        if precond_roots is not None:
            roots = precond_roots[0] if precond_roots.dim() == 3 \
                else precond_roots
        else:
            with torch.no_grad():
                roots = self._precond_roots(x, precond_rank, rows=rows)[0]
        # the probes' rank is the roots' (stale roots may have another)
        m_rank = int(roots.shape[-1])
        eps, xi = self._draw_probes(n, Ydelta.dtype, x.device, eps, xi,
                                    generator, num_probes,
                                    (m_rank, self.n_tasks))
        K = self._block(
            x, rows, out_dtype=torch.bfloat16 if matvec_bf16 else None)[0]
        return it_ops.icm_pcg_log_prob(K, B, St, Ydelta, eps, xi, roots,
                                       max_cg_iters, cg_tol, matvec_bf16,
                                       m_rank, rows=rows)

    # -- posterior ---------------------------------------------------------------
    def precompute_posterior(self, iterative: bool = None,
                             max_cg_iters: int = 400, cg_tol: float = 1e-5,
                             precond_rank: int = 256, v0=None,
                             generator=None):
        """Factorize the training system once, a dict for :meth:`posterior`.

        LMC: up to q·n = ``DENSE_QN_MAX`` (or with ``iterative=False``) the
        dense Woodbury factors ("lmc"). Above it ("lmc_iter"): the mean from
        a tight PCG solve on the materialized (q, n, n) stack (kernel K3),
        Nyström-preconditioned at ``precond_rank``, and a conservative
        variance through M_up = Σ_b Q_b ⊗ h_bh_bᵀ + I ⊗ (Σt + c·I) ⪰ Σ,
        c the residual's λmax from power iteration started at ``v0``
        (n, T), or at a draw from ``generator``.

        ICM: up to n = ``ICM_DENSE_N_MAX`` (or with ``iterative=False``) the
        joint-diagonalization factors and α ("icm"). Above it ("icm_iter"):
        the mean from PCG with the one-K-stream ICM product, preconditioned
        by rank-m Nyström roots of K3's (n, n) matrix, and a conservative
        variance through M_up = Q ⊗ B + I ⊗ (Σt + c·I), c = λmax(K − Q) ·
        λmax(B) from power iteration started at ``v0`` (n, 1), or at a draw
        from ``generator``.

        SGPR (both types): the Woodbury factors of the low-rank roots
        without the roots themselves, α and u_b = R_bᵀ(α h_b) ("sgpr").

        Under a mesh: "lmc_iter" and "icm_iter" on the rank's row block
        (the PCG and the power iteration row-sharded, their start vector
        rank 0's draw), "lmc" and "icm" whole on every rank, "sgpr" on the
        rank's rows over every rank (α and u gathered whole); the cache is
        whole and the same on every rank."""
        if self.sgpr:
            return self._sgpr_cache()
        if self.icm:
            return self._icm_posterior_cache(iterative, max_cg_iters, cg_tol,
                                             precond_rank, v0, generator)
        x = self.train_x
        n = x.shape[0]
        Ydelta = self._train_delta()
        H, St = self._mixing()
        if iterative is None:
            iterative = self.n_latents * n > self.DENSE_QN_MAX
        if not iterative:
            fac = wb_ops.lmc_factors(self.covar_module(x), H, St)
            return dict(kind="lmc", fac=fac, alpha=wb_ops.lmc_solve(Ydelta, fac),
                        H=H, Sigma_t=St)
        rows = self._rows(n)
        Ks = self._block(x, rows)
        roots = self._precond_roots(x, precond_rank, rows=rows)
        minv = it_ops.nystrom_precond(Ks, H, St, precond_rank, roots=roots)
        # M⁻¹ is given, so the Jacobi diagonal is never read
        alpha = it_ops.batched_pcg(
            lambda V: it_ops.lmc_matvec(Ks, H, St, V, rows), Ydelta[None],
            None, max_iters=max_cg_iters, tol=cg_tol, minv=minv)[0]
        c = it_ops.residual_spectral_bound(Ks, roots, H, v0=v0,
                                           generator=generator, rows=rows)
        eye = torch.eye(self.n_tasks, dtype=St.dtype, device=St.device)
        fac_up = wb_ops.lmc_factors_from_roots(roots, H, St + c * eye)
        return dict(kind="lmc_iter", alpha=alpha, H=H, Sigma_t=St, fac=fac_up)

    def _sgpr_cache(self):
        """The "sgpr" cache: the factors of :meth:`_sgpr_structure`, α =
        Σ⁻¹ vec(Y − m) (``woodbury.lmc_solve`` on the summed s) and u_b =
        R_bᵀ(α h_b) for its rows; under the mesh α gathered whole and u
        summed over every rank in one call. Its fac keeps no roots (L_G),
        whose rows would be the rank's alone: the posterior reads u."""
        x = self.train_x
        n, T = x.shape[0], self.n_tasks
        sg = self._sgpr_structure(x, self.train_y)
        fac = dict(sg["fac"])
        roots = fac.pop("L_G")
        alpha = wb_ops.lmc_solve(sg["Yd"], sg["fac"], s=sg["sums"][0])
        u = torch.einsum("bnk,nb->bk", roots, alpha @ fac["H"])
        if self.mesh is not None:
            r0, r1 = sg["rows"]
            buf = alpha.new_zeros(n * T + u.numel())
            buf[r0 * T:r1 * T] = alpha.reshape(-1)
            buf[n * T:] = u.reshape(-1)
            buf = self.mesh.world_sum(buf)
            alpha, u = buf[:n * T].reshape(n, T), buf[n * T:].reshape(u.shape)
        return dict(kind="sgpr", fac=fac, alpha=alpha, u=u, H=fac["H"],
                    Sigma_t=sg["St"])

    def _icm_posterior_cache(self, iterative, max_cg_iters, cg_tol,
                             precond_rank, v0, generator):
        x = self.train_x
        n = x.shape[0]
        Ydelta = self._train_delta()
        B = self.task_covar_matrix()
        St = self.likelihood.task_covariance()
        if iterative is None:
            iterative = n > self.ICM_DENSE_N_MAX
        if not iterative:
            fac = kron_ops.icm_eig_factors(self.covar_module(x)[0], B, St)
            alpha = kron_ops.icm_solve(Ydelta, fac)
            return dict(kind="icm", fac=fac, alpha=alpha, B=B, Sigma_t=St)
        rows = self._rows(n)
        K = self._block(x, rows)[0]
        m_rank = min(precond_rank if precond_rank > 0 else 256, n)
        roots = it_ops.nystrom_roots_from_kernels(K[None], m_rank,
                                                  rows=rows)[0]
        minv = it_ops._icm_nystrom_parts(K, B, St, m_rank, roots=roots)[3]
        # M⁻¹ is given, so the Jacobi diagonal is never read
        alpha = it_ops.batched_pcg(
            lambda V: it_ops.icm_matvec(K, B, St, V, rows), Ydelta[None],
            None, max_iters=max_cg_iters, tol=cg_tol, minv=minv)[0]
        c = it_ops.icm_residual_spectral_bound(K, roots, B, v0=v0,
                                               generator=generator, rows=rows)
        eye = torch.eye(self.n_tasks, dtype=St.dtype, device=St.device)
        parts = it_ops.icm_whitened_parts(None, B, St + c * eye, m_rank,
                                          roots=roots)
        return dict(kind="icm_iter", alpha=alpha, B=B, Sigma_t=St,
                    **{k: parts[k] for k in ("R", "gam", "P_inv", "C_inv")})

    def posterior(self, x_star, cache=None, observed: bool = True):
        """Posterior mean and variance diagonal (n*, T) at x_star, with the
        observation noise when ``observed``. The (q, n*, n) cross-covariance
        ((1, n*, n) for ICM) is kernel K3 on the card; the prior and noise
        use the true Σt, the "lmc_iter" and "icm_iter" corrections the
        inflated factors. "sgpr": the test points' Nyström roots (K3's
        (q, n*, m)) through ``woodbury.lmc_sgpr_posterior``, with the
        low-rank gap when ``sgpr_titsias_var``. Under a mesh the test points
        split over the ranks and the mean and variance are gathered (one
        ``all_reduce``): every rank returns the whole (n*, T)."""
        if cache is None:
            cache = self.precompute_posterior()
        x_star = _as_inputs(x_star, self.train_x)
        parts = self._sgpr_posterior if cache["kind"] == "sgpr" \
            else self._posterior_parts
        if self.mesh is None:
            return _MeanVarMT(*parts(x_star, cache, observed))
        ns, T = x_star.shape[0], self.n_tasks
        s0, s1 = self.mesh.world_range(ns)
        both = self.mesh.gather_world(torch.cat(parts(
            x_star, cache, observed, (s0, s1)), -1), s0, s1, ns)
        return _MeanVarMT(both[:, :T], both[:, T:])

    def _posterior_parts(self, x_star, cache, observed, rows=None):
        """(mean, variance diagonal), each (n*, T), at x_star, or at its
        rows r0..r1 − 1 alone for ``rows`` = (r0, r1) (the cross-covariance
        rows bitwise those of the whole)."""
        kw = {} if rows is None else dict(rows=rows)
        Kstars = self.covar_module(x_star, self.train_x, **kw)  # (q, n*, n)
        if rows is not None:
            x_star = x_star[rows[0]:rows[1]]
        kss = self.covar_module(x_star, diag=True)              # (q, n*)
        mean_star = self.mean_module(x_star).T
        if cache["kind"] in ("icm", "icm_iter"):
            B, St = cache["B"], cache["Sigma_t"]
            mean = kron_ops.icm_posterior_mean(Kstars[0], B, cache["alpha"],
                                               mean_star)
            if cache["kind"] == "icm":
                var = kron_ops.icm_posterior_variance(
                    kss[0], Kstars[0], B, cache["fac"],
                    noise_diag=torch.diagonal(St) if observed else None)
            else:
                var = it_ops.icm_nystrom_posterior_variance(
                    Kstars[0], kss[0], B, St, cache, noise=observed)
            return mean, var
        mean = wb_ops.lmc_posterior_mean(Kstars, cache["H"], cache["alpha"],
                                         mean_star)
        var = wb_ops.lmc_posterior_variance(
            Kstars, kss, cache["H"], cache["Sigma_t"], cache["fac"],
            noise=observed)
        return mean, var

    def _sgpr_posterior(self, x_star, cache, observed, rows=None):
        """(mean, variance diagonal) of the "sgpr" cache at x_star, or at
        its rows r0..r1 − 1 alone for ``rows`` (K3's rows of K(x*, z))."""
        roots = self._nystrom_roots(x_star, rows)               # (k, n*, m)
        if rows is not None:
            x_star = x_star[rows[0]:rows[1]]
        kss = self.covar_module(x_star, diag=True) \
            if self.sgpr_titsias_var else None                  # (k, n*)
        if self.icm:
            roots = roots[0].expand((self.n_tasks,) + roots.shape[1:])
            if kss is not None:
                kss = kss[0].expand(self.n_tasks, kss.shape[-1])
        return wb_ops.lmc_sgpr_posterior(
            roots, cache["fac"], cache["alpha"],
            self.mean_module(x_star).T, noise=observed, kss_star=kss,
            u=cache["u"])

    def compute_var(self, x_star):
        """The ICM's posterior variance with noise (projected_lmc.py:591-640,
        chunked over test points); not defined for LMC."""
        if not self.icm:
            raise ValueError("This method is only available for ICM models")
        return self.posterior(x_star, observed=True).variance

    def _dense_cov(self):
        """The (n·T, n·T) training covariance with its noise."""
        if self.icm:
            return KronCov(self.covar_module(self.train_x)[0],
                           self.task_covar_matrix(),
                           self.likelihood.task_covariance()).dense()
        H, St = self._mixing()
        return SumKronRank1Cov(self.covar_module(self.train_x), H, St).dense()

    def compute_loo(self):
        """Multitask LOO on the dense (n·T)² system (on the SGPR route the
        Nyström one): (σ², y − μ), both (n, T), detached."""
        n = self.train_x.shape[0]
        if self.sgpr:
            roots, H, St = self._sgpr_mixing(
                self._nystrom_roots(self.train_x))
            dense = SumKronRank1Cov(roots @ roots.transpose(-1, -2), H,
                                    St).dense()
        else:
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

    def lscales(self, unpacked: bool = True):
        """Learned lengthscales, (n_latents, dims), as a numpy array (the
        ICM's one kernel repeated for each latent; a list of one when not
        ``unpacked``); for an additive kernel, a list with one array per
        group."""
        cm = self.covar_module
        if isinstance(cm, AdditiveKernel):
            return [_np(k.lengthscale) for k in cm.kernels]
        scales = np.squeeze(cm.lengthscale.detach().cpu().numpy(), axis=-2)
        if self.icm:
            scales = np.repeat(scales, self.n_latents, axis=0)
        return scales if unpacked else [scales]

    def outputscale(self, unpacked: bool = False):
        """Outputscales, (n_latents, 1): ones, as the kernels carry none
        (squeezed when ``unpacked``); an additive kernel's groups' own,
        (n_kernels, n_groups)."""
        cm = self.covar_module
        if isinstance(cm, AdditiveKernel):
            res = np.stack([_np(k.outputscale) for k in cm.kernels], axis=1)
        else:
            res = np.ones((self.n_latents, 1))
        return res.squeeze() if unpacked else res


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
