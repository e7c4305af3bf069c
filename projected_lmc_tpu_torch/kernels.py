"""Kernels, priors and the kernel factory (port of
``projected_lmc_tpu/kernels.py``).

Every kernel is batched over a leading ``n_funcs`` dimension (latents) and
returns (n_funcs, n, m). The stationary kernels' dense evaluations go
through :func:`stationary_kernel_matrix`, whose forward is kernel K3 on the
card (``ops.cuda_kernels.kernel_matrix``) and whose backward is the JAX
package's hand-written ``_skm_bwd`` in plain torch. The spline and
spectral-mixture kernels, the Scale wrapper and the additive sum are plain
torch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch
from torch import nn

from . import constraints
from .module import Module
from .ops import cuda_kernels as ck
from .utils.device import resolve_device

# dg/d(d²), shared with the CUDA kernels' plain versions (the profile g itself
# is ops.cuda_kernels.profile)
_dprofile = ck.dprofile


def _sqdist(x1, x2):
    """Batched pairwise squared distances (..., n, d), (..., m, d) → (..., n, m)."""
    cross = torch.matmul(x1, x2.transpose(-1, -2))
    d2 = (x1 * x1).sum(-1)[..., :, None] + (x2 * x2).sum(-1)[..., None, :] \
        - 2.0 * cross
    return torch.clamp(d2, min=0.0)


_BWD_SLAB = 2048
_BWD_SLAB_MIN = 500_000_000     # cotangent entries above which W is slabbed


def _skm_bwd_reductions(kind, x1c, x2c, ls, g):
    """rows (B, n), cols (B, m), W x2 (B, n, d), Wᵀ x1 (B, m, d) of
    W = g ⊙ g′(d²). Under memory pressure (an fp32 or bf16 cotangent of more
    than ``_BWD_SLAB_MIN`` entries) it runs over row slabs, so that only one
    (B, slab, m) block of W exists at a time."""
    B, n, m = ls.shape[0], x1c.shape[0], x2c.shape[0]
    if not (g.dtype in (torch.float32, torch.bfloat16)
            and B * n * m > _BWD_SLAB_MIN):
        W = g * _dprofile(kind, _sqdist(x1c[None] / ls, x2c[None] / ls))
        return (W.sum(-1), W.sum(-2), W @ x2c,
                torch.einsum("bij,id->bjd", W, x1c))
    a2 = x2c[None] / ls
    cols = torch.zeros((B, m), dtype=torch.float32, device=g.device)
    Wtx1 = torch.zeros((B, m, x1c.shape[1]), dtype=torch.float32,
                       device=g.device)
    rows, Wx2 = [], []
    for start in range(0, n, _BWD_SLAB):
        xb = x1c[start:start + _BWD_SLAB]
        W = g[:, start:start + _BWD_SLAB].float() \
            * _dprofile(kind, _sqdist(xb[None] / ls, a2))
        rows.append(W.sum(-1))
        Wx2.append(W @ x2c)
        cols = cols + W.sum(-2)
        Wtx1 = Wtx1 + torch.einsum("bij,id->bjd", W, xb)
    return torch.cat(rows, 1), cols, torch.cat(Wx2, 1), Wtx1


class _StationaryKernelMatrix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x1, x2, ls, kind, out_dtype, device, rows):
        # centred inputs (translation invariance, exact): the backward's
        # distance expansion stays safe for large-offset features; a row
        # block is centred as the whole x1 is, so that its values are
        # bitwise those rows of the whole matrix
        mu = x1.mean(0)
        x1c, x2c = x1 - mu, x2 - mu
        ctx.rows = rows
        if rows is not None:
            ctx.n1 = x1.shape[0]
            x1c = x1c[rows[0]:rows[1]]
        if x1c.is_cuda and x1c.dtype != torch.float32:
            raise NotImplementedError(
                "on the card the dense kernel matrix takes float32 inputs "
                "(kernel K3)")
        # another out_dtype (bf16 for a bf16 stack) is K3's fp32 matrix cast
        # once, as the JAX _skm_fwd's XLA branch casts
        K = ck.kernel_matrix(x1c, x2c, ls, kind, device=device)
        ctx.save_for_backward(x1c, x2c, ls)
        ctx.kind = kind
        return K if out_dtype is None else K.to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x1c, x2c, ls = ctx.saved_tensors
        rows, cols, Wx2, Wtx1 = _skm_bwd_reductions(ctx.kind, x1c, x2c, ls, g)
        lsq = ls[:, 0, :]                                   # (B, d)
        ls2 = lsq * lsq
        sq1 = rows @ (x1c * x1c)
        sq2 = cols @ (x2c * x2c)
        crossd = torch.einsum("bid,id->bd", Wx2, x1c)
        # dd²/dl_bd = −2 (x1_id − x2_jd)² / l_bd³
        dls = (sq1 + sq2 - 2.0 * crossd) * (-2.0)
        if lsq.shape[-1] == 1 and dls.shape[-1] != 1:
            dls = dls.sum(-1, keepdim=True)     # scalar lengthscale, d > 1
        dls = dls / (lsq * ls2)
        dx1 = 2.0 * ((rows[..., None] * x1c[None] - Wx2)
                     / ls2[:, None, :]).sum(0)
        dx2 = 2.0 * ((cols[..., None] * x2c[None] - Wtx1)
                     / ls2[:, None, :]).sum(0)
        if ctx.rows is not None:
            dx1 = torch.nn.functional.pad(
                dx1, (0, 0, ctx.rows[0], ctx.n1 - ctx.rows[1]))
        return (dx1.to(x1c.dtype), dx2.to(x2c.dtype),
                dls[:, None, :].to(ls.dtype), None, None, None, None)


def stationary_kernel_matrix(x1, x2, ls, kind: str, out_dtype=None,
                             device="cuda", rows=None):
    """K_b = g(|x1/l_b − x2/l_b|²), (B, n, m), for inputs x1 (n, d) and
    x2 (m, d) shared across the lengthscale batch (B, 1, d). Custom backward:
    one elementwise pass over the cotangent plus matvec-sized contractions
    (the JAX package's ``_skm_bwd``), no autodiff through the profile.
    ``rows`` (r0, r1): only the rows r0..r1 − 1 of that matrix, bitwise
    those of the whole (a rank's block under a mesh)."""
    return _StationaryKernelMatrix.apply(x1, x2, ls, kind, out_dtype, device,
                                         rows)


class Prior:
    """Lengthscale prior (``handle_covar_`` registers Normal/MVN priors,
    projected_lmc.py:143-149); adds its log-probability to the MLLs.

    Value equality and hashing (array-aware, as the JAX package's, where
    priors live in a kernel's static pytree data): two models built with
    equal priors count as the same configuration."""

    def log_prob(self, value):
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and \
            self.__dict__.keys() == other.__dict__.keys() and \
            all(np.array_equal(v, other.__dict__[k])
                for k, v in self.__dict__.items())

    def __hash__(self):
        return hash((type(self).__name__,
                     tuple((k, np.asarray(v).tobytes())
                           for k, v in sorted(self.__dict__.items()))))


class NormalPrior(Prior):
    """Normal lengthscale prior (1-feature groups)."""

    def __init__(self, loc, scale):
        self.loc = np.asarray(loc, dtype=np.float64)
        self.scale = np.asarray(scale, dtype=np.float64)

    def log_prob(self, value):
        loc = torch.as_tensor(self.loc, dtype=value.dtype, device=value.device)
        scale = torch.as_tensor(self.scale, dtype=value.dtype,
                                device=value.device)
        z = (value - loc) / scale
        return (-0.5 * z ** 2 - torch.log(scale)
                - 0.5 * math.log(2 * math.pi)).sum()


class MultivariateNormalPrior(Prior):
    """Diagonal-covariance MVN lengthscale prior (multi-feature groups)."""

    def __init__(self, loc, variance_diag):
        self.loc = np.asarray(loc, dtype=np.float64)
        self.var = np.asarray(variance_diag, dtype=np.float64)

    def log_prob(self, value):
        loc = torch.as_tensor(self.loc, dtype=value.dtype, device=value.device)
        var = torch.as_tensor(self.var, dtype=value.dtype, device=value.device)
        return (-0.5 * (value - loc) ** 2 / var - 0.5 * torch.log(var)
                - 0.5 * math.log(2 * math.pi)).sum()


class Kernel(Module):
    """Base kernel, batched over ``batch`` functions: ``forward(x1, x2,
    diag, out_dtype)`` on inputs shared by the batch, (n, d) or 1-D for one
    feature, or per batch element, (batch, n, d), gives (batch, n, m), or
    with ``diag`` the (batch, min(n, m)) diagonal k(x1_i, x2_i). A dense
    ``forward`` also takes ``rows=(r0, r1)``: the rows r0..r1 − 1 of that
    matrix alone, bitwise those of the whole (a rank's row block under a
    mesh)."""

    has_lengthscale = False

    def _setup(self, batch_shape, active_dims):
        self.batch = int(batch_shape)
        self.active_dims = tuple(active_dims) if active_dims is not None \
            else None

    def _leaf(self):
        return next(itertools.chain(self.parameters(), self.buffers()))

    @property
    def device(self):
        """The device of the kernel's leaves."""
        return self._leaf().device

    def _inputs(self, x1, x2):
        """(x1, x2) over the kernel's active features (sliced on the last
        axis): both 2-D (n, d), or, when either is 3-D, both (batch, n, d),
        a 2-D one broadcast to the batch (the JAX ``Kernel.__call__``)."""
        x2 = x1 if x2 is None else x2
        x1, x2 = (x[:, None] if x.dim() == 1 else x for x in (x1, x2))
        if self.active_dims is not None:
            idx = list(self.active_dims)
            x1, x2 = x1[..., idx], x2[..., idx]
        if x1.dim() == 3 or x2.dim() == 3:
            x1, x2 = (x.expand(self.batch, *x.shape) if x.dim() == 2 else x
                      for x in (x1, x2))
        return x1, x2

    @staticmethod
    def _rows_of(x1, rows):
        """x1's rows r0..r1 − 1 (all of x1 when ``rows`` is None)."""
        return x1 if rows is None else x1[..., rows[0]:rows[1], :]

    def prior_log_prob(self):
        """Sum of the hyperparameter priors' log-probabilities."""
        leaf = self._leaf()
        return torch.zeros((), dtype=leaf.dtype, device=leaf.device)

    def sub_kernels(self):
        return []


class _StationaryKernel(Kernel):
    """Stationary kernel with an ARD lengthscale of shape (batch, 1, d)."""

    has_lengthscale = True
    _kind = None   # profile name in ops.cuda_kernels.KINDS

    def __init__(self, ard_num_dims=1, batch_shape=1, active_dims=None,
                 lengthscale_prior=None, dtype=torch.float32, device="cuda"):
        super().__init__()
        self._setup(batch_shape, active_dims)
        d = int(ard_num_dims) if ard_num_dims else 1
        init = constraints.inv_softplus(torch.tensor(1.0, dtype=dtype))
        self.register_raw("raw_lengthscale", init.expand(self.batch, 1, d),
                          dtype, resolve_device(device))
        self.lengthscale_prior = lengthscale_prior

    @property
    def lengthscale(self):
        return constraints.softplus(self.raw_lengthscale)

    def set_lengthscale(self, value):
        value = torch.as_tensor(value, dtype=self.raw_lengthscale.dtype,
                                device=self.device)
        with torch.no_grad():
            self.raw_lengthscale.copy_(constraints.inv_softplus(
                value.expand_as(self.raw_lengthscale)))
        return self

    def forward(self, x1, x2=None, diag: bool = False, out_dtype=None,
                rows=None):
        """Dense (batch, n, m) on shared inputs through
        :func:`stationary_kernel_matrix` (kernel K3 on the card); the
        diagonal, and per-batch 3-D inputs, in plain torch, as the JAX
        package leaves them to XLA (it sends only 2-D inputs to Pallas)."""
        x1, x2 = self._inputs(x1, x2)
        ls = self.lengthscale                               # (B, 1, d)
        if diag:
            n = min(x1.shape[-2], x2.shape[-2])
            d2 = (((x1[..., :n, :] - x2[..., :n, :]) / ls) ** 2).sum(-1)
        elif x1.dim() == 3:       # from direct differences, as K3's plain
            a, b = self._rows_of(x1, rows) / ls, x2 / ls
            d2 = ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)
        else:
            return stationary_kernel_matrix(x1, x2, ls, self._kind,
                                            out_dtype, self.device, rows)
        K = ck.profile(self._kind, d2)
        return K if out_dtype is None else K.to(out_dtype)

    def prior_log_prob(self):
        if self.lengthscale_prior is not None:
            return self.lengthscale_prior.log_prob(self.lengthscale[..., 0, :])
        return torch.zeros((), dtype=self.raw_lengthscale.dtype,
                           device=self.device)


class RBFKernel(_StationaryKernel):
    """k(x, y) = exp(−½ |x − y|²/l²), ARD."""

    _kind = "rbf"


class MaternKernel(_StationaryKernel):
    """Matérn kernel, nu in {0.5, 1.5, 2.5} (gpytorch default 2.5)."""

    def __init__(self, nu: float = 2.5, **kwargs):
        if nu not in (0.5, 1.5, 2.5):
            raise ValueError("nu must be 0.5, 1.5 or 2.5")
        super().__init__(**kwargs)
        self.nu = float(nu)
        self._kind = {0.5: "matern05", 1.5: "matern15", 2.5: "matern25"}[self.nu]


class SplineKernel(Kernel):
    """Cubic-spline kernel (projected_lmc.py:26-35): the product over
    features of 1 + min·max + ½ min² (max − min/3); its diagonal is
    Π (1 + x² + x³/3), as in the reference. Plain torch, as the JAX package
    leaves it to XLA."""

    def __init__(self, batch_shape=1, active_dims=None, dtype=torch.float32,
                 device="cuda", **_):
        super().__init__()
        self._setup(batch_shape, active_dims)
        # the JAX kernel's empty placeholder leaf, kept so that key paths match
        self.register_buffer("_dummy", torch.zeros(
            (0,), dtype=dtype, device=resolve_device(device)))

    def forward(self, x1, x2=None, diag: bool = False, out_dtype=None,
                rows=None):
        x1, x2 = self._inputs(x1, x2)
        if not diag:
            x1 = self._rows_of(x1, rows)
        if diag:
            x = x1[..., :min(x1.shape[-2], x2.shape[-2]), :]
            K = (1 + x ** 2 + x ** 3 / 3.0).prod(-1)
        else:
            K = torch.ones(x1.shape[:-1] + x2.shape[-2:-1], dtype=x1.dtype,
                           device=x1.device)
            for j in range(x1.shape[-1]):           # one (n, m) at a time
                a, b = x1[..., :, j, None], x2[..., None, :, j]
                lo, hi = torch.minimum(a, b), torch.maximum(a, b)
                K = K * (1 + lo * hi + 0.5 * lo ** 2 * (hi - lo / 3.0))
        K = K.expand(self.batch, *(K.shape[-1:] if diag else K.shape[-2:]))
        return K if out_dtype is None else K.to(out_dtype)


class SpectralMixtureKernel(Kernel):
    """Spectral mixture kernel (Wilson & Adams 2013), the kernel of the
    reference's bramblemet tidal experiment (realdata_experiments.py:130-140):

        k(τ) = Σ_q w_q Π_d exp(−2π² τ_d² σ_qd²) cos(2π τ_d μ_qd)

    with softplus-constrained weights (batch, Q), frequencies μ and
    bandwidths σ (batch, Q, 1, d). Plain torch, as the JAX package leaves it
    to XLA; the sum runs over the mixtures and features one (batch, n, m)
    term at a time (the JAX kernel broadcasts a (batch, Q, n, m, d) array),
    which adds the same terms."""

    def __init__(self, num_mixtures: int = 4, ard_num_dims: int = 1,
                 batch_shape=1, active_dims=None, seed: int = 0,
                 dtype=torch.float32, device="cuda", **_):
        super().__init__()
        self._setup(batch_shape, active_dims)
        dev = resolve_device(device)
        self.num_mixtures = int(num_mixtures)
        d = int(ard_num_dims)
        rng = np.random.default_rng(seed)
        init = constraints.inv_softplus(torch.tensor(1.0, dtype=dtype))
        B, Q = self.batch, self.num_mixtures
        self.register_raw("raw_mixture_weights", init.expand(B, Q), dtype, dev)
        self.register_raw("raw_mixture_means", constraints.inv_softplus(
            torch.as_tensor(rng.random((B, Q, 1, d)) + 0.1, dtype=dtype)),
            dtype, dev)
        self.register_raw("raw_mixture_scales", init.expand(B, Q, 1, d),
                          dtype, dev)

    @property
    def mixture_weights(self):
        return constraints.softplus(self.raw_mixture_weights)

    @property
    def mixture_means(self):
        return constraints.softplus(self.raw_mixture_means)

    @property
    def mixture_scales(self):
        return constraints.softplus(self.raw_mixture_scales)

    def _set_raw(self, means, scales, weights):
        """Write the raw leaves from positive (float64 numpy) values, each
        cast to the leaf's dtype before its inverse softplus, as the JAX
        package does."""
        with torch.no_grad():
            for name, value in (("raw_mixture_means", means),
                                ("raw_mixture_scales", scales),
                                ("raw_mixture_weights", weights)):
                leaf = getattr(self, name)
                leaf.copy_(constraints.inv_softplus(torch.as_tensor(
                    value, dtype=leaf.dtype)))
        return self

    @staticmethod
    def _train_inputs(train_x, dtype=None):
        x = np.atleast_2d(np.asarray(train_x, dtype))
        return x.T if x.shape[0] == 1 else x

    def initialize_from_data(self, train_x, train_y, seed: int = 0):
        """gpytorch 1.11's ``initialize_from_data`` heuristic, in numpy
        float64 with draws from ``default_rng(seed)`` (so the leaves equal
        the JAX package's): means ~ U(0, 0.5/min spacing) (below Nyquist),
        scales = 1/(|N(0, 1)|·data range), weights = std(y)/Q. In place;
        returns the kernel."""
        x = self._train_inputs(train_x)
        y = np.asarray(train_y)
        d = x.shape[-1] if self.active_dims is None else len(self.active_dims)
        if self.active_dims is not None:
            x = x[:, list(self.active_dims)]
        xs = np.sort(x, axis=0)
        diffs = np.diff(xs, axis=0)
        min_dist = np.where(diffs > 0, diffs, np.inf).min(axis=0)
        min_dist = np.where(np.isfinite(min_dist), min_dist, 1.0)
        max_dist = np.maximum(xs[-1] - xs[0], 1e-6)
        rng = np.random.default_rng(seed)
        Q, B = self.num_mixtures, self.batch
        means = rng.random((B, Q, 1, d)) * (0.5 / min_dist)
        scales = 1.0 / np.maximum(
            np.abs(rng.standard_normal((B, Q, 1, d))) * max_dist, 1e-8)
        weights = np.full((B, Q), y.std() / Q)
        return self._set_raw(np.maximum(means, 1e-6), scales,
                             np.maximum(weights, 1e-6))

    def initialize_from_data_empspect(self, train_x, train_y, seed: int = 0):
        """Empirical-spectrum init (gpytorch ``initialize_from_data_empspect``),
        in numpy float64: the means at the Q largest periodogram peaks of the
        series resampled onto a regular grid, the bandwidths at the frequency
        resolution, the weights at the peaks' share of var(y). For one
        regularly sampled feature; otherwise :meth:`initialize_from_data`.
        In place; returns the kernel."""
        x = self._train_inputs(train_x, np.float64)
        y = np.asarray(train_y, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        d = x.shape[-1] if self.active_dims is None else len(self.active_dims)
        if d != 1:
            return self.initialize_from_data(train_x, train_y, seed=seed)
        xs = x[:, 0] if self.active_dims is None else x[:, self.active_dims[0]]
        order = np.argsort(xs)
        xs, y = xs[order], y[order]
        dt = float(np.median(np.diff(xs)))
        if dt <= 0:
            return self.initialize_from_data(train_x, train_y, seed=seed)
        grid = np.arange(xs[0], xs[-1] + 0.5 * dt, dt)
        yg = np.stack([np.interp(grid, xs, y[:, t]) for t in range(y.shape[1])],
                      axis=1)
        yc = yg - yg.mean(axis=0)
        power = (np.abs(np.fft.rfft(yc, axis=0)) ** 2).sum(axis=1)
        freqs = np.fft.rfftfreq(len(grid), dt)
        Q, B = self.num_mixtures, self.batch
        top = np.argsort(power[1:])[::-1][:Q] + 1          # skip DC
        if len(top) < Q:                                   # tiny series
            return self.initialize_from_data(train_x, train_y, seed=seed)
        means = np.tile(freqs[top][None, :, None, None], (B, 1, 1, 1))
        scales = np.full((B, Q, 1, 1), freqs[1] - freqs[0])
        w = power[top] / power[top].sum() * y.var(axis=0).mean()
        weights = np.tile(w[None, :], (B, 1))
        return self._set_raw(np.maximum(means, 1e-12),
                             np.maximum(scales, 1e-12),
                             np.maximum(weights, 1e-12))

    def forward(self, x1, x2=None, diag: bool = False, out_dtype=None,
                rows=None):
        x1, x2 = self._inputs(x1, x2)
        if not diag:
            x1 = self._rows_of(x1, rows)
        w = self.mixture_weights                            # (B, Q)
        mu = self.mixture_means[:, :, 0, :]                 # (B, Q, d)
        sig = self.mixture_scales[:, :, 0, :]
        if diag:
            n = min(x1.shape[-2], x2.shape[-2])
            # (1, n, d), or (B, 1, n, d) for per-batch inputs
            tau = (x1[..., :n, :] - x2[..., :n, :]).unsqueeze(-3)
            comp = (torch.exp(-2 * math.pi ** 2 * tau ** 2
                              * sig[..., None, :] ** 2)
                    * torch.cos(2 * math.pi * tau * mu[..., None, :])
                    ).prod(-1)                              # (B, Q, n)
            K = (w[..., None] * comp).sum(-2)
        else:
            K = 0.0
            for q in range(self.num_mixtures):
                comp = w[:, q, None, None]
                for j in range(x1.shape[-1]):
                    # (n, m), or (B, n, m) for per-batch inputs
                    tau = x1[..., :, j, None] - x2[..., None, :, j]
                    s, m = sig[:, q, j, None, None], mu[:, q, j, None, None]
                    comp = comp * (torch.exp(-2 * math.pi ** 2 * tau ** 2
                                             * s ** 2)
                                   * torch.cos(2 * math.pi * tau * m))
                K = K + comp
        return K if out_dtype is None else K.to(out_dtype)


class ScaleKernel(Kernel):
    """k(x, y) = s_b · k_base(x, y) with a positive outputscale per batch
    element (gpytorch ScaleKernel)."""

    def __init__(self, base_kernel, batch_shape=None, dtype=torch.float32):
        super().__init__()
        self.base_kernel = base_kernel
        self._setup(base_kernel.batch if batch_shape is None else batch_shape,
                    None)
        init = constraints.inv_softplus(torch.tensor(1.0, dtype=dtype))
        self.register_raw("raw_outputscale", init.expand(self.batch), dtype,
                          base_kernel.device)

    @property
    def has_lengthscale(self):
        return self.base_kernel.has_lengthscale

    @property
    def outputscale(self):
        return constraints.softplus(self.raw_outputscale)

    @property
    def lengthscale(self):
        return self.base_kernel.lengthscale

    def set_lengthscale(self, value):
        """The base kernel's ``set_lengthscale`` (in place); returns the
        Scale kernel. Raises AttributeError when the base kernel has no
        lengthscale (it has no ``set_lengthscale``), as the JAX one does."""
        self.base_kernel.set_lengthscale(value)
        return self

    def forward(self, x1, x2=None, diag: bool = False, out_dtype=None,
                rows=None):
        K = self.base_kernel(x1, x2, diag=diag,
                             **({} if rows is None else dict(rows=rows)))
        s = self.outputscale
        K = K * (s[:, None] if diag else s[:, None, None])
        return K if out_dtype is None else K.to(out_dtype)

    def prior_log_prob(self):
        return self.base_kernel.prior_log_prob()

    def sub_kernels(self):
        return [self.base_kernel]


class AdditiveKernel(Kernel):
    """Sum of kernels: the additive ``decomp`` composition
    (projected_lmc.py:159-162, a sum of ScaleKernels over feature groups).
    The sum is plain torch; each stationary group is K3 on the card, on its
    sliced inputs. Its leaves are named ``kernels.<i>.…``, which
    ``module.keyed_state`` gives as the JAX key path ``kernels[<i>].…``."""

    def __init__(self, kernels):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)
        self._setup(kernels[0].batch, None)

    def forward(self, x1, x2=None, diag: bool = False, out_dtype=None,
                rows=None):
        kw = {} if rows is None else dict(rows=rows)
        K = self.kernels[0](x1, x2, diag=diag, **kw)
        for k in self.kernels[1:]:
            K = K + k(x1, x2, diag=diag, **kw)
        return K if out_dtype is None else K.to(out_dtype)

    def prior_log_prob(self):
        total = self.kernels[0].prior_log_prob()
        for k in self.kernels[1:]:
            total = total + k.prior_log_prob()
        return total

    def sub_kernels(self):
        return list(self.kernels)


KERNEL_REGISTRY = {
    "rbf": RBFKernel,
    "matern": MaternKernel,
    "spline": SplineKernel,
    "spectral_mixture": SpectralMixtureKernel,
}


def _group_priors(decomp, prior_scales, prior_width):
    """Per group: (its lengthscale prior, its prior-mean lengthscales), a
    Normal prior for one feature and a diagonal MVN for several, of mean
    ``prior_scales`` and deviation-to-mean ratio ``prior_width`` (a list of
    one entry per group, or an array over the features)."""
    if prior_scales is None:
        return [(None, None)] * len(decomp)
    if prior_width is None:
        raise ValueError("A prior width should be provided if a prior mean is")
    ps = prior_scales if isinstance(prior_scales, list) else \
        [np.asarray(prior_scales)[g] for g in decomp]
    pw = prior_width if isinstance(prior_width, list) else \
        [np.asarray(prior_width)[g] for g in decomp]
    out = []
    for g, scales, width in zip(decomp, ps, pw):
        loc = np.atleast_1d(np.asarray(scales, np.float64))
        width = np.atleast_1d(np.asarray(width, np.float64))
        prior = MultivariateNormalPrior(loc, loc * width) if len(g) > 1 \
            else NormalPrior(loc, loc * width)
        out.append((prior, scales))
    return out


def handle_covar(kernel_type, dim: int, decomp=None, n_funcs: int = 1,
                 prior_scales=None, prior_width=None, outputscales: bool = True,
                 ker_kwargs=None, dtype=torch.float32, device="cuda"):
    """Kernel factory mirroring ``handle_covar_`` (projected_lmc.py:107-181).

    ``decomp=[[0, 1], [1, 2]]`` builds k1(x0, x1) + k2(x1, x2), one
    ``ScaleKernel(kernel_type(active_dims=g))`` per group (an
    :class:`AdditiveKernel`); one group (the default, all ``dim`` features)
    gives the kernel itself, Scale-wrapped when ``outputscales``. Each
    kernel has ``n_funcs`` batch copies. Lengthscale priors are Normal
    (1-feature groups) or diagonal-MVN (larger groups) with mean
    ``prior_scales`` and deviation-to-mean ratio ``prior_width``; when
    given, lengthscales start at the prior mean."""
    if ker_kwargs is None:
        ker_kwargs = {}
    if isinstance(kernel_type, str):
        kernel_type = KERNEL_REGISTRY[kernel_type]
    decomp = [list(range(dim))] if decomp is None else [list(g)
                                                        for g in decomp]
    kernels = []
    for g, (prior, scales) in zip(decomp, _group_priors(decomp, prior_scales,
                                                         prior_width)):
        ker = kernel_type(ard_num_dims=len(g), active_dims=g,
                          batch_shape=n_funcs, dtype=dtype, device=device,
                          **ker_kwargs)
        if ker.has_lengthscale:
            ker.lengthscale_prior = prior
            if scales is not None:
                ker.set_lengthscale(np.atleast_1d(scales))
        kernels.append(ker)
    if len(decomp) > 1:
        return AdditiveKernel([ScaleKernel(k, dtype=dtype) for k in kernels])
    return ScaleKernel(kernels[0], dtype=dtype) if outputscales else kernels[0]
