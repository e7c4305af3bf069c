"""Stationary kernels and the kernel factory (port of the main-path subset of
``projected_lmc_tpu/kernels.py``).

Every kernel is batched over a leading ``n_funcs`` dimension (latents) and
returns (n_funcs, n, m). Dense evaluations go through
:func:`stationary_kernel_matrix`, whose forward is kernel K3 on the card
(``ops.cuda_kernels.kernel_matrix``) and whose backward is the JAX package's
hand-written ``_skm_bwd`` in plain torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

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
    def forward(ctx, x1, x2, ls, kind, out_dtype, device):
        # centred inputs (translation invariance, exact): the backward's
        # distance expansion stays safe for large-offset features
        mu = x1.mean(0)
        x1c, x2c = x1 - mu, x2 - mu
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
        return (dx1.to(x1c.dtype), dx2.to(x2c.dtype),
                dls[:, None, :].to(ls.dtype), None, None, None)


def stationary_kernel_matrix(x1, x2, ls, kind: str, out_dtype=None,
                             device="cuda"):
    """K_b = g(|x1/l_b − x2/l_b|²), (B, n, m), for inputs x1 (n, d) and
    x2 (m, d) shared across the lengthscale batch (B, 1, d). Custom backward:
    one elementwise pass over the cotangent plus matvec-sized contractions
    (the JAX package's ``_skm_bwd``), no autodiff through the profile."""
    return _StationaryKernelMatrix.apply(x1, x2, ls, kind, out_dtype, device)


class NormalPrior:
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


class MultivariateNormalPrior:
    """Diagonal-covariance MVN lengthscale prior (multi-feature groups)."""

    def __init__(self, loc, variance_diag):
        self.loc = np.asarray(loc, dtype=np.float64)
        self.var = np.asarray(variance_diag, dtype=np.float64)

    def log_prob(self, value):
        loc = torch.as_tensor(self.loc, dtype=value.dtype, device=value.device)
        var = torch.as_tensor(self.var, dtype=value.dtype, device=value.device)
        return (-0.5 * (value - loc) ** 2 / var - 0.5 * torch.log(var)
                - 0.5 * math.log(2 * math.pi)).sum()


class _StationaryKernel(Module):
    """Stationary kernel with an ARD lengthscale of shape (batch, 1, d)."""

    _kind = None   # profile name in ops.cuda_kernels.KINDS

    def __init__(self, ard_num_dims=1, batch_shape=1, active_dims=None,
                 lengthscale_prior=None, dtype=torch.float32, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.batch = int(batch_shape)
        self.active_dims = tuple(active_dims) if active_dims is not None \
            else None
        d = int(ard_num_dims) if ard_num_dims else 1
        init = constraints.inv_softplus(torch.tensor(1.0, dtype=dtype))
        self.register_raw("raw_lengthscale", init.expand(self.batch, 1, d),
                          dtype, dev)
        self.lengthscale_prior = lengthscale_prior

    @property
    def device(self):
        return self.raw_lengthscale.device

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

    def forward(self, x1, x2=None, diag: bool = False, out_dtype=None):
        """k(x1, x2) on inputs shared by the batch, (n, d) or 1-D (one
        feature): dense (batch, n, m) through
        :func:`stationary_kernel_matrix` (kernel K3 on the card), or with
        ``diag`` the (batch, min(n, m)) diagonal k(x1_i, x2_i), in plain
        torch as the JAX package leaves it to XLA."""
        x2 = x1 if x2 is None else x2
        x1, x2 = (x[:, None] if x.dim() == 1 else x for x in (x1, x2))
        if x1.dim() != 2 or x2.dim() != 2:
            raise NotImplementedError("batched 3-D kernel inputs are ported "
                                      "in a later slice")
        if self.active_dims is not None:
            idx = list(self.active_dims)
            x1, x2 = x1[:, idx], x2[:, idx]
        if diag:
            n = min(x1.shape[0], x2.shape[0])
            d2 = (((x1[:n] - x2[:n])[None] / self.lengthscale) ** 2).sum(-1)
            K = ck.profile(self._kind, d2)
            return K if out_dtype is None else K.to(out_dtype)
        return stationary_kernel_matrix(x1, x2, self.lengthscale, self._kind,
                                        out_dtype, self.device)

    def prior_log_prob(self):
        """Sum of the hyperparameter priors' log-probabilities."""
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


class ScaleKernel(Module):
    """k(x, y) = s_b · k_base(x, y) with a positive outputscale per batch
    element (gpytorch ScaleKernel)."""

    def __init__(self, base_kernel, batch_shape=None, dtype=torch.float32):
        super().__init__()
        self.base_kernel = base_kernel
        self.batch = base_kernel.batch if batch_shape is None \
            else int(batch_shape)
        self.active_dims = None
        init = constraints.inv_softplus(torch.tensor(1.0, dtype=dtype))
        self.register_raw("raw_outputscale", init.expand(self.batch), dtype,
                          base_kernel.device)

    @property
    def outputscale(self):
        return constraints.softplus(self.raw_outputscale)

    @property
    def lengthscale(self):
        return self.base_kernel.lengthscale

    def forward(self, x1, x2=None, diag: bool = False, out_dtype=None):
        K = self.base_kernel(x1, x2, diag=diag)
        s = self.outputscale
        K = K * (s[:, None] if diag else s[:, None, None])
        return K if out_dtype is None else K.to(out_dtype)

    def prior_log_prob(self):
        return self.base_kernel.prior_log_prob()


KERNEL_REGISTRY = {
    "rbf": RBFKernel,
    "matern": MaternKernel,
}


def handle_covar(kernel_type, dim: int, decomp=None, n_funcs: int = 1,
                 prior_scales=None, prior_width=None, outputscales: bool = True,
                 ker_kwargs=None, dtype=torch.float32, device="cuda"):
    """Kernel factory mirroring ``handle_covar_`` (projected_lmc.py:107-181),
    single-group branch: one (optionally Scale-wrapped) stationary kernel over
    the ``dim`` features with ``n_funcs`` batch copies. Normal (1 feature) or
    diagonal-MVN lengthscale priors with mean ``prior_scales`` and
    deviation-to-mean ratio ``prior_width``; lengthscales start at the prior
    mean."""
    if ker_kwargs is None:
        ker_kwargs = {}
    if isinstance(kernel_type, str):
        kernel_type = KERNEL_REGISTRY[kernel_type]
    if decomp is not None and len(decomp) > 1:
        raise NotImplementedError("additive kernel decompositions are ported "
                                  "in a later slice")
    group = list(decomp[0]) if decomp is not None else list(range(dim))
    prior, scales = None, None
    if prior_scales is not None:
        if prior_width is None:
            raise ValueError("A prior width should be provided if a prior "
                             "mean is")
        scales = prior_scales[0] if isinstance(prior_scales, list) \
            else np.asarray(prior_scales)[group]
        width = prior_width[0] if isinstance(prior_width, list) \
            else np.asarray(prior_width)[group]
        loc = np.atleast_1d(np.asarray(scales, np.float64))
        width = np.atleast_1d(np.asarray(width, np.float64))
        prior = MultivariateNormalPrior(loc, loc * width) if len(group) > 1 \
            else NormalPrior(loc, loc * width)
    ker = kernel_type(ard_num_dims=len(group), active_dims=group,
                      batch_shape=n_funcs, dtype=dtype, device=device,
                      **ker_kwargs)
    ker.lengthscale_prior = prior
    if scales is not None:
        ker.set_lengthscale(np.atleast_1d(scales))
    return ScaleKernel(ker, dtype=dtype) if outputscales else ker
