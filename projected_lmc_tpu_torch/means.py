"""Mean functions (port of ``projected_lmc_tpu/means.py``): Zero, Constant
and the reference's Linear and Polynomial means (projected_lmc.py:37-81).
Means are batched over ``n_funcs`` and map inputs (n, d) to (n_funcs, n).
A mean with a ``basis_matrix`` serves the universal-kriging LOO
(``ExactGPModel.compute_loo(complex_mean=True)``)."""

from __future__ import annotations

import numpy as np
import torch

from .module import Module
from .utils.device import resolve_device


class Mean(Module):
    """Base of the means: ``forward(x)`` maps inputs (n, d) to (batch, n);
    a mean without regressors has no ``basis_matrix`` (reading it raises
    AttributeError, so ``hasattr`` is False)."""

    def forward(self, x):
        raise NotImplementedError

    @property
    def basis_matrix(self):
        raise AttributeError(f"{type(self).__name__} has no basis_matrix")


class ZeroMean(Mean):
    def __init__(self, input_size=None, batch_shape=1, dtype=torch.float32,
                 device="cuda", **_):
        super().__init__()
        self.batch = int(batch_shape)
        # the JAX module's empty placeholder leaf, kept so that key paths match
        self.register_buffer("_dummy", torch.zeros((0,), dtype=dtype,
                                                    device=resolve_device(device)))

    def forward(self, x):
        return torch.zeros((self.batch, x.shape[0]), dtype=self._dummy.dtype,
                           device=self._dummy.device)


class ConstantMean(Mean):
    def __init__(self, input_size=None, batch_shape=1, dtype=torch.float32,
                 device="cuda", **_):
        super().__init__()
        self.batch = int(batch_shape)
        self.register_raw("constant", torch.zeros((self.batch,)), dtype,
                          resolve_device(device))

    def forward(self, x):
        return self.constant[:, None].expand(self.batch, x.shape[0])


class LinearMean(Mean):
    """Affine mean x W_b + c_b (projected_lmc.py:65-81): weights (B, d, 1)
    and, with ``bias``, a bias (B, 1), drawn from N(0, 1) by
    ``default_rng(seed)`` as the JAX package draws them. ``basis_matrix``
    is [x, 1], the universal-kriging LOO's regressors."""

    def __init__(self, input_size, batch_shape=1, bias: bool = True,
                 seed: int = 0, dtype=torch.float32, device="cuda", **_):
        super().__init__()
        dev = resolve_device(device)
        self.batch = int(batch_shape)
        rng = np.random.default_rng(seed)
        self.register_raw("weights", rng.standard_normal(
            (self.batch, int(input_size), 1)), dtype, dev)
        if bias:
            self.register_raw("bias", rng.standard_normal((self.batch, 1)),
                              dtype, dev)
        else:
            self.bias = None

    def forward(self, x):
        res = (x[None] @ self.weights)[..., 0]              # (B, n)
        return res if self.bias is None else res + self.bias

    def basis_matrix(self, x):
        return torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype,
                                        device=x.device)], 1)


class PolynomialMean(Mean):
    """Degree-``degree`` polynomial mean Σ_{i≥1} (x^i) W_{i,b} + c_b with
    per-degree weights (degree + 1, B, d, 1) (projected_lmc.py:37-63; the
    degree-0 weights are drawn but unused, as in the reference) and, with
    ``bias``, a bias (B, 1), from ``default_rng(seed)``. It has no basis
    matrix."""

    def __init__(self, input_size, batch_shape=1, bias: bool = True,
                 degree: int = 3, seed: int = 0, dtype=torch.float32,
                 device="cuda", **_):
        super().__init__()
        dev = resolve_device(device)
        self.batch = int(batch_shape)
        self.degree = int(degree)
        rng = np.random.default_rng(seed)
        self.register_raw("weights", rng.standard_normal(
            (self.degree + 1, self.batch, int(input_size), 1)), dtype, dev)
        if bias:
            self.register_raw("bias", rng.standard_normal((self.batch, 1)),
                              dtype, dev)
        else:
            self.bias = None

    def forward(self, x):
        res = torch.zeros((self.batch, x.shape[0]), dtype=x.dtype,
                          device=x.device)
        for i in range(1, self.degree + 1):
            res = res + ((x ** i)[None] @ self.weights[i])[..., 0]
        return res if self.bias is None else res + self.bias


MEAN_REGISTRY = {
    "zero": ZeroMean,
    "constant": ConstantMean,
    "linear": LinearMean,
    "polynomial": PolynomialMean,
}
