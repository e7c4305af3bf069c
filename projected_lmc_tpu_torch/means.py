"""Mean functions (port of ``projected_lmc_tpu/means.py``: Zero and
Constant). Means are batched over ``n_funcs`` and map inputs (n, d) to
(n_funcs, n)."""

from __future__ import annotations

import torch

from .module import Module
from .utils.device import resolve_device


class ZeroMean(Module):
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


class ConstantMean(Module):
    def __init__(self, input_size=None, batch_shape=1, dtype=torch.float32,
                 device="cuda", **_):
        super().__init__()
        self.batch = int(batch_shape)
        self.register_raw("constant", torch.zeros((self.batch,)), dtype,
                          resolve_device(device))

    def forward(self, x):
        return self.constant[:, None].expand(self.batch, x.shape[0])


MEAN_REGISTRY = {
    "zero": ZeroMean,
    "constant": ConstantMean,
}
