"""Parameter layer of the PyTorch port (port of ``projected_lmc_tpu/module.py``).

The JAX package keeps models as immutable pytrees and splits trainable from
frozen leaves with ``trainable_mask``/``partition``. Here a model is a
``torch.nn.Module``:

  * parameters are ``nn.Parameter``s holding the JAX package's RAW
    (unconstrained) leaves under the same attribute names
    (``covar_module.raw_lengthscale``, ``covar_factor``, ``raw_var``, ...);
  * the JAX ``_buffers_`` (data such as ``train_x``) are registered buffers;
  * the JAX ``_frozen_params_`` are parameters with ``requires_grad=False``.

So ``"." + name`` over ``named_parameters()`` and ``named_buffers()`` is the
JAX key path of the same leaf, which is what ``utils.checkpoint`` matches on,
once the index of a list-held submodule (``kernels.0``, an ``nn.ModuleList``)
is written as JAX writes a list index (``kernels[0]``).
"""

from __future__ import annotations

import re

import torch
from torch import nn


class Module(nn.Module):
    """nn.Module with the JAX package's frozen-parameter convention."""

    _frozen_params_: tuple = ()

    def register_raw(self, name: str, value, dtype, device):
        """Register ``value`` as parameter ``name``; trainable unless ``name``
        is in ``_frozen_params_``."""
        t = torch.as_tensor(value, dtype=dtype, device=device).clone(
            memory_format=torch.contiguous_format)
        self.register_parameter(
            name, nn.Parameter(t, requires_grad=name not in self._frozen_params_))


def trainable_parameters(module: nn.Module):
    """[(name, parameter)] of the parameters the optimizer updates — the
    port of ``trainable_mask`` + ``partition``."""
    return [(n, p) for n, p in module.named_parameters() if p.requires_grad]


def jax_key(name: str) -> str:
    """The JAX key path of the leaf torch names ``name``:
    ``covar_module.kernels.0.raw_outputscale`` →
    ``.covar_module.kernels[0].raw_outputscale``."""
    return "." + re.sub(r"\.(\d+)(?=\.|$)", r"[\1]", name)


def keyed_state(module: nn.Module) -> dict:
    """{JAX key path: tensor} over every parameter and buffer, e.g.
    ``.covar_module.raw_lengthscale``."""
    out = {jax_key(n): p for n, p in module.named_parameters()}
    out.update({jax_key(n): b for n, b in module.named_buffers()})
    return out
