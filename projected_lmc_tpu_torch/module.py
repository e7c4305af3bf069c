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

import copy
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
    port of ``trainable_mask`` + ``partition``. The JAX package's
    ``combine`` has no counterpart: the optimizer updates these tensors in
    place, so the model never comes apart."""
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


def latent_slice(module: nn.Module, lo: int, hi: int, q: int) -> nn.Module:
    """A shallow copy of ``module`` and of every submodule in which each
    parameter and buffer whose leading dimension is ``q`` is its rows
    ``lo:hi`` (a view, so gradients reach the whole leaf) and each integer
    ``batch`` equal to ``q`` is ``hi - lo``: the module restricted to latents
    lo..hi − 1, as a rank of the mesh's latent axis computes them. The
    original is not changed."""
    view = copy.copy(module)

    def part(t):
        if t is not None and t.dim() > 0 and t.shape[0] == q:
            return t[lo:hi]
        return t

    view._parameters = {k: part(p) for k, p in module._parameters.items()}
    view._buffers = {k: part(b) for k, b in module._buffers.items()}
    view._modules = {k: None if m is None else latent_slice(m, lo, hi, q)
                     for k, m in module._modules.items()}
    if getattr(module, "batch", None) == q:
        view.batch = hi - lo
    return view
