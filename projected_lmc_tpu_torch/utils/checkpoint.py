"""Model checkpoints, interchangeable with the JAX package's (port of
``projected_lmc_tpu/utils/checkpoint.py``).

``save_model`` writes every leaf of a model to one ``.npz`` under its JAX
pytree key path (e.g. ``.covar_module.raw_lengthscale``,
``.covar_module.kernels[0].raw_outputscale``), as the JAX ``save_model``
does. The port keeps the same raw leaves under the same names, so such
arrays — a JAX checkpoint, a port checkpoint or a dict of numpy arrays —
load into a port model built with the same constructor arguments
(``load_jax_state``, ``load_model``), and a port checkpoint loads into the
JAX package's ``load_model``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..module import keyed_state


def load_jax_state(model, arrays):
    """Copy ``arrays`` ({JAX key path: array}, e.g. ``np.load(path)``) into
    ``model``'s parameters and buffers, in place, keeping each tensor's
    dtype and device. Raises on a missing name, an extra name or a shape
    mismatch, like the JAX ``load_model``. Returns ``model``."""
    state = keyed_state(model)
    names = list(arrays.files if hasattr(arrays, "files") else arrays)
    missing = [n for n in state if n not in names]
    extra = [n for n in names if n not in state]
    if missing or extra:
        raise ValueError(
            f"checkpoint/model mismatch — missing from checkpoint: "
            f"{missing[:5]}{'...' if len(missing) > 5 else ''}; "
            f"unknown in checkpoint: {extra[:5]}{'...' if len(extra) > 5 else ''}")
    with torch.no_grad():
        for name, t in state.items():
            arr = np.asarray(arrays[name])
            if arr.shape != tuple(t.shape):
                raise ValueError(f"shape mismatch at {name}: checkpoint "
                                 f"{arr.shape} vs model {tuple(t.shape)}")
            t.copy_(torch.tensor(arr, dtype=t.dtype))
    return model


def save_model(model, path: str):
    """Save every parameter and buffer of ``model`` to ``path`` (.npz), keyed
    by its JAX key path."""
    arrays = {k: t.detach().cpu().numpy() for k, t in keyed_state(model).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_model(template, path: str):
    """Load a checkpoint written by :func:`save_model` (or the JAX
    package's) into ``template``, a model built with the same constructor
    arguments, in place; loud on a missing or extra name or a shape
    mismatch. Returns ``template``."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return load_jax_state(template, data)
