"""Carry a JAX model's state into the port.

``projected_lmc_tpu/utils/checkpoint.save_model`` writes every leaf of a
model under its pytree key path (e.g. ``.covar_module.raw_lengthscale``).
The port keeps the same raw leaves under the same names, so those arrays —
a loaded ``.npz`` or a dict of numpy arrays — load straight into a port
model built with the same constructor arguments.
"""

from __future__ import annotations

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
