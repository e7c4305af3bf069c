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

``save_orbax``/``load_orbax`` are the counterparts of the JAX package's
sharded checkpoints. Their format is ``torch.distributed.checkpoint``
(DCP), not orbax: the ``.npz`` of ``save_model`` stays the format both
packages read.
"""

from __future__ import annotations

import contextlib
import os
import warnings

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


def _dcp_state(model):
    """{JAX key path: tensor} of the leaves that carry state: zero-size
    leaves (parameterless modules' placeholders) are left out, as the JAX
    package leaves them out of its orbax checkpoints."""
    return {k: t.detach() for k, t in keyed_state(model).items()
            if t.numel() > 0}


@contextlib.contextmanager
def _single_process_quiet():
    """Silence DCP's notice that, with no process group, it runs in one
    process (which is what is meant)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*assuming the intent is")
        yield


def save_orbax(model, path: str):
    """Save ``model`` as a ``torch.distributed.checkpoint`` directory at
    ``path``, keyed by JAX key path. Works with and without an initialized
    process group; under one, every rank calls it (the parameters are
    replicated, so one copy is written)."""
    import torch.distributed.checkpoint as dcp
    with _single_process_quiet():
        dcp.save(_dcp_state(model), checkpoint_id=os.path.abspath(path))


def load_orbax(template, path: str):
    """Load a checkpoint written by :func:`save_orbax` into ``template`` (a
    model built with the same constructor arguments), in place; zero-size
    leaves keep the template's. Under a process group every rank calls it.
    Returns ``template``."""
    import torch.distributed.checkpoint as dcp
    state = _dcp_state(template)
    with _single_process_quiet():
        dcp.load(state, checkpoint_id=os.path.abspath(path))
    return template
