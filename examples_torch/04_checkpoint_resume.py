"""Checkpoint / resume: survive a preemption mid-training.

The PyTorch/CUDA counterpart of ``examples/04_checkpoint_resume.py``.
``fit(checkpoint_every=..., checkpoint_path=...)`` saves the in-training
model as a key-path-keyed .npz (the JAX package's format) every N
iterations and at the end; ``load_model`` restores it into a structurally
identical template (loud on any mismatch — leaves are matched by key path,
never by position). Runs on the card; with ``--cpu`` on the CPU with the
kernels' plain versions:

    python examples_torch/04_checkpoint_resume.py
    python examples_torch/04_checkpoint_resume.py --cpu
"""
import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import projected_lmc_tpu_torch as pl
from projected_lmc_tpu_torch.training import fit
from projected_lmc_tpu_torch.utils import ensure_cuda
from projected_lmc_tpu_torch.utils.checkpoint import load_model
from projected_lmc_tpu_torch.utils.device import resolve_device

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain versions")
device = resolve_device("cpu" if parser.parse_args().cpu else "cuda")
if device.type == "cuda":                 # raises above when there is no card
    t0 = time.perf_counter()
    ensure_cuda()
    print(f"kernel library loaded in {time.perf_counter() - t0:.3f} s")

rng = np.random.default_rng(0)
n, d, p, q = 200, 2, 5, 2
X = rng.standard_normal((n, d)).astype(np.float32)
F = np.stack([np.sin(X @ w) for w in rng.standard_normal((q, d))], axis=1)
H = rng.standard_normal((q, p)).astype(np.float32)
Y = (F @ H + 0.05 * rng.standard_normal((n, p))).astype(np.float32)


def mll_loss(model):
    with torch.no_grad():
        return float(-pl.projected_lmc_mll(model))


with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "plmc_ckpt.npz")

    # phase 1: train 300 iters, checkpointing every 100
    model = pl.ProjectedGPModel(X, Y, p, q, init_lmc_coeffs=True,
                                kernel_type="matern", BDN=True, scalar_B=True,
                                device=device)
    model, info = fit(model, pl.projected_lmc_mll, n_iter=300, lr=2e-2,
                      patience=10_000, checkpoint_every=100,
                      checkpoint_path=path, device=device)
    # info['loss'] is the last in-loop evaluation (pre-update); recompute on
    # the returned (post-update) model for an exact comparison with the
    # checkpoint
    loss_after_300 = mll_loss(model)
    print(f"phase 1: {info['n_iter']} iters, loss {loss_after_300:.5f}, "
          f"checkpoint at {path}")

    # --- simulated preemption: a fresh process builds the SAME template and
    # restores the learned state from disk -----------------------------------
    template = pl.ProjectedGPModel(X, Y, p, q, init_lmc_coeffs=True,
                                   kernel_type="matern", BDN=True,
                                   scalar_B=True, device=device)
    restored = load_model(template, path)
resumed_loss = mll_loss(restored)
print(f"restored: loss {resumed_loss:.5f} "
      f"(matches phase-1 final: {abs(resumed_loss - loss_after_300) < 1e-4})")

# phase 2: continue training from the restored state
restored, info2 = fit(restored, pl.projected_lmc_mll, n_iter=300, lr=5e-3,
                      patience=10_000, device=device)
print(f"phase 2: loss {info2['loss']:.5f} "
      f"(improved: {info2['loss'] <= resumed_loss + 1e-6})")

with torch.no_grad():
    mean, _ = restored.predict(torch.as_tensor(X, device=device))
rmse = float(np.sqrt(np.mean((mean.cpu().numpy() - F @ H) ** 2)))
print(f"rmse vs noiseless truth: {rmse:.4f}")
