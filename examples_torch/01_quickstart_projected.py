"""Quickstart: train a Projected-LMC model on synthetic multitask data.

The PyTorch/CUDA counterpart of ``examples/01_quickstart_projected.py``:
generate q latent GPs mixed to p tasks (the reference's
experiments.py:136-170 setup), train the paper's projected model, and check
calibration. Runs on the card (the CUDA kernels, built on first use); with
``--cpu`` on the CPU with the kernels' plain versions:

    python examples_torch/01_quickstart_projected.py
    python examples_torch/01_quickstart_projected.py --cpu
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import projected_lmc_tpu_torch as pl
from projected_lmc_tpu_torch.experiments.synthetic import generate_synthetic
from projected_lmc_tpu_torch.training import fit
from projected_lmc_tpu_torch.utils import ensure_cuda
from projected_lmc_tpu_torch.utils.device import resolve_device

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--cpu", action="store_true",
                    help="run on the CPU with the kernels' plain versions")
device = resolve_device("cpu" if parser.parse_args().cpu else "cuda")
if device.type == "cuda":                 # raises above when there is no card
    t0 = time.perf_counter()
    ensure_cuda()
    print(f"kernel library loaded in {time.perf_counter() - t0:.3f} s")

data = generate_synthetic(n=300, p=12, q=3, q_noise=3, mu_noise=0.1,
                          mu_str=0.9, max_scale=0.5, n_test=400, seed=0)
X, Y, Xt, Yt = data["X"], data["Y"], data["X_test"], data["Y_test"]

model = pl.ProjectedGPModel(
    X, Y, n_tasks=Y.shape[1], n_latents=3, init_lmc_coeffs=True,
    kernel_type="matern", BDN=False, diagonal_B=False, scalar_B=False,
    device=device)

model, info = fit(model, pl.projected_lmc_mll, n_iter=2000, lr=1e-2,
                  patience=200, loss_thresh=2.5e-6, device=device)
print(f"trained {info['n_iter']} iters, final loss {info['loss']:.4f}")

with torch.no_grad():
    mean, var = model.predict(torch.as_tensor(Xt, device=device),
                              observed=True)
metrics = pl.compute_metrics(
    Yt, mean, torch.sqrt(var), loss=info["loss"],
    H_guess_hid=np.zeros((1, Y.shape[1])), n_iter=info["n_iter"],
    train_time=info.get("train_time", 0.0), pred_time=0.0,
    print_metrics=False)
print(f"R2={metrics['R2']:.3f}  RMSE={metrics['RMSE']:.3f}  "
      f"alpha_CI={metrics['alpha_CI']:.3f} (target ~0.95)  "
      f"PVA={metrics['PVA']:.2f} (optimum 0)")

# model introspection (projected_lmc.py parity surface)
with torch.no_grad():
    print("latent noises:",
          model.projected_noise().cpu().numpy().round(4))
print("lengthscales:", np.asarray(model.lscales()).round(3))
