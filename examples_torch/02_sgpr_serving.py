"""Serving pattern: SGPR projected-LMC with an amortized prediction cache.

The PyTorch/CUDA counterpart of ``examples/02_sgpr_serving.py``. Large-n
training data with m inducing points (the Titsias SGPR path of
projected_lmc.py:302-303), then low-latency batched prediction: the
training system is factorized ONCE by ``model.prediction_cache()`` and
reused across serving batches — per-batch work is only the n*×m
cross-covariance and solves. Runs on the card; with ``--cpu`` on the CPU
with the kernels' plain versions:

    python examples_torch/02_sgpr_serving.py
    python examples_torch/02_sgpr_serving.py --cpu
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import projected_lmc_tpu_torch as pl
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


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize(device)


rng = np.random.default_rng(0)
n, d, p, q, m = 4000, 4, 6, 3, 128
X = rng.standard_normal((n, d)).astype(np.float32)
F = np.stack([np.sin(X @ w) for w in rng.standard_normal((q, d))], axis=1)
H = rng.standard_normal((q, p)).astype(np.float32)
Y = (F @ H + 0.05 * rng.standard_normal((n, p))).astype(np.float32)

model = pl.ProjectedGPModel(X, Y, p, q, init_lmc_coeffs=True,
                            kernel_type="matern", BDN=True, scalar_B=True,
                            diagonal_B=True, n_inducing_points=m,
                            device=device)
model, info = fit(model, pl.projected_lmc_mll, n_iter=400, lr=2e-2,
                  patience=100, device=device)
print(f"trained {info['n_iter']} iters, loss {info['loss']:.4f}")

# --- serving: factorize once, reuse per batch -------------------------------
with torch.no_grad():
    t0 = time.perf_counter()
    cache = model.prediction_cache()
    sync()
    print(f"prediction cache: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for batch in range(3):
        Xb = rng.standard_normal((256, d)).astype(np.float32)
        t0 = time.perf_counter()
        mean, var = model.predict(torch.as_tensor(Xb, device=device),
                                  observed=True, cache=cache)
        sync()
        print(f"batch {batch}: mean {tuple(mean.shape)}, var "
              f"{tuple(var.shape)}, {(time.perf_counter() - t0) * 1e3:.1f} ms"
              + ("  (includes the first call's warm-up)" if batch == 0
                 else ""))

    # the cache gives the same results as the self-contained path (up to
    # fp32 reduction-order noise)
    x64 = torch.as_tensor(X[:64], device=device)
    mean0, var0 = model.predict(x64, observed=True)
    mean1, var1 = model.predict(x64, observed=True, cache=cache)
print("cache == self-contained:",
      bool(np.allclose(mean0.cpu().numpy(), mean1.cpu().numpy(),
                       rtol=1e-4, atol=1e-4)))
