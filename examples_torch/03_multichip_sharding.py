"""Multi-rank SPMD training over a ('data', 'latent') mesh.

The PyTorch/CUDA counterpart of ``examples/03_multichip_sharding.py``: the
latent GPs split over the 'latent' axis, kernel rows and labels over
'data', on ``torch.distributed``, one process a rank. This demo spawns 8
ranks on this host (``parallel.launch.run_ranks``) as a data 4 × latent 2
mesh. On one card the ranks share it over gloo (``parallel.initialize``'s
choice when ranks outnumber cards; a card a rank takes NCCL); with
``--cpu`` they run over gloo on the CPU with the kernels' plain versions:

    python examples_torch/03_multichip_sharding.py
    python examples_torch/03_multichip_sharding.py --cpu
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

WORLD, DATA, LATENT, STEPS = 8, 4, 2, 20


def rank_main(rank, X, Y, p, q):
    """One rank: the model sharded over the mesh, 20 AdamW steps through
    ``parallel.sharded_fit_step`` (the port's counterpart of JAX's jitted
    step), then the MLL of a fresh model unsharded and sharded."""
    import torch

    import projected_lmc_tpu_torch as pl
    from projected_lmc_tpu_torch import parallel

    device = parallel.distributed.current_device()

    def fresh():
        return pl.ProjectedGPModel(X, Y, p, q, init_lmc_coeffs=True,
                                   kernel_type="matern", BDN=True,
                                   scalar_B=True, diagonal_B=True,
                                   device=device)

    mesh = parallel.make_mesh(data=DATA, latent=LATENT)
    step, model, _ = parallel.sharded_fit_step(fresh(), mesh,
                                               pl.projected_lmc_mll)
    losses = [float(step()) for _ in range(STEPS)]

    # sharded == unsharded (up to reduction order)
    model_ref = fresh()
    with torch.no_grad():
        l0 = float(pl.projected_lmc_mll(model_ref))
        l1 = float(pl.projected_lmc_mll(parallel.shard_model(model_ref,
                                                             mesh)))
    return dict(mesh=dict(mesh.shape), backend=parallel.distributed.backend(),
                device=str(device), losses=losses, l0=l0, l1=l1)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run the ranks on the CPU with the kernels' "
                             "plain versions")
    from projected_lmc_tpu_torch.parallel.launch import run_ranks
    from projected_lmc_tpu_torch.utils import ensure_cuda
    from projected_lmc_tpu_torch.utils.device import resolve_device
    device = resolve_device("cpu" if parser.parse_args().cpu else "cuda")
    if device.type == "cuda":             # raises above when there is no card
        t0 = time.perf_counter()
        ensure_cuda()                     # the ranks load what this built
        print(f"kernel library loaded in {time.perf_counter() - t0:.3f} s")

    rng = np.random.default_rng(0)
    n, d, p, q = 512, 3, 8, 2
    X = rng.standard_normal((n, d)).astype(np.float32)
    Y = rng.standard_normal((n, p)).astype(np.float32)

    # 8 ranks on one host: one torch thread each
    t0 = time.perf_counter()
    out = run_ranks(rank_main, WORLD, args=(X, Y, p, q), device=device.type,
                    threads=1)
    wall = time.perf_counter() - t0
    r0 = out[0]
    print("mesh:", r0["mesh"], "ranks:", WORLD, f"({r0['backend']} on "
          f"{r0['device']})")
    same = all(r["losses"] == r0["losses"] for r in out)
    print(f"{STEPS} sharded steps done, loss {r0['losses'][-1]:.4f} "
          f"(every rank the same: {same}; {wall:.1f} s with the spawn)")
    l0, l1 = r0["l0"], r0["l1"]
    print(f"unsharded MLL {l0:.6f}  sharded MLL {l1:.6f}  "
          f"match: {abs(l0 - l1) < 1e-4}")


if __name__ == "__main__":                # spawned ranks re-import this file
    main()
