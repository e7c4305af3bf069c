"""Entry points of the port (counterpart of the JAX package's
``__graft_entry__.py``).

entry(device)              -> (fn, example_args): the flagship forward step,
                              ``projected_lmc_mll`` on a tiny
                              ``ProjectedGPModel``.
dryrun_multichip(n, device) -> spawns n ranks (``parallel.launch``), builds
                              ``make_mesh(n)`` and runs, as JAX's does, one
                              sharded SGPR step (m = 8) and one sharded
                              exact step of the projected model at
                              n = 16·D, q = max(2, L); one sharded step of
                              the exact LMC's iterative MLL and one of the
                              ICM's matrix-free MLL (n = 16·D, q latents,
                              2q tasks; rank 16, 4 probes, 24 CG
                              iterations to 1e-4, bf16 products); then the
                              projected model's sharded
                              ``prediction_cache`` and ``predict`` on 8·D
                              test points and the ICM's sharded
                              ``compute_var`` on 8.
"""

from __future__ import annotations

import numpy as np


def _tiny_model(n=32, p=6, q=2, m_ind=None, dtype=np.float32,
                device="cuda"):
    """JAX's ``_tiny_model``: the full-B̃ projected model on two latent
    curves mixed into p tasks, data from ``default_rng(0)``."""
    from .models.projected import ProjectedGPModel

    rng = np.random.default_rng(0)
    X = np.linspace(-1, 1, n)[:, None].astype(dtype)
    U = np.stack([np.sin(3 * X[:, 0]), np.cos(5 * X[:, 0])][:q], axis=1)
    H = rng.standard_normal((q, p))
    Y = (U @ H + 0.05 * rng.standard_normal((n, p))).astype(dtype)
    return ProjectedGPModel(X, Y, p, q, init_lmc_coeffs=True,
                            kernel_type="matern", BDN=False, diagonal_B=False,
                            scalar_B=False, n_inducing_points=m_ind,
                            device=device)


def entry(device="cuda"):
    """(projected_lmc_mll, (model,)): the flagship forward step."""
    from .mlls import projected_lmc_mll

    return projected_lmc_mll, (_tiny_model(device=device),)


# the iterative MLLs' settings in JAX's dryrun (__graft_entry__.py)
_ITER_KW = dict(iterative=True, precond_rank=16, num_probes=4,
                max_cg_iters=24, cg_tol=1e-4, matvec_bf16=True)


def _dryrun_rank(rank, n_devices):
    """One rank of :func:`dryrun_multichip`: (SGPR loss, exact loss,
    LMC-iterative loss, ICM-iterative loss, mean of the sharded prediction,
    mean of the ICM's sharded ``compute_var``, mesh shape, backend)."""
    import torch

    from .likelihoods import MultitaskGaussianLikelihood
    from .mlls import projected_lmc_mll
    from .models.multitask import MultitaskGPModel
    from .parallel import distributed
    from .parallel.mesh import make_mesh
    from .parallel.sharded import dryrun_step

    device = distributed.current_device()
    mesh = make_mesh(n_devices)
    data_ax, latent_ax = mesh.shape["data"], mesh.shape["latent"]
    # n rows split over 'data', q latents over 'latent': the SGPR step runs
    # the row-split Gram sums, the exact step the latent split
    n = 16 * data_ax
    q = max(2, latent_ax)
    model = _tiny_model(n=n, p=2 * q + 2, q=q, m_ind=8, device=device)
    loss = dryrun_step(model, mesh, projected_lmc_mll)
    if not np.isfinite(loss):
        raise FloatingPointError(f"sharded SGPR step gave loss {loss}")
    model2 = _tiny_model(n=n, p=2 * q + 2, q=q, device=device)
    loss2 = dryrun_step(model2, mesh, projected_lmc_mll)
    if not np.isfinite(loss2):
        raise FloatingPointError(f"sharded exact step gave loss {loss2}")
    # the sharded prediction path (model2 is on the mesh since its step): a
    # cache of the rank's latents, then predict mixing them over the latent
    # group
    xt = torch.linspace(-0.9, 0.9, 8 * data_ax, dtype=torch.float32,
                        device=device)[:, None]
    with torch.no_grad():
        cache = model2.prediction_cache()
        mean, var = model2.predict(xt, observed=True, cache=cache)
    if not bool(torch.isfinite(mean).all()) or not bool((var > 0).all()):
        raise FloatingPointError("sharded predict gave a non-finite mean or "
                                 "a non-positive variance")
    # the LMC and ICM families: the row-sharded PCG (the LMC's rows over
    # 'data', its latents over 'latent'; the ICM's rows over every rank)
    rng = np.random.default_rng(1)
    X3 = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    Y3 = rng.standard_normal((n, 2 * q)).astype(np.float32)
    model3 = MultitaskGPModel(X3, Y3, n_tasks=2 * q, n_latents=q,
                              model_type="LMC", kernel_type="matern",
                              mean_type="zero", fix_diagonal=True,
                              device=device)
    loss3 = dryrun_step(model3, mesh, lambda m: m.mll(**_ITER_KW))
    if not np.isfinite(loss3):
        raise FloatingPointError(f"sharded LMC-iterative step gave {loss3}")
    lik4 = MultitaskGaussianLikelihood(num_tasks=2 * q, rank=0,
                                       device=device)
    model4 = MultitaskGPModel(X3, Y3, lik4, n_tasks=2 * q, n_latents=q,
                              model_type="ICM", kernel_type="matern",
                              mean_type="zero", seed=0, device=device)
    loss4 = dryrun_step(model4, mesh, lambda m: m.mll(**_ITER_KW))
    if not np.isfinite(loss4):
        raise FloatingPointError(f"sharded ICM-iterative step gave {loss4}")
    xs = torch.as_tensor(rng.uniform(-1, 1, (8, 2)).astype(np.float32),
                         device=device)
    with torch.no_grad():
        var_icm = model4.compute_var(xs)
    if not bool((var_icm > 0).all()):
        raise FloatingPointError("the sharded ICM compute_var gave a "
                                 "non-positive variance")
    return (loss, loss2, loss3, loss4, float(mean.mean()),
            float(var_icm.mean()), dict(mesh.shape), distributed.backend())


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0):
    """One sharded projected-LMC training step (SGPR and exact), one
    sharded step of the LMC's iterative MLL and one of the ICM's
    matrix-free MLL, the projected model's sharded prediction and the
    ICM's sharded ``compute_var``, over an ``n_devices`` mesh, one spawned
    rank a device; ranks share the card over gloo when there are fewer
    cards than ranks, and take one each over NCCL otherwise
    (``device="cpu"``: gloo on the CPU). Prints one line, as JAX's does;
    raises if any rank fails."""
    from .parallel.launch import run_ranks
    from .utils.device import resolve_device

    cpu = resolve_device(device).type == "cpu"
    out = run_ranks(_dryrun_rank, n_devices, (n_devices,), device=device,
                    timeout=timeout, threads=1 if cpu else None)
    loss, loss2, loss3, loss4, pred, var, shape, backend = out[0]
    for r, other in enumerate(out[1:], 1):
        if not np.allclose(other[:6], out[0][:6], rtol=1e-6, atol=0):
            raise RuntimeError(f"rank {r} computed {other[:6]}, rank 0 "
                               f"{out[0][:6]}: every rank must compute the "
                               f"whole values")
    print(f"dryrun_multichip({n_devices}) OK: mesh={shape} "
          f"backend={backend} sgpr_loss={loss:.4f} exact_loss={loss2:.4f} "
          f"lmc_iter_loss={loss3:.4f} icm_iter_loss={loss4:.4f} "
          f"sharded_predict_mean={pred:.4f} "
          f"sharded_icm_var_mean={var:.4f}")
