"""Sharded training steps (port of
``projected_lmc_tpu/parallel/sharded.py``).

The JAX step is the plain step under ``jax.jit``: XLA partitions it over
the mesh and inserts the collectives. PyTorch has no partitioner, so the
port decomposes each model family by hand, one process a rank, each rank
running its own CUDA kernels on its shard. The rule, which every sharded
model method keeps:

  * **Leaves.** Every rank holds every parameter whole (JAX: "parameters
    stay replicated"); ``shard_model`` broadcasts them from rank 0. A rank
    computes only the terms of its shard: its latents on the latent axis,
    its rows on the data axis.
  * **Forward.** Each rank computes the full loss value. A sum across
    ranks inside the graph (the latent sum, the SGPR Gram sums RᵀR and
    Rᵀδ, the ELBO's row sum, the mixing sum Σ_b μ_b h_b) is an
    ``all_reduce`` whose backward is again an ``all_reduce`` of the
    incoming gradient (``collectives.group_sum``).
  * **Gradients.** After ``backward`` the parameters' gradients are
    averaged over all ranks with one flattened ``all_reduce``. With the
    rule above that counts once the terms that every rank computes whole
    (the projection terms, the KL, the hyper-priors, K_zz): the backward
    of W ranks' copies of the loss is W times the gradient.
  * **Blocks of shared tensors.** Where a rank takes its block of a
    tensor that every rank computes whole (the projected targets, its
    latents' rows and its data columns), the backward sums the blocks'
    gradients over all ranks and divides by their number
    (``Mesh.block``): each rank carries the whole gradient into the
    computation they share, as one process does, and its rounding; a
    gradient that one process finds exactly zero (the mixing matrix's
    columns past q) stays zero, where the sum of partial backwards would
    leave fp32 noise that AdamW's first step scales up to the learning
    rate. The averaged gradient is the same sum either way.
  * **Optimizer.** AdamW then runs identically on every rank.
  * **Row-sharded solvers** (the LMC and ICM families, ``ops/iterative``).
    The CG state is replicated: every rank runs the whole PCG on the whole
    (1+s, n, T) vectors, with the same probes (given, or drawn from a
    generator seeded alike), so that their scalars and branches agree bit
    for bit. Only the kernel stack and its products are sharded: a rank
    holds its block (its latents' rows over the data axis; the ICM's rows
    over every rank, ``mesh.RowBlock``), and each product is its rows
    zero-padded and summed over the world in one ``all_reduce`` outside
    autograd, before any sum over the latents or tasks, which every rank
    then takes in one process's order; the Nyström roots are gathered the
    same way from the ranks' rows of K(x, z). The replicated state is then
    the bits one process computes wherever the block's products are. Such an op writes its own backward: it gathers its block's
    products whole in ONE packed ``all_reduce`` (the fused op's K7 rows,
    wx and stack product; the ICM's and the Hutchinson backward's stack
    product) and runs one process's formulas on them, so that every rank
    carries the whole gradient of the replicated leaves, summed in one
    process's order; and it scales the cotangent of the rank's
    own block of the stack by the world size, the adjoint of the forward's
    world sum under the averaging above (the kernel's leaves then receive
    the sum of the blocks' terms). The one collective of a backward lies
    on the loss's chain.

Summing the gradients instead of averaging them, or letting the backward
of a group sum pass its gradient through unchanged, counts the replicated
terms once a rank; the tests hold a sharded step to an unsharded one to
catch that.
"""

from __future__ import annotations

import torch

from ..module import trainable_parameters
from ..utils.profiling import count
from .mesh import shard_model


def sharded_fit_step(model, mesh, loss_fn=None, lr: float = 1e-2,
                     weight_decay: float = 1e-2):
    """(step, model, optimizer): ``model`` sharded over ``mesh`` (in
    place), an AdamW over its trainable parameters (optax's ``adamw``
    defaults, as ``training.fit``), and ``step()``, which runs one update
    and returns the minimized value −loss_fn(model) (``loss_fn`` defaults to
    ``model.mll()``).

    JAX returns ``(step, params, opt_state, static)`` with a pure
    ``step(params, opt_state, static)``; here the model and the optimizer
    hold that state and ``step`` updates them in place."""
    if loss_fn is None:
        loss_fn = lambda m: m.mll()                         # noqa: E731
    model = shard_model(model, mesh)
    params = [p for _, p in trainable_parameters(model)]
    opt = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)

    def step():
        opt.zero_grad(set_to_none=False)
        loss = -loss_fn(model)
        loss.backward()
        average_gradients(mesh, params)
        opt.step()
        return loss.detach()

    return step, model, opt


def average_gradients(mesh, params):
    """Each parameter's gradient replaced by its mean over the ranks of
    ``mesh``, in one ``all_reduce`` (a dtype). A gradient that is None on a
    rank counts as zeros, and the mean is written to ``p.grad``; a
    parameter that no rank gave a gradient keeps None, so that the
    optimizer skips it as it would in one process."""
    if mesh.group("world") is None or not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    had = torch.tensor([float(p.grad is not None) for p in params],
                       dtype=params[0].dtype, device=params[0].device)
    mesh.average_(grads + [had])
    count("host_read")
    for p, g, h in zip(params, grads, had.tolist()):
        if p.grad is None and h > 0:
            p.grad = g


def dryrun_step(model, mesh, loss_fn=None) -> float:
    """Run ONE sharded training step, synchronize, and return its loss as a
    float (``entry.dryrun_multichip`` validates the multi-rank path with
    it)."""
    step, model, _ = sharded_fit_step(model, mesh, loss_fn)
    loss = step()
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    return float(loss)
