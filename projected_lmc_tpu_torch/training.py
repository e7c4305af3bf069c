"""Training loop with plateau early stopping (port of ``training.fit`` with
its chunks, checkpoints and evals, ``training.fit_two_phase``,
``training.fit_svgp_minibatch``, ``training.fit_ensemble`` and the
learning-rate schedules from ``projected_lmc_tpu/training.py``).

The reference's loop (experiments.py:256-284): AdamW, LambdaLR linear decay
lr_max → lr_min over 10k iterations, and plateau stopping — |1 − loss /
last_loss| < thresh for ``patience`` consecutive iterations ('max') or on a
rolling mean ('mean'). PyTorch runs eagerly, so one step is a forward, a
backward and an AdamW update; the plateau test reads each loss on the host.
"""

from __future__ import annotations

import inspect
import time
from typing import Callable

import numpy as np
import torch

from .module import keyed_state, trainable_parameters
from .parallel.sharded import average_gradients
from .utils.device import check_device
from .utils.profiling import count, span


def _loss_fn_takes_generator(loss_fn) -> bool:
    """True if ``loss_fn``'s second positional argument is named
    ``generator`` or ``rng``."""
    try:
        params = list(inspect.signature(loss_fn).parameters.values())
    except (TypeError, ValueError):
        return False
    positional = [p for p in params if p.kind in
                  (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 2 and positional[1].name in ("generator", "rng")


def lambda_lr_schedule(lr_max: float = 1e-2, lr_min: float = 1e-3,
                       last_epoch: int = 10000):
    """LambdaLR of experiments.py:84: the learning rate at step i, decaying
    linearly lr_max → lr_min over ``last_epoch`` steps, then flat (evaluated
    in float32, as the JAX schedule is)."""
    def schedule(i):
        i = np.float32(i)
        frac = i / np.float32(last_epoch) * np.float32(lr_min / lr_max) \
            + (np.float32(last_epoch) - i) / np.float32(last_epoch)
        scale = frac if i <= last_epoch else np.float32(lr_min / lr_max)
        return float(np.float32(lr_max) * np.float32(scale))
    return schedule


def exponential_schedule(lr: float, lr_min: float, n_iter: int):
    """ExponentialLR with γ = exp(log(lr_min/lr)/n_iter) (experiments.py:251):
    the learning rate lr·γ^i at step i (γ^i in float32, as the JAX schedule
    evaluates it)."""
    gamma = float(np.exp(np.log(lr_min / lr) / n_iter))

    def schedule(i):
        return float(np.float32(lr) * np.float32(gamma) ** np.float32(i))
    return schedule


def default_scan_steps(device="cuda") -> int:
    """Steps whose losses the host reads together: 16 on the card (one sync
    a chunk instead of one a step), 1 on the CPU (every loss at once, as
    the tests want)."""
    return 1 if torch.device(device).type == "cpu" else 16


def fit(model, loss_fn: Callable = None, n_iter: int = 10000, lr: float = 1e-2,
        schedule=None, loss_thresh: float = 2.5e-6, patience: int = 500,
        criterion: str = "max", weight_decay: float = 1e-2,
        print_loss: bool = False, freq_print: int = 1000,
        block_every: int = 1, scan_steps: int = None, seed: int = 0,
        checkpoint_every: int = 0, checkpoint_path: str = None,
        eval_every: int = 0, eval_fn: Callable = None, device="cuda"):
    """Train ``model`` in place by maximizing ``loss_fn(model)`` (an MLL; the
    loop minimizes −MLL like the reference). Returns (model, info) with
    info = dict(n_iter, train_time, losses, loss), and ``evals`` when any
    were taken.

    AdamW with ``weight_decay`` (1e-2, torch.optim.AdamW's default as in the
    reference), masked off spectral-mixture ``raw_mixture*`` parameters as in
    the JAX loop; ``schedule(i)`` gives the learning rate of step i (default
    :func:`lambda_lr_schedule` from ``lr`` to ``lr/10``). ``loss_fn`` takes
    ``(model)`` or ``(model, generator)``; the second form receives one
    ``torch.Generator`` on ``device``, seeded with ``seed``, whose state
    advances from step to step (fresh probes each step). The model's
    parameters must lie on ``device``.

    ``scan_steps`` (default :func:`default_scan_steps`): steps run as one
    chunk whose losses the host reads together at its end. The plateau
    test sees every loss of the chunk, but a stop lands on the chunk's end
    (up to ``scan_steps`` − 1 steps past the plateau), as in the JAX loop,
    whose chunk is one XLA program; a chunk always runs whole, so n_iter
    rounds up to a multiple of it. With ``scan_steps=1``, ``block_every``:
    the loss is read (a sync) every that many steps.

    A model sharded over a mesh (``parallel.shard_model``) has its
    gradients averaged over the ranks after each backward, as
    ``parallel.sharded_fit_step`` does, so that every rank takes the same
    step and reads the same losses.

    ``checkpoint_every`` > 0 with a ``checkpoint_path`` saves the model
    (``utils.checkpoint.save_model``, the JAX package's key-path-keyed
    .npz) every that many steps, and once at the end. ``eval_every`` > 0
    with an ``eval_fn(model, i)`` records ``(i, eval_fn(model, i))`` in
    ``info["evals"]`` at the first chunk end at or past each multiple, and
    at the end. The steps counted are the JAX loop's: steps taken at a
    chunk's end, the step's index with ``scan_steps=1``.
    """
    params = trainable_parameters(model)
    dev = check_device(device, *[p for _, p in params])
    if loss_fn is None:
        loss_fn = lambda m: m.mll()                         # noqa: E731
    if schedule is None:
        schedule = lambda_lr_schedule(lr_max=lr, lr_min=lr / 10.0)
    takes_gen = _loss_fn_takes_generator(loss_fn)
    generator = torch.Generator(device=dev).manual_seed(seed) \
        if takes_gen else None

    decay = [p for n, p in params
             if not n.split(".")[-1].startswith("raw_mixture")]
    no_decay = [p for n, p in params
                if n.split(".")[-1].startswith("raw_mixture")]
    groups = [{"params": decay, "weight_decay": weight_decay}]
    if no_decay:
        groups.append({"params": no_decay, "weight_decay": 0.0})
    # base lr 1: the LambdaLR factor IS the scheduled learning rate
    opt = torch.optim.AdamW(groups, lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=schedule)

    if scan_steps is None:
        scan_steps = default_scan_steps(dev)
    losses = []
    plateau_id = 0
    last_loss = 1e-9
    deltas = np.zeros(patience)
    effective_n_iter = n_iter
    evals = []
    next_eval = eval_every if eval_every > 0 and eval_fn is not None \
        else None

    def maybe_checkpoint(i, final=False):
        nonlocal next_eval
        if next_eval is not None and (i >= next_eval or final) \
                and not (evals and evals[-1][0] == i):
            evals.append((i, eval_fn(model, i)))
            while next_eval <= i:
                next_eval += eval_every
        if checkpoint_path and (final or (
                checkpoint_every > 0 and i > 0 and i % checkpoint_every == 0)):
            from .utils.checkpoint import save_model
            save_model(model, checkpoint_path)

    def check_plateau(i, new_loss):
        nonlocal plateau_id, last_loss
        if criterion == "max":
            if i > 0 and abs(1 - new_loss / last_loss) < loss_thresh:
                plateau_id += 1
                if plateau_id > patience:
                    return True
            else:
                plateau_id = 0
        elif criterion == "mean":
            deltas[1:] = deltas[:-1]
            deltas[0] = abs(1 - new_loss / last_loss)
            if i >= patience and deltas.mean() < loss_thresh:
                return True
        else:
            raise ValueError("Criterion not recognized")
        last_loss = new_loss
        return False

    mesh = getattr(model, "mesh", None)
    plist = [p for _, p in params]

    def step(i):
        with span("fit.step", trace_id=i):
            opt.zero_grad(set_to_none=True)
            with span("fit.forward"):
                loss = -(loss_fn(model, generator) if takes_gen
                         else loss_fn(model))
            with span("fit.backward"):
                loss.backward()
            if mesh is not None:
                # a rank's gradient holds its shard's terms until averaged
                # (parallel.sharded)
                average_gradients(mesh, plist)
            opt.step()
            sched.step()
            return loss.detach()

    start = time.time()
    if scan_steps > 1:
        i = 0
        while i < n_iter:
            chunk = torch.stack([step(i + j) for j in range(scan_steps)])
            stop = False
            with span("fit.read"):
                count("host_read")
                values = chunk.tolist()                 # one host read
            for j, lv in enumerate(values):
                losses.append(lv)
                if print_loss and (i + j) % freq_print == 0:
                    print(f"iter {i + j}: loss {lv:.6f}")
                if check_plateau(i + j, lv):
                    effective_n_iter = i + j
                    stop = True
                    break
            i += scan_steps
            maybe_checkpoint(i)
            if stop:
                break
    else:
        for i in range(n_iter):
            loss = step(i)
            maybe_checkpoint(i)
            if i % block_every == 0 or i == n_iter - 1:
                with span("fit.read"):
                    count("host_read")
                    new_loss = float(loss)
                losses.append(new_loss)
                if print_loss and i % freq_print == 0:
                    print(f"iter {i}: loss {new_loss:.6f}")
                if check_plateau(i, new_loss):
                    effective_n_iter = i
                    break
    train_time = time.time() - start
    maybe_checkpoint(effective_n_iter, final=True)
    info = dict(n_iter=effective_n_iter, train_time=train_time,
                losses=np.asarray(losses), loss=last_loss)
    if evals:
        info["evals"] = evals
    return model, info


def _architecture(model):
    """What models trained together must share: the class of every
    submodule with its configuration (the attributes that are neither
    tensors, arrays nor submodules: the projected model's BDN, diagonal_B,
    scalar_B, the mixing matrix's diagonal_R, …), and every leaf's key
    path, shape and dtype."""
    config = []
    for name, mod in model.named_modules():
        attrs = sorted((k, v) for k, v in vars(mod).items()
                       if not k.startswith("_") and k != "training"
                       and not isinstance(v, (torch.Tensor, np.ndarray,
                                              torch.nn.Module)))
        config.append((name, type(mod).__name__, attrs))
    leaves = [(k, tuple(t.shape), t.dtype) for k, t in
              keyed_state(model).items()]
    return config, leaves


def _plateau_step(criterion, i, new_loss, state, loss_thresh, patience):
    """One loss row of :func:`fit_ensemble`'s per-seed plateau test (the
    test of :func:`fit`, vectorized over seeds, as in the JAX loop); returns
    the seeds that plateau at step ``i``."""
    if criterion == "max":
        flat = (i > 0) & (np.abs(1 - new_loss / state["last"]) < loss_thresh)
        state["count"] = np.where(flat, state["count"] + 1, 0)
        newly = (~state["done"]) & (state["count"] > patience)
    elif criterion == "mean":
        deltas = state["deltas"]
        deltas[1:] = deltas[:-1]
        deltas[0] = np.abs(1 - new_loss / state["last"])
        newly = (~state["done"]) & (i >= patience) \
            & (deltas.mean(axis=0) < loss_thresh)
    else:
        raise ValueError("Criterion not recognized")
    state["last"] = new_loss
    return newly


def fit_ensemble(models, loss_fn: Callable = None, n_iter: int = 10000,
                 lr: float = 1e-2, schedule=None, loss_thresh: float = 2.5e-6,
                 patience: int = 500, criterion: str = "max",
                 weight_decay: float = 1e-2, scan_steps: int = None,
                 seed: int = 0, print_loss: bool = False,
                 freq_print: int = 1000, force_xla_kernels: bool = True,
                 device="cuda"):
    """Seed-parallel training (port of ``training.fit_ensemble``): B
    same-config models, e.g. ``experiments.driver.build_models`` with B
    seeds (the reference's seeded-study protocol, experiments.py:125-127),
    stepped in lockstep, in place.

    Each step evaluates the B losses, runs one backward of their sum (the
    graphs are disjoint, so each model gets exactly its own gradient) and
    one AdamW update over all B models' parameters (the foreach update;
    :func:`fit`'s weight decay, off the ``raw_mixture*`` leaves, and
    schedule). The host reads the (scan_steps, B) losses once a chunk.
    A ``loss_fn(model, generator)`` gets one ``torch.Generator`` a model,
    model b's seeded with ``seed + b`` (its sequential :func:`fit` with
    ``seed=seed + b`` draws the same). ``torch.func.vmap`` is not used:
    the Cholesky ladder reads its failure flag on the host, a branch vmap
    cannot batch.

    Plateau semantics: each seed's plateau step (:func:`fit`'s rule) is
    recorded in ``info["n_iter"]`` (shape (B,)); the batch stops only when
    every seed has plateaued, or at ``n_iter``. A plateaued seed keeps
    stepping until the batch stops.

    ``force_xla_kernels`` is accepted for the JAX signature and does
    nothing: JAX turns its Pallas kernels off because they do not batch
    under vmap; the port's CUDA kernels have no such limit, so each model
    keeps launching its kernels (K3) on the card.

    Raises ``ValueError`` naming the architecture when the models differ in
    class, configuration or leaves, and for a model sharded over a mesh. Returns ``(models, info)``: the
    length-B list, and info with ``losses`` (iters, B), per-seed ``n_iter``,
    the shared ``train_time`` and per-seed final ``loss``.
    """
    del force_xla_kernels
    B = len(models)
    if B == 0:
        raise ValueError("fit_ensemble needs at least one model")
    if any(getattr(m, "mesh", None) is not None for m in models):
        raise ValueError("fit_ensemble steps unsharded models in lockstep; "
                         "a model sharded over a mesh (parallel.shard_model) "
                         "trains with fit or sharded_fit_step")
    ref = _architecture(models[0])
    for i, m in enumerate(models[1:], 1):
        if _architecture(m) != ref:
            raise ValueError(
                f"model {i} has a different architecture (class, "
                "configuration or leaf mismatch) — fit_ensemble batches "
                "same-config models")
    params = [trainable_parameters(m) for m in models]
    dev = check_device(device, *[p for ps in params for _, p in ps])
    if loss_fn is None:
        loss_fn = lambda m: m.mll()                         # noqa: E731
    if schedule is None:
        schedule = lambda_lr_schedule(lr_max=lr, lr_min=lr / 10.0)
    if scan_steps is None:
        scan_steps = default_scan_steps(dev)
    takes_gen = _loss_fn_takes_generator(loss_fn)
    generators = [torch.Generator(device=dev).manual_seed(seed + b)
                  if takes_gen else None for b in range(B)]

    def raw_mixture(n):
        return n.split(".")[-1].startswith("raw_mixture")

    decay = [p for ps in params for n, p in ps if not raw_mixture(n)]
    no_decay = [p for ps in params for n, p in ps if raw_mixture(n)]
    groups = [{"params": decay, "weight_decay": weight_decay}]
    if no_decay:
        groups.append({"params": no_decay, "weight_decay": 0.0})
    opt = torch.optim.AdamW(groups, lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda=schedule)

    def step():
        opt.zero_grad(set_to_none=True)
        losses = torch.stack([
            -(loss_fn(m, g) if takes_gen else loss_fn(m))
            for m, g in zip(models, generators)])
        losses.sum().backward()
        opt.step()
        sched.step()
        return losses.detach()

    losses = []
    state = dict(count=np.zeros(B, dtype=int), last=np.full(B, 1e-9),
                 deltas=np.zeros((patience, B)), done=np.zeros(B, dtype=bool))
    eff_n_iter = np.full(B, n_iter, dtype=int)
    start = time.time()
    i = 0
    while i < n_iter:
        chunk = torch.stack([step() for _ in range(max(scan_steps, 1))])
        stop = False
        count("host_read")
        for j, lv in enumerate(chunk.cpu().numpy()):
            losses.append(lv)
            if print_loss and (i + j) % freq_print == 0:
                print(f"iter {i + j}: loss {np.array2string(lv, precision=4)}")
            newly = _plateau_step(criterion, i + j, lv, state, loss_thresh,
                                  patience)
            eff_n_iter[newly] = i + j
            state["done"] |= newly
            if state["done"].all():
                stop = True
                break
        i += max(scan_steps, 1)
        if stop:
            break
    train_time = time.time() - start
    info = dict(n_iter=eff_n_iter, train_time=train_time,
                losses=np.asarray(losses), loss=state["last"].copy())
    return list(models), info


def fit_two_phase(model, coarse_loss_fn, fine_loss_fn, n_iter: int = 10000,
                  fine_frac: float = 0.25, lr: float = 1e-2,
                  fine_lr: float = None, **kwargs):
    """Precision-escalated training (port of ``training.fit_two_phase``):
    :func:`fit` with the cheap low-precision MLL ``coarse_loss_fn`` for
    int(n_iter·(1 − fine_frac)) steps (or until plateau), then with the
    full-precision ``fine_loss_fn`` for the rest of the budget at
    ``fine_lr`` (default lr/10), from the phase-1 parameters. Low-precision
    (bf16, int8) CG products bias the MLL like an extra jitter of the
    operator's noise class, so the fp32 phase recovers the fp32 optimum:

        coarse = lambda m, g: m.mll(generator=g, iterative=True,
                                    max_cg_iters=16, cg_tol=2e-2,
                                    matvec_int8=True, precond_rank=256,
                                    num_probes=8)
        fine   = lambda m, g: m.mll(generator=g, iterative=True,
                                    max_cg_iters=64, cg_tol=1e-4,
                                    precond_rank=256, num_probes=8)
        model, info = fit_two_phase(model, coarse, fine, n_iter=50_000)

    ``kwargs`` go to both :func:`fit` calls. Returns (model, info) with the
    phases' losses concatenated, n_iter and train_time summed, and each
    phase's own info under ``info["phases"]``."""
    n_coarse = int(n_iter * (1.0 - fine_frac))
    n_fine = n_iter - n_coarse
    model, info1 = fit(model, coarse_loss_fn, n_iter=n_coarse, lr=lr,
                       **kwargs)
    model, info2 = fit(model, fine_loss_fn, n_iter=n_fine,
                       lr=fine_lr if fine_lr is not None else lr / 10.0,
                       **kwargs)
    info = dict(
        n_iter=info1["n_iter"] + info2["n_iter"],
        train_time=info1["train_time"] + info2["train_time"],
        losses=np.concatenate([info1["losses"], info2["losses"]]),
        loss=info2["loss"],
        phases=[info1, info2],
    )
    return model, info


def _draw_batch(generator, n: int, batch_size: int):
    """``batch_size`` indices drawn uniformly from range(n) with
    replacement, on the generator's device."""
    return torch.randint(n, (batch_size,), generator=generator,
                         device=generator.device)


def fit_svgp_minibatch(model, batch_size: int = 256, n_iter: int = 10000,
                       lr: float = 1e-2, schedule=None,
                       weight_decay: float = 1e-2, loss_thresh: float = 2.5e-6,
                       patience: int = 500, criterion: str = "max",
                       seed: int = 0, scan_steps: int = None,
                       print_loss: bool = False, freq_print: int = 1000,
                       device="cuda"):
    """Stochastic-variational (minibatch) training of an SVGP model: each
    step draws ``batch_size`` indices uniformly with replacement (a
    ``torch.Generator`` on ``device`` seeded with ``seed``) and maximizes
    ``model.elbo(x=X[idx], y=Y[idx], num_data=n)``, with :func:`fit`'s
    AdamW, schedule and plateau test. The plateau test of a noisy loss
    needs the rolling mean, so ``criterion="max"`` becomes "mean", as in
    the JAX package. Returns (model, info)."""
    X, Y = model.train_x, model.train_y
    n = X.shape[0]
    batch_size = min(batch_size, n)

    def loss_fn(m, generator):
        idx = _draw_batch(generator, n, batch_size)
        return m.elbo(x=X[idx], y=Y[idx], num_data=n)

    criterion = "mean" if criterion == "max" else criterion
    return fit(model, loss_fn, n_iter=n_iter, lr=lr, schedule=schedule,
               weight_decay=weight_decay, loss_thresh=loss_thresh,
               patience=patience, criterion=criterion, seed=seed,
               scan_steps=scan_steps, print_loss=print_loss,
               freq_print=freq_print, device=device)
