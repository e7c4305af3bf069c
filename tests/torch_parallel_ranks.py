"""What each rank of ``tests/test_torch_distributed.py``'s spawned world
runs: the port on a (data 2, latent 2) mesh of 4 gloo ranks on the CPU
(and a (data 4, latent 1) mesh for the cases that name it), in float64,
beside the unsharded port on the same leaves. Imports neither JAX nor the
JAX package (the test process holds those and compares); the ranks return
numpy arrays."""

import contextlib
import os

import torch


def _np(t):
    return t.detach().cpu().numpy()


def _grads(model, loss_fn):
    """(loss value, {parameter name: gradient}) of ``loss_fn(model)``."""
    for p in model.parameters():
        p.grad = None
    loss = loss_fn(model)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  model.named_parameters()
                                  if p.grad is not None}


def _loss_and_grads(make, loss_fn, mesh):
    """The unsharded and the sharded (gradients averaged over the ranks)
    loss and gradients of two models ``make()`` builds."""
    from projected_lmc_tpu_torch.parallel import shard_model
    loss_u, grads_u = _grads(make(), loss_fn)
    model = shard_model(make(), mesh)
    loss_s, grads_s = _grads(model, loss_fn)
    mesh.average_(list(grads_s.values()))
    return model, dict(
        loss_unsharded=loss_u, loss_sharded=loss_s,
        grads_unsharded={k: _np(v) for k, v in grads_u.items()},
        grads_sharded={k: _np(v) for k, v in grads_s.items()})


def _projected(case, mesh):
    import projected_lmc_tpu_torch as pl

    def make():
        m = pl.ProjectedGPModel(case["X"], case["Y"], case["p"], case["q"],
                                device="cpu", **case["args"])
        return pl.load_jax_state(m, case["arrays"])

    model, out = _loss_and_grads(make, pl.projected_lmc_mll, mesh)
    with torch.no_grad():
        cache = model.prediction_cache()
        mean, var = model.predict(case["X_test"], observed=True, cache=cache)
    out.update(mean=_np(mean), var=_np(var), cache_latents=cache["latents"])
    return out


def _variational(case, mesh):
    import projected_lmc_tpu_torch as pl

    def make():
        m = pl.VariationalMultitaskGPModel(
            case["X"], n_latents=case["q"], n_tasks=case["p"],
            train_y=case["Y"], device="cpu", **case["args"])
        return pl.load_jax_state(m, case["arrays"])

    model, out = _loss_and_grads(make, lambda m: m.elbo(), mesh)
    with torch.no_grad():
        pred = model(case["X_test"], observed=True)
    out.update(mean=_np(pred.mean), var=_np(pred.variance))
    return out


def _step(case, mesh):
    """One sharded AdamW step beside one unsharded AdamW step."""
    import projected_lmc_tpu_torch as pl
    from projected_lmc_tpu_torch.module import keyed_state, \
        trainable_parameters
    from projected_lmc_tpu_torch.parallel import sharded_fit_step

    def make():
        m = pl.ProjectedGPModel(case["X"], case["Y"], case["p"], case["q"],
                                device="cpu", **case["args"])
        return pl.load_jax_state(m, case["arrays"])

    ref = make()
    opt = torch.optim.AdamW([p for _, p in trainable_parameters(ref)],
                            lr=1e-2, weight_decay=1e-2)
    loss_u = -pl.projected_lmc_mll(ref)
    loss_u.backward()
    opt.step()
    step, model, _ = sharded_fit_step(make(), mesh, pl.projected_lmc_mll,
                                      lr=1e-2)
    loss_s = step()
    trained = {n for n, _ in trainable_parameters(model)}
    return dict(
        loss_unsharded=float(loss_u.detach()), loss_sharded=float(loss_s),
        params_unsharded={k: _np(v) for k, v in keyed_state(ref).items()
                          if k[1:] in trained},
        params_sharded={k: _np(v) for k, v in keyed_state(model).items()
                        if k[1:] in trained})


def _checkpoint(case, mesh):
    """``save_orbax`` then ``load_orbax`` into a fresh model, every rank
    calling both: the largest difference from the saved leaves."""
    import projected_lmc_tpu_torch as pl
    from projected_lmc_tpu_torch.module import keyed_state

    def make():
        return pl.ProjectedGPModel(case["X"], case["Y"], case["p"],
                                   case["q"], device="cpu", **case["args"])

    saved = pl.load_jax_state(make(), case["arrays"])
    pl.save_orbax(saved, case["path"])
    loaded = pl.load_orbax(make(), case["path"])
    a, b = keyed_state(saved), keyed_state(loaded)
    return dict(keys=sorted(a) == sorted(b),
                max_diff=max(float((a[k] - b[k]).abs().max()) for k in a
                             if a[k].numel()))


def _layout(mesh):
    """The global mesh's layout on two 'hosts' of two ranks, a data-group
    sum, and the ValueErrors of make_global_mesh."""
    import torch.distributed as dist

    from projected_lmc_tpu_torch.parallel import make_global_mesh, \
        make_mesh, replicate
    errors = []
    for bad in (dict(latent=4), dict(latent=2, data=3)):
        try:
            make_global_mesh(**bad)
        except ValueError as e:
            errors.append(str(e))
    rank = dist.get_rank()
    total = mesh.data_sum(torch.tensor([float(rank)], dtype=torch.float64))
    mine = {"a": torch.full((2,), float(rank + 1), dtype=torch.float64)}
    replicate(mine, mesh)
    return dict(
        replicated=mine["a"].tolist(),
        rank=rank, shape=dict(mesh.shape), latent_index=mesh.latent_index,
        data_index=mesh.data_index,
        latent_group=dist.get_process_group_ranks(mesh.group("latent")),
        data_group=dist.get_process_group_ranks(mesh.group("data")),
        data_sum=float(total), errors=errors,
        make_mesh_shape=dict(make_mesh(4).shape))


def _multitask_model(case):
    """The case's ``MultitaskGPModel`` or ``ExactGPModel`` on the CPU,
    carrying its leaves."""
    import projected_lmc_tpu_torch as pl
    if case["family"] == "exact":
        T = case["Y"].shape[1]
        m = pl.ExactGPModel(case["X"], case["Y"], pl.GaussianLikelihood(
            batch_shape=T, dtype=torch.float64, device="cpu"), n_tasks=T,
            device="cpu", **case["args"])
    else:
        m = pl.MultitaskGPModel(case["X"], case["Y"], device="cpu",
                                **case["args"])
    return pl.load_jax_state(m, case["arrays"])


@contextlib.contextmanager
def _eigenbasis(case):
    """The ICM probes' eigenbasis: the case's (JAX's) eigenpairs of the
    whitened task covariance in place of the port's sign-fixed ones, for
    that matrix only (the test process computed them)."""
    from projected_lmc_tpu_torch.ops import iterative as it
    if "eig" not in case:
        yield
        return
    own = it._eigh_fixed_signs
    w, V = (torch.tensor(a) for a in case["eig"])

    def jax_eigh(A):
        if A.shape == V.shape and torch.allclose(A, (V * w) @ V.T,
                                                 rtol=1e-10, atol=1e-12):
            return w, V
        return own(A)

    it._eigh_fixed_signs = jax_eigh
    try:
        yield
    finally:
        it._eigh_fixed_signs = own


@contextlib.contextmanager
def _env(case):
    """The case's environment (a backward route's switch) while it runs."""
    old = {k: os.environ.get(k) for k in case.get("env", {})}
    os.environ.update(case.get("env", {}))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _loss_fn(case):
    """The case's MLL, with JAX's probes: eps and xi for a PCG route, the
    Rademacher ``probes`` for CG + SLQ."""
    draws = {k: torch.tensor(case[k]) for k in ("eps", "xi", "probes")
             if case.get(k) is not None}

    def loss_fn(m):
        if case["mll"] is None:
            return m.mll()
        return m.mll(**draws, **case["mll"])
    return loss_fn


def _multitask(case, mesh, meshes):
    """The LMC/ICM (or ``ExactGPModel``'s iterative) MLL with its
    gradients, sharded on each of the case's mesh layouts, beside the
    unsharded port; then, with a "cache" entry, the sharded cache and
    ``posterior`` (and, with "compute_var", the ICM's ``compute_var``)."""
    loss_fn = _loss_fn(case)
    out = {}
    with _eigenbasis(case), _env(case):
        for layout in case["layouts"]:
            _, out[layout] = _loss_and_grads(
                lambda: _multitask_model(case), loss_fn, meshes[layout])
        if "cache" not in case:
            return out
        from projected_lmc_tpu_torch.parallel import shard_model
        x = torch.tensor(case["X_test"])
        kw = dict(case["cache"])
        if case.get("v0") is not None:
            kw["v0"] = torch.tensor(case["v0"])
        for label, model in (("unsharded", _multitask_model(case)),
                             ("sharded", shard_model(_multitask_model(case),
                                                     mesh))):
            with torch.no_grad():
                cache = model.precompute_posterior(**kw)
                pred = model.posterior(x, cache=cache, observed=True)
                out[label] = dict(kind=cache["kind"], mean=_np(pred.mean),
                                  var=_np(pred.variance))
                if case.get("compute_var"):
                    out[label]["compute_var"] = _np(model.compute_var(x))
    return out


def _multitask_step(case, mesh):
    """One sharded AdamW step of the LMC's MLL beside one unsharded step."""
    from projected_lmc_tpu_torch.module import keyed_state, \
        trainable_parameters
    from projected_lmc_tpu_torch.parallel import sharded_fit_step
    loss_fn = _loss_fn(case)

    ref = _multitask_model(case)
    opt = torch.optim.AdamW([p for _, p in trainable_parameters(ref)],
                            lr=1e-2, weight_decay=1e-2)
    loss_u = -loss_fn(ref)
    loss_u.backward()
    opt.step()
    step, model, _ = sharded_fit_step(_multitask_model(case), mesh, loss_fn,
                                      lr=1e-2)
    loss_s = step()
    trained = {n for n, _ in trainable_parameters(model)}
    return dict(
        loss_unsharded=float(loss_u.detach()), loss_sharded=float(loss_s),
        params_unsharded={k: _np(v) for k, v in keyed_state(ref).items()
                          if k[1:] in trained},
        params_sharded={k: _np(v) for k, v in keyed_state(model).items()
                        if k[1:] in trained})


def _fit(case, mesh):
    """``training.fit`` on the LMC, unsharded and sharded (its gradients
    averaged over the ranks after each backward), beside 2 steps of
    ``sharded_fit_step`` at the same constant learning rate; then
    ``fit_two_phase`` (an int8 phase, then an fp32 one), unsharded and
    sharded. Each run's losses and its trained leaves."""
    from projected_lmc_tpu_torch.module import keyed_state, \
        trainable_parameters
    from projected_lmc_tpu_torch.parallel import shard_model, \
        sharded_fit_step
    from projected_lmc_tpu_torch.training import fit, fit_two_phase
    loss_fn = _loss_fn(case)
    coarse = _loss_fn(dict(case, mll=dict(case["mll"], matvec_int8=True)))
    kw = dict(schedule=lambda i: 1e-2, scan_steps=1, patience=100,
              device="cpu")

    def leaves(m):
        trained = {n for n, _ in trainable_parameters(m)}
        return {k: _np(v) for k, v in keyed_state(m).items()
                if k[1:] in trained}

    out = {}
    for label in ("unsharded", "sharded"):
        for name, train in (
                ("fit", lambda m: fit(m, loss_fn, n_iter=2, **kw)),
                ("two_phase", lambda m: fit_two_phase(
                    m, coarse, loss_fn, n_iter=4, fine_frac=0.25, **kw))):
            m = _multitask_model(case)
            if label == "sharded":
                m = shard_model(m, mesh)
            m, info = train(m)
            out[f"{name}_{label}"] = dict(losses=list(info["losses"]),
                                          params=leaves(m))
    step, m, _ = sharded_fit_step(_multitask_model(case), mesh, loss_fn,
                                  lr=1e-2)
    out["step"] = dict(losses=[float(step()) for _ in range(2)],
                       params=leaves(m))
    return out


CHECKS = {"projected": _projected, "variational": _variational,
          "step": _step, "checkpoint": _checkpoint,
          "multitask_step": _multitask_step, "fit": _fit}


def run(rank, cases):
    """Every check on this rank: {case name: its results}, plus the layout
    under "layout"."""
    from projected_lmc_tpu_torch.parallel import make_global_mesh, make_mesh
    mesh = make_global_mesh(latent=2)
    out = {"layout": _layout(mesh)}
    meshes = {(2, 2): mesh, (4, 1): make_mesh(4, data=4, latent=1)}
    for name, case in cases.items():
        if case["check"] == "multitask":
            out[name] = _multitask(case, mesh, meshes)
        else:
            out[name] = CHECKS[case["check"]](case, mesh)
    return out
