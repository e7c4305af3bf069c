"""The port's mesh layer in one process (no spawn): the sharding report
leaf for leaf against the JAX package's on its 8-device mesh, the mesh's
axis rule and ranges, a layout's collectives, every route that once raised
under a mesh on a one-rank mesh against the unsharded model, the errors of
``fit_ensemble`` on a sharded model and of a missing card, ``latent_slice``,
the DCP checkpoints and ``entry``."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import projected_lmc_tpu as jpl
from projected_lmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from projected_lmc_tpu.parallel.mesh import sharding_report as jax_report
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves

import projected_lmc_tpu_torch as pl
from projected_lmc_tpu_torch import parallel
from projected_lmc_tpu_torch.entry import entry
from projected_lmc_tpu_torch.module import keyed_state, latent_slice
from projected_lmc_tpu_torch.parallel import Mesh, make_mesh, sharding_report


def make_data(n=64, p=6, q=2, seed=0):
    """tests/test_sharding.py's data."""
    rng = np.random.default_rng(seed)
    X = np.linspace(-1, 1, n)[:, None]
    U = np.stack([np.sin(3 * X[:, 0]), np.cos(5 * X[:, 0])][:q], axis=1)
    H = rng.standard_normal((q, p))
    Y = U @ H + 0.05 * rng.standard_normal((n, p))
    return X, Y


def _projected(lib, m_ind=None, **kw):
    X, Y = make_data()
    return lib.ProjectedGPModel(X, Y, Y.shape[1], 2, init_lmc_coeffs=True,
                                kernel_type="matern",
                                n_inducing_points=m_ind, **kw)


def _multitask(lib, model_type, **kw):
    X, Y = make_data()
    lik = lib.MultitaskGaussianLikelihood(num_tasks=4, **kw)
    return lib.MultitaskGPModel(X, Y[:, :4], lik, n_tasks=4, n_latents=2,
                                model_type=model_type, kernel_type="matern",
                                **kw)


def _variational(lib, **kw):
    X, Y = make_data(n=48)
    return lib.VariationalMultitaskGPModel(
        X, n_latents=2, n_tasks=Y.shape[1], train_y=Y, init_lmc_coeffs=True,
        kernel_type="matern", mean_type="zero", **kw)


MODELS = {
    "projected": lambda lib, **kw: _projected(lib, **kw),
    "projected_sgpr": lambda lib, **kw: _projected(lib, m_ind=10, **kw),
    "projected_fast": lambda lib, **kw: _projected(
        lib, BDN=True, diagonal_B=True, scalar_B=True, **kw),
    "multitask_lmc": lambda lib, **kw: _multitask(lib, "LMC", **kw),
    "multitask_icm": lambda lib, **kw: _multitask(lib, "ICM", **kw),
    "variational": lambda lib, **kw: _variational(lib, **kw),
    "additive": lambda lib, **kw: lib.ExactGPModel(
        np.random.default_rng(0).uniform(-1, 1, (40, 4)),
        np.random.default_rng(1).standard_normal((40, 2)),
        lib.GaussianLikelihood(batch_shape=2, **kw), n_tasks=2,
        decomp=[[0, 1], [2, 3]], kernel_type="matern", **kw),
}


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh(8)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sharding_report_equals_jax_leaf_for_leaf(jax_mesh, name):
    """Spec and rule tag of every leaf, on JAX's mesh of data 4 × latent
    2 and on the port's layout of the same shape."""
    want = {path: (tuple(spec), rule) for path, (spec, rule)
            in jax_report(MODELS[name](jpl), jax_mesh).items()}
    mesh = make_mesh(8)
    assert mesh.shape == dict(jax_mesh.shape)
    got = sharding_report(MODELS[name](pl, device="cpu"), mesh)
    assert got == want
    assert len(got) >= 5


def test_projected_report_rules():
    """tests/test_sharding.py's rules, and no latent-batched leaf of a
    latent scope left replicated (``test_no_silent_latent_replication``)."""
    model = _projected(pl, device="cpu")
    rep = sharding_report(model, make_mesh(8))
    assert rep["train_x"] == (("data", None), "data-rows")
    assert rep["covar_module.raw_lengthscale"] == (
        ("latent", None, None), "latent-batch")
    assert rep["likelihood.raw_noise"] == (("latent", None), "latent-batch")
    assert rep["train_y"] == (("latent", "data"), "latent-by-data")
    leaves = {k[1:]: v for k, v in keyed_state(model).items()}
    for path, (spec, rule) in rep.items():
        leaf = leaves[path]
        if leaf.dim() and leaf.shape[0] == 2 and any(
                s in path for s in ("covar_module", "likelihood",
                                    "mean_module")):
            assert rule in ("latent-batch", "latent-by-data"), (path, rule)


@pytest.mark.parametrize("n, latent, data, want", [
    (8, None, None, (4, 2)), (6, None, None, (3, 2)), (5, None, None, (5, 1)),
    (8, 4, None, (2, 4)), (8, None, 8, (8, 1)), (None, None, None, (1, 1))])
def test_make_mesh_axis_rule(n, latent, data, want):
    mesh = make_mesh(n, latent=latent, data=data)
    assert (mesh.shape["data"], mesh.shape["latent"]) == want
    assert mesh.rank == 0 and (mesh.data_index, mesh.latent_index) == (0, 0)


def test_make_mesh_product_and_ranges():
    with pytest.raises(AssertionError, match="multiply to n_devices"):
        make_mesh(8, latent=3, data=2)
    # rank = d·L + l; the ranges tile q and n in rank order
    ranges = [(Mesh(3, 2, r).latent_range(5), Mesh(3, 2, r).data_range(10))
              for r in range(6)]
    assert [r[0] for r in ranges] == [(0, 2), (2, 5)] * 3
    assert [r[1] for r in ranges] == [(0, 3)] * 2 + [(3, 6)] * 2 \
        + [(6, 10)] * 2


def test_layout_collectives_raise_and_trivial_axes_pass():
    t = torch.ones(3, dtype=torch.float64)
    layout = make_mesh(8)
    for call in (lambda: layout.latent_sum(t), lambda: layout.data_sum(t),
                 lambda: layout.average_([t])):
        with pytest.raises(RuntimeError, match="no process group"):
            call()
    one = make_mesh(1)
    assert one.latent_sum(t) is t and one.data_sum(t) is t
    assert torch.equal(one.gather_latents(t, 0, 3, 3), t)


ITER = dict(iterative=True, precond_rank=8, num_probes=2, max_cg_iters=8)


def _mean_var(m):
    """The posterior's mean and variance at 5 training inputs, summed with
    weights so that each counts (a scalar to differentiate)."""
    pred = m.posterior(m.train_x[:5], m.precompute_posterior())
    return pred.mean.sum() + 3.0 * pred.variance.sum()


# every route that once raised under a mesh (their former ROADMAP item),
# and the SGPR cache, the SGPR posterior, the ICM's SGPR MLL, the composed
# int8 loop and the "krs" backward beside them
A15_ROUTES = {
    "LMC dense Woodbury MLL": ("LMC", {}, lambda m: m.mll()),
    "LMC \"lmc\" cache": ("LMC", {}, _mean_var),
    "LMC CG + SLQ MLL": ("LMC", {}, lambda m: m.mll(iterative=True)),
    "LMC int8 loop": ("LMC", {},
                      lambda m: m.mll(matvec_int8=True, **ITER)),
    "LMC SGPR MLL": ("LMC", dict(n_inducing_points=6), lambda m: m.mll()),
    "ICM SGPR cache": ("ICM", dict(n_inducing_points=6), _mean_var),
    "ExactGPModel composed iterative MLL": (
        "exact", dict(decomp=[[0], [1]]), lambda m: m.mll(**ITER)),
    "fused \"kr\" backward": ("LMC", {}, lambda m: m.mll(**ITER)),
    "LMC \"sgpr\" cache": ("LMC", dict(n_inducing_points=6), _mean_var),
    "LMC SGPR posterior": (
        "LMC", dict(n_inducing_points=6),
        lambda m: m.posterior(m.train_x[3:9], m.precompute_posterior(),
                              observed=False).variance.sum()),
    "ICM SGPR MLL": ("ICM", dict(n_inducing_points=6), lambda m: m.mll()),
    "LMC composed int8 loop": ("LMC", dict(decomp=[[0], [1]]),
                               lambda m: m.mll(matvec_int8=True, **ITER)),
    "fused \"krs\" backward": ("LMC", {}, lambda m: m.mll(**ITER)),
}
ROUTE_ENV = {"fused \"kr\" backward": "PLMC_KR_FUSED",
             "fused \"krs\" backward": "PLMC_KR_STREAM"}


def _a15_model(family, kw):
    if family == "exact":
        X, Y = make_data(n=24, p=2)
        X = np.concatenate([X, X[::-1]], 1)
        return pl.ExactGPModel(X, Y, pl.GaussianLikelihood(
            batch_shape=2, dtype=torch.float64, device="cpu"), n_tasks=2,
            device="cpu", **kw)
    X, Y = make_data(n=24)
    if "decomp" in kw:
        X = np.concatenate([X, X[::-1]], 1)
    return pl.MultitaskGPModel(X, Y[:, :4], n_tasks=4, n_latents=2,
                               model_type=family, kernel_type="matern",
                               device="cpu", **kw)


@pytest.mark.parametrize("route", sorted(A15_ROUTES))
def test_shard_model_takes_the_lmc_and_icm_and_routes_left_raise(
        monkeypatch, route):
    """``shard_model`` takes the LMC and the ICM (``MultitaskGPModel``) and
    ``ExactGPModel``, and no route is left raising under a mesh: each
    route that once did, on a one-rank mesh (its row-block, world-sum and
    world-max code paths, with the kernels' plain versions), gives the
    unsharded model's value (rtol 1e-12) and gradients (1e-10 of each
    leaf's largest entry)."""
    family, kw, call = A15_ROUTES[route]
    if route in ROUTE_ENV:
        monkeypatch.setenv(ROUTE_ENV[route], "1")
    plain, model = _a15_model(family, kw), _a15_model(family, kw)
    assert parallel.shard_model(model, make_mesh(1)) is model
    assert model.mesh is not None
    values = []
    for m in (plain, model):
        value = call(m)
        value.backward()
        values.append(float(value.detach()))
    np.testing.assert_allclose(values[1], values[0], rtol=1e-12)
    grads = [{k: p.grad for k, p in m.named_parameters()
              if p.grad is not None} for m in (plain, model)]
    assert len(grads[0]) >= 3
    for k, g in grads[0].items():
        assert torch.allclose(grads[1][k], g, rtol=0,
                              atol=1e-10 * float(g.abs().max())), k
    # a leaf the plain route leaves without a gradient gets zeros at most
    for k in set(grads[1]) - set(grads[0]):
        assert not bool(grads[1][k].any()), k
    with pytest.raises(TypeError):
        parallel.shard_model(torch.nn.Linear(2, 2), make_mesh(1))


def test_fit_ensemble_refuses_a_sharded_model():
    """``fit_ensemble`` steps unsharded models in lockstep: a model on a
    mesh is refused, with a message naming the alternatives."""
    model = parallel.shard_model(_multitask(pl, "LMC", device="cpu"),
                                 make_mesh(1))
    with pytest.raises(ValueError, match="sharded over a mesh"):
        pl.fit_ensemble([model, _multitask(pl, "LMC", device="cpu")],
                        n_iter=1, device="cpu")


def test_initialize_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        parallel.initialize(device="cuda")
    assert not torch.distributed.is_initialized()
    assert parallel.is_coordinator()


@pytest.mark.parametrize("device, world, rank, cards, local, want", [
    ("cuda", 4, 3, 4, None, ("nccl", 4, 3)),     # one host, a card a rank
    ("cuda", 4, 3, 1, 4, ("gloo", 4, 0)),        # four ranks share a card
    ("cuda", 8, 5, 4, 4, ("nccl", 4, 1)),        # two hosts of four cards
    ("cuda", 8, 5, 4, None, None),               # ambiguous: raises
    ("cpu", 4, 3, 0, None, ("gloo", 4, None)),
])
def test_initialize_picks_the_transport_and_the_host(
        monkeypatch, device, world, rank, cards, local, want):
    """With an explicit address: NCCL when every local rank has a card of
    its own, else gloo; the rank's card and the ranks a host; more ranks
    than cards without ``local_world_size`` raises (shared cards or
    several hosts cannot be told apart)."""
    from projected_lmc_tpu_torch.parallel import distributed
    seen = {}
    monkeypatch.setattr(distributed, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    try:
        if want is None:
            with pytest.raises(ValueError, match="local_world_size"):
                distributed.initialize("tcp://localhost:1", world, rank,
                                       device=device)
            assert not seen
            return
        assert distributed.initialize("tcp://localhost:1", world, rank,
                                      device=device, local_world_size=local)
        dev = distributed.current_device()
        assert (seen["backend"], distributed._context["local_world_size"],
                dev.index) == want
        assert dev.type == device and seen["world_size"] == world \
            and seen["rank"] == rank
    finally:
        distributed.shutdown()


def test_one_rank_mesh_step_is_the_plain_step():
    """On a one-rank layout the sharded step is AdamW on the plain loss:
    the same loss and parameters as a plain AdamW step."""
    a, b = _projected(pl, device="cpu"), _projected(pl, device="cpu")
    opt = torch.optim.AdamW([p for p in a.parameters() if p.requires_grad],
                            lr=1e-2, weight_decay=1e-2)
    loss = -pl.projected_lmc_mll(a)
    loss.backward()
    opt.step()
    step, model, _ = parallel.sharded_fit_step(b, make_mesh(1),
                                               pl.projected_lmc_mll)
    assert model is b and model.mesh.size == 1
    assert float(step()) == float(loss.detach())
    for (k, v), w in zip(keyed_state(a).items(), keyed_state(b).values()):
        assert torch.equal(v, w), k


def test_latent_slice_views_reach_the_whole_leaf():
    cov = pl.kernels.handle_covar("matern", dim=2, n_funcs=4,
                                  outputscales=True, device="cpu",
                                  dtype=torch.float64)
    view = latent_slice(cov, 1, 3, 4)
    assert view.batch == 2 and view.base_kernel.batch == 2 and cov.batch == 4
    x = torch.rand(5, 2, dtype=torch.float64)
    K = view(x)
    assert K.shape == (2, 5, 5)
    assert torch.equal(K, cov(x)[1:3])
    K.sum().backward()
    g = cov.base_kernel.raw_lengthscale.grad
    assert g.shape == (4, 1, 2) and bool((g[[0, 3]] == 0).all())
    assert bool((g[1:3] != 0).all())


def test_dcp_checkpoint_round_trip_in_process(tmp_path):
    """``save_orbax``/``load_orbax`` with no process group, keyed by JAX
    key path; the zero-size leaves keep the template's."""
    saved = _projected(pl, device="cpu")
    with torch.no_grad():
        for p in saved.parameters():
            p.add_(0.25)
    pl.save_orbax(saved, str(tmp_path / "ck"))
    loaded = pl.load_orbax(_projected(pl, device="cpu"), str(tmp_path / "ck"))
    a, b = keyed_state(saved), keyed_state(loaded)
    assert ".mean_module._dummy" in b and b[".mean_module._dummy"].numel() == 0
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_entry_matches_jax_entry():
    """``entry()`` is JAX's flagship step on its ``_tiny_model`` (float32)."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry", Path(__file__).parents[1] / "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    fn, (model,) = entry(device="cpu")
    jfn, (jmodel,) = graft.entry()
    assert fn is pl.projected_lmc_mll
    arrays = {k: np.asarray(v) for k, v in _keyed_leaves(jmodel)}
    for k, t in keyed_state(model).items():
        np.testing.assert_array_equal(t.detach().numpy(), arrays[k])
    np.testing.assert_allclose(float(fn(model)), float(jax.jit(jfn)(jmodel)),
                               rtol=1e-5)
