"""The port's ``ExactGPModel`` (``projected_lmc_tpu_torch.models.exact``)
against the JAX package's, on the CPU.

The JAX model's leaves are carried into the port with ``load_jax_state``;
both see the same eps and xi (the ones the JAX model draws from its key).
The dense and the iterative MLL, their gradients and three AdamW steps of
``training.fit`` must agree (float64).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.likelihoods import GaussianLikelihood as JaxLik
from projected_lmc_tpu.models.exact import ExactGPModel as JaxModel
from projected_lmc_tpu.module import trainable_mask
from projected_lmc_tpu.training import fit as jax_fit
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import (ExactGPModel, GaussianLikelihood,
                                     exact_mll, fit, load_jax_state)
from projected_lmc_tpu_torch.models.exact import _canon_targets
from projected_lmc_tpu_torch.module import keyed_state

N, T, D, RANK, S = 40, 3, 2, 16, 4
MLL_KW = dict(iterative=True, max_cg_iters=200, cg_tol=1e-12,
              precond_rank=RANK, num_probes=S)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny torch ops in long loops: one intra-op thread
    avoids oversubscribing the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def data(seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (N, D)), rng.standard_normal((N, T))


def models(outputscales=True, mean_type="constant", **kw):
    """A JAX model moved off its defaults and the port model carrying its
    leaves."""
    X, Y = data()
    jm = JaxModel(X, Y, JaxLik(batch_shape=T, dtype=jnp.float64), n_tasks=T,
                  kernel_type="matern", outputscales=outputscales,
                  mean_type=mean_type, **kw)
    arrays = {k: np.asarray(v) for k, v in _keyed_leaves(jm)}
    rng = np.random.default_rng(2)
    for k in arrays:
        if "raw" in k or "constant" in k:
            arrays[k] = arrays[k] + rng.uniform(-0.4, 0.4, arrays[k].shape)
    jm = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jm),
        [jnp.asarray(arrays[k]) for k, _ in _keyed_leaves(jm)])
    tm = ExactGPModel(X, Y, GaussianLikelihood(batch_shape=T,
                                               dtype=torch.float64,
                                               device="cpu"),
                      n_tasks=T, kernel_type="matern",
                      outputscales=outputscales, mean_type=mean_type,
                      device="cpu", **kw)
    load_jax_state(tm, arrays)
    return jm, tm


def jax_probes():
    """The eps and xi that the JAX model draws from PRNGKey(0)
    (models/exact.py: split, then normal draws)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    eps = jax.random.normal(k1, (S, N, T), jnp.float64)
    xi = jax.random.normal(k2, (S, T, RANK), jnp.float64)
    return torch.tensor(np.asarray(eps)), torch.tensor(np.asarray(xi))


def assert_grads_match(tm, jgrad):
    """Every trainable leaf's gradient, by key path, rtol 1e-7."""
    jg = dict(_keyed_leaves(jgrad))
    n = 0
    for name, p in tm.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg["." + name]),
                                       rtol=1e-7, atol=1e-10, err_msg=name)
            n += 1
    assert n >= 3


@pytest.mark.parametrize("outputscales", [False, True])
@pytest.mark.parametrize("mean_type", ["zero", "constant"])
def test_key_paths_and_trainable_set_match_jax(outputscales, mean_type):
    jm, tm = models(outputscales, mean_type)
    tstate = keyed_state(tm)
    assert sorted(k for k, _ in _keyed_leaves(jm)) == sorted(tstate)
    for (k, leaf), trainable in zip(_keyed_leaves(jm), trainable_mask(jm)):
        if np.size(leaf) == 0:
            continue          # ZeroMean's empty placeholder
        assert tstate[k].requires_grad == trainable, k
        assert tuple(tstate[k].shape) == np.shape(leaf), k


def test_dense_mll_matches_jax():
    """``exact_mll`` below the ceiling: the batched-Cholesky route, with
    outputscales and a constant mean."""
    from projected_lmc_tpu.mlls import exact_mll as jax_exact_mll
    jm, tm = models()
    vj, gj = jax.value_and_grad(jax_exact_mll)(jm)
    vt = exact_mll(tm)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-10)
    assert_grads_match(tm, gj)


@pytest.mark.parametrize("route", ["default", "PLMC_KR_FUSED",
                                   "PLMC_KR_STREAM"])
def test_iterative_mll_matches_jax(monkeypatch, route):
    """The fused PCG route with identity mixing and outputscales ≠ 1, on
    each backward route of the port (the JAX op on the CPU takes its stack
    product route, the same math)."""
    monkeypatch.delenv("PLMC_KR_FUSED", raising=False)
    monkeypatch.delenv("PLMC_KR_STREAM", raising=False)
    if route != "default":
        monkeypatch.setenv(route, "1")
    jm, tm = models()
    eps, xi = jax_probes()
    key = jax.random.PRNGKey(0)
    vj, gj = jax.value_and_grad(lambda m: m.mll(key=key, **MLL_KW))(jm)
    vt = tm.mll(eps=eps, xi=xi, **MLL_KW)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-10)
    assert_grads_match(tm, gj)


def test_three_fit_steps_match_jax():
    """``training.fit`` on the iterative MLL: the JAX loop's one-argument
    loss draws from PRNGKey(0) every step; the port gets those eps and xi."""
    jm, tm = models()
    eps, xi = jax_probes()
    _, jinfo = jax_fit(jm, lambda m: m.mll(**MLL_KW), n_iter=3, lr=0.05,
                       patience=100)
    _, tinfo = fit(tm, lambda m: m.mll(eps=eps, xi=xi, **MLL_KW), n_iter=3,
                   lr=0.05, patience=100, device="cpu")
    assert len(tinfo["losses"]) == 3
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-9)


def test_auto_routing_warns_and_takes_the_iterative_route(monkeypatch):
    """Above ITER_TN2_MAX the MLL is the iterative one, with a warning, and
    at it the dense one, silently. ``precond_rank <= 0`` means
    min(256, n)."""
    _, tm = models()
    kw = dict(num_probes=S, max_cg_iters=16, cg_tol=2e-2)
    with torch.no_grad():
        want = float(tm.mll(iterative=True, precond_rank=N,
                            generator=torch.Generator().manual_seed(5), **kw))
        monkeypatch.setattr(ExactGPModel, "ITER_TN2_MAX", T * N * N - 1)
        with pytest.warns(UserWarning, match="auto-routing"):
            got = float(tm.mll(precond_rank=0,
                               generator=torch.Generator().manual_seed(5),
                               **kw))
        assert got == want
        monkeypatch.setattr(ExactGPModel, "ITER_TN2_MAX", T * N * N)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            dense = float(tm.mll())
        assert dense == float(tm.mll(iterative=False))


def test_canon_targets_orientation():
    y = torch.zeros((3, 3))
    y[0, 1] = 1.0
    assert torch.equal(_canon_targets(y, 3, "tn"), y)
    assert torch.equal(_canon_targets(y, 3, "nt"), y.T)
    assert torch.equal(_canon_targets(y, 3), y.T)       # square: (n, T)
    assert _canon_targets(torch.zeros(5), 1).shape == (1, 5)
    with pytest.raises(ValueError):
        _canon_targets(torch.zeros((4, 5)), 3, "tn")
    with pytest.raises(ValueError):
        _canon_targets(torch.zeros((4, 5)), 3, "nt")
    with pytest.raises(ValueError):
        _canon_targets(torch.zeros(5), 2)


def test_unported_routes_raise():
    """The routes that raised until their slice was ported now run and
    match JAX: the SGPR route (``n_inducing_points``, slice 5), a linear
    mean (its dense MLL and gradients) and the composed route (a kernel
    over a proper subset of the features, the iterative MLL and its
    gradients on JAX's probes)."""
    jm, tm = models(n_inducing_points=8)
    assert tm.sgpr and tuple(tm.inducing_points.shape) == (8, D)
    np.testing.assert_allclose(float(tm.mll().detach()),
                               float(jax.jit(lambda m: m.mll())(jm)),
                               rtol=1e-10)
    jm, tm = models(mean_type="linear")
    vj, gj = jax.value_and_grad(lambda m: m.mll())(jm)
    vt = tm.mll()
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-10)
    assert_grads_match(tm, gj)
    # a kernel over a proper subset of the features: the composed route
    jm, tm = models(decomp=[[0]])
    eps, xi = jax_probes()
    vj, gj = jax.jit(jax.value_and_grad(lambda m: m.mll(**MLL_KW)))(jm)
    vt = tm.mll(eps=eps, xi=xi, **MLL_KW)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-9)
    assert_grads_match(tm, gj)
