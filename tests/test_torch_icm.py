"""The port's exact ICM model (``MultitaskGPModel(model_type="ICM")``)
against the JAX package's, on the CPU in float64: the dense (Kronecker) and
matrix-free (PCG) MLL, three ``fit`` steps, the "icm" and "icm_iter"
posteriors, ``compute_var``, ``compute_loo``, ``kernel_cond``, the prior,
``lscales``/``outputscale`` (ICM and LMC) and ``load_jax_state``.

The JAX models' leaves, moved off their defaults, are carried into the port
with ``load_jax_state``. Values to rtol 1e-10 (with an absolute floor of
1e-10 of the array's largest entry), gradients by key path to 1e-7, the
matrix-free posterior to 1e-8 (its spectral bound started from JAX's own
draw), three ``fit`` steps to 1e-9. The matrix-free MLL gets JAX's own
probes, and the port JAX's eigenbasis of the whitened task covariance
(``jax_eigenbasis``; see ``tests/test_torch_kron.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.likelihoods import (
    MultitaskGaussianLikelihood as JaxMTLik)
from projected_lmc_tpu.models.multitask import MultitaskGPModel as JaxMT
from projected_lmc_tpu.module import trainable_mask
from projected_lmc_tpu.training import fit as jax_fit
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import (KronCov, MultitaskGaussianLikelihood,
                                     MultitaskGPModel, fit, load_jax_state)
from projected_lmc_tpu_torch import distributions as tdist
from projected_lmc_tpu_torch.module import keyed_state
from projected_lmc_tpu_torch.ops import iterative as tit_ops

N, NS, T, Q = 24, 10, 3, 2
ICM_KW = dict(n_tasks=T, n_latents=Q, model_type="ICM", kernel_type="matern",
              mean_type="constant")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny torch ops in loops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_eigenbasis(monkeypatch):
    """The port's sign-fixed eigh replaced by JAX's eigh of the same matrix,
    so both packages draw the ICM probes in one eigenbasis."""
    def jax_eigh(A):
        w, V = jnp.linalg.eigh(jnp.asarray(A.detach().numpy()))
        return t64(w), t64(V)
    monkeypatch.setattr(tit_ops, "_eigh_fixed_signs", jax_eigh)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol=1e-10, what=""):
    """Equal to rtol, with an absolute floor of rtol × max |want|."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=what)


def data(n=N, p=T, seed=1):
    """Smooth latent draws mixed into p tasks, plus noise; test inputs."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 2))
    U = np.stack([np.sin(3 * X[:, 0]), np.cos(2 * X[:, 1]),
                  X[:, 0] * X[:, 1]], 1)
    Y = U @ rng.standard_normal((3, p)) + 0.1 * rng.standard_normal((n, p))
    return X, Y, rng.uniform(-1.1, 1.1, (NS, 2))


def carried(jm, tm, seed=2):
    """Move the JAX model's trainable leaves by uniform(−0.3, 0.3), carry
    every leaf into the port model; returns both."""
    arrays = {k: np.asarray(v) for k, v in _keyed_leaves(jm)}
    rng = np.random.default_rng(seed)
    for (k, _), trainable in zip(_keyed_leaves(jm), trainable_mask(jm)):
        if trainable:
            arrays[k] = arrays[k] + rng.uniform(-0.3, 0.3, arrays[k].shape)
    jm = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jm),
        [jnp.asarray(arrays[k]) for k, _ in _keyed_leaves(jm)])
    load_jax_state(tm, arrays)
    return jm, tm


def icm_models(n=N, noise_rank=0, **kw):
    """A JAX ICM model and the port's, with a rank-``noise_rank`` task-noise
    likelihood, carrying the same moved leaves."""
    X, Y, Xs = data(n)
    kw = dict(ICM_KW, **kw)
    jm = JaxMT(X, Y, JaxMTLik(num_tasks=T, rank=noise_rank,
                              dtype=jnp.float64), **kw)
    tm = MultitaskGPModel(X, Y, MultitaskGaussianLikelihood(
        num_tasks=T, rank=noise_rank, dtype=torch.float64, device="cpu"),
        device="cpu", **kw)
    return (*carried(jm, tm), Xs)


def grads_match(jm, tm, jg, rtol=1e-7):
    """Every trainable leaf's gradient, by key path."""
    grads = dict(_keyed_leaves(jg))
    params = dict(tm.named_parameters())
    names = [k for (k, _), m in zip(_keyed_leaves(jm), trainable_mask(jm))
             if m]
    for k in names:
        close(params[k[1:]].grad, grads[k], rtol=rtol, what=k)
    return names


@pytest.mark.parametrize("noise_rank", [0, T])
def test_dense_mll_value_and_gradients_match_jax(noise_rank):
    """``mll()`` at n ≤ ``ICM_DENSE_N_MAX``: the Kronecker MLL with its
    analytic backward, with a diagonal and a rank-T task noise."""
    jm, tm, _ = icm_models(noise_rank=noise_rank)
    jv, jg = jax.jit(jax.value_and_grad(lambda m: m.mll()))(jm)
    tv = tm.mll()
    tv.backward()
    close(tv, jv)
    assert len(grads_match(jm, tm, jg)) >= 5


ROOTS = ("auto", "knm", "nm", "stale")


@pytest.mark.parametrize("roots", ROOTS)
def test_iterative_mll_value_and_gradients_match_jax(roots, jax_eigenbasis,
                                                     monkeypatch):
    """The matrix-free MLL with JAX's own probes (its ``key`` split, xi of
    the roots' rank), CG to 1e-10, a rank-T task noise. "auto": the port
    routed by a lowered ``ICM_DENSE_N_MAX`` and ``precond_rank=0`` (so
    min(256, n)); roots given as (k, n, m) and as (n, m) of rank 8; stale
    rank-12 roots of the unmoved model."""
    X, Y, _ = data()
    lik = JaxMTLik(num_tasks=T, rank=T, dtype=jnp.float64)
    stale = np.asarray(JaxMT(X, Y, lik, **ICM_KW)._precond_roots(
        jnp.asarray(X), 12))
    jm, tm, _ = icm_models(noise_rank=T)
    given = {"auto": None, "knm": np.asarray(jm._precond_roots(jm.train_x, 8)),
             "stale": stale}
    given["nm"] = given["knm"][0]
    r = given[roots]
    m_rank = N if r is None else r.shape[-1]
    key = jax.random.PRNGKey(5)
    k1, k2 = jax.random.split(key)
    eps = jax.random.normal(k1, (6, N, T), jnp.float64)
    xi = jax.random.normal(k2, (6, m_rank, T), jnp.float64)
    kw = dict(num_probes=6, max_cg_iters=100, cg_tol=1e-10,
              precond_rank=0 if r is None else 8)
    jv, jg = jax.jit(jax.value_and_grad(lambda m: m.mll(
        key=key, iterative=True, precond_roots=None if r is None
        else jnp.asarray(r), **kw)))(jm)
    if roots == "auto":
        monkeypatch.setattr(MultitaskGPModel, "ICM_DENSE_N_MAX", N - 1)
    tv = tm.mll(iterative=None if roots == "auto" else True,
                precond_roots=None if r is None else t64(r), eps=t64(eps),
                xi=t64(xi), **kw)
    tv.backward()
    close(tv, jv)
    grads_match(jm, tm, jg)


@pytest.mark.parametrize("route", ["dense", "matrix-free"])
def test_three_fit_steps_match_jax(route, jax_eigenbasis):
    """``fit`` with the default loss (the dense route), and with the
    matrix-free MLL on fixed probes (JAX's draw from one key, rank-8 roots
    rebuilt each step, CG to 1e-10)."""
    jm, tm = icm_models(noise_rank=T)[:2]
    jloss = tloss = None
    if route == "matrix-free":
        key = jax.random.PRNGKey(7)
        k1, k2 = jax.random.split(key)
        eps = jax.random.normal(k1, (4, N, T), jnp.float64)
        xi = jax.random.normal(k2, (4, 8, T), jnp.float64)
        kw = dict(iterative=True, num_probes=4, max_cg_iters=100,
                  cg_tol=1e-10, precond_rank=8)
        jloss = lambda m: m.mll(key=key, **kw)                  # noqa: E731
        tloss = lambda m: m.mll(eps=t64(eps), xi=t64(xi), **kw)  # noqa
    _, jinfo = jax_fit(jm, jloss, n_iter=3, lr=0.05, patience=100)
    _, tinfo = fit(tm, tloss, n_iter=3, lr=0.05, patience=100, device="cpu")
    assert len(tinfo["losses"]) == 3
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-9)


@pytest.mark.parametrize("observed", [True, False])
def test_icm_posterior_and_compute_var_match_jax(observed):
    """The "icm" cache (α), mean, variance, stddev and the confidence
    region; ``compute_var`` (the observed variance, from no cache)."""
    jm, tm, Xs = icm_models(noise_rank=T)

    def jax_side(m):
        c = m.precompute_posterior()
        p = m.posterior(Xs, cache=c, observed=observed)
        return (c["alpha"], p.mean, p.variance, p.stddev,
                *p.confidence_region(), m.compute_var(Xs))
    want = jax.jit(jax_side)(jm)
    tc = tm.precompute_posterior()
    assert tc["kind"] == "icm"
    tp = tm.posterior(t64(Xs), cache=tc, observed=observed)
    got = (tc["alpha"], tp.mean, tp.variance, tp.stddev,
           *tp.confidence_region(), tm.compute_var(t64(Xs)))
    for a, b, what in zip(got, want, ("alpha", "mean", "variance", "stddev",
                                      "lower", "upper", "compute_var")):
        close(a, b, what=what)


def test_icm_iter_posterior_matches_jax(jax_eigenbasis):
    """The matrix-free posterior (PCG at tol 1e-5 with rank-8 Nyström roots
    of K, the Kronecker-factored spectral bound, the inflated whitened
    parts), its power iteration started from JAX's (n, 1) draw from
    PRNGKey(0); ``compute_var`` through it when the route is the default."""
    jm, tm, Xs = icm_models(40, noise_rank=T)
    kw = dict(iterative=True, precond_rank=8)

    def jax_side(m):
        c = m.precompute_posterior(**kw)
        return (c["alpha"], c["R"], c["gam"], c["P_inv"], c["C_inv"],
                *[getattr(m.posterior(Xs, cache=c, observed=o), a)
                  for o in (True, False) for a in ("mean", "variance")])
    want = jax.jit(jax_side)(jm)
    v0 = jax.random.normal(jax.random.PRNGKey(0), (40, 1), jnp.float64)
    tc = tm.precompute_posterior(v0=t64(v0), **kw)
    assert tc["kind"] == "icm_iter"
    got = (tc["alpha"], tc["R"], tc["gam"], tc["P_inv"], tc["C_inv"],
           *[getattr(tm.posterior(t64(Xs), cache=tc, observed=o), a)
             for o in (True, False) for a in ("mean", "variance")])
    for a, b, what in zip(got, want, ("alpha", "R", "gam", "P_inv", "C_inv",
                                      "mean (observed)", "variance (observed)",
                                      "mean", "variance")):
        close(a, b, rtol=1e-8, what=what)


def test_icm_loo_prior_and_introspection_match_jax():
    """``compute_loo`` (detached), ``kernel_cond``, the prior of ``__call__``
    (a ``KronCov``: its dense covariance, variance and log-density with the
    noise), ``task_covar_matrix`` and ``lmc_coefficients``."""
    jm, tm, Xs = icm_models(noise_rank=T)
    y = np.random.default_rng(4).standard_normal((NS, T))

    def jax_side(m):
        p = m(Xs)
        St = m.likelihood.task_covariance()
        return (*m.compute_loo(), m.kernel_cond(), p.mean, p.covar.dense(),
                p.variance, St, m.task_covar_matrix(),
                p.covar.with_noise(St).log_prob_centered(jnp.asarray(y)
                                                         - p.mean))
    js, jr, jcond, jmean, jdense, jvar, St, jB, jlp = jax.jit(jax_side)(jm)
    for a, b in zip(tm.compute_loo(), (js, jr)):
        close(a, b)
        assert not a.requires_grad
    close(tm.kernel_cond(), jcond, rtol=1e-8)
    tp = tm(t64(Xs))
    assert isinstance(tp.covar, KronCov)
    close(tp.mean, jmean)
    close(tp.covar.dense(), jdense)
    close(tp.variance, jvar)
    close(tm.task_covar_matrix(), jB)
    close(tdist.MultitaskMultivariateNormal(
        tp.mean, tp.covar.with_noise(t64(St))).log_prob(t64(y)), jlp)
    np.testing.assert_array_equal(tm.lmc_coefficients(),
                                  jm.lmc_coefficients())


@pytest.mark.parametrize("model_type", ["ICM", "LMC"])
@pytest.mark.parametrize("unpacked", [True, False])
def test_lscales_and_outputscale_match_jax(model_type, unpacked):
    """(n_latents, dims) lengthscales (the ICM's one kernel repeated) and
    the unit outputscales, packed and unpacked."""
    jm, tm, _ = icm_models(model_type=model_type)
    js, ts = jm.lscales(unpacked), tm.lscales(unpacked)
    if not unpacked:
        assert isinstance(ts, list) and len(ts) == len(js) == 1
        js, ts = js[0], ts[0]
    assert ts.shape == np.shape(js) == (Q, 2)
    np.testing.assert_allclose(ts, js, rtol=1e-12)
    np.testing.assert_array_equal(tm.outputscale(unpacked),
                                  jm.outputscale(unpacked))


@pytest.mark.parametrize("fix_diagonal", [False, True])
def test_load_jax_state_carries_an_icm_model(fix_diagonal):
    """Every leaf of a JAX ICM model with a rank-T task noise (its
    ``task_noise_covar_factor``) under the same name and shape; ``raw_var``
    is frozen with ``fix_diagonal`` in both."""
    jm, tm, _ = icm_models(noise_rank=T, fix_diagonal=fix_diagonal)
    want = {k: np.asarray(v) for k, v in _keyed_leaves(jm)}
    state = keyed_state(tm)
    assert sorted(state) == sorted(want)
    assert ".likelihood.task_noise_covar_factor" in state
    assert tuple(state[".covar_factor"].shape) == (T, Q)
    assert tuple(state[".raw_var"].shape) == (T,)
    assert tuple(state[".covar_module.raw_lengthscale"].shape) == (1, 1, 2)
    for k, v in want.items():
        np.testing.assert_array_equal(state[k].detach().numpy(), v)
    assert tm.raw_var.requires_grad == (not fix_diagonal)


def test_icm_with_inducing_points_raises_naming_slice_5():
    """Slice 5 ported the ICM's SGPR route: with ``n_inducing_points`` the
    model builds, and its MLL, gradients and "sgpr" posterior match JAX's
    (``tests/test_torch_sgpr.py`` covers the route in full)."""
    jm, tm, Xs = icm_models(n_inducing_points=8)
    jv, jg = jax.jit(jax.value_and_grad(lambda m: m.mll()))(jm)
    tv = tm.mll()
    tv.backward()
    close(tv, jv)
    assert ".inducing_points" in grads_match(jm, tm, jg)
    want = jax.jit(lambda m: m.posterior(Xs).variance)(jm)
    assert tm.precompute_posterior()["kind"] == "sgpr"
    close(tm.posterior(t64(Xs)).variance, want)
