"""The port's prediction against the JAX package's, on the CPU in float64:
the exact GP's prior, posterior and LOO (and ``loo_pseudo_likelihood``),
the LMC model's dense Woodbury MLL, posteriors ("lmc" and "lmc_iter") and
LOO, the projected LMC's prediction in the experiments' model
configurations, ``compute_metrics`` and the distributions.

The JAX models' leaves, moved off their defaults, are carried into the port
with ``load_jax_state``. Values to rtol 1e-10 (with an absolute floor of
1e-10 of the array's largest entry), gradients to 1e-7, the iterative LMC
posterior to 1e-8 (its spectral bound started from JAX's own draw), three
``fit`` steps to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu import distributions as jdist
from projected_lmc_tpu.likelihoods import GaussianLikelihood as JaxLik
from projected_lmc_tpu.metrics import compute_metrics as jax_metrics
from projected_lmc_tpu.mlls import loo_pseudo_likelihood as jax_loo_ll
from projected_lmc_tpu.mlls import projected_lmc_mll as jax_proj_mll
from projected_lmc_tpu.models.exact import ExactGPModel as JaxExact
from projected_lmc_tpu.models.multitask import MultitaskGPModel as JaxLMC
from projected_lmc_tpu.models.projected import ProjectedGPModel as JaxProj
from projected_lmc_tpu.module import trainable_mask
from projected_lmc_tpu.ops.iterative import draw_probes as jit_draw_probes
from projected_lmc_tpu.training import fit as jax_fit
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import (ExactGPModel, GaussianLikelihood,
                                     MultitaskGPModel, ProjectedGPModel,
                                     compute_metrics, fit, load_jax_state,
                                     loo_pseudo_likelihood, projected_lmc_mll)
from projected_lmc_tpu_torch import distributions as tdist
from projected_lmc_tpu_torch.likelihoods import FixedTaskNoise

N, NS, T, Q = 24, 10, 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny torch ops in loops: one intra-op thread avoids oversubscribing
    the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# -- the exact GP ---------------------------------------------------------------

def exact_models(n_tasks=T):
    X, Y, Xs = data()
    Y = Y[:, :n_tasks] if n_tasks > 1 else Y[:, 0]
    kw = dict(n_tasks=n_tasks, kernel_type="matern", outputscales=True,
              mean_type="constant")
    jm = JaxExact(X, Y, JaxLik(batch_shape=n_tasks, dtype=jnp.float64), **kw)
    tm = ExactGPModel(X, Y, GaussianLikelihood(
        batch_shape=n_tasks, dtype=torch.float64, device="cpu"),
        device="cpu", **kw)
    return (*carried(jm, tm), Xs)


@pytest.mark.parametrize("full_cov", [True, False])
def test_exact_posterior_matches_jax(full_cov):
    jm, tm, Xs = exact_models()
    y = np.random.default_rng(3).standard_normal((T, NS))

    def jax_side(m):
        c = m.precompute_posterior()
        p = m.posterior(Xs, cache=c, full_cov=full_cov)
        return (c["L"], c["alpha"], p.mean, p.variance, p.covariance_matrix,
                p.log_prob(y))
    want = jax.jit(jax_side)(jm)
    tc = tm.precompute_posterior()
    assert tc["kind"] == "exact"
    tp = tm.posterior(t64(Xs), cache=tc, full_cov=full_cov)
    got = (tc["L"], tc["alpha"], tp.mean, tp.variance, tp.covariance_matrix,
           tp.log_prob(t64(y)))
    for a, b, what in zip(got, want, ("L", "alpha", "mean", "variance",
                                      "covariance", "log_prob")):
        close(a, b, what=what)


def test_exact_prior_forward_and_kernel_cond_match_jax():
    """The prior (from numpy inputs), ``__call__`` (the prior,
    multitask-wrapped under a non-Gaussian likelihood) and the condition
    numbers."""
    jm, tm, Xs = exact_models()
    jmean, jcov, jcall, jcond = jax.jit(lambda m: (
        m.prior(Xs).mean, m.prior(Xs).covariance_matrix,
        m(Xs).covariance_matrix, m.kernel_cond()))(jm)
    tp = tm.prior(Xs)
    close(tp.mean, jmean)
    close(tp.covariance_matrix, jcov)
    close(tm(t64(Xs)).covariance_matrix, jcall)
    close(tm.kernel_cond(), jcond, rtol=1e-8)
    tm.likelihood = FixedTaskNoise(torch.eye(T, dtype=torch.float64))
    wrapped = tm(t64(Xs))
    assert isinstance(wrapped, tdist.MultitaskMultivariateNormal)
    close(wrapped.variance, np.diagonal(jcov, axis1=-2, axis2=-1).T)


@pytest.mark.parametrize("n_tasks", [1, T])
def test_exact_compute_loo_matches_jax(n_tasks):
    """σ² and y − μ, detached with several outputs only; ``complex_mean``
    raises for the ported means, as in JAX."""
    jm, tm, _ = exact_models(n_tasks)
    js, jr = jax.jit(lambda m: m.compute_loo())(jm)
    ts, tr = tm.compute_loo()
    close(ts, js, what="sigma2")
    close(tr, jr, what="y - mu")
    assert ts.requires_grad == (n_tasks == 1)
    with pytest.raises(ValueError):
        jm.compute_loo(complex_mean=True)
    with pytest.raises(ValueError):
        tm.compute_loo(complex_mean=True)


def test_loo_pseudo_likelihood_value_and_gradients_match_jax():
    """On a single-output model, which trains through it: value and every
    trainable leaf's gradient, by key path."""
    jm, tm, _ = exact_models(1)
    mask = trainable_mask(jm)
    jv, jg = jax.jit(jax.value_and_grad(jax_loo_ll))(jm)
    tv = loo_pseudo_likelihood(tm)
    tv.backward()
    close(tv, jv)
    grads = dict(_keyed_leaves(jg))
    names = [k for (k, _), m in zip(_keyed_leaves(jm), mask) if m]
    params = dict(tm.named_parameters())
    for k in names:
        close(params[k[1:]].grad, grads[k], rtol=1e-7, what=k)
    assert len(names) >= 4


# -- the LMC model ----------------------------------------------------------------

LMC_KW = dict(n_tasks=T, n_latents=Q, model_type="LMC", kernel_type="matern",
              mean_type="constant")


def lmc_models(n=N):
    X, Y, Xs = data(n)
    jm = JaxLMC(X, Y, **LMC_KW)
    tm = MultitaskGPModel(X, Y, device="cpu", **LMC_KW)
    return (*carried(jm, tm), Xs)


def test_dense_woodbury_mll_value_and_gradients_match_jax():
    """``mll()`` with its defaults takes the dense Woodbury route at
    q·n ≤ 4096, in both packages."""
    jm, tm, _ = lmc_models()
    mask = trainable_mask(jm)
    jv, jg = jax.jit(jax.value_and_grad(lambda m: m.mll()))(jm)
    tv = tm.mll()
    tv.backward()
    close(tv, jv)
    grads = dict(_keyed_leaves(jg))
    params = dict(tm.named_parameters())
    names = [k for (k, _), m in zip(_keyed_leaves(jm), mask) if m]
    for k in names:
        close(params[k[1:]].grad, grads[k], rtol=1e-7, what=k)
    assert len(names) >= 5


def test_three_fit_steps_with_the_default_loss_match_jax():
    jm, tm = lmc_models()[:2]
    _, jinfo = jax_fit(jm, n_iter=3, lr=0.05, patience=100)
    _, tinfo = fit(tm, n_iter=3, lr=0.05, patience=100, device="cpu")
    assert len(tinfo["losses"]) == 3
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-9)


@pytest.mark.parametrize("observed", [True, False])
def test_lmc_posterior_matches_jax(observed):
    jm, tm, Xs = lmc_models()

    def jax_side(m):
        c = m.precompute_posterior()
        p = m.posterior(Xs, cache=c, observed=observed)
        return (c["alpha"], c["fac"]["L_cap"], p.mean, p.variance, p.stddev,
                *p.confidence_region())
    want = jax.jit(jax_side)(jm)
    tc = tm.precompute_posterior()
    assert tc["kind"] == "lmc"
    tp = tm.posterior(t64(Xs), cache=tc, observed=observed)
    got = (tc["alpha"], tc["fac"]["L_cap"], tp.mean, tp.variance, tp.stddev,
           *tp.confidence_region())
    for a, b, what in zip(got, want, ("alpha", "L_cap", "mean", "variance",
                                      "stddev", "lower", "upper")):
        close(a, b, what=what)


def test_lmc_iter_posterior_matches_jax():
    """The matrix-free posterior (PCG at tol 1e-5 with a rank-8 Nyström
    preconditioner, the residual's spectral bound, the inflated factors),
    its power iteration started from JAX's draw from PRNGKey(0)."""
    jm, tm, Xs = lmc_models(40)
    kw = dict(iterative=True, precond_rank=8)

    def jax_side(m):
        c = m.precompute_posterior(**kw)
        return (c["alpha"], c["fac"]["L_cap"],
                *[getattr(m.posterior(Xs, cache=c, observed=o), a)
                  for o in (True, False) for a in ("mean", "variance")])
    want = jax.jit(jax_side)(jm)
    v0 = jax.random.normal(jax.random.PRNGKey(0), (40, T), jnp.float64)
    tc = tm.precompute_posterior(v0=t64(v0), **kw)
    assert tc["kind"] == "lmc_iter"
    got = (tc["alpha"], tc["fac"]["L_cap"],
           *[getattr(tm.posterior(t64(Xs), cache=tc, observed=o), a)
             for o in (True, False) for a in ("mean", "variance")])
    for a, b, what in zip(got, want, ("alpha", "L_cap", "mean (observed)",
                                      "variance (observed)", "mean",
                                      "variance")):
        close(a, b, rtol=1e-8, what=what)


def test_lmc_loo_prior_and_introspection_match_jax():
    """``compute_loo`` (detached), ``kernel_cond``, the prior of
    ``__call__`` (its dense covariance and log-density with the noise),
    ``lmc_coefficients``; ``compute_var`` is ICM-only in both."""
    jm, tm, Xs = lmc_models()
    y = np.random.default_rng(4).standard_normal((NS, T))

    def jax_side(m):
        p = m(Xs)
        St = m.likelihood.task_covariance()
        return (*m.compute_loo(), m.kernel_cond(), p.mean, p.covar.dense(),
                p.variance, St, jdist.MultitaskMultivariateNormal(
                    p.mean, p.covar.with_noise(St)).log_prob(y))
    js, jr, jcond, jmean, jdense, jvar, St, jlp = jax.jit(jax_side)(jm)
    for a, b in zip(tm.compute_loo(), (js, jr)):
        close(a, b)
        assert not a.requires_grad
    close(tm.kernel_cond(), jcond, rtol=1e-8)
    tp = tm(t64(Xs))
    close(tp.mean, jmean)
    close(tp.covar.dense(), jdense)
    close(tp.variance, jvar)
    close(tdist.MultitaskMultivariateNormal(
        tp.mean, tp.covar.with_noise(t64(St))).log_prob(t64(y)), jlp)
    np.testing.assert_array_equal(tm.lmc_coefficients(),
                                  jm.lmc_coefficients())
    for m, x in ((jm, Xs), (tm, t64(Xs))):
        with pytest.raises(ValueError):
            m.compute_var(x)


# -- the projected LMC -------------------------------------------------------------

PROJ = {"PLMC": dict(BDN=False, diagonal_B=False, scalar_B=False,
                     diagonal_R=False),
        "PLMC_fast": dict(BDN=True, diagonal_B=True, scalar_B=True,
                          diagonal_R=False),
        "oilmm": dict(BDN=True, diagonal_B=True, scalar_B=True,
                      diagonal_R=True),
        "oilmm_factored": dict(BDN=True, diagonal_B=True, scalar_B=True,
                               diagonal_R=True, bulk=False)}


@pytest.mark.parametrize("cfg", sorted(PROJ))
def test_projected_prediction_matches_jax(cfg):
    """The experiments' configurations (oilmm also factored, ``bulk=False``):
    the cache, the latent posterior both ways, the latent prior, LOO,
    ``predict`` observed and not (with and without a cache) and
    ``__call__``'s mean and covariance."""
    X, Y, Xs = data(p=5)
    kw = dict(init_lmc_coeffs=True, kernel_type="matern", **PROJ[cfg])
    jm, tm = carried(JaxProj(X, Y, 5, Q, **kw),
                     ProjectedGPModel(X, Y, 5, Q, device="cpu", **kw))
    what = ("cache alpha", "latent mean", "latent variance",
            "latent mean (diagonal)", "latent variance (diagonal)",
            "latent prior", "loo sigma2", "loo y - mu") + tuple(
        f"{name} observed={o}" for o in (True, False) for name in (
            "predict mean", "predict variance", "__call__ mean",
            "__call__ variance", "__call__ covariance"))

    def side(m, x, pre):
        c = m.prediction_cache()
        out = [c["alpha"]]
        for full_cov in (True, False):
            lat = m.compute_latent_distrib(x, full_cov=full_cov, cache=c)
            out += [lat.mean, lat.variance]
        out += [m.latent_prior(x).covariance_matrix, *m.compute_loo()]
        for o in (True, False):
            d = m(x, observed=o)
            out += [*m.predict(x, observed=o, cache=pre(c)), d.mean,
                    d.variance, d.covar.dense()]
        return out
    want = jax.jit(lambda m: side(m, Xs, lambda c: c))(jm)
    for pre in (lambda c: c, lambda c: None):      # with and without a cache
        got = side(tm, t64(Xs), pre)
        for a, b, w in zip(got, want, what):
            close(a, b, what=w)


# -- metrics and distributions -------------------------------------------------------

def test_compute_metrics_gives_the_same_dict():
    """The 15 names and values, from numpy arrays or tensors, with and
    without a test mask."""
    rng = np.random.default_rng(5)
    y, yp = rng.standard_normal((2, 50, 4))
    sigma = rng.uniform(0.2, 1.5, (50, 4))
    H = rng.standard_normal((2, 4))
    mask = rng.uniform(size=50) < 0.7
    args = (3.25, H, 120, 1.5, 0.25)
    for kw in ({}, dict(test_mask=mask)):
        want = jax_metrics(y, yp, sigma, *args, print_metrics=False, **kw)
        got = compute_metrics(t64(y), t64(yp), t64(sigma), torch.tensor(3.25),
                              *args[1:], print_metrics=False, **kw)
        assert list(got) == list(want) and len(got) == 15
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_distributions_match_jax():
    rng = np.random.default_rng(6)
    n, t = 5, 3
    F = rng.standard_normal((t, n, n))
    covs = F @ F.transpose(0, 2, 1) + np.eye(n)
    mean = rng.standard_normal((t, n))
    y = rng.standard_normal((t, n))
    Ks, H = covs[:2], rng.standard_normal((t, 2))
    St = np.diag(rng.uniform(0.5, 1.0, t))
    noise = np.full((t, n), 0.3)

    def side(d, a):
        mvn = d.MultivariateNormal(a(mean), a(covs))
        mt = d.MultitaskMultivariateNormal.from_batch_mvn(mvn)
        dense = mt.covar.dense()
        dc = d.DenseCov(dense, n, t)
        out = [mvn.log_prob(a(y)), mvn.stddev,
               mvn.add_noise_diag(a(noise)).covariance_matrix,
               *mvn.confidence_region(3.0), mt.variance,
               mt.log_prob(a(y.T)), mt.to_dense().covariance_matrix,
               dc.diag(), dc.log_prob_centered(a(y.T))]
        for s in (None, a(St)):
            kr = d.SumKronRank1Cov(a(Ks), a(H), s)
            out += [kr.diag(), kr.dense()]
        return out + [kr.log_prob_centered(a(y.T))]
    want = jax.jit(lambda: side(jdist, jnp.asarray))()
    for a, b in zip(side(tdist, t64), want):
        close(a, b)
    tm = tdist.MultivariateNormal(t64(mean), t64(covs))
    assert tuple(tm.batch_shape) == (t,) and tuple(tm.event_shape) == (n,)
    draws = [tm.sample(torch.Generator().manual_seed(0), (4,))
             for _ in range(2)]
    assert draws[0].shape == (4, t, n) and torch.equal(draws[0], draws[1])


# -- the routes that raised until their slice was ported -------------------------

def _sgpr_models(make, X, Y):
    """A JAX model and the port's, built alike with 8 inducing points, the
    port carrying the JAX leaves."""
    jm, tm = make(X, Y, True), make(X, Y, False)
    load_jax_state(tm, {k: np.asarray(v) for k, v in _keyed_leaves(jm)})
    return jm, tm


def _sgpr_exact(X, Y, jax_side):
    if jax_side:
        return JaxExact(X, Y[:, 0], JaxLik(dtype=jnp.float64),
                        n_inducing_points=8)
    return ExactGPModel(X, Y[:, 0], GaussianLikelihood(dtype=torch.float64,
                                                       device="cpu"),
                        n_inducing_points=8, device="cpu")


def _sgpr_multitask(**kw):
    def make(X, Y, jax_side):
        if jax_side:
            return JaxLMC(X, Y, n_inducing_points=8, **kw)
        return MultitaskGPModel(X, Y, n_inducing_points=8, device="cpu",
                                **kw)
    return make


def _sgpr_projected(X, Y, jax_side):
    cls, kw = (JaxProj, {}) if jax_side else (ProjectedGPModel,
                                               dict(device="cpu"))
    return cls(X, Y, T, Q, n_inducing_points=8, **kw)


def _mll(m):
    return projected_lmc_mll(m) if isinstance(m, ProjectedGPModel) \
        else m.mll()


def _jax_mll(m):
    return jax_proj_mll(m) if isinstance(m, JaxProj) else m.mll()


def _slq_lmc(X, Y, jax_side):
    cls, kw = (JaxLMC, {}) if jax_side else (MultitaskGPModel,
                                             dict(device="cpu"))
    return cls(X, Y, **LMC_KW, **kw)


# slices 5 (SGPR) and 6 (the unpreconditioned SLQ route) are ported: each
# route builds, and its MLL and posterior variance match JAX's
UNPORTED = {
    "sgpr-exact": ("slice 5", _sgpr_exact),
    "sgpr-lmc": ("slice 5", _sgpr_multitask(**LMC_KW)),
    "sgpr-projected": ("slice 5", _sgpr_projected),
    "icm": ("slice 5", _sgpr_multitask(n_tasks=T, model_type="ICM")),
    "slq": ("slice 6", _slq_lmc),
}
SLQ_KW = dict(iterative=True, precond_rank=0, max_cg_iters=200, cg_tol=1e-12,
              num_probes=4)


def _variance(m, x):
    if isinstance(m, (ProjectedGPModel, JaxProj)):
        return m.predict(x, cache=m.prediction_cache())[1]
    return m.posterior(x).variance


@pytest.mark.parametrize("route", sorted(UNPORTED))
def test_unported_routes_name_their_slice(route):
    X, Y, Xs = data()
    slice_, make = UNPORTED[route]
    if slice_ == "slice 6":
        jm, tm = _sgpr_models(make, X, Y)
        probes = t64(jit_draw_probes(jax.random.PRNGKey(0), N, T, 4,
                                     jnp.float64))
        want = jax.jit(lambda m: (m.mll(**SLQ_KW), _variance(m, Xs)))(jm)
        with torch.no_grad():
            close(tm.mll(probes=probes, **SLQ_KW), want[0], rtol=1e-9)
            close(_variance(tm, t64(Xs)), want[1])
        return
    jm, tm = _sgpr_models(make, X, Y)
    assert tm.sgpr
    want = jax.jit(lambda m: (_jax_mll(m), _variance(m, Xs)))(jm)
    with torch.no_grad():
        close(_mll(tm), want[0])
        close(_variance(tm, t64(Xs)), want[1])
