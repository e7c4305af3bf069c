"""The port's variational LMC (``VariationalMultitaskGPModel``) against the
JAX package's, on the CPU in float64: its construction (the QMC inducing
points, the strategies and distributions, the unwhitened prior init), for
each strategy × distribution ``compute_latent_distrib`` (full and
diagonal, and the prior), ``kl_divergence``, ``forward`` and the ELBO with
its gradients (the inducing points' included), the closed-form
``sgpr_warm_start``, ``noise_mstep`` and ``sgpr_em``, three ``fit`` steps,
``fit_svgp_minibatch`` on JAX's own index draws, the QMC samplers and the
likelihoods' ``noise``/``set_noise``.

Both models are built from the same arguments and their drawn leaves
compared before the JAX leaves, moved off their defaults, are carried into
the port with ``load_jax_state``. Values to rtol 1e-10 (with an absolute
floor of 1e-10 of the array's largest entry), gradients by key path to
1e-7, the E/M steps to 1e-8, ``fit`` steps to 1e-9. The JAX side is jitted.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.likelihoods import GaussianLikelihood as JaxLik
from projected_lmc_tpu.likelihoods import \
    MultitaskGaussianLikelihood as JaxMTLik
from projected_lmc_tpu.models.variational import \
    VariationalMultitaskGPModel as JaxVar
from projected_lmc_tpu.module import trainable_mask
from projected_lmc_tpu.ops import init_ops as jinit
from projected_lmc_tpu.training import fit as jax_fit
from projected_lmc_tpu.training import fit_svgp_minibatch as jax_svgp
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import (GaussianLikelihood,
                                     MultitaskGaussianLikelihood,
                                     VariationalMultitaskGPModel, fit,
                                     fit_svgp_minibatch, load_jax_state)
from projected_lmc_tpu_torch import training as ttraining
from projected_lmc_tpu_torch.module import keyed_state
from projected_lmc_tpu_torch.ops import init_ops as tinit

N, NS, T, Q = 30, 10, 3, 2
STRATEGIES = ("whitened", "unwhitened")
DISTRIBS = ("cholesky", "mean_field", "delta")


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


def same_leaves(jm, tm, rtol=1e-12):
    """The same key paths and, to ``rtol``, the same values."""
    arrays = {k: np.asarray(v) for k, v in _keyed_leaves(jm)}
    state = keyed_state(tm)
    assert sorted(state) == sorted(arrays)
    for k, v in arrays.items():
        np.testing.assert_allclose(state[k].detach().numpy(), v, rtol=rtol,
                                   atol=rtol * max(np.abs(v).max(initial=0),
                                                   1e-300), err_msg=k)
    return arrays


def carried(jm, tm, seed=2):
    """Check that both models drew the same leaves, then move the JAX
    model's trainable leaves by uniform(−0.3, 0.3) (±0.1 on the variational
    factors, which stay well inside the prior) and carry every leaf into
    the port model; returns both."""
    arrays = same_leaves(jm, tm)
    rng = np.random.default_rng(seed)
    for (k, _), trainable in zip(_keyed_leaves(jm), trainable_mask(jm)):
        if trainable:
            w = 0.1 if k.startswith(".var_chol") else 0.3
            arrays[k] = arrays[k] + rng.uniform(-w, w, arrays[k].shape)
    jm = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jm),
        [jnp.asarray(arrays[k]) for k, _ in _keyed_leaves(jm)])
    load_jax_state(tm, arrays)
    return jm, tm


def var_models(move=True, noise_rank=0, n=N, **kw):
    """A JAX variational model and the port's, built from the same
    arguments (LHC inducing points, m = n / 3), carrying the same leaves,
    moved unless ``move`` is False."""
    X, Y, Xs = data(n)
    kw = dict(dict(n_latents=Q, train_y=Y, train_ind_ratio=3.0,
                   kernel_type="matern", seed=3), **kw)
    lik_kw = dict(num_tasks=T, rank=noise_rank)
    jm = JaxVar(X, likelihood=JaxMTLik(dtype=jnp.float64, **lik_kw), **kw)
    tm = VariationalMultitaskGPModel(X, likelihood=MultitaskGaussianLikelihood(
        dtype=torch.float64, device="cpu", **lik_kw), device="cpu", **kw)
    if not move:
        same_leaves(jm, tm)
        return jm, tm, Xs
    return (*carried(jm, tm), Xs)


def grads_match(jm, tm, jg, rtol=1e-7):
    grads = dict(_keyed_leaves(jg))
    params = dict(tm.named_parameters())
    names = [k for (k, _), m in zip(_keyed_leaves(jm), trainable_mask(jm))
             if m]
    assert sorted(k[1:] for k in names) == sorted(
        k for k, p in params.items() if p.requires_grad)
    for k in names:
        close(params[k[1:]].grad, grads[k], rtol=rtol, what=k)
    return names


# -- construction ---------------------------------------------------------------

CONSTRUCT = {
    "lhc": dict(),
    "sobol": dict(ind_point_method="sobol", seed=5),
    "data-range": dict(ind_point_range="data", var_strat="unwhitened"),
    "given-range": dict(ind_point_range=((-2.0, 0.0), (2.0, 0.5)),
                        distrib="mean_field", var_strat="unwhitened"),
    "svd-init": dict(init_lmc_coeffs=True, mean_type="zero",
                     outputscales=True),
    "ratio-one": dict(train_ind_ratio=1.0, distrib="mean_field"),
}


@pytest.mark.parametrize("case", sorted(CONSTRUCT))
def test_construction_draws_the_jax_leaves(case):
    """The inducing points (LHC or Sobol' in [−1, 1]^d, the data's box or a
    given one; the training inputs, frozen, at ratio 1, which forces the
    unwhitened strategy and a Cholesky distribution), ``lmc_coeffs``
    (default_rng(seed) or the SVD), the unwhitened prior init of q(u), and
    which leaves train."""
    jm, tm, _ = var_models(move=False, **CONSTRUCT[case])
    assert (tm.whitened, tm.distrib) == (jm.whitened, jm.distrib)
    # (the JAX zero mean's empty placeholder is a buffer in the port)
    want = {k for (k, v), m in zip(_keyed_leaves(jm), trainable_mask(jm))
            if m and np.size(v)}
    got = {"." + k for k, p in tm.named_parameters() if p.requires_grad}
    assert got == want
    if case == "ratio-one":
        assert not tm.whitened and tm.distrib == "cholesky"
        assert not tm.inducing_points.requires_grad
        assert tuple(tm.inducing_points.shape) == (N, 2)
    else:
        assert tuple(tm.inducing_points.shape) == (N // 3, 2)
    np.testing.assert_array_equal(tm.lmc_coefficients(),
                                  jm.lmc_coefficients())


def test_bad_arguments_raise_as_in_jax():
    X, Y, _ = data()
    for cls, kw in ((JaxVar, {}), (VariationalMultitaskGPModel,
                                   dict(device="cpu"))):
        for bad in (dict(var_strat="natural"), dict(distrib="full")):
            with pytest.raises(ValueError, match="unknown variational"):
                cls(X, Q, train_y=Y, **bad, **kw)
        m = cls(X, Q, n_tasks=T, **kw)
        for step in (m.sgpr_warm_start, m.noise_mstep):
            with pytest.raises(ValueError, match="requires train_y"):
                step()


# -- the variational machinery, for each strategy and distribution ---------------

@pytest.mark.parametrize("distrib", DISTRIBS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_latents_kl_forward_and_elbo_match_jax(strategy, distrib):
    """``compute_latent_distrib`` (full, diagonal, prior both ways),
    ``kl_divergence``, ``forward`` observed and not (from numpy inputs),
    the ELBO on the training data and on a minibatch with the full n, and
    the ELBO's gradients, the inducing points' among them."""
    jm, tm, Xs = var_models(var_strat=strategy, distrib=distrib)
    X, Y, _ = data()
    idx = np.random.default_rng(4).integers(0, N, 8)

    def side(m, x, xb, yb):
        out = []
        for full_cov in (True, False):
            for prior in (False, True):
                out += list(m.compute_latent_distrib(x, full_cov=full_cov,
                                                     prior=prior))
        out.append(m.kl_divergence())
        for o in (False, True):
            p = m(x, observed=o)
            out += [p.mean, p.variance, p.stddev]
        return out + [m.elbo(x=xb, y=yb, num_data=N)]
    want = jax.jit(lambda m: side(m, Xs, X[idx], Y[idx]))(jm)
    with torch.no_grad():
        got = side(tm, Xs, t64(X[idx]), t64(Y[idx]))
    for i, (a, b) in enumerate(zip(got, want)):
        close(a, b, what=str(i))
    jv, jg = jax.jit(jax.value_and_grad(lambda m: m.elbo()))(jm)
    tv = tm.elbo()
    tv.backward()
    close(tv, jv)
    assert ".inducing_points" in grads_match(jm, tm, jg)


def test_ratio_one_frozen_inducing_elbo_matches_jax():
    """At ``train_ind_ratio == 1`` the inducing points are the frozen
    training inputs (unwhitened, Cholesky): no gradient reaches them."""
    jm, tm, _ = var_models(train_ind_ratio=1.0, n=16)
    jv, jg = jax.jit(jax.value_and_grad(lambda m: m.elbo()))(jm)
    tv = tm.elbo()
    tv.backward()
    close(tv, jv)
    assert ".inducing_points" not in grads_match(jm, tm, jg)
    assert tm.inducing_points.grad is None


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_three_fit_steps_on_the_elbo_match_jax(strategy):
    """AdamW's weight decay acts on the whole (q, m, m) ``var_chol`` leaf,
    its upper triangle included, as optax's does."""
    jm, tm = var_models(var_strat=strategy, outputscales=True)[:2]
    _, jinfo = jax_fit(jm, lambda m: m.elbo(), n_iter=3, lr=0.05,
                       patience=100)
    _, tinfo = fit(tm, lambda m: m.elbo(), n_iter=3, lr=0.05, patience=100,
                   device="cpu")
    assert len(tinfo["losses"]) == 3
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-9)


def test_fit_svgp_minibatch_on_jax_index_draws_matches_jax(monkeypatch):
    """Three minibatch steps (batch 8, the 'mean' criterion for 'max'), the
    port fed the indices JAX's loop draws: a key split each step, then
    ``choice`` with replacement."""
    jm, tm = var_models()[:2]
    key, draws = jax.random.PRNGKey(11), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.choice(sub, N, (8,),
                                                  replace=True)))
    fed = iter(draws)
    monkeypatch.setattr(ttraining, "_draw_batch",
                        lambda g, n, b: torch.tensor(next(fed)))
    kw = dict(batch_size=8, n_iter=3, lr=0.05, patience=2, seed=11)
    _, jinfo = jax_svgp(jm, scan_steps=1, **kw)
    _, tinfo = fit_svgp_minibatch(tm, device="cpu", **kw)
    assert len(tinfo["losses"]) == 3
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-9)


def test_fit_svgp_minibatch_draws_from_its_generator():
    """Without a hook: batch indices from a ``torch.Generator`` seeded with
    ``seed``, so two runs from one state take the same steps; a batch
    larger than n is cut to n."""
    runs = []
    for _ in range(2):
        tm = var_models(move=False)[1]
        _, info = fit_svgp_minibatch(tm, batch_size=10, n_iter=4, seed=1,
                                     device="cpu")
        runs.append(info["losses"])
    assert np.all(np.isfinite(runs[0])) and len(runs[0]) == 4
    np.testing.assert_array_equal(runs[0], runs[1])
    tm = var_models(move=False, n=12)[1]
    _, info = fit_svgp_minibatch(tm, batch_size=64, n_iter=2, device="cpu")
    assert np.all(np.isfinite(info["losses"]))


# -- the closed-form E and M steps ------------------------------------------------

EM_CASES = {"whitened-cholesky": dict(),
            "whitened-delta": dict(distrib="delta"),
            "unwhitened-mean-field": dict(var_strat="unwhitened",
                                          distrib="mean_field")}


@pytest.mark.parametrize("case", sorted(EM_CASES))
def test_sgpr_warm_start_matches_jax(case):
    """The E-step at the moved leaves: ``var_mean`` and the variational
    factor (whitened against the runtime L_zz), with the default noise and
    a given one."""
    jm, tm, _ = var_models(**EM_CASES[case])
    for noise in (None, 0.05):
        want = {k: np.asarray(v) for k, v in _keyed_leaves(
            jm.sgpr_warm_start(noise=noise))}
        got = keyed_state(tm.sgpr_warm_start(noise=noise))
        for k in (".var_mean", ".var_chol", ".var_chol_diag"):
            if k in want:
                close(got[k], want[k], rtol=1e-8, what=k)


def _noise_leaves(lik):
    return [lik.task_covariance(), lik.noise] + (
        [lik.task_noises] if lik.has_task_noise and lik.rank == 0 else [])


@pytest.mark.parametrize("kind", ["rank-0", "rank-0-global-only", "rank-2"])
def test_noise_mstep_matches_jax(kind):
    """The M-step for a diagonal task noise (with and without per-task
    noises) and a rank-2 one (PPCA-style; the factor's columns are
    eigenvectors, compared up to sign, and Σt itself)."""
    rank = 2 if kind == "rank-2" else 0
    task = kind != "rank-0-global-only"
    X, Y, _ = data()
    kw = dict(n_latents=Q, train_y=Y, train_ind_ratio=3.0,
              kernel_type="matern", seed=3)
    lik = dict(num_tasks=T, rank=rank, has_task_noise=task)
    jm, tm = carried(
        JaxVar(X, likelihood=JaxMTLik(dtype=jnp.float64, **lik), **kw),
        VariationalMultitaskGPModel(X, likelihood=MultitaskGaussianLikelihood(
            dtype=torch.float64, device="cpu", **lik), device="cpu", **kw))
    jl = jm.noise_mstep().likelihood
    tl = tm.noise_mstep().likelihood
    for a, b in zip(_noise_leaves(tl), _noise_leaves(jl)):
        close(a, b, rtol=1e-8)
    if rank:
        F, G = tl.task_noise_covar_factor.detach().numpy(), np.asarray(
            jl.task_noise_covar_factor)
        close(F * np.sign(F[0] * G[0]), G, rtol=1e-8)


def test_sgpr_em_matches_jax():
    """Three rounds of the E- and M-steps, ending on the M-step; then the
    ELBO on the result."""
    jm, tm, _ = var_models(noise_rank=0)
    jm = jm.sgpr_em(n_steps=3)
    assert tm.sgpr_em(n_steps=3) is tm
    for k, v in _keyed_leaves(jm):
        close(keyed_state(tm)[k], v, rtol=1e-8, what=k)
    close(tm.elbo(), jax.jit(lambda m: m.elbo())(jm), rtol=1e-8)


# -- introspection, state and the QMC samplers ---------------------------------------

def test_introspection_matches_jax():
    for kw in (dict(), dict(outputscales=True)):
        jm, tm, _ = var_models(**kw)
        np.testing.assert_allclose(tm.lscales(), jm.lscales(), rtol=1e-12)
        np.testing.assert_allclose(tm.lscales(unpacked=False),
                                   jm.lscales(unpacked=False), rtol=1e-12)
        for u in (True, False):
            np.testing.assert_allclose(tm.outputscale(u), jm.outputscale(u),
                                       rtol=1e-12)
        np.testing.assert_array_equal(tm.lmc_coefficients(),
                                      jm.lmc_coefficients())


@pytest.mark.parametrize("method", ["latin_hypercube", "sobol"])
@pytest.mark.parametrize("with_scipy", [True, False])
def test_qmc_samplers_are_the_jax_ones(method, with_scipy, monkeypatch):
    """scipy's scrambled samplers with the same seed, and without scipy the
    same numpy fallback."""
    if not with_scipy:
        monkeypatch.setitem(sys.modules, "scipy.stats", None)
    for n, d, seed in ((10, 2, 0), (33, 3, 4)):
        got = getattr(tinit, method)(n, d, seed=seed)
        want = getattr(jinit, method)(n, d, seed=seed)
        assert got.shape == (n, d)
        np.testing.assert_array_equal(got, want)


# -- the likelihoods -----------------------------------------------------------------

def test_likelihood_noise_and_set_noise_match_jax():
    """``set_noise`` on both likelihoods (in place, returning the
    likelihood) and the multitask ``noise`` without a global noise: zeros,
    as in JAX."""
    jl = JaxLik(batch_shape=3, dtype=jnp.float64).set_noise(
        np.array([0.2, 0.3, 0.4])[:, None])
    tl = GaussianLikelihood(batch_shape=3, dtype=torch.float64, device="cpu")
    assert tl.set_noise(t64([0.2, 0.3, 0.4])[:, None]) is tl
    close(tl.noise, jl.noise)
    close(tl.raw_noise, jl.raw_noise)
    close(tl.set_noise(0.05).noise, jl.set_noise(0.05).noise)
    for rank in (0, 2):
        jm = JaxMTLik(T, rank=rank, dtype=jnp.float64).set_noise(0.7)
        tm = MultitaskGaussianLikelihood(T, rank=rank, dtype=torch.float64,
                                         device="cpu")
        assert tm.set_noise(0.7) is tm
        close(tm.noise, jm.noise)
        close(tm.task_covariance(), jm.task_covariance())
        jm = JaxMTLik(T, rank=rank, has_global_noise=False,
                      dtype=jnp.float64)
        tm = MultitaskGaussianLikelihood(T, rank=rank, has_global_noise=False,
                                         dtype=torch.float64, device="cpu")
        np.testing.assert_array_equal(tm.noise.numpy(), np.asarray(jm.noise))
        assert tm.noise.dtype == torch.float64
        close(tm.task_covariance(), jm.task_covariance())
