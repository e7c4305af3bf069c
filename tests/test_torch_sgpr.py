"""The port's Titsias SGPR routes against the JAX package's, on the CPU in
float64: ``ExactGPModel``, ``MultitaskGPModel`` (LMC and ICM) and
``ProjectedGPModel`` built with ``n_inducing_points`` (their MLLs with the
inducing points' gradients, three ``fit`` steps, the "sgpr" caches and
posteriors, LOO, the Nyström prior) and ``woodbury.lmc_sgpr_posterior``.

Both models are built from the same arguments, their drawn leaves compared
before the JAX leaves, moved off their defaults, are carried into the port
with ``load_jax_state``. Values to rtol 1e-10 (with an absolute floor of
1e-10 of the array's largest entry), gradients by key path to 1e-7, three
``fit`` steps to 1e-9. The JAX side is jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.likelihoods import GaussianLikelihood as JaxLik
from projected_lmc_tpu.likelihoods import \
    MultitaskGaussianLikelihood as JaxMTLik
from projected_lmc_tpu.mlls import projected_lmc_mll as jax_proj_mll
from projected_lmc_tpu.models.exact import ExactGPModel as JaxExact
from projected_lmc_tpu.models.multitask import MultitaskGPModel as JaxMT
from projected_lmc_tpu.models.projected import ProjectedGPModel as JaxProj
from projected_lmc_tpu.module import trainable_mask
from projected_lmc_tpu.ops import woodbury as jwb
from projected_lmc_tpu.training import fit as jax_fit
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import (ExactGPModel, GaussianLikelihood,
                                     MultitaskGaussianLikelihood,
                                     MultitaskGPModel, ProjectedGPModel, fit,
                                     load_jax_state, projected_lmc_mll)
from projected_lmc_tpu_torch.module import keyed_state
from projected_lmc_tpu_torch.ops import woodbury as twb

N, NS, T, Q, M = 30, 10, 3, 2, 8


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
    """Check that both models drew the same leaves (the inducing points bit
    for bit, sums such as the projected model's ‖Y‖² to 1e-12), then move
    the JAX model's trainable leaves by uniform(−0.3, 0.3) and carry every
    leaf into the port model; returns both."""
    arrays = {k: np.asarray(v) for k, v in _keyed_leaves(jm)}
    state = keyed_state(tm)
    assert sorted(state) == sorted(arrays)
    for k, v in arrays.items():
        np.testing.assert_allclose(state[k].detach().numpy(), v, rtol=1e-12,
                                   atol=0, err_msg=k)
    np.testing.assert_array_equal(
        state[".inducing_points"].detach().numpy(),
        arrays[".inducing_points"])
    rng = np.random.default_rng(seed)
    for (k, _), trainable in zip(_keyed_leaves(jm), trainable_mask(jm)):
        if trainable:
            arrays[k] = arrays[k] + rng.uniform(-0.3, 0.3, arrays[k].shape)
    jm = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jm),
        [jnp.asarray(arrays[k]) for k, _ in _keyed_leaves(jm)])
    load_jax_state(tm, arrays)
    return jm, tm


def grads_match(jm, tm, jg, rtol=1e-7):
    """Every trainable leaf's gradient, by key path; the inducing points'
    among them."""
    grads = dict(_keyed_leaves(jg))
    params = dict(tm.named_parameters())
    names = [k for (k, _), m in zip(_keyed_leaves(jm), trainable_mask(jm))
             if m and k[1:] in params]
    for k in names:
        close(params[k[1:]].grad, grads[k], rtol=rtol, what=k)
    assert ".inducing_points" in names
    return names


def value_and_grads_match(jm, tm, jax_fn, torch_fn):
    jv, jg = jax.jit(jax.value_and_grad(jax_fn))(jm)
    tv = torch_fn(tm)
    tv.backward()
    close(tv, jv)
    return grads_match(jm, tm, jg)


def three_fit_steps_match(jm, tm, jax_loss=None, torch_loss=None):
    _, jinfo = jax_fit(jm, jax_loss, n_iter=3, lr=0.05, patience=100)
    _, tinfo = fit(tm, torch_loss, n_iter=3, lr=0.05, patience=100,
                   device="cpu")
    assert len(tinfo["losses"]) == 3
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-9)


# -- the exact GP ---------------------------------------------------------------

def exact_models(n_tasks=T, **kw):
    X, Y, Xs = data()
    Y = Y[:, :n_tasks] if n_tasks > 1 else Y[:, 0]
    kw = dict(n_tasks=n_tasks, kernel_type="matern", outputscales=True,
              mean_type="constant", n_inducing_points=M, seed=4, **kw)
    jm = JaxExact(X, Y, JaxLik(batch_shape=n_tasks, dtype=jnp.float64), **kw)
    tm = ExactGPModel(X, Y, GaussianLikelihood(
        batch_shape=n_tasks, dtype=torch.float64, device="cpu"),
        device="cpu", **kw)
    return (*carried(jm, tm), Xs)


@pytest.mark.parametrize("n_tasks", [1, T])
def test_exact_sgpr_mll_value_and_gradients_match_jax(n_tasks):
    """The Titsias bound with its trace term, the inducing points' gradient
    through K3's backward (dx2 of K(x, z), dx1 and dx2 of K(z, z))."""
    jm, tm, _ = exact_models(n_tasks)
    assert tm.sgpr and tuple(tm.inducing_points.shape) == (M, 2)
    value_and_grads_match(jm, tm, lambda m: m.mll(), lambda m: m.mll())


def test_exact_sgpr_three_fit_steps_match_jax():
    three_fit_steps_match(*exact_models()[:2])


@pytest.mark.parametrize("titsias", [True, False])
@pytest.mark.parametrize("full_cov", [True, False])
def test_exact_sgpr_posterior_matches_jax(full_cov, titsias):
    """The "sgpr" cache (the capacitance factor and β) and the Titsias
    predictive (or, without ``sgpr_titsias_var``, the subset-of-regressors
    one), with a re-targeted cache; the Nyström prior."""
    jm, tm, Xs = exact_models(sgpr_titsias_var=titsias)
    y = np.random.default_rng(3).standard_normal((T, N))

    def side(m, x, yy):
        out = []
        for targets in (None, yy):
            c = m.precompute_posterior(targets)
            p = m.posterior(x, cache=c, full_cov=full_cov)
            out += [c["Lc"], c["beta"], c["noise"], p.mean, p.variance,
                    p.covariance_matrix]
        pr = m.prior(x)
        return out + [pr.mean, pr.covariance_matrix]
    want = jax.jit(lambda m: side(m, Xs, y))(jm)
    assert tm.precompute_posterior()["kind"] == "sgpr"
    got = side(tm, t64(Xs), t64(y))
    for i, (a, b) in enumerate(zip(got, want)):
        close(a, b, what=str(i))


def test_exact_sgpr_refuses_the_iterative_route():
    """``iterative=True`` raises with the JAX message; the auto-routing
    never leaves the bound (a lowered dense ceiling changes nothing)."""
    jm, tm, _ = exact_models()
    for m in (jm, tm):
        with pytest.raises(ValueError, match="already matrix-free"):
            m.mll(iterative=True)
    tm.ITER_TN2_MAX = 1
    close(tm.mll(), jax.jit(lambda m: m.mll())(jm))


# -- the LMC and the ICM -------------------------------------------------------------

def mt_models(model_type, noise_rank=0, n=N, **kw):
    X, Y, Xs = data(n)
    kw = dict(n_tasks=T, n_latents=Q, model_type=model_type,
              kernel_type="matern", mean_type="constant",
              n_inducing_points=M, seed=5, **kw)
    jm = JaxMT(X, Y, JaxMTLik(num_tasks=T, rank=noise_rank,
                              dtype=jnp.float64), **kw)
    tm = MultitaskGPModel(X, Y, MultitaskGaussianLikelihood(
        num_tasks=T, rank=noise_rank, dtype=torch.float64, device="cpu"),
        device="cpu", **kw)
    return (*carried(jm, tm), Xs)


MT_CASES = {"lmc": dict(model_type="LMC"),
            "lmc-fix-diagonal-init": dict(model_type="LMC",
                                          fix_diagonal=True,
                                          init_lmc_coeffs=False),
            "icm": dict(model_type="ICM"),
            "icm-rank-noise": dict(model_type="ICM", noise_rank=T)}


@pytest.mark.parametrize("case", sorted(MT_CASES))
def test_multitask_sgpr_mll_value_and_gradients_match_jax(case):
    """The low-rank Woodbury MLL with the Titsias term over n·T; the
    inducing points drawn from the same rng after the factor and diagonal
    draws (``init_lmc_coeffs=False`` draws the factor too)."""
    jm, tm, _ = mt_models(**MT_CASES[case])
    value_and_grads_match(jm, tm, lambda m: m.mll(), lambda m: m.mll())


@pytest.mark.parametrize("model_type", ["LMC", "ICM"])
def test_multitask_sgpr_three_fit_steps_match_jax(model_type):
    three_fit_steps_match(*mt_models(model_type)[:2])


@pytest.mark.parametrize("titsias", [True, False])
@pytest.mark.parametrize("model_type", ["LMC", "ICM"])
def test_multitask_sgpr_posterior_and_loo_match_jax(model_type, titsias):
    """The "sgpr" cache (α and the capacitance factor), the posterior
    observed and not (with and without the low-rank gap), ``compute_var``
    for the ICM, and the LOO on the Nyström system."""
    jm, tm, Xs = mt_models(model_type, sgpr_titsias_var=titsias)

    def side(m, x):
        c = m.precompute_posterior()
        out = [c["alpha"], c["fac"]["L_cap"], c["Sigma_t"]]
        for o in (True, False):
            p = m.posterior(x, cache=c, observed=o)
            out += [p.mean, p.variance]
        if model_type == "ICM":
            out.append(m.compute_var(x))
        return out + list(m.compute_loo())
    want = jax.jit(lambda m: side(m, Xs))(jm)
    assert tm.precompute_posterior()["kind"] == "sgpr"
    got = side(tm, t64(Xs))
    for i, (a, b) in enumerate(zip(got, want)):
        close(a, b, what=str(i))


# -- the projected LMC ----------------------------------------------------------------

PROJ = {"PLMC": dict(BDN=False, diagonal_B=False, scalar_B=False),
        "PLMC_fast": dict(BDN=True, diagonal_B=True, scalar_B=True),
        "oilmm": dict(BDN=True, diagonal_B=True, scalar_B=True,
                      diagonal_R=True)}


def proj_models(cfg, **kw):
    X, Y, Xs = data(p=5)
    kw = dict(init_lmc_coeffs=True, kernel_type="matern",
              n_inducing_points=M, seed=6, **PROJ[cfg], **kw)
    return (*carried(JaxProj(X, Y, 5, Q, **kw),
                     ProjectedGPModel(X, Y, 5, Q, device="cpu", **kw)), Xs)


@pytest.mark.parametrize("cfg", sorted(PROJ))
def test_projected_sgpr_mll_value_and_gradients_match_jax(cfg):
    """``projected_lmc_mll`` on the inherited SGPR route, with its terms."""
    jm, tm, _ = proj_models(cfg)
    value_and_grads_match(jm, tm, jax_proj_mll, projected_lmc_mll)
    jv, jterms = jax.jit(lambda m: jax_proj_mll(m, with_terms=True))(jm)
    tv, tterms = projected_lmc_mll(tm, with_terms=True)
    for a, b in zip(tterms, jterms):
        close(a, b)


def test_projected_sgpr_three_fit_steps_match_jax():
    three_fit_steps_match(*proj_models("PLMC")[:2], jax_proj_mll,
                          projected_lmc_mll)


@pytest.mark.parametrize("cfg", sorted(PROJ))
def test_projected_sgpr_prediction_matches_jax(cfg):
    """``prediction_cache`` ("sgpr" on the projected data), the latent
    posterior both ways, ``predict`` observed and not, with and without a
    cache, and the LOO (the exact one, as in JAX)."""
    jm, tm, Xs = proj_models(cfg)

    def side(m, x, pre):
        c = m.prediction_cache()
        out = [c["Lc"], c["beta"]]
        for full_cov in (True, False):
            lat = m.compute_latent_distrib(x, full_cov=full_cov, cache=c)
            out += [lat.mean, lat.variance]
        for o in (True, False):
            out += list(m.predict(x, observed=o, cache=pre(c)))
        return out + list(m.compute_loo())
    want = jax.jit(lambda m: side(m, Xs, lambda c: c))(jm)
    assert tm.prediction_cache()["kind"] == "sgpr"
    for pre in (lambda c: c, lambda c: None):
        got = side(tm, t64(Xs), pre)
        for i, (a, b) in enumerate(zip(got, want)):
            close(a, b, what=str(i))


# -- woodbury.lmc_sgpr_posterior --------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 512])
@pytest.mark.parametrize("with_gap", [True, False])
@pytest.mark.parametrize("noise", [True, False])
def test_lmc_sgpr_posterior_matches_jax(noise, with_gap, chunk):
    """Mean and variance from low-rank roots (q, n, m), in one chunk or in
    chunks of 4 test points (ragged at n* = 10), with and without the gap
    term and the noise."""
    rng = np.random.default_rng(7)
    q, t, n, m = 3, 4, 20, 5
    roots = rng.standard_normal((q, n, m)) / 3
    roots_s = rng.standard_normal((q, NS, m)) / 3
    H = rng.standard_normal((t, q))
    A = rng.standard_normal((t, t))
    St = A @ A.T / t + 0.1 * np.eye(t)
    alpha = rng.standard_normal((n, t))
    mean_s = rng.standard_normal((NS, t))
    kss = (roots_s ** 2).sum(-1) + rng.uniform(-0.1, 0.5, (q, NS))
    kss_arg = kss if with_gap else None

    def jax_side(R, Rs, H, St, a, ms, k):
        fac = jwb.lmc_factors_from_roots(R, H, St)
        return jwb.lmc_sgpr_posterior(Rs, fac, a, ms, noise=noise,
                                      chunk=chunk, kss_star=k)
    want = jax.jit(jax_side)(roots, roots_s, H, St, alpha, mean_s, kss_arg)
    fac = twb.lmc_factors_from_roots(t64(roots), t64(H), t64(St))
    got = twb.lmc_sgpr_posterior(
        t64(roots_s), fac, t64(alpha), t64(mean_s), noise=noise,
        chunk=chunk, kss_star=None if kss_arg is None else t64(kss_arg))
    close(got[0], want[0], what="mean")
    close(got[1], want[1], what="variance")
