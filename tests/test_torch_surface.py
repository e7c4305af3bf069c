"""The port's kernels, priors and means beyond the stationary main path,
against the JAX package on the CPU (float64).

``kernels``: ``Prior``'s value equality and hashing, ``handle_covar``'s
additive groups with their priors and prior-mean lengthscales, the spline
kernel, and the spectral-mixture kernel with its seeded leaves and both
data-driven inits. ``means``: ``LinearMean`` and ``PolynomialMean`` with
their seeded leaves and ``basis_matrix``; and
``ExactGPModel.compute_loo(complex_mean=True)``, the universal-kriging LOO.
Key paths are held against JAX's ``_keyed_leaves``; values rtol 1e-10,
gradients rtol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu import constraints as jcons
from projected_lmc_tpu import kernels as jker
from projected_lmc_tpu import means as jmeans
from projected_lmc_tpu.likelihoods import GaussianLikelihood as JaxLik
from projected_lmc_tpu.models.exact import ExactGPModel as JaxExact
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import (ExactGPModel, GaussianLikelihood,
                                     load_jax_state)
from projected_lmc_tpu_torch import constraints as tcons
from projected_lmc_tpu_torch import kernels as tker
from projected_lmc_tpu_torch import means as tmeans
from projected_lmc_tpu_torch.module import keyed_state

D, B = 3, 2
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny torch ops: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share."""
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


def inputs(seed=0, n=9, m=6):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, D)), rng.uniform(-1, 1, (m, D))


def same_leaves(jmod, tmod):
    """The port module's key paths are JAX's, and each leaf equals JAX's to
    1e-14: the seeded draws are numpy's on both sides, and the inverse
    softplus of torch's and XLA's log and expm1 differ by an ulp."""
    jl = dict(_keyed_leaves(jmod))
    ts = keyed_state(tmod)
    assert sorted(jl) == sorted(ts)
    for k, v in jl.items():
        assert tuple(ts[k].shape) == np.shape(v), k
        if np.size(v):
            close(ts[k], v, rtol=1e-14, what=k)


# -- priors ----------------------------------------------------------------------

def test_priors_compare_and_hash_by_value():
    """Equal parameters: equal and of one hash (two models built with equal
    priors are one configuration); another value or class: not equal."""
    a = tker.NormalPrior([0.5, 1.0], [0.1, 0.2])
    b = tker.NormalPrior(np.array([0.5, 1.0]), (0.1, 0.2))
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert a != tker.NormalPrior([0.5, 1.0], [0.1, 0.3])
    m = tker.MultivariateNormalPrior([0.5, 1.0], [0.1, 0.2])
    assert m != a and isinstance(m, tker.Prior)
    value = t64([[0.4, 1.3], [0.7, 0.9]])
    for tp, jp in ((a, jker.NormalPrior([0.5, 1.0], [0.1, 0.2])),
                   (m, jker.MultivariateNormalPrior([0.5, 1.0], [0.1, 0.2]))):
        close(tp.log_prob(value), jp.log_prob(jnp.asarray(value.numpy())))


def test_inv_softplus_at_the_extremes():
    """The spectral mixture's raw frequencies sit at 1e4 (softplus ≈ the
    identity there) and its floors at 1e-12: the port's inverse equals
    JAX's and round-trips."""
    y = t64([1e-12, 1e-3, 1.0, 3.5e4, 1e4])
    got = tcons.inv_softplus(y)
    close(got, jcons.inv_softplus(jnp.asarray(y.numpy())))
    close(tcons.softplus(got), y, rtol=1e-12)


# -- kernels ---------------------------------------------------------------------

CASES = {
    "additive": dict(kernel_type="matern", decomp=[[0, 1], [2]]),
    "additive-priors": dict(kernel_type="rbf", decomp=[[0], [1, 2]],
                            prior_scales=np.array([0.4, 0.8, 1.6]),
                            prior_width=np.array([0.2, 0.3, 0.5])),
    "subset-priors": dict(kernel_type="matern", decomp=[[0, 2]],
                          prior_scales=[np.array([0.5, 2.0])],
                          prior_width=[np.array([0.1, 0.2])]),
    "spline": dict(kernel_type="spline"),
    "spline-additive": dict(kernel_type="spline", decomp=[[0], [1, 2]]),
    "spectral_mixture": dict(kernel_type="spectral_mixture",
                             ker_kwargs=dict(num_mixtures=3, seed=4)),
}


def kernel_pair(case, outputscales=True):
    kw = CASES[case]
    jk = jker.handle_covar(dim=D, n_funcs=B, outputscales=outputscales,
                           dtype=jnp.float64, **kw)
    tk = tker.handle_covar(dim=D, n_funcs=B, outputscales=outputscales,
                           dtype=torch.float64, device="cpu", **kw)
    return jk, tk


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_leaves_values_and_gradients_match_jax(case):
    """The factory's leaves (key paths such as
    ``.kernels[0].base_kernel.raw_lengthscale``, seeded draws, prior-mean
    lengthscales), its sub-kernels, the dense and diagonal values, the prior
    term, and the gradients of a weighted sum of the values and the prior
    term with respect to every leaf and to x1."""
    jk, tk = kernel_pair(case)
    same_leaves(jk, tk)
    assert len(tk.sub_kernels()) == len(jk.sub_kernels())
    x1, x2 = inputs()
    W = np.random.default_rng(1).standard_normal((B, 9, 6))
    close(tk(t64(x1), t64(x2)), jk(x1, x2))
    close(tk(t64(x1), diag=True), jk(x1, diag=True))
    close(tk.prior_log_prob(), jk.prior_log_prob())

    def jloss(k, x):
        return jnp.sum(k(x, x2) * W) + jnp.sum(k(x, diag=True)) \
            + k.prior_log_prob()
    gk, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jk, jnp.asarray(x1))
    x = t64(x1).requires_grad_(True)
    ((tk(x, t64(x2)) * t64(W)).sum() + tk(x, diag=True).sum()
     + tk.prior_log_prob()).backward()
    close(x.grad, gx, rtol=1e-7)
    jg = dict(_keyed_leaves(gk))
    for k, p in keyed_state(tk).items():
        if p.requires_grad:
            close(p.grad, jg[k], rtol=1e-7, what=k)


def test_groups_carry_their_priors_and_outputscales():
    """One ScaleKernel per group, each over its features, with a Normal
    prior for one feature and a diagonal MVN for several, lengthscales at
    the prior means; one group without ``outputscales`` is the bare kernel."""
    _, tk = kernel_pair("additive-priors")
    assert isinstance(tk, tker.AdditiveKernel)
    (k0, k1) = tk.kernels
    assert isinstance(k0, tker.ScaleKernel)
    assert k0.base_kernel.active_dims == (0,)
    assert k1.base_kernel.active_dims == (1, 2)
    assert isinstance(k0.base_kernel.lengthscale_prior, tker.NormalPrior)
    assert isinstance(k1.base_kernel.lengthscale_prior,
                      tker.MultivariateNormalPrior)
    close(k1.lengthscale[0, 0], [0.8, 1.6])
    _, bare = kernel_pair("subset-priors", outputscales=False)
    assert isinstance(bare, tker.MaternKernel)
    close(bare.lengthscale[1, 0], [0.5, 2.0])
    with pytest.raises(ValueError, match="prior width"):
        tker.handle_covar("rbf", D, prior_scales=np.ones(D), device="cpu")


@pytest.mark.parametrize("init", ["initialize_from_data",
                                  "initialize_from_data_empspect"])
def test_spectral_mixture_inits_match_jax_leaf_for_leaf(init):
    """Both data-driven inits in numpy float64 from ``default_rng(seed)``:
    the raw leaves equal JAX's (a regular tidal-like series with a gap for
    the periodogram; three features for the heuristic, which the
    periodogram init falls back to), and the kernel matches after them."""
    rng = np.random.default_rng(7)
    if init.endswith("empspect"):
        t = np.arange(300) / 12.0
        t = np.delete(t, range(140, 160))[:, None]
        y = np.stack([np.sin(2 * np.pi * t[:, 0] / 12.42 * 3 + p)
                      for p in (0.0, 1.0)], 1) \
            + 0.05 * rng.standard_normal((len(t), 2))
        d = 1
    else:
        t, y, d = rng.uniform(0, 5, (50, D)), rng.standard_normal(50), D
    jk = jker.SpectralMixtureKernel(num_mixtures=3, ard_num_dims=d,
                                    batch_shape=B, dtype=jnp.float64)
    tk = tker.SpectralMixtureKernel(num_mixtures=3, ard_num_dims=d,
                                    batch_shape=B, **F64)
    jk = getattr(jk, init)(t, y, seed=3)
    assert getattr(tk, init)(t, y, seed=3) is tk
    same_leaves(jk, tk)
    x1 = t[:7]
    close(tk(t64(x1), t64(t[3:12])), jk(x1, t[3:12]), rtol=1e-9)


def test_spectral_mixture_takes_weight_decay_off_its_raw_leaves():
    """``fit`` masks weight decay off the ``raw_mixture*`` leaves, as the JAX
    loop does (one AdamW step with zero gradient leaves them put)."""
    from projected_lmc_tpu_torch import fit
    k = tker.SpectralMixtureKernel(num_mixtures=2, **F64)
    k.register_buffer("x", t64(np.linspace(0, 1, 5)[:, None]))
    before = {n: p.detach().clone() for n, p in k.named_parameters()}
    fit(k, lambda m: 0.0 * m(m.x).sum(), n_iter=1, weight_decay=0.5,
        device="cpu")
    for n, p in k.named_parameters():
        assert torch.equal(p, before[n]), n


# -- means -----------------------------------------------------------------------

MEANS = {
    "linear": dict(seed=5),
    "linear-no-bias": dict(seed=5, bias=False),
    "polynomial": dict(seed=6, degree=2),
}


@pytest.mark.parametrize("case", sorted(MEANS))
def test_means_match_jax(case):
    """Seeded leaves equal JAX's (no bias leaf with ``bias=False``), the
    values, the gradients of every leaf, and the basis matrix [x, 1] of the
    linear mean (the polynomial mean has none, as in JAX)."""
    kind = case.split("-")[0]
    kw = MEANS[case]
    jm = jmeans.MEAN_REGISTRY[kind](D, batch_shape=B, dtype=jnp.float64, **kw)
    tm = tmeans.MEAN_REGISTRY[kind](D, batch_shape=B, **F64, **kw)
    same_leaves(jm, tm)
    assert (tm.bias is None) == (not kw.get("bias", True))
    x, _ = inputs(2)
    W = np.random.default_rng(3).standard_normal((B, len(x)))
    want, g = jax.jit(jax.value_and_grad(
        lambda m: jnp.sum(m(jnp.asarray(x)) * W)))(jm)
    got = (tm(t64(x)) * t64(W)).sum()
    got.backward()
    close(got, want)
    jg = dict(_keyed_leaves(g))
    for k, p in keyed_state(tm).items():
        close(p.grad, jg[k], rtol=1e-10, what=k)
    if kind == "linear":
        close(tm.basis_matrix(t64(x)), jm.basis_matrix(x))
    else:
        assert not hasattr(tm, "basis_matrix")


# -- the universal-kriging LOO ---------------------------------------------------

def exact_pair(mean_type, n_tasks):
    rng = np.random.default_rng(8)
    X = rng.uniform(-1, 1, (24, D))
    Y = rng.standard_normal((24, n_tasks)) + X @ rng.standard_normal(
        (D, n_tasks))
    Y = Y if n_tasks > 1 else Y[:, 0]
    kw = dict(n_tasks=n_tasks, kernel_type="matern", mean_type=mean_type,
              outputscales=True, seed=4)
    jm = JaxExact(X, Y, JaxLik(batch_shape=n_tasks, dtype=jnp.float64), **kw)
    tm = ExactGPModel(X, Y, GaussianLikelihood(batch_shape=n_tasks, **F64),
                      device="cpu", **kw)
    load_jax_state(tm, {k: np.asarray(v) for k, v in _keyed_leaves(jm)})
    return jm, tm


@pytest.mark.parametrize("n_tasks", [1, 3])
def test_complex_mean_loo_matches_jax(n_tasks):
    """K⁻ = K⁻¹ − K⁻¹H(HᵀK⁻¹H)⁻¹HᵀK⁻¹ with the linear mean's basis: σ² and
    the residuals, and (one output, where it stays differentiable) the
    gradient of their sum."""
    jm, tm = exact_pair("linear", n_tasks)

    def side(m):
        s2, r = m.compute_loo(complex_mean=True)
        return s2, r, jnp.sum(s2) + jnp.sum(r)
    want = jax.jit(side)(jm)
    s2, r = tm.compute_loo(complex_mean=True)
    close(s2, want[0])
    close(r, want[1])
    if n_tasks == 1:
        g = jax.jit(jax.grad(lambda m: side(m)[2]))(jm)
        (s2.sum() + r.sum()).backward()
        jg = dict(_keyed_leaves(g))
        for k, p in keyed_state(tm).items():
            if p.requires_grad:      # the mean's own leaves do not enter
                got = torch.zeros_like(p) if p.grad is None else p.grad
                close(got, jg[k], rtol=1e-7, what=k)
    else:
        assert not s2.requires_grad


@pytest.mark.parametrize("mean_type", ["constant", "polynomial"])
def test_complex_mean_loo_needs_a_basis_matrix(mean_type):
    """A mean without ``basis_matrix`` raises ValueError, as in JAX."""
    jm, tm = exact_pair(mean_type, 1)
    with pytest.raises(ValueError, match="complex mean"):
        jm.compute_loo(complex_mean=True)
    with pytest.raises(ValueError, match="complex mean"):
        tm.compute_loo(complex_mean=True)
