"""The port's matrix-free LMC estimators over a materialized stack and the
model routes that reach them, against the JAX package on the CPU (float64).

``ops.iterative``: ``draw_probes``, ``slq_logdet``, CG + SLQ
(``lmc_iterative_log_prob``, the LMC model's default MLL above the dense
ceiling) and the composed route's one-pass PCG (``lmc_pcg_log_prob``) with
the fp32, bf16 and int8 CG loops. The models: ``MultitaskGPModel.mll`` on
the SLQ route (``precond_rank`` 0 and 12) and on the composed route (an
additive, a spline and a spectral-mixture kernel), ``ExactGPModel.mll``'s
composed route, and every posterior that reaches the covariance module
("exact", "lmc", "lmc_iter", "icm", "icm_iter", "sgpr", the projected
model's) with an additive and a spectral-mixture kernel. Both sides see the
same probes (the ones the JAX model draws from PRNGKey(0)); the port carries
the JAX leaves, moved off their defaults. Values rtol 1e-9, gradients by key
path rtol 1e-7 (atol 1e-9); the bf16 loop, whose roundings differ now and
then by one bf16 step, as ``tests/test_torch_fused_mll.py`` holds it; the
int8 loop's gradients, whose re-quantized CG directions flip rounding ties,
to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.likelihoods import GaussianLikelihood as JaxLik
from projected_lmc_tpu.mlls import projected_lmc_mll as jax_proj_mll
from projected_lmc_tpu.models.exact import ExactGPModel as JaxExact
from projected_lmc_tpu.models.multitask import MultitaskGPModel as JaxMT
from projected_lmc_tpu.models.projected import ProjectedGPModel as JaxProj
from projected_lmc_tpu.module import trainable_mask
from projected_lmc_tpu.ops import iterative as jit_ops
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import (ExactGPModel, GaussianLikelihood,
                                     MultitaskGPModel, ProjectedGPModel,
                                     load_jax_state, projected_lmc_mll)
from projected_lmc_tpu_torch.module import keyed_state
from projected_lmc_tpu_torch.ops import iterative as tit_ops

N, NS, T, Q, D, RANK, S = 40, 10, 3, 2, 3, 12, 4
DECOMP = [[0, 1], [2]]
KERNELS = {
    "additive": dict(kernel_type="matern", decomp=DECOMP),
    "spline": dict(kernel_type="spline"),
    "spectral_mixture": dict(kernel_type="spectral_mixture",
                             ker_kwargs=dict(num_mixtures=2)),
}
LMC_KW = dict(n_tasks=T, n_latents=Q, model_type="LMC", fix_diagonal=True,
              mean_type="constant")
CG = dict(max_cg_iters=200, cg_tol=1e-12, num_probes=S)


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


def data(n=N, seed=1):
    """Smooth latent draws mixed into T tasks, plus noise; test inputs."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, D))
    U = np.stack([np.sin(3 * X[:, 0]), np.cos(2 * X[:, 1]),
                  X[:, 0] * X[:, 2]], 1)
    Y = U @ rng.standard_normal((3, T)) + 0.1 * rng.standard_normal((n, T))
    return X, Y, rng.uniform(-1.1, 1.1, (NS, D))


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


def pair(jax_cls, torch_cls, *args, **kw):
    """The JAX model and the port's, built alike, the port carrying the
    JAX leaves moved off their defaults."""
    return carried(jax_cls(*args, **kw), torch_cls(*args, device="cpu", **kw))


def lmc_pair(kernel="additive", **extra):
    X, Y, Xs = data()
    return (*pair(JaxMT, MultitaskGPModel, X, Y, **LMC_KW,
                  **KERNELS[kernel], **extra), Xs)


def jax_normals(xi_shape):
    """The eps and xi the JAX models draw from PRNGKey(0)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return (t64(jax.random.normal(k1, (S, N, T), jnp.float64)),
            t64(jax.random.normal(k2, (S, *xi_shape), jnp.float64)))


def jax_rademacher(s):
    """The probes the JAX LMC model's SLQ route draws from PRNGKey(0)."""
    return t64(jit_ops.draw_probes(jax.random.PRNGKey(0), N, T, s,
                                   jnp.float64))


def matches_jax(jm, tm, jax_loss, torch_loss, vtol=1e-9, gtol=1e-7,
                normwise=None):
    """Value to ``vtol`` and each trainable leaf's gradient, by key path,
    to ``gtol`` (or, with ``normwise``, in norm to that fraction)."""
    vj, gj = jax.jit(jax.value_and_grad(jax_loss))(jm)
    tm.zero_grad(set_to_none=True)
    vt = torch_loss(tm)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=vtol)
    jg = dict(_keyed_leaves(gj))
    checked = 0
    for k, p in keyed_state(tm).items():
        if not (isinstance(p, torch.nn.Parameter) and p.requires_grad):
            continue
        a, b = p.grad.numpy(), np.asarray(jg[k])
        if normwise is not None:
            assert np.linalg.norm(a - b) <= normwise * np.linalg.norm(b), k
        else:
            np.testing.assert_allclose(a, b, rtol=gtol, atol=1e-9, err_msg=k)
        checked += 1
    assert checked >= 3


# -- the ops ---------------------------------------------------------------------

def test_draw_probes_are_rademacher_of_the_asked_shape():
    g = torch.Generator().manual_seed(3)
    Z = tit_ops.draw_probes(g, 50, 4, 6, torch.float64)
    assert Z.shape == (6, 50, 4) and Z.dtype == torch.float64
    assert set(Z.unique().tolist()) == {-1.0, 1.0}
    again = tit_ops.draw_probes(torch.Generator().manual_seed(3), 50, 4, 6,
                                torch.float64)
    assert torch.equal(Z, again)


def stack_problem(n=N, seed=4):
    """A (Q, n, n) Matérn stack, H (T, Q), Σt, Y (n, T) as numpy float64."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, D))
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    Ks = np.stack([(1 + np.sqrt(5) * d / ls + 5 * d ** 2 / (3 * ls ** 2))
                   * np.exp(-np.sqrt(5) * d / ls) for ls in (0.6, 1.3)])
    F = rng.standard_normal((T, T))
    return dict(Ks=Ks, H=rng.standard_normal((T, Q)),
                St=0.05 * F @ F.T + 0.1 * np.eye(T),
                Y=rng.standard_normal((n, T)))


def test_slq_logdet_matches_jax_and_the_exact_logdet():
    """The Lanczos quadrature on the same Rademacher probes: JAX's value to
    1e-10. On the probes √(nT)·e_i, which make the trace estimate exact, 30
    steps on the 120-dimensional operator give the exact logdet to 1e-6."""
    p = stack_problem()
    Z = np.asarray(jit_ops.draw_probes(jax.random.PRNGKey(1), N, T, S,
                                       jnp.float64))

    def jmv(V):
        return jit_ops.lmc_matvec(jnp.asarray(p["Ks"]), jnp.asarray(p["H"]),
                                  jnp.asarray(p["St"]), V)
    want = jax.jit(lambda z: jit_ops.slq_logdet(jmv, z, 30))(jnp.asarray(Z))

    def tmv(V):
        return tit_ops.lmc_matvec(t64(p["Ks"]), t64(p["H"]), t64(p["St"]), V)
    close(tit_ops.slq_logdet(tmv, t64(Z), 30), want)
    dense = sum(np.kron(K, np.outer(h, h)) for K, h in zip(p["Ks"],
                                                           p["H"].T))
    exact = np.linalg.slogdet(dense + np.kron(np.eye(N), p["St"]))[1]
    units = torch.eye(N * T, dtype=torch.float64).reshape(N * T, N, T)
    close(tit_ops.slq_logdet(tmv, units * np.sqrt(N * T), 30), exact,
          rtol=1e-6)


@pytest.mark.parametrize("rank", [0, RANK])
def test_lmc_iterative_log_prob_matches_jax(rank):
    """CG (Jacobi, or Nyström from the stack) + SLQ: value and the four
    gradients (Hutchinson on the saved solves)."""
    p = stack_problem()
    Z = np.asarray(jit_ops.draw_probes(jax.random.PRNGKey(2), N, T, S,
                                       jnp.float64))
    args = (200, 1e-12, 20, False, rank)
    f = jax.jit(jax.value_and_grad(
        lambda *a: jit_ops.lmc_iterative_log_prob(*a, jnp.asarray(Z), *args),
        argnums=(0, 1, 2, 3)))
    vj, gj = f(*[jnp.asarray(p[k]) for k in ("Ks", "H", "St", "Y")])
    ts = [t64(p[k]).requires_grad_(True) for k in ("Ks", "H", "St", "Y")]
    vt = tit_ops.lmc_iterative_log_prob(*ts, t64(Z), *args)
    vt.backward()
    close(vt, vj, rtol=1e-9)
    for a, b, name in zip(ts, gj, ("Ks", "H", "St", "Y")):
        close(a.grad, b, rtol=1e-7, what=name)


@pytest.mark.parametrize("loop", ["float", "bf16", "int8"])
def test_lmc_pcg_log_prob_matches_jax(loop):
    """The composed route's one-pass PCG on a materialized stack (roots from
    the stack), in each CG loop. bf16: value to 1e-5 and the gradients in
    norm to 2e-2, as the fused op's bf16 test. int8: each CG direction is
    re-quantized, so a rounding tie that falls apart on the two sides moves
    a solve by one count; a 1e-14 relative change of Y moves JAX's own dH by
    1.5e-7 of its largest entry. The value to 1e-9, the gradients to 1e-5
    of each one's largest entry."""
    p = stack_problem()
    rng = np.random.default_rng(5)
    eps, xi = rng.standard_normal((S, N, T)), rng.standard_normal((S, Q, RANK))
    bf16, int8 = loop == "bf16", loop == "int8"
    cg = (200, 1e-12) if loop != "bf16" else (100, 1e-6)

    def jf(Ks, H, St, Y):
        Kin = Ks.astype(jnp.bfloat16) if bf16 else Ks
        return jit_ops.lmc_pcg_log_prob(Kin, H, St, Y, jnp.asarray(eps),
                                        jnp.asarray(xi), None, *cg, bf16,
                                        RANK, int8)
    vj, gj = jax.jit(jax.value_and_grad(jf, argnums=(0, 1, 2, 3)))(
        *[jnp.asarray(p[k]) for k in ("Ks", "H", "St", "Y")])
    ts = [t64(p[k]).requires_grad_(True) for k in ("Ks", "H", "St", "Y")]
    Kin = ts[0].to(torch.bfloat16) if bf16 else ts[0]
    vt = tit_ops.lmc_pcg_log_prob(Kin, *ts[1:], t64(eps), t64(xi), None, *cg,
                                  bf16, RANK, int8)
    vt.backward()
    if bf16:
        close(vt, vj, rtol=1e-5)
        for a, b in zip(ts, gj):
            b = np.asarray(b, np.float64)
            assert np.linalg.norm(a.grad.numpy() - b) < 2e-2 * np.linalg.norm(b)
        assert ts[0].grad.dtype == torch.float64
        return
    close(vt, vj, rtol=1e-9)
    for a, b, name in zip(ts, gj, ("Ks", "H", "St", "Y")):
        close(a.grad, b, rtol=1e-5 if int8 else 1e-7, what=name)


# -- the model routes ------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, RANK])
def test_lmc_slq_route_matches_jax(rank, monkeypatch):
    """The LMC model's default MLL above the dense ceiling (lowered to
    q·n = 60 here) is CG + SLQ at ``precond_rank=0`` (with its default 10
    probes); with a rank and ``quad_method="slq"`` the same estimator,
    Nyström-preconditioned. CG runs to 1e-12: at the default 1e-2 the
    iterate at which CG stops carries the two packages' rounding, which CG
    amplifies from iteration to iteration (1e-15 → 5e-11 in 11 Jacobi
    iterations here), so the two stop at points 1e-4 apart."""
    monkeypatch.setattr(JaxMT, "DENSE_QN_MAX", 60)
    monkeypatch.setattr(MultitaskGPModel, "DENSE_QN_MAX", 60)
    jm, tm, _ = lmc_pair("additive")
    kw = dict(max_cg_iters=200, cg_tol=1e-12)
    if rank:
        kw.update(precond_rank=rank, quad_method="slq", num_probes=S)
    probes = jax_rademacher(S if rank else 10)
    matches_jax(jm, tm, lambda m: m.mll(**kw),
                lambda m: m.mll(probes=probes, **kw))


@pytest.mark.parametrize("case", ["additive", "additive-bf16",
                                  "additive-int8", "spline",
                                  "spectral_mixture"])
def test_lmc_composed_route_matches_jax(case):
    """Each kernel that is not one stationary kernel over all the features
    takes the composed route: the stack materialized, one PCG pass (the
    bf16 and int8 loops held as in :func:`test_lmc_pcg_log_prob_matches_jax`,
    the int8 gradients to 1e-5 relative)."""
    kernel, _, loop = case.partition("-")
    jm, tm, _ = lmc_pair(kernel)
    kw = dict(iterative=True, precond_rank=RANK, matvec_bf16=loop == "bf16",
              matvec_int8=loop == "int8", **CG)
    if loop == "bf16":
        kw.update(max_cg_iters=100, cg_tol=1e-6)
    eps, xi = jax_normals((Q, RANK))
    matches_jax(jm, tm, lambda m: m.mll(**kw),
                lambda m: m.mll(eps=eps, xi=xi, **kw),
                vtol=1e-5 if loop == "bf16" else 1e-9,
                gtol=1e-5 if loop == "int8" else 1e-7,
                normwise=2e-2 if loop == "bf16" else None)


@pytest.mark.parametrize("decomp", [DECOMP, [[0, 2]]])
def test_exact_composed_route_matches_jax(decomp):
    """``ExactGPModel``'s iterative MLL with an additive kernel, and with a
    kernel over a proper subset of the features."""
    X, Y, _ = data()
    kw = dict(n_tasks=T, kernel_type="matern", decomp=decomp,
              outputscales=True)
    jm, tm = carried(JaxExact(X, Y, JaxLik(batch_shape=T, dtype=jnp.float64),
                              **kw),
                     ExactGPModel(X, Y, GaussianLikelihood(
                         batch_shape=T, dtype=torch.float64, device="cpu"),
                         device="cpu", **kw))
    eps, xi = jax_normals((T, RANK))
    mkw = dict(iterative=True, precond_rank=RANK, **CG)
    matches_jax(jm, tm, lambda m: m.mll(**mkw),
                lambda m: m.mll(eps=eps, xi=xi, **mkw))


def _exact(X, Y, jax_side, **kw):
    if jax_side:
        return JaxExact(X, Y, JaxLik(batch_shape=T, dtype=jnp.float64),
                        n_tasks=T, **kw)
    return ExactGPModel(X, Y, GaussianLikelihood(
        batch_shape=T, dtype=torch.float64, device="cpu"), n_tasks=T,
        device="cpu", **kw)


def _multitask(**route_kw):
    def make(X, Y, jax_side, **kw):
        cls, dev = (JaxMT, {}) if jax_side else (MultitaskGPModel,
                                                 dict(device="cpu"))
        return cls(X, Y, **route_kw, **kw, **dev)
    return make


def _projected(X, Y, jax_side, **kw):
    if jax_side:
        return JaxProj(X, Y, T, Q, **kw)
    return ProjectedGPModel(X, Y, T, Q, device="cpu", **kw)


LMC_ROUTE = dict(n_tasks=T, n_latents=Q, model_type="LMC", fix_diagonal=True)
ICM_ROUTE = dict(n_tasks=T, n_latents=Q, model_type="ICM")
POSTERIORS = {
    "exact": (_exact, {}),
    "lmc": (_multitask(**LMC_ROUTE), {}),
    "lmc_iter": (_multitask(**LMC_ROUTE), dict(iterative=True,
                                               precond_rank=8)),
    "icm": (_multitask(**ICM_ROUTE), {}),
    "icm_iter": (_multitask(**ICM_ROUTE), dict(iterative=True,
                                               precond_rank=8)),
    "sgpr": (_multitask(**LMC_ROUTE, n_inducing_points=8), {}),
    "projected": (_projected, {}),
}


def _predict(m, x, cache_kw, v0):
    """(mean, variance) of the route's posterior at x from a cache built
    once."""
    if isinstance(m, (ProjectedGPModel, JaxProj)):
        return m.predict(x, cache=m.prediction_cache())
    if v0 is not None:
        cache_kw = dict(cache_kw, v0=v0)
    cache = m.precompute_posterior(**cache_kw)
    if isinstance(m, (ExactGPModel, JaxExact)):
        p = m.posterior(x, cache=cache, full_cov=False)
    else:
        p = m.posterior(x, cache=cache, observed=True)
    return p.mean, p.variance


@pytest.mark.parametrize("kernel", ["additive", "spectral_mixture"])
@pytest.mark.parametrize("route", sorted(POSTERIORS))
def test_posteriors_take_the_new_kernels(route, kernel, monkeypatch):
    """Each posterior and cache that reaches the covariance module, with an
    additive and a spectral-mixture kernel: mean and variance to 1e-8 (the
    iterative caches' PCG runs to 1e-5, as in ``test_torch_predict``)."""
    def jax_eigh(A):         # ICM probes and parts in JAX's eigenbasis
        w, V = jnp.linalg.eigh(jnp.asarray(A.detach().numpy()))
        return t64(w), t64(V)
    monkeypatch.setattr(tit_ops, "_eigh_fixed_signs", jax_eigh)
    make, cache_kw = POSTERIORS[route]
    X, Y, Xs = data()
    kw = dict(KERNELS[kernel], mean_type="zero") if route == "projected" \
        else KERNELS[kernel]
    jm, tm = carried(make(X, Y, True, **kw), make(X, Y, False, **kw))
    v0 = None
    if route.endswith("_iter"):
        shape = (N, T) if route == "lmc_iter" else (N, 1)
        v0 = t64(jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float64))
    want = jax.jit(lambda m: _predict(m, Xs, cache_kw, None))(jm)
    with torch.no_grad():
        got = _predict(tm, t64(Xs), cache_kw, v0)
    if route == "projected":
        close(projected_lmc_mll(tm).detach(), jax.jit(jax_proj_mll)(jm))
    for a, b, what in zip(got, want, ("mean", "variance")):
        close(a, b, rtol=1e-8, what=what)
