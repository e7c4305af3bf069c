"""The port's prediction ops against the JAX package's, on the CPU in
float64: ``ops/woodbury.py`` (the dense LMC log-density, solve, posterior
mean and variance), the pieces of the matrix-free LMC posterior in
``ops/iterative.py`` (Jacobi diagonal, Nyström preconditioner, PCG, the
residual's spectral bound), ``ops/cholesky.chol_inverse_diag`` and the
kernels' diagonals and 1-D inputs. Same numpy inputs, made from a seed;
values to rtol 1e-10, gradients to 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu import kernels as jker
from projected_lmc_tpu.ops import cholesky as jchol
from projected_lmc_tpu.ops import iterative as jit_ops
from projected_lmc_tpu.ops import woodbury as jwb
from projected_lmc_tpu_torch import kernels as tker
from projected_lmc_tpu_torch.ops import cholesky as tchol
from projected_lmc_tpu_torch.ops import iterative as tit_ops
from projected_lmc_tpu_torch.ops import woodbury as twb

Q, N, T, NS = 3, 40, 4, 30


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


def problem(seed=0, n=N, ns=NS, noise=0.05):
    """RBF latent stacks on random inputs with one lengthscale a latent,
    their cross-covariances and diagonals at test points, a mixing matrix, a
    positive-definite task noise of scale ``noise`` and targets."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    xs = rng.uniform(-1.2, 1.2, (ns, 2))
    ls = np.array([0.3, 0.6, 1.1])[:Q, None, None]

    def k(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2[None] / ls ** 2)
    F = rng.standard_normal((T, T))
    return dict(Ks=k(x, x), Kstars=k(xs, x), kss=np.ones((Q, ns)),
                H=rng.standard_normal((T, Q)),
                St=noise * (F @ F.T / T + np.eye(T)),
                Y=rng.standard_normal((n, T)),
                mean_star=rng.standard_normal((ns, T)))


def test_lmc_log_prob_value_and_gradients_match_jax():
    p = problem()
    names = ("Ks", "H", "St", "Y")
    jv, jg = jax.jit(jax.value_and_grad(jwb.lmc_log_prob,
                                        argnums=(0, 1, 2, 3)))(
        *[jnp.asarray(p[k]) for k in names])
    args = [t64(p[k]).requires_grad_(True) for k in names]
    tv = twb.lmc_log_prob(*args)
    tv.backward()
    close(tv, jv, what="value")
    for a, g, name in zip(args, jg, names):
        close(a.grad, g, rtol=1e-7, what=name)


@pytest.mark.parametrize("low_rank", [False, True])
def test_factors_and_solve_match_jax(low_rank):
    """``lmc_factors`` (the n×n roots) or ``lmc_factors_from_roots`` on
    (n, 12) Nyström roots: every factor, the solve and the log-density."""
    p = problem(1)
    H, St, Y = p["H"], p["St"], p["Y"]
    names = ("L_G", "Rt", "C", "SinvH", "L_cap", "solve", "log_prob")
    if low_rank:
        roots = np.asarray(jax.jit(jit_ops.nystrom_roots_from_kernels,
                                   static_argnums=1)(jnp.asarray(p["Ks"]), 12))
        jfac = lambda: jwb.lmc_factors_from_roots(roots, H, St)  # noqa: E731
        tf = twb.lmc_factors_from_roots(t64(roots), t64(H), t64(St))
    else:
        jfac = lambda: jwb.lmc_factors(p["Ks"], H, St)           # noqa: E731
        tf = twb.lmc_factors(t64(p["Ks"]), t64(H), t64(St))

    def jax_side():
        f = jfac()
        return [f[k] for k in names[:5]] + [
            jwb.lmc_solve(Y, f), jwb.lmc_log_prob(None, H, St, Y, fac=f)]
    got = [tf[k] for k in names[:5]] + [
        twb.lmc_solve(t64(Y), tf),
        twb.lmc_log_prob(None, t64(H), t64(St), t64(Y), fac=tf)]
    for a, b, what in zip(got, jax.jit(jax_side)(), names):
        close(a, b, what=what)
    assert (tf["q"], tf["n"], tf["r"]) == (Q, N, 12 if low_rank else N)


@pytest.mark.parametrize("chunk", [256, 16])
@pytest.mark.parametrize("noise", [True, False])
def test_posterior_mean_and_variance_match_jax(chunk, noise):
    """Mean and variance diagonal at 30 test points, in one chunk and in
    chunks of 16 (the loop with a ragged last chunk)."""
    p = problem(2)

    def jax_side():
        f = jwb.lmc_factors(p["Ks"], p["H"], p["St"])
        alpha = jwb.lmc_solve(p["Y"], f)
        return (alpha, jwb.lmc_posterior_mean(p["Kstars"], p["H"], alpha,
                                              p["mean_star"]),
                jwb.lmc_posterior_variance(p["Kstars"], p["kss"], p["H"],
                                           p["St"], f, noise=noise,
                                           chunk=chunk))
    alpha, mean, var = jax.jit(jax_side)()
    tf = twb.lmc_factors(t64(p["Ks"]), t64(p["H"]), t64(p["St"]))
    close(twb.lmc_posterior_mean(t64(p["Kstars"]), t64(p["H"]), t64(alpha),
                                 t64(p["mean_star"])), mean, what="mean")
    got = twb.lmc_posterior_variance(t64(p["Kstars"]), t64(p["kss"]),
                                     t64(p["H"]), t64(p["St"]), tf,
                                     noise=noise, chunk=chunk)
    assert got.shape == (NS, T)
    close(got, var, what="variance")


def test_chol_inverse_diag_value_and_gradient_match_jax():
    p = problem(3)
    A = p["Ks"] + 0.1 * np.eye(N)
    jv, jg = jax.jit(jax.value_and_grad(lambda a: jnp.sum(
        jnp.log(jchol.chol_inverse_diag(jchol.safe_cholesky(a))))))(
        jnp.asarray(A))
    ta = t64(A).requires_grad_(True)
    tv = torch.log(tchol.chol_inverse_diag(tchol.safe_cholesky(ta))).sum()
    tv.backward()
    close(tv, jv)
    close(ta.grad, jg, rtol=1e-7)
    close(tchol.add_jitter(t64(A), 0.5), jchol.add_jitter(A, 0.5))


def test_jacobi_diag_and_nystrom_precond_match_jax():
    p = problem(4)
    Ks, H, St = p["Ks"], p["H"], p["St"]
    V = np.random.default_rng(5).standard_normal((3, N, T))

    def jax_side():
        roots = jit_ops.nystrom_roots_from_kernels(jnp.asarray(Ks), 10)
        return (roots, jit_ops._jacobi_diag(Ks, H, St),
                jit_ops.nystrom_precond(Ks, H, St, 10, roots=roots)(V))
    roots, diag, mv = jax.jit(jax_side)()
    close(tit_ops._jacobi_diag(t64(Ks), t64(H), t64(St)), diag)
    close(tit_ops.nystrom_precond(t64(Ks), t64(H), t64(St), 10,
                                  roots=t64(roots))(t64(V)), mv)


@pytest.mark.parametrize("precond", ["nystrom", "jacobi"])
@pytest.mark.parametrize("max_iters,tol", [(400, 1e-9), (5, 1e-9),
                                           (400, 1e-3)])
def test_batched_pcg_matches_jax(precond, max_iters, tol):
    """Two right-hand sides; the stop at ``tol`` (same iteration count, so
    the same iterate) and at ``max_iters``. The task noise keeps CG stable
    (σ = 1 under the Nyström preconditioner, 20 under the Jacobi one): on an
    ill-conditioned system the two packages' rounding differences (1e-16)
    grow about tenfold an iteration, in either package."""
    p = problem(6, noise=1.0 if precond == "nystrom" else 20.0)
    Ks, H, St = p["Ks"], p["H"], p["St"]
    B = np.random.default_rng(7).standard_normal((2, N, T))
    kw = dict(max_iters=max_iters, tol=tol)
    roots = np.asarray(jax.jit(jit_ops.nystrom_roots_from_kernels,
                               static_argnums=1)(jnp.asarray(Ks), 8))

    def jax_side():
        Md = jnp.clip(jit_ops._jacobi_diag(Ks, H, St), 1e-10)
        minv = jit_ops.nystrom_precond(Ks, H, St, 8, roots=roots) \
            if precond == "nystrom" else None
        return jit_ops.batched_pcg(lambda V: jit_ops.lmc_matvec(Ks, H, St, V),
                                   B, Md, minv=minv, **kw)
    want = jax.jit(jax_side)()
    Md = torch.clamp(tit_ops._jacobi_diag(t64(Ks), t64(H), t64(St)),
                     min=1e-10)
    minv = tit_ops.nystrom_precond(t64(Ks), t64(H), t64(St), 8,
                                   roots=t64(roots)) \
        if precond == "nystrom" else None
    got = tit_ops.batched_pcg(
        lambda V: tit_ops.lmc_matvec(t64(Ks), t64(H), t64(St), V), t64(B),
        Md, minv=minv, **kw)
    close(got, want, rtol=1e-8)


def test_residual_spectral_bound_matches_jax_from_its_start_vector():
    """The JAX function draws its start vector from PRNGKey(seed); the port
    takes that vector as ``v0``, or draws from a generator."""
    p = problem(8)
    Ks, H = p["Ks"], p["H"]

    def jax_side():
        roots = jit_ops.nystrom_roots_from_kernels(jnp.asarray(Ks), 6)
        return roots, jit_ops.residual_spectral_bound(Ks, roots, H, seed=3)
    roots, want = jax.jit(jax_side)()
    v0 = jax.random.normal(jax.random.PRNGKey(3), (N, T), jnp.float64)
    got = tit_ops.residual_spectral_bound(t64(Ks), t64(roots), t64(H),
                                          v0=t64(v0))
    close(got, want)
    drawn = [float(tit_ops.residual_spectral_bound(
        t64(Ks), t64(roots), t64(H),
        generator=torch.Generator().manual_seed(s))) for s in (1, 1)]
    assert drawn[0] == drawn[1] > 0


KERNELS = {"rbf": (jker.RBFKernel, tker.RBFKernel, {}),
           "matern05": (jker.MaternKernel, tker.MaternKernel, dict(nu=0.5)),
           "matern15": (jker.MaternKernel, tker.MaternKernel, dict(nu=1.5)),
           "matern25": (jker.MaternKernel, tker.MaternKernel, dict(nu=2.5))}


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("kind", sorted(KERNELS))
def test_kernel_diagonal_and_1d_inputs_match_jax(kind, scaled):
    """``diag=True`` on (n, d) inputs (and on inputs of unequal length, the
    shorter's diagonal) and the dense matrix on 1-D inputs, bare and in a
    ScaleKernel, with lengthscales and outputscales off their defaults."""
    jcls, tcls, kw = KERNELS[kind]
    rng = np.random.default_rng(9)
    jk = jcls(ard_num_dims=2, batch_shape=Q, dtype=jnp.float64, **kw)
    jk = jk.replace(raw_lengthscale=jk.raw_lengthscale
                    + rng.uniform(-0.5, 0.5, (Q, 1, 2)))
    tk = tcls(ard_num_dims=2, batch_shape=Q, dtype=torch.float64,
              device="cpu", **kw)
    with torch.no_grad():
        tk.raw_lengthscale.copy_(t64(jk.raw_lengthscale))
    j1 = jcls(batch_shape=Q, dtype=jnp.float64, **kw)
    j1 = j1.replace(raw_lengthscale=j1.raw_lengthscale + 0.3)
    t1 = tcls(batch_shape=Q, dtype=torch.float64, device="cpu", **kw)
    with torch.no_grad():
        t1.raw_lengthscale.copy_(t64(j1.raw_lengthscale))
    if scaled:
        os_raw = rng.uniform(-1, 1, Q)
        jk, j1 = (jker.ScaleKernel(k, dtype=jnp.float64).replace(
                      raw_outputscale=os_raw)
                  for k in (jk, j1))
        tk, t1 = (tker.ScaleKernel(k, dtype=torch.float64) for k in (tk, t1))
        for k in (tk, t1):
            with torch.no_grad():
                k.raw_outputscale.copy_(t64(os_raw))
    x, x2 = rng.uniform(-1, 1, (12, 2)), rng.uniform(-1, 1, (9, 2))
    z, z2 = rng.uniform(-1, 1, 12), rng.uniform(-1, 1, 7)
    close(tk(t64(x), diag=True), jk(x, diag=True), what="diag")
    close(tk(t64(x), t64(x2), diag=True), jk(x, x2, diag=True),
          what="diag of a rectangle")
    close(t1(t64(z), t64(z2)), j1(z, z2), what="1-D inputs")
    close(t1(t64(z), diag=True), j1(z, diag=True), what="1-D diag")
