"""The port's exact-ICM ops against the JAX package's, on the CPU in
float64: ``distributions.KronCov``, ``ops/kron.py`` (the joint
diagonalization, the batched-Cholesky MLL with its analytic backward, the
solve and the posterior) and the ICM part of ``ops/iterative.py`` (the
product, the whitened Nyström parts, the PCG estimator with its backward,
the residual's spectral bound and the conservative variance). Same numpy
inputs, made from a seed; values to rtol 1e-10 and gradients to 1e-8 of
their largest entry on the dense route, the PCG estimator to 1e-9 and 1e-7.

The ICM probes are drawn in the eigenbasis of the whitened task covariance,
whose eigenvectors' signs are each LAPACK's choice; the port fixes them
(``iterative._eigh_fixed_signs``), and the estimator's tests feed the port
JAX's eigenbasis instead (``jax_eigenbasis``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu import distributions as jdist
from projected_lmc_tpu.ops import iterative as jit_ops
from projected_lmc_tpu.ops import kron as jkron
from projected_lmc_tpu_torch import distributions as tdist
from projected_lmc_tpu_torch.ops import iterative as tit_ops
from projected_lmc_tpu_torch.ops import kron as tkron

N, T, NS = 16, 4, 12


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


def matern(x, z, ls):
    d = np.sqrt(((x[:, None, :] - z[None, :, :]) ** 2).sum(-1)) / ls
    return (1 + np.sqrt(5) * d + 5 * d ** 2 / 3) * np.exp(-np.sqrt(5) * d)


def problem(kind="generic", seed=0, n=N, t=T, ns=NS, noise=1.0):
    """A Matérn-2.5 kernel on random 2-D inputs, its cross-covariance at
    test points, B, Σt and targets. ``kind``: "generic" (B of rank 2 plus a
    diagonal), "clustered" (Σt = GGᵀ + 0.7 I of full rank, so the whitened
    B has a cluster of near-equal eigenvalues), "rank1" (B = ffᵀ + 4.5e-5 I,
    the rank-1 ICM with a frozen diagonal)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))
    xs = rng.uniform(-1.2, 1.2, (ns, 2))
    G = rng.standard_normal((t, t))
    St = noise * (G @ G.T / t + np.eye(t))
    if kind == "generic":
        F = rng.standard_normal((t, 2))
        B = F @ F.T + np.diag(rng.uniform(0.1, 0.5, t))
    elif kind == "clustered":
        F = rng.standard_normal((t, t - 1))
        B = F @ F.T + np.diag(np.log1p(np.exp(rng.standard_normal(t))))
        St = G @ G.T + 0.7 * np.eye(t)
    else:
        f = rng.standard_normal((t, 1))
        B = f @ f.T + 4.5e-5 * np.eye(t)
    return dict(K=matern(x, x, 0.5), Kstar=matern(xs, x, 0.5),
                kss=np.ones(ns), B=B, St=St, Y=rng.standard_normal((n, t)),
                mean_star=rng.standard_normal((ns, t)))


# -- distributions.KronCov --------------------------------------------------------

def test_kron_cov_matches_jax():
    """diag and dense with and without noise, ``with_noise``, the centred
    log-density (through ``icm_log_prob``), and the refusal without noise."""
    p = problem(seed=1)

    def side(d, a):
        out = []
        for s in (None, a(p["St"])):
            kc = d.KronCov(a(p["K"]), a(p["B"]), s)
            out += [kc.diag(), kc.dense()]
        kc = d.KronCov(a(p["K"]), a(p["B"])).with_noise(a(p["St"]))
        return out + [kc.dense(), kc.log_prob_centered(a(p["Y"])),
                      d.MultitaskMultivariateNormal(
                          a(p["Y"]) * 0.5, kc).log_prob(a(p["Y"]))]
    want = jax.jit(lambda: side(jdist, jnp.asarray))()
    for a, b in zip(side(tdist, t64), want):
        close(a, b)
    with pytest.raises(ValueError, match="task noise"):
        tdist.KronCov(t64(p["K"]), t64(p["B"])).log_prob_centered(t64(p["Y"]))


# -- ops/kron.py ------------------------------------------------------------------

PROBLEMS = ("generic", "clustered", "rank1")


@pytest.mark.parametrize("kind", PROBLEMS)
def test_eig_factors_log_prob_and_solve_match_jax(kind):
    """The sign-free factors (Rt, λ, γ, S), the log-density and α, with the
    default jitter; the solve held to the dense system as well."""
    p = problem(kind, seed=2)
    args = [p[k] for k in ("K", "B", "St")]

    def side(m, a):
        fac = m.icm_eig_factors(*map(a, args))
        return (fac["Rt"], fac["lam"], fac["gam"], fac["S"],
                m.icm_log_prob(*map(a, args), a(p["Y"])),
                m.icm_solve(a(p["Y"]), fac))
    want = jax.jit(lambda: side(jkron, jnp.asarray))()
    got = side(tkron, t64)
    for a, b, what in zip(got, want, ("Rt", "lam", "gam", "S", "log_prob",
                                      "solve")):
        close(a, b, what=what)
    dense = np.kron(p["K"] + 1e-8 * np.eye(N), p["B"]) + np.kron(np.eye(N),
                                                                 p["St"])
    close(got[-1].reshape(-1), np.linalg.solve(dense, p["Y"].reshape(-1)),
          rtol=1e-8)


@pytest.mark.parametrize("kind", PROBLEMS)
def test_log_prob_chol_value_and_gradients_match_jax(kind):
    """The batched-Cholesky MLL and its analytic backward against the JAX
    custom VJP on a generic problem, a clustered whitened spectrum and a
    rank-1 B with a tiny diagonal."""
    p = problem(kind, seed=3)
    names = ("K", "B", "St", "Y")
    jv, jg = jax.jit(jax.value_and_grad(jkron.icm_log_prob_chol,
                                        argnums=(0, 1, 2, 3)))(
        *[jnp.asarray(p[k]) for k in names])
    args = [t64(p[k]).requires_grad_(True) for k in names]
    tv = tkron.icm_log_prob_chol(*args)
    tv.backward()
    close(tv, jv, what="value")
    for a, g, name in zip(args, jg, names):
        close(a.grad, g, rtol=1e-8, what=name)


def _graph_ops(fn):
    seen, stack, names = set(), [fn], set()
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.add(type(f).__name__)
        stack.extend(g for g, _ in f.next_functions)
    return names


def test_log_prob_chol_backward_never_passes_through_eigh():
    """Autograd records no ``eigh`` anywhere in the Cholesky MLL's graph,
    which ends in the analytic backward; the eigen-route ``icm_log_prob``
    does record one (the check can see it)."""
    p = problem("clustered", seed=4)
    args = [t64(p[k]).requires_grad_(True) for k in ("K", "B", "St", "Y")]
    K2 = args[0] * 1.0                        # a node above the Function
    chol = _graph_ops(tkron.icm_log_prob_chol(K2, *args[1:]).grad_fn)
    eig = _graph_ops(tkron.icm_log_prob(K2, *args[1:]).grad_fn)
    assert "_IcmLogProbCholBackward" in chol and "MulBackward0" in chol
    assert not any("Eigh" in name for name in chol)
    assert any("Eigh" in name for name in eig)


def test_log_prob_chol_mixed_dtypes_return_each_primal_dtype():
    """A float32 task noise on a float64 model: computed in float64, each
    cotangent in its primal's dtype, as the JAX VJP."""
    p = problem(seed=5)
    dts = (np.float64, np.float64, np.float32, np.float64)
    vals = [p[k].astype(dt) for k, dt in zip(("K", "B", "St", "Y"), dts)]
    jv, jg = jax.jit(jax.value_and_grad(jkron.icm_log_prob_chol,
                                        argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, vals))
    args = [torch.tensor(v).requires_grad_(True) for v in vals]
    tkron.icm_log_prob_chol(*args).backward()
    for a, g in zip(args, jg):
        assert a.grad.dtype == a.dtype
        close(a.grad, g, rtol=1e-6)


def test_chol_bf16_matches_jax():
    """``chol_bf16`` with blocks of 8 (two blocks at n = 16): the blocked
    factor's bf16 updates round alike on both sides, so the value is JAX's
    to 1e-8 (and within 1e-4 of the exact route's); the backward is the
    exact analytic one, so every gradient is JAX's to 1e-8 of its largest
    entry."""
    p = problem(seed=6)
    args = [p[k] for k in ("K", "B", "St", "Y")]
    vj, gj = jax.jit(jax.value_and_grad(
        lambda *a: jkron.icm_log_prob_chol(*a, 1e-8, True, 8),
        argnums=(0, 1, 2, 3)))(*map(jnp.asarray, args))
    ts = [t64(a).requires_grad_(True) for a in args]
    vt = tkron.icm_log_prob_chol(*ts, chol_bf16=True, chol_block=8)
    vt.backward()
    close(vt, vj, rtol=1e-8)
    exact = tkron.icm_log_prob_chol(*map(t64, args))
    close(vt, exact, rtol=1e-4)
    for a, g, name in zip(ts, gj, ("K", "B", "St", "Y")):
        close(a.grad, g, rtol=1e-8, what=name)


@pytest.mark.parametrize("chunk", [1024, 5])
@pytest.mark.parametrize("noise", [True, False])
def test_posterior_mean_and_variance_match_jax(chunk, noise):
    """Mean and variance diagonal at 12 test points in one chunk and in
    chunks of 5 (a ragged last chunk)."""
    p = problem(seed=7)

    def side(m, a):
        fac = m.icm_eig_factors(a(p["K"]), a(p["B"]), a(p["St"]))
        alpha = m.icm_solve(a(p["Y"]), fac)
        nd = a(np.diag(p["St"])) if noise else None
        return (m.icm_posterior_mean(a(p["Kstar"]), a(p["B"]), alpha,
                                     a(p["mean_star"])),
                m.icm_posterior_variance(a(p["kss"]), a(p["Kstar"]),
                                         a(p["B"]), fac, noise_diag=nd,
                                         chunk=chunk))
    want = jax.jit(lambda: side(jkron, jnp.asarray))()
    for a, b, what in zip(side(tkron, t64), want, ("mean", "variance")):
        close(a, b, what=what)


# -- the matrix-free ICM (ops/iterative.py) ----------------------------------------

@pytest.mark.parametrize("rhs", [(), (3,)])
def test_icm_matvec_matches_jax(rhs):
    p = problem(seed=8)
    V = np.random.default_rng(9).standard_normal(rhs + (N, T))
    args = [p["K"], p["B"], p["St"], V]
    want = jax.jit(jit_ops.icm_matvec)(*map(jnp.asarray, args))
    close(tit_ops.icm_matvec(*map(t64, args)), want, rtol=1e-12)


@pytest.mark.parametrize("rhs", [(), (3,)])
def test_icm_matvec_with_a_bf16_kernel_returns_fp32(rhs):
    """A bf16 K: fp32 products of the bf16 values (never rounded to bf16),
    float64 elsewhere, within the bf16-stack test's rtol 1e-5 of JAX's
    ``preferred_element_type=float32`` product."""
    p = problem(seed=10)
    V = np.random.default_rng(11).standard_normal(rhs + (N, T))
    Kb = jnp.asarray(p["K"], jnp.float32).astype(jnp.bfloat16)
    want = jax.jit(jit_ops.icm_matvec)(Kb, *map(jnp.asarray,
                                                 (p["B"], p["St"], V)))
    Kt = torch.tensor(p["K"], dtype=torch.float32).to(torch.bfloat16)
    KV = tit_ops._kernel_product(Kt, t64(V))
    assert KV.dtype == torch.float32
    np.testing.assert_allclose(
        KV.numpy(), np.matmul(Kt.float().numpy(),
                              t64(V).to(torch.bfloat16).float().numpy()),
        rtol=1e-6, atol=1e-6)
    got = tit_ops.icm_matvec(Kt, t64(p["B"]), t64(p["St"]), t64(V))
    assert got.dtype == torch.float64
    close(got, want, rtol=1e-5)


@pytest.mark.parametrize("given_roots", [True, False])
def test_whitened_parts_and_preconditioner_match_jax(given_roots,
                                                     jax_eigenbasis):
    """R, γ, P, P⁻¹, C⁻¹, logdet M and the apply M⁻¹ on 3 right-hand sides,
    from rank-6 roots given or sliced from K."""
    p = problem(seed=12)
    V = np.random.default_rng(13).standard_normal((3, N, T))
    roots = np.asarray(jit_ops.nystrom_roots_from_kernels(
        jnp.asarray(p["K"])[None], 6))[0]

    def side(m, a):
        r = a(roots) if given_roots else None
        parts = m.icm_whitened_parts(a(p["K"]), a(p["B"]), a(p["St"]), 6,
                                     roots=r)
        minv = m._icm_nystrom_parts(a(p["K"]), a(p["B"]), a(p["St"]), 6,
                                    roots=r)[3]
        return [parts[k] for k in ("R", "gam", "P", "P_inv", "C_inv",
                                   "logdet_M")] + [minv(a(V))]
    want = jax.jit(lambda: side(jit_ops, jnp.asarray))()
    for a, b, what in zip(side(tit_ops, t64), want, (
            "R", "gam", "P", "P_inv", "C_inv", "logdet_M", "minv")):
        close(a, b, what=what)


def test_fixed_signs_make_each_eigenvectors_largest_entry_positive(
        monkeypatch):
    """The port's own eigenbasis: eigh's pairs, each column's
    largest-magnitude entry positive, the same whatever signs eigh gave."""
    A = np.random.default_rng(14).standard_normal((6, 6))
    A = t64(A @ A.T)
    w, V = tit_ops._eigh_fixed_signs(A)
    close(V @ torch.diag(w) @ V.T, A.numpy())
    top = V.gather(0, V.abs().argmax(0, keepdim=True))
    assert bool((top > 0).all())
    eigh = torch.linalg.eigh

    def flipped(M):
        w_, V_ = eigh(M)
        return w_, V_ * t64([1, -1, 1, -1, -1, 1])
    monkeypatch.setattr(torch.linalg, "eigh", flipped)
    wf, Vf = tit_ops._eigh_fixed_signs(A)
    assert torch.equal(wf, w) and torch.equal(Vf, V)


def _pcg_problem(seed):
    """A problem where CG is stable in both packages (task noise of scale 1
    under a rank-8 Nyström preconditioner), its probes and roots."""
    p = problem(seed=seed, n=24)
    rng = np.random.default_rng(seed + 100)
    eps = rng.standard_normal((5, 24, T))
    xi = rng.standard_normal((5, 8, T))
    roots = np.asarray(jit_ops.nystrom_roots_from_kernels(
        jnp.asarray(p["K"])[None], 8))[0]
    return p, eps, xi, roots


@pytest.mark.parametrize("given_roots", [True, False])
def test_pcg_log_prob_value_and_gradients_match_jax(given_roots,
                                                    jax_eigenbasis):
    """The estimator with JAX's own eps, xi and roots (or roots sliced from
    K inside), CG to 1e-10: value to 1e-9, the gradients of K, B, Σt and Y
    to 1e-7 of their largest entry; no gradient for the probes or roots."""
    p, eps, xi, roots = _pcg_problem(15)
    names = ("K", "B", "St", "Y")
    r = roots if given_roots else None

    def jax_ll(K, B, St, Y):
        return jit_ops.icm_pcg_log_prob(
            K, B, St, Y, jnp.asarray(eps), jnp.asarray(xi),
            None if r is None else jnp.asarray(r), 100, 1e-10, False, 8)
    jv, jg = jax.jit(jax.value_and_grad(jax_ll, argnums=(0, 1, 2, 3)))(
        *[jnp.asarray(p[k]) for k in names])
    args = [t64(p[k]).requires_grad_(True) for k in names]
    probes = [t64(a).requires_grad_(True) for a in (eps, xi)]
    tr = None if r is None else t64(r).requires_grad_(True)
    tv = tit_ops.icm_pcg_log_prob(*args, *probes, tr, max_cg_iters=100,
                                  cg_tol=1e-10, precond_rank=8)
    tv.backward()
    close(tv, jv, rtol=1e-9, what="value")
    for a, g, name in zip(args, jg, names):
        close(a.grad, g, rtol=1e-7, what=name)
    assert all(a.grad is None for a in probes)
    assert tr is None or tr.grad is None


def test_pcg_log_prob_with_a_bf16_kernel_matches_jax(jax_eigenbasis):
    """``matvec_bf16``: both round K to bf16 and take fp32 products of bf16
    values in the CG and in the backward's K stream, CG to 1e-6. The value
    to 1e-5; the gradients normwise to 2e-2, as the LMC's bf16 stack."""
    p, eps, xi, roots = _pcg_problem(16)
    names = ("K", "B", "St", "Y")
    Kb = np.asarray(jnp.asarray(p["K"], jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))

    def jax_ll(B, St, Y):
        return jit_ops.icm_pcg_log_prob(
            jnp.asarray(Kb).astype(jnp.bfloat16), B, St, Y, jnp.asarray(eps),
            jnp.asarray(xi), jnp.asarray(roots), 100, 1e-6, True, 8)
    jv, jg = jax.jit(jax.value_and_grad(jax_ll, argnums=(0, 1, 2)))(
        *[jnp.asarray(p[k]) for k in names[1:]])
    K = torch.tensor(Kb).to(torch.bfloat16).requires_grad_(True)
    args = [t64(p[k]).requires_grad_(True) for k in names[1:]]
    tv = tit_ops.icm_pcg_log_prob(K, *args, t64(eps), t64(xi), t64(roots),
                                  max_cg_iters=100, cg_tol=1e-6,
                                  matvec_bf16=True, precond_rank=8)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    assert K.grad.dtype == torch.bfloat16
    for a, g, name in zip(args, jg, names[1:]):
        rel = np.linalg.norm(a.grad.numpy() - g) / np.linalg.norm(g)
        assert rel < 2e-2, (name, rel)


def test_residual_spectral_bound_matches_jax():
    """Started from JAX's own draw (PRNGKey(0), (n, 1)), rank-6 roots; and
    from a generator, a bound ≥ 0 that the same seed repeats."""
    p = problem(seed=17)
    roots = np.asarray(jit_ops.nystrom_roots_from_kernels(
        jnp.asarray(p["K"])[None], 6))[0]
    want = jax.jit(jit_ops.icm_residual_spectral_bound)(
        *map(jnp.asarray, (p["K"], roots, p["B"])))
    v0 = jax.random.normal(jax.random.PRNGKey(0), (N, 1), jnp.float64)
    got = tit_ops.icm_residual_spectral_bound(
        *map(t64, (p["K"], roots, p["B"])), v0=t64(v0))
    close(got, want)
    draws = [tit_ops.icm_residual_spectral_bound(
        *map(t64, (p["K"], roots, p["B"])),
        generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert float(draws[0]) >= 0.0 and torch.equal(*draws)


@pytest.mark.parametrize("noise", [True, False])
def test_nystrom_posterior_variance_matches_jax(noise, jax_eigenbasis):
    """The conservative variance through parts built with an inflated
    Σt + 0.3·I, against JAX's."""
    p = problem(seed=18)
    roots = np.asarray(jit_ops.nystrom_roots_from_kernels(
        jnp.asarray(p["K"])[None], 6))[0]
    St_up = p["St"] + 0.3 * np.eye(T)

    def side(m, a):
        parts = m.icm_whitened_parts(None, a(p["B"]), a(St_up), 6,
                                     roots=a(roots))
        return m.icm_nystrom_posterior_variance(
            a(p["Kstar"]), a(p["kss"]), a(p["B"]), a(p["St"]), parts,
            noise=noise)
    want = jax.jit(lambda: side(jit_ops, jnp.asarray))()
    close(side(tit_ops, t64), want)
