"""The Gaussian log-density's closed-form gradient
(``ops.cholesky.gaussian_log_density``) and the blocked inverse it takes
K⁻¹ from (``ops.cholesky.cholesky_inverse``), on the CPU.

The blocked inverse against ``torch.cholesky_inverse`` in float32 and
float64, batched, at sizes around its leaf (and with small leaves, so that
the products' halving runs too), exactly symmetric. The Function against
the generic route (``safe_cholesky`` + ``solve_triangular`` through
autograd): values, gradients to K and δ under per-task cotangents, on a
matrix that climbs a rung of the jitter ladder, and ``gradcheck`` in
float64. The projected LMC's MLL gradients against the JAX package's with
the blocked inverse recursing. The counters: one closed-form pullback a
step under ``fit.backward`` (the benchmark's
``pullback_closed_form_share.train`` reads 1), and the LOO
pseudo-likelihood still through the generic pullback.
"""

import importlib.util
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import projected_lmc_tpu_torch as pl
from projected_lmc_tpu.mlls import projected_lmc_mll as jax_mll
from projected_lmc_tpu.models.projected import ProjectedGPModel as JaxModel
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import load_jax_state
from projected_lmc_tpu_torch.ops import cholesky as tchol
from projected_lmc_tpu_torch.utils import profiling as tprof

ROOT = Path(__file__).resolve().parent.parent
LEAF = tchol.INVERSE_LEAF
# small leaves: the inverse halves a 389-row matrix twice, and the
# triangular products halve their factors too
SMALL = dict(INVERSE_LEAF=128, TRI_MM_LEAF=128)


@pytest.fixture(autouse=True)
def _empty_store():
    tprof.clear()
    yield
    tprof.clear()


def _leaves(monkeypatch, leaves):
    for k, v in (SMALL if leaves == "small" else {}).items():
        monkeypatch.setattr(tchol, k, v)


def _spd(batch, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((batch, n, n), generator=g, dtype=torch.float64)
    return (X @ X.transpose(-1, -2) / n + torch.eye(n, dtype=torch.float64)
            ).to(dtype)


def _generic(K, delta):
    """The log-density through the generic Cholesky pullback."""
    L = tchol.safe_cholesky(K)
    z = tchol.solve_triangular(L, delta[..., None], lower=True)[..., 0]
    return -0.5 * ((z * z).sum(-1) + tchol.logdet_from_chol(L)
                   + K.shape[-1] * math.log(2 * math.pi))


def _value_and_grads(fn, K, delta, g):
    K = K.clone().requires_grad_(True)
    delta = delta.clone().requires_grad_(True)
    v = fn(K, delta)
    (v * g).sum().backward()
    return v.detach(), K.grad, delta.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("leaves,n", [
    ("shipped", 1), ("shipped", LEAF - 1), ("shipped", LEAF),
    ("shipped", LEAF + 1), ("shipped", 3 * LEAF + 5),
    ("small", 1), ("small", 127), ("small", 128), ("small", 129),
    ("small", 389)])
def test_blocked_inverse_is_the_librarys(monkeypatch, leaves, n, dtype):
    _leaves(monkeypatch, leaves)
    L = torch.linalg.cholesky(_spd(3, n, dtype))
    got = tchol.cholesky_inverse(L)
    want = torch.cholesky_inverse(L)
    assert got.shape == want.shape and got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    scale = want.abs().amax((-2, -1), keepdim=True)
    assert float(((got - want).abs() / scale).max()) < tol
    assert torch.equal(got, got.transpose(-1, -2))
    assert torch.equal(L, torch.linalg.cholesky(_spd(3, n, dtype)))


def test_blocked_inverse_keeps_leading_dimensions():
    L = torch.linalg.cholesky(_spd(6, 20, torch.float64)).reshape(2, 3, 20,
                                                                  20)
    np.testing.assert_allclose(tchol.cholesky_inverse(L).numpy(),
                               torch.cholesky_inverse(L).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-11),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("leaves,n", [("shipped", 60), ("small", 300)])
def test_log_density_is_the_generic_routes(monkeypatch, leaves, n, dtype,
                                           tol):
    """Value and gradients to K and δ under a cotangent of its own for each
    task; K̄ exactly symmetric."""
    _leaves(monkeypatch, leaves)
    K = _spd(4, n, dtype, seed=1)
    g = torch.Generator().manual_seed(2)
    delta = torch.randn((4, n), generator=g, dtype=dtype)
    cot = torch.randn((4,), generator=g, dtype=dtype)
    v, Kb, db = _value_and_grads(tchol.gaussian_log_density, K, delta, cot)
    v0, Kb0, db0 = _value_and_grads(_generic, K, delta, cot)
    assert torch.equal(v, v0)
    for got, want in ((Kb, Kb0), (db, db0)):
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) < tol
    assert torch.equal(Kb, Kb.transpose(-1, -2))


def test_log_density_climbs_the_ladder_as_the_generic_route(monkeypatch):
    """Duplicated points with no noise in float64: the first factor fails
    and the ladder climbs as it does for the generic route; the value, K̄
    and δ̄ are that route's, the gradient to K as given."""
    tries = []
    inner = tchol._factor

    def counted(A):
        tries.append(1)
        return inner(A)

    monkeypatch.setattr(tchol, "_factor", counted)
    x = np.repeat(np.linspace(-1, 1, 12), 2)[:, None]
    K0 = np.exp(-0.5 * (x - x.T) ** 2 / 0.3 ** 2)
    K = torch.tensor(np.stack([K0, 2 * K0]))
    delta = torch.tensor(np.random.default_rng(3).standard_normal((2, 24)))
    cot = torch.tensor([0.7, -1.3], dtype=torch.float64)
    v, Kb, db = _value_and_grads(tchol.gaussian_log_density, K, delta, cot)
    climbed = len(tries)
    assert climbed >= 2
    v0, Kb0, db0 = _value_and_grads(_generic, K, delta, cot)
    assert len(tries) == 2 * climbed
    assert torch.isfinite(v).all()
    np.testing.assert_allclose(v.numpy(), v0.numpy(), rtol=1e-12)
    for got, want in ((Kb, Kb0), (db, db0)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-7 * float(want.abs().max()))


def test_log_density_is_nan_where_every_rung_fails():
    K = torch.stack([torch.eye(3, dtype=torch.float64),
                     -torch.eye(3, dtype=torch.float64)]).requires_grad_()
    v = tchol.gaussian_log_density(K, torch.ones((2, 3), dtype=torch.float64))
    assert torch.isfinite(v[0]) and torch.isnan(v[1])
    v.sum().backward()
    assert torch.isfinite(K.grad[0]).all() and torch.isnan(K.grad[1]).all()


def test_log_density_passes_gradcheck():
    g = torch.Generator().manual_seed(4)
    M = torch.randn((2, 7, 7), generator=g, dtype=torch.float64)
    delta = torch.randn((2, 7), generator=g, dtype=torch.float64,
                        requires_grad=True)

    def f(M, delta):
        K = M @ M.transpose(-1, -2) + 7 * torch.eye(7, dtype=M.dtype)
        return tchol.gaussian_log_density(K, delta)

    assert torch.autograd.gradcheck(f, (M.requires_grad_(), delta))


def _jax_and_port(n=300, p=5, q=2, seed=0):
    rng = np.random.default_rng(seed)
    X = np.linspace(-1, 1, n)[:, None]
    U = np.stack([np.sin(3 * X[:, 0]), np.cos(5 * X[:, 0])][:q], axis=1)
    Y = U @ rng.standard_normal((q, p)) + 0.05 * rng.standard_normal((n, p))
    args = dict(init_lmc_coeffs=True, kernel_type="matern", BDN=False,
                diagonal_B=False, scalar_B=False, diagonal_R=False)
    jm = JaxModel(X, Y, p, q, **args)
    tm = pl.ProjectedGPModel(X, Y, p, q, device="cpu", **args)
    load_jax_state(tm, {k: np.asarray(v) for k, v in _keyed_leaves(jm)})
    return jm, tm


def test_projected_lmc_gradients_are_jaxs(monkeypatch):
    """The projected LMC's MLL (full B̃, learned M) at n = 300 with the
    blocked inverse recursing: value and every trainable leaf's gradient
    against JAX's, in float64, through one closed-form pullback."""
    _leaves(monkeypatch, "small")
    jm, tm = _jax_and_port()
    vj, gj = jax.jit(jax.value_and_grad(jax_mll))(jm)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        vt = pl.projected_lmc_mll(tm)
        vt.backward()
    counts = tprof.summary()["counts"]
    assert counts["cholesky.pullback"] == 1
    assert counts["cholesky.pullback.closed_form"] == 1
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-10)
    jg = dict(_keyed_leaves(gj))
    names = [k for k, p in tm.named_parameters() if p.requires_grad]
    assert len(names) >= 4
    for name in names:
        got = dict(tm.named_parameters())[name].grad.numpy()
        want = np.asarray(jg["." + name])
        np.testing.assert_allclose(got, want, rtol=1e-7,
                                   atol=1e-9 * max(np.abs(want).max(), 1.0),
                                   err_msg=name)


def _metric():
    path = ROOT / "benchmark" / "metrics" / \
        "pullback_closed_form_share.train.py"
    spec = importlib.util.spec_from_file_location("closed_form_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_one_closed_form_pullback_a_fit_step():
    """A profiled ``fit`` of the projected model: one ``cholesky.pullback``
    span a step, under ``fit.backward``, each the closed form; the
    benchmark's share reads 1."""
    steps = 3
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 2)).astype("float32")
    Y = rng.normal(size=(40, 4)).astype("float32")
    model = pl.ProjectedGPModel(X, Y, 4, 2, device="cpu")
    read = _metric()
    assert read(dict(loop="train", profiled_steps=steps)) is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pl.fit(model, pl.projected_lmc_mll, n_iter=steps, scan_steps=1,
               loss_thresh=0.0, device="cpu")
    recs = tprof.spans()
    by_id = {s["id"]: s for s in recs}
    pulls = [s for s in recs if s["name"] == "cholesky.pullback"]
    assert len(pulls) == steps
    for s in pulls:
        assert by_id[s["parent"]]["name"] == "fit.backward"
        assert s["counts"] == {"cholesky.pullback": 1,
                               "cholesky.pullback.closed_form": 1}
    assert read(dict(loop="train", profiled_steps=steps)) == 1.0
    assert read(dict(loop="serve", profiled_steps=steps)) is None


def test_loo_trains_through_the_generic_pullback():
    """The LOO pseudo-likelihood differentiates through L (its K⁻¹
    diagonal), so it keeps the generic pullback: alone its share is 0, and
    beside the exact MLL in one backward ½."""
    read = _metric()
    rng = np.random.default_rng(5)
    X = rng.normal(size=(30, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.normal(size=30)
    lik = pl.GaussianLikelihood(device="cpu")
    model = pl.ExactGPModel(X, y, lik, device="cpu")
    ctx = dict(loop="train", profiled_steps=1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        pl.loo_pseudo_likelihood(model).backward()
        assert read(ctx) == 0.0
        (pl.loo_pseudo_likelihood(model) + pl.exact_mll(model)).backward()
    counts = tprof.summary()["counts"]
    assert counts["cholesky.pullback"] == 3
    assert counts["cholesky.pullback.closed_form"] == 1
    assert read(ctx) == pytest.approx(1 / 3)
