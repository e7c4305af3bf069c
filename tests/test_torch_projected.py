"""The port's projected LMC (``projected_lmc_tpu_torch.models.projected``,
``mlls.projected_lmc_mll``) and its jitter ladder against the JAX package's,
on the CPU.

The JAX model's leaves, moved off their defaults, are carried into the
port with ``load_jax_state``. Value, every gradient by key path, the terms,
``full_likelihood().chol`` and three ``fit`` steps must agree (float64);
the flagship model of ``__graft_entry__`` in float32.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu import constraints as jcons
from projected_lmc_tpu.experiments.synthetic import \
    generate_synthetic as jax_synthetic
from projected_lmc_tpu.mlls import projected_lmc_mll as jax_mll
from projected_lmc_tpu.models.projected import LMCMixingMatrix as JaxMix
from projected_lmc_tpu.models.projected import ProjectedGPModel as JaxModel
from projected_lmc_tpu.module import trainable_mask
from projected_lmc_tpu.ops import cholesky as jchol
from projected_lmc_tpu.training import fit as jax_fit
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import (ProjectedGPModel, fit, load_jax_state,
                                     projected_lmc_mll)
from projected_lmc_tpu_torch import constraints as tcons
from projected_lmc_tpu_torch.experiments import generate_synthetic
from projected_lmc_tpu_torch.models.projected import LMCMixingMatrix
from projected_lmc_tpu_torch.module import keyed_state
from projected_lmc_tpu_torch.ops import cholesky as tchol

# tests/test_mlls.py's TestProjectedMLLIdentity configurations, the flagship
# (full B̃, learned M) and the factored maps
PLMC = dict(BDN=False, diagonal_B=False, scalar_B=False, diagonal_R=False)
CONFIGS = {
    "PLMC": PLMC,
    "diagonal_B": dict(BDN=True, diagonal_B=True, scalar_B=False,
                       diagonal_R=False),
    "PLMC_fast": dict(BDN=True, diagonal_B=True, scalar_B=True,
                      diagonal_R=False),
    "oilmm_expm": dict(BDN=True, diagonal_B=True, scalar_B=True,
                       diagonal_R=True, bulk=False),
    "full_B_BDN_cayley": dict(BDN=True, diagonal_B=False, scalar_B=False,
                              bulk=False, ortho_param="cayley"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny torch ops in long loops: one intra-op thread
    avoids oversubscribing the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_data(n=25, p=5, q=2, seed=0, dtype=np.float64):
    """tests/test_mlls.py's data (``__graft_entry__._tiny_model``'s at n=32,
    p=6)."""
    rng = np.random.default_rng(seed)
    X = np.linspace(-1, 1, n)[:, None]
    U = np.stack([np.sin(3 * X[:, 0]), np.cos(5 * X[:, 0])][:q], axis=1)
    H = rng.standard_normal((q, p))
    Y = U @ H + 0.05 * rng.standard_normal((n, p))
    return X.astype(dtype), Y.astype(dtype)


def jax_arrays(jm):
    return {k: np.asarray(v) for k, v in _keyed_leaves(jm)}


def with_arrays(jm, arrays):
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jm),
        [jnp.asarray(arrays[k]) for k, _ in _keyed_leaves(jm)])


def models(cfg, perturb=True, n=25, p=5, q=2, seed=0, **kw):
    """A JAX model (trainable leaves moved off their defaults when
    ``perturb``) and the port model carrying its leaves."""
    X, Y = make_data(n, p, q, seed)
    args = dict(init_lmc_coeffs=True, kernel_type="matern", **cfg, **kw)
    jm = JaxModel(X, Y, p, q, **args)
    arrays = jax_arrays(jm)
    if perturb:
        rng = np.random.default_rng(seed + 2)
        for (k, _), trainable in zip(_keyed_leaves(jm), trainable_mask(jm)):
            if trainable:
                arrays[k] = arrays[k] + rng.uniform(-0.3, 0.3,
                                                    arrays[k].shape)
        jm = with_arrays(jm, arrays)
    tm = ProjectedGPModel(X, Y, p, q, device="cpu", **args)
    load_jax_state(tm, arrays)
    return jm, tm


def assert_grads_match(tm, jgrad):
    """Every trainable leaf's gradient, by key path."""
    jg = dict(_keyed_leaves(jgrad))
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    for name in names:
        p = dict(tm.named_parameters())[name]
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg["." + name]),
                                   rtol=1e-7, atol=1e-10, err_msg=name)
    assert len(names) >= 4


# -- the matrix parametrizations ----------------------------------------------

PARAMS = {
    "scalar": (lambda m: m.scalar_param, dict(bounds=(-0.2, 0.2)), None),
    "positive_diagonal": (lambda m: m.positive_diagonal_param, {},
                          lambda m: m.positive_diagonal_param_inverse),
    "upper": (lambda m: m.upper_triangular_param, {},
              lambda m: m.upper_triangular_param_inverse),
    "upper_bounded": (lambda m: m.upper_triangular_param,
                      dict(bounds=(-0.5, 0.5)),
                      lambda m: m.upper_triangular_param_inverse),
    "lower_bounded": (lambda m: m.lower_triangular_param,
                      dict(bounds=(-0.5, 0.5)),
                      lambda m: m.lower_triangular_param_inverse),
}


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_matrix_parametrization_matches_jax(name):
    """Value and gradient of each parametrization (the clamp on the
    diagonal, before exp, moves part of it to a bound); its inverse
    recovers the raw diagonal and triangle."""
    get, kw, get_inv = PARAMS[name]
    rng = np.random.default_rng(4)
    raw = rng.uniform(-1, 1, (4, 4))
    C = rng.standard_normal((4, 4))
    v, g = jax.value_and_grad(
        lambda r: jnp.sum(get(jcons)(r, **kw) * C))(jnp.asarray(raw))
    rt = torch.tensor(raw, requires_grad=True)
    out = get(tcons)(rt, **kw)
    (out * torch.tensor(C)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(get(jcons)(jnp.asarray(raw), **kw)),
                               rtol=1e-14)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(g), rtol=1e-14,
                               atol=1e-15)
    if get_inv is not None:
        target = out.detach()
        np.testing.assert_allclose(
            get_inv(tcons)(target).numpy(),
            np.asarray(get_inv(jcons)(jnp.asarray(target.numpy()))),
            rtol=1e-14)


# -- the mixing matrix --------------------------------------------------------

@pytest.mark.parametrize("mode,bulk,ortho,diagonal_R", [
    ("Q_plus", True, "matrix_exp", False),
    ("Q", True, "matrix_exp", False),
    ("Q_plus", False, "matrix_exp", False),
    ("Q_plus", False, "matrix_exp", True),
    ("Q", False, "cayley", False),
    ("Q_plus", False, "cayley", True),
])
def test_mixing_matrix_matches_jax(mode, bulk, ortho, diagonal_R):
    """QR() and __call__ in each mode and map: values, and the gradient of
    a random functional of Q, R, Q⊥ and Hᵀ by leaf."""
    p, q = 6, 2
    rng = np.random.default_rng(5)
    Q_plus, _ = np.linalg.qr(rng.standard_normal((p, p)))
    if mode == "Q":
        Q_plus = Q_plus[:, :q]
    R = np.diag(rng.uniform(0.5, 2.0, q))
    kw = dict(bulk=bulk, diagonal_R=diagonal_R, ortho_param=ortho)
    jmix = JaxMix(jnp.asarray(Q_plus), jnp.asarray(R), **kw)
    arrays = jax_arrays(jmix)
    for k in arrays:
        if k in (".H", ".ortho_raw", ".R_raw"):
            arrays[k] = arrays[k] + rng.uniform(-0.3, 0.3, arrays[k].shape)
    jmix = with_arrays(jmix, arrays)
    tmix = LMCMixingMatrix(torch.tensor(Q_plus), torch.tensor(R), **kw)
    assert sorted(keyed_state(tmix)) == sorted(arrays)
    load_jax_state(tmix, arrays)
    weights = [rng.standard_normal(s) for s in
               ((p, q), (q, q), (p, p - q), (q, p))]

    def functional(mix, lib):
        Q, R_, Q_orth = mix.QR()
        parts = [Q, R_, Q_orth, mix()]
        return sum((a * lib(w)).sum() for a, w in zip(parts, weights)
                   if a is not None)

    vj, gj = jax.value_and_grad(lambda m: functional(m, jnp.asarray))(jmix)
    vt = functional(tmix, torch.tensor)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-12)
    for got, want in zip(tmix.QR(), jmix.QR()):
        if want is not None:
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-13)
    jg = dict(_keyed_leaves(gj))
    for name, prm in tmix.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(),
                                   np.asarray(jg["." + name]), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    assert tmix.size() == jmix.size() and tmix.size(1) == p
    if not bulk:
        np.testing.assert_allclose(float(tmix.r_raw_diag_sum().detach()),
                                   float(jmix.r_raw_diag_sum()), rtol=1e-14)


# -- the model after construction ---------------------------------------------

@pytest.mark.parametrize("init_lmc_coeffs", [True, False])
@pytest.mark.parametrize("cfg", ["PLMC", "PLMC_fast", "oilmm_expm",
                                 "diagonal_B"])
def test_leaves_key_paths_and_trainable_set_match_jax(cfg, init_lmc_coeffs):
    """Every leaf equal to JAX's after construction (the SVD or random
    init, the B̃ modes), under the same key paths, with the same trainable
    set; ``load_jax_state`` carries the JAX model with no name missing or
    extra."""
    X, Y = make_data(32, 6, 2)
    args = dict(init_lmc_coeffs=init_lmc_coeffs, kernel_type="matern",
                seed=3, **CONFIGS[cfg])
    jm = JaxModel(X, Y, 6, 2, **args)
    tm = ProjectedGPModel(X, Y, 6, 2, device="cpu", **args)
    tstate = keyed_state(tm)
    assert sorted(k for k, _ in _keyed_leaves(jm)) == sorted(tstate)
    for (k, leaf), trainable in zip(_keyed_leaves(jm), trainable_mask(jm)):
        assert tuple(tstate[k].shape) == np.shape(leaf), k
        if np.size(leaf) == 0:
            continue          # ZeroMean's empty placeholder
        assert tstate[k].requires_grad == trainable, k
        # Y_squared_norm is a sum: the two libraries' orders may differ in
        # the last bits
        np.testing.assert_allclose(tstate[k].detach().numpy(),
                                   np.asarray(leaf), rtol=1e-14, err_msg=k)
    load_jax_state(tm, jax_arrays(jm))
    assert (tm.n_tasks, tm.n_latents, tm.n_funcs) == (6, 2, 2)


# -- the MLL ------------------------------------------------------------------

MLL_CASES = dict(CONFIGS, p_equals_q=dict(BDN=True, diagonal_B=True,
                                          scalar_B=False, diagonal_R=False))


@pytest.mark.parametrize("cfg", sorted(MLL_CASES))
def test_mll_value_terms_and_gradients_match_jax(cfg):
    """``projected_lmc_mll`` and its three terms to rtol 1e-10, every
    gradient by key path to rtol 1e-7 (atol 1e-10); p = q leaves B̃
    empty."""
    p = 2 if cfg == "p_equals_q" else 5
    jm, tm = models(MLL_CASES[cfg], p=p)
    (vj, tj), gj = jax.value_and_grad(
        lambda m: jax_mll(m, with_terms=True), has_aux=True)(jm)
    vt, tt = projected_lmc_mll(tm, with_terms=True)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-10)
    for a, b in zip(tt, tj):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-10,
                                   atol=1e-12)
    assert_grads_match(tm, gj)


def test_mll_with_nonzero_M_matches_jax_and_the_dense_model():
    """The M cross term (non-BDN) keeps the identity: the MLL equals the
    dense full model log N(vec Y; 0, Σ_b K_b ⊗ h_b h_bᵀ + I ⊗ Σ)/n."""
    jm, tm = models(PLMC, seed=3)
    assert float(tm.M.detach().abs().min()) > 0
    np.testing.assert_allclose(float(projected_lmc_mll(tm).detach()),
                               float(jax_mll(jm)), rtol=1e-10)
    np.testing.assert_allclose(float(projected_lmc_mll(tm).detach()),
                               dense_full_model_logprob(tm), rtol=1e-8)


def dense_full_model_logprob(tm):
    """log N(vec Y; 0, Σ_b K_b ⊗ h_b h_bᵀ + I_n ⊗ Σ)/n, with Σ = L Lᵀ − 1e-6 I
    from ``full_likelihood`` (which adds that jitter)."""
    with torch.no_grad():
        Y = tm.train_y_tasks.numpy()
        n, p = Y.shape
        Ks = tm.covar_module(tm.train_x).numpy()
        H = tm.lmc_coefficients().numpy()
        Sigma = tm.full_likelihood().task_covariance().numpy() \
            - 1e-6 * np.eye(p)
    cov = np.kron(np.eye(n), Sigma)
    for b in range(Ks.shape[0]):
        cov += np.kron(Ks[b], np.outer(H[b], H[b]))
    L = np.linalg.cholesky(cov)
    z = np.linalg.solve(L, Y.reshape(-1))
    return -0.5 * (z @ z + 2 * np.log(np.diag(L)).sum()
                   + n * p * np.log(2 * np.pi)) / n


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_identity_against_the_dense_full_model(cfg):
    np.testing.assert_allclose(
        float(projected_lmc_mll(models(CONFIGS[cfg])[1]).detach()),
        dense_full_model_logprob(models(CONFIGS[cfg])[1]), rtol=1e-8)


@pytest.mark.parametrize("cfg", ["PLMC", "PLMC_fast", "diagonal_B",
                                 "full_B_BDN_cayley"])
def test_full_likelihood_chol_matches_jax(cfg):
    """The reconstructed p×p noise factor, detached by default and
    differentiable on request; the projection matrix and B̃ beside it."""
    jm, tm = models(CONFIGS[cfg])
    jl = jm.full_likelihood()
    tl = tm.full_likelihood()
    np.testing.assert_allclose(tl.chol.numpy(), np.asarray(jl.chol),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(tl.task_covariance().numpy(),
                               np.asarray(jl.task_covariance()), rtol=1e-10,
                               atol=1e-13)
    assert tl.task_noise_covar_factor is tl.chol and tl.num_tasks == 5
    assert not tl.chol.requires_grad
    assert tm.full_likelihood(differentiable=True).chol.requires_grad
    with torch.no_grad():
        np.testing.assert_allclose(tm.projection_matrix().numpy(),
                                   np.asarray(jm.projection_matrix()),
                                   rtol=1e-10, atol=1e-13)
        np.testing.assert_allclose(tm.B_tilde().numpy(),
                                   np.asarray(jm.B_tilde()), rtol=1e-10,
                                   atol=1e-13)


@pytest.mark.parametrize("cfg", ["PLMC", "oilmm_expm"])
def test_three_fit_steps_match_jax(cfg):
    """``training.fit(model, projected_lmc_mll)``: three AdamW steps, the
    losses to rtol 1e-9."""
    jm, tm = models(CONFIGS[cfg])
    _, jinfo = jax_fit(jm, jax_mll, n_iter=3, lr=0.05, patience=100)
    _, tinfo = fit(tm, projected_lmc_mll, n_iter=3, lr=0.05, patience=100,
                   device="cpu")
    assert len(tinfo["losses"]) == 3
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-9)


def test_introspection_matches_jax():
    jm, tm = models(PLMC)
    np.testing.assert_allclose(tm.lscales(), jm.lscales(), rtol=1e-14)
    np.testing.assert_allclose(tm.outputscale(), jm.outputscale())
    jm, tm = models(PLMC, outputscales=True)
    np.testing.assert_allclose(tm.outputscale(unpacked=True),
                               jm.outputscale(unpacked=True), rtol=1e-14)
    np.testing.assert_allclose(tm.lscales(unpacked=False)[0],
                               jm.lscales(unpacked=False)[0], rtol=1e-14)


def test_flagship_entry_matches_jax_in_float32():
    """``__graft_entry__.entry()``'s model (fp32, n=32, p=6, q=2, full B̃,
    learned M): one MLL value, rtol 1e-5."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        Path(__file__).resolve().parents[1] / "__graft_entry__.py")
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    fn, (jm,) = ge.entry()
    X = np.asarray(jm.train_x)
    Y = np.asarray(jm.train_y_tasks)
    assert X.dtype == np.float32
    tm = ProjectedGPModel(X, Y, 6, 2, init_lmc_coeffs=True,
                          kernel_type="matern", BDN=False, diagonal_B=False,
                          scalar_B=False, device="cpu")
    load_jax_state(tm, jax_arrays(jm))
    np.testing.assert_allclose(float(projected_lmc_mll(tm).detach()),
                               float(fn(jm)), rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_synthetic_is_the_jax_copy_bit_for_bit(seed):
    kw = dict(n=40, p=7, q=3, q_noise=4, n_test=30, seed=seed)
    got, want = generate_synthetic(**kw), jax_synthetic(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sgpr_and_a_missing_card_raise():
    """The SGPR route (ported with slice 5) builds, and its
    ``projected_lmc_mll`` matches JAX's; without a card the default device
    raises."""
    X, Y = make_data()
    jm, tm = models(PLMC, n_inducing_points=8)
    assert tm.sgpr and tuple(tm.inducing_points.shape) == (8, 1)
    np.testing.assert_allclose(float(projected_lmc_mll(tm).detach()),
                               float(jax.jit(jax_mll)(jm)), rtol=1e-10)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        ProjectedGPModel(X, Y, 5, 2)


# -- the jitter ladder --------------------------------------------------------

@pytest.fixture
def factorizations(monkeypatch):
    """Every matrix the ladder factorizes, in order."""
    seen = []
    inner = tchol._factor

    def counted(A):
        seen.append(A.detach().clone())
        return inner(A)

    monkeypatch.setattr(tchol, "_factor", counted)
    return seen


def test_ladder_factorizes_once_when_positive_definite(factorizations):
    """One factorization, the factor and the hand-written pullback as
    JAX's."""
    rng = np.random.default_rng(6)
    V = rng.standard_normal((3, 20, 20))
    A = V @ np.swapaxes(V, -1, -2) + 20 * np.eye(20)
    C = rng.standard_normal(A.shape)
    Lj, gj = jax.value_and_grad(
        lambda a: jnp.sum(jchol.safe_cholesky(a) * C))(jnp.asarray(A))
    At = t64(A).requires_grad_(True)
    L = tchol.safe_cholesky(At)
    assert len(factorizations) == 1
    np.testing.assert_allclose(L.detach().numpy(), np.linalg.cholesky(A),
                               rtol=1e-12)
    (L * t64(C)).sum().backward()
    np.testing.assert_allclose(At.grad.numpy(), np.asarray(gj), rtol=1e-10,
                               atol=1e-13)


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("dtype,noise", [(np.float32, 1e-9),
                                         (np.float64, 0.0)])
def test_ladder_picks_jax_jitter_and_factor(factorizations, dtype, noise):
    """A kernel matrix singular by rounding (duplicated points, noise 1e-9
    in float32, none in float64) climbs the ladder to the jitter JAX's
    while_loop picks, with the same factor; the pullback is the same
    hand-written one."""
    x = np.repeat(np.linspace(-1, 1, 12), 2)[:, None]
    K = np.exp(-0.5 * (x - x.T) ** 2 / 0.3 ** 2)
    A = np.stack([K, 2 * K]) + noise * np.eye(24)
    A = A.astype(dtype)
    C = np.random.default_rng(7).standard_normal(A.shape).astype(dtype)
    assert not np.all(np.isfinite(np.asarray(jnp.linalg.cholesky(A))))
    Lj, jitter = jchol.safe_cholesky_with_jitter(jnp.asarray(A))
    gj = jax.grad(lambda a: jnp.sum(jchol.safe_cholesky(a) * C))(
        jnp.asarray(A))
    At = torch.tensor(A, requires_grad=True)
    L = tchol.safe_cholesky(At)
    picked = float((factorizations[-1] - At.detach())[0].diagonal().mean())
    base = 1e-8 if dtype == np.float64 else 1e-6
    rung = round(math.log10(float(jitter) / base))
    assert len(factorizations) == rung + 2     # the plain factor, then rungs
    np.testing.assert_allclose(picked, float(jitter), rtol=0.1)
    # the jittered matrix keeps a condition number ~1e7 in float32 (~1e16
    # in float64 before its 1e-8 jitter): two LAPACK builds' factors then
    # differ by ~cond·eps in their small entries, while each reproduces it
    eps = np.finfo(dtype).eps
    Aj = A + float(jitter) * np.eye(24, dtype=dtype)
    Ld = L.detach().numpy().astype(np.float64)
    np.testing.assert_allclose(Ld @ np.swapaxes(Ld, -1, -2), Aj,
                               atol=100 * eps)
    np.testing.assert_allclose(Ld, np.asarray(Lj),
                               atol=1e-3 if dtype == np.float32 else 1e-10)
    if dtype == np.float64:     # in float32 the pullback's L⁻¹ magnifies
        (L * torch.tensor(C)).sum().backward()      # those differences 1e7×
        gj = np.asarray(gj)
        np.testing.assert_allclose(At.grad.numpy(), gj, rtol=1e-6,
                                   atol=1e-6 * np.abs(gj).max())


def test_ladder_returns_nan_where_every_rung_fails(factorizations):
    A = torch.stack([torch.eye(4, dtype=torch.float64),
                     -torch.eye(4, dtype=torch.float64)])
    L = tchol.safe_cholesky(A, 3)
    assert len(factorizations) == 4
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1]).all()
