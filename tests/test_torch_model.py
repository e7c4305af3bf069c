"""The port's LMC model and training loop against the JAX package, on the CPU.

The JAX model's leaves are carried into the port with ``load_jax_state`` (so
nothing relies on the SVD init), both models see the same eps and xi (the
ones the JAX model draws from its key), and the MLL, its gradients and
three AdamW steps of ``training.fit`` must agree (float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.models.multitask import MultitaskGPModel as JaxModel
from projected_lmc_tpu.training import fit as jax_fit
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import MultitaskGPModel, fit, load_jax_state
from projected_lmc_tpu_torch.module import keyed_state

N, T, Q, RANK, S = 40, 4, 2, 16, 4
MLL_KW = dict(iterative=True, max_cg_iters=200, cg_tol=1e-12,
              precond_rank=RANK, num_probes=S)
MODEL_KW = dict(n_tasks=T, n_latents=Q, model_type="LMC",
                kernel_type="matern", fix_diagonal=True, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny torch ops in long loops: one intra-op thread
    avoids oversubscribing the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def data(seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (N, 3)), rng.standard_normal((N, T))


def jax_probes():
    """The eps and xi that the JAX model draws from PRNGKey(0)
    (models/multitask.py: split, then normal draws)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    eps = jax.random.normal(k1, (S, N, T), jnp.float64)
    xi = jax.random.normal(k2, (S, Q, RANK), jnp.float64)
    return torch.tensor(np.asarray(eps)), torch.tensor(np.asarray(xi))


def carried_models(mean_type="zero", perturb=True):
    X, Y = data()
    jm = JaxModel(X, Y, mean_type=mean_type, **MODEL_KW)
    if perturb:       # move off the defaults so every leaf matters
        rng = np.random.default_rng(2)
        jm = jm.replace(covar_module=jm.covar_module.replace(
            raw_lengthscale=jm.covar_module.raw_lengthscale
            + rng.uniform(-0.4, 0.4, (Q, 1, 3))))
    tm = MultitaskGPModel(X, Y, mean_type=mean_type, device="cpu",
                          **MODEL_KW)
    load_jax_state(tm, {k: np.asarray(v) for k, v in _keyed_leaves(jm)})
    return jm, tm


@pytest.mark.parametrize("mean_type", ["zero", "constant"])
def test_key_paths_and_trainable_set_match_jax(mean_type):
    from projected_lmc_tpu.module import trainable_mask
    X, Y = data()
    jm = JaxModel(X, Y, mean_type=mean_type, **MODEL_KW)
    tm = MultitaskGPModel(X, Y, mean_type=mean_type, device="cpu",
                          **MODEL_KW)
    jkeys = [k for k, _ in _keyed_leaves(jm)]
    tstate = keyed_state(tm)
    assert sorted(jkeys) == sorted(tstate)
    for (k, leaf), trainable in zip(_keyed_leaves(jm), trainable_mask(jm)):
        if np.size(leaf) == 0:
            continue          # ZeroMean's empty placeholder
        assert tstate[k].requires_grad == trainable, k
        assert tuple(tstate[k].shape) == np.shape(leaf), k


def test_mll_value_and_gradients_match_jax():
    jm, tm = carried_models()
    eps, xi = jax_probes()
    key = jax.random.PRNGKey(0)

    def jloss(raw_ls, factor, raw_noise, raw_tn):
        m = jm.replace(
            covar_module=jm.covar_module.replace(raw_lengthscale=raw_ls),
            covar_factor=factor,
            likelihood=jm.likelihood.replace(raw_noise=raw_noise,
                                             raw_task_noises=raw_tn))
        return m.mll(key=key, **MLL_KW)
    args = (jm.covar_module.raw_lengthscale, jm.covar_factor,
            jm.likelihood.raw_noise, jm.likelihood.raw_task_noises)
    vj, gj = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(*args)
    vt = tm.mll(eps=eps, xi=xi, **MLL_KW)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-10)
    tgrads = (tm.covar_module.raw_lengthscale.grad, tm.covar_factor.grad,
              tm.likelihood.raw_noise.grad, tm.likelihood.raw_task_noises.grad)
    for a, b, name in zip(tgrads, gj, ["raw_lengthscale", "covar_factor",
                                       "raw_noise", "raw_task_noises"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                   atol=1e-10, err_msg=name)
    assert tm.raw_var.grad is None          # frozen by fix_diagonal


def test_three_fit_steps_match_jax():
    """``training.fit`` (AdamW, weight decay 1e-2, LambdaLR): the JAX loop's
    one-argument loss draws from PRNGKey(0) every step; the port gets those
    eps and xi. Same loss at each of three steps."""
    jm, tm = carried_models(mean_type="constant")
    eps, xi = jax_probes()
    _, jinfo = jax_fit(jm, lambda m: m.mll(**MLL_KW), n_iter=3, lr=0.05,
                       patience=100)
    _, tinfo = fit(tm, lambda m: m.mll(eps=eps, xi=xi, **MLL_KW), n_iter=3,
                   lr=0.05, patience=100, device="cpu")
    assert len(tinfo["losses"]) == 3
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-9)


def test_generator_draws_and_stale_roots():
    """Without eps/xi the model draws them from a torch.Generator: the same
    seed gives the same value; caller-supplied roots are used as given."""
    _, tm = carried_models()
    kw = dict(MLL_KW, max_cg_iters=16, cg_tol=2e-2)
    with torch.no_grad():
        a, b, c = (float(tm.mll(generator=torch.Generator().manual_seed(g),
                                **kw)) for g in (3, 3, 4))
        roots = tm._precond_roots(tm.train_x, RANK)
        d = float(tm.mll(generator=torch.Generator().manual_seed(3),
                         precond_roots=roots, **kw))
    assert a == b and a != c
    np.testing.assert_allclose(d, a, rtol=1e-12)


def test_load_jax_state_is_loud_on_mismatch():
    jm, tm = carried_models()
    arrays = {k: np.asarray(v) for k, v in _keyed_leaves(jm)}
    missing = dict(arrays)
    missing.pop(".covar_factor")
    with pytest.raises(ValueError, match="missing"):
        load_jax_state(tm, missing)
    with pytest.raises(ValueError, match="unknown"):
        load_jax_state(tm, dict(arrays, **{".extra": np.zeros(1)}))
    bad = dict(arrays)
    bad[".covar_factor"] = np.zeros((Q + 1, T, 1))
    with pytest.raises(ValueError, match="shape"):
        load_jax_state(tm, bad)


def test_model_without_device_raises_without_cuda(monkeypatch):
    """The default device is CUDA; without a card the constructor raises
    instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = data()
    with pytest.raises(RuntimeError, match="cuda"):
        MultitaskGPModel(X, Y, **MODEL_KW)


def test_unported_routes_raise():
    """The routes that raised until their slice was ported now run and
    match JAX: the ICM's SGPR route (slice 5), and the unpreconditioned
    CG + SLQ route (``precond_rank=0``), value and gradients on JAX's
    Rademacher probes with CG run to 1e-12."""
    X, Y = data()
    kw = dict(n_tasks=T, model_type="ICM", n_inducing_points=8)
    jm = JaxModel(X, Y, **kw)
    icm = MultitaskGPModel(X, Y, device="cpu", **kw)
    load_jax_state(icm, {k: np.asarray(v) for k, v in _keyed_leaves(jm)})
    np.testing.assert_allclose(float(icm.mll().detach()),
                               float(jax.jit(lambda m: m.mll())(jm)),
                               rtol=1e-10)
    jm, tm = carried_models()
    kw = dict(iterative=True, precond_rank=0, max_cg_iters=200, cg_tol=1e-12,
              num_probes=S)
    from projected_lmc_tpu.ops.iterative import draw_probes
    probes = torch.tensor(np.asarray(draw_probes(jax.random.PRNGKey(0), N, T,
                                                 S, jnp.float64)))
    vj, gj = jax.jit(jax.value_and_grad(lambda m: m.mll(**kw)))(jm)
    vt = tm.mll(probes=probes, **kw)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-9)
    jg = dict(_keyed_leaves(gj))
    for name, p in tm.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(),
                                       np.asarray(jg["." + name]), rtol=1e-7,
                                       atol=1e-9, err_msg=name)
