"""The port's training extras and checkpoints, and the blocked Cholesky,
against the JAX package on the CPU (float64).

``training``: ``exponential_schedule``, ``default_scan_steps``, and
``fit``'s chunks (the losses read once a chunk, the stop on the chunk's
end), checkpoints and evals at ``scan_steps`` 1 and 4, each step by step
against JAX's loop on the same model and losses. ``utils.checkpoint``:
``save_model``/``load_model``, a JAX checkpoint into the port and a port
checkpoint into JAX's ``load_model``, for each model family.
``ops.blocked_cholesky``: the fp32-update factor to 1e-10 of LAPACK's in
float64; the bf16-update factor within JAX's stated noise (the
reconstruction within 4e-3 of the off-diagonal energy) and within 1e-2 of
JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import projected_lmc_tpu.utils.checkpoint as jckpt
import projected_lmc_tpu_torch.utils.checkpoint as tckpt
from projected_lmc_tpu.likelihoods import GaussianLikelihood as JaxLik
from projected_lmc_tpu.models.exact import ExactGPModel as JaxExact
from projected_lmc_tpu.models.multitask import MultitaskGPModel as JaxMT
from projected_lmc_tpu.models.projected import ProjectedGPModel as JaxProj
from projected_lmc_tpu.models.variational import \
    VariationalMultitaskGPModel as JaxVar
from projected_lmc_tpu.ops import blocked_cholesky as jblk
from projected_lmc_tpu.training import exponential_schedule as jax_exp
from projected_lmc_tpu.training import fit as jax_fit
from projected_lmc_tpu_torch import (ExactGPModel, GaussianLikelihood,
                                     MultitaskGPModel, ProjectedGPModel,
                                     VariationalMultitaskGPModel,
                                     default_scan_steps, exponential_schedule,
                                     fit, load_jax_state, load_model,
                                     save_model)
from projected_lmc_tpu_torch.module import keyed_state
from projected_lmc_tpu_torch.ops import blocked_cholesky as tblk

N, T, D = 24, 2, 3


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
                               atol=rtol * np.abs(want).max(initial=0.0),
                               err_msg=what)


def data(seed=1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (N, D))
    Y = np.stack([np.sin(3 * X[:, 0]), X[:, 1] * X[:, 2]], 1) \
        + 0.1 * rng.standard_normal((N, T))
    return X, Y


def jax_state(jm):
    return {k: np.asarray(v) for k, v in jckpt._keyed_leaves(jm)}


# -- schedules -------------------------------------------------------------------

def test_schedules_match_jax():
    """γ = (lr_min/lr)^(1/n_iter); the rate at each step equals JAX's (both
    in float32); the default chunk is 1 step on the CPU, 16 on the card."""
    js, ts = jax_exp(1e-2, 1e-4, 50), exponential_schedule(1e-2, 1e-4, 50)
    for i in (0, 1, 7, 49, 50, 80):
        np.testing.assert_allclose(ts(i), float(js(i)), rtol=1e-6)
    np.testing.assert_allclose(ts(50), 1e-4, rtol=1e-5)
    assert default_scan_steps("cpu") == 1
    assert default_scan_steps(torch.device("cpu")) == 1
    assert default_scan_steps("cuda") == 16


# -- fit's chunks, checkpoints and evals -----------------------------------------

def exact_pair(**kw):
    X, Y = data()
    kw = dict(n_tasks=T, kernel_type="matern", decomp=[[0, 1], [2]],
              mean_type="linear", **kw)
    jm = JaxExact(X, Y, JaxLik(batch_shape=T, dtype=jnp.float64), **kw)
    tm = ExactGPModel(X, Y, GaussianLikelihood(
        batch_shape=T, dtype=torch.float64, device="cpu"), device="cpu", **kw)
    load_jax_state(tm, jax_state(jm))
    return jm, tm


@pytest.mark.parametrize("scan_steps,n_iter,thresh", [
    (1, 9, 2e-2), (4, 10, 2e-2), (4, 10, 0.0)])
def test_fit_chunks_checkpoints_and_evals_match_jax(scan_steps, n_iter, thresh,
                                                    monkeypatch, tmp_path):
    """The same losses (rtol 1e-9), the same stopping step (a plateau of
    patience 2 at |Δ| < 2e-2, or none), the checkpoints taken at the same
    steps (each saved model's leaves), the evals' (step, value) pairs, and
    the final checkpoint of the port loading into JAX's trained model. The
    learning rate is constant: the default schedule is float32 on both
    sides, and XLA's jitted float32 arithmetic differs from numpy's by an
    ulp at some steps."""
    jm, tm = exact_pair()
    saved = {"jax": [], "torch": []}
    monkeypatch.setattr(jckpt, "save_model", lambda m, p: saved["jax"].append(
        jax_state(m)))
    monkeypatch.setattr(tckpt, "save_model", lambda m, p: saved[
        "torch"].append({k: v.detach().numpy().copy()
                         for k, v in keyed_state(m).items()}))
    kw = dict(n_iter=n_iter, schedule=lambda i: 3e-2, loss_thresh=thresh,
              patience=2, scan_steps=scan_steps, checkpoint_every=2,
              checkpoint_path=str(tmp_path / "ck.npz"), eval_every=3)
    jm, jinfo = jax_fit(jm, eval_fn=lambda m, i: float(m.mll()), **kw)
    tm, tinfo = fit(tm, eval_fn=lambda m, i: float(m.mll().detach()),
                    device="cpu", **kw)
    assert tinfo["n_iter"] == jinfo["n_iter"]
    if thresh:
        assert tinfo["n_iter"] < n_iter - 1      # the plateau stopped it
    close(tinfo["losses"], jinfo["losses"], rtol=1e-9)
    assert [i for i, _ in tinfo["evals"]] == [i for i, _ in jinfo["evals"]]
    close(np.array([v for _, v in tinfo["evals"]]),
          np.array([v for _, v in jinfo["evals"]]), rtol=1e-9)
    assert len(saved["torch"]) == len(saved["jax"]) >= 2
    for got, want in zip(saved["torch"], saved["jax"]):
        for k, v in want.items():
            if np.size(v):
                close(got[k], v, rtol=1e-8, what=k)
    monkeypatch.undo()
    save_model(tm, str(tmp_path / "final.npz"))
    back = jckpt.load_model(jm, str(tmp_path / "final.npz"))
    for k, v in jax_state(jm).items():
        if np.size(v):
            close(jax_state(back)[k], v, rtol=1e-8, what=k)


# -- checkpoints both ways --------------------------------------------------------

def _families():
    X, Y = data()
    lik = dict(jax=lambda: JaxLik(batch_shape=T, dtype=jnp.float64),
               torch=lambda: GaussianLikelihood(batch_shape=T,
                                                dtype=torch.float64,
                                                device="cpu"))
    sm = dict(kernel_type="spectral_mixture", ker_kwargs=dict(num_mixtures=2))
    add = dict(kernel_type="matern", decomp=[[0], [1, 2]])
    return {
        "exact-additive": lambda side, cls: cls(
            X, Y, lik[side](), n_tasks=T, mean_type="linear", **add),
        "lmc-spectral_mixture": lambda side, cls: cls(
            X, Y, n_tasks=T, n_latents=2, model_type="LMC", **sm),
        "icm-spline": lambda side, cls: cls(
            X, Y, n_tasks=T, model_type="ICM", kernel_type="spline",
            mean_type="polynomial"),
        "projected-additive": lambda side, cls: cls(X, Y, T, 1, **add),
        "variational-spectral_mixture": lambda side, cls: cls(
            X, n_latents=2, n_tasks=T, train_y=Y, **sm),
    }


CLASSES = {"exact": (JaxExact, ExactGPModel),
           "lmc": (JaxMT, MultitaskGPModel), "icm": (JaxMT, MultitaskGPModel),
           "projected": (JaxProj, ProjectedGPModel),
           "variational": (JaxVar, VariationalMultitaskGPModel)}


@pytest.mark.parametrize("family", sorted(_families()))
def test_checkpoints_load_both_ways(family, tmp_path):
    """A checkpoint of JAX's ``save_model`` loads with the port's
    ``load_model`` (every leaf equal), and the port's ``save_model`` of the
    moved model loads with JAX's ``load_model`` (every leaf equal)."""
    make = _families()[family]
    jcls, tcls = CLASSES[family.split("-")[0]]
    jm = make("jax", jcls)
    tm = make("torch", lambda *a, **k: tcls(*a, device="cpu", **k))
    arrays = jax_state(jm)
    rng = np.random.default_rng(3)
    arrays = {k: v + rng.uniform(-0.1, 0.1, v.shape) if v.dtype.kind == "f"
              else v for k, v in arrays.items()}
    jm = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jm),
        [jnp.asarray(arrays[k]) for k, _ in jckpt._keyed_leaves(jm)])
    jckpt.save_model(jm, str(tmp_path / "jax.npz"))
    assert load_model(tm, str(tmp_path / "jax.npz")) is tm
    state = keyed_state(tm)
    assert sorted(state) == sorted(arrays)
    for k, v in arrays.items():
        close(state[k], v, rtol=0, what=k)
    with torch.no_grad():
        for t in state.values():
            if t.is_floating_point():
                t.mul_(1.5)
    save_model(tm, str(tmp_path / "port"))
    back = jax_state(jckpt.load_model(jm, str(tmp_path / "port.npz")))
    for k, t in keyed_state(tm).items():
        close(t, back[k], rtol=0, what=k)


def test_load_model_is_loud_on_a_mismatch(tmp_path):
    _, tm = exact_pair()
    save_model(tm, str(tmp_path / "a.npz"))
    other = ExactGPModel(*data(), GaussianLikelihood(
        batch_shape=T, dtype=torch.float64, device="cpu"), n_tasks=T,
        device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        load_model(other, str(tmp_path / "a.npz"))


# -- the blocked Cholesky --------------------------------------------------------

def spd(n=300, seed=0):
    """Two Matérn-2.5 matrices with ridges (condition ~1.6e3 and ~8e2)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2))

    def matern(ls):
        d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1)) / ls
        return (1 + np.sqrt(5) * d + 5 * d ** 2 / 3) * np.exp(-np.sqrt(5) * d)
    return np.stack([matern(0.5) + 0.05 * np.eye(n),
                     matern(1.0) + 0.2 * np.eye(n)])


def test_blocked_f32_factor_is_lapacks():
    A = spd()
    L = tblk.cholesky_blocked_f32(t64(A), 64)
    close(L, np.linalg.cholesky(A), rtol=1e-10)
    close(L, jblk.cholesky_blocked_f32(jnp.asarray(A), 64), rtol=1e-10)
    small = A[:, :40, :40]
    close(tblk.cholesky_blocked_f32(t64(small), 64), np.linalg.cholesky(small))


def test_bf16_blocked_factor_within_its_noise_and_jaxs():
    """The factor of A + E, ‖E‖ within 4e-3 of A's off-diagonal energy (JAX's
    stated noise level, ``blocked_cholesky.py``), on both packages, and the
    two factors within 1e-2 of each other (their fp32 accumulations of the
    bf16 products differ in order)."""
    A = spd()
    off = np.linalg.norm(A - np.stack([np.diag(np.diag(a)) for a in A]))
    Lt = tblk.cholesky_bf16_blocked(t64(A), 64).numpy()
    Lj = np.asarray(jblk.cholesky_bf16_blocked(jnp.asarray(A), 64))
    for L in (Lt, Lj):
        assert np.linalg.norm(L @ np.swapaxes(L, -1, -2) - A) < 4e-3 * off
    assert np.linalg.norm(Lt - Lj) < 1e-2 * np.linalg.norm(Lj)
    assert np.isfinite(Lt).all() and np.allclose(np.triu(Lt, 1), 0)
