"""The port's seed-parallel training (``training.fit_ensemble``) against the
JAX package's and against the port's own sequential ``fit``, on the CPU.

B projected models of one configuration, each from its own seed, carry
JAX's leaves (float64). Against JAX's ``fit_ensemble`` (one vmapped
program): the (iters, B) losses 1e-8 relative, each seed's plateau step
and the batch's stop exactly, the final leaves 1e-5 of their largest entry,
for both plateau criteria. Against the sequential ``fit`` of each model:
the losses and leaves bit for bit (the graphs are disjoint, and AdamW's
update is elementwise).
"""

import numpy as np
import pytest
import torch

from projected_lmc_tpu.mlls import projected_lmc_mll as jax_mll
from projected_lmc_tpu.models.projected import ProjectedGPModel as JaxModel
from projected_lmc_tpu.training import fit_ensemble as jax_fit_ensemble
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import (ProjectedGPModel, fit, load_jax_state,
                                     projected_lmc_mll)
from projected_lmc_tpu_torch.experiments import driver as td
from projected_lmc_tpu_torch.module import keyed_state
from projected_lmc_tpu_torch.training import fit_ensemble

N, P, Q, B = 30, 4, 2, 3
LR = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny torch ops: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_data(seed):
    """tests/test_ensemble.py's data, per seed, in float64."""
    r = np.random.default_rng(seed)
    X = np.linspace(-1, 1, N)[:, None]
    F = np.stack([np.sin(3 * X[:, 0]), np.cos(2 * X[:, 0])], 1)
    Y = F @ r.standard_normal((Q, P)) + 0.05 * r.standard_normal((N, P))
    return X, Y


def pair(seed, **kw):
    """A JAX model and the port's, built from one seed, the port carrying
    JAX's leaves."""
    X, Y = make_data(seed)
    args = dict(init_lmc_coeffs=True, kernel_type="matern", seed=seed, **kw)
    jm = JaxModel(X, Y, P, Q, **args)
    tm = ProjectedGPModel(X, Y, P, Q, device="cpu", **args)
    load_jax_state(tm, {k: np.asarray(v) for k, v in _keyed_leaves(jm)})
    return jm, tm


def const(i):
    return LR


def close(got, want, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(initial=0.0),
                               err_msg=what)


# seeds plateau at different steps under these thresholds: the per-seed
# n_iter and the batch stop are exercised, not only the n_iter cap
PLATEAU = {"max": dict(loss_thresh=0.045, patience=3, n_iter=60),
           "mean": dict(loss_thresh=0.035, patience=6, n_iter=60)}


@pytest.mark.parametrize("criterion", sorted(PLATEAU))
def test_fit_ensemble_matches_jax(criterion):
    """Losses (iters, B), per-seed n_iter, the batch stop, the last losses
    and the trained leaves, against JAX's ``fit_ensemble`` (chunks of 5
    steps, a constant learning rate)."""
    pairs = [pair(s) for s in range(B)]
    kw = dict(PLATEAU[criterion], lr=LR, schedule=const, scan_steps=5,
              criterion=criterion)
    jtr, jinfo = jax_fit_ensemble([j for j, _ in pairs], jax_mll, **kw)
    ttr, tinfo = fit_ensemble([t for _, t in pairs], projected_lmc_mll,
                              device="cpu", **kw)
    assert tinfo["losses"].shape == jinfo["losses"].shape
    assert tinfo["losses"].shape[1] == B
    close(tinfo["losses"], jinfo["losses"], 1e-8)
    np.testing.assert_array_equal(tinfo["n_iter"], jinfo["n_iter"])
    # the seeds plateau apart, and the batch stops before the cap
    assert len(set(tinfo["n_iter"].tolist())) > 1
    assert tinfo["losses"].shape[0] < kw["n_iter"]
    close(tinfo["loss"], jinfo["loss"], 1e-8)
    # the leaves to 1e-5 of their largest entry: Adam's normalized step
    # makes a full-size step of a gradient entry near 0, so an entry whose
    # gradient sits near 0 (B̃'s off-diagonal) differs by up to ~1e-6
    for jm, tm in zip(jtr, ttr):
        ts = keyed_state(tm)
        for k, v in _keyed_leaves(jm):
            close(ts[k], v, 1e-5, k)


def test_fit_ensemble_equals_sequential_fit():
    """Each seed's losses and trained leaves equal its own ``fit`` (same
    chunks, same schedule) bit for bit."""
    models = [pair(s)[1] for s in range(B)]
    seq = [pair(s)[1] for s in range(B)]
    _, info = fit_ensemble(models, projected_lmc_mll, n_iter=12, lr=LR,
                           scan_steps=4, device="cpu")
    for b, m in enumerate(seq):
        _, ib = fit(m, projected_lmc_mll, n_iter=12, lr=LR, scan_steps=4,
                    device="cpu")
        np.testing.assert_array_equal(info["losses"][:, b], ib["losses"])
        for k, v in keyed_state(m).items():
            np.testing.assert_array_equal(
                keyed_state(models[b])[k].detach().numpy(),
                v.detach().numpy(), err_msg=k)


def test_generators_are_per_seed():
    """A loss that takes a generator gets one a model, model b's seeded
    with seed + b: what the sequential ``fit(seed=seed + b)`` draws."""
    seen = {}

    def loss(m, generator):
        seen.setdefault(id(m), []).append(
            float(torch.randn((), generator=generator, dtype=torch.float64)))
        return projected_lmc_mll(m)
    models = [pair(s)[1] for s in range(2)]
    fit_ensemble(models, loss, n_iter=3, lr=LR, seed=7, scan_steps=1,
                 device="cpu")
    for b, m in enumerate(models):
        g = torch.Generator().manual_seed(7 + b)
        want = [float(torch.randn((), generator=g, dtype=torch.float64))
                for _ in range(3)]
        assert seen[id(m)] == want


def test_batch_stop_when_every_seed_plateaus():
    """At a learning rate near 0 every seed plateaus at once: the batch
    stops in its first chunk, its losses recorded up to the stopping step,
    as JAX's."""
    models = [pair(s)[1] for s in range(2)]
    _, info = fit_ensemble(models, projected_lmc_mll, n_iter=40, lr=1e-9,
                           scan_steps=10, loss_thresh=1e-2, patience=3,
                           device="cpu")
    assert info["losses"].shape == (5, 2)
    np.testing.assert_array_equal(info["n_iter"], [4, 4])


def test_driver_seeds_batch_and_mismatch_raises():
    """``build_models`` with different seeds gives one architecture; a
    model of another configuration (the BDN/diagonal/scalar flags) or of
    other leaf shapes raises naming the architecture."""
    X, Y = make_data(0)
    seeded = [td.build_models(X, Y, Q, P, ["PLMC"], seed=s,
                              device="cpu")["PLMC"] for s in (0, 1)]
    fit_ensemble(seeded, projected_lmc_mll, n_iter=2, lr=LR, scan_steps=1,
                 device="cpu")
    a = pair(0)[1]
    for other in (pair(1, scalar_B=True, diagonal_B=True, BDN=True,
                       diagonal_R=True)[1],
                  ProjectedGPModel(*make_data(1), P, Q + 1, device="cpu",
                                   kernel_type="matern")):
        with pytest.raises(ValueError, match="architecture"):
            fit_ensemble([a, other], projected_lmc_mll, n_iter=2,
                         device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        fit_ensemble([], projected_lmc_mll, device="cpu")


def test_force_xla_kernels_changes_nothing():
    """``force_xla_kernels`` is accepted for the JAX signature and does
    nothing: the same losses either way."""
    runs = []
    for flag in (True, False):
        models = [pair(s)[1] for s in range(2)]
        _, info = fit_ensemble(models, projected_lmc_mll, n_iter=4, lr=LR,
                               scan_steps=2, force_xla_kernels=flag,
                               device="cpu")
        runs.append(info["losses"])
    np.testing.assert_array_equal(runs[0], runs[1])
