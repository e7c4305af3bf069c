"""The exact LMC's spans and counters on the fused PCG route, on the CPU: a
profiled ``fit`` records ``mll.pcg`` under ``fit.forward``, each
``mll.stack_product`` under it or under ``fit.backward``, and
``mll.ls_reduce`` under ``fit.backward``, with the CG's ``cg.solves``,
``cg.iters`` and ``cg.frozen`` counts; without a profiler nothing is
recorded; and the CG counters add no host read."""

import numpy as np
import pytest
import torch

import projected_lmc_tpu_torch as pl
from projected_lmc_tpu_torch.ops import iterative as it
from projected_lmc_tpu_torch.utils import profiling as tprof

S, ITERS, STEPS = 3, 6, 4           # probes, CG steps, fit steps


@pytest.fixture(autouse=True)
def _empty_store():
    tprof.clear()
    yield
    tprof.clear()


def _model(n=60, t=3, q=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 2)).astype("float32")
    Y = rng.standard_normal((n, t)).astype("float32")
    lik = pl.MultitaskGaussianLikelihood(num_tasks=t, rank=0, device="cpu")
    return pl.MultitaskGPModel(X, Y, lik, n_tasks=t, n_latents=q,
                               model_type="LMC", kernel_type="matern",
                               device="cpu")


def _loss(model, generator):
    return model.mll(iterative=True, max_cg_iters=ITERS, cg_tol=1e-9,
                     matvec_bf16=True, precond_rank=8, num_probes=S,
                     generator=generator)


def _fit(model):
    pl.fit(model, _loss, n_iter=STEPS, scan_steps=2, loss_thresh=0.0,
           device="cpu")


def _profiled_fit():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _fit(_model())
    return tprof.spans()


def test_the_spans_nest_under_the_step():
    spans = _profiled_fit()
    by_id = {r["id"]: r for r in spans}
    names = [r["name"] for r in spans]
    parent = lambda r: by_id[r["parent"]]["name"]          # noqa: E731
    pcg = [r for r in spans if r["name"] == "mll.pcg"]
    products = [r for r in spans if r["name"] == "mll.stack_product"]
    reduces = [r for r in spans if r["name"] == "mll.ls_reduce"]
    assert len(pcg) == STEPS and {parent(r) for r in pcg} == {"fit.forward"}
    assert len(reduces) == STEPS
    assert {parent(r) for r in reduces} == {"fit.backward"}
    # one product a CG step, one in each backward
    assert sorted(parent(r) for r in products) == sorted(
        ["mll.pcg"] * ITERS * STEPS + ["fit.backward"] * STEPS)
    assert names.count("fit.step") == STEPS
    # a step's spans carry its trace id
    for r in pcg + reduces:
        assert r["trace_id"] in range(STEPS)


def test_the_cg_counts_per_step():
    _profiled_fit()
    counts = tprof.summary("fit.forward")["counts"]
    assert counts["cg.solves"] == STEPS * (1 + S)
    assert 0 < counts["cg.iters"] <= STEPS * (1 + S) * ITERS
    assert counts["cg.frozen"] == 0
    assert tprof.summary()["counts"]["cg.iters"] == counts["cg.iters"]


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(it, "count", lambda *a, **k: calls.append(a))
    _fit(_model())
    assert calls == []
    assert tprof.spans() == [] and tprof.summary()["counts"] == {}


def test_the_cg_counters_add_no_host_read(monkeypatch):
    """The profiled fit's ``host_read`` counts with the CG counters on and
    with them off are the same: one a chunk's loss read (and the roots'
    ladder, once a step)."""
    _profiled_fit()
    with_counters = tprof.summary()["counts"]
    tprof.clear()
    monkeypatch.setattr(it, "recording", lambda: False)
    _profiled_fit()
    without = tprof.summary()["counts"]
    assert "cg.iters" not in without
    assert with_counters["host_read"] == without["host_read"] > 0
