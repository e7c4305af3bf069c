"""The PCG's breakdown guard (``ops.iterative.pcg_with_tridiag``) and the
quadrature's mask (``_tridiag_logquad``), on the CPU.

A matvec with planted faults (one right-hand side's product turns NaN,
another's curvature zero): the NaN column is frozen at its last iterate and
is the only one frozen, the zero-curvature column restarts as before, every
other column keeps every bit of the clean run, the quadrature's eigh sees
only finite entries, and the counters count it. A step α ≤ 1e-30 or a
non-finite entry handed to the quadrature is left out with the rest of its
column. Through the fused MLL, a NaN stack product in one CG step leaves
the value and the gradients finite.
"""

import numpy as np
import pytest
import torch

import projected_lmc_tpu_torch as pl
from projected_lmc_tpu_torch.ops import iterative as it
from projected_lmc_tpu_torch.utils import profiling as tprof

R, N, T, K = 6, 40, 3, 10          # right-hand sides, points, tasks, steps
NAN_COL, NAN_CALL = 2, 4           # column j's product NaN from call 4 on
ZERO_COL, ZERO_CALL = 4, 3         # column j's curvature zero at call 3


@pytest.fixture(autouse=True)
def _empty_store():
    tprof.clear()
    yield
    tprof.clear()


def _problem(seed=0):
    f32 = dict(generator=torch.Generator().manual_seed(seed),
               dtype=torch.float32)
    M = torch.randn((N * T, N * T), **f32)
    A = M @ M.T / (N * T) + 0.5 * torch.eye(N * T, dtype=torch.float32)
    d = 0.5 + torch.rand((N, T), **f32)
    B = torch.randn((R, N, T), **f32)
    return A, d, B


def _matvec(A, faults=True):
    calls = [0]

    def mv(V):
        out = (V.reshape(V.shape[0], -1) @ A).reshape(V.shape)
        if faults and calls[0] >= NAN_CALL:
            out[NAN_COL] = float("nan")
        if faults and calls[0] == ZERO_CALL:
            out[ZERO_COL] = 0.0
        calls[0] += 1
        return out
    return mv


def _run(faults=True, iters=K, tol=1e-9):
    A, d, B = _problem()
    return it._pcg_loop(_matvec(A, faults), B, lambda V: V / d, iters, tol)


def _others():
    return [c for c in range(R) if c not in (NAN_COL, ZERO_COL)]


def test_a_nan_product_freezes_exactly_its_column():
    X, alphas, betas, active, rz0, frozen = _run()
    assert frozen.tolist() == [c == NAN_COL for c in range(R)]
    assert torch.isfinite(X).all() and torch.isfinite(alphas).all() \
        and torch.isfinite(betas).all()
    # frozen at its last iterate: the clean run stopped at that call
    clean = _run(faults=False, iters=NAN_CALL)
    assert torch.equal(X[NAN_COL], clean[0][NAN_COL])
    assert not active[NAN_CALL:, NAN_COL].any()
    assert active[:NAN_CALL, NAN_COL].all()
    assert (alphas[NAN_CALL:, NAN_COL] == 1).all()
    assert (betas[NAN_CALL:, NAN_COL] == 0).all()


def test_zero_curvature_restarts_and_is_not_frozen():
    X, alphas, _, active, _, frozen = _run()
    assert not frozen[ZERO_COL]
    assert not active[ZERO_CALL, ZERO_COL]
    assert active[ZERO_CALL + 1:, ZERO_COL].any()     # it goes on after it
    assert alphas[ZERO_CALL, ZERO_COL] == 1


def test_the_other_columns_keep_every_bit():
    got, clean = _run(), _run(faults=False)
    cols = _others()
    for a, b in zip(got[:5], clean[:5]):
        assert torch.equal(a[..., cols] if a.dim() == 2 else a[cols],
                           b[..., cols] if b.dim() == 2 else b[cols])


def test_the_quadrature_sees_only_finite_entries(monkeypatch):
    seen = []
    eigh = torch.linalg.eigh

    def watched(T):
        seen.append(bool(torch.isfinite(T).all()))
        return eigh(T)
    monkeypatch.setattr(torch.linalg, "eigh", watched)
    _, alphas, betas, active, _, _ = _run()
    quad = it._tridiag_logquad(alphas, betas, active)
    clean = _run(faults=False)
    want = it._tridiag_logquad(clean[1], clean[2], clean[3])
    assert seen == [True, True]
    assert torch.isfinite(quad).all()
    cols = _others()
    torch.testing.assert_close(quad[cols], want[cols], rtol=1e-6, atol=0)


@pytest.mark.parametrize("fault", ["tiny_alpha", "nan_alpha", "nan_beta"])
def test_the_quadrature_leaves_out_a_bad_step_and_the_rest(fault):
    """Coefficients of a clean run with one step spoiled, handed to the
    quadrature as active: the column reads as if its run had stopped
    before the spoiled step (β_{k−1} spoils step k's diagonal entry)."""
    _, alphas, betas, active, _, _ = _run(faults=False)
    c, k = 1, 5
    a, b = alphas.clone(), betas.clone()
    if fault == "tiny_alpha":
        a[k, c] = 1e-31
    elif fault == "nan_alpha":
        a[k, c] = float("nan")
    else:
        b[k - 1, c] = float("inf")
    got = it._tridiag_logquad(a, b, active)
    cut = active.clone()
    cut[k:, c] = False
    want = it._tridiag_logquad(alphas, betas, cut)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_the_counters_count_it_on_the_device_tensor():
    A, d, B = _problem()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, _, _, active, _ = it.pcg_with_tridiag(
            _matvec(A), B, lambda V: V / d, K, 1e-9)
        # held as a tensor until the store is read
        rec = next(r for r in tprof._STORE.records if r["name"] == "mll.pcg")
        assert isinstance(rec["counts"]["cg.iters"], torch.Tensor)
    counts = tprof.summary("mll.pcg")["counts"]
    assert counts["cg.solves"] == R
    assert counts["cg.frozen"] == 1
    assert counts["cg.iters"] == int(active.sum())
    assert isinstance(counts["cg.iters"], int)


def test_no_count_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(it, "count", lambda *a, **k: calls.append(a))
    A, d, B = _problem()
    it.pcg_with_tridiag(_matvec(A), B, lambda V: V / d, K, 1e-9)
    assert calls == [] and tprof.spans() == []


def _lmc_model(n=64, t=3, q=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 2)).astype("float32")
    Y = rng.standard_normal((n, t)).astype("float32")
    lik = pl.MultitaskGaussianLikelihood(num_tasks=t, rank=0, device="cpu")
    return pl.MultitaskGPModel(X, Y, lik, n_tasks=t, n_latents=q,
                               model_type="LMC", kernel_type="matern",
                               device="cpu")


def test_a_nan_stack_product_leaves_the_mll_and_its_gradient_finite(
        monkeypatch):
    """One CG step's product NaN in one probe's column (at n = 64, where
    the unguarded loop hands a NaN to the quadrature): the fused MLL and
    its backward stay finite, and the probe's column is frozen."""
    real = it._stack_matmul
    calls = [0]

    def spoiled(Ks, W):
        out = real(Ks, W)
        calls[0] += 1
        if calls[0] == 4 and W.dim() == 3:
            out = out.clone()
            out[3] = float("nan")
        return out
    monkeypatch.setattr(it, "_stack_matmul", spoiled)
    model = _lmc_model()
    g = torch.Generator().manual_seed(1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        mll = model.mll(iterative=True, max_cg_iters=12, cg_tol=1e-6,
                        matvec_bf16=True, precond_rank=16, num_probes=4,
                        generator=g)
        (-mll).backward()
    assert torch.isfinite(mll)
    for name, p in model.named_parameters():
        if p.grad is not None:
            assert torch.isfinite(p.grad).all(), name
    assert tprof.summary()["counts"]["cg.frozen"] == 1
