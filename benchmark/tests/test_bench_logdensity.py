"""The Gaussian log-density's closed-form gradient
(``ops.cholesky.gaussian_log_density``) as the benchmark reads it: the
share of closed-form pullbacks in a small traced cell on the CPU, and on
the card the closed form against the generic Cholesky pullback, with the
``cholesky.pullback`` stretch its backward leaves under ``fit.backward``
for ``cholesky_pullback_ms.train`` to read."""

import importlib.util
import math

import pytest

from conftest import BENCH, run_small, small_cell


@pytest.fixture(autouse=True)
def _empty_store():
    from projected_lmc_tpu_torch.utils import profiling
    profiling.clear()
    yield
    profiling.clear()


def _generic(K, delta):
    from projected_lmc_tpu_torch.ops import cholesky
    L = cholesky.safe_cholesky(K)
    z = cholesky.solve_triangular(L, delta[..., None], lower=True)[..., 0]
    return -0.5 * ((z * z).sum(-1) + cholesky.logdet_from_chol(L)
                   + K.shape[-1] * math.log(2 * math.pi))


def test_a_traced_training_cell_reads_a_share_of_one():
    """Every pullback of the projected model's step is the closed form;
    serving runs no backward and reports no share."""
    _, res = run_small(small_cell("plmc_sarcos10k.train"), trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["pullback_closed_form_share.train"] == {
        "value": 1.0, "unit": "share"}
    _, res = run_small(small_cell("plmc_sarcos10k.serve"), trace=True)
    assert res["correct"], res["checks"]
    assert "pullback_closed_form_share.train" not in res["metrics"]


@pytest.mark.chip
def test_closed_form_pullback_on_the_card(cuda):
    """At (4, 2048, 2048): value, K̄ and δ̄ within the CPU test's float32
    tolerance of the generic route's on the card, K̄ exactly symmetric; the
    closed form's pullback hangs under the backward's span with a device
    stretch, and the share reads 1."""
    import torch

    from projected_lmc_tpu_torch.ops.cholesky import gaussian_log_density
    from projected_lmc_tpu_torch.utils import profiling

    g = torch.Generator(device=cuda).manual_seed(0)
    B = torch.randn((4, 2048, 2048), generator=g, device=cuda)
    A = B @ B.transpose(-1, -2) / 2048 + torch.eye(2048, device=cuda)
    delta = torch.randn((4, 2048), generator=g, device=cuda)
    cot = torch.randn((4,), generator=g, device=cuda)

    def run(fn):
        K = A.clone().requires_grad_()
        d = delta.clone().requires_grad_()
        with profiling.span("fit.forward"):
            v = fn(K, d)
        with profiling.span("fit.backward"):
            (v * cot).sum().backward()
        return v.detach(), K.grad, d.grad

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        got = run(gaussian_log_density)
        torch.cuda.synchronize()
    recs = profiling.spans()
    by_id = {s["id"]: s for s in recs}
    (pull,) = [s for s in recs if s["name"] == "cholesky.pullback"]
    assert by_id[pull["parent"]]["name"] == "fit.backward"
    assert pull["device_ms"] is not None and pull["device_ms"] > 0
    assert pull["counts"] == {"cholesky.pullback": 1,
                              "cholesky.pullback.closed_form": 1}
    path = BENCH / "metrics" / "pullback_closed_form_share.train.py"
    spec = importlib.util.spec_from_file_location("share", path)
    share = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(share)
    assert share.read(dict(loop="train", profiled_steps=1)) == 1.0

    want = run(_generic)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        err = (a - b).abs().max() / b.abs().max()
        assert float(err) < 2e-5, float(err)
    assert torch.equal(got[1], got[1].transpose(-1, -2))
