"""The per-layer metrics read from the program's own spans and counters
(``projected_lmc_tpu_torch.utils.profiling``): what a small traced cell
reports on the CPU, that the benchmark's accepted files are untouched,
and, on the card, the device stretches of the Cholesky ladder and its
pullback under the profiler."""

import hashlib
import json

import pytest

from conftest import BENCH, run_small, small_cell

STRETCHES = {
    "plmc_sarcos10k.train": ("step_forward_ms.train",
                             "cholesky_factor_ms.train",
                             "cholesky_pullback_ms.train",
                             "step_backward_self_ms.train"),
    "plmc_sarcos10k.serve": ("predict_solve_ms.serve",),
}


@pytest.fixture(autouse=True)
def _empty_store():
    from projected_lmc_tpu_torch.utils import profiling
    profiling.clear()
    yield
    profiling.clear()


def test_counts_are_read_and_stretches_are_absent_on_the_cpu():
    """The counters give their ratios in a traced run on the CPU; every
    device stretch is left out of the result line, not read as 0."""
    _, res = run_small(small_cell("plmc_sarcos10k.train"), trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # one ladder read a step and one loss read a chunk of 4 steps
    assert got["host_reads_per_step.train"]["value"] == 1.25
    assert got["cholesky_tries_per_factor.train"]["value"] >= 1
    assert not set(STRETCHES["plmc_sarcos10k.train"]) & set(got)


def test_serving_counts_the_reads_inside_predict():
    _, res = run_small(small_cell("plmc_sarcos10k.serve"), trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # the 7 x 7 task noise's ladder, once a request
    assert got["host_reads_per_request.serve"]["value"] == 1
    assert not set(STRETCHES["plmc_sarcos10k.serve"]) & set(got)


def test_untraced_runs_store_nothing():
    from projected_lmc_tpu_torch.utils import profiling
    _, res = run_small(small_cell("plmc_sarcos10k.train"))
    assert res["correct"], res["checks"]
    assert profiling.spans() == []


def test_accepted_files_are_unchanged():
    """Every file the accepted benchmark holds (``accepted_files.json``)
    is there byte for byte: metrics and cells are added by new files and
    entries alone."""
    want = json.loads((BENCH / "tests" / "accepted_files.json").read_text())
    for rel, digest in want.items():
        path = BENCH / rel
        assert path.is_file(), rel
        assert hashlib.sha256(path.read_bytes()).hexdigest() == digest, rel


@pytest.mark.chip
def test_ladder_and_pullback_stretches_on_the_card(cuda):
    """On the card the autograd engine runs the backward on its own thread:
    the profiler is on there, the pullback's span hangs under the
    backward's, each span has a device stretch, and no span puts an event
    on the device timeline."""
    import threading

    import torch

    from projected_lmc_tpu_torch.ops.cholesky import safe_cholesky
    from projected_lmc_tpu_torch.utils import profiling

    g = torch.Generator(device=cuda).manual_seed(0)
    B = torch.randn((4, 2048, 2048), generator=g, device=cuda)
    A = (B @ B.transpose(-1, -2) / 2048 + torch.eye(2048, device=cuda)) \
        .requires_grad_()
    threads = set()

    def note(grad):
        threads.add(threading.get_ident())
        return grad

    A.register_hook(note)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with profiling.span("fit.forward"):
            loss = safe_cholesky(A).diagonal(dim1=-2, dim2=-1).log().sum()
        with profiling.span("fit.backward"):
            loss.backward()
        torch.cuda.synchronize()
    assert threads and threading.get_ident() not in threads
    recs = {s["name"]: s for s in profiling.spans()}
    # the spans lie on the host timeline alone: nothing of theirs reads as
    # device work to the harness's trace
    on_device = {e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA}
    assert not on_device & set(recs)
    assert {e.name() for e in prof.profiler.kineto_results.events()} \
        >= set(recs)
    assert set(recs) == {"fit.forward", "cholesky.factor", "fit.backward",
                         "cholesky.pullback"}
    assert recs["cholesky.pullback"]["parent"] == recs["fit.backward"]["id"]
    assert recs["cholesky.factor"]["parent"] == recs["fit.forward"]["id"]
    for s in recs.values():
        assert s["device_ms"] is not None and s["device_ms"] > 0, s
    s = profiling.summary("fit.backward")
    assert 0 < s["children_device_ms"]["cholesky.pullback"] <= s["device_ms"]
    assert recs["cholesky.factor"]["counts"]["cholesky.try"] == 1
