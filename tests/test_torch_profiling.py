"""The port's spans and counters (``utils.profiling.span``/``count``): off
without a profiler, and under ``torch.profiler`` their nesting, trace ids,
counts, clock and bounded store, and what a profiled ``fit`` and
``predict`` of a small projected model record."""

import sys
import threading

import numpy as np
import pytest
import torch

import projected_lmc_tpu_torch as pl
from projected_lmc_tpu_torch.utils import profiling as tprof


@pytest.fixture(autouse=True)
def _empty_store():
    tprof.clear()
    yield
    tprof.clear()


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _small_model(n=40, p=4, q=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2)).astype("float32")
    Y = rng.normal(size=(n, p)).astype("float32")
    return pl.ProjectedGPModel(X, Y, p, q, device="cpu"), X


def test_off_without_a_profiler():
    """No profiler recording: ``span`` hands out one shared no-op context
    and nothing lands in the store."""
    assert tprof.span("a") is tprof.span("b", trace_id=3)
    with tprof.span("a"):
        tprof.count("host_read")
    assert tprof.spans() == []
    assert tprof.summary()["counts"] == {}


def test_no_profiler_range_and_no_cuda_event_off_the_profiler(monkeypatch):
    """A fit and a served prediction with no profiler recording open no
    profiler range in the port (``record_function`` or the fast record a
    span uses) and make no CUDA event (torch's own optimizer still opens
    its ranges)."""
    calls = []

    def watched(real):
        def call(*args, **kwargs):
            calls.append(sys._getframe(1).f_globals.get("__name__", ""))
            return real(*args, **kwargs)
        return call

    monkeypatch.setattr(torch.profiler, "record_function",
                        watched(torch.profiler.record_function))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        watched(torch.autograd.profiler.record_function))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        watched(torch._C._profiler._RecordFunctionFast))
    monkeypatch.setattr(torch.cuda, "Event", watched(torch.cuda.Event))
    model, X = _small_model()
    pl.fit(model, pl.projected_lmc_mll, n_iter=2, scan_steps=1,
           loss_thresh=0.0, device="cpu")
    pl.fit(model, pl.projected_lmc_mll, n_iter=4, scan_steps=2,
           loss_thresh=0.0, device="cpu")
    with torch.no_grad():
        model.predict(torch.as_tensor(X[:8]), cache=model.prediction_cache())
    assert calls, "the watch saw torch's own ranges"
    assert not [c for c in calls if c.startswith("projected_lmc_tpu_torch")]
    assert tprof.spans() == []
    # the same watch sees the port's spans while a profiler records
    with _profiler():
        pl.fit(model, pl.projected_lmc_mll, n_iter=1, scan_steps=1,
               loss_thresh=0.0, device="cpu")
    assert "projected_lmc_tpu_torch.utils.profiling" in calls


def test_spans_nest_with_parents_and_trace_ids():
    with _profiler():
        with tprof.span("req", trace_id=7):
            with tprof.span("inner"):
                with tprof.span("leaf"):
                    pass
            with tprof.span("inner"):
                pass
        with tprof.span("req"):         # a root: its ordinal among "req"s
            pass
        with tprof.span("req"):
            pass
    recs = tprof.spans()
    assert [s["name"] for s in recs] == ["req", "inner", "leaf", "inner",
                                         "req", "req"]
    root, a, leaf, b, r1, r2 = recs
    assert root["parent"] is None and root["trace_id"] == 7
    assert a["parent"] == root["id"] and b["parent"] == root["id"]
    assert leaf["parent"] == a["id"]
    assert {a["trace_id"], b["trace_id"], leaf["trace_id"]} == {7}
    assert (r1["trace_id"], r2["trace_id"]) == (0, 1)
    assert len({s["id"] for s in recs}) == 6
    assert all(s["device_ms"] is None for s in recs)
    assert all(s["start_ns"] <= s["end_ns"] for s in recs)


def test_counts_land_on_the_innermost_span():
    with _profiler():
        tprof.count("loose")
        with tprof.span("outer"):
            tprof.count("host_read")
            with tprof.span("inner"):
                tprof.count("host_read", 2)
                tprof.count("other")
            tprof.count("host_read")
    outer, inner = tprof.spans()
    assert outer["counts"] == {"host_read": 2}
    assert inner["counts"] == {"host_read": 2, "other": 1}
    assert tprof.summary("outer")["counts"] == {"host_read": 4, "other": 1}
    assert tprof.summary("inner")["counts"] == {"host_read": 2, "other": 1}
    assert tprof.summary()["counts"] == {"host_read": 4, "other": 1,
                                         "loose": 1}


def test_a_span_on_another_thread_takes_the_open_span_as_parent(
        monkeypatch):
    """A thread with no span open (the autograd engine's, on a card) hangs
    its spans and counts under the latest span opened on any thread. A
    plain thread is not profiled, so the check is forced on there."""
    monkeypatch.setattr(tprof, "_recording", lambda: True)
    with tprof.span("fit.backward"):
        def work():
            with tprof.span("cholesky.pullback"):
                pass
            tprof.count("host_read")
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    back, pull = tprof.spans()
    assert pull["parent"] == back["id"]
    assert back["counts"] == {"host_read": 1}


def test_spans_share_the_profilers_clock():
    """Each stored span's host start and end lie within 1 ms of its range
    in the profiler's own events, a host event."""
    with _profiler() as prof:
        for k in range(3):
            with tprof.span(f"s{k}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    recs = tprof.spans()
    assert len(recs) == 3
    for s in recs:
        e = events[s["name"]]
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert abs(s["start_ns"] - e.start_ns()) < 1e6
        assert abs(s["end_ns"] - (e.start_ns() + e.duration_ns())) < 1e6


def test_the_store_drops_past_its_cap(monkeypatch):
    monkeypatch.setattr(tprof._STORE, "cap", 3)
    with _profiler():
        with tprof.span("kept"):
            for _ in range(4):
                with tprof.span("child"):
                    tprof.count("host_read")
    recs = tprof.spans()
    assert [s["name"] for s in recs] == ["kept", "child", "child"]
    assert tprof.dropped() == 2
    # the dropped spans' counts landed on their enclosing span
    assert recs[0]["counts"] == {"host_read": 2}
    tprof.clear()
    assert tprof.spans() == [] and tprof.dropped() == 0


@pytest.mark.parametrize("scan_steps", [1, 3])
def test_a_profiled_fit_records_its_steps(scan_steps):
    """One ``fit.step``, ``fit.forward`` and ``fit.backward`` a step (trace
    id the step), a Cholesky pullback under each backward, the ladder's
    factor under each forward with one try, and a host read a step at
    least."""
    steps = 3
    model, _ = _small_model()
    with _profiler():
        pl.fit(model, pl.projected_lmc_mll, n_iter=steps,
               scan_steps=scan_steps, loss_thresh=0.0, device="cpu")
    recs = tprof.spans()
    by_id = {s["id"]: s for s in recs}
    for name in ("fit.step", "fit.forward", "fit.backward"):
        assert [s["trace_id"] for s in recs if s["name"] == name] \
            == list(range(steps)), name
    for s in recs:
        if s["name"] in ("fit.forward", "fit.backward"):
            assert by_id[s["parent"]]["name"] == "fit.step"
    pulls = [s for s in recs if s["name"] == "cholesky.pullback"]
    assert len(pulls) >= steps
    assert all(by_id[s["parent"]]["name"] == "fit.backward" for s in pulls)
    factors = [s for s in recs if s["name"] == "cholesky.factor"]
    assert all(by_id[s["parent"]]["name"] == "fit.forward" for s in factors)
    totals = tprof.summary()["counts"]
    assert totals["host_read"] >= steps
    assert totals["cholesky.try"] == totals["cholesky.factor"] \
        == len(factors) >= steps
    reads = [s for s in recs if s["name"] == "fit.read"]
    assert len(reads) == (steps if scan_steps == 1 else 1)
    assert all(s["counts"]["host_read"] == 1 for s in reads)


def test_a_profiled_predict_records_its_solve_and_noise():
    model, X = _small_model()
    with torch.no_grad():
        cache = model.prediction_cache()
        with _profiler():
            for size in (5, 9):
                model.predict(torch.as_tensor(X[:size]), cache=cache)
    recs = tprof.spans()
    by_id = {s["id"]: s for s in recs}
    preds = [s for s in recs if s["name"] == "predict"]
    assert [s["trace_id"] for s in preds] == [0, 1]
    for name in ("predict.solve", "predict.noise"):
        kids = [s for s in recs if s["name"] == name]
        assert len(kids) == 2
        assert all(by_id[s["parent"]]["name"] == "predict" for s in kids)
        assert [s["trace_id"] for s in kids] == [0, 1]
    s = tprof.summary("predict")
    assert s["spans"] == 2 and s["counts"]["host_read"] == 2
    assert s["counts"]["cholesky.try"] == 2


def test_the_ladder_counts_each_rung():
    """A matrix that fails as it is climbs one rung: two tries for the one
    factor, and a host read at each rung."""
    A = torch.tensor([[1.0, 1.0], [1.0, 1.0]])
    with _profiler():
        L = pl.safe_cholesky(A)
    assert torch.isfinite(L).all()
    (rec,) = tprof.spans()
    assert rec["name"] == "cholesky.factor"
    assert rec["counts"] == {"cholesky.factor": 1, "cholesky.try": 2,
                             "host_read": 2}
