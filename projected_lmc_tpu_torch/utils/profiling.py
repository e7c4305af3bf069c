"""Tracing / profiling helpers (port of ``projected_lmc_tpu/utils/profiling.py``).

The reference measures wall-clock only (train_time/pred_time/t_per_iter,
experiments.py:261,284,316,331). Those metric names are preserved by
training.fit and metrics.compute_metrics; this module adds optional
``torch.profiler`` traces (Chrome trace format, viewable in Perfetto or
chrome://tracing) around any region, and the program's own spans and
counters on the profiler's clock.

Spans and counters. :func:`span` marks a region of the program and
:func:`count` adds to a named counter. Both are on only while a
``torch.profiler`` is recording in the process (``profile_trace``, or any
``torch.profiler.profile``): each call checks
``torch._C._autograd._profiler_enabled()`` and, when it is false, does
nothing more (``span`` returns one shared no-op context), so the program
opens no profiler range and makes no CUDA event then. There is no other
switch. While one records, a span

- opens a range of its name on the profiler's host timeline (and so in
  ``profile_trace``'s Chrome trace), with
  ``torch._C._profiler._RecordFunctionFast``: the scope of torch's own
  operators. ``torch.profiler.record_function`` opens a user scope, for
  which the profiler also draws a ``gpu_user_annotation`` over the span's
  kernels on the device timeline, an event that a reader of device
  operations would take for device work;
- stores a record: ``name``, ``id``, ``parent`` (the innermost open span
  of its thread; on a thread with none open, the latest opened on any
  thread, so that the autograd engine's backward thread hangs its spans
  under ``fit.backward``), ``trace_id`` (given; else the parent's; else
  the span's ordinal among the stored root spans of its name), host
  ``start_ns`` and ``end_ns`` on the profiler's clock (the
  Unix epoch in ns, ``time.time_ns()``) and the ``counts`` that landed on
  it: a count lands on the innermost open span of its thread (else as a
  parent would), or, with no span open, on the store itself;
- on a card, records a ``torch.cuda.Event`` at entry and one at exit on
  the stream current at entry. The span's device stretch is the time between them:
  from the stream reaching the entry event to its reaching the exit event,
  idle inside included. It is read once the device is synced
  (:func:`spans` synchronizes).

The store is this process's, bounded at :data:`MAX_SPANS` records: past
that, a span is not stored (its counts land on its enclosing span) and
:func:`dropped` counts it. :func:`spans` and :func:`summary` read it,
:func:`clear` empties it; nothing is written to disk.

The spans: ``fit.step`` (trace id the step's index), ``fit.forward``,
``fit.backward`` and ``fit.read`` (``training.fit``); ``cholesky.factor``
(the jitter ladder) and ``cholesky.pullback`` (the generic Cholesky
backward, or the Gaussian log-density's closed form, ``ops.cholesky``); ``predict`` (``ProjectedGPModel.predict``, trace id the
request's ordinal), ``predict.noise`` (its task noise) and
``predict.solve`` (the n*-column triangular solve of
``ExactGPModel.posterior``); ``mll.pcg`` (the MLL's PCG loop with its
M⁻¹ applies, ``ops.iterative.pcg_with_tridiag``), ``mll.stack_product``
(each product with a materialized kernel stack, in the CG and in the
backward) and ``mll.ls_reduce`` (the fused MLL's lengthscale reduction,
K2 or K7, in its backward). The counters: ``host_read``, one at each
place where the host reads a device value and so waits for the device;
``cholesky.try``, one a factorization the ladder attempts, and
``cholesky.factor``, one a factor it returns; ``cholesky.pullback``, one a
pullback of either kind, and ``cholesky.pullback.closed_form``, one a
closed-form one; ``cg.solves``, ``cg.iters`` and ``cg.frozen``, the PCG's
right-hand sides, their active steps and those frozen by its breakdown
guard, added up on the card. The benchmark's per-layer
metrics (``benchmark/metrics/``) read them after a traced run.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import Counter

import torch

MAX_SPANS = 10 ** 6
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Store:
    """The spans and loose counts of the process, guarded by one lock."""

    def __init__(self, cap: int):
        self.cap = cap
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self):
        self.records, self.open = [], []
        self.loose, self.roots = Counter(), Counter()
        self.dropped, self.next_id = 0, 0

    def stack(self):
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def innermost(self):
        s = self.stack()
        if s:
            return s[-1]
        return self.open[-1] if self.open else None


_STORE = _Store(MAX_SPANS)


class _Span:
    """One stored span while it is open (see the module docstring)."""

    def __init__(self, name: str, trace_id):
        self.name, self.trace_id = name, trace_id

    def __enter__(self):
        st = _STORE
        with st.lock:
            if len(st.records) >= st.cap:
                st.dropped += 1
                self.rec = None
                return self
            parent = st.innermost()
            trace_id = self.trace_id
            if trace_id is None:
                if parent is not None:
                    trace_id = parent["trace_id"]
                else:
                    trace_id = st.roots[self.name]
                    st.roots[self.name] += 1
            rec = dict(name=self.name, id=st.next_id,
                       parent=None if parent is None else parent["id"],
                       trace_id=trace_id, start_ns=None, end_ns=None,
                       counts=Counter(), _events=None)
            st.next_id += 1
            st.records.append(rec)
            st.open.append(rec)
        st.stack().append(rec)
        self.rec = rec
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            # both events on the stream current at entry, looked up once:
            # the lookup costs about as much as a record
            self.stream = torch.cuda.current_stream()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            rec["_events"] = (ev, None)
        rec["start_ns"] = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is None:
            return False
        rec["end_ns"] = time.time_ns()
        if rec["_events"] is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            rec["_events"] = (rec["_events"][0], ev)
        self.rf.__exit__(*exc)
        stack = _STORE.stack()
        if stack and stack[-1] is rec:
            stack.pop()
        with _STORE.lock:       # gone already if the store was cleared
            _STORE.open = [r for r in _STORE.open if r is not rec]
        return False


def span(name: str, trace_id=None):
    """A context marking a region of the program as the span ``name``
    while a ``torch.profiler`` records (see the module docstring); else
    the shared no-op context."""
    if not _recording():
        return _OFF
    return _Span(name, trace_id)


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process: the one switch
    of spans and counters, for a caller whose count costs work to form."""
    return _recording()


def count(name: str, k=1):
    """Add ``k`` to the counter ``name`` on the innermost open span while a
    ``torch.profiler`` records; else nothing. ``k`` may be a tensor on the
    card: it is added up there, and read once the store is read
    (:func:`spans`, :func:`summary`), so counting waits for nothing."""
    if not _recording():
        return
    st = _STORE
    with st.lock:
        rec = st.innermost()
        (st.loose if rec is None else rec["counts"])[name] += k


def clear():
    """Empty the store; spans open now are forgotten, and so are the counts
    that land on them."""
    with _STORE.lock:
        _STORE.clear()
    _STORE.local = threading.local()


def dropped() -> int:
    """Spans not stored because the store was full."""
    return _STORE.dropped


def spans() -> list:
    """Every stored span, closed or not, as a dict: ``name``, ``id``,
    ``parent``, ``trace_id``, ``start_ns``, ``end_ns``,
    ``counts`` and ``device_ms`` (its device stretch; None off a card or
    while the span is open). Synchronizes the device first when a stored
    span has events."""
    with _STORE.lock:
        records = list(_STORE.records)
    if any(r["_events"] is not None for r in records):
        torch.cuda.synchronize()
    out = []
    for r in records:
        ev = r["_events"]
        if ev is not None and ev[1] is not None and "device_ms" not in r:
            r["device_ms"] = ev[0].elapsed_time(ev[1])
        d = {k: v for k, v in r.items() if k != "_events"}
        d.setdefault("device_ms", None)
        d["counts"] = _numbers(d["counts"])
        out.append(d)
    return out


def _numbers(counts) -> Counter:
    """A copy of ``counts`` with the counts held in tensors read to
    numbers."""
    return Counter({k: v.item() if isinstance(v, torch.Tensor) else v
                    for k, v in counts.items()})


def summary(name: str = None) -> dict:
    """What the stored spans named ``name`` add up to: ``spans`` (how
    many), ``host_ms`` (their host durations), ``device_ms`` (their device
    stretches; None unless each span has one), ``children_device_ms`` (the
    stretches of their direct children, by the child's name) and
    ``counts`` (the counts on them and on every span below them). With no
    ``name``, ``counts`` is every count in the store, loose ones too."""
    recs = spans()
    if name is None:
        total = _numbers(_STORE.loose)
        for r in recs:
            total.update(r["counts"])
        return dict(spans=len(recs), counts=total)
    by_id = {r["id"]: r for r in recs}
    picked = [r for r in recs if r["name"] == name]
    ids = {r["id"] for r in picked}
    children, counts = {}, Counter()
    for r in recs:
        if r["parent"] in ids and r["device_ms"] is not None:
            children[r["name"]] = children.get(r["name"], 0.0) \
                + r["device_ms"]
        a = r
        while a is not None and a["id"] not in ids:
            a = by_id.get(a["parent"])
        if a is not None:
            counts.update(r["counts"])
    stretches = [r["device_ms"] for r in picked]
    return dict(spans=len(picked),
                host_ms=sum((r["end_ns"] or r["start_ns"]) - r["start_ns"]
                            for r in picked) * 1e-6,
                device_ms=sum(stretches) if picked and None not in stretches
                else None,
                children_device_ms=children, counts=counts)


@contextlib.contextmanager
def profile_trace(logdir: str = "torch-trace", enabled: bool = True):
    """``torch.profiler`` trace of the region (the CPU, and the card's
    kernels when one is present), written as a Chrome trace
    ``trace_<pid>_<time>.json`` into ``logdir``; yields the profiler, or
    None when disabled (a no-op)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer:
    """Wall-clock timer mirroring the reference's time.time() bracketing."""

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.start
        return False
