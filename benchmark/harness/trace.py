"""The traced part of a run: ``torch.profiler`` over a short steady span,
read into the device's busy time (the union of its operations' intervals),
its kernel launches, the operations that took most time and the idle gaps
by what the host was doing. Nothing is written to disk."""

from __future__ import annotations

import heapq
import time
from collections import defaultdict

TOP = 10
NAME_CHARS = 96


def _span(e):
    """(start, end) of a profiler event in seconds."""
    if hasattr(e, "start_ns"):
        s = e.start_ns() * 1e-9
        return s, s + e.duration_ns() * 1e-9
    s = e.start_us() * 1e-6
    return s, s + e.duration_us() * 1e-6


def merge(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top(totals: dict):
    return [[k[:NAME_CHARS], v] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


class Profile:
    """Start and stop around the traced span (the device synchronised at
    both ends, so that the span holds whole operations), then ``read()``."""

    def __init__(self, torch):
        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.wall_s = None
        self.running = False

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def start(self):
        self._sync()
        self.prof.start()
        self.running = True
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.running = False

    def read(self) -> dict:
        """busy_s, window_s, kernels (launch count), device_ops and
        idle_gaps (each a list of [name, seconds], at most 10)."""
        device_type = self.torch.autograd.DeviceType
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            s, t = _span(e)
            if e.device_type() == device_type.CUDA:
                dev.append((s, t, e.name()))
            elif e.device_type() == device_type.CPU:
                host.append((s, t, e.name()))
        busy = merge([(s, t) for s, t, _ in dev])
        ops = defaultdict(float)
        for s, t, name in dev:
            ops[name] += t - s
        kernels = sum(1 for _, _, name in dev
                      if not name.startswith(("Memcpy", "Memset")))
        return dict(busy_s=sum(t - s for s, t in busy), window_s=self.wall_s,
                    kernels=kernels, device_ops=_top(ops),
                    idle_gaps=_top(self._gaps(busy, host)))

    @staticmethod
    def _gaps(busy, host):
        """Idle time between device operations, by the innermost host
        operation running at the gap's middle (the latest started of those
        that span it), in one sweep over time."""
        host = sorted(host)
        gaps = defaultdict(float)
        active, j = [], 0
        mids = sorted((0.5 * (a + b), b - a) for (_, a), (b, _)
                      in zip(busy, busy[1:]))
        for mid, length in mids:
            while j < len(host) and host[j][0] <= mid:
                s, t, name = host[j]
                heapq.heappush(active, (t, s, name))
                j += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            name = max(active, key=lambda a: a[1])[2] if active \
                else "(no host operation)"
            gaps[name] += length
        return gaps
