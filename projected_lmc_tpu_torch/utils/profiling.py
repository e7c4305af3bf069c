"""Tracing / profiling helpers (port of ``projected_lmc_tpu/utils/profiling.py``).

The reference measures wall-clock only (train_time/pred_time/t_per_iter,
experiments.py:261,284,316,331). Those metric names are preserved by
training.fit and metrics.compute_metrics; this module adds optional
``torch.profiler`` traces (Chrome trace format, viewable in Perfetto or
chrome://tracing) around any region.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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
