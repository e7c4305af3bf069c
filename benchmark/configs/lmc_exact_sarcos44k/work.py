"""The work of one training step of the exact LMC, counted from its shapes
by ``configs/lmc_exact_sarcos10k/work.py`` (loaded from that file) at this
configuration's n = 44,484."""

from __future__ import annotations

from pathlib import Path

from harness.core import load_file

_SHARED = load_file(Path(__file__).resolve().parent.parent
                    / "lmc_exact_sarcos10k" / "work.py",
                    "bench_work_lmc_exact_shared")

step_operations = _SHARED.step_operations
least_step_seconds = _SHARED.least_step_seconds
