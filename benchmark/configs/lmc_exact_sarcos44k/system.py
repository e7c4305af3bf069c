"""The exact LMC at SARCOS's full n as the port runs it: the program side of
``configs/lmc_exact_sarcos10k/system.py`` (the model, its starting leaves,
the objective ``training.fit`` drives, the int8 control and the planted
"half" fault), loaded from that file; only ``config.json`` differs."""

from __future__ import annotations

from pathlib import Path

from harness.core import load_file

_SHARED = load_file(Path(__file__).resolve().parent.parent
                    / "lmc_exact_sarcos10k" / "system.py",
                    "bench_system_lmc_exact_shared")

LOOPS = _SHARED.LOOPS
CONTROL = _SHARED.CONTROL
leaves_from_seed = _SHARED.leaves_from_seed
frozen_leaves = _SHARED.frozen_leaves
build = _SHARED.build
objective = _SHARED.objective
