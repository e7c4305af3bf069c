"""Smoke tests: every script in examples_torch/ runs end to end with --cpu.

Each example is executed as a real subprocess (its docstring's invocation,
with ``--cpu``: the kernels' plain versions), and the same markers are
asserted as for the JAX package's examples (``tests/test_examples.py``),
with every printed loss finite. The 8-rank example runs its ranks with one
torch thread each.
"""

import math
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples_torch")


def _run(name, extra_env=None, timeout=900):
    env = dict(os.environ, PYTHONPATH=REPO, **(extra_env or {}))
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES, name),
                           "--cpu"], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    losses = [float(v) for v in re.findall(r"\bloss (\S+?)[,\s]",
                                           proc.stdout + "\n")]
    assert losses and all(map(math.isfinite, losses)), proc.stdout
    return proc.stdout


@pytest.mark.slow
def test_quickstart_projected():
    out = _run("01_quickstart_projected.py")
    assert "R2=" in out and "alpha_CI=" in out


@pytest.mark.slow
def test_sgpr_serving():
    out = _run("02_sgpr_serving.py")
    assert "cache == self-contained: True" in out


@pytest.mark.slow
def test_checkpoint_resume():
    out = _run("04_checkpoint_resume.py")
    assert "matches phase-1 final: True" in out
    assert "improved: True" in out


@pytest.mark.slow
def test_multichip_sharding():
    out = _run("03_multichip_sharding.py", {"OMP_NUM_THREADS": "1"})
    assert "match: True" in out
    assert "'data': 4" in out and "'latent': 2" in out
