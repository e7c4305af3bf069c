"""The control of each cell, on the chip at the cell's own size: the
configuration one precision lower (the reference in float32 with TF32 on
in the program's place; where a configuration's program has its own lower
path, ``system.CONTROL``, that path) fails the cell's limits."""

import time

import pytest

from harness import core


@pytest.mark.chip
@pytest.mark.parametrize("workload", ("plmc_sarcos10k.train",
                                      "plmc_sarcos10k.serve"))
def test_control_fails_the_limits(workload, cuda):
    import calibrate
    import projected_lmc_tpu_torch as pl
    from harness.compare import verdict
    cell = core.Cell(workload)
    variant = getattr(cell.system, "CONTROL", None)
    if variant is None:
        numbers = calibrate.reference_control(cell, 2 ** 33 + 7, cuda)
    else:
        numbers = cell.loop.run(cell, pl, 2 ** 33 + 7, 1.0, False, cuda,
                                time.time(), variant)["numbers"]
    ok, checks = verdict(numbers, cell.limits)
    assert not ok, checks
