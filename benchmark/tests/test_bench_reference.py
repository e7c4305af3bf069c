"""Each reference against the port at a small size on the CPU, through the
cell's own loop (the port's CPU path runs the kernels' plain versions):
every number compared stays within the cell's limits."""

import pytest

from conftest import run_small, small_cell

CELLS = ("lmc_exact_sarcos10k.train", "plmc_sarcos10k.train",
         "plmc_sarcos10k.serve")


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(workload):
    cell = small_cell(workload)
    out, result = run_small(cell)
    assert result["correct"], result["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(result["checks"]) == set(cell.limits)
    assert list(result)[-1] == "checks"


def test_projected_reference_mll_is_the_ports():
    """The projected MLL of the reference in float64 against the port's
    ``projected_lmc_mll`` on the same leaves, at n = 120."""
    import torch

    import projected_lmc_tpu_torch as pl
    from harness import data
    cell = small_cell("plmc_sarcos10k.train")
    cfg = dict(cell.config, n=120)
    cpu = torch.device("cpu")
    x, y = data.training_set(cfg, 9, cpu)
    leaves = cell.system.leaves_from_seed(cfg, 9, cpu)
    model = cell.system.build(pl, cfg, x.double(), y.double(),
                              {k: v.double() for k, v in leaves.items()},
                              cpu)
    got = float(pl.projected_lmc_mll(model).detach())
    want = float(cell.reference.mll(x.double(), y.double(),
                                    {k: v.double() for k, v in leaves.items()},
                                    cfg))
    assert got == pytest.approx(want, rel=1e-10)
