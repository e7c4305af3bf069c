"""A run with the timed path broken underneath (the look for a chip
skipped, the rest of the run driven) comes out not correct, once for each
fault the cell can have: a step that leaves its state unchanged, half of
the rows or of each batch left out (the mean taken over the rest), an
answer altered where it is produced. One chip needs no exchange between
chips, so that fault has no cell here."""

import pytest
import torch

from conftest import run_small, small_cell


@pytest.mark.parametrize("workload", ("lmc_exact_sarcos10k.train",
                                      "plmc_sarcos10k.train"))
def test_state_left_unchanged(workload, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    _, result = run_small(small_cell(workload))
    assert not result["correct"]
    # each leaf at or above the median change reads 1; the median leaf's
    # gap is at least ½
    assert result["checks"]["change_gap"]["value"] >= 0.5


@pytest.mark.parametrize("workload,fault", [
    ("lmc_exact_sarcos10k.train", "half"),
    ("plmc_sarcos10k.train", "half"),
    ("plmc_sarcos10k.serve", "half"),
    ("plmc_sarcos10k.serve", "altered"),
])
def test_planted_fault_is_not_correct(workload, fault):
    _, result = run_small(small_cell(workload), variant=fault)
    assert not result["correct"], result["checks"]
