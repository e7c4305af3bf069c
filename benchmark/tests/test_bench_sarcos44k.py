"""The exact LMC at SARCOS's full n (``lmc_exact_sarcos44k.train``) at a
small size on the CPU, through the cell's own loop and limits: the blocked
reference (row blocks that do not divide n) agrees with the port, a planted
fault does not; a traced run reads the CG's counters and leaves the device
stretches out; the new readers read nothing where the program has no such
spans or counters, and the two roofline shares take the cell's work model
by its least step time."""

import json

import pytest
import torch

from conftest import BENCH, run_small, small_cell

CELL = "lmc_exact_sarcos44k.train"
NEW = ("pcg_ms.train", "cg_iters_per_solve.train",
       "pcg_frozen_per_step.train", "stack_product_roofline.train",
       "ls_reduce_roofline.train")


@pytest.fixture(autouse=True)
def _empty_store():
    from projected_lmc_tpu_torch.utils import profiling
    profiling.clear()
    yield
    profiling.clear()


def _cell(monkeypatch):
    cell = small_cell(CELL)
    # n = 240 in blocks of 100, 100 and 40
    monkeypatch.setattr(cell.reference, "ROWS", 100)
    return cell


def test_reference_agrees_with_the_port(monkeypatch):
    cell = _cell(monkeypatch)
    out, result = run_small(cell)
    assert result["correct"], result["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(result["checks"]) == set(cell.limits)


@pytest.mark.parametrize("fault", ["half", "unchanged"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    cell = _cell(monkeypatch)
    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.AdamW, "step",
                            lambda self, closure=None: None)
    _, result = run_small(cell, variant=fault if fault == "half" else None)
    assert not result["correct"], result["checks"]


def test_a_traced_run_reads_the_cg_counters(monkeypatch):
    cell = _cell(monkeypatch)
    _, result = run_small(cell, trace=True)
    got = result["metrics"]
    assert 0 < got["cg_iters_per_solve.train"]["value"] \
        <= cell.config["mll"]["max_cg_iters"]
    assert got["pcg_frozen_per_step.train"]["value"] == 0
    assert got["host_reads_per_step.train"]["value"] > 0
    # device stretches: none off a card
    for name in ("pcg_ms.train", "stack_product_roofline.train",
                 "ls_reduce_roofline.train", "step_forward_ms.train"):
        assert name not in got


def _reader(name):
    from harness.core import load_file
    return load_file(BENCH / "metrics" / f"{name}.py",
                     "test_metric_" + name.replace(".", "_"))


def _least_s():
    from harness.core import load_file
    work = load_file(BENCH / "configs" / "lmc_exact_sarcos44k" / "work.py",
                     "test_work_lmc_exact_sarcos44k")
    cfg = json.loads((BENCH / "configs" / "lmc_exact_sarcos44k"
                      / "config.json").read_text())
    return work, cfg, work.least_step_seconds(cfg)


def test_the_readers_read_nothing_without_the_programs_spans():
    """A program that records none of the new spans and counters (the
    store is empty, as after a run of one that lacks them): every new
    reader returns None and does not raise."""
    ctx = dict(loop="train", profiled_steps=16, least_s=_least_s()[2],
               busy_s=1.0, window_s=1.0)
    assert [_reader(n).read(ctx) for n in NEW] == [None] * len(NEW)


def test_the_shares_take_the_cells_work(monkeypatch):
    from harness.peaks import least_seconds
    from harness.stepwork import least_by_name
    from projected_lmc_tpu_torch.utils import profiling
    work, cfg, least_s = _least_s()
    ops = work.step_operations(cfg)
    by_name = least_by_name({"least_s": least_s})
    assert sum(by_name.values()) == pytest.approx(least_s, rel=1e-12)
    assert least_by_name({"least_s": least_s * 1.5}) == {}
    products = sum(least_seconds(o) for o in ops if "stack product"
                   in o["name"])
    reduction = sum(least_seconds(o) for o in ops
                    if o["name"] == "lengthscale reduction")
    stretch = {"mll.stack_product": 4000.0, "mll.ls_reduce": 400.0}
    monkeypatch.setattr(profiling, "summary", lambda name=None: dict(
        spans=1, device_ms=stretch.get(name), counts={}))
    ctx = dict(loop="train", profiled_steps=16, least_s=least_s)
    assert _reader("stack_product_roofline.train").read(ctx) == \
        pytest.approx(100 * 16 * products / 4.0)
    assert _reader("ls_reduce_roofline.train").read(ctx) == \
        pytest.approx(100 * 16 * reduction / 0.4)
