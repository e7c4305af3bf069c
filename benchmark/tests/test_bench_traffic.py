"""The traffic and the inputs repeat for a seed, and differ between
seeds; seeds above 32 bits are taken."""

import json

import torch

from conftest import BENCH

BIG = 2 ** 33 + 12345


def test_request_sizes_repeat_for_a_seed():
    from harness.serve import request_sizes
    tr = json.loads((BENCH / "traffic" / "serve.json").read_text())
    a, b = request_sizes(tr, BIG), request_sizes(tr, BIG)
    assert (a == b).all()
    assert not (a == request_sizes(tr, BIG + 1)).all()
    assert a.min() >= tr["batch_min"] and a.max() <= tr["batch_max"]
    # every seed sends the same sizes, in another order
    k = tr["ladder"]
    other = request_sizes(tr, 7)
    assert sorted(a[:k]) == sorted(other[:k]) == sorted(a[k:2 * k])


def test_inputs_and_leaves_repeat_for_a_seed():
    from conftest import small_cell
    from harness import data
    cpu = torch.device("cpu")
    for name in ("lmc_exact_sarcos10k.train", "plmc_sarcos10k.train"):
        cell = small_cell(name)
        cfg = dict(cell.config, n=50)
        for seed in (BIG, 3):
            x1, y1 = data.training_set(cfg, seed, cpu)
            x2, y2 = data.training_set(cfg, seed, cpu)
            assert torch.equal(x1, x2) and torch.equal(y1, y2)
            l1 = cell.system.leaves_from_seed(cfg, seed, cpu)
            l2 = cell.system.leaves_from_seed(cfg, seed, cpu)
            assert all(torch.equal(l1[k], l2[k]) for k in l1)
        assert not torch.equal(data.training_set(cfg, 1, cpu)[0],
                               data.training_set(cfg, 2, cpu)[0])
    p = data.serving_pool(100, 21, BIG, cpu)
    assert torch.equal(p, data.serving_pool(100, 21, BIG, cpu))
