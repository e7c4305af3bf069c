"""The operation and byte counts against hand counts at a small shape, and
the least time against the peaks."""

import json

import pytest

from conftest import BENCH
from harness import peaks, work
from harness.core import load_file


def _cfg(name, **kw):
    cfg = json.loads((BENCH / "configs" / name / "config.json").read_text())
    cfg.update(kw)
    return cfg


def _by_name(ops):
    out = {}
    for o in ops:
        e = out.setdefault(o["name"], {"bytes": 0.0, "ops": {}})
        e["bytes"] += o["bytes"]
        for k, v in o["ops"].items():
            e["ops"][k] = e["ops"].get(k, 0.0) + v
    return out


def test_projected_step_by_hand():
    w = load_file(BENCH / "configs" / "plmc_sarcos10k" / "work.py", "w_p")
    n, d, q = 10, 3, 2
    ops = _by_name(w.step_operations(_cfg("plmc_sarcos10k", n=n, d=d, q=q)))
    pairs = q * n * (n + 1) / 2                       # 110
    assert ops["latent kernels"]["ops"]["fp32"] == pairs * 19
    assert ops["latent kernels"]["bytes"] == 4 * (n * d + pairs)
    assert ops["potrf"]["ops"]["fp32"] == pytest.approx(q * 1000 / 3)
    assert ops["latent inverses"]["ops"]["fp32"] == pytest.approx(
        q * 2000 / 3)
    assert ops["solve with the projected data"]["ops"]["fp32"] == q * 100
    assert ops["lengthscale reduction"]["ops"]["fp32"] == pairs * (9 + 7 + 14)


def test_projected_request_by_hand():
    w = load_file(BENCH / "configs" / "plmc_sarcos10k" / "work.py", "w_p2")
    n, d, q, t, ns = 10, 3, 2, 5, 4
    ops = _by_name(w.request_operations(
        _cfg("plmc_sarcos10k", n=n, d=d, q=q, T=t), ns))
    assert ops["cross-covariance"]["ops"]["fp32"] == q * n * ns * 19
    assert ops["L^-1 K*"]["ops"]["fp32"] == q * n * n * ns
    assert ops["L^-1 K*"]["bytes"] == 4 * q * (55 + 2 * n * ns)
    assert ops["mean"]["ops"]["fp32"] == 2 * q * n * ns


def test_lmc_step_by_hand():
    w = load_file(BENCH / "configs" / "lmc_exact_sarcos10k" / "work.py",
                  "w_l")
    cfg = _cfg("lmc_exact_sarcos10k", n=10, d=3, q=2, T=5)
    cfg["mll"] = dict(cfg["mll"], num_probes=2, precond_rank=4,
                      max_cg_iters=3)
    ops = w.step_operations(cfg)
    named = _by_name(ops)
    # 3 CG products with 1 + 2 right-hand sides on 2 latents of 10 × 10
    assert named["CG stack product"]["ops"]["bf16"] == 3 * 2 * 2 * 100 * 3
    assert named["CG stack product"]["bytes"] == 3 * (2 * 55 * 2
                                                      + 2 * 2 * 10 * 3 * 4)
    assert named["backward stack product"]["ops"]["bf16"] == 2 * 2 * 100 * 5
    # 4 applies with 3 columns and one with 2: 4 q n m per column + 2 (qm)²
    per = lambda c: 4 * 2 * 10 * 4 * c + 2 * 64 * c    # noqa: E731
    assert named["preconditioner apply"]["ops"]["fp32"] == 4 * per(3) + per(2)
    assert named["stack build"]["bytes"] == 10 * 3 * 4 + 110 * 2
    # the roots once a chunk of 16 steps
    assert named["roots factor"]["ops"]["fp32"] == pytest.approx(
        2 * 64 / 3 / 16)


def test_least_time_is_the_larger_bound():
    o = peaks.op("x", 3.35e12, fp32=67e12)
    assert peaks.least_seconds(o) == pytest.approx(1.0)
    o = peaks.op("y", 0.0, fp32=67e12, bf16=989e12)
    assert peaks.least_seconds(o) == pytest.approx(2.0)
    o = work.gemm("g", 2, 3, 4)
    assert o["ops"]["fp32"] == 48 and o["bytes"] == 4 * (8 + 12 + 6)
