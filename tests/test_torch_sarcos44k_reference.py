"""The benchmark's blocked reference of the exact LMC at SARCOS's full n
(``benchmark/reference/lmc_exact_sarcos44k.py``) against the port's fused
PCG MLL and against the whole-matrix reference of the 10k configuration,
on the CPU at small n, on seeded leaves, data and probes.

The port on the configuration's objective (``MultitaskGPModel.mll`` on the
fused route, the roots as the benchmark builds them): the value and every
raw leaf's gradient against the reference's first step, at row blocks that
divide n, that do not, and that exceed it. With fp32 stack products on both
sides the two are one computation in another order: value within 1e-5,
each leaf's gradient within 1e-3 of its largest entry. With the
configuration's bf16 stack each side rounds its own fp32 kernel (the
port's plain kernel sums squared differences, the reference expands them),
so entries near a bf16 rounding boundary differ by one bf16 step and the
16-step CG carries that: value within 2e-3 and gradient norms within 1e-1.
The blocked reference against the 10k one: two AdamW steps, the losses and
leaves bit for bit, the gradients within 1e-6 (the lengthscale
cotangent's product is formed from its factors in one GEMM here).
"""

import json
import sys
from pathlib import Path

import pytest
import torch

import projected_lmc_tpu_torch as pl
from projected_lmc_tpu_torch.ops import iterative

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import data  # noqa: E402
from harness.core import load_file  # noqa: E402

N, RANK, SEED = 300, 32, 2 ** 33 + 7
REF = load_file(BENCH / "reference" / "lmc_exact_sarcos44k.py",
                "test_reference_lmc_exact_sarcos44k")
REF10K = load_file(BENCH / "reference" / "lmc_exact_sarcos10k.py",
                   "test_reference_lmc_exact_sarcos10k")
SYSTEM = load_file(BENCH / "configs" / "lmc_exact_sarcos44k" / "system.py",
                   "test_system_lmc_exact_sarcos44k")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _float32_default():
    """The benchmark draws its leaves at the default dtype, float32 in its
    own process; a test module run before this one may have changed it."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_default_dtype(old)


def _config(bf16=True):
    cfg = json.loads((BENCH / "configs" / "lmc_exact_sarcos44k"
                      / "config.json").read_text())
    assert cfg["n"] == 44484 and cfg["mll"]["matvec_bf16"]
    cfg["n"] = N
    cfg["mll"].update(precond_rank=RANK, matvec_bf16=bf16)
    return cfg


def _inputs(cfg, steps=1):
    x, y = data.training_set(cfg, SEED, CPU)
    leaves = SYSTEM.leaves_from_seed(cfg, SEED, CPU)
    g = torch.Generator().manual_seed(3)
    s, q = cfg["mll"]["num_probes"], cfg["q"]
    f32 = dict(generator=g, dtype=torch.float32)
    probes = [(torch.randn((s, N, cfg["T"]), **f32),
               torch.randn((s, q, RANK), **f32)) for _ in range(steps)]
    return x, y, leaves, probes


def _port(cfg, x, y, leaves, probes):
    """(−ℓ/(nT), {raw leaf: gradient}) of the port's objective."""
    model = SYSTEM.build(pl, cfg, x, y, leaves, CPU)
    kw = dict(cfg["mll"])
    kw.pop("num_probes")
    roots = iterative.nystrom_roots_from_covar(
        model.covar_module, x, RANK, cfg["roots_jitter"])
    eps, xi = probes[0]
    loss = -model.mll(precond_roots=roots, eps=eps, xi=xi, **kw)
    loss.backward()
    params = dict(model.named_parameters())
    return float(loss.detach()), {k: params[k].grad for k in leaves}


@pytest.mark.parametrize("rows", [64, 100, 4096])
def test_fp32_products_match_the_port(monkeypatch, rows):
    monkeypatch.setattr(REF, "STACK", torch.float32)
    cfg = _config(bf16=False)
    x, y, leaves, probes = _inputs(cfg)
    loss, grads = _port(cfg, x, y, leaves, probes)
    losses, first, _ = REF.train(x, y, leaves, SYSTEM.frozen_leaves(cfg, CPU),
                                 probes, cfg, 1, rows=rows)
    assert loss == pytest.approx(losses[0], rel=1e-5)
    for k, want in first.items():
        gap = float((grads[k] - want).abs().max() / want.abs().max())
        assert gap <= 1e-3, (k, gap)


def test_bf16_products_match_the_port():
    cfg = _config()
    x, y, leaves, probes = _inputs(cfg)
    loss, grads = _port(cfg, x, y, leaves, probes)
    losses, first, _ = REF.train(x, y, leaves, SYSTEM.frozen_leaves(cfg, CPU),
                                 probes, cfg, 1, rows=64)
    assert loss == pytest.approx(losses[0], rel=2e-3)
    for k, want in first.items():
        gap = abs(float(grads[k].norm() - want.norm())) / float(want.norm())
        assert gap <= 1e-1, (k, gap)


@pytest.mark.parametrize("rows", [64, 4096])
def test_blocks_match_the_whole_matrix_reference(rows):
    cfg = _config()
    x, y, leaves, probes = _inputs(cfg, steps=2)
    frozen = SYSTEM.frozen_leaves(cfg, CPU)
    got = REF.train(x, y, leaves, frozen, probes, cfg, 2, rows=rows)
    want = REF10K.train(x, y, leaves, frozen, probes, cfg, 2)
    assert got[0] == want[0]
    for k in want[1]:
        torch.testing.assert_close(got[1][k], want[1][k], rtol=1e-6,
                                   atol=1e-6 * float(want[1][k].abs().max()))
        assert torch.equal(got[2][k], want[2][k])
