"""The port's full-grid kernels K6 (``cuda_kernels.scaled_kernel_stack``,
TPU kernel B5) and K7 (``lowrank_stationary_reduce``, B6), K3
(``kernel_matrix``, B4's forward, K6's kernel at os = 1), and the fused
MLL under ``PLMC_SYM_BUILD=0``, against the JAX package on the CPU.

K3, K6 and K7 run only on the card (``chip_smoke.py``); here their plain
versions run beside the Pallas kernels in interpret mode. The JAX fused op
on the CPU takes its dense XLA branch whatever ``PLMC_SYM_BUILD`` says,
which is the same math as both of the port's grids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.ops import pallas_kernels as pk
from projected_lmc_tpu_torch.ops import cuda_kernels as ck
from projected_lmc_tpu_torch.ops import fused_mll as tfm
from test_torch_fused_mll import (NAMES, jax_value_and_grads, make_problem,
                                  torch_value_and_grads)

KINDS = ["matern25", "rbf", "matern15", "matern05"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny torch ops in long loops: one intra-op thread
    avoids oversubscribing the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


# (kind, d, n, m, seed): a 70-point square and a ragged rectangle, then
# (n, m) = (130, 200), which straddle a 128-tile of the Pallas grid and of
# the card's, at d = 1 and 21 for every kind
CASES = {"square": ("matern25", 3, 70, None, 0),
         "ragged": ("matern25", 3, 70, 45, 0),
         **{f"{kind}-d{d}-130x200": (kind, d, 130, 200, d)
            for kind in KINDS for d in (1, 21)}}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_scaled_stack_matches_pallas(case, bf16):
    """K6 plain, and in fp32 K3 plain, against the Pallas kernels: fp32 at
    the JAX tests' tolerance (tests/test_fused_mll.py::test_scaled_stack,
    rtol 1e-5, atol 1e-6); bf16 within one bf16 step (2⁻⁷ relative): the
    Pallas tile rounds its short-exp2 value, the plain version its libm
    one. Matérn-½ at d = 1 has pairs ~1e-4 apart, where the Pallas d²
    expansion's fp32 cancellation moves g by ~2e-4 against float64
    (g′ ~ 1/r), while the plain version's direct differences stay within
    1e-6 of it: there fp32 is held to float64 at 1e-6 and to the Pallas
    kernel at 5e-4 of the largest entry."""
    kind, d, n, m, seed = CASES[case]
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    x2 = x1 if m is None else rng.uniform(-1, 1, (m, d)).astype(np.float32)
    # lengthscales grow with √d past 8 features, so that the kernel is not
    # near diagonal
    ls = (rng.uniform(0.5, 1.5, (2, 1, d))
          * (np.sqrt(d / 2) if d > 8 else 1.0)).astype(np.float32)
    os_ = np.float32([0.7, 1.9])
    J = [jnp.asarray(a) for a in (x1, x2, ls)]
    T = [t32(a) for a in (x1, x2, ls)]
    dt = torch.bfloat16 if bf16 else torch.float32
    want = {"K6": pk.scaled_kernel_stack(*J, jnp.asarray(os_), kind, True,
                                         jnp.bfloat16 if bf16 else None)}
    got = {"K6": ck.scaled_kernel_stack(*T, t32(os_), kind, dt,
                                        device="cpu")}
    if not bf16:    # K3 is fp32 only
        want["K3"] = pk.fused_kernel_matrix(*J, kind, True)
        got["K3"] = ck.kernel_matrix(*T, kind, device="cpu")
        exact = ck.kernel_matrix(*(torch.tensor(a, dtype=torch.float64)
                                   for a in (x1, x2, ls)), kind,
                                 device="cpu")
    for key in got:
        assert got[key].shape == (2, n, m or n), key
        assert got[key].dtype == dt, key
        g = got[key].float().numpy()
        w = np.asarray(want[key]).astype(np.float32)
        if bf16:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, err_msg=key)
        elif kind == "matern05" and d == 1:
            scale = 1.0 if key == "K3" else os_[:, None, None]
            np.testing.assert_allclose(g, exact.numpy() * scale, rtol=0,
                                       atol=1e-6, err_msg=key)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=5e-4 * np.abs(w).max(),
                                       err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("kind", KINDS)
def test_lowrank_reduce_matches_pallas(kind):
    """Non-symmetric factors (the full grid assumes no symmetry), n = 130 (a
    ragged Pallas tile), at the port's K2 tolerances: the Pallas body's exp2
    (~2e-5) summed over 130 columns."""
    rng = np.random.default_rng(4)
    n, d, B, r = 130, 2, 3, 5
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, (B, 1, d)).astype(np.float32)
    A = rng.standard_normal((B, n, r)).astype(np.float32)
    Bf = rng.standard_normal((B, n, r)).astype(np.float32)
    rows_j, wx_j = pk.lowrank_stationary_reduce(
        jnp.asarray(x), jnp.asarray(ls), jnp.asarray(A), jnp.asarray(Bf),
        kind, interpret=True)
    rows, wx = ck.lowrank_stationary_reduce(t32(x), t32(ls), t32(A), t32(Bf),
                                            kind, device="cpu")
    assert rows.shape == (B, n) and wx.shape == (B, n, d)
    if kind != "matern05":
        for got, want in ((rows, rows_j), (wx, wx_j)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-3, atol=5e-3)
        return
    # Matérn-½: a pair 0.005 apart has g′ ~ 1e2, and the Pallas d² expansion
    # is off by 9e-4 of the largest entry against float64 there, while the
    # plain version (direct differences) is within 1e-5 of it (ROADMAP.md C)
    exact = ck.lowrank_stationary_reduce(
        *(torch.tensor(a, dtype=torch.float64) for a in (x, ls, A, Bf)),
        kind, device="cpu")
    for got, want, ref in zip((rows, wx), (rows_j, wx_j), exact):
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-3 * scale)


def test_cpu_tensors_take_plain_versions_without_a_launch():
    rng = np.random.default_rng(1)
    x = t32(rng.standard_normal((20, 2)))
    ls = t32(np.ones((2, 1, 2)))
    A = t32(rng.standard_normal((2, 20, 3)))
    before = (ck.scaled_kernel_stack.launches,
              ck.lowrank_stationary_reduce.launches)
    ck.scaled_kernel_stack(x, x[:7], ls, t32([1.0, 2.0]), "rbf", device="cpu")
    ck.lowrank_stationary_reduce(x, ls, A, A, "rbf", device="cpu")
    assert before == (ck.scaled_kernel_stack.launches,
                      ck.lowrank_stationary_reduce.launches)


def test_routes_under_full_grid(monkeypatch):
    """PLMC_SYM_BUILD=0, read at each call: the stack route whatever
    PLMC_KR_FUSED and PLMC_KR_STREAM ask, for every stack dtype."""
    monkeypatch.setenv("PLMC_KR_FUSED", "1")
    stacks = [torch.zeros((1, 8, 8), dtype=dt)
              for dt in (torch.float32, torch.bfloat16, torch.int8)]
    monkeypatch.setenv("PLMC_SYM_BUILD", "1")
    assert [tfm._backward_route(K) for K in stacks] == ["kr", "kr", "stack"]
    monkeypatch.setenv("PLMC_SYM_BUILD", "0")
    assert [tfm._backward_route(K) for K in stacks] == ["stack"] * 3
    monkeypatch.setenv("PLMC_KR_STREAM", "1")
    assert [tfm._backward_route(K) for K in stacks] == ["stack"] * 3


def spy_on(monkeypatch, names):
    """Record the calls of the named cuda_kernels wrappers (the fused op
    looks each up on the module at call time)."""
    calls = []
    for name in names:
        real = getattr(ck, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(ck, name, spy)
    return calls


WRAPPERS = ["scaled_kernel_stack_sym", "scaled_kernel_stack",
            "quantized_kernel_stack", "lowrank_stationary_reduce_sym",
            "lowrank_stationary_reduce", "lowrank_stationary_reduce_sym_kr",
            "lowrank_stationary_reduce_sym_krs"]


@pytest.mark.parametrize("kind", ["matern25", "rbf", "matern15"])
def test_fused_op_full_grid_matches_jax(monkeypatch, kind):
    """PLMC_SYM_BUILD=0 with PLMC_KR_FUSED=1 set: K6 builds the stack, K7
    reduces, and value (rtol 1e-9) and gradients (rtol 1e-7) match the JAX
    fused op in float64 (tests/test_torch_fused_mll.py's tolerances)."""
    monkeypatch.setenv("PLMC_SYM_BUILD", "0")
    monkeypatch.setenv("PLMC_KR_FUSED", "1")
    calls = spy_on(monkeypatch, WRAPPERS)
    x, leaves, eps, xi, rank = make_problem()
    vj, gj = jax_value_and_grads(x, leaves, eps, xi, rank, kind, jit=True)
    vt, gt = torch_value_and_grads(x, leaves, eps, xi, rank, kind)
    assert calls == ["scaled_kernel_stack", "lowrank_stationary_reduce"]
    np.testing.assert_allclose(vt, vj, rtol=1e-9)
    for a, b, name in zip(gt, gj, NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9,
                                   err_msg=f"cotangent mismatch for {name}")


def test_fused_op_full_grid_bf16_matches_jax(monkeypatch):
    """A bf16 stack from K6: tolerances of test_bf16_stack_matches_jax
    (value rtol 1e-5, gradients normwise 2e-2)."""
    monkeypatch.setenv("PLMC_SYM_BUILD", "0")
    calls = spy_on(monkeypatch, WRAPPERS)
    x, leaves, eps, xi, rank = make_problem(n=64, seed=5)
    vj, gj = jax_value_and_grads(x, leaves, eps, xi, rank, "matern25",
                                 cg=(100, 1e-6), bf16=True, jit=True)
    vt, gt = torch_value_and_grads(x, leaves, eps, xi, rank, "matern25",
                                   cg=(100, 1e-6), bf16=True)
    assert calls == ["scaled_kernel_stack", "lowrank_stationary_reduce"]
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    for a, b, name in zip(gt, gj, NAMES):
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 2e-2, (name, rel)


def test_int8_on_the_full_grid_is_k8_then_k7(monkeypatch):
    """matvec_int8 with PLMC_SYM_BUILD=0: K8 forward, K7 backward; the same
    value and gradients as on the symmetric grid (K2), bit for bit on the
    CPU, since both reductions are the same dense formula there."""
    x, leaves, eps, xi, rank = make_problem(n=40)
    T = [torch.tensor(a) for a in (x, *leaves, eps, xi)]
    out = {}
    for sym in ("1", "0"):
        monkeypatch.setenv("PLMC_SYM_BUILD", sym)
        calls = spy_on(monkeypatch, WRAPPERS)
        leaves_t = [a.clone().requires_grad_(True) for a in T[1:6]]
        ll = tfm.lmc_pcg_log_prob_stationary(
            T[0], *leaves_t, T[6], T[7], None, "matern25", 32, 1e-3, False,
            rank, matvec_int8=True, device="cpu")
        ll.backward()
        out[sym] = [ll.detach()] + [a.grad for a in leaves_t]
        reduce = "lowrank_stationary_reduce" + ("_sym" if sym == "1" else "")
        assert calls == ["quantized_kernel_stack", reduce]
        monkeypatch.undo()
    for a, b in zip(out["1"], out["0"]):
        assert torch.equal(a, b)
