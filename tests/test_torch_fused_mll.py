"""The port's fused exact-LMC MLL (``projected_lmc_tpu_torch.ops.fused_mll``)
against the JAX op, on the CPU.

Same numpy-seeded inputs, same eps and xi, tight CG: the value and every
gradient must agree to the precision the JAX package holds its own fused
op to against the composed path (tests/test_fused_mll.py: rtol 1e-10 for
the value, 1e-7 for gradients, float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.ops import fused_mll as jfm
from projected_lmc_tpu.ops import iterative as jit_
from projected_lmc_tpu.ops import pallas_kernels as pk
from projected_lmc_tpu_torch.ops import fused_mll as tfm
from projected_lmc_tpu_torch.ops import iterative as tit

NAMES = ["ls", "os", "H", "St", "Y"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run tiny torch ops in long loops: one intra-op thread
    avoids oversubscribing the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_problem(n=48, t=5, q=3, d=2, s=4, rank=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    ls = rng.uniform(0.4, 1.5, (q, 1, d))
    os_ = rng.uniform(0.5, 2.0, (q,))
    H = rng.standard_normal((t, q))
    A = rng.standard_normal((t, t)) * 0.1
    St = A @ A.T + 0.5 * np.eye(t)
    Y = rng.standard_normal((n, t))
    eps = rng.standard_normal((s, n, t))
    xi = rng.standard_normal((s, q, rank))
    return x, (ls, os_, H, St, Y), eps, xi, rank


def jax_value_and_grads(x, leaves, eps, xi, rank, kind, roots=None,
                        cg=(200, 1e-12), bf16=False, jit=False):
    """``jit`` compiles the whole op once: quicker on a first call."""
    def f(*p):
        return jfm.lmc_pcg_log_prob_stationary(
            jax.lax.stop_gradient(jnp.asarray(x)), *p, jnp.asarray(eps),
            jnp.asarray(xi), None if roots is None else jnp.asarray(roots),
            kind, cg[0], cg[1], bf16, rank)
    vg = jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4))
    v, g = (jax.jit(vg) if jit else vg)(*[jnp.asarray(a) for a in leaves])
    return float(v), [np.asarray(a) for a in g]


def torch_value_and_grads(x, leaves, eps, xi, rank, kind, roots=None,
                          cg=(200, 1e-12), bf16=False):
    T = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
         for a in leaves]
    ll = tfm.lmc_pcg_log_prob_stationary(
        torch.tensor(x), *T, torch.tensor(eps), torch.tensor(xi),
        None if roots is None else torch.tensor(roots), kind, cg[0], cg[1],
        bf16, rank, device="cpu")
    ll.backward()
    return float(ll.detach()), [a.grad.numpy() for a in T]


@pytest.mark.parametrize("kind", ["rbf", "matern25", "matern15", "matern05"])
def test_value_matches_jax(kind):
    x, leaves, eps, xi, rank = make_problem()
    vj, _ = jax_value_and_grads(x, leaves, eps, xi, rank, kind)
    vt, _ = torch_value_and_grads(x, leaves, eps, xi, rank, kind)
    np.testing.assert_allclose(vt, vj, rtol=1e-9)


@pytest.mark.parametrize("kind", ["rbf", "matern25"])
def test_gradients_match_jax(kind):
    x, leaves, eps, xi, rank = make_problem()
    vj, gj = jax_value_and_grads(x, leaves, eps, xi, rank, kind)
    vt, gt = torch_value_and_grads(x, leaves, eps, xi, rank, kind)
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    for a, b, name in zip(gt, gj, NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9,
                                   err_msg=f"cotangent mismatch for {name}")


def test_scalar_lengthscale():
    """Non-ARD (q, 1, 1) lengthscale with d = 3: dls sums over features."""
    x, leaves, eps, xi, rank = make_problem(d=3)
    ls = np.random.default_rng(7).uniform(0.5, 1.2, (3, 1, 1))
    leaves = (ls,) + leaves[1:]
    _, gj = jax_value_and_grads(x, leaves, eps, xi, rank, "matern25")
    _, gt = torch_value_and_grads(x, leaves, eps, xi, rank, "matern25")
    assert gt[0].shape == (3, 1, 1)
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-7)


def test_given_roots_and_training_cg():
    """Caller-supplied stale Nyström roots (built at other lengthscales, as
    the main path reuses one set for a 16-step chunk) and the main path's
    training CG (16 iterations, tol 2e-2): the iterations that JAX skips
    after every RHS converged change nothing in the port."""
    x, leaves, eps, xi, rank = make_problem(n=64, seed=3)
    xc = x - x.mean(0)
    stale = pk.xla_kernel_matrix(jnp.asarray(xc), jnp.asarray(xc),
                                 jnp.asarray(leaves[0] * 1.2), "matern25")
    roots = np.asarray(jit_.nystrom_roots_from_kernels(stale, rank))
    vj, gj = jax_value_and_grads(x, leaves, eps, xi, rank, "matern25",
                                 roots=roots, cg=(16, 2e-2))
    vt, gt = torch_value_and_grads(x, leaves, eps, xi, rank, "matern25",
                                   roots=roots, cg=(16, 2e-2))
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    for a, b, name in zip(gt, gj, NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9, err_msg=name)


def test_bf16_stack_matches_jax():
    """matvec_bf16: both sides round the same stack to bf16 and form fp32
    products of bf16 values (float64 elsewhere), CG run to 1e-6. The value
    agrees to ~1e-5. The backward also rounds its right-hand sides (α h, W h,
    Z̃ h) to bf16 for the stack product; values that differ by 1e-7 round
    apart now and then (one bf16 step, 4e-3), and dH's Hutchinson terms
    cancel, so the gradients are held normwise to 2e-2."""
    x, leaves, eps, xi, rank = make_problem(n=64, seed=5)
    vj, gj = jax_value_and_grads(x, leaves, eps, xi, rank, "matern25",
                                 cg=(100, 1e-6), bf16=True)
    vt, gt = torch_value_and_grads(x, leaves, eps, xi, rank, "matern25",
                                   cg=(100, 1e-6), bf16=True)
    np.testing.assert_allclose(vt, vj, rtol=1e-5)
    for a, b, name in zip(gt, gj, NAMES):
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < 2e-2, (name, rel)


def test_bf16_stack_product_keeps_fp32_result():
    """_stack_matmul on a bf16 stack returns fp32 products of the bf16
    values, never rounded to bf16."""
    rng = np.random.default_rng(6)
    Ks = torch.tensor(rng.standard_normal((2, 30, 30)),
                      dtype=torch.float32).to(torch.bfloat16)
    W = torch.tensor(rng.standard_normal((3, 30, 2)), dtype=torch.float32)
    out = tit._stack_matmul(Ks, W)
    assert out.dtype == torch.float32
    want = np.einsum("bij,rjb->rib", Ks.float().numpy(),
                     W.to(torch.bfloat16).float().numpy())
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_int8_and_wrong_device_raise():
    """matvec_int8 runs on the CPU (its parity with JAX is in
    tests/test_torch_int8.py); a device the port does not take raises."""
    x, leaves, eps, xi, rank = make_problem(n=20)
    T = [torch.tensor(a) for a in leaves]
    args = (torch.tensor(x), *T, torch.tensor(eps), torch.tensor(xi), None,
            "rbf")
    ll = tfm.lmc_pcg_log_prob_stationary(*args, max_cg_iters=16,
                                         cg_tol=1e-3, precond_rank=rank,
                                         matvec_int8=True, device="cpu")
    assert ll.dtype == torch.float64 and torch.isfinite(ll)
    with pytest.raises(ValueError):
        tfm.lmc_pcg_log_prob_stationary(*args, device="meta")
