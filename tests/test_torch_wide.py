"""The port at SARCOS's width (d = 21 input features) and K3's route with a
bf16 output, against the JAX package on the CPU.

On the card every kernel takes up to 32 features: the stack builders (K1,
K3, K6, K8) keep them in shared memory sized from d, and above 8 features
the reductions (K2, K4/K5, K7) run at a wider width that the kernel library
reports (``cuda_kernels.reduce_width``: 24 or 32), to which their wrappers
pad x with zero columns of lengthscale 1 (``pad_features``) and drop the
padded wx columns. The kernels run only on the card (``chip_smoke.py`` phase 2 and path E);
here the padding logic runs through the plain versions, the Pallas kernels
run at d = 21 in interpret mode beside the plain versions, and the fused
MLL (fp32/bf16 stack and int8 stack) is held against the JAX op, which on
the CPU takes its dense XLA branch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu import kernels as jkernels
from projected_lmc_tpu.ops import iterative as jit_
from projected_lmc_tpu.ops import pallas_kernels as pk
from projected_lmc_tpu_torch import kernels as tkernels
from projected_lmc_tpu_torch.ops import cuda_kernels as ck
from test_torch_fused_mll import (NAMES, jax_value_and_grads,
                                  torch_value_and_grads)
from test_torch_int8 import jax_int8, torch_int8

KINDS = ["matern25", "rbf", "matern15", "matern05"]
D = 21                                   # SARCOS (experiments/realdata.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the cores are shared with parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


def wide_problem(n=48, t=5, q=3, d=D, s=4, rank=16, seed=0):
    """``test_torch_fused_mll.make_problem``'s inputs at d features, the
    lengthscales scaled by √(d/2) so that the kernel is not near diagonal
    (a typical distance grows with √d)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    ls = rng.uniform(0.4, 1.5, (q, 1, d)) * np.sqrt(d / 2)
    os_ = rng.uniform(0.5, 2.0, (q,))
    H = rng.standard_normal((t, q))
    A = rng.standard_normal((t, t)) * 0.1
    St = A @ A.T + 0.5 * np.eye(t)
    Y = rng.standard_normal((n, t))
    eps = rng.standard_normal((s, n, t))
    xi = rng.standard_normal((s, q, rank))
    return x, (ls, os_, H, St, Y), eps, xi, rank


def reduce_inputs(n=61, q=2, d=D, r=5, seed=3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d))
    ls = rng.uniform(0.5, 1.5, (q, 1, d)) * np.sqrt(d / 2)
    os_ = rng.uniform(0.5, 2.0, (q,))
    U, V = rng.standard_normal((2, q, n, r))
    # A Bfᵀ symmetric, as the fused backward builds it
    return tuple(np.asarray(a, dtype) for a in
                 (x, ls, os_, np.concatenate([U, V], -1),
                  np.concatenate([V, U], -1)))


# -- the padding of the reductions' inputs ----------------------------------------

def test_pad_features_adds_zero_columns_of_unit_lengthscale():
    """What the reductions' wrappers do to x and the (q, d) lengthscales
    (``_reduce_inputs``) before a launch at the library's width."""
    x, ls, *_ = map(t32, reduce_inputs(n=30))
    xw, lw = ck.pad_features(x, ck._lengthscale_2d(ls, 2, D), 24)
    assert xw.shape == (30, 24) and lw.shape == (2, 24)
    assert torch.equal(xw[:, :D], x) and not xw[:, D:].any()
    assert torch.equal(lw[:, :D], ls[:, 0]) and torch.all(lw[:, D:] == 1)
    # a scalar lengthscale is expanded over the features first
    _, lw1 = ck.pad_features(x, ck._lengthscale_2d(ls[:, :, :1], 2, D), 32)
    assert torch.equal(lw1[:, :D], ls[:, 0, :1].expand(2, D))
    assert torch.all(lw1[:, D:] == 1)
    # at its own width (d up to 8, or a width compiled): no copy
    assert ck.pad_features(x, lw1[:, :D], D)[0] is x


# -- the padding the reductions' wrappers apply, through the plain versions ----

def padded(x, ls, width):
    """x and (q, 1, width) lengthscales as the card's wrappers pad them."""
    q, d = ls.shape[0], x.shape[1]
    # (q, d), as ``_lengthscale_2d`` gives it (that one takes fp32 alone)
    xw, lw = ck.pad_features(x, ls.reshape(q, -1).expand(q, d).contiguous(),
                             width)
    return xw, lw[:, None, :]


# d and the widths the library runs the reductions at (plmc_reduce_width:
# K2 and K7 at 24 or 32, K4/K5 at 32)
@pytest.mark.parametrize("d, width", [(9, 24), (21, 24), (21, 32), (32, 32)])
@pytest.mark.parametrize("kind", KINDS)
def test_padded_reductions_equal_plain(kind, d, width):
    """K2's, K7's, K4's and K5's plain versions on the padded inputs, wx
    cut to d, equal them on the inputs as given (float64: only the order of
    the sums over the features differs)."""
    x, ls, os_, A, Bf = map(t64, reduce_inputs(d=d, dtype=np.float64))
    C = t64(np.random.default_rng(5).standard_normal(A.shape))
    xw, lw = padded(x, ls, width)
    assert xw.shape[1] == width
    Ks = ck.scaled_kernel_stack_sym_plain(x, ls, os_, kind)
    cases = {
        "K2": (ck.lowrank_stationary_reduce_sym_plain, (A, Bf), ()),
        "K7": (ck.lowrank_stationary_reduce_plain, (A, C), ()),
        "K4": (ck.lowrank_stationary_reduce_sym_kr_plain, (os_, A, Bf), ()),
        "K5": (ck.lowrank_stationary_reduce_sym_krs_plain, (os_, A, Bf),
               (Ks,))}
    for name, (plain, args, extra) in cases.items():
        want = plain(x, ls, *args, *extra, kind)
        got = list(plain(xw, lw, *args, *extra, kind))
        assert got[1].shape[-1] == xw.shape[1]
        assert not got[1][..., d:].any(), name     # padded columns: wx = 0
        got[1] = got[1][..., :d]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12,
                                       atol=1e-12 * float(w.abs().max()),
                                       err_msg=f"{name} {kind} d={d}")


# -- the Pallas kernels at d = 21 in interpret mode ------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_quantized_stack_within_one_count_of_pallas(kind):
    """K8's plain version, square and ragged, as tests/test_torch_int8.py at
    d = 3: counts within one of the Pallas tile's (short exp2, expanded d²)."""
    x, ls, *_ = reduce_inputs(n=70)
    x2 = np.random.default_rng(6).uniform(-1, 1, (45, D)).astype(np.float32)
    for b in (x, x2):
        want = np.asarray(pk.quantized_kernel_stack(
            jnp.asarray(x), jnp.asarray(b), jnp.asarray(ls), kind,
            interpret=True)).astype(int)
        got = ck.quantized_kernel_stack(t32(x), t32(b), t32(ls), kind,
                                        padded_to=want.shape[1:],
                                        device="cpu")
        assert got.shape == want.shape
        assert np.abs(got.numpy().astype(int) - want).max() <= 1


@pytest.mark.parametrize("kind", KINDS)
def test_reductions_match_pallas(kind):
    """K7's plain version against ``lowrank_stationary_reduce`` and K2's
    against ``lowrank_stationary_reduce_sym``, n = 130 (a ragged Pallas
    tile): the Pallas bodies' short exp2 (rel. err ~2e-5) and expanded d²,
    which Matérn-½'s 1/r magnifies, set the tolerance, 1e-4 of the largest
    entry (1e-3 for Matérn-½), as at d = 2 (tests/test_torch_redesign.py)."""
    x, ls, _, A, Bf = reduce_inputs(n=130)
    tol = 1e-3 if kind == "matern05" else 1e-4
    for pallas, plain in ((pk.lowrank_stationary_reduce,
                           ck.lowrank_stationary_reduce_plain),
                          (pk.lowrank_stationary_reduce_sym,
                           ck.lowrank_stationary_reduce_sym_plain)):
        want = pallas(*map(jnp.asarray, (x, ls, A, Bf)), kind, interpret=True)
        got = plain(*map(t32, (x, ls, A, Bf)), kind)
        for g, w in zip(got, want):
            w = np.asarray(w).reshape(g.shape)
            assert np.abs(g.numpy() - w).max() <= tol * np.abs(w).max()


def test_kernel_matrix_matches_pallas():
    """K3's plain version against ``fused_kernel_matrix`` at the JAX
    package's fp32 tolerance (tests/test_torch_kernels.py)."""
    x, ls, *_ = reduce_inputs(n=70)
    z = x[::7]
    want = pk.fused_kernel_matrix(jnp.asarray(x), jnp.asarray(z),
                                  jnp.asarray(ls), "matern25", interpret=True)
    got = ck.kernel_matrix(t32(x), t32(z), t32(ls), "matern25", device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-6)


# -- the fused MLL at d = 21 --------------------------------------------------------

@pytest.mark.parametrize("kind", ["matern25", "rbf"])
def test_fused_mll_matches_jax(kind):
    """Value and gradients at d = 21, float64, tight CG: the tolerances of
    tests/test_torch_fused_mll.py (value 1e-10, gradients 1e-7)."""
    x, leaves, eps, xi, rank = wide_problem()
    vj, gj = jax_value_and_grads(x, leaves, eps, xi, rank, kind, jit=True)
    vt, gt = torch_value_and_grads(x, leaves, eps, xi, rank, kind)
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    assert gt[0].shape == (3, 1, D)
    for a, b, name in zip(gt, gj, NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9,
                                   err_msg=f"cotangent mismatch for {name}")


@pytest.mark.parametrize("kind", ["matern25", "rbf"])
def test_fused_mll_int8_matches_jax(kind):
    """The int8 stack at d = 21, float64 (tests/test_torch_int8.py): both
    sides round the same profile values to the same counts, so value rtol
    1e-9 and gradients rtol 1e-7, with the caller's Nyström roots."""
    x, leaves, eps, xi, rank = wide_problem(seed=1)
    ls = leaves[0]
    xc = x - x.mean(0)
    want_q = np.asarray(jnp.round(pk.xla_kernel_matrix(
        jnp.asarray(xc), jnp.asarray(xc), jnp.asarray(ls), kind) * 127.0
    ).astype(jnp.int8))
    got_q = ck.quantized_kernel_stack(t64(xc), t64(xc), t64(ls), kind,
                                      device="cpu")
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    roots = np.asarray(jit_.nystrom_roots_from_kernels(
        pk.xla_kernel_matrix(jnp.asarray(xc), jnp.asarray(xc),
                             jnp.asarray(ls), kind), rank))
    vj, gj = jax_int8(x, leaves, eps, xi, rank, kind, roots)
    vt, gt = torch_int8(x, leaves, eps, xi, rank, kind, roots)
    np.testing.assert_allclose(vt, vj, rtol=1e-9)
    for a, b, name in zip(gt, gj, NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9,
                                   err_msg=f"cotangent mismatch for {name}")


# -- K3's route with a bf16 output ---------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matrix_bf16_output_matches_jax(kind):
    """``stationary_kernel_matrix(out_dtype=bfloat16)`` on fp32 inputs is
    the fp32 matrix cast once (what the card now runs: K3 in fp32, then the
    cast), and agrees with the JAX ``_skm_fwd``'s XLA branch, which casts
    the same way, within one bf16 step: the two fp32 matrices differ by
    ~1e-7 (the JAX side expands d²), so an entry may round to the
    neighbouring bf16 value."""
    rng = np.random.default_rng(11)
    x1 = rng.uniform(-1, 1, (40, D)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (23, D)).astype(np.float32)
    ls = (rng.uniform(0.5, 1.5, (3, 1, D)) * np.sqrt(D / 2)).astype(np.float32)
    got = tkernels.stationary_kernel_matrix(t32(x1), t32(x2), t32(ls), kind,
                                            torch.bfloat16, device="cpu")
    full = tkernels.stationary_kernel_matrix(t32(x1), t32(x2), t32(ls), kind,
                                             device="cpu")
    assert got.dtype == torch.bfloat16 and got.shape == (3, 40, 23)
    assert torch.equal(got, full.to(torch.bfloat16))
    want, _ = jkernels._skm_fwd(jnp.asarray(x1), jnp.asarray(x2),
                                jnp.asarray(ls), kind, False, jnp.bfloat16)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-6)


def test_kernel_matrix_bf16_output_gradient_matches_jax():
    """The backward is unchanged by the bf16 output: the lengthscale and
    input gradients of Σ K ⊙ C through a bf16 matrix, against JAX's custom
    VJP of ``stationary_kernel_matrix`` on the same bf16 cotangent; fp32
    sums in another order and the two d² forms, 1e-4 of the largest entry."""
    rng = np.random.default_rng(12)
    x1 = rng.uniform(-1, 1, (40, D)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (23, D)).astype(np.float32)
    ls = (rng.uniform(0.5, 1.5, (3, 1, D)) * np.sqrt(D / 2)).astype(np.float32)
    C = rng.standard_normal((3, 40, 23)).astype(np.float32)

    def f(a, b, l):
        K = jkernels.stationary_kernel_matrix(a, b, l, "matern25", False,
                                              jnp.bfloat16)
        return jnp.sum(K.astype(jnp.float32) * C)
    gj = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x1, x2, ls)))
    leaves = [t32(a).requires_grad_(True) for a in (x1, x2, ls)]
    K = tkernels.stationary_kernel_matrix(*leaves, "matern25", torch.bfloat16,
                                          device="cpu")
    (K.float() * t32(C)).sum().backward()
    for a, b, name in zip(leaves, gj, ("x1", "x2", "ls")):
        b = np.asarray(b)
        assert np.abs(a.grad.numpy() - b).max() <= 1e-4 * np.abs(b).max(), \
            name


# -- which K8 calls are symmetric ------------------------------------------------------

def test_symmetric_call():
    """K8 mirrors lower tiles only for the same points into a square stack:
    one tensor (the fused MLL's call), or a view of the same memory."""
    x = t32(np.random.default_rng(2).standard_normal((30, D)))
    assert ck.symmetric_call(x, x, 32, 32)
    assert ck.symmetric_call(x, x[:], 32, 32)
    assert not ck.symmetric_call(x, x, 32, 40)          # a rectangular pad
    assert not ck.symmetric_call(x, x.clone(), 32, 32)  # equal, other memory
    assert not ck.symmetric_call(x, x[:20], 32, 32)
