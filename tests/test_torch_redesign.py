"""What the redesigned K1 and K2 of the PyTorch port decide or lean on
outside their CUDA code, on the CPU.

K1 (``scaled_kernel_stack_sym``) stores 16 bytes at a time where the rows of
the stack allow it: the wrapper decides that from n and the dtype. K2
(``lowrank_stationary_reduce_sym``) sums on the scaled features alone,
wx = l · Σ W (x/l), and sizes its scratch from n, the tile and d. The kernels
themselves run only on the card (``chip_smoke.py`` phase 2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.ops import pallas_kernels as pk
from projected_lmc_tpu_torch.ops import cuda_kernels as ck

KINDS = ["matern25", "rbf", "matern15", "matern05"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the cores are shared with parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t32(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("n, dtype, want", [
    (10_000, torch.bfloat16, 8), (20_000, torch.bfloat16, 8),
    (1240, torch.bfloat16, 8),       # aligned rows, ragged tile
    (1237, torch.bfloat16, 1), (1236, torch.bfloat16, 1),
    (50, torch.bfloat16, 1), (8, torch.bfloat16, 8),
    (10_000, torch.float32, 4), (1240, torch.float32, 4),
    (1236, torch.float32, 4),        # rows on 16 bytes in fp32, not in bf16
    (1237, torch.float32, 1), (1238, torch.float32, 1),
    (50, torch.float32, 1)])
def test_wide_store_elements(n, dtype, want):
    """A 16-byte store needs every row of the contiguous (q, n, n) stack to
    start on 16 bytes: n a multiple of 8 in bf16, of 4 in fp32."""
    assert ck.wide_store_elements(n, dtype) == want
    row_bytes = n * torch.empty((), dtype=dtype).element_size()
    assert (want > 1) == (row_bytes % 16 == 0)


@pytest.mark.parametrize("q, n, d, tile, want", [
    (4, 10_000, 4, 64, (4, 157, 157, 5, 64)),
    (4, 20_000, 4, 64, (4, 313, 313, 5, 64)),
    (1, 50, 1, 64, (1, 1, 1, 2, 64)),
    (3, 64, 8, 64, (3, 1, 1, 9, 64)),
    (2, 65, 3, 64, (2, 2, 2, 4, 64)),
    (2, 130, 2, 32, (2, 5, 5, 3, 32))])
def test_reduce_sym_slots_shape(q, n, d, tile, want):
    """One (1+d, tile) partial sum per (latent, row block, slot), nt slots a
    row block: enough for the nt−1−R tiles below row block R plus its own
    runs of column tiles, of which there are at most R+1."""
    shape = ck.reduce_sym_slots_shape(q, n, d, tile)
    assert shape == want
    nt = shape[1]
    assert (nt - 1) * tile < n <= nt * tile
    for run in (1, 8):
        assert all(nt - 1 - R + -(-(R + 1) // run) <= nt for R in range(nt))


def _reduce_inputs(seed=4, n=130, d=2, B=3, half=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, (B, 1, d)).astype(np.float32)
    U, V = rng.standard_normal((2, B, n, half)).astype(np.float32)
    # A Bfᵀ symmetric, r = 6
    return x, ls, np.concatenate([U, V], -1), np.concatenate([V, U], -1)


def reduce_on_scaled_features(x, ls, A, Bf, kind):
    """K2's arithmetic: every sum runs on s = x/l, and wx is multiplied by l
    once at the end."""
    s = x[None] / ls                                         # (B, n, d)
    d2 = ((s[:, :, None, :] - s[:, None, :, :]) ** 2).sum(-1)
    W = torch.matmul(A, Bf.transpose(-1, -2)) * ck.dprofile(kind, d2)
    return W.sum(-1), ls * torch.matmul(W, s)


@pytest.mark.parametrize("kind", KINDS)
def test_scaled_feature_sums_equal_plain(kind):
    """wx = l · Σ W (x/l) against the plain version, which sums W x: fp32
    roundings in another order, 1e-5 of the largest entry."""
    x, ls, A, Bf = map(t32, _reduce_inputs())
    rows, wx = reduce_on_scaled_features(x, ls, A, Bf, kind)
    want_rows, want_wx = ck.lowrank_stationary_reduce_sym_plain(x, ls, A, Bf,
                                                                kind)
    assert float((rows - want_rows).abs().max()) \
        <= 1e-5 * float(want_rows.abs().max())
    assert float((wx - want_wx).abs().max()) \
        <= 1e-5 * float(want_wx.abs().max())


@pytest.mark.parametrize("kind", KINDS)
def test_scaled_feature_sums_equal_pallas(kind):
    """The same against the TPU kernel in interpret mode, n = 130 (a ragged
    Pallas tile), d = 2, r = 6. The Pallas body's short exp2 (rel. err
    ~2e-5) and its expanded d², which Matérn-½'s 1/r magnifies, set the
    tolerance: 1e-4 of the largest entry, 1e-3 for Matérn-½."""
    x, ls, A, Bf = _reduce_inputs()
    rows_j, wx_j = pk.lowrank_stationary_reduce_sym(
        jnp.asarray(x), jnp.asarray(ls), jnp.asarray(A), jnp.asarray(Bf),
        kind, interpret=True)
    rows, wx = reduce_on_scaled_features(*map(t32, (x, ls, A, Bf)), kind)
    tol = 1e-3 if kind == "matern05" else 1e-4
    for got, want in ((rows, rows_j), (wx, wx_j)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_stack_exactly_symmetric(kind, dtype):
    """K1's plain version is symmetric to the bit, as the kernel's stack is
    (it writes one rounded value to both halves): (a−b)² = (b−a)² exactly,
    summed over the features in the same order."""
    rng = np.random.default_rng(9)
    x = t32(rng.standard_normal((77, 3)))
    ls = t32(rng.uniform(0.5, 1.5, (2, 1, 3)))
    os_ = t32([0.7, 1.9])
    K = ck.scaled_kernel_stack_sym(x, ls, os_, kind, dtype, device="cpu")
    assert K.shape == (2, 77, 77) and K.dtype == dtype
    assert torch.equal(K, K.transpose(-1, -2))
    assert torch.equal(K, ck.scaled_kernel_stack_sym_plain(x, ls, os_, kind,
                                                           dtype))
