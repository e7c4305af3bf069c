"""What the redesigned K1, K2, K4 and K5 of the PyTorch port decide or lean
on outside their CUDA code, on the CPU.

K1 (``scaled_kernel_stack_sym``) stores 16 bytes at a time where the rows of
the stack allow it: the wrapper decides that from n and the dtype. K2
(``lowrank_stationary_reduce_sym``) sums on the scaled features alone,
wx = l · Σ W (x/l), and sizes its scratch from n, the tile and d. K4 and K5
(``lowrank_stationary_reduce_sym_kr``, ``..._krs``) write only the slots a
block fills, at packed offsets, and sum them in slot order; the order is
emulated here in torch. The kernels themselves run only on the card
(``chip_smoke.py`` phase 2).
"""

import re
from pathlib import Path

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


# -- K4/K5: packed slots and the reduction order -------------------------------
# The slot layout of csrc/stationary.cu (kr_row_offset), restated here for
# the emulation; the wrappers size the buffers from the library itself
# (plmc_kr_slot_count, plmc_kr_pack_floats).

SOURCE = (Path(__file__).resolve().parent.parent / "projected_lmc_tpu_torch"
          / "csrc" / "stationary.cu").read_text()


def source_constant(name: str) -> int:
    """A ``constexpr int`` of the CUDA source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def kr_row_offset(R: int, nt: int, run: int) -> int:
    """Slots of one latent before row block R's: row block R' owns
    nt − R' + ⌊R'/run⌋ of them, the column slots of the nt−1−R' tiles
    below it, then one per run of its own column tiles."""
    g, rest = divmod(R, run)
    return R * nt - R * (R - 1) // 2 + run * g * (g - 1) // 2 + g * rest


def kr_column_slot(I: int, J: int, nt: int, run: int) -> int:
    """Slot of tile (I, J), I > J: its mirrored sums, for the rows of J."""
    return kr_row_offset(J, nt, run) + I - J - 1


def kr_run_slot(I: int, c: int, nt: int, run: int) -> int:
    """Slot of row tile I's run c (column tiles c·run .. min(c·run+run,
    I+1)): its row sums."""
    return kr_row_offset(I, nt, run) + nt - 1 - I + c


def kr_slots_shape(q: int, n: int, d: int, r: int, tile: int, run: int):
    """(q, slots of one latent, 1+d+r, tile): only the written slots."""
    nt = -(-n // tile)
    return (q, kr_row_offset(nt, nt, run), 1 + d + r, tile)


def test_kr_layout_constants_match_the_source():
    """The emulation's tile and run are the kernel's."""
    assert (source_constant("TS"), source_constant("KR_RUN")) == (64, 8)

@pytest.mark.parametrize("n, tile, run", [
    (50, 64, 8),          # below one tile
    (64, 64, 8),          # exactly one tile
    (256, 64, 8),         # a multiple of the tile
    (130, 16, 2),         # ragged, several runs a row
    (1237, 64, 8),        # ragged, the main path's tile and run
    (20_000, 64, 8),      # the main path's large n
    (700, 64, 16)])
def test_kr_slots_each_written_once(n, tile, run):
    """Every mirrored tile (I, J < I) and every run (I, c) of K4/K5 gets its
    own slot, inside the buffer; together they fill it, and each row block's
    slots are consecutive: its column slots, then its runs."""
    nt = -(-n // tile)
    seen = []
    for I in range(nt):
        for J in range(I):
            seen.append(kr_column_slot(I, J, nt, run))
        for c in range(I // run + 1):
            seen.append(kr_run_slot(I, c, nt, run))
    shape = kr_slots_shape(4, n, 4, 17, tile, run)
    assert shape[0] == 4 and shape[2:] == (22, tile)
    assert len(seen) == len(set(seen)) == shape[1]
    assert min(seen) == 0 and max(seen) == shape[1] - 1
    for R in range(nt):
        own = [kr_column_slot(I, R, nt, run) for I in range(R + 1, nt)] \
            + [kr_run_slot(R, c, nt, run) for c in range(R // run + 1)]
        start = kr_row_offset(R, nt, run)
        assert own == list(range(start, start + len(own)))


def test_kr_scratch_below_the_full_box():
    """The packed slots hold what the (q, nt, nt) box held minus the slots
    no block writes: 1.24 GB at n = 2·10⁴, q = 4, d = 4, r = 17 (2.21 GB as
    a box), 0.31 GB at n = 10⁴."""
    for n, want in ((10_000, 312_373_248), (20_000, 1_241_473_024)):
        got = 4 * int(np.prod(kr_slots_shape(4, n, 4, 17, 64, 8)))
        nt = -(-n // 64)
        assert got == want < 4 * 4 * nt * nt * 22 * 64


def kr_reduce_in_slot_order(x, ls, os_, A, Bf, kind, tile, run):
    """K4's reduction order in torch: each (latent, row tile I, run of column
    tiles) sums its rows' W, W·(x/l) and K A_J over the run; each tile
    J < I leaves its mirrored sums (W column sums, Wᵀ (x_I/l), K_IJᵀ A_I)
    in a slot of row block J; a second pass sums each row block's slots in
    slot order and multiplies wx by l."""
    q, n, r = A.shape
    d = x.shape[1]
    nt = -(-n // tile)
    pad = nt * tile - n
    s = torch.nn.functional.pad(x[None] / ls, (0, 0, 0, pad))   # (q, N, d)
    Ap = torch.nn.functional.pad(A, (0, 0, 0, pad))
    Bp = torch.nn.functional.pad(Bf, (0, 0, 0, pad))
    slots = torch.full(kr_slots_shape(q, n, d, r, tile, run), float("nan"))
    rows_of = lambda t: slice(t * tile, (t + 1) * tile)  # noqa: E731
    for I in range(nt):
        for c in range(I // run + 1):
            acc = torch.zeros((q, 1 + d + r, tile))
            for J in range(c * run, min(c * run + run, I + 1)):
                sI, sJ = s[:, rows_of(I)], s[:, rows_of(J)]
                d2 = ((sI[:, :, None] - sJ[:, None]) ** 2).sum(-1)
                W = Ap[:, rows_of(I)] @ Bp[:, rows_of(J)].transpose(1, 2) \
                    * ck.dprofile(kind, d2)
                K = ck.profile(kind, d2) * os_[:, None, None]
                acc += torch.cat([W.sum(2)[:, None], (W @ sJ).transpose(1, 2),
                                  (K @ Ap[:, rows_of(J)]).transpose(1, 2)], 1)
                if J < I:
                    slots[:, kr_column_slot(I, J, nt, run)] = torch.cat(
                        [W.sum(1)[:, None],
                         (W.transpose(1, 2) @ sI).transpose(1, 2),
                         (K.transpose(1, 2) @ Ap[:, rows_of(I)])
                         .transpose(1, 2)], 1)
            slots[:, kr_run_slot(I, c, nt, run)] = acc
    out = torch.zeros((q, 1 + d + r, nt * tile))
    for R in range(nt):
        start = kr_row_offset(R, nt, run)
        total = torch.zeros((q, 1 + d + r, tile))
        for k in range(start, start + nt - R + R // run):
            total = total + slots[:, k]
        out[:, :, rows_of(R)] = total
    out = out[:, :, :n]
    return (out[:, 0], out[:, 1:1 + d].transpose(1, 2) * ls,
            out[:, 1 + d:].transpose(1, 2))


def _kr_inputs(n=130, d=3, B=2, half=4, seed=31):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, (B, 1, d)).astype(np.float32)
    os_ = rng.uniform(0.5, 2.0, (B,)).astype(np.float32)
    U, V = rng.standard_normal((2, B, n, half)).astype(np.float32)
    # A Bfᵀ symmetric, r = 2·half + 1, as the fused backward builds them
    u0 = rng.standard_normal((B, n, 1)).astype(np.float32)
    return (x, ls, os_, np.concatenate([u0, U, V], -1),
            np.concatenate([0.5 * u0, V, U], -1))


@pytest.mark.parametrize("kind", KINDS)
def test_kr_slot_order_equals_plain(kind):
    """The slot order against K4's plain version, n = 130 in tiles of 16
    (a ragged last tile) and runs of 2: fp32 sums in another order, 1e-5 of
    each output's largest entry."""
    x, ls, os_, A, Bf = map(t32, _kr_inputs())
    got = kr_reduce_in_slot_order(x, ls, os_, A, Bf, kind, tile=16, run=2)
    want = ck.lowrank_stationary_reduce_sym_kr_plain(x, ls, os_, A, Bf, kind)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("kind", KINDS)
def test_kr_slot_order_equals_pallas(kind):
    """The same against the TPU kernel in interpret mode: the Pallas body's
    short exp2 (~2e-5 relative) and its expanded d², magnified by
    Matérn-½'s 1/r, set rows' and wx's tolerance, 1e-4 of the largest entry
    (1e-3 for Matérn-½); its KA is a bf16 pass, 2⁻⁷."""
    x, ls, os_, A, Bf = _kr_inputs()
    want = pk.lowrank_stationary_reduce_sym_kr(
        *map(jnp.asarray, (x, ls, os_, A, Bf)), kind, interpret=True)
    got = kr_reduce_in_slot_order(*map(t32, (x, ls, os_, A, Bf)), kind,
                                  tile=16, run=2)
    tol = 1e-3 if kind == "matern05" else 1e-4
    for g, w, t in zip(got, want, (tol, tol, 2.0 ** -7)):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= t * np.abs(w).max()
