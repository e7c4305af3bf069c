"""The fused MLL's hand-written CUDA kernels and their plain PyTorch versions.

Port of ``projected_lmc_tpu/ops/pallas_kernels.py``: one kernel for each of
its eight TPU kernels (K1–K8), and for K4, K5 and K7 a row-block form
that takes a rank's rows of the pair grid under a mesh (where XLA
partitions the TPU kernel's call). The CUDA sources are in
``csrc/stationary.cu`` (built by ``ops/_build.py`` on first use).

Each wrapper takes a ``device`` argument (default ``"cuda"``) and requires its
tensors to lie there. A CUDA tensor goes to the kernel, or the wrapper raises
(wrong dtype, shape or layout, or a refused launch). A CPU tensor, with
``device="cpu"``, goes to the plain version: the JAX package's dense XLA
formula, with d² summed from direct differences as in the kernels; the CPU
tests hold it against JAX. Each wrapper
counts its launches in ``<wrapper>.launches``, incremented only where the
kernel is launched.
"""

from __future__ import annotations

import math

import torch

from ..utils.device import check_device
from . import _build

KINDS = {"rbf": 0, "matern05": 1, "matern15": 2, "matern25": 3}


def profile(kind: str, d2):
    """Stationary profile g(d²) (pallas_kernels._profile, libm-grade exp)."""
    if kind == "rbf":
        return torch.exp(-0.5 * d2)
    r = torch.sqrt(torch.clamp(d2, min=1e-30))
    if kind == "matern05":
        return torch.exp(-r)
    if kind == "matern15":
        c = math.sqrt(3.0) * r
        return (1.0 + c) * torch.exp(-c)
    if kind == "matern25":
        c = math.sqrt(5.0) * r
        return (1.0 + c + (5.0 / 3.0) * d2) * torch.exp(-c)
    raise ValueError(f"unknown kernel kind {kind!r}")


def dprofile(kind: str, d2):
    """dg/d(d²) in closed form (pallas_kernels._dprofile)."""
    if kind == "rbf":
        return -0.5 * torch.exp(-0.5 * d2)
    r = torch.sqrt(torch.clamp(d2, min=1e-30))
    if kind == "matern05":
        # non-differentiable at r = 0: the symmetric subgradient 0
        return torch.where(d2 <= 1e-12, torch.zeros_like(d2),
                           -torch.exp(-r) / (2.0 * r))
    if kind == "matern15":
        return -1.5 * torch.exp(-math.sqrt(3.0) * r)
    if kind == "matern25":
        return (-5.0 / 6.0) * (1.0 + math.sqrt(5.0) * r) \
            * torch.exp(-math.sqrt(5.0) * r)
    raise ValueError(f"unknown kernel kind {kind!r}")


def _sqdist_scaled(x1, x2, lengthscale):
    """(B, n, m) squared distances of x1/l_b and x2/l_b, summed from direct
    differences as the CUDA kernels do. (The JAX package's XLA path expands
    |a|² + |b|² − 2⟨a, b⟩, whose fp32 cancellation leaves d² ~ 1e-8 instead
    of 0 for coincident points — which the Matérn-½ profile, non-smooth at 0,
    turns into errors of 1e-4 in g and 1e3 in g′.)"""
    a = x1[None] / lengthscale
    b = x2[None] / lengthscale
    return ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)


# -- launch plumbing ----------------------------------------------------------

def _kind_id(kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}")
    return KINDS[kind]


def _require(name: str, t, shape):
    """A CUDA kernel takes contiguous fp32 tensors of the given shape."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")


def _features(x):
    """x's feature count d, which the kernels must take (1..32, as the
    library reports)."""
    d = x.shape[-1]
    most = _build.library().plmc_max_features()
    if not 1 <= d <= most:
        raise NotImplementedError(
            f"the CUDA kernels take 1..{most} input features, got {d}")
    return d


def reduce_width(d: int, kr: bool = False) -> int:
    """The feature count at which the library runs a reduction for d
    features (K4/K5 with ``kr``, else K2 and K7): d itself up to 8, else a
    wider width compiled for it, to which the wrapper pads x."""
    width = _build.library().plmc_reduce_width(d, int(kr))
    if width == 0:
        raise NotImplementedError(
            f"the CUDA kernels take 1..{_build.library().plmc_max_features()}"
            f" input features, got {d}")
    return width


def pad_features(x, ls, width: int):
    """x (n, d) and lengthscales (q, d) widened to ``width`` features: zero
    columns of x with lengthscale 1. Each adds exactly 0 to the squared
    distances, which the kernels sum from direct differences, and has a wx
    column of 0, which the caller drops."""
    n, d = x.shape
    if width == d:
        return x, ls
    xw = torch.zeros((n, width), dtype=x.dtype, device=x.device)
    xw[:, :d] = x
    lw = torch.ones((ls.shape[0], width), dtype=ls.dtype, device=ls.device)
    lw[:, :d] = ls
    return xw, lw


def _lengthscale_2d(lengthscale, q, d):
    """(q, 1, d) or (q, 1, 1) lengthscales as a contiguous (q, d) array."""
    if lengthscale.dtype != torch.float32:
        raise TypeError(f"lengthscale: the CUDA kernel takes float32, got "
                        f"{lengthscale.dtype}")
    if lengthscale.shape[0] != q or lengthscale.shape[-1] not in (1, d):
        raise ValueError(f"lengthscale of shape {tuple(lengthscale.shape)} does "
                         f"not fit {q} latents and {d} features")
    return lengthscale.reshape(q, -1).expand(q, d).contiguous()


def _launch(fn_name: str, *args):
    err = getattr(_build.library(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _out_dtype(out_dtype):
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    return out_dtype or torch.float32


# -- K1: symmetric scaled kernel stack ----------------------------------------

def scaled_kernel_stack_sym_plain(x, lengthscale, outputscale, kind: str,
                                  out_dtype=None):
    """os_b · g(|x_i/l_b − x_j/l_b|²), (q, n, n): the dense formula of
    ``fused_mll._scaled_stack``'s XLA branch."""
    return scaled_kernel_stack_plain(x, x, lengthscale, outputscale, kind,
                                     out_dtype)


def wide_store_elements(row: int, dtype) -> int:
    """Elements of one 16-byte store into a contiguous (q, n, ``row``)
    output of ``dtype`` (8 in bf16, 4 in fp32) when every row starts on a
    16-byte boundary, else 1: the kernel then stores element by element.
    K1's wrapper passes it for its (q, n, n) stack; the K3/K6 launcher
    applies the same rule to the row width m of its (q, n, m) grid."""
    per_store = 16 // torch.empty((), dtype=dtype).element_size()
    return per_store if row % per_store == 0 else 1


def scaled_kernel_stack_sym(x, lengthscale, outputscale, kind: str,
                            out_dtype=None, device="cuda"):
    """K1. os_b · K_b(x, x) for the symmetric training stack, (q, n, n),
    fp32 or bf16 (``out_dtype``).

    Replaces ``scaled_kernel_stack_sym`` (projected_lmc_tpu/ops/
    pallas_kernels.py:278; body ``_scaled_tile_kernel_tri`` :225) and its
    aliased mirror pass ``_symmetrize_lower`` (:247, body ``_mirror_tile``).
    Bound on the card: the write of the stack, q·n²·2 bytes in bf16 (800 MB
    at n = 10⁴, q = 4). Design (bf16): each block evaluates one lower
    128 × 128 tile once (sqrt and exp for half the pairs), each thread an
    8 × 8 block in registers, rounded once to bf16; a row's 8 values leave
    as one 16-byte store to the tile and a column's 8 as one 16-byte store
    to the mirrored tile, so the two halves are the same bits and nothing
    is staged in shared memory. It writes exactly (q, n, n): where the rows
    do not start on 16 bytes (``wide_store_elements`` is 1) it stores
    element by element, bounds-checked. It uses the card's exp2 and
    reciprocal square root (MUFU.EX2, MUFU.RSQ; rel. err ~1e-6 ≪ bf16's
    2⁻⁸). An fp32 stack is K6's kernel on (x, x) (see
    ``scaled_kernel_stack``; a square root within an ulp and libm expf),
    which measured faster on the card than mirrored fp32 tiles, and is
    bitwise symmetric."""
    dev = check_device(device, x, lengthscale, outputscale)
    if dev.type == "cpu":
        return scaled_kernel_stack_sym_plain(x, lengthscale, outputscale, kind,
                                             out_dtype)
    n = x.shape[0]
    d = _features(x)
    q = lengthscale.shape[0]
    dtype = _out_dtype(out_dtype)
    _require("x", x, (n, d))
    _require("outputscale", outputscale, (q,))
    ls = _lengthscale_2d(lengthscale, q, d)
    out = torch.empty((q, n, n), dtype=dtype, device=x.device)
    _launch("plmc_scaled_stack_sym", x.data_ptr(), ls.data_ptr(),
            outputscale.data_ptr(), out.data_ptr(), q, n, d, _kind_id(kind),
            int(dtype == torch.bfloat16),
            int(wide_store_elements(n, dtype) > 1), _stream(x))
    scaled_kernel_stack_sym.launches += 1
    return out


scaled_kernel_stack_sym.launches = 0


# -- K2: symmetric low-rank cotangent reduction -------------------------------

def _reduce_inputs(x, lengthscale, A, Bf, kr=False):
    """The checks shared by the reductions (K2, K4/K5, K7), and their x and
    (q, d) lengthscales padded to ``reduce_width(d, kr)`` features:
    (x, ls, d)."""
    n = x.shape[0]
    d = _features(x)
    q, _, r = A.shape
    _require("x", x, (n, d))
    _require("A", A, (q, n, r))
    _require("Bf", Bf, (q, n, r))
    x, ls = pad_features(x, _lengthscale_2d(lengthscale, q, d),
                         reduce_width(d, kr))
    return x, ls, d


def _drop_padding(wx, d):
    """wx (q, n, width) of a padded call → its first d features."""
    return wx if wx.shape[-1] == d else wx[..., :d].contiguous()


def lowrank_stationary_reduce_sym_plain(x, lengthscale, A, Bf, kind: str):
    """(rows, wx) with W_b = (A_b Bf_bᵀ) ⊙ g′(d²_b): rows[b,i] = Σ_j W_bij,
    wx[b,i,:] = Σ_j W_bij x_j — ``fused_mll._lowrank_reduce``'s dense branch."""
    d2 = _sqdist_scaled(x, x, lengthscale)
    W = torch.matmul(A, Bf.transpose(-1, -2)) * dprofile(kind, d2)
    return W.sum(-1), torch.matmul(W, x)


def reduce_sym_slots_shape(q: int, n: int, d: int, tile: int):
    """Shape of K2's fp32 scratch: for each (latent, row block of ``tile``
    rows) up to nt = ⌈n/tile⌉ partial sums of (1+d, tile) — the column sums
    of the nt−1−R tiles below row block R, then the row sums of its own
    runs of column tiles (never more than R+1)."""
    nt = -(-n // tile)
    return (q, nt, nt, 1 + d, tile)


def lowrank_stationary_reduce_sym(x, lengthscale, A, Bf, kind: str,
                                  device="cuda"):
    """K2. rows (q, n) and wx (q, n, d) of the SYMMETRIC low-rank kernel
    cotangent W_b = (A_b Bf_bᵀ) ⊙ g′(d²_b) (A Bfᵀ = Bf Aᵀ, as the fused
    MLL's factor construction guarantees), without forming dK or W.

    Replaces ``lowrank_stationary_reduce_sym`` (projected_lmc_tpu/ops/
    pallas_kernels.py:470; body ``_lowrank_vjp_tile_sym`` :406). Bound on
    the card: arithmetic — per unordered pair a rank-r dot product
    (r = 1 + 2·probes = 17), d², a sqrt and an exp, 2(1+d) accumulations;
    the factors are only ~11 MB at n = 10⁴. Design: a block owns (latent,
    row tile, a run of 8 lower column tiles) and walks the run with its
    row sums in registers; a thread's 4 × 4 block of each 64 × 64 tile is
    adjacent rows and columns, read from shared memory 16 bytes at a time.
    The sums run on the scaled features alone, wx = l · Σ W (x/l). Only
    each tile's mirrored column sums, and one set of row sums per run,
    leave the block, each into its own slot of a (q, nt, nt, 1+d, 64)
    buffer that a second kernel sums in slot order: no float atomics, the
    same bits on every run. (The TPU kernel's resident full-height
    accumulator works around a Mosaic race that Hopper does not have, and
    is not carried.)"""
    dev = check_device(device, x, lengthscale, A, Bf)
    if dev.type == "cpu":
        return lowrank_stationary_reduce_sym_plain(x, lengthscale, A, Bf, kind)
    x, ls, d = _reduce_inputs(x, lengthscale, A, Bf)
    q, n, r = A.shape
    w = x.shape[1]
    tile = _build.library().plmc_tile_size()
    slots = torch.empty(reduce_sym_slots_shape(q, n, w, tile),
                        dtype=torch.float32, device=x.device)
    rows = torch.empty((q, n), dtype=torch.float32, device=x.device)
    wx = torch.empty((q, n, w), dtype=torch.float32, device=x.device)
    _launch("plmc_lowrank_reduce_sym", x.data_ptr(), ls.data_ptr(),
            A.data_ptr(), Bf.data_ptr(), slots.data_ptr(), rows.data_ptr(),
            wx.data_ptr(), q, n, r, w, _kind_id(kind), _stream(x))
    lowrank_stationary_reduce_sym.launches += 1
    return rows, _drop_padding(wx, d)


lowrank_stationary_reduce_sym.launches = 0


# -- K4, K5: the one-pass backward (reductions plus KA) -----------------------

def lowrank_stationary_reduce_sym_kr_plain(x, lengthscale, outputscale, A, Bf,
                                           kind: str):
    """(rows, wx, KA): K2's reductions and KA_b = (os_b · K_b) A_b —
    ``fused_mll._lowrank_reduce_kr``'s dense branch."""
    d2 = _sqdist_scaled(x, x, lengthscale)
    W = torch.matmul(A, Bf.transpose(-1, -2)) * dprofile(kind, d2)
    K = profile(kind, d2) * outputscale[:, None, None]
    return W.sum(-1), torch.matmul(W, x), torch.matmul(K, A)


def _dprofile_from_stack(kind: str, x, lengthscale, outputscale, Kf, x2=None):
    """g′(d²) recovered from the os-scaled stack values Kf = os_b·g by the
    rational identity of ``pallas_kernels._lowrank_vjp_tile_sym_krs``, no
    exp: it carries the stack's own rounding. ``x2``: the columns' points
    of a (q, n1, n2) block (x itself when None)."""
    inv_os = (1.0 / outputscale)[:, None, None]
    if kind == "rbf":
        return -0.5 * inv_os * Kf
    d2 = _sqdist_scaled(x, x if x2 is None else x2, lengthscale)
    r = torch.sqrt(torch.clamp(d2, min=1e-30))
    if kind == "matern05":
        return torch.where(d2 <= 1e-12, torch.zeros_like(d2),
                           -0.5 * inv_os * Kf / r)
    if kind == "matern15":
        return -1.5 * inv_os * Kf / (1.0 + math.sqrt(3.0) * r)
    if kind == "matern25":
        c = math.sqrt(5.0) * r
        return (-5.0 / 6.0) * inv_os * Kf * (1.0 + c) \
            / (1.0 + c + (5.0 / 3.0) * d2)
    raise ValueError(f"unknown kernel kind {kind!r}")


def lowrank_stationary_reduce_sym_krs_plain(x, lengthscale, outputscale, A, Bf,
                                            Ks, kind: str):
    """K4's (rows, wx, KA) from the stored symmetric stack ``Ks``
    (q, n, n), os-scaled: g′ by the rational identity, KA = Ks·A."""
    Kf = Ks.to(A.dtype)
    gp = _dprofile_from_stack(kind, x, lengthscale, outputscale, Kf)
    W = torch.matmul(A, Bf.transpose(-1, -2)) * gp
    return W.sum(-1), torch.matmul(W, x), torch.matmul(Kf, A)


def kr_scratch_shapes(q: int, n: int, d: int, r: int):
    """Shapes of K4/K5's two fp32 scratch buffers, as the kernel library
    sizes them: the pack of the factors, (q, nt, floats of one tile's
    pack), and the slots, (q, slots of one latent, 1+d+r, tile) — only the
    slots that are written (every lower tile's mirrored side, every run's
    rows), packed by row block."""
    lib = _build.library()
    tile = lib.plmc_tile_size()
    nt = -(-n // tile)
    return ((q, nt, lib.plmc_kr_pack_floats(r, d)),
            (q, lib.plmc_kr_slot_count(nt), 1 + d + r, tile))


def _kr_launch(fn_name, x, lengthscale, outputscale, A, Bf, Ks, kind):
    """Checks, scratch and outputs shared by K4 and K5 (``Ks`` None for K4)."""
    x, ls, d = _reduce_inputs(x, lengthscale, A, Bf, kr=True)
    q, n, r = A.shape
    w = x.shape[1]
    _require("outputscale", outputscale, (q,))
    pack_shape, slots_shape = kr_scratch_shapes(q, n, w, r)
    pack = torch.empty(pack_shape, dtype=torch.float32, device=x.device)
    slots = torch.empty(slots_shape, dtype=torch.float32, device=x.device)
    rows = torch.empty((q, n), dtype=torch.float32, device=x.device)
    wx = torch.empty((q, n, w), dtype=torch.float32, device=x.device)
    ka = torch.empty((q, n, r), dtype=torch.float32, device=x.device)
    head = (x.data_ptr(), ls.data_ptr(), outputscale.data_ptr(), A.data_ptr(),
            Bf.data_ptr())
    tail = (pack.data_ptr(), slots.data_ptr(), rows.data_ptr(),
            wx.data_ptr(), ka.data_ptr(), q, n, r, w, _kind_id(kind))
    if Ks is None:
        _launch(fn_name, *head, *tail, _stream(x))
    else:
        _launch(fn_name, *head, Ks.data_ptr(), *tail,
                int(Ks.dtype == torch.bfloat16), _stream(x))
    return rows, _drop_padding(wx, d), ka


def lowrank_stationary_reduce_sym_kr(x, lengthscale, outputscale, A, Bf,
                                     kind: str, device="cuda"):
    """K4. (rows (q, n), wx (q, n, d), KA (q, n, r)) in one pass: K2's
    reductions of the symmetric W_b = (A_b Bf_bᵀ) ⊙ g′(d²_b) and
    KA_b = (os_b · K_b) A_b, which replaces the backward's stack product.

    Replaces ``lowrank_stationary_reduce_sym_kr`` (projected_lmc_tpu/ops/
    pallas_kernels.py:630; body ``_lowrank_vjp_tile_sym_kr`` :524). Bound
    on the card: arithmetic — K2's per-pair work (rank-r product, d², one
    exp for g and g′, the W sums) in fp32; KA's 4r operations a pair, one
    bf16 pass as in the TPU kernel, run on the tensor cores beside it, not
    after it. Design: K2's (a block
    walks a run of lower tiles of one row tile with its row sums in
    registers; adjacent 4 × 4 blocks, 16-byte shared loads, sums on x/l,
    rsqrt and ex2), with os·g of each tile left in shared memory as bf16
    hi and lo parts; both KA products run from there on the tensor cores
    (``mma.sync`` fed by ``ldmatrix``) as hi·hi + hi·lo + lo·hi of the
    splits of K and A, ~2⁻¹⁷ relative. A first kernel packs the factors
    (``kr_scratch_shapes``) so that a block copies a tile's by ``cp.async``.
    Only each tile's mirrored sums (W column sums, K_IJᵀ A_I) and one set
    of row sums per run (W row sums, Σ_J K_IJ A_J) leave the block, each
    into its own slot of a packed fp32 buffer (``kr_scratch_shapes``: 1.24 GB
    at n = 2·10⁴, q = 4, d = 4, r = 17), which a last kernel sums in slot
    order: no float atomics, the same bits on every run."""
    dev = check_device(device, x, lengthscale, outputscale, A, Bf)
    if dev.type == "cpu":
        return lowrank_stationary_reduce_sym_kr_plain(x, lengthscale,
                                                      outputscale, A, Bf, kind)
    out = _kr_launch("plmc_lowrank_reduce_sym_kr", x, lengthscale,
                     outputscale, A, Bf, None, kind)
    lowrank_stationary_reduce_sym_kr.launches += 1
    return out


lowrank_stationary_reduce_sym_kr.launches = 0


def lowrank_stationary_reduce_sym_krs(x, lengthscale, outputscale, A, Bf, Ks,
                                      kind: str, device="cuda"):
    """K5. K4's (rows, wx, KA), reading the stored os-scaled symmetric stack
    ``Ks`` (q, n, n), fp32 or bf16, instead of recomputing it: g′ comes from
    the stack value by a rational identity (no exp), so the results carry
    the stack's rounding.

    Replaces ``lowrank_stationary_reduce_sym_krs`` (projected_lmc_tpu/ops/
    pallas_kernels.py:798; body ``_lowrank_vjp_tile_sym_krs`` :703). Bound:
    K4's arithmetic less the exp, plus the read of the stack's lower half.
    Design: K4's, with each lower tile read from the stack in place of its
    evaluation, 16 bytes a load (``cp.async`` for a bf16 stack) where the
    rows start on 16 bytes (n a multiple of 8 in bf16, of 4 in fp32),
    element by element otherwise, and g′ from it with one reciprocal; a
    bf16 stack is its own hi part, so its KA products are two bf16
    products, not three."""
    dev = check_device(device, x, lengthscale, outputscale, A, Bf, Ks)
    if dev.type == "cpu":
        return lowrank_stationary_reduce_sym_krs_plain(
            x, lengthscale, outputscale, A, Bf, Ks, kind)
    n = x.shape[0]
    if Ks.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Ks: the CUDA kernel takes float32 or bfloat16, got "
                        f"{Ks.dtype}")
    if tuple(Ks.shape) != (A.shape[0], n, n) or not Ks.is_contiguous():
        raise ValueError(f"Ks: expected a contiguous ({A.shape[0]}, {n}, {n}) "
                         f"stack, got {tuple(Ks.shape)}")
    out = _kr_launch("plmc_lowrank_reduce_sym_krs", x, lengthscale,
                     outputscale, A, Bf, Ks, kind)
    lowrank_stationary_reduce_sym_krs.launches += 1
    return out


lowrank_stationary_reduce_sym_krs.launches = 0


# -- K4, K5: their row-block forms (a rank's rows under a mesh) ---------------

def lowrank_stationary_reduce_rows_kr_plain(x1, x2, lengthscale, outputscale,
                                            Bf, A, kind: str):
    """(rows (q, n1), wx (q, n1, d), KA (q, n1, r)) over rows x1 with the
    row factor Bf (q, n1, r) against columns x2 with the column factor A
    (q, n2, r): W_b = (Bf_b A_bᵀ) ⊙ g′(d²(x1, x2)_b), its row sums and
    W x2, and KA_b = (os_b · K_b(x1, x2)) A_b. For a symmetric A Bfᵀ (the
    fused MLL's) and x1 = x[lo:hi], these are rows lo..hi − 1 of the square
    plain version's (rows, wx, KA) on x with A and Bf."""
    d2 = _sqdist_scaled(x1, x2, lengthscale)
    W = torch.matmul(Bf, A.transpose(-1, -2)) * dprofile(kind, d2)
    K = profile(kind, d2) * outputscale[:, None, None]
    return W.sum(-1), torch.matmul(W, x2), torch.matmul(K, A)


def lowrank_stationary_reduce_rows_krs_plain(x1, x2, lengthscale,
                                             outputscale, Bf, A, Ks,
                                             kind: str):
    """:func:`lowrank_stationary_reduce_rows_kr_plain` from the stored
    os-scaled block ``Ks`` (q, n1, n2): g′ by the rational identity,
    KA = Ks·A."""
    Kf = Ks.to(A.dtype)
    gp = _dprofile_from_stack(kind, x1, lengthscale, outputscale, Kf, x2)
    W = torch.matmul(Bf, A.transpose(-1, -2)) * gp
    return W.sum(-1), torch.matmul(W, x2), torch.matmul(Kf, A)


def kr_rows_scratch_shapes(q: int, n1: int, n2: int, d: int, r: int):
    """Shapes of the row-block forms' three fp32 scratch buffers, as the
    library sizes them: the packs of the row tiles and of the column tiles,
    (q, nt1, P) and (q, nt2, P), P K4's pack of a tile, and the slots,
    (q, nt1, runs of the nt2 column tiles, 1+d+r, tile)."""
    lib = _build.library()
    tile = lib.plmc_tile_size()
    nt1, nt2 = -(-n1 // tile), -(-n2 // tile)
    floats = lib.plmc_kr_pack_floats(r, d)
    return ((q, nt1, floats), (q, nt2, floats),
            (q, nt1, lib.plmc_kr_rows_runs(nt2), 1 + d + r, tile))


def _kr_rows_launch(fn_name, x1, x2, lengthscale, outputscale, Bf, A, Ks,
                    kind):
    """Checks, scratch and outputs shared by K4's and K5's row-block forms
    (``Ks`` None for K4's)."""
    n1, n2 = x1.shape[0], x2.shape[0]
    d = _features(x2)
    q, _, r = A.shape
    _require("x1", x1, (n1, d))
    _require("x2", x2, (n2, d))
    _require("Bf", Bf, (q, n1, r))
    _require("A", A, (q, n2, r))
    _require("outputscale", outputscale, (q,))
    width = reduce_width(d, kr=True)
    ls2 = _lengthscale_2d(lengthscale, q, d)
    x1, ls = pad_features(x1, ls2, width)
    x2, _ = pad_features(x2, ls2, width)
    p1_shape, p2_shape, slots_shape = kr_rows_scratch_shapes(q, n1, n2,
                                                             width, r)
    pack1 = torch.empty(p1_shape, dtype=torch.float32, device=x1.device)
    pack2 = torch.empty(p2_shape, dtype=torch.float32, device=x1.device)
    slots = torch.empty(slots_shape, dtype=torch.float32, device=x1.device)
    rows = torch.empty((q, n1), dtype=torch.float32, device=x1.device)
    wx = torch.empty((q, n1, width), dtype=torch.float32, device=x1.device)
    ka = torch.empty((q, n1, r), dtype=torch.float32, device=x1.device)
    head = (x1.data_ptr(), x2.data_ptr(), ls.data_ptr(),
            outputscale.data_ptr(), Bf.data_ptr(), A.data_ptr())
    tail = (pack1.data_ptr(), pack2.data_ptr(), slots.data_ptr(),
            rows.data_ptr(), wx.data_ptr(), ka.data_ptr(), q, n1, n2, r,
            width, _kind_id(kind))
    if Ks is None:
        _launch(fn_name, *head, *tail, _stream(x1))
    else:
        _launch(fn_name, *head, Ks.data_ptr(), *tail,
                int(Ks.dtype == torch.bfloat16), _stream(x1))
    return rows, _drop_padding(wx, d), ka


def lowrank_stationary_reduce_rows_kr(x1, x2, lengthscale, outputscale, Bf, A,
                                      kind: str, device="cuda"):
    """K4's row-block form, a rank's rows of the "kr" backward under a mesh:
    (rows (q, n1), wx (q, n1, d), KA (q, n1, r)) of
    :func:`lowrank_stationary_reduce_rows_kr_plain` in one pass, the block
    os·K(x1, x2) recomputed, never stored.

    Replaces ``lowrank_stationary_reduce_sym_kr`` (projected_lmc_tpu/ops/
    pallas_kernels.py:630) on a rank's row block, where XLA partitions the
    TPU kernel's call. Bound on the card: arithmetic — K4's per-pair work
    (the rank-r product, d², one exp for g and g′, the W sums) over the
    q·n1·n2 ordered pairs, and one KA product (2r bf16 operations, three
    times over) a pair. Design: K4's tile loop without the mirror, as K7's
    row-block form is K7's: the row tiles packed from (x1, Bf), the column
    tiles from (x2, A) by K4's pack kernel; a block walks a run of 8 column
    tiles with its rows' sums in registers and os·g of each tile in shared
    memory as bf16 hi and lo parts, K_IJ A_J on the tensor cores (K4's
    ``mma.sync`` split products), each run's sums into its own slot, summed
    in run order by a last kernel: no float atomics, and a row's results do
    not depend on the block of rows it lies in."""
    dev = check_device(device, x1, x2, lengthscale, outputscale, Bf, A)
    if dev.type == "cpu":
        return lowrank_stationary_reduce_rows_kr_plain(
            x1, x2, lengthscale, outputscale, Bf, A, kind)
    out = _kr_rows_launch("plmc_lowrank_reduce_rows_kr", x1, x2, lengthscale,
                          outputscale, Bf, A, None, kind)
    lowrank_stationary_reduce_rows_kr.launches += 1
    return out


lowrank_stationary_reduce_rows_kr.launches = 0


def lowrank_stationary_reduce_rows_krs(x1, x2, lengthscale, outputscale, Bf,
                                       A, Ks, kind: str, device="cuda"):
    """K5's row-block form, a rank's rows of the "krs" backward under a mesh:
    :func:`lowrank_stationary_reduce_rows_kr`'s (rows, wx, KA) reading the
    rank's stored os-scaled block ``Ks`` (q, n1, n2), fp32 or bf16 (K6's),
    g′ by the rational identity.

    Replaces ``lowrank_stationary_reduce_sym_krs`` (projected_lmc_tpu/ops/
    pallas_kernels.py:798) on a rank's row block. Bound: the row-block
    K4's arithmetic less the exp, plus the read of the block. Design: the
    row-block K4's, each tile (I, J) read from the block, whose rows are
    n2 elements apart, 16 bytes a load (``cp.async`` in bf16) where they
    start on 16 bytes, element by element otherwise."""
    dev = check_device(device, x1, x2, lengthscale, outputscale, Bf, A, Ks)
    if dev.type == "cpu":
        return lowrank_stationary_reduce_rows_krs_plain(
            x1, x2, lengthscale, outputscale, Bf, A, Ks, kind)
    n1, n2 = x1.shape[0], x2.shape[0]
    if Ks.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Ks: the CUDA kernel takes float32 or bfloat16, got "
                        f"{Ks.dtype}")
    if tuple(Ks.shape) != (A.shape[0], n1, n2) or not Ks.is_contiguous():
        raise ValueError(f"Ks: expected a contiguous ({A.shape[0]}, {n1}, "
                         f"{n2}) block, got {tuple(Ks.shape)}")
    out = _kr_rows_launch("plmc_lowrank_reduce_rows_krs", x1, x2, lengthscale,
                          outputscale, Bf, A, Ks, kind)
    lowrank_stationary_reduce_rows_krs.launches += 1
    return out


lowrank_stationary_reduce_rows_krs.launches = 0


# -- K3: general cross kernel matrix ------------------------------------------

def kernel_matrix_plain(x1, x2, lengthscale, kind: str):
    """g(|x1_i/l_b − x2_j/l_b|²), (B, n, m) (pallas_kernels.xla_kernel_matrix
    with direct-difference d²)."""
    return profile(kind, _sqdist_scaled(x1, x2, lengthscale))


def kernel_matrix(x1, x2, lengthscale, kind: str, device="cuda"):
    """K3. The general cross-kernel forward g(d²), (q, n, m), fp32.

    Replaces ``_pallas_forward`` of ``fused_kernel_matrix`` (projected_lmc_tpu/
    ops/pallas_kernels.py:912 and :881; body ``_tile_kernel`` :76). Bound on
    the card: the (q, n, m) fp32 write (41 MB for the Nyström cross block at
    n = 10⁴, m = 256). Design: K6's kernel at os = 1 (see
    ``scaled_kernel_stack``), so its values are K6's fp32 ones bit for bit;
    16-byte stores where m is a multiple of 4. Its gradient is the
    plain-torch backward of ``kernels.stationary_kernel_matrix``, as the TPU
    kernel's VJP is XLA."""
    dev = check_device(device, x1, x2, lengthscale)
    if dev.type == "cpu":
        return kernel_matrix_plain(x1, x2, lengthscale, kind)
    n, m = x1.shape[0], x2.shape[0]
    d = _features(x1)
    q = lengthscale.shape[0]
    _require("x1", x1, (n, d))
    _require("x2", x2, (m, d))
    ls = _lengthscale_2d(lengthscale, q, d)
    out = torch.empty((q, n, m), dtype=torch.float32, device=x1.device)
    _launch("plmc_kernel_matrix", x1.data_ptr(), x2.data_ptr(), ls.data_ptr(),
            out.data_ptr(), q, n, m, d, _kind_id(kind), _stream(x1))
    kernel_matrix.launches += 1
    return out


kernel_matrix.launches = 0


# -- K6: full-grid scaled kernel stack -----------------------------------------

def scaled_kernel_stack_plain(x1, x2, lengthscale, outputscale, kind: str,
                              out_dtype=None):
    """os_b · g(|x1_i/l_b − x2_j/l_b|²), (q, n, m), in ``out_dtype``."""
    K = kernel_matrix_plain(x1, x2, lengthscale, kind) \
        * outputscale[:, None, None]
    return K if out_dtype is None else K.to(out_dtype)


def scaled_kernel_stack(x1, x2, lengthscale, outputscale, kind: str,
                        out_dtype=None, device="cuda"):
    """K6. os_b · K_b(x1, x2) over the full (q, n, m) grid, fp32 or bf16
    (``out_dtype``); x1 and x2 may differ. Not differentiable: the fused
    MLL owns the gradient.

    Replaces ``scaled_kernel_stack`` (projected_lmc_tpu/ops/
    pallas_kernels.py:130; body ``_scaled_tile_kernel`` :110), the
    forward of the fused MLL under ``PLMC_SYM_BUILD=0``. Bound on the card:
    the write, q·n·m·2 bytes in bf16 (800 MB at n = m = 10⁴, q = 4), just
    above the arithmetic of the n·m pairs. Design: K1's on the rectangle —
    one block per (latent, 128 × 128 tile), each thread an 8 × 8 block in
    registers with d² summed as K1 sums it and K1's profile of the output
    type (the card's exp2 and reciprocal square root in bf16, libm expf in
    fp32), so that on (x, x) it gives K1's stack bit for bit; every pair is
    evaluated, no mirror. A row's 8 values leave as 16-byte stores where
    the rows start on 16 bytes (the kernel's launcher decides it from the
    row width m: a multiple of 8 in bf16, of 4 in fp32), else element by
    element, bounds-checked; it writes exactly (q, n, m), never a padded
    stack."""
    dev = check_device(device, x1, x2, lengthscale, outputscale)
    if dev.type == "cpu":
        return scaled_kernel_stack_plain(x1, x2, lengthscale, outputscale,
                                         kind, out_dtype)
    n, m = x1.shape[0], x2.shape[0]
    d = _features(x1)
    q = lengthscale.shape[0]
    dtype = _out_dtype(out_dtype)
    _require("x1", x1, (n, d))
    _require("x2", x2, (m, d))
    _require("outputscale", outputscale, (q,))
    ls = _lengthscale_2d(lengthscale, q, d)
    out = torch.empty((q, n, m), dtype=dtype, device=x1.device)
    _launch("plmc_scaled_stack", x1.data_ptr(), x2.data_ptr(), ls.data_ptr(),
            outputscale.data_ptr(), out.data_ptr(), q, n, m, d, _kind_id(kind),
            int(dtype == torch.bfloat16), _stream(x1))
    scaled_kernel_stack.launches += 1
    return out


scaled_kernel_stack.launches = 0


# -- K7: full-grid low-rank cotangent reduction -------------------------------

# K2's plain version is already the full-grid formula: it assumes no symmetry
lowrank_stationary_reduce_plain = lowrank_stationary_reduce_sym_plain


def lowrank_stationary_reduce_rows_plain(x1, x2, lengthscale, A, Bf,
                                         kind: str):
    """K7's row-block form, plain: rows (q, n1) and wx (q, n1, d) of
    W_b = (A_b Bf_bᵀ) ⊙ g′(d²(x1, x2)_b) for A (q, n1, r) with x1 and Bf
    (q, n2, r) with x2 — the dense formula on the rectangle, whose rows are
    those of the square formula on x = x2 at x1 = x2[lo:hi]."""
    d2 = _sqdist_scaled(x1, x2, lengthscale)
    W = torch.matmul(A, Bf.transpose(-1, -2)) * dprofile(kind, d2)
    return W.sum(-1), torch.matmul(W, x2)


def reduce_scratch_shapes(q: int, n: int, d: int, r: int):
    """Shapes of K7's two fp32 scratch buffers, as the kernel library sizes
    them: the pack of the factors, (q, nt, floats of one tile's pack), and
    the slots, (q, nt, runs a row tile, 1+d, tile): one set of row sums for
    each run of column tiles that a block walks."""
    lib = _build.library()
    tile = lib.plmc_tile_size()
    nt = -(-n // tile)
    return ((q, nt, lib.plmc_reduce_pack_floats(r, d)),
            (q, nt, lib.plmc_reduce_runs(nt), 1 + d, tile))


def lowrank_stationary_reduce(x, lengthscale, A, Bf, kind: str, device="cuda",
                              row_x=None):
    """K7. rows (q, n) and wx (q, n, d) of W_b = (A_b Bf_bᵀ) ⊙ g′(d²_b) over
    the full grid, for any factors (A Bfᵀ need not be symmetric).

    Replaces ``lowrank_stationary_reduce`` (projected_lmc_tpu/ops/
    pallas_kernels.py:364; body ``_lowrank_vjp_tile`` :322), the fused
    backward's reduction under ``PLMC_SYM_BUILD=0``. Bound on the card:
    arithmetic — per ordered pair the rank-r product, d², g′, and 1+d
    accumulations, over n² pairs (about twice K2's). Design, K2's where it
    fits the full grid: a first kernel packs each tile's factors and x/l
    (``reduce_scratch_shapes``); a block owns (latent, row tile, a run of 8
    column tiles), copies their packs by ``cp.async`` and keeps its rows'
    sums in registers; a thread's 4 × 4 block of each 64 × 64 tile is
    adjacent rows and columns, read 16 bytes at a time; the kind is a
    template parameter, g′ takes the card's rsqrt and ex2; the sums run on
    x/l, wx = l · Σ W (x/l). Each run's row sums go to their own slot, and
    a last kernel sums a row tile's slots in run order: no float atomics,
    the same bits on every run.

    ``row_x`` (n1, d) gives the row-block form, a rank's rows of the grid
    under a mesh: rows (q, n1) and wx (q, n1, d) of W = (A Bfᵀ) ⊙ g′ over the
    rows ``row_x`` (with A (q, n1, r)) against all of ``x`` (with Bf
    (q, n, r)). The same kernel walks row tiles packed from (row_x, A) and
    runs of column tiles packed from (x, Bf), with the square call's slots
    and their ordered sum (``reduce_rows_scratch_shapes``); it counts as a
    launch of K7."""
    if row_x is not None:
        return _lowrank_reduce_rows(row_x, x, lengthscale, A, Bf, kind,
                                    device)
    dev = check_device(device, x, lengthscale, A, Bf)
    if dev.type == "cpu":
        return lowrank_stationary_reduce_plain(x, lengthscale, A, Bf, kind)
    x, ls, d = _reduce_inputs(x, lengthscale, A, Bf)
    q, n, r = A.shape
    w = x.shape[1]
    pack_shape, slots_shape = reduce_scratch_shapes(q, n, w, r)
    pack = torch.empty(pack_shape, dtype=torch.float32, device=x.device)
    slots = torch.empty(slots_shape, dtype=torch.float32, device=x.device)
    rows = torch.empty((q, n), dtype=torch.float32, device=x.device)
    wx = torch.empty((q, n, w), dtype=torch.float32, device=x.device)
    _launch("plmc_lowrank_reduce", x.data_ptr(), ls.data_ptr(), A.data_ptr(),
            Bf.data_ptr(), pack.data_ptr(), slots.data_ptr(), rows.data_ptr(),
            wx.data_ptr(), q, n, r, w, _kind_id(kind), _stream(x))
    lowrank_stationary_reduce.launches += 1
    return rows, _drop_padding(wx, d)


lowrank_stationary_reduce.launches = 0


def reduce_rows_scratch_shapes(q: int, n1: int, n2: int, d: int, r: int):
    """Shapes of the row-block form's three fp32 scratch buffers: the packs
    of the row tiles and of the column tiles, (q, nt1, P) and (q, nt2, P),
    and the slots, (q, nt1, runs of the nt2 column tiles, 1+d, tile)."""
    lib = _build.library()
    tile = lib.plmc_tile_size()
    nt1, nt2 = -(-n1 // tile), -(-n2 // tile)
    floats = lib.plmc_reduce_pack_floats(r, d)
    return ((q, nt1, floats), (q, nt2, floats),
            (q, nt1, lib.plmc_reduce_runs(nt2), 1 + d, tile))


def _lowrank_reduce_rows(x1, x2, lengthscale, A, Bf, kind, device):
    """K7's row-block form (``lowrank_stationary_reduce(row_x=)``)."""
    dev = check_device(device, x1, x2, lengthscale, A, Bf)
    if dev.type == "cpu":
        return lowrank_stationary_reduce_rows_plain(x1, x2, lengthscale, A,
                                                    Bf, kind)
    n1, n2 = x1.shape[0], x2.shape[0]
    d = _features(x2)
    q, _, r = A.shape
    _require("row_x", x1, (n1, d))
    _require("x", x2, (n2, d))
    _require("A", A, (q, n1, r))
    _require("Bf", Bf, (q, n2, r))
    width = reduce_width(d)
    ls2 = _lengthscale_2d(lengthscale, q, d)
    x1, ls = pad_features(x1, ls2, width)
    x2, _ = pad_features(x2, ls2, width)
    p1_shape, p2_shape, slots_shape = reduce_rows_scratch_shapes(
        q, n1, n2, width, r)
    pack1 = torch.empty(p1_shape, dtype=torch.float32, device=x1.device)
    pack2 = torch.empty(p2_shape, dtype=torch.float32, device=x1.device)
    slots = torch.empty(slots_shape, dtype=torch.float32, device=x1.device)
    rows = torch.empty((q, n1), dtype=torch.float32, device=x1.device)
    wx = torch.empty((q, n1, width), dtype=torch.float32, device=x1.device)
    _launch("plmc_lowrank_reduce_rows", x1.data_ptr(), x2.data_ptr(),
            ls.data_ptr(), A.data_ptr(), Bf.data_ptr(), pack1.data_ptr(),
            pack2.data_ptr(), slots.data_ptr(), rows.data_ptr(),
            wx.data_ptr(), q, n1, n2, r, width, _kind_id(kind), _stream(x1))
    lowrank_stationary_reduce.launches += 1
    return rows, _drop_padding(wx, d)


# -- K8: int8 kernel stack -----------------------------------------------------

def _padded_shape(n, m, padded_to):
    rows, cols = (n, m) if padded_to is None else padded_to
    if rows < n or cols < m:
        raise ValueError(f"padded_to {padded_to} is smaller than ({n}, {m})")
    return rows, cols


def quantized_kernel_stack_plain(x1, x2, lengthscale, kind: str,
                                 padded_to=None):
    """round(127·g(d²)) as int8 (round half to even), (q, n, m), or zero-
    padded to (q, *padded_to)."""
    n, m = x1.shape[0], x2.shape[0]
    rows, cols = _padded_shape(n, m, padded_to)
    Q = torch.round(kernel_matrix_plain(x1, x2, lengthscale, kind) * 127.0)
    out = torch.zeros((Q.shape[0], rows, cols), dtype=torch.int8,
                      device=Q.device)
    out[:, :n, :m] = Q.to(torch.int8)
    return out


def quantized_kernel_stack(x1, x2, lengthscale, kind: str, padded_to=None,
                           device="cuda"):
    """K8. The int8 stack round(127·g(d²)), (q, n, m), no outputscale: g
    lies in [0, 1], so 1/127 is a range-exact scale and os_b/127 dequantises
    at the consumer. ``padded_to`` (rows, cols) ≥ (n, m) writes a larger
    stack with zeros outside (n, m), the shape the int8 tensor-core product
    takes (``iterative.int8_width``).

    Replaces ``quantized_kernel_stack`` (projected_lmc_tpu/ops/
    pallas_kernels.py:190; body ``_quant_tile_kernel`` :169). Bound on the
    card: the q·rows·cols-byte write (400 MB at n = 10⁴, 0.119 ms), above
    the pair arithmetic. Design: one block per (latent, 128 × 128 tile), a
    thread's 8 × 16 block of counts in registers, each row's 16 counts one
    16-byte store. When x1 and x2 are the same points (``symmetric_call``,
    the fused MLL's only call) into a square stack, only the lower tiles
    are evaluated and each thread also stores its counts, packed by column,
    into the mirrored tile: half the pairs, a bitwise symmetric stack equal
    to the full grid's. The kind is a template parameter; a square root within an ulp and libm expf, so counts differ from the
    plain version's only where 127·g lies within ~1e-5 of a half (rounded
    half to even, as ``torch.round``)."""
    dev = check_device(device, x1, x2, lengthscale)
    n, m = x1.shape[0], x2.shape[0]
    rows, cols = _padded_shape(n, m, padded_to)
    if dev.type == "cpu":
        return quantized_kernel_stack_plain(x1, x2, lengthscale, kind,
                                            padded_to)
    d = _features(x1)
    q = lengthscale.shape[0]
    _require("x1", x1, (n, d))
    _require("x2", x2, (m, d))
    ls = _lengthscale_2d(lengthscale, q, d)
    out = torch.empty((q, rows, cols), dtype=torch.int8, device=x1.device)
    _launch("plmc_quantized_stack", x1.data_ptr(), x2.data_ptr(),
            ls.data_ptr(), out.data_ptr(), q, n, m, rows, cols, d,
            _kind_id(kind), int(symmetric_call(x1, x2, rows, cols)),
            _stream(x1))
    quantized_kernel_stack.launches += 1
    return out


quantized_kernel_stack.launches = 0


def symmetric_call(x1, x2, rows, cols) -> bool:
    """Whether K8 may evaluate the lower tiles only and mirror them: x1 and
    x2 are the same points (one tensor, or two views of the same memory)
    and the stack is square."""
    return (rows == cols and x1.shape == x2.shape
            and x1.data_ptr() == x2.data_ptr()
            and x1.stride() == x2.stride())
