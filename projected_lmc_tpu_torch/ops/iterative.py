"""Matrix-free exact-LMC marginal likelihoods and their pieces (port of
``projected_lmc_tpu/ops/iterative.py``): the stack product, the Nyström
preconditioner, PCG with its Lanczos tridiagonals and the tridiagonal
log-quadrature; the two estimators over a materialized stack, the
composed route's one-pass PCG (``lmc_pcg_log_prob``) and CG + SLQ on
Rademacher probes (``lmc_iterative_log_prob``, the LMC's default MLL above
the dense ceiling), with their shared Hutchinson backward; the matrix-free
LMC posterior's pieces; and the matrix-free exact ICM: its product,
preconditioner, PCG estimator and posterior variance.

Σ = Σ_b K_b ⊗ h_b h_bᵀ + I_n ⊗ Σt is applied through the materialized
(q, n, n) stack; every contraction here is a plain product that the JAX
package left to XLA, so it goes to torch/cuBLAS (fp32 without TF32 on the
card, see ``utils.device``). The int8 stack's product, int8 × int8 → int32
in JAX, goes to ``torch._int_mm`` on the card's int8 tensor cores.

Under a mesh (``rows``, a ``parallel.mesh.RowBlock``) a rank holds only
its row block of the stack, (q_l, n_l, n): the LMC's latents lo..hi − 1
and rows r0..r1 − 1, or the ICM's kernel's rows. Every product of the stack
is the rank's rows, zero-padded and summed over the world in one
``all_reduce`` before any sum over the latents or tasks
(``RowBlock.gather_product``, ``RowBlock.sum_rows``); the CG state, the
probes and the preconditioner stay whole and the same on every rank, so
that their scalars agree bit for bit and every rank takes the same
branches. The
Nyström roots come from the rank's rows and one gather; the Jacobi
diagonal of CG + SLQ is gathered whole, and its Lanczos basis stays
replicated; an int8 loop quantises the rank's block at the world max of
each latent's absmax (the whole stack's scale) and its right-hand sides
over their whole columns, so that its integer products are one process's.
A backward
gathers its block's products whole in one packed ``all_reduce``, then
runs one process's formulas on them, and scales the cotangent of the
rank's block by ``rows.grad_scale`` (``parallel/sharded.py`` states the
rule).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.profiling import count, recording, span
from .cholesky import cholesky_nan, safe_cholesky

# aten::bmm.dtype: a bf16 x bf16 batched product with an fp32 result (CUDA)
_BMM_OUT_DTYPE = hasattr(torch.ops.aten.bmm, "dtype")


def _bf16_stack_bmm(Ks, Wq):
    """Ks (q, n, n) bf16 @ Wq (q, n, r) → fp32, the products of bf16 values
    accumulated in fp32 (JAX's ``preferred_element_type=float32``); the
    result is never rounded to bf16. Without ``aten::bmm.dtype`` the card
    up-casts one latent's stack at a time (n² fp32 scratch, 400 MB at
    n = 10⁴)."""
    Wb = Wq.to(torch.bfloat16)
    if Ks.is_cuda:
        if _BMM_OUT_DTYPE:
            return torch.bmm(Ks, Wb, out_dtype=torch.float32)
        return torch.stack([Ks[b].float() @ Wb[b].float()
                            for b in range(Ks.shape[0])])
    return torch.bmm(Ks.float(), Wb.float())


def _stack_matmul(Ks, W):
    """K_b @ W[..., b] for every latent, in the stack's native layout:
    W (..., n, q) → (..., n, q), fp32-accumulated for a bf16 stack. The
    span ``mll.stack_product``."""
    single = W.dim() == 2
    Wt = W[None] if single else W                       # (r, n, q)
    Wq = Wt.permute(2, 1, 0)                            # (q, n, r)
    with span("mll.stack_product"):
        if Ks.dtype == torch.bfloat16:
            Z = _bf16_stack_bmm(Ks, Wq)
        else:
            Z = torch.bmm(Ks, Wq)
    out = Z.permute(2, 1, 0)                            # (r, n, q)
    return out[0] if single else out


def lmc_matvec(Ks, H, St, V, rows=None):
    """Σ · vec(V) in matrix form: Σ_b K_b (V h_b) h_bᵀ + V Σt.
    V (..., n, T); Ks (q, n, n); H (T, q); St (T, T). With ``rows`` Ks is
    the rank's (q_l, n_l, n) block, and its rows' products are gathered
    over the world before the sum over the latents: every rank returns the
    whole (..., n, T)."""
    W = V @ H
    if rows is None:
        Z = _stack_matmul(Ks, W)
    else:
        Z = rows.gather_product(_stack_matmul(Ks, W[..., rows.lo:rows.hi]))
    return Z.to(V.dtype) @ H.T + V @ St


def int8_width(n: int) -> int:
    """The stack width the card's int8 product takes for n points: n rounded
    up to a multiple of 8, and above 16 (``torch._int_mm``'s shape rules,
    aten/src/ATen/native/cuda/Blas.cpp). An int8 stack carries zero rows and
    columns up to it (``cuda_kernels.quantized_kernel_stack(padded_to=)``)."""
    return max(-(-n // 8) * 8, 24)


def _int8_stack_matmul(Kq, Wq, n_rows=None):
    """Kq_b @ Wq_b for every latent, exact in int32: Kq (q, N, N) int8, an
    int8 stack that may carry zero padding (N ≥ n); Wq (q, n, r) with
    integer values in [−127, 127] → (q, n, r) int32. With ``n_rows``, Kq is
    a rank's row block (q, M, N), its first ``n_rows`` rows real, and the
    result is (q, n_rows, r).

    On the card, one ``torch._int_mm`` per latent (int8 tensor cores, int32
    accumulation), with Wq zero-padded to (N, r rounded up to 8) and laid
    out column-major, the layout for which cuBLASLt's int8 kernels ran
    about six times faster than for a row-major Wq on an H100 (``PERF.md``
    §5; ``chip_smoke.py`` phase 2 times both). An N that ``int8_width`` did
    not give raises. On the CPU, an int32 product, which is exact (an fp32
    one is not, above 2²⁴)."""
    q, n, r = Wq.shape
    n_rows = n if n_rows is None else int(n_rows)
    M, N = Kq.shape[-2:]
    if not Kq.is_cuda:
        return torch.bmm(Kq[:, :n_rows, :n].to(torch.int32),
                         Wq.to(torch.int32))
    for width, count in ((N, n), (M, n_rows)):
        if width != int8_width(width) or width < count:
            raise ValueError(
                f"an int8 stack of {width} rows or columns does not fit the "
                f"int8 product for {count}: build it at int8_width("
                f"{count}) = {int8_width(count)}")
    rp = -(-r // 8) * 8
    Wt = torch.zeros((q, rp, N), dtype=torch.int8, device=Wq.device)
    Wt[:, :r, :n] = Wq.transpose(1, 2)
    out = torch.empty((q, M, rp), dtype=torch.int32, device=Wq.device)
    for b in range(q):
        torch._int_mm(Kq[b], Wt[b].t(), out=out[b])
    return out[:, :n_rows, :r]


def quantize_stack_int8(Ks, rows=None):
    """Symmetric per-latent int8 quantisation of a kernel stack:
    K_b ≈ scale_b · Q_b with Q_b = round(K_b/scale_b) ∈ [−127, 127].
    Returns (Q (q, n, n) int8, scale (q,) float32). With ``rows`` Ks is the
    rank's row block and each latent's absmax is the world max of its
    blocks', the whole stack's: every rank quantises as one process."""
    absmax = Ks.abs().amax(dim=(-2, -1)).to(torch.float32)
    if rows is not None:
        full = absmax.new_zeros(rows.q)
        full[rows.lo:rows.hi] = absmax
        absmax = rows.mesh.world_max_(full)[rows.lo:rows.hi]
    scale = torch.clamp(absmax, min=1e-30) / 127.0
    Q = torch.clamp(torch.round(Ks.to(torch.float32) / scale[:, None, None]),
                    -127, 127).to(torch.int8)
    return Q, scale


def _int8_stack_product(Kq, kscale, W, n_rows=None):
    """:func:`_stack_matmul` for an int8 stack Kq (q, N, N), K_b ≈ kscale_b
    · Kq_b (zero padding beyond n allowed): each (right-hand side, latent)
    column of W (..., n, q) is quantised as clip(round(W/ws), ±127), ws =
    max(|W| over n, 1e-30)/127, and the int8 × int8 → int32 product is
    dequantised with kscale·ws. Serves the CG products and the fused
    backward's, as in the JAX package. With ``n_rows`` Kq is a rank's row
    block (:func:`_int8_stack_matmul`); W is whole, so its scales are one
    process's."""
    ws = torch.clamp(W.abs().amax(dim=-2, keepdim=True), min=1e-30) / 127.0
    Wq = torch.clamp(torch.round(W / ws), -127, 127)
    single = Wq.dim() == 2
    Wt = Wq[None] if single else Wq                         # (r, n, q)
    Zi = _int8_stack_matmul(Kq, Wt.permute(2, 1, 0), n_rows)  # (q, n, r)
    Zl = Zi.permute(2, 1, 0).to(torch.float32)              # (r, n, q)
    return (Zl[0] if single else Zl) * (kscale[None, :] * ws)


def lmc_matvec_int8(Kq, kscale, H, St, V, rows=None):
    """:func:`lmc_matvec` with an int8 stack (:func:`_int8_stack_product`,
    the columns of V·H re-quantised at each call). V (n, T) or (r, n, T).
    With ``rows`` Kq is the rank's int8 row block and ``kscale`` its
    latents' scales; the rows' products are gathered as in
    :func:`lmc_matvec`."""
    W = V @ H
    if rows is None:
        Z = _int8_stack_product(Kq, kscale, W)
    else:
        Z = rows.gather_product(_int8_stack_product(
            Kq, kscale, W[..., rows.lo:rows.hi], rows.r1 - rows.r0))
    return Z.to(V.dtype) @ H.T + V @ St


def _landmarks(n: int, rank: int):
    """Strided landmark indices, as ``jnp.linspace(0, n-1, m).astype(int32)``."""
    m = min(int(rank), n)
    return np.linspace(0, n - 1, m).astype(np.int32)


def _roots_from_blocks(Kzz, Kxz, jitter):
    m = Kzz.shape[-1]
    eye = torch.eye(m, dtype=Kzz.dtype, device=Kzz.device)
    Lzz = safe_cholesky(Kzz + jitter * eye)
    Linv = torch.linalg.solve_triangular(Lzz, eye.expand_as(Lzz), upper=False)
    return torch.einsum("bnk,bmk->bnm", Kxz, Linv)


def nystrom_roots_from_kernels(Ks, rank: int = 256, jitter: float = 1e-4,
                               rows=None):
    """Strided-landmark Nyström roots R_b with R_b R_bᵀ ≈ K_b, (q, n, rank),
    sliced from a materialized stack (bf16 stacks up-cast to fp32). With
    ``rows``, Ks is the rank's row block: its landmark columns are gathered
    whole, (q, n, rank), and every rank factors the same blocks."""
    idx = torch.as_tensor(_landmarks(Ks.shape[-1], rank), device=Ks.device,
                          dtype=torch.long)
    dt = torch.float32 if Ks.dtype == torch.bfloat16 else Ks.dtype
    Knm = Ks[:, :, idx].to(dt)
    if rows is not None:
        Knm = rows.gather(Knm)
    return _roots_from_blocks(Knm[:, idx, :], Knm, jitter)


def nystrom_roots_from_covar(covar, x, rank: int, jitter: float = 1e-4,
                             rows=None):
    """Strided-landmark Nyström roots evaluated directly from a batched
    kernel callable's (b, m, m) and (b, n, m) blocks, (b, n, rank). With
    ``rows`` the rank evaluates its rows of K(x, z) for every latent, and
    the roots are gathered whole on every rank (no gradient), the same
    bits as one process's."""
    idx = torch.as_tensor(_landmarks(x.shape[0], rank), device=x.device,
                          dtype=torch.long)
    z = x[idx]
    if rows is None:
        return _roots_from_blocks(covar(z), covar(x, z), jitter)
    with torch.no_grad():
        return rows.gather_rows(_roots_from_blocks(
            covar(z), covar(x, z, rows=(rows.r0, rows.r1)), jitter))


def _nystrom_precond_parts(Ks, H, St, rank: int, jitter: float = 1e-4,
                           roots=None, rows=None):
    """Pieces of the Nyström preconditioner M = Σ_b Q_b ⊗ h_b h_bᵀ + I ⊗ Σt:
    roots R (q, n, m), Lt = chol(Σt), the apply M⁻¹ and logdet M (exact, by
    the determinant lemma through the capacitance Cholesky). Ks is only
    read when ``roots`` is None (the rank's row block with ``rows``)."""
    R = nystrom_roots_from_kernels(Ks, rank, jitter, rows) if roots is None \
        else roots
    # roots of a bf16 stack are fp32; the solver works in Σt's dtype (JAX
    # promotes the same way)
    R = R.to(St.dtype)
    q, n, m = R.shape
    t = St.shape[0]
    Lt = cholesky_nan(St)
    St_inv = torch.cholesky_solve(
        torch.eye(t, dtype=St.dtype, device=St.device), Lt)
    SinvH = St_inv @ H                                      # (T, q)
    C = H.T @ SinvH                                         # (q, q)
    Rtall = R.permute(1, 0, 2).reshape(n, q * m)
    P = (Rtall.T @ Rtall).reshape(q, m, q, m)
    eye_qm = torch.eye(q * m, dtype=R.dtype, device=R.device)
    cap = (C[:, None, :, None] * P).reshape(q * m, q * m) + eye_qm
    L_cap = cholesky_nan(cap)
    logdet_M = (2.0 * n * torch.log(torch.diagonal(Lt)).sum()
                + 2.0 * torch.log(torch.diagonal(L_cap)).sum())
    # cap⁻¹ once, so every apply inside the CG loop is a product
    cap_inv = torch.cholesky_solve(eye_qm, L_cap)

    def minv(V):                                            # V: (r, n, T)
        W = V @ St_inv
        u = torch.einsum("bnk,rnb->rbk", R, W @ H)
        r_ = u.shape[0]
        z = (u.reshape(r_, q * m) @ cap_inv).reshape(r_, q, m)
        t2 = torch.einsum("bnk,rbk->rnb", R, z)
        return W - t2 @ SinvH.T

    return R, Lt, minv, logdet_M


def pcg_with_tridiag(matvec, B, minv, max_iters: int, tol: float):
    """Batched PCG that also records the Lanczos tridiagonal coefficients of
    the preconditioned operator (t_jj = 1/α_j + β_{j-1}/α_{j-1},
    t_{j,j+1} = √β_j/α_j; Saad §6.7, gpytorch's inv_quad_logdet trick).

    Returns (X, alphas (K, r), betas (K, r), active (K, r), rz0 (r,)).

    The JAX loop exits on the device once every right-hand side converged.
    Here exactly ``max_iters`` masked iterations run with no host sync: a
    converged or broken-down RHS is frozen by ``skip`` and its later steps
    are recorded inactive, which ``_tridiag_logquad`` masks out, so the
    leftover iterations leave every output as the early exit would.

    Two guards. A RHS whose pAp ≤ 0 (low-precision operator noise)
    restarts from steepest descent (P ← Z), as in the JAX loop. A RHS whose
    step α = rz/pAp is not finite or is ≤ 1e-30 (a NaN or infinite pAp or
    rz, or a curvature that swamps rz) is frozen for good at its last
    iterate, as a converged one: the JAX loop lets such a step through, and
    its NaN or 1/α ≈ 1e30 then reaches the tridiagonal's eigh. A run whose
    steps are all finite and above 1e-30 freezes nothing and keeps every
    bit of the JAX loop's result.

    The loop is the span ``mll.pcg``. While a profiler records it counts,
    on the device, ``cg.solves`` (the r right-hand sides), ``cg.iters``
    (their active steps) and ``cg.frozen`` (those frozen by the second
    guard), read only when the profiling store is read."""
    with span("mll.pcg"):
        X, alphas, betas, active, rz0, frozen = _pcg_loop(
            matvec, B, minv, max_iters, tol)
        if recording():
            count("cg.solves", B.shape[0])
            count("cg.iters", active.sum())
            count("cg.frozen", frozen.sum())
    return X, alphas, betas, active, rz0


def _pcg_loop(matvec, B, minv, K, tol):
    """:func:`pcg_with_tridiag`'s iterations; also returns the (r,) mask of
    the right-hand sides frozen by the second guard."""

    def dot(a, b):
        return (a * b).sum(dim=(-2, -1))                    # (r,)

    r = B.shape[0]
    bnorm = torch.sqrt(torch.clamp(dot(B, B), min=1e-30))
    X = torch.zeros_like(B)
    Rr = B
    Z = minv(Rr)
    P = Z
    rz = dot(Rr, Z)
    rz0 = rz
    alphas = torch.zeros((K, r), dtype=B.dtype, device=B.device)
    betas = torch.zeros((K, r), dtype=B.dtype, device=B.device)
    active = torch.zeros((K, r), dtype=torch.bool, device=B.device)
    done = torch.zeros((r,), dtype=torch.bool, device=B.device)
    frozen = torch.zeros((r,), dtype=torch.bool, device=B.device)
    for it in range(K):
        Ap = matvec(P)
        pAp = dot(P, Ap)
        step = rz / torch.clamp(pAp, min=1e-30)
        # restart: low-precision operator noise can push pAp ≤ 0; such RHS
        # restart from steepest descent (P ← Z)
        brk = (pAp <= 0.0) & ~done
        # freeze: a step that is NaN, infinite or ≤ 1e-30 (comparisons
        # with NaN are false, so a NaN pAp lands here, not in brk)
        frz = ~(done | brk) & ~(torch.isfinite(step) & (step > 1e-30))
        frozen = frozen | frz
        done = done | frz
        skip = done | brk
        alpha = torch.where(skip, torch.ones_like(rz), step)
        upd = (~skip)[:, None, None]
        X = torch.where(upd, X + alpha[:, None, None] * P, X)
        Rn = torch.where(upd, Rr - alpha[:, None, None] * Ap, Rr)
        Zn = minv(Rn)
        rzn = dot(Rn, Zn)
        beta = torch.where(skip, torch.zeros_like(rz),
                           rzn / torch.clamp(rz, min=1e-30))
        P = torch.where(upd, Zn + beta[:, None, None] * P,
                        torch.where(brk[:, None, None], Zn, P))
        alphas[it] = alpha
        betas[it] = beta
        active[it] = ~skip
        rel = torch.sqrt(torch.clamp(dot(Rn, Rn), min=0.0)) / bnorm
        done = done | (rel < tol)
        # converged and frozen RHS keep their rz; restarted ones re-seed
        # from rzn
        rz = torch.where(done, rz, rzn)
        Rr = Rn
    return X, alphas, betas, active, rz0, frozen


def _tridiag_logquad(alphas, betas, active):
    """e₁ᵀ log(T_K) e₁ per RHS from the CG coefficients, (r,). Inactive steps
    pad T with an identity block, which adds exactly nothing. An active
    step whose α is ≤ 1e-30 or whose diagonal entry is not finite is left
    out with every later step of its column (a breakdown that the PCG's
    guards did not stop): no non-finite entry, and no 1/α ≈ 1e30, reaches
    the eigh. Where every active step is sound this changes nothing."""
    K, r = alphas.shape
    one = torch.ones((1, r), dtype=alphas.dtype, device=alphas.device)
    a_prev = torch.cat([one, alphas[:-1]])
    b_prev = torch.cat([torch.zeros_like(one), betas[:-1]])
    diag = 1.0 / torch.clamp(alphas, min=1e-30) \
        + b_prev / torch.clamp(a_prev, min=1e-30)
    bad = active & ~(torch.isfinite(diag) & (alphas > 1e-30))
    active = active & (torch.cumsum(bad.to(torch.int32), 0) == 0)
    diag = torch.where(active, diag, torch.ones_like(alphas))
    act_next = torch.cat([active[1:], torch.zeros_like(active[:1])])
    off = torch.where(act_next & active,
                      torch.sqrt(torch.clamp(betas, min=0.0))
                      / torch.clamp(alphas, min=1e-30),
                      torch.zeros_like(alphas))
    return _tridiag_quadrature(diag.T, off[:-1].T)


def _tridiag_quadrature(diag, off):
    """e₁ᵀ log(T) e₁ for the batched symmetric tridiagonals T of diagonal
    ``diag`` (r, K) and off-diagonal ``off`` (r, K − 1): one batched eigh on
    the device. Krylov-converged directions give spurious tiny or negative
    Ritz values of ~zero weight, floored so that the log stays finite."""
    T = (torch.diag_embed(diag) + torch.diag_embed(off, 1)
         + torch.diag_embed(off, -1))
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.maximum(evals, 1e-10 * evals.abs().amax(-1, keepdim=True))
    return (evecs[:, 0, :] ** 2 * torch.log(evals)).sum(-1)   # (r,)


def _pcg_fwd_impl(Ks, H, St, Ydelta, eps, xi, roots, max_cg_iters, cg_tol,
                  matvec_bf16, precond_rank, matvec_int8=False, kscale=None,
                  rows=None):
    """log N(vec(Y); 0, Σ) from one batched PCG pass (the forward of
    ``iterative.lmc_pcg_log_prob``): probes z = eps·chol(Σt)ᵀ + Σ_b (R_b ξ_b)
    h_bᵀ ~ N(0, M), logdet Σ = logdet M + Lanczos quadrature of the
    preconditioned operator. Returns (ll, (alpha, W, Ztilde)).

    ``matvec_int8`` (over ``matvec_bf16``) runs the CG products through
    :func:`lmc_matvec_int8`: on a pre-quantised int8 stack ``Ks`` (q, N, N),
    which may carry zero padding beyond n, with its scales ``kscale`` (q,),
    or on ``Ks`` quantised here by :func:`quantize_stack_int8`. With
    ``rows`` Ks is the rank's row block (int8 ones padded, ``kscale`` its
    latents' scales) and the products are summed over the world."""
    n, t = Ydelta.shape
    # an int8 stack's padding off
    Kn = Ks[:, :n, :n] if rows is None else Ks[:, :rows.r1 - rows.r0, :n]
    if Ks.dtype == torch.int8 and roots is None:
        # fallback only: the roots Cholesky is fp32-sensitive
        roots = nystrom_roots_from_kernels(
            Kn.to(torch.float32) * kscale[:, None, None], min(precond_rank, n),
            rows=rows)
    R, Lt, minv, logdet_M = _nystrom_precond_parts(
        Kn, H, St, precond_rank,
        roots=roots.detach() if roots is not None else None, rows=rows)
    z1 = torch.einsum("snt,ut->snu", eps, Lt)
    t2 = torch.einsum("bnk,sbk->snb", R, xi)
    z = z1 + t2 @ H.T
    if matvec_int8:
        if Ks.dtype == torch.int8:
            Kq, ks_ = Ks, kscale
        else:
            Kq, ks_ = quantize_stack_int8(Ks.detach(), rows)
            # the int8 product's shape
            M = int8_width(n if rows is None else rows.r1 - rows.r0)
            N = int8_width(n)
            Kq = torch.nn.functional.pad(Kq, (0, N - n, 0, M - Kq.shape[-2]))
        matvec = lambda V: lmc_matvec_int8(Kq, ks_, H, St, V,  # noqa: E731
                                           rows)
    else:
        Kmv = Ks.to(torch.bfloat16) if matvec_bf16 else Ks
        matvec = lambda V: lmc_matvec(Kmv, H, St, V, rows)  # noqa: E731
    B = torch.cat([Ydelta[None], z], 0)                     # (1+s, n, T)
    X, alphas, betas, active, rz0 = pcg_with_tridiag(
        matvec, B, minv, max_cg_iters, cg_tol)
    alpha, W = X[0], X[1:]
    quad = (Ydelta * alpha).sum()
    logquad = _tridiag_logquad(alphas[:, 1:], betas[:, 1:], active[:, 1:])
    logdet = logdet_M + (rz0[1:] * logquad).mean()
    ll = -0.5 * (quad + logdet + n * t * math.log(2 * math.pi))
    return ll, (alpha, W, minv(z))


def _lmc_hutchinson_bwd(Ks, H, alpha, W, Z, g, rows=None):
    """The estimators' backward (the JAX package's ``_bwd_impl``): the
    cotangents (dK, dH, dΣt, dY) of ll for Σ = Σ_b K_b ⊗ h_b h_bᵀ + I ⊗ Σt
    from dll/dΣ = ½(ααᵀ − Σ⁻¹), Σ⁻¹ ≈ (1/2s) Σ_i (w_i z_iᵀ + z_i w_iᵀ),
    w_i = Σ⁻¹z_i (z_i the probes, or M⁻¹ of them for the PCG estimator).

    dK is dense, (q, n, n) in the stack's dtype (a bf16 stack carries a
    bf16 cotangent), one batched GEMM of rank 1 + 2s per latent; dH streams
    the stack once, in one product with the 1 + 2s right-hand sides
    α h_b, W h_b and Z h_b. With ``rows``: dK is the rank's block, scaled
    by ``rows.grad_scale``, and the block's rows of the product are
    gathered whole in one call (``RowBlock.gather_product``), so that dH
    sums in one process's order."""
    s = max(W.shape[0], 1)
    Ah, WH, ZH = alpha @ H, W @ H, Z @ H                # (n, q), (s, n, q)
    R3 = torch.cat([Ah[None], WH, ZH], 0)
    if rows is None:
        dK = _lmc_dk(Ah, WH, ZH, g).to(Ks.dtype)
        KR = _stack_matmul(Ks, R3).to(alpha.dtype)
    else:
        dK = (_lmc_dk(Ah, WH, ZH, g, rows) * rows.grad_scale).to(Ks.dtype)
        KR = rows.gather_product(_stack_matmul(
            Ks, R3[..., rows.lo:rows.hi]).to(alpha.dtype))
    KAh, KWH, KZH = KR[0], KR[1:1 + s], KR[1 + s:]
    dH_s = 0.5 * (torch.einsum("snt,snb->tb", Z, KWH)
                  + torch.einsum("snt,snb->tb", W, KZH))
    dH = g * (alpha.T @ KAh - dH_s / s)
    wz = torch.einsum("snt,snu->tu", W, Z)
    dSt = g * 0.5 * (alpha.T @ alpha - (wz + wz.T) / (2 * s))
    return dK, dH, dSt, -g * alpha


def _lmc_dk(Ah, WH, ZH, g, rows=None):
    """The estimators' dense dK, (q, n, n):
    g·[½ (αh_b)(αh_b)ᵀ − ¼/s Σ_i ((W_i h_b)(Z_i h_b)ᵀ + (Z_i h_b)(W_i h_b)ᵀ)]
    as one batched GEMM of rank 1 + 2s per latent; with ``rows`` the rank's
    (q_l, n_l, n) block of it."""
    s = max(WH.shape[0], 1)
    lat = lambda A: A.permute(2, 1, 0)                  # noqa: E731 (q, n, s)
    left = torch.cat([(0.5 * g) * Ah.T[..., None], (-0.25 / s * g) * lat(WH),
                      (-0.25 / s * g) * lat(ZH)], 2)
    right = torch.cat([Ah.T[..., None], lat(ZH), lat(WH)], 2)
    if rows is not None:
        left = left[rows.lo:rows.hi, rows.r0:rows.r1]
        right = right[rows.lo:rows.hi]
    return torch.bmm(left, right.transpose(1, 2))


def draw_probes(generator, n, t, num_probes, dtype=torch.float32):
    """Rademacher probe matrices Z ~ U{±1}, (num_probes, n, t), drawn from
    ``generator`` on its device."""
    bits = torch.randint(0, 2, (num_probes, n, t), generator=generator,
                         device=generator.device)
    return (2 * bits - 1).to(dtype)


def slq_logdet(matvec, Z, num_steps: int = 20):
    """Stochastic Lanczos quadrature estimate of logdet(Σ) from probes
    Z (s, n, T): ``num_steps`` Lanczos iterations per probe with full
    reorthogonalization against the stored basis (s, n, T) per step, then
    the batched eigh of the (s, m, m) tridiagonals, on the device, and
    logdet ≈ mean_i ‖z_i‖² · e₁ᵀ log(T_m) e₁."""
    m = num_steps

    def dot(a, b):
        return (a * b).sum(dim=(-2, -1))                    # (s,)

    beta0 = torch.sqrt(dot(Z, Z))
    q = Z / beta0[:, None, None]
    q_prev = torch.zeros_like(q)
    beta = torch.zeros_like(beta0)
    Qbuf = torch.empty((m,) + tuple(Z.shape), dtype=Z.dtype, device=Z.device)
    alphas, betas = [], []
    for j in range(m):
        Qbuf[j] = q
        w = matvec(q) - beta[:, None, None] * q_prev
        alpha = dot(w, q)
        w = w - alpha[:, None, None] * q
        basis = Qbuf[:j + 1]                                # (j+1, s, n, T)
        coeffs = torch.einsum("msnt,snt->ms", basis, w)
        w = w - torch.einsum("ms,msnt->snt", coeffs, basis)
        beta = torch.sqrt(torch.clamp(dot(w, w), min=1e-30))
        q_prev, q = q, w / beta[:, None, None]
        alphas.append(alpha)
        betas.append(beta)
    quad = _tridiag_quadrature(torch.stack(alphas, 1),
                               torch.stack(betas, 1)[:, :-1])
    return (beta0 ** 2 * quad).mean()


class _LmcIterativeLogProb(torch.autograd.Function):
    """The JAX package's ``lmc_iterative_log_prob``: CG for the quadratic
    form (Jacobi-, or with ``precond_rank`` > 0 Nyström-preconditioned from
    the stack), SLQ on the Rademacher probes for the logdet; the backward is
    :func:`_lmc_hutchinson_bwd` on the saved solves."""

    @staticmethod
    def forward(ctx, Ks, H, St, Ydelta, probes, max_cg_iters, cg_tol,
                slq_steps, matvec_bf16, precond_rank, rows):
        n, t = Ydelta.shape
        Kmv = Ks.to(torch.bfloat16) if matvec_bf16 else Ks
        matvec = lambda V: lmc_matvec(Kmv, H, St, V, rows)  # noqa: E731
        Md = torch.clamp(_jacobi_diag(Ks, H, St, rows), min=1e-10)
        minv = nystrom_precond(Ks, H, St, precond_rank, rows=rows) \
            if precond_rank > 0 else None
        X = batched_pcg(matvec, torch.cat([Ydelta[None], probes], 0), Md,
                        max_iters=max_cg_iters, tol=cg_tol, minv=minv)
        alpha, W = X[0], X[1:]
        logdet = slq_logdet(matvec, probes, num_steps=slq_steps)
        ctx.save_for_backward(Ks, H, alpha, W, probes)
        ctx.rows = rows
        return -0.5 * ((Ydelta * alpha).sum() + logdet
                       + n * t * math.log(2 * math.pi))

    @staticmethod
    def backward(ctx, g):
        return _lmc_hutchinson_bwd(*ctx.saved_tensors, g,
                                   rows=ctx.rows) + (None,) * 7


def lmc_iterative_log_prob(Ks, H, St, Ydelta, probes, max_cg_iters: int = 256,
                           cg_tol: float = 1e-4, slq_steps: int = 20,
                           matvec_bf16: bool = False, precond_rank: int = 0,
                           rows=None):
    """log N(vec(Y); 0, Σ_b K_b ⊗ h_b h_bᵀ + I ⊗ Σt), matrix-free: Ks
    (q, n, n), H (T, q), St (T, T), Ydelta (n, T), probes (s, n, T)
    (:func:`draw_probes`). The value is CG for the quadratic form plus SLQ
    for the logdet; the gradient is Hutchinson's on the saved CG solves
    (gpytorch's inv_quad_logdet estimator family); the probes get none.
    With ``rows`` (a ``parallel.mesh.RowBlock``) Ks is the rank's
    (q_l, n_l, n) block: every CG and Lanczos product is gathered over the
    world, the Jacobi diagonal and the Nyström roots are gathered whole,
    and the Lanczos basis stays replicated."""
    return _LmcIterativeLogProb.apply(
        Ks, H, St, Ydelta, probes.detach(), int(max_cg_iters), float(cg_tol),
        int(slq_steps), bool(matvec_bf16), int(precond_rank), rows)


class _LmcPcgLogProb(torch.autograd.Function):
    """The JAX package's ``lmc_pcg_log_prob`` on a materialized stack (the
    composed kernel → log-prob route): :func:`_pcg_fwd_impl` forward,
    :func:`_lmc_hutchinson_bwd` backward with the M-covariant probes
    z̃ = M⁻¹z. The probes' normals and the roots get no gradient."""

    @staticmethod
    def forward(ctx, Ks, H, St, Ydelta, eps, xi, roots, max_cg_iters, cg_tol,
                matvec_bf16, precond_rank, matvec_int8, rows):
        ll, (alpha, W, Zt) = _pcg_fwd_impl(
            Ks, H, St, Ydelta, eps, xi, roots, max_cg_iters, cg_tol,
            matvec_bf16, precond_rank, matvec_int8, rows=rows)
        ctx.save_for_backward(Ks, H, alpha, W, Zt)
        ctx.rows = rows
        return ll

    @staticmethod
    def backward(ctx, g):
        return _lmc_hutchinson_bwd(*ctx.saved_tensors, g,
                                   rows=ctx.rows) + (None,) * 9


def lmc_pcg_log_prob(Ks, H, St, Ydelta, eps, xi, roots=None,
                     max_cg_iters: int = 32, cg_tol: float = 1e-2,
                     matvec_bf16: bool = False, precond_rank: int = 256,
                     matvec_int8: bool = False, rows=None):
    """log N(vec(Y); 0, Σ_b K_b ⊗ h_b h_bᵀ + I ⊗ Σt) from ONE batched PCG
    pass over the materialized stack Ks (q, n, n) (bf16 for a bf16 CG
    loop; its cotangent is then bf16 too): probes z = eps·chol(Σt)ᵀ +
    Σ_b (R_b ξ_b) h_bᵀ ~ N(0, M), M the Nyström preconditioner of the roots
    (q, n, m) (from the stack when None), and logdet Σ = logdet M + Lanczos
    quadrature of the CG coefficients. eps (s, n, T), xi (s, q, m).
    ``matvec_int8`` (over ``matvec_bf16``) runs the CG loop on the stack
    quantized to int8; the backward reads the unquantized stack. With
    ``rows`` (a ``parallel.mesh.RowBlock``) Ks is the rank's (q_l, n_l, n)
    block and every rank returns the whole value."""
    if roots is not None:
        roots = roots.detach()
    return _LmcPcgLogProb.apply(
        Ks, H, St, Ydelta, eps.detach(), xi.detach(), roots,
        int(max_cg_iters), float(cg_tol), bool(matvec_bf16),
        int(precond_rank), bool(matvec_int8), rows)


# -- the matrix-free LMC posterior (models.multitask, "lmc_iter") -------------

def _jacobi_diag(Ks, H, St, rows=None):
    """diag(Σ) as an (n, T) grid: Σ_b K_b[i,i] h_b[t]² + Σt[t,t]. With
    ``rows`` Ks is the rank's row block, whose entries (i, r0 + i) are
    gathered whole in one world sum."""
    if rows is None:
        kdiag = torch.diagonal(Ks, dim1=-2, dim2=-1)        # (q, n)
    else:
        kdiag = rows.gather(torch.diagonal(
            Ks[..., rows.r0:rows.r1], dim1=-2, dim2=-1)[..., None])[..., 0]
    return kdiag.T @ (H * H).T + torch.diagonal(St)[None, :]


def nystrom_precond(Ks, H, St, rank: int = 128, jitter: float = 1e-4,
                    roots=None, rows=None):
    """The apply M⁻¹ for M = Σ_b Q_b ⊗ h_b h_bᵀ + I ⊗ Σt, Q_b the rank-
    ``rank`` Nyström approximations of the K_b (strided landmarks), or the
    given ``roots`` (q, n, m)."""
    return _nystrom_precond_parts(Ks, H, St, rank, jitter, roots, rows)[2]


def batched_pcg(matvec, B, Md, max_iters: int = 256, tol: float = 1e-4,
                minv=None):
    """Preconditioned CG for r simultaneous (n, T)-shaped right-hand sides
    B (r, n, T); Md (n, T) a positive diagonal (the Jacobi preconditioner
    unless ``minv`` is given; None with it). Returns X with Σ X_k = B_k.

    Stops, as the JAX ``while_loop`` does, before the first iteration at
    which every right-hand side has a relative residual ≤ ``tol``, or after
    ``max_iters``: one host read of the residuals an iteration. A right-hand
    side whose direction meets pAp ≤ 0 (operator noise) keeps its iterate
    and restarts from steepest descent."""
    if minv is None:
        minv = lambda R: R / Md                             # noqa: E731

    def dot(a, b):
        return (a * b).sum(dim=(-2, -1))                    # (r,)

    bnorm = torch.sqrt(torch.clamp(dot(B, B), min=1e-30))
    X = torch.zeros_like(B)
    R = B
    Z = minv(R)
    P = Z
    rz = dot(R, Z)
    for _ in range(max_iters):
        rel = torch.sqrt(torch.clamp(dot(R, R), min=0.0)) / bnorm
        count("host_read")
        if not bool(rel.max() > tol):
            break
        Ap = matvec(P)
        pAp = dot(P, Ap)
        ok = pAp > 0.0
        alpha = torch.where(ok, rz / torch.clamp(pAp, min=1e-30),
                            torch.zeros_like(rz))
        X = X + alpha[:, None, None] * P
        R = torch.where(ok[:, None, None], R - alpha[:, None, None] * Ap, R)
        Z = minv(R)
        rz_new = dot(R, Z)
        beta = torch.where(ok, rz_new / torch.clamp(rz, min=1e-30),
                           torch.zeros_like(rz))
        P = torch.where(ok[:, None, None], Z + beta[:, None, None] * P, Z)
        rz = rz_new
    return X


def _start_vector(shape, generator, like, rows):
    """A standard normal draw from ``generator``; under a mesh, rank 0's
    draw on every rank."""
    v0 = torch.randn(shape, generator=generator, dtype=like.dtype,
                     device=like.device)
    if rows is not None:
        rows.mesh.broadcast_([v0])
    return v0


def residual_spectral_bound(Ks, roots, H, n_iters: int = 12, v0=None,
                            generator=None, rows=None):
    """Power-iteration estimate of λmax of the Nyström residual operator
    R(V) = Σ_b (K_b − R_b R_bᵀ)(V h_b) h_bᵀ, clamped at 0: the inflation c
    that makes M + c·I bound Σ from above (a conservative posterior
    variance). The start vector is ``v0`` (n, T), or a standard normal
    draw from ``generator`` when ``v0`` is None (rank 0's under a mesh,
    where Ks is the rank's row block and ``rows`` sums its products)."""
    n, t = Ks.shape[-1], H.shape[0]

    def resid_mv(V):
        W = V @ H                                           # (n, q)
        RtW = torch.einsum("bnk,nb->bk", roots, W)
        QW = torch.einsum("bnk,bk->nb", roots, RtW)
        if rows is None:
            KW = _stack_matmul(Ks, W)
        else:
            KW = rows.gather_product(_stack_matmul(Ks, W[:, rows.lo:rows.hi]))
        return (KW - QW) @ H.T

    if v0 is None:
        v0 = _start_vector((n, t), generator, Ks, rows)
    v = v0 / torch.sqrt((v0 * v0).sum())
    for _ in range(n_iters):
        w = resid_mv(v)
        v = w / torch.clamp(torch.sqrt((w * w).sum()), min=1e-30)
    w = resid_mv(v)
    return torch.clamp((v * w).sum() / torch.clamp((v * v).sum(), min=1e-30),
                       min=0.0)


# -- the matrix-free exact ICM (Σ = K ⊗ B + I ⊗ Σt) ---------------------------
# The large-n route the dense joint diagonalization (ops/kron.py) cannot
# reach: ICM shares ONE data kernel across tasks, so a product streams a
# single (n, n) matrix whatever the task count, and the Nyström
# preconditioner factors per task eigenvalue.

def _kernel_product(K, V):
    """K @ V[r] for V (n, t) or (r, n, t). With a bf16 K, the bf16 product
    with an fp32 result (:func:`_bf16_stack_bmm` with one latent, the
    right-hand sides side by side), never rounded to bf16 (JAX's
    ``preferred_element_type=float32``)."""
    if K.dtype != torch.bfloat16:
        return K @ V
    single = V.dim() == 2
    Vr = V[None] if single else V                       # (r, n, t)
    r, n, t = Vr.shape
    W = Vr.permute(1, 0, 2).reshape(1, n, r * t)
    out = _bf16_stack_bmm(K[None], W)[0].reshape(K.shape[0], r, t).permute(
        1, 0, 2)
    return out[0] if single else out


def icm_matvec(K, B, St, V, rows=None):
    """(K ⊗ B + I ⊗ Σt) · vec(V) in matrix form, K V B + V Σt, for V
    (..., n, t): one (n, n) stream a call (half of it with K pre-cast to
    bf16, the product fp32). With ``rows`` K is the rank's (n_l, n) rows,
    whose product K V is gathered over the world before it meets B."""
    KV = _kernel_product(K, V)
    if rows is not None:
        KV = rows.sum_rows(KV)
    return KV.to(V.dtype) @ B + V @ St


def _eigh_fixed_signs(A):
    """``torch.linalg.eigh`` with each eigenvector's largest-magnitude entry
    made positive. An eigenvector's sign is the LAPACK's choice (MKL,
    cuSOLVER and the JAX package's LAPACK differ); the ICM probes are drawn
    in this eigenbasis, so fixing it makes the estimator the same on every
    device (its distribution is the same under any sign)."""
    w, V = torch.linalg.eigh(A)
    top = torch.gather(V, -2, V.abs().argmax(-2, keepdim=True))
    return w, V * torch.where(top < 0, -1.0, 1.0).to(V.dtype)


def icm_whitened_parts(K, B, St, rank: int, roots=None, rows=None):
    """Factors of M = Q ⊗ B + I ⊗ Σt, Q = R Rᵀ (rank-m Nyström root of K).
    With B̃ = Lt⁻¹ B Lt⁻ᵀ = Vb Γ Vbᵀ and P = Lt Vb,

        M = (I ⊗ P) · blockdiag_j(γ_j Q + I_n) · (I ⊗ Pᵀ).

    Returns dict(R, gam, P, P_inv, C_inv (t, m, m), logdet_M); Vb's signs
    are fixed (:func:`_eigh_fixed_signs`). ``K`` may be None when ``roots``
    (n, m) are given (with ``rows``, the rank's rows of K)."""
    R = nystrom_roots_from_kernels(K[None], rank, rows=rows)[0] \
        if roots is None else roots
    n, m = R.shape
    t = St.shape[-1]
    Lt = cholesky_nan(St)
    Lt_inv = torch.linalg.solve_triangular(
        Lt, torch.eye(t, dtype=St.dtype, device=St.device), upper=False)
    Btil = Lt_inv @ B @ Lt_inv.T
    gam, Vb = _eigh_fixed_signs(0.5 * (Btil + Btil.T))
    gam = torch.clamp(gam, min=0.0)                         # B ⪰ 0
    P = Lt @ Vb
    P_inv = Vb.T @ Lt_inv
    eye_m = torch.eye(m, dtype=R.dtype, device=R.device)
    C = eye_m[None] + gam[:, None, None] * (R.T @ R)[None]  # (t, m, m)
    L_C = cholesky_nan(C)
    C_inv = torch.cholesky_solve(eye_m.expand_as(C), L_C)
    logdet_M = (2.0 * n * torch.log(torch.diagonal(Lt)).sum()
                + 2.0 * torch.log(torch.diagonal(L_C, dim1=-2,
                                                 dim2=-1)).sum())
    return dict(R=R, gam=gam, P=P, P_inv=P_inv, C_inv=C_inv,
                logdet_M=logdet_M)


def _icm_nystrom_parts(K, B, St, rank: int, roots=None, rows=None):
    """(R, P, gam, the apply M⁻¹, logdet M) for M = Q ⊗ B + I ⊗ Σt: t
    independent rank-m Woodbury solves in the whitened eigenbasis."""
    parts = icm_whitened_parts(K, B, St, rank, roots=roots, rows=rows)
    R, gam, P, P_inv, C_inv = (parts[k] for k in ("R", "gam", "P", "P_inv",
                                                  "C_inv"))

    def minv(V):                                            # (..., n, t)
        W2 = V @ P_inv.T                                    # eigenbasis
        RtW = torch.einsum("nm,...nj->...mj", R, W2)
        S = torch.einsum("jmk,...kj->...mj", C_inv, RtW)
        corr = torch.einsum("nm,...mj->...nj", R, S * gam)
        return (W2 - corr) @ P_inv

    return R, P, gam, minv, parts["logdet_M"]


def icm_nystrom_posterior_variance(K_star, kss, B, Sigma_t, parts,
                                   noise: bool = True):
    """Conservative ICM posterior variance diagonal (n*, t) through
    M_up = Q⊗B + I⊗St_up (``parts`` = :func:`icm_whitened_parts` of M_up,
    built with an inflated St_up ⪰ Σt, so the correction under-shoots):

        corr[c] = Σ_j s_cj · g_j g_jᵀ,      g_j = B P⁻ᵀ e_j,
        s_cj = ‖k_c‖² − γ_j u_c C_j⁻¹ u_cᵀ,  u = K_* R.

    The prior and the noise use the true Σt."""
    R, gam, P_inv, C_inv = (parts[k] for k in ("R", "gam", "P_inv", "C_inv"))
    u = K_star @ R                                          # (n*, m)
    kk2 = (K_star * K_star).sum(-1)                         # (n*,)
    quad = torch.einsum("cm,jmk,ck->cj", u, C_inv, u)       # (n*, t)
    s = torch.clamp(kk2[:, None] - gam[None, :] * quad, min=0.0)
    G2 = B @ P_inv.T                                        # columns g_j
    corr = s @ (G2 * G2).T
    prior = kss[:, None] * torch.diagonal(B)[None, :]
    var = torch.clamp(prior - corr, min=1e-12)
    if noise:
        var = var + torch.diagonal(Sigma_t)[None, :]
    return var


class _IcmPcgLogProb(torch.autograd.Function):
    """The JAX package's ``icm_pcg_log_prob`` with its custom VJP: one
    batched PCG pass in the forward; the backward's Hutchinson estimate of
    dll/dΣ = ½(ααᵀ − Σ⁻¹), Σ⁻¹ ≈ (1/2s) Σ_i (w_i z̃_iᵀ + z̃_i w_iᵀ), with
    dK formed densely and K streamed once for dB. The probes and the roots
    get no gradient (JAX's stop_gradient and zero cotangents)."""

    @staticmethod
    def forward(ctx, K, B, St, Ydelta, eps, xi, roots, max_cg_iters, cg_tol,
                matvec_bf16, precond_rank, rows):
        n, t = Ydelta.shape
        R, P, gam, minv, logdet_M = _icm_nystrom_parts(
            K, B, St, precond_rank, roots=roots, rows=rows)
        u = eps + torch.einsum("nm,smj->snj", R,
                               xi * torch.sqrt(gam)[None, None, :])
        z = u @ P.T
        Kmv = K.to(torch.bfloat16) if matvec_bf16 else K
        Brhs = torch.cat([Ydelta[None], z], 0)              # (1+s, n, t)
        X, alphas, betas, active, rz0 = pcg_with_tridiag(
            lambda V: icm_matvec(Kmv, B, St, V, rows), Brhs, minv,
            max_cg_iters, cg_tol)
        alpha, W = X[0], X[1:]
        quad = (Ydelta * alpha).sum()
        logquad = _tridiag_logquad(alphas[:, 1:], betas[:, 1:],
                                   active[:, 1:])
        logdet = logdet_M + (rz0[1:] * logquad).mean()
        ctx.save_for_backward(K, B, alpha, W, minv(z))
        ctx.rows = rows
        return -0.5 * (quad + logdet + n * t * math.log(2 * math.pi))

    @staticmethod
    def backward(ctx, g):
        K, B, alpha, W, Zt = ctx.saved_tensors
        dK = _icm_pcg_dk(alpha, B, W, Zt, g, ctx.rows).to(K.dtype)
        dB, dSt = _icm_pcg_dtasks(K, alpha, W, Zt, g, ctx.rows)
        return (dK, dB.to(B.dtype), dSt, -g * alpha, None, None, None, None,
                None, None, None, None)


def _icm_pcg_dk(alpha, B, W, Zt, g, rows=None):
    """The estimator's dK, dense (n, n), as one GEMM:
    g·[½ (αB)αᵀ − ¼/s Σ_i ((w_iB) z̃_iᵀ + (z̃_iB) w_iᵀ)] (never reads K);
    with ``rows`` the rank's (n_l, n) rows of it, times
    ``rows.grad_scale``."""
    s = max(W.shape[0], 1)
    n = alpha.shape[0]
    flat = lambda A: A.permute(1, 0, 2).reshape(n, -1)      # noqa: E731
    left = torch.cat([0.5 * (alpha @ B), (-0.25 / s) * flat(W @ B),
                      (-0.25 / s) * flat(Zt @ B)], 1)
    right = torch.cat([alpha, flat(Zt), flat(W)], 1)
    if rows is None:
        return g * (left @ right.T)
    return (g * rows.grad_scale) * (left[rows.r0:rows.r1] @ right.T)


def _icm_pcg_dtasks(K, alpha, W, Zt, g, rows=None):
    """The estimator's (dB, dΣt), K streamed once (one product with the
    1 + 2s right-hand sides α, w_i, z̃_i). With ``rows`` K is the rank's
    rows, whose product is gathered whole in one call."""
    s = max(W.shape[0], 1)
    KR = _kernel_product(K, torch.cat([alpha[None], W, Zt], 0)).to(
        alpha.dtype)
    if rows is not None:
        KR = rows.sum_rows(KR)
    Ka, KW, KZ = KR[0], KR[1:1 + s], KR[1 + s:]
    dB = (0.5 * alpha.T @ Ka
          - (0.25 / s) * (torch.einsum("snt,snu->tu", W, KZ)
                          + torch.einsum("snt,snu->tu", Zt, KW)))
    wz = torch.einsum("snt,snu->tu", W, Zt)
    return (g * 0.5 * (dB + dB.T),
            g * 0.5 * (alpha.T @ alpha - 0.5 * (wz + wz.T) / s))


def icm_pcg_log_prob(K, B, St, Ydelta, eps, xi, roots=None,
                     max_cg_iters: int = 32, cg_tol: float = 1e-2,
                     matvec_bf16: bool = False, precond_rank: int = 256,
                     rows=None):
    """log N(vec(Y); 0, K ⊗ B + I ⊗ Σt) from ONE batched PCG pass:
    K (n, n) data kernel (bf16 for a bf16 matvec), B (t, t), Σt (t, t),
    Ydelta (n, t); eps (s, n, t) and xi (s, m, t) standard normals, m the
    roots' rank (``precond_rank`` when ``roots`` is None). Probes
    z = (eps + R·(ξ·√γ))·Pᵀ have covariance exactly M; logdet Σ = logdet M
    + Lanczos quadrature of the preconditioned tridiagonals. With ``rows``
    (a ``parallel.mesh.RowBlock`` over the world) K is the rank's (n_l, n)
    rows and every rank returns the whole value."""
    if roots is not None:
        roots = roots.detach()
    return _IcmPcgLogProb.apply(K, B, St, Ydelta, eps, xi, roots,
                                int(max_cg_iters), float(cg_tol),
                                bool(matvec_bf16), int(precond_rank), rows)


def icm_residual_spectral_bound(K, roots, B, n_iters: int = 12, v0=None,
                                generator=None, rows=None):
    """λmax bound of the ICM Nyström residual (K − R Rᵀ) ⊗ B, which
    factorizes as λmax(K − R Rᵀ) · λmax(B): power iteration on the n×n
    residual alone (one K stream an iteration), started at ``v0`` (n, 1) or
    a standard normal draw from ``generator`` (rank 0's under a mesh, where
    K is the rank's rows), times the exact t×t eigenvalue; each factor
    clamped at 0."""
    n = K.shape[-1]

    def resid_mv(v):
        Kv = K @ v if rows is None else rows.sum_rows(K @ v)
        return Kv - roots @ (roots.T @ v)

    if v0 is None:
        v0 = _start_vector((n, 1), generator, K, rows)
    v = v0 / torch.sqrt((v0 * v0).sum())
    for _ in range(n_iters):
        w = resid_mv(v)
        v = w / torch.clamp(torch.sqrt((w * w).sum()), min=1e-30)
    w = resid_mv(v)
    lam_K = torch.clamp((v * w).sum() / torch.clamp((v * v).sum(), min=1e-30),
                        min=0.0)
    lam_B = torch.clamp(torch.linalg.eigvalsh(0.5 * (B + B.T))[-1], min=0.0)
    return lam_K * lam_B
