"""The PyTorch port's kernel layer against the JAX package, on the CPU.

Each CUDA kernel of ``projected_lmc_tpu_torch.ops.cuda_kernels`` has a plain
PyTorch version; here that version runs on numpy-seeded inputs beside the
Pallas kernel it replaces, in interpret mode, as the JAX package's own tests
run it. The kernels themselves run only on the card (``chip_smoke.py``).
Also: the custom-backward kernel matrix, ``safe_cholesky``, PCG with its
tridiagonals, and the port's import and device rules.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu import kernels as jkern
from projected_lmc_tpu.ops import cholesky as jchol
from projected_lmc_tpu.ops import iterative as jit_
from projected_lmc_tpu.ops import pallas_kernels as pk
from projected_lmc_tpu_torch import kernels as tkern
from projected_lmc_tpu_torch.ops import cholesky as tchol
from projected_lmc_tpu_torch.ops import cuda_kernels as ck
from projected_lmc_tpu_torch.ops import iterative as tit

CPU = "cpu"


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


def t64(a):
    return torch.tensor(np.asarray(a, np.float64))


class TestPlainVersionsAgainstPallas:
    """fp32, Pallas in interpret mode. The Pallas tiles use the same
    |a|²+|b|²−2⟨a,b⟩ expansion; K2's Pallas body also uses the short exp2
    (rel. err ~2e-5), hence its looser tolerance."""

    @pytest.mark.parametrize("n", [70, 300])
    def test_scaled_stack_sym(self, n):
        rng = np.random.default_rng(3)
        x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        ls = rng.uniform(0.5, 1.5, (2, 1, 3)).astype(np.float32)
        os_ = np.float32([0.7, 1.9])
        want = pk.scaled_kernel_stack_sym(jnp.asarray(x), jnp.asarray(ls),
                                          jnp.asarray(os_), "matern25",
                                          interpret=True)
        got = ck.scaled_kernel_stack_sym(t32(x), t32(ls), t32(os_),
                                         "matern25", device=CPU)
        assert got.shape == (2, n, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=2e-6)

    def test_scaled_stack_sym_bf16(self):
        """bf16 result = the fp32 result rounded once (the TPU's bf16 tiles
        differ from it by at most one bf16 step: 2⁻⁸ relative)."""
        rng = np.random.default_rng(5)
        x = t32(rng.uniform(-1, 1, (90, 4)))
        ls = t32(rng.uniform(0.5, 1.5, (3, 1, 4)))
        os_ = t32(rng.uniform(0.5, 2.0, (3,)))
        full = ck.scaled_kernel_stack_sym(x, ls, os_, "rbf", device=CPU)
        half = ck.scaled_kernel_stack_sym(x, ls, os_, "rbf", torch.bfloat16,
                                          device=CPU)
        assert half.dtype == torch.bfloat16
        assert torch.equal(half, full.to(torch.bfloat16))

    @pytest.mark.parametrize("kind", ["matern25", "rbf", "matern15",
                                      "matern05"])
    def test_lowrank_reduce_sym(self, kind):
        rng = np.random.default_rng(4)
        n, d, B, r2 = 130, 2, 3, 3               # 130: a ragged Pallas tile
        x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
        ls = rng.uniform(0.5, 1.5, (B, 1, d)).astype(np.float32)
        U = rng.standard_normal((B, n, r2)).astype(np.float32)
        V = rng.standard_normal((B, n, r2)).astype(np.float32)
        A = np.concatenate([U, V], -1)
        Bf = np.concatenate([V, U], -1)          # A Bfᵀ symmetric
        rows_j, wx_j = pk.lowrank_stationary_reduce_sym(
            jnp.asarray(x), jnp.asarray(ls), jnp.asarray(A), jnp.asarray(Bf),
            kind, interpret=True)
        rows, wx = ck.lowrank_stationary_reduce_sym(
            t32(x), t32(ls), t32(A), t32(Bf), kind, device=CPU)
        assert rows.shape == (B, n) and wx.shape == (B, n, d)
        # the Pallas body's exp2 sequence (rel. err ~2e-5) summed over 130
        # columns of magnitude ~10: the JAX tests' own fast-vs-exact class.
        # Matérn-½'s g′ = −e^{−r}/2r magnifies the Pallas d² expansion's
        # fp32 cancellation for near-coincident pairs by 1/r: 5× looser.
        rtol = 5e-3 if kind == "matern05" else 1e-3
        np.testing.assert_allclose(rows.numpy(), np.asarray(rows_j),
                                   rtol=rtol, atol=5e-3)
        np.testing.assert_allclose(wx.numpy(), np.asarray(wx_j),
                                   rtol=rtol, atol=5e-3)

    @pytest.mark.parametrize("kind", ["matern25", "rbf", "matern15",
                                      "matern05"])
    @pytest.mark.parametrize("lo, hi", [(0, 70), (37, 130)])
    def test_lowrank_reduce_row_block(self, kind, lo, hi):
        """K7's row-block form (a rank's rows under a mesh): its plain
        version on rows lo..hi − 1 (x1 = x[lo:hi] with A's rows, against all
        of x with Bf) equals those rows of the square plain version exactly,
        and those rows of JAX's ``lowrank_stationary_reduce`` in interpret
        mode at K2's tolerance above (factors with no symmetry)."""
        rng = np.random.default_rng(8)
        n, d, B, r = 130, 2, 3, 5
        x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
        ls = rng.uniform(0.5, 1.5, (B, 1, d)).astype(np.float32)
        A = rng.standard_normal((B, n, r)).astype(np.float32)
        Bf = rng.standard_normal((B, n, r)).astype(np.float32)
        rows_j, wx_j = pk.lowrank_stationary_reduce(
            jnp.asarray(x), jnp.asarray(ls), jnp.asarray(A), jnp.asarray(Bf),
            kind, interpret=True)
        rows, wx = ck.lowrank_stationary_reduce(
            t32(x), t32(ls), t32(A[:, lo:hi]), t32(Bf), kind, device=CPU,
            row_x=t32(x[lo:hi]))
        assert rows.shape == (B, hi - lo) and wx.shape == (B, hi - lo, d)
        rows_sq, wx_sq = ck.lowrank_stationary_reduce(
            t32(x), t32(ls), t32(A), t32(Bf), kind, device=CPU)
        assert torch.equal(rows, rows_sq[:, lo:hi])
        assert torch.equal(wx, wx_sq[:, lo:hi])
        rtol = 5e-3 if kind == "matern05" else 1e-3
        np.testing.assert_allclose(rows.numpy(), np.asarray(rows_j)[:, lo:hi],
                                   rtol=rtol, atol=5e-3)
        np.testing.assert_allclose(wx.numpy(), np.asarray(wx_j)[:, lo:hi],
                                   rtol=rtol, atol=5e-3)

    @pytest.mark.parametrize("kind", ["matern25", "rbf", "matern15",
                                      "matern05"])
    def test_kernel_matrix(self, kind):
        rng = np.random.default_rng(6)
        x1 = rng.uniform(-1, 1, (140, 4)).astype(np.float32)
        x2 = x1[np.linspace(0, 139, 20).astype(np.int32)]
        ls = rng.uniform(0.5, 1.5, (3, 1, 4)).astype(np.float32)
        want = pk.fused_kernel_matrix(jnp.asarray(x1), jnp.asarray(x2),
                                      jnp.asarray(ls), kind, True)
        got = ck.kernel_matrix(t32(x1), t32(x2), t32(ls), kind, device=CPU)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("kind", ["matern25", "rbf", "matern15",
                                      "matern05"])
    @pytest.mark.parametrize("stack", [None, "fp32"])
    def test_kr_row_block_against_pallas(self, kind, stack):
        """K4's and K5's row-block forms (a rank's rows under a mesh) on a
        square input, every row a block row: their plain versions (rows x
        with Bf against columns x with A) beside JAX's
        ``lowrank_stationary_reduce_sym_kr`` / ``_krs`` in interpret mode
        on the same symmetric factors and os-scaled stack, at the square
        plain versions' tolerances against Pallas
        (``tests/test_torch_kr.py``: K2's for rows and wx, the JAX tests'
        for KA)."""
        x, ls, os_, A, Bf = _kr_factors(130, 31, d=3)
        args = [jnp.asarray(a) for a in (x, ls, os_, A, Bf)]
        if stack is None:
            want = pk.lowrank_stationary_reduce_sym_kr(*args, kind,
                                                       interpret=True)
            got = ck.lowrank_stationary_reduce_rows_kr(
                t32(x), t32(x), t32(ls), t32(os_), t32(Bf), t32(A), kind,
                device=CPU)
        else:
            Ks = ck.scaled_kernel_stack_sym_plain(t32(x), t32(ls), t32(os_),
                                                  kind)
            want = pk.lowrank_stationary_reduce_sym_krs(
                *args, jnp.asarray(Ks.numpy()), kind, interpret=True)
            got = ck.lowrank_stationary_reduce_rows_krs(
                t32(x), t32(x), t32(ls), t32(os_), t32(Bf), t32(A), Ks, kind,
                device=CPU)
        assert [tuple(a.shape) for a in got] == [(2, 130), (2, 130, 3),
                                                 (2, 130, 8)]
        rtol = 5e-3 if kind == "matern05" else 1e-3
        for g, w, name in zip(got[:2], want[:2], ("rows", "wx")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                       atol=5e-3, err_msg=name)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=2e-3, atol=2e-2, err_msg="KA")

    @pytest.mark.parametrize("d", [1, 4, 21])
    def test_kr_row_blocks_are_the_square_rows(self, d):
        """float64: on rows lo..hi − 1 the row-block plain versions equal
        those rows of the square plain versions (K4's, and K5's on the
        stack's rows), for each profile, to rounding (A Bfᵀ is symmetric
        only up to the order of its sums)."""
        x, ls, os_, A, Bf = (t64(a) for a in _kr_factors(90, 32, d=d))
        for kind in ("matern25", "rbf", "matern15", "matern05"):
            square = ck.lowrank_stationary_reduce_sym_kr(x, ls, os_, A, Bf,
                                                         kind, device=CPU)
            Ks = ck.scaled_kernel_stack_sym_plain(x, ls, os_, kind)
            for lo, hi in ((0, 40), (37, 90)):
                blocks = (
                    ck.lowrank_stationary_reduce_rows_kr(
                        x[lo:hi], x, ls, os_, Bf[:, lo:hi], A, kind,
                        device=CPU),
                    ck.lowrank_stationary_reduce_rows_krs(
                        x[lo:hi], x, ls, os_, Bf[:, lo:hi], A, Ks[:, lo:hi],
                        kind, device=CPU))
                for got in blocks:
                    for g, w in zip(got, square):
                        w = w[:, lo:hi]
                        assert g.shape == w.shape
                        np.testing.assert_allclose(
                            g.numpy(), w.numpy(), rtol=1e-11,
                            atol=1e-12 * float(w.abs().max()),
                            err_msg=f"{kind} d={d} rows {lo}:{hi}")


def _kr_factors(n, seed, d=3, B=2, r2=4):
    """x, lengthscales, outputscales in [0.5, 2], and factors A, Bf with
    A Bfᵀ symmetric, as the fused backward builds them (float32)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, (B, 1, d)).astype(np.float32)
    os_ = rng.uniform(0.5, 2.0, (B,)).astype(np.float32)
    U = rng.standard_normal((B, n, r2)).astype(np.float32)
    V = rng.standard_normal((B, n, r2)).astype(np.float32)
    return x, ls, os_, np.concatenate([U, V], -1), np.concatenate([V, U], -1)


class TestWrapperRouting:
    def test_cpu_tensors_take_plain_version_without_a_launch(self):
        rng = np.random.default_rng(0)
        x = t32(rng.standard_normal((20, 2)))
        ls = t32(np.ones((2, 1, 2)))
        before = (ck.scaled_kernel_stack_sym.launches,
                  ck.lowrank_stationary_reduce_sym.launches,
                  ck.kernel_matrix.launches)
        ck.scaled_kernel_stack_sym(x, ls, t32([1.0, 2.0]), "rbf", device=CPU)
        ck.kernel_matrix(x, x, ls, "rbf", device=CPU)
        A = t32(rng.standard_normal((2, 20, 3)))
        ck.lowrank_stationary_reduce_sym(x, ls, A, A, "rbf", device=CPU)
        assert before == (ck.scaled_kernel_stack_sym.launches,
                          ck.lowrank_stationary_reduce_sym.launches,
                          ck.kernel_matrix.launches)

    def test_default_device_is_cuda_and_raises_without_a_card(self,
                                                             monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        x = t32(np.zeros((4, 2)))
        with pytest.raises(RuntimeError, match="cuda"):
            ck.kernel_matrix(x, x, t32(np.ones((1, 1, 2))), "rbf")

    def test_device_mismatch_raises(self):
        x = t32(np.zeros((4, 2)))
        with pytest.raises(ValueError):
            ck.kernel_matrix(x, x, t32(np.ones((1, 1, 2))), "rbf",
                             device="meta")


class TestStationaryKernelMatrix:
    @pytest.mark.parametrize("kind", ["matern25", "rbf"])
    def test_value_and_gradients_vs_jax(self, kind):
        """fp64: the custom backward (``_skm_bwd``) for x1, x2 and ls."""
        rng = np.random.default_rng(8)
        x1 = rng.standard_normal((30, 3)) + 5.0    # offset: centring matters
        x2 = rng.standard_normal((17, 3)) + 5.0
        ls = rng.uniform(0.5, 1.5, (2, 1, 3))
        C = rng.standard_normal((2, 30, 17))

        def f(a, b, l):
            return jnp.sum(jkern.stationary_kernel_matrix(a, b, l, kind) * C)
        v, g = jax.value_and_grad(f, argnums=(0, 1, 2))(
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls))
        T = [t64(a).requires_grad_(True) for a in (x1, x2, ls)]
        out = (tkern.stationary_kernel_matrix(*T, kind, device=CPU)
               * t64(C)).sum()
        out.backward()
        np.testing.assert_allclose(float(out.detach()), float(v), rtol=1e-12)
        for a, b in zip(T, g):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                       rtol=1e-9, atol=1e-12)

    def test_slabbed_backward_matches_monolithic(self, monkeypatch):
        """The row-slab reductions (memory-pressure path) equal the
        monolithic ones; forced here at a small size."""
        rng = np.random.default_rng(9)
        x1 = t32(rng.standard_normal((50, 2)))
        x2 = t32(rng.standard_normal((40, 2)))
        ls = t32(rng.uniform(0.5, 1.5, (2, 1, 2)))
        g = t32(rng.standard_normal((2, 50, 40)))
        full = tkern._skm_bwd_reductions("matern25", x1, x2, ls, g)
        monkeypatch.setattr(tkern, "_BWD_SLAB_MIN", 0)
        monkeypatch.setattr(tkern, "_BWD_SLAB", 16)
        slab = tkern._skm_bwd_reductions("matern25", x1, x2, ls, g)
        for a, b in zip(full, slab):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


class TestCholesky:
    def test_safe_cholesky_needs_jitter(self):
        """A rank-deficient PSD matrix fails the plain factorization; the
        ladder's factor and its pullback match JAX (fp64)."""
        rng = np.random.default_rng(10)
        V = rng.standard_normal((3, 12, 9))
        A = V @ np.swapaxes(V, -1, -2)           # rank 9 < 12
        C = rng.standard_normal((3, 12, 12))
        assert not np.all(np.isfinite(np.asarray(
            jnp.linalg.cholesky(jnp.asarray(A)))))
        v, g = jax.value_and_grad(
            lambda a: jnp.sum(jchol.safe_cholesky(a) * C))(jnp.asarray(A))
        At = t64(A).requires_grad_(True)
        L = tchol.safe_cholesky(At)
        # A + 1e-8·I keeps a condition number ~1e9, so two LAPACK builds
        # agree to ~1e-10 in L and ~1e-8 (relative to its largest entry) in
        # the pullback
        np.testing.assert_allclose(L.detach().numpy(),
                                   np.asarray(jchol.safe_cholesky(
                                       jnp.asarray(A))), rtol=1e-7,
                                   atol=1e-9)
        (L * t64(C)).sum().backward()
        g = np.asarray(g)
        np.testing.assert_allclose(At.grad.numpy(), g, rtol=1e-6,
                                   atol=1e-7 * np.abs(g).max())

    def test_solves_and_logdet(self):
        rng = np.random.default_rng(11)
        M = rng.standard_normal((2, 6, 6))
        A = M @ np.swapaxes(M, -1, -2) + 6 * np.eye(6)
        B = rng.standard_normal((2, 6, 3))
        L = jnp.linalg.cholesky(jnp.asarray(A))
        Lt = t64(np.asarray(L))
        np.testing.assert_allclose(tchol.cho_solve(Lt, t64(B)).numpy(),
                                   np.asarray(jchol.cho_solve(L, jnp.asarray(B))),
                                   rtol=1e-10)
        np.testing.assert_allclose(
            tchol.solve_triangular(Lt, t64(B), lower=True, trans=True).numpy(),
            np.asarray(jchol.solve_triangular(L, jnp.asarray(B), lower=True,
                                              trans=True)), rtol=1e-10)
        np.testing.assert_allclose(tchol.logdet_from_chol(Lt).numpy(),
                                   np.asarray(jchol.logdet_from_chol(L)),
                                   rtol=1e-12)


class TestPCG:
    def _system(self, n=40, t=3, r=4, seed=12):
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((n * t, n * t))
        S = M @ M.T / (n * t) + np.eye(n * t)
        B = rng.standard_normal((r, n, t))
        P = np.diag(1.0 / np.diag(S))            # Jacobi preconditioner
        return S, B, P

    @pytest.mark.parametrize("max_iters,tol", [(60, 1e-9), (8, 1e-9)],
                             ids=["converges-early", "runs-out"])
    def test_pcg_with_tridiag_and_logquad_vs_jax(self, max_iters, tol):
        """Same solves, coefficients and quadrature as the JAX while_loop,
        also when every RHS converges before ``max_iters`` (JAX exits early,
        the port runs the remaining iterations masked)."""
        S, B, P = self._system()
        n, t = B.shape[1:]

        def mv_j(V):
            return (V.reshape(V.shape[0], -1) @ S).reshape(V.shape)

        def pre_j(V):
            return (V.reshape(V.shape[0], -1) @ P).reshape(V.shape)
        Xj, aj, bj, actj, rzj = jit_.pcg_with_tridiag(
            mv_j, jnp.asarray(B), pre_j, max_iters, tol)
        St, Pt = t64(S), t64(P)
        Xt, at, bt, actt, rzt = tit.pcg_with_tridiag(
            lambda V: (V.reshape(V.shape[0], -1) @ St).reshape(V.shape),
            t64(B),
            lambda V: (V.reshape(V.shape[0], -1) @ Pt).reshape(V.shape),
            max_iters, tol)
        actj = np.asarray(actj)
        if max_iters == 60:
            assert not actj[-1].any()            # JAX stopped early
        np.testing.assert_array_equal(actt.numpy(), actj)
        np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(rzt.numpy(), np.asarray(rzj), rtol=1e-12)
        np.testing.assert_allclose(at.numpy()[actj], np.asarray(aj)[actj],
                                   rtol=1e-9)
        np.testing.assert_allclose(bt.numpy()[actj], np.asarray(bj)[actj],
                                   rtol=1e-8, atol=1e-14)
        qj = jit_._tridiag_logquad(aj, bj, jnp.asarray(actj))
        qt = tit._tridiag_logquad(at, bt, actt)
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-9)

    def test_breakdown_restarts_from_steepest_descent(self):
        """pAp ≤ 0 (an indefinite operator) restarts the RHS instead of
        dividing by it: finite output, step recorded inactive — as JAX."""
        S, B, P = self._system(n=10, t=2, r=2, seed=13)
        S = S - 3.5 * np.eye(S.shape[0])           # make it indefinite
        out_j = jit_.pcg_with_tridiag(
            lambda V: (V.reshape(V.shape[0], -1) @ S).reshape(V.shape),
            jnp.asarray(B), lambda V: V, 6, 1e-12)
        St = t64(S)
        out_t = tit.pcg_with_tridiag(
            lambda V: (V.reshape(V.shape[0], -1) @ St).reshape(V.shape),
            t64(B), lambda V: V, 6, 1e-12)
        assert np.all(np.isfinite(out_t[0].numpy()))
        np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
        np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                                   rtol=1e-8, atol=1e-10)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port (the projected model, the MLLs, the
    synthetic data, the prediction modules, the variational model, the
    blocked Cholesky, the study driver, the real-data loaders, the plots,
    the profiling helpers, the mesh layer and the entry points among them),
    imported in a fresh interpreter,
    leaves no ``jax`` or ``projected_lmc_tpu`` module behind."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import projected_lmc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = {'models.projected', 'mlls', 'experiments.synthetic',\n"
        "        'ops.woodbury', 'distributions', 'metrics',\n"
        "        'models.variational', 'ops.blocked_cholesky',\n"
        "        'utils.checkpoint', 'experiments.driver',\n"
        "        'experiments.realdata', 'experiments.plots',\n"
        "        'utils.profiling', 'parallel', 'parallel.mesh',\n"
        "        'parallel.sharded', 'parallel.distributed',\n"
        "        'parallel.collectives', 'parallel.launch', 'entry'}\n"
        "assert all(p.__name__ + '.' + m in sys.modules for m in need)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'projected_lmc_tpu'\n"
        "       or m.startswith('projected_lmc_tpu.')]\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('projected_lmc_tpu_torch')]))\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.strip()) >= 15
