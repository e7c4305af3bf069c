"""The port's one-pass fused backward (kernels K4 and K5 of
``projected_lmc_tpu_torch.ops.cuda_kernels``) and its routing in
``ops/fused_mll``, against the JAX package on the CPU.

K4 and K5 run only on the card (``chip_smoke.py``); here their plain
versions run beside the Pallas kernels they replace, in interpret mode, on
the same numpy-seeded inputs. The fused op on the kr and krs routes is held
against the JAX fused op in float64; on the CPU the JAX op takes its stack
product route, which is the same math.
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


def factors(n, seed, d=3, B=2, r2=4):
    """x, lengthscales, outputscales in [0.5, 2] and factors with A Bfᵀ
    symmetric, as the fused backward builds them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, (B, 1, d)).astype(np.float32)
    os_ = rng.uniform(0.5, 2.0, (B,)).astype(np.float32)
    U = rng.standard_normal((B, n, r2)).astype(np.float32)
    V = rng.standard_normal((B, n, r2)).astype(np.float32)
    return x, ls, os_, np.concatenate([U, V], -1), np.concatenate([V, U], -1)


def assert_kr_close(got, want, kind, rtol_rows=None, atol_rows=5e-3,
                    rtol_ka=2e-3, atol_ka=2e-2):
    """rows and wx at the port's K2 tolerances (the Pallas body's exp2
    sequence, ~2e-5 relative, summed over n columns; Matérn-½'s g′ = −e^{−r}/2r
    magnifies the Pallas d² expansion's fp32 cancellation by 1/r, hence 5×
    looser), KA at the JAX tests' own (tests/test_fused_mll.py)."""
    if rtol_rows is None:
        rtol_rows = 5e-3 if kind == "matern05" else 1e-3
    for g, w, name in zip(got[:2], want[:2], ("rows", "wx")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol_rows,
                                   atol=atol_rows, err_msg=f"{kind} {name}")
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=rtol_ka, atol=atol_ka,
                               err_msg=f"{kind} KA")


class TestPlainVersionsAgainstPallas:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("n", [130, 200])           # 130: ragged tile
    def test_kr(self, kind, n):
        x, ls, os_, A, Bf = factors(n, seed=21)
        want = pk.lowrank_stationary_reduce_sym_kr(
            jnp.asarray(x), jnp.asarray(ls), jnp.asarray(os_), jnp.asarray(A),
            jnp.asarray(Bf), kind, interpret=True)
        got = ck.lowrank_stationary_reduce_sym_kr(
            t32(x), t32(ls), t32(os_), t32(A), t32(Bf), kind, device="cpu")
        assert [tuple(a.shape) for a in got] == [(2, n), (2, n, 3), (2, n, 8)]
        assert_kr_close(got, want, kind)

    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("n", [130, 200])
    def test_krs_fp32_stack(self, kind, n):
        """Both read the same symmetric os-scaled stack (the port's K1
        plain version, exactly symmetric)."""
        x, ls, os_, A, Bf = factors(n, seed=22)
        Ks = ck.scaled_kernel_stack_sym_plain(t32(x), t32(ls), t32(os_), kind)
        want = pk.lowrank_stationary_reduce_sym_krs(
            jnp.asarray(x), jnp.asarray(ls), jnp.asarray(os_), jnp.asarray(A),
            jnp.asarray(Bf), jnp.asarray(Ks.numpy()), kind, interpret=True)
        got = ck.lowrank_stationary_reduce_sym_krs(
            t32(x), t32(ls), t32(os_), t32(A), t32(Bf), Ks, kind,
            device="cpu")
        assert_kr_close(got, want, kind)

    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("n", [130, 200])
    def test_krs_bf16_stack(self, kind, n):
        """A bf16 stack: g′ inherits its rounding on both sides; tolerances
        of the JAX package's bf16-stack test."""
        x, ls, os_, A, Bf = factors(n, seed=23)
        Ks = ck.scaled_kernel_stack_sym_plain(t32(x), t32(ls), t32(os_), kind,
                                              torch.bfloat16)
        want = pk.lowrank_stationary_reduce_sym_krs(
            jnp.asarray(x), jnp.asarray(ls), jnp.asarray(os_), jnp.asarray(A),
            jnp.asarray(Bf), jnp.asarray(Ks.float().numpy(), jnp.bfloat16),
            kind, interpret=True)
        got = ck.lowrank_stationary_reduce_sym_krs(
            t32(x), t32(ls), t32(os_), t32(A), t32(Bf), Ks, kind,
            device="cpu")
        assert_kr_close(got, want, kind, rtol_rows=2e-2, atol_rows=5e-2,
                        rtol_ka=2e-2, atol_ka=2e-1)

    def test_krs_on_a_fresh_stack_is_kr(self):
        """fp64, exact stack: the rational identity gives K4's g′."""
        x, ls, os_, A, Bf = (torch.tensor(a, dtype=torch.float64)
                             for a in factors(90, seed=24))
        for kind in KINDS:
            Ks = ck.scaled_kernel_stack_sym_plain(x, ls, os_, kind)
            for a, b in zip(
                    ck.lowrank_stationary_reduce_sym_krs(x, ls, os_, A, Bf, Ks,
                                                         kind, device="cpu"),
                    ck.lowrank_stationary_reduce_sym_kr(x, ls, os_, A, Bf,
                                                        kind, device="cpu")):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                           atol=1e-10, err_msg=kind)

    def test_cpu_tensors_take_plain_versions_without_a_launch(self):
        x, ls, os_, A, Bf = (t32(a) for a in factors(20, seed=25))
        Ks = ck.scaled_kernel_stack_sym_plain(x, ls, os_, "rbf")
        before = (ck.lowrank_stationary_reduce_sym_kr.launches,
                  ck.lowrank_stationary_reduce_sym_krs.launches)
        ck.lowrank_stationary_reduce_sym_kr(x, ls, os_, A, Bf, "rbf",
                                            device="cpu")
        ck.lowrank_stationary_reduce_sym_krs(x, ls, os_, A, Bf, Ks, "rbf",
                                             device="cpu")
        assert before == (ck.lowrank_stationary_reduce_sym_kr.launches,
                          ck.lowrank_stationary_reduce_sym_krs.launches)


class TestRouting:
    """``_use_kr_fused`` / ``_use_kr_stream`` as the JAX package's
    (tests/test_fused_mll.py test_kr_routing, test_krs_routing), with the
    port's measured ``KR_MIN_N`` in place of the TPU's VMEM gate."""

    def test_kr_fused(self, monkeypatch):
        monkeypatch.delenv("PLMC_KR_FUSED", raising=False)
        if tfm.KR_MIN_N is None:                 # K4 is the default nowhere
            assert not tfm._use_kr_fused(10 ** 6)
        monkeypatch.setattr(tfm, "KR_MIN_N", 20_000)
        assert not tfm._use_kr_fused(19_999)
        assert tfm._use_kr_fused(20_000)
        # the override is read at each call, not at import
        monkeypatch.setenv("PLMC_KR_FUSED", "1")
        assert tfm._use_kr_fused(64)
        monkeypatch.setenv("PLMC_KR_FUSED", "0")
        assert not tfm._use_kr_fused(10 ** 6)

    def test_kr_stream(self, monkeypatch):
        bf = torch.zeros((2, 8, 8), dtype=torch.bfloat16)
        i8 = torch.zeros((2, 8, 8), dtype=torch.int8)
        monkeypatch.delenv("PLMC_KR_STREAM", raising=False)
        assert not tfm._use_kr_stream(bf) and not tfm._use_kr_stream(i8)
        monkeypatch.setenv("PLMC_KR_STREAM", "1")
        assert tfm._use_kr_stream(bf) and not tfm._use_kr_stream(i8)
        monkeypatch.setenv("PLMC_KR_STREAM", "0")
        assert not tfm._use_kr_stream(bf)

    def test_backward_route(self, monkeypatch):
        monkeypatch.delenv("PLMC_KR_FUSED", raising=False)
        monkeypatch.delenv("PLMC_KR_STREAM", raising=False)
        monkeypatch.setattr(tfm, "KR_MIN_N", 64)
        small = torch.zeros((1, 8, 8), dtype=torch.bfloat16)
        big = torch.zeros((1, 1, 1), dtype=torch.bfloat16).expand(1, 64, 64)
        assert tfm._backward_route(small) == "stack"
        assert tfm._backward_route(big) == "kr"
        monkeypatch.setenv("PLMC_KR_FUSED", "0")
        monkeypatch.setenv("PLMC_KR_STREAM", "1")      # streaming wins
        assert tfm._backward_route(small) == "krs"


@pytest.mark.parametrize("env", ["PLMC_KR_FUSED", "PLMC_KR_STREAM"])
@pytest.mark.parametrize("kind", ["matern25", "rbf", "matern15"])
def test_fused_op_on_the_kr_routes_matches_jax(monkeypatch, env, kind):
    """float64, tight CG: value rtol 1e-9, gradients 1e-7 against the JAX
    fused op (tests/test_torch_fused_mll.py), and the backward went
    through the one-pass reduction. (Not Matérn-½: the JAX side's expanded
    d² leaves ~1e-16 on the diagonal, which its √ turns into 1e-8 in K;
    ROADMAP.md C.)"""
    monkeypatch.delenv("PLMC_KR_FUSED", raising=False)
    monkeypatch.delenv("PLMC_KR_STREAM", raising=False)
    monkeypatch.setenv(env, "1")
    calls = []
    real = tfm._lowrank_reduce_kr

    def spy(*args, **kw):
        calls.append(kw.get("Ks") is not None)
        return real(*args, **kw)
    monkeypatch.setattr(tfm, "_lowrank_reduce_kr", spy)
    x, leaves, eps, xi, rank = make_problem()
    vj, gj = jax_value_and_grads(x, leaves, eps, xi, rank, kind)
    vt, gt = torch_value_and_grads(x, leaves, eps, xi, rank, kind)
    assert calls == [env == "PLMC_KR_STREAM"]
    np.testing.assert_allclose(vt, vj, rtol=1e-9)
    for a, b, name in zip(gt, gj, NAMES):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9,
                                   err_msg=f"cotangent mismatch for {name}")
