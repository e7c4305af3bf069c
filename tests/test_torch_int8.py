"""The port's int8 path against the JAX package, on the CPU: kernel K8
(``cuda_kernels.quantized_kernel_stack``, TPU kernel B7), the int8 stack
product of ``ops/iterative``, the fused MLL and ``MultitaskGPModel.mll``
with ``matvec_int8=True``, and ``training.fit_two_phase``.

K8 runs only on the card (``chip_smoke.py``); here its plain version runs
beside the Pallas kernel in interpret mode. In float64 both packages round
the same profile values to the same int8 counts, and the int8 products are
exact integers on both sides, so the fused op agrees with JAX's as closely
as the fp32 and bf16 routes do (``tests/test_torch_fused_mll.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu.ops import fused_mll as jfm
from projected_lmc_tpu.ops import iterative as jit_
from projected_lmc_tpu.ops import pallas_kernels as pk
from projected_lmc_tpu.training import fit_two_phase as jax_fit_two_phase
from projected_lmc_tpu_torch import fit_two_phase
from projected_lmc_tpu_torch.ops import cuda_kernels as ck
from projected_lmc_tpu_torch.ops import fused_mll as tfm
from projected_lmc_tpu_torch.ops import iterative as tit
from test_torch_fused_mll import NAMES, make_problem
from test_torch_model import MLL_KW, carried_models, jax_probes

KINDS = ["matern25", "rbf", "matern15", "matern05"]
# int8 is a training-tolerance mode: its dynamic re-quantisation makes the
# CG operator slightly nonlinear, so CG runs at the JAX int8 tests' settings
INT8_CG = (32, 1e-3)


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


def inputs(seed, n=70, m=None, d=3, q=2):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-1, 1, (n, d))
    x2 = x1 if m is None else rng.uniform(-1, 1, (m, d))
    return x1, x2, rng.uniform(0.5, 1.5, (q, 1, d))


class TestQuantizedStack:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("m", [None, 45], ids=["square", "ragged"])
    def test_within_one_count_of_pallas(self, kind, m):
        """fp32, as tests/test_fused_mll.py::test_quantized_stack: the
        Pallas tile's short exp2 (rel. err ~2e-5) and expanded d² move
        127·g by ~1e-3, so a count may differ by one near a half."""
        x1, x2, ls = (a.astype(np.float32) for a in inputs(2, m=m))
        want = np.asarray(pk.quantized_kernel_stack(
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls), kind,
            interpret=True)).astype(int)
        got = ck.quantized_kernel_stack(t32(x1), t32(x2), t32(ls), kind,
                                        device="cpu")
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert np.abs(got.numpy().astype(int) - want).max() <= 1

    @pytest.mark.parametrize("kind", KINDS)
    def test_is_the_rounded_profile_in_float64(self, kind):
        """Exactly round(127·xla_kernel_matrix) (half to even), also in a
        zero-padded stack."""
        x1, x2, ls = inputs(3, n=61, m=37)
        want = np.asarray(jnp.round(pk.xla_kernel_matrix(
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls), kind) * 127.0
        ).astype(jnp.int8))
        got = ck.quantized_kernel_stack(t64(x1), t64(x2), t64(ls), kind,
                                        device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        padded = ck.quantized_kernel_stack(t64(x1), t64(x2), t64(ls), kind,
                                           padded_to=(64, 40), device="cpu")
        assert padded.shape == (2, 64, 40)
        np.testing.assert_array_equal(padded[:, :61, :37].numpy(), want)
        assert not padded[:, 61:].any() and not padded[:, :, 37:].any()

    def test_padding_below_the_shape_raises(self):
        x1, x2, ls = inputs(4, n=20)
        with pytest.raises(ValueError):
            ck.quantized_kernel_stack(t64(x1), t64(x2), t64(ls), "rbf",
                                      padded_to=(16, 24), device="cpu")

    def test_cpu_tensors_take_the_plain_version_without_a_launch(self):
        x1, x2, ls = inputs(5, n=20)
        before = ck.quantized_kernel_stack.launches
        ck.quantized_kernel_stack(t32(x1), t32(x2), t32(ls), "rbf",
                                  device="cpu")
        assert ck.quantized_kernel_stack.launches == before


def test_int8_width_fits_the_card_product():
    """A multiple of 8 above 16 (torch._int_mm's shape rules), ≥ n."""
    for n in (1, 16, 17, 24, 25, 2048, 10_000, 10_001):
        w = tit.int8_width(n)
        assert w >= n and w % 8 == 0 and w > 16 and w - max(n, 17) < 8


def test_quantize_and_matvec_int8_match_jax():
    """quantize_stack_int8 on the same float64 stack gives the same counts
    and fp32 scales; lmc_matvec_int8 on the same int8 inputs, with a 2-D and
    a 3-D right-hand side, the same product (exact integer sums on both
    sides), also from a zero-padded stack."""
    x, (ls, os_, H, St, Y), _, _, _ = make_problem(n=90)
    Ks = ck.scaled_kernel_stack_sym_plain(t64(x), t64(ls), t64(os_),
                                          "matern25")
    Qj, sj = jit_.quantize_stack_int8(jnp.asarray(Ks.numpy()))
    Qt, st = tit.quantize_stack_int8(Ks)
    assert Qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(Qt.numpy(), np.asarray(Qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    Qp = torch.nn.functional.pad(Qt, (0, tit.int8_width(90) - 90) * 2)
    V3 = np.random.default_rng(8).standard_normal((3,) + Y.shape)
    for V in (Y, V3):
        want = np.asarray(jit_.lmc_matvec_int8(Qj, sj, jnp.asarray(H),
                                               jnp.asarray(St),
                                               jnp.asarray(V)))
        got = tit.lmc_matvec_int8(Qt, st, t64(H), t64(St), t64(V))
        assert got.shape == V.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-13)
        assert torch.equal(tit.lmc_matvec_int8(Qp, st, t64(H), t64(St),
                                               t64(V)), got)


def test_pcg_quantises_a_float_stack_as_jax():
    """_pcg_fwd_impl with matvec_int8 on a float stack quantises it per
    latent (the JAX composed route's branch): the same value and solves as
    JAX's _pcg_fwd_impl (float64, rtol 1e-9)."""
    x, (ls, os_, H, St, Y), eps, xi, rank = make_problem(n=50, seed=6)
    Ks = ck.scaled_kernel_stack_sym_plain(t64(x), t64(ls), t64(os_), "rbf")
    roots = tit.nystrom_roots_from_kernels(Ks, rank)
    args = (H, St, Y, eps, xi, roots)
    # eager, as the JAX tests run it: under jit the fp32 scales absmax/127
    # come out one ulp apart, which moves the value by ~2e-8
    llj, resj = jit_._pcg_fwd_impl(jnp.asarray(Ks.numpy()),
                                   *map(jnp.asarray, args), *INT8_CG, False,
                                   rank, True)
    llt, (alpha, _, _) = tit._pcg_fwd_impl(Ks, *map(t64, args), *INT8_CG,
                                           False, rank, True)
    np.testing.assert_allclose(float(llt), float(llj), rtol=1e-9)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(resj[3]), rtol=1e-9,
                               atol=1e-12)


def jax_int8(x, leaves, eps, xi, rank, kind, roots):
    def f(*p):
        return jfm.lmc_pcg_log_prob_stationary(
            jax.lax.stop_gradient(jnp.asarray(x)), *p, jnp.asarray(eps),
            jnp.asarray(xi), None if roots is None else jnp.asarray(roots),
            kind, *INT8_CG, False, rank, True)
    v, g = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3, 4)))(
        *[jnp.asarray(a) for a in leaves])
    return float(v), [np.asarray(a) for a in g]


def torch_int8(x, leaves, eps, xi, rank, kind, roots):
    T = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
         for a in leaves]
    ll = tfm.lmc_pcg_log_prob_stationary(
        torch.tensor(x), *T, torch.tensor(eps), torch.tensor(xi),
        None if roots is None else torch.tensor(roots), kind, *INT8_CG,
        False, rank, matvec_int8=True, device="cpu")
    ll.backward()
    return float(ll.detach()), [a.grad.numpy() for a in T]


@pytest.mark.parametrize("kind", ["matern25", "rbf", "matern15"])
def test_fused_op_int8_matches_jax(kind):
    """float64: the two int8 stacks are equal, then value rtol 1e-9 and
    gradients rtol 1e-7 (the fused op's own parity tolerances), with the
    caller's Nyström roots (as the model passes them). Not Matérn-½: the
    JAX side's expanded d² (ROADMAP.md C)."""
    x, leaves, eps, xi, rank = make_problem()
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


def test_fused_op_int8_roots_from_the_int8_stack():
    """Without roots both sides build them from the dequantised int8 stack
    in fp32, through two LAPACK builds' fp32 Cholesky: agreement to the
    fp32 class (value 1e-6, gradients 1e-4 of their largest entry)."""
    x, leaves, eps, xi, rank = make_problem(seed=4)
    vj, gj = jax_int8(x, leaves, eps, xi, rank, "matern25", None)
    vt, gt = torch_int8(x, leaves, eps, xi, rank, "matern25", None)
    np.testing.assert_allclose(vt, vj, rtol=1e-6)
    for a, b, name in zip(gt, gj, NAMES):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


def test_int8_backward_takes_the_stack_route(monkeypatch):
    """An int8 stack never takes K4 or K5, whatever PLMC_KR_* ask; the
    forward built it with K8 at the card product's padded width."""
    monkeypatch.setenv("PLMC_KR_FUSED", "1")
    monkeypatch.setenv("PLMC_KR_STREAM", "1")
    shapes, kr = [], []
    real = ck.quantized_kernel_stack

    def spy(*args, **kw):
        out = real(*args, **kw)
        shapes.append(tuple(out.shape))
        return out
    monkeypatch.setattr(ck, "quantized_kernel_stack", spy)
    monkeypatch.setattr(tfm, "_lowrank_reduce_kr",
                        lambda *a, **k: kr.append(1))
    x, leaves, eps, xi, rank = make_problem(n=45)
    _, grads = torch_int8(x, leaves, eps, xi, rank, "rbf", None)
    assert shapes == [(3, 48, 48)] and kr == []
    assert all(np.all(np.isfinite(g)) for g in grads)


INT8_MLL = dict(MLL_KW, max_cg_iters=INT8_CG[0], cg_tol=INT8_CG[1])


def test_model_mll_int8_matches_jax():
    """MultitaskGPModel.mll(matvec_int8=True) on weights carried by
    load_jax_state, the JAX model's probes: value rtol 1e-9, gradients
    rtol 1e-7 (float64)."""
    jm, tm = carried_models()
    eps, xi = jax_probes()
    key = jax.random.PRNGKey(0)

    def jloss(raw_ls, factor, raw_noise, raw_tn):
        m = jm.replace(
            covar_module=jm.covar_module.replace(raw_lengthscale=raw_ls),
            covar_factor=factor,
            likelihood=jm.likelihood.replace(raw_noise=raw_noise,
                                             raw_task_noises=raw_tn))
        return m.mll(key=key, matvec_int8=True, **INT8_MLL)
    args = (jm.covar_module.raw_lengthscale, jm.covar_factor,
            jm.likelihood.raw_noise, jm.likelihood.raw_task_noises)
    vj, gj = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3)))(*args)
    vt = tm.mll(eps=eps, xi=xi, matvec_int8=True, **INT8_MLL)
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-9)
    tgrads = (tm.covar_module.raw_lengthscale.grad, tm.covar_factor.grad,
              tm.likelihood.raw_noise.grad, tm.likelihood.raw_task_noises.grad)
    for a, b, name in zip(tgrads, gj, ["raw_lengthscale", "covar_factor",
                                       "raw_noise", "raw_task_noises"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7,
                                   atol=1e-10, err_msg=name)


def test_fit_two_phase_matches_jax():
    """3 int8 steps, then 1 fp32 step at lr/10 (n_iter=4, fine_frac=0.25),
    the JAX loop's PRNGKey(0) probes given to the port: the same loss at
    each step (rtol 1e-9, float64), and the same phase bookkeeping."""
    jm, tm = carried_models(mean_type="constant")
    eps, xi = jax_probes()
    fine_kw = dict(MLL_KW, max_cg_iters=64, cg_tol=1e-10)
    _, jinfo = jax_fit_two_phase(
        jm, lambda m: m.mll(matvec_int8=True, **INT8_MLL),
        lambda m: m.mll(**fine_kw), n_iter=4, lr=0.05, patience=100)
    _, tinfo = fit_two_phase(
        tm, lambda m: m.mll(eps=eps, xi=xi, matvec_int8=True, **INT8_MLL),
        lambda m: m.mll(eps=eps, xi=xi, **fine_kw), n_iter=4, lr=0.05,
        patience=100, device="cpu")
    assert [len(p["losses"]) for p in tinfo["phases"]] == [3, 1]
    assert tinfo["n_iter"] == jinfo["n_iter"] == 4
    np.testing.assert_allclose(tinfo["losses"], jinfo["losses"], rtol=1e-9)
    assert tinfo["loss"] == tinfo["phases"][1]["loss"]
