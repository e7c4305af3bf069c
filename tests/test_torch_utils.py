"""The port's per-batch 3-D kernel inputs, its profiling and device
helpers, and the stragglers of the model surface, against the JAX package
on the CPU (float64).

3-D inputs (``Kernel._inputs``, as the JAX ``Kernel.__call__``): (B, n, d)
inputs, a 2-D one broadcast to the batch, the active features sliced on the
last axis, for every kernel family; values 1e-10 relative (1e-7 for
Matérn-½ at coincident points), gradients 1e-7.
``constraints.lower_triangular_param_inverse`` 1e-12;
``ops.cholesky.safe_cholesky_with_jitter``: the jitter exactly, the factor
1e-10, its gradient 1e-7; ``means.Mean`` as the base of the four means.
``Timer``, ``profile_trace`` and ``ensure_cuda`` on a host with no card.
"""

import glob
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from projected_lmc_tpu import constraints as jcons
from projected_lmc_tpu import kernels as jker
from projected_lmc_tpu import means as jmeans
from projected_lmc_tpu.ops import cholesky as jchol
from projected_lmc_tpu.utils import profiling as jprof
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import constraints as tcons
from projected_lmc_tpu_torch import kernels as tker
from projected_lmc_tpu_torch import load_jax_state
from projected_lmc_tpu_torch import means as tmeans
from projected_lmc_tpu_torch.module import keyed_state
from projected_lmc_tpu_torch.ops import cholesky as tchol
from projected_lmc_tpu_torch.utils import device as tdevice
from projected_lmc_tpu_torch.utils import profiling as tprof

D, B = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny torch ops: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def close(got, want, rtol, what=""):
    got, want = (v.detach().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v) for v in (got, want))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(initial=0.0),
                               err_msg=what)


# -- per-batch 3-D kernel inputs -------------------------------------------------

FAMILIES = {
    "rbf": dict(kernel_type="rbf"),
    "matern05": dict(kernel_type="matern", ker_kwargs=dict(nu=0.5)),
    "matern25": dict(kernel_type="matern"),
    "additive": dict(kernel_type="matern", decomp=[[0, 1], [2]]),
    "spline": dict(kernel_type="spline"),
    "spectral_mixture": dict(kernel_type="spectral_mixture",
                             ker_kwargs=dict(num_mixtures=3, seed=4)),
}


def kernel_pair(family):
    """A JAX kernel (Scale-wrapped, leaves moved off their defaults) and
    the port's carrying its leaves."""
    kw = FAMILIES[family]
    jk = jker.handle_covar(dim=D, n_funcs=B, dtype=jnp.float64, **kw)
    tk = tker.handle_covar(dim=D, n_funcs=B, dtype=torch.float64,
                           device="cpu", **kw)
    rng = np.random.default_rng(3)
    arrays = {k: np.asarray(v) + rng.uniform(-0.3, 0.3, np.shape(v))
              for k, v in _keyed_leaves(jk)}
    jk = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jk),
        [jnp.asarray(arrays[k]) for k, _ in _keyed_leaves(jk)])
    load_jax_state(tk, arrays)
    return jk, tk


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batched_inputs_match_jax(family):
    """(B, n, d) against (B, m, d), against a shared 2-D x2, and with
    itself; the diagonal; and the gradients of a weighted sum with respect
    to every leaf and to x1."""
    jk, tk = kernel_pair(family)
    rng = np.random.default_rng(0)
    x1 = rng.uniform(-1, 1, (B, 7, D))
    x2 = rng.uniform(-1, 1, (B, 5, D))
    shared = rng.uniform(-1, 1, (5, D))
    for a, b in ((x1, x2), (x1, shared), (x1, None)):
        got = tk(t64(a), None if b is None else t64(b))
        want = jk(a, b)
        assert tuple(got.shape) == want.shape
        # x1 with itself: the port sums d² from direct differences (0 at
        # coincident points), JAX expands |a|² + |b|² − 2⟨a, b⟩ (~1e-16),
        # which Matérn-½'s exp(−√d²) turns into 1e-8
        close(got, want, 1e-7 if family == "matern05" and b is None
              else 1e-10)
    close(tk(t64(x1), t64(x2), diag=True), jk(x1, x2, diag=True), 1e-10)
    # a 2-D x1 against a 3-D x2 broadcasts x1 to the batch
    close(tk(t64(shared), t64(x2)),
          tk(t64(np.broadcast_to(shared, (B, 5, D))), t64(x2)), 0.0)

    W = rng.standard_normal((B, 7, 5))

    def jloss(k, x):
        return jnp.sum(k(x, x2) * W) + jnp.sum(k(x, x2, diag=True))
    gk, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jk, jnp.asarray(x1))
    x = t64(x1).requires_grad_(True)
    ((tk(x, t64(x2)) * t64(W)).sum() + tk(x, t64(x2), diag=True).sum()
     ).backward()
    close(x.grad, gx, 1e-7)
    jg = dict(_keyed_leaves(gk))
    for k, p in keyed_state(tk).items():
        if p.requires_grad:
            close(p.grad, jg[k], 1e-7, k)


def test_batched_inputs_keep_2d_inputs_on_their_route():
    """2-D inputs still take ``stationary_kernel_matrix`` (K3's route);
    3-D inputs do not, on either device."""
    _, tk = kernel_pair("matern25")
    calls = []
    real = tker.stationary_kernel_matrix

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    x = t64(np.random.default_rng(1).uniform(-1, 1, (6, D)))
    mp = pytest.MonkeyPatch()
    mp.setattr(tker, "stationary_kernel_matrix", spy)
    try:
        tk(x)
        tk(x.expand(B, 6, D))
    finally:
        mp.undo()
    assert calls == [(6, D)]


# -- the stragglers ----------------------------------------------------------------

def test_lower_triangular_param_inverse_matches_jax():
    rng = np.random.default_rng(2)
    L = np.tril(rng.uniform(0.2, 1.5, (2, 4, 4)))
    L[:, 0, 3] = 0.7                         # kept as given, as in JAX
    close(tcons.lower_triangular_param_inverse(t64(L)),
          jcons.lower_triangular_param_inverse(jnp.asarray(L)), 1e-12)
    close(tcons.lower_triangular_param(
        tcons.lower_triangular_param_inverse(t64(L))), np.tril(L), 1e-12)


@pytest.mark.parametrize("case", ["definite", "singular"])
def test_safe_cholesky_with_jitter_matches_jax(case):
    """The ladder's jitter (0 for a definite matrix, the first rung that
    factors a singular one), the factor, and the gradient through L (none
    through the jitter)."""
    rng = np.random.default_rng(4)
    G = rng.standard_normal((5, 3 if case == "singular" else 8))
    A = G @ G.T
    W = rng.standard_normal((5, 5))
    jL, jj = jchol.safe_cholesky_with_jitter(jnp.asarray(A))
    jg = jax.grad(lambda a: jnp.sum(
        jchol.safe_cholesky_with_jitter(a)[0] * W))(jnp.asarray(A))
    a = t64(A).requires_grad_(True)
    tL, tj = tchol.safe_cholesky_with_jitter(a)
    assert tj.dtype == torch.float64 and tj.shape == ()
    assert float(tj) == float(jj)
    assert (float(tj) > 0) == (case == "singular")
    close(tL, jL, 1e-10)
    (tL * t64(W)).sum().backward()
    close(a.grad, jg, 1e-7)


def test_mean_base_matches_jax():
    """``Mean`` is the base of the four means; ``basis_matrix`` raises
    AttributeError where JAX's does, and exists where JAX's does."""
    x = t64(np.random.default_rng(5).uniform(-1, 1, (4, 2)))
    for name in ("ZeroMean", "ConstantMean", "LinearMean", "PolynomialMean"):
        tm = getattr(tmeans, name)(input_size=2, dtype=torch.float64,
                                   device="cpu")
        jm = getattr(jmeans, name)(input_size=2, dtype=jnp.float64)
        assert isinstance(tm, tmeans.Mean) and isinstance(jm, jmeans.Mean)
        try:
            jm.basis_matrix(jnp.asarray(x.numpy()))
            close(tm.basis_matrix(x), jm.basis_matrix(jnp.asarray(x.numpy())),
                  1e-12)
        except AttributeError:
            with pytest.raises(AttributeError, match="basis_matrix"):
                tm.basis_matrix(x)
    with pytest.raises(NotImplementedError):
        tmeans.Mean()(x)


# -- profiling and device helpers --------------------------------------------------

def test_timer_matches_jax():
    for mod in (tprof, jprof):
        with mod.Timer() as t:
            time.sleep(0.01)
        assert 0.01 <= t.elapsed < 5.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """Enabled: one trace file in ``logdir`` holding the region's ops;
    disabled: a no-op that writes nothing."""
    with tprof.profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        torch.ones(3).sum()
    assert prof is None and not (tmp_path / "off").exists()
    with tprof.profile_trace(str(tmp_path / "on")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(str(tmp_path / "on" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_ensure_cuda_is_false_without_a_card():
    """On a host with no card ``ensure_cuda`` returns False (as
    ``ensure_tpu`` on a CPU host), builds nothing, and entry points still
    raise on ``device="cuda"``."""
    assert not torch.cuda.is_available()
    assert tdevice.ensure_cuda() is False
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve_device("cuda")
