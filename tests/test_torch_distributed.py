"""The port's sharded models on 4 gloo ranks (CPU, float64, a mesh of data
2 × latent 2 laid over two 'hosts' of two ranks, and one of data 4 ×
latent 1) against the JAX package's unsharded and sharded results, and
against the unsharded port: the projected, SGPR and variational models,
and every route of the LMC and ICM families (the fused LMC on its bf16,
int8, "kr" and "krs" routes, the composed LMC with its fp32 and int8
loops, CG + SLQ, the dense Woodbury LMC, the ICM's matrix-free and dense
MLLs, the LMC's and ICM's SGPR MLLs, ``ExactGPModel``'s fused and composed
iterative MLLs, the "lmc", "lmc_iter", "icm", "icm_iter" and "sgpr" caches,
``compute_var``, one AdamW step), and ``training.fit`` and
``fit_two_phase`` on a sharded model. JAX's probes are fed to the port,
and the ICM's JAX's eigenbasis of the whitened task covariance
(``tests/test_torch_icm.py``).

One module-scoped fixture spawns the ranks once (``parallel.launch``,
``spawn``, a ``file://`` rendezvous in a fresh directory, one torch thread
a rank, a deadline on every rank). The ranks run every check of
``tests/torch_parallel_ranks.py`` on JAX's leaves (``load_jax_state``) and
return numpy arrays; the tests below compare. ``dryrun_multichip`` is the
second and last spawn.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from projected_lmc_tpu.likelihoods import GaussianLikelihood as JaxLik
from projected_lmc_tpu.mlls import projected_lmc_mll as jax_mll
from projected_lmc_tpu.models.exact import ExactGPModel as JaxExact
from projected_lmc_tpu.models.multitask import MultitaskGPModel as JaxMT
from projected_lmc_tpu.models.projected import ProjectedGPModel as JaxProj
from projected_lmc_tpu.models.variational import \
    VariationalMultitaskGPModel as JaxVar
from projected_lmc_tpu.module import combine, partition, trainable_mask
from projected_lmc_tpu.ops import iterative as jit_ops
from projected_lmc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from projected_lmc_tpu.parallel.sharded import \
    sharded_fit_step as jax_sharded_fit_step
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves

sys.path.insert(0, str(Path(__file__).parent))
import torch_parallel_ranks  # noqa: E402

from projected_lmc_tpu_torch.entry import dryrun_multichip  # noqa: E402
from projected_lmc_tpu_torch.module import jax_key  # noqa: E402
from projected_lmc_tpu_torch.parallel.launch import run_ranks  # noqa: E402

PLMC = dict(init_lmc_coeffs=True, kernel_type="matern", BDN=False,
            diagonal_B=False, scalar_B=False)


def _data(n, p, q, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, d))
    U = np.stack([np.sin(3 * X[:, 0] + k) * np.cos((k + 1) * X[:, -1])
                  for k in range(q)], axis=1)
    Y = U @ rng.standard_normal((q, p)) + 0.05 * rng.standard_normal((n, p))
    X_test = rng.uniform(-0.9, 0.9, (12, d))
    return X, Y, X_test


def _moved(jm, seed):
    """The JAX model with its trainable leaves moved by a seeded
    uniform(−0.2, 0.2), and those leaves as {key path: array}."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for (k, v), trainable in zip(_keyed_leaves(jm), trainable_mask(jm)):
        v = np.asarray(v)
        arrays[k] = v + rng.uniform(-0.2, 0.2, v.shape) if trainable else v
    jm = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jm),
        [jnp.asarray(arrays[k]) for k, _ in _keyed_leaves(jm)])
    return jm, arrays


def _projected_case(n, p, q, d, seed, m_ind=None):
    X, Y, X_test = _data(n, p, q, d, seed)
    args = dict(PLMC, n_inducing_points=m_ind)
    jm, arrays = _moved(JaxProj(X, Y, p, q, **args), seed + 1)
    case = dict(check="projected", X=X, Y=Y, X_test=X_test, p=p, q=q,
                args=args, arrays=arrays)
    return jm, case


def _variational_case(n=48, p=6, q=4, d=2, seed=3):
    X, Y, X_test = _data(n, p, q, d, seed)
    args = dict(init_lmc_coeffs=True, kernel_type="matern",
                mean_type="constant")
    jm = JaxVar(X, n_latents=q, n_tasks=p, train_y=Y, **args)
    jm, arrays = _moved(jm, seed + 1)
    return jm, dict(check="variational", X=X, Y=Y, X_test=X_test, p=p, q=q,
                    args=args, arrays=arrays)


def _jax_loss_and_grads(jm, loss):
    mask = trainable_mask(jm)
    params, static = partition(jm, mask)
    value, grads = jax.jit(jax.value_and_grad(
        lambda p, s: loss(combine(p, s))))(params, static)
    return float(value), {k[1:]: np.asarray(v)
                          for k, v in _keyed_leaves(grads)}


JAX_LOSS = {"exact": jax_mll, "sgpr": jax_mll,
            "variational": lambda m: m.elbo()}

# the LMC and ICM families: n, tasks, latents, probes, Nyström rank
MT_N, MT_T, MT_Q, MT_S, MT_RANK = 48, 4, 2, 4, 16
MT_MLL = dict(iterative=True, max_cg_iters=200, cg_tol=1e-12,
              precond_rank=MT_RANK, num_probes=MT_S)
MT_CACHE = dict(iterative=True, precond_rank=8)
# CG + SLQ (no Nyström rank: Jacobi CG), and the SGPR's inducing points
MT_SLQ = dict(iterative=True, max_cg_iters=200, cg_tol=1e-12,
              num_probes=MT_S)
MT_M = 8
# the mixing factors from the seeded normal draw, not the SVD init (every
# leaf is moved and carried over anyway)
MT_MODELS = {
    "lmc": dict(n_tasks=MT_T, n_latents=MT_Q, model_type="LMC",
                kernel_type="matern", mean_type="constant",
                init_lmc_coeffs=False),
    "composed": dict(n_tasks=MT_T, n_latents=MT_Q, model_type="LMC",
                     kernel_type="matern", mean_type="constant",
                     decomp=[[0], [1]], init_lmc_coeffs=False),
    "icm": dict(n_tasks=MT_T, n_latents=MT_Q, model_type="ICM",
                kernel_type="matern", mean_type="constant",
                init_lmc_coeffs=False),
    "exact_iter": dict(kernel_type="matern", outputscales=True,
                       mean_type="constant"),
    "sgpr_lmc": dict(n_tasks=MT_T, n_latents=MT_Q, model_type="LMC",
                     kernel_type="matern", mean_type="constant",
                     init_lmc_coeffs=False, n_inducing_points=MT_M),
    "sgpr_icm": dict(n_tasks=MT_T, n_latents=MT_Q, model_type="ICM",
                     kernel_type="matern", mean_type="constant",
                     init_lmc_coeffs=False, n_inducing_points=MT_M),
    "exact_composed": dict(kernel_type="matern", outputscales=True,
                           mean_type="constant", decomp=[[0], [1]]),
}


def _jax_probes(key, xi_shape):
    """The eps (S, n, T) and xi the JAX models draw from ``key``."""
    k1, k2 = jax.random.split(key)
    return (np.asarray(jax.random.normal(k1, (MT_S, MT_N, MT_T),
                                         jnp.float64)),
            np.asarray(jax.random.normal(k2, xi_shape, jnp.float64)))


def _jax_eigenbasis(jm):
    """JAX's eigenpairs of the ICM's whitened task covariance
    Lt⁻¹ B Lt⁻ᵀ, in which both packages draw the ICM probes."""
    B = np.asarray(jm.task_covar_matrix())
    Lt = np.linalg.cholesky(np.asarray(jm.likelihood.task_covariance()))
    Li = np.linalg.inv(Lt)
    Bt = Li @ B @ Li.T
    w, V = jnp.linalg.eigh(jnp.asarray(0.5 * (Bt + Bt.T)))
    return np.asarray(w), np.asarray(V)


def _multitask_cases():
    """(JAX models, cases): the LMC on both mesh layouts (fused) and its
    one AdamW step, the composed LMC, the ICM's matrix-free and dense MLLs,
    ``ExactGPModel``'s iterative MLLs, the "lmc_iter", "icm_iter" and "icm"
    caches; the dense Woodbury LMC and its "lmc" cache, CG + SLQ, the int8
    loops, the "kr" and "krs" backward routes, the SGPR MLLs and "sgpr"
    caches; ``fit`` and ``fit_two_phase`` on the LMC."""
    X, Y, X_test = _data(MT_N, MT_T, MT_Q, 2, 5)
    jax_models, cases = {}, {}
    for name, args in MT_MODELS.items():
        if name.startswith("exact"):
            jm = JaxExact(X, Y, JaxLik(batch_shape=MT_T, dtype=jnp.float64),
                          n_tasks=MT_T, **args)
        else:
            jm = JaxMT(X, Y, **args)
        jm, arrays = _moved(jm, 20 + len(cases))
        jax_models[name] = jm
        cases[name] = dict(check="multitask", X=X, Y=Y, X_test=X_test,
                           args=args, arrays=arrays, mll=MT_MLL,
                           family="exact" if name.startswith("exact")
                           else "mt", layouts=[(2, 2)])
    key = jax.random.PRNGKey(0)
    cases["lmc"]["layouts"] = [(2, 2), (4, 1)]
    for name in ("lmc", "composed"):
        cases[name]["eps"], cases[name]["xi"] = _jax_probes(
            key, (MT_S, MT_Q, MT_RANK))
    for name in ("exact_iter", "exact_composed"):
        cases[name]["eps"], cases[name]["xi"] = _jax_probes(
            key, (MT_S, MT_T, MT_RANK))
    cases["icm"]["eps"], cases["icm"]["xi"] = _jax_probes(
        jax.random.PRNGKey(5), (MT_S, MT_RANK, MT_T))
    cases["icm"]["eig"] = _jax_eigenbasis(jax_models["icm"])
    # the ICM's dense MLL; the caches with their start vectors (JAX's
    # draws from PRNGKey(0))
    cases["icm_dense"] = dict(cases["icm"], mll=None, cache={})
    cases["icm_dense"].pop("eps"), cases["icm_dense"].pop("xi")
    v0 = lambda c: np.asarray(jax.random.normal(                # noqa: E731
        jax.random.PRNGKey(0), (MT_N, c), jnp.float64))
    lmc = dict(cases["lmc"])
    cases["lmc"].update(cache=MT_CACHE, v0=v0(MT_T))
    cases["icm"].update(cache=MT_CACHE, v0=v0(1), compute_var=True)
    cases["icm_dense"]["compute_var"] = True
    cases["multitask_step"] = dict(cases["lmc"], check="multitask_step")
    cases["fit"] = dict(lmc, check="fit")
    jax_models["icm_dense"] = jax_models["icm"]
    # the dense Woodbury LMC (q·n ≤ DENSE_QN_MAX) and its "lmc" cache; CG +
    # SLQ on JAX's Rademacher probes, Jacobi and Nyström-preconditioned; the
    # int8 loops; the fused op's "kr" and "krs" backward (JAX's value is
    # its "lmc" case's: the same MLL, another order of sums); the SGPR
    # routes with their "sgpr" caches
    probes = np.asarray(jit_ops.draw_probes(key, MT_N, MT_T, MT_S,
                                            jnp.float64))
    no_probes = {k: v for k, v in lmc.items() if k not in ("eps", "xi")}
    cases["lmc_dense"] = dict(no_probes, mll=None, cache={},
                              layouts=[(2, 2), (4, 1)])
    cases["slq"] = dict(no_probes, mll=MT_SLQ, probes=probes)
    cases["slq_rank"] = dict(no_probes, probes=probes, layouts=[(4, 1)],
                             mll=dict(MT_SLQ, precond_rank=MT_RANK,
                                      quad_method="slq"))
    cases["int8"] = dict(lmc, mll=dict(MT_MLL, matvec_int8=True))
    cases["int8_composed"] = dict(cases["composed"],
                                  mll=dict(MT_MLL, matvec_int8=True))
    cases["kr"] = dict(lmc, env={"PLMC_KR_FUSED": "1"}, ref="lmc",
                       layouts=[(2, 2), (4, 1)])
    cases["krs"] = dict(lmc, env={"PLMC_KR_STREAM": "1"}, ref="lmc")
    for name in ("sgpr_lmc", "sgpr_icm"):
        cases[name].update(mll=None, cache={})
    for name in ("lmc_dense", "slq", "slq_rank", "int8"):
        jax_models[name] = jax_models["lmc"]
    jax_models["int8_composed"] = jax_models["composed"]
    return jax_models, cases


def _jax_multitask_references(jax_models, cases):
    """JAX's loss and gradients for each multitask case, its caches'
    predictions and ``compute_var``, and one LMC step on its 8-device
    mesh."""
    refs = {}
    for name, jm in jax_models.items():
        case = cases[name]
        if case["mll"] is None:
            loss = lambda m: m.mll()                        # noqa: E731
        else:
            key = jax.random.PRNGKey(5 if name == "icm" else 0)
            loss = (lambda key, kw: lambda m: m.mll(key=key, **kw))(
                key, case["mll"])
        value, grads = _jax_loss_and_grads(jm, loss)
        refs[name] = dict(loss=value, grads=grads)
        if "cache" in case:
            kw = case["cache"]

            def side(m, x, kw=kw, case=case):
                c = m.precompute_posterior(**kw)
                p = m.posterior(x, cache=c, observed=True)
                out = [p.mean, p.variance]
                if case.get("compute_var"):
                    out.append(m.compute_var(x))
                return out
            got = jax.jit(side)(jm, jnp.asarray(case["X_test"]))
            refs[name].update(zip(("mean", "var", "compute_var"),
                                  (np.asarray(a) for a in got)))
    for name, case in cases.items():
        if "ref" in case:
            refs[name] = refs[case["ref"]]
    step, params, opt, static = jax_sharded_fit_step(
        jax_models["lmc"], jax_make_mesh(8),
        lambda m: m.mll(key=jax.random.PRNGKey(0), **MT_MLL), lr=1e-2)
    params, _, loss = step(params, opt, static)
    refs["multitask_step"] = dict(loss=float(loss), params={
        k: np.asarray(v) for k, v in _keyed_leaves(params) if np.size(v)})
    return refs


def _jax_references(jax_models, cases):
    """JAX's values for every case (jitted: its eager calls take seconds
    each): loss and gradients, the predictions, one sharded step."""
    refs = {}
    for name in ("exact", "sgpr", "variational"):
        jm, x = jax_models[name], jnp.asarray(cases[name]["X_test"])
        loss, grads = _jax_loss_and_grads(jm, JAX_LOSS[name])
        if name == "variational":
            pred = jax.jit(lambda m, x: m(x, observed=True))(jm, x)
            mean, var = pred.mean, pred.variance
        else:
            mean, var = jax.jit(lambda m, x: m.predict(
                x, observed=True, cache=m.prediction_cache()))(jm, x)
        refs[name] = dict(loss=loss, grads=grads, mean=np.asarray(mean),
                          var=np.asarray(var))
    step, params, opt, static = jax_sharded_fit_step(
        jax_models["step"], jax_make_mesh(8), jax_mll, lr=1e-2)
    params, _, loss = step(params, opt, static)
    refs["step"] = dict(loss=float(loss), params={
        k: np.asarray(v) for k, v in _keyed_leaves(params) if np.size(v)})
    refs.update(_jax_multitask_references(jax_models["multitask"], cases))
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the cases, the ranks' results, JAX's references). JAX computes its
    references while the ranks run."""
    jax_models, cases = {}, {}
    jax_models["exact"], cases["exact"] = _projected_case(48, 6, 4, 2, 0)
    jax_models["sgpr"], cases["sgpr"] = _projected_case(64, 6, 4, 2, 1,
                                                        m_ind=10)
    jax_models["variational"], cases["variational"] = _variational_case()
    # the step: JAX's own test's model (tests/test_sharding.py), q = 2
    X = np.linspace(-1, 1, 32)[:, None]
    rng = np.random.default_rng(0)
    U = np.stack([np.sin(3 * X[:, 0]), np.cos(5 * X[:, 0])], axis=1)
    Y = U @ rng.standard_normal((2, 6)) + 0.05 * rng.standard_normal((32, 6))
    args = dict(init_lmc_coeffs=True, kernel_type="matern")
    jm, arrays = _moved(JaxProj(X, Y, 6, 2, **args), 7)
    jax_models["step"] = jm
    cases["step"] = dict(check="step", X=X, Y=Y, p=6, q=2, args=args,
                         arrays=arrays)
    cases["checkpoint"] = dict(cases["exact"], check="checkpoint",
                               path=str(tmp_path_factory.mktemp("dcp")))
    jax_models["multitask"], mt_cases = _multitask_cases()
    cases.update(mt_cases)
    with ThreadPoolExecutor(1) as pool:
        refs = pool.submit(_jax_references, jax_models, cases)
        results = run_ranks(torch_parallel_ranks.run, 4, (cases,),
                            device="cpu", local_world_size=2, timeout=240,
                            collective_timeout=60, threads=1)
        return cases, results, refs.result()


@pytest.mark.parametrize("rank", range(4))
def test_layout_keeps_latent_groups_on_one_host(world, rank):
    lay = world[1][rank]["layout"]
    assert lay["rank"] == rank
    assert lay["shape"] == lay["make_mesh_shape"] == {"data": 2, "latent": 2}
    assert (lay["data_index"], lay["latent_index"]) == divmod(rank, 2)
    # the latent group is the rank's row of reshape(data, latent): one host
    # of local_world_size = 2
    assert lay["latent_group"] == [2 * (rank // 2), 2 * (rank // 2) + 1]
    assert {r // 2 for r in lay["latent_group"]} == {rank // 2}
    assert lay["data_group"] == [rank % 2, rank % 2 + 2]
    assert lay["data_sum"] == float(sum(lay["data_group"]))
    assert lay["replicated"] == [1.0, 1.0]          # rank 0's values


def test_global_mesh_value_errors(world):
    errors = world[1][0]["layout"]["errors"]
    assert len(errors) == 2
    assert "must divide the per-host device count" in errors[0]
    assert "must multiply to the global device count" in errors[1]


@pytest.mark.parametrize("case", ["exact", "sgpr", "variational"])
def test_sharded_loss_matches_jax_and_unsharded(world, case):
    _, results, refs = world
    want = refs[case]["loss"]
    for r in results:
        got = r[case]
        np.testing.assert_allclose(got["loss_sharded"], want, rtol=1e-9)
        np.testing.assert_allclose(got["loss_unsharded"], want, rtol=1e-9)


@pytest.mark.parametrize("case", ["exact", "sgpr", "variational"])
def test_sharded_gradients_match_unsharded(world, case):
    """Averaged over the ranks, each gradient equals the unsharded port's
    within 1e-8 of its largest entry, and JAX's: a replicated term counted
    once a rank would be off by a factor."""
    _, results, refs = world
    jax_grads = refs[case]["grads"]
    for r in results:
        sharded, unsharded = (r[case]["grads_sharded"],
                              r[case]["grads_unsharded"])
        assert sorted(sharded) == sorted(unsharded)
        assert len(sharded) >= 4
        for k, g in unsharded.items():
            scale = max(np.abs(g).max(), 1e-300)
            assert np.abs(sharded[k] - g).max() <= 1e-8 * scale, k
            jg = jax_grads[k]
            assert np.abs(sharded[k] - jg).max() <= 1e-8 * max(
                np.abs(jg).max(), 1e-300), k


@pytest.mark.parametrize("case", ["exact", "sgpr"])
def test_sharded_cache_and_predict_match_jax(world, case):
    _, results, refs = world
    mean, var = refs[case]["mean"], refs[case]["var"]
    for rank, r in enumerate(results):
        got = r[case]
        assert got["cache_latents"] == (2 * (rank % 2), 2 * (rank % 2) + 2)
        assert np.abs(got["mean"] - mean).max() <= 1e-8 * np.abs(mean).max()
        assert np.abs(got["var"] - var).max() <= 1e-8 * np.abs(var).max()


def test_sharded_variational_prediction_matches_jax(world):
    _, results, refs = world
    mean, var = refs["variational"]["mean"], refs["variational"]["var"]
    for r in results:
        got = r["variational"]
        assert np.abs(got["mean"] - mean).max() <= 1e-8 * np.abs(mean).max()
        assert np.abs(got["var"] - var).max() <= 1e-8 * np.abs(var).max()


def test_sharded_step_matches_unsharded_and_jax(world):
    """One sharded AdamW step against one unsharded port step and against
    JAX's ``sharded_fit_step`` on its 8-device mesh: the loss to 1e-9, the
    parameters to JAX's own limit for this comparison (rtol 1e-4, atol 1e-8:
    Adam's rsqrt amplifies ulp differences)."""
    _, results, refs = world
    loss, jax_params = refs["step"]["loss"], refs["step"]["params"]
    for r in results:
        got = r["step"]
        np.testing.assert_allclose(got["loss_sharded"], float(loss),
                                   rtol=1e-9)
        np.testing.assert_allclose(got["loss_unsharded"], float(loss),
                                   rtol=1e-9)
        assert sorted(got["params_sharded"]) == sorted(jax_params)
        for k, v in jax_params.items():
            np.testing.assert_allclose(got["params_sharded"][k], v,
                                       rtol=1e-4, atol=1e-8, err_msg=k)
            np.testing.assert_allclose(got["params_sharded"][k],
                                       got["params_unsharded"][k],
                                       rtol=1e-4, atol=1e-8, err_msg=k)


def test_checkpoint_round_trip_under_the_group(world):
    for r in world[1]:
        assert r["checkpoint"]["keys"]
        assert r["checkpoint"]["max_diff"] == 0.0


MT_LOSS_CASES = [("lmc", (2, 2)), ("lmc", (4, 1)), ("composed", (2, 2)),
                 ("icm", (2, 2)), ("icm_dense", (2, 2)),
                 ("exact_iter", (2, 2)), ("lmc_dense", (2, 2)),
                 ("lmc_dense", (4, 1)), ("slq", (2, 2)), ("slq_rank", (4, 1)),
                 ("int8", (2, 2)), ("int8_composed", (2, 2)), ("kr", (2, 2)),
                 ("kr", (4, 1)), ("krs", (2, 2)), ("sgpr_lmc", (2, 2)),
                 ("sgpr_icm", (2, 2)), ("exact_composed", (2, 2))]
# against JAX: the unsharded parity tests' tolerances (loss rtol, gradient
# rtol, gradient atol) where they differ from the PCG routes' (1e-10, 1e-7,
# 1e-10): CG + SLQ (tests/test_torch_slq.py) and the int8 loops
# (tests/test_torch_int8.py, and the composed route's int8 gradients)
MT_JAX_TOL = {"slq": (1e-9, 1e-7, 1e-9), "slq_rank": (1e-9, 1e-7, 1e-9),
              "int8": (1e-9, 1e-7, 1e-10),
              "int8_composed": (1e-9, 1e-5, 1e-9)}


def _close_to(got, want, rtol, atol_frac=0.0, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("case, layout", MT_LOSS_CASES)
def test_sharded_multitask_mll_and_gradients_match_jax(world, case, layout):
    """Every route's sharded MLL (the fused LMC on data 2 × latent 2 and data
    4 × latent 1 and its int8, "kr" and "krs" routes, the composed LMC and
    its int8 loop, CG + SLQ, the dense Woodbury LMC, the ICM's matrix-free
    and dense MLLs, the LMC's and ICM's SGPR MLLs, ``ExactGPModel``'s fused
    and composed iterative MLLs) and its gradients, averaged over the
    ranks, against JAX's and the unsharded port's: loss rtol 1e-10,
    gradients rtol 1e-7 and atol 1e-10 (the unsharded parity tests'; for
    CG + SLQ and the int8 loops against JAX, theirs, ``MT_JAX_TOL``)."""
    _, results, refs = world
    want = refs[case]
    lrtol, grtol, gatol = MT_JAX_TOL.get(case, (1e-10, 1e-7, 1e-10))
    for r in results:
        got = r[case][layout]
        for loss in (got["loss_sharded"], got["loss_unsharded"]):
            np.testing.assert_allclose(loss, want["loss"], rtol=lrtol)
        np.testing.assert_allclose(got["loss_sharded"], got["loss_unsharded"],
                                   rtol=1e-10)
        # the port's names as JAX's key paths (kernels.0 → kernels[0])
        sharded, unsharded = ({jax_key(k)[1:]: g for k, g in
                               got[f"grads_{side}"].items()}
                              for side in ("sharded", "unsharded"))
        assert sorted(sharded) == sorted(unsharded) == sorted(want["grads"])
        assert len(want["grads"]) >= 4
        for k, g in want["grads"].items():
            for other in (sharded, unsharded):
                np.testing.assert_allclose(other[k], g, rtol=grtol,
                                           atol=gatol, err_msg=k)
            np.testing.assert_allclose(sharded[k], unsharded[k], rtol=1e-7,
                                       atol=1e-10, err_msg=k)


@pytest.mark.parametrize("case, kind", [("lmc", "lmc_iter"),
                                        ("icm", "icm_iter"),
                                        ("icm_dense", "icm"),
                                        ("lmc_dense", "lmc"),
                                        ("sgpr_lmc", "sgpr"),
                                        ("sgpr_icm", "sgpr")])
def test_sharded_multitask_cache_and_posterior_match_jax(world, case, kind):
    """The sharded "lmc_iter", "icm_iter", "icm", "lmc" and "sgpr" caches,
    ``posterior`` on the test points split over the ranks and gathered,
    and the ICM's ``compute_var``, against JAX's and the unsharded port's
    (1e-8 of the largest entry, as the unsharded matrix-free posterior
    tests)."""
    _, results, refs = world
    want = refs[case]
    names = ("mean", "var") + (("compute_var",) if "compute_var" in want
                               else ())
    for r in results:
        got = r[case]
        assert got["sharded"]["kind"] == got["unsharded"]["kind"] == kind
        for name in names:
            for side in ("sharded", "unsharded"):
                _close_to(got[side][name], want[name], 1e-8, 1e-8,
                          f"{side} {name}")


def test_sharded_multitask_step_matches_unsharded_and_jax(world):
    """One sharded AdamW step of the LMC's iterative MLL against one
    unsharded port step and JAX's ``sharded_fit_step`` on its 8-device
    mesh, at the projected step's limits."""
    _, results, refs = world
    loss, jax_params = (refs["multitask_step"]["loss"],
                        refs["multitask_step"]["params"])
    for r in results:
        got = r["multitask_step"]
        np.testing.assert_allclose(got["loss_sharded"], loss, rtol=1e-10)
        np.testing.assert_allclose(got["loss_unsharded"], loss, rtol=1e-10)
        assert sorted(got["params_sharded"]) == sorted(jax_params)
        for k, v in jax_params.items():
            np.testing.assert_allclose(got["params_sharded"][k], v,
                                       rtol=1e-4, atol=1e-8, err_msg=k)
            np.testing.assert_allclose(got["params_sharded"][k],
                                       got["params_unsharded"][k],
                                       rtol=1e-4, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("run", ["fit", "two_phase"])
def test_sharded_fit_matches_unsharded_and_the_sharded_step(world, run):
    """``training.fit`` (2 steps) and ``fit_two_phase`` (3 int8 steps, then
    1 fp32 step) on the sharded LMC, each rank averaging its gradients
    after each backward, against the same unsharded run and, for ``fit``,
    against 2 steps of ``sharded_fit_step`` at the same constant learning
    rate: every loss to 1e-10, the leaves at the step test's limits (rtol
    1e-4, atol 1e-8); every rank the same leaves."""
    results = world[1]
    for r in results:
        got = r["fit"]
        pairs = [(got[f"{run}_sharded"], got[f"{run}_unsharded"])]
        if run == "fit":
            pairs.append((got["fit_sharded"], got["step"]))
        for a, b in pairs:
            assert len(a["losses"]) == len(b["losses"]) == (
                2 if run == "fit" else 4)
            np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-10)
            assert sorted(a["params"]) == sorted(b["params"])
            for k, v in b["params"].items():
                np.testing.assert_allclose(a["params"][k], v, rtol=1e-4,
                                           atol=1e-8, err_msg=k)
        for k, v in got[f"{run}_sharded"]["params"].items():
            np.testing.assert_array_equal(
                v, results[0]["fit"][f"{run}_sharded"]["params"][k])


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    """JAX's dry run on four CPU ranks: the projected SGPR and exact steps,
    the LMC-iterative and ICM-iterative steps, the sharded prediction and
    the ICM's ``compute_var``, every value finite and the variance
    positive."""
    dryrun_multichip(4, device="cpu", timeout=240)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(4) OK: mesh={'data': 2, "
                           "'latent': 2} backend=gloo")
    values = dict(kv.split("=")
                  for kv in line.split("backend=gloo ")[1].split())
    assert sorted(values) == ["exact_loss", "icm_iter_loss",
                              "lmc_iter_loss", "sgpr_loss",
                              "sharded_icm_var_mean",
                              "sharded_predict_mean"]
    assert all(np.isfinite(float(v)) for v in values.values())
    assert float(values["sharded_icm_var_mean"]) > 0
