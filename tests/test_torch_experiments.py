"""The port's experiment harness (``projected_lmc_tpu_torch.experiments``:
the study driver, the real-data loaders and the plots) against the JAX
package's, on the CPU.

``build_models``: key paths, shapes and values at build time (float64;
the likelihoods' leaves, float32 in the JAX driver whatever the data, to
float32 rounding, 1e-7), the var model's ``seed=0`` and the
spectral-mixture init. ``train_and_eval``: every model from the same
leaves, a few steps at a constant learning rate (XLA's jitted float32
schedule and numpy's differ by an ulp at some steps): losses 1e-8
relative, metrics 1e-6 (the wall-clock ones by name and finiteness).
``run_study``: its landmark and final CSVs read back by ``pd.read_csv``
equal to JAX's, exactly, with the data, models and training stubbed in
both drivers. The loaders: the same dict (keys, dtypes, arrays to 1e-12)
on fixture files written here, in each source's format.
"""

import csv
import gzip
import os
import subprocess
import sys
from datetime import datetime, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from projected_lmc_tpu.experiments import driver as jd
from projected_lmc_tpu.experiments import plots as jplots
from projected_lmc_tpu.experiments import realdata as jreal
from projected_lmc_tpu.training import fit as jax_fit
from projected_lmc_tpu.utils.checkpoint import _keyed_leaves
from projected_lmc_tpu_torch import load_jax_state
from projected_lmc_tpu_torch.experiments import driver as td
from projected_lmc_tpu_torch.experiments import plots as tplots
from projected_lmc_tpu_torch.experiments import realdata as treal
from projected_lmc_tpu_torch.module import keyed_state

N, P, Q, N_TEST = 30, 4, 2, 20
ALL = ["ICM", "var", "PLMC", "oilmm", "PLMC_fast"]
WALL_CLOCK = ("train_time", "pred_time")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny torch ops: one intra-op thread avoids oversubscribing the cores
    that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def data(seed=0, n=N, p=P):
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 1, n + N_TEST)[:, None]
    F = np.stack([np.sin(6 * X[:, 0]), np.cos(4 * X[:, 0])], 1)
    Y = F @ rng.standard_normal((2, p)) \
        + 0.05 * rng.standard_normal((len(X), p))
    test = np.arange(1, len(X), (len(X) + N_TEST - 1) // N_TEST)[:N_TEST]
    train = np.setdiff1d(np.arange(len(X)), test)
    return X[train], Y[train], X[test], Y[test]


def as_f64(jm):
    """The JAX model with every float leaf in float64 (the JAX driver's
    likelihoods are float32 whatever the data)."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, jm)


def close(got, want, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.nanmax(np.abs(want),
                                                     initial=0.0),
                               err_msg=what)


# -- build_models ----------------------------------------------------------------

BUILDS = {
    "matern": dict(kernel_type="matern"),
    "spectral_mixture": dict(kernel_type="spectral_mixture",
                             ker_kwargs={"num_mixtures": 2},
                             var_ind_range="data", oilmm_bulk=False),
}


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_build_models_match_jax(build):
    """All five models at seed 3: JAX's key paths, shapes and values (the
    var model built from seed 0, as in both drivers; the spectral mixture
    from its periodogram init), then JAX's leaves carried in."""
    X, Y, _, _ = data()
    kw = dict(BUILDS[build], seed=3)
    jms = jd.build_models(X, Y, Q, P, ALL, **kw)
    tms = td.build_models(X, Y, Q, P, ALL, device="cpu", **kw)
    assert list(tms) == list(jms)
    for name, jm in jms.items():
        jl = dict(_keyed_leaves(jm))
        ts = keyed_state(tms[name])
        assert sorted(jl) == sorted(ts), name
        for k, v in jl.items():
            v = np.asarray(v)
            assert tuple(ts[k].shape) == v.shape, (name, k)
            close(ts[k], v, 1e-7 if v.dtype == np.float32 else 1e-12,
                  f"{name} {k}")
        load_jax_state(tms[name], {k: np.asarray(v) for k, v in jl.items()})
    assert type(tms["oilmm"].lmc_coefficients).__name__ == "LMCMixingMatrix"
    assert tms["oilmm"].lmc_coefficients.bulk == (build == "matern")
    # the var model's inducing points come from seed 0, not 3
    z0 = td.build_models(X, Y, Q, P, ["var"], device="cpu",
                         **dict(kw, seed=0))["var"]
    for k, v in keyed_state(z0).items():
        if "inducing" in k:
            close(keyed_state(tms["var"])[k], v.detach().numpy(), 0.0, k)
    if build == "spectral_mixture":
        cm = tms["ICM"].covar_module
        assert float(cm.mixture_means.detach().min()) > 0.5  # spectral peaks


# -- train_and_eval / predict_and_metrics -----------------------------------------

STEPS, LR = 3, 0.02


def const_schedule(lr_max=1e-2, lr_min=1e-3):
    return lambda i: lr_max


@pytest.fixture(scope="module")
def trained_pair():
    """One ``train_and_eval`` of all five models on each side (the var
    model by ``sgpr_em``), from the same leaves, recording each fit's
    per-step losses."""
    X, Y, Xt, Yt = data(1)
    jms = {k: as_f64(m) for k, m in jd.build_models(
        X, Y, Q, P, ALL, seed=2).items()}
    tms = td.build_models(X, Y, Q, P, ALL, seed=2, device="cpu")
    for name, jm in jms.items():
        load_jax_state(tms[name], {k: np.asarray(v)
                                   for k, v in _keyed_leaves(jm)})
    losses = {"jax": [], "torch": []}
    mp = pytest.MonkeyPatch()
    for side, mod in (("jax", jd), ("torch", td)):
        fit = mod.fit

        def recorded(*a, _fit=fit, _side=side, **k):
            model, info = _fit(*a, **k)
            losses[_side].append(np.asarray(info["losses"]))
            return model, info
        mp.setattr(mod, "fit", recorded)
        mp.setattr(mod, "lambda_lr_schedule", const_schedule)
    try:
        kw = dict(n_iter=STEPS, lr=LR, print_metrics=False,
                  var_fit="warm_start")
        jres, jtr = jd.train_and_eval(jms, Xt, Yt, **kw)
        tres, ttr = td.train_and_eval(tms, Xt, Yt, device="cpu", **kw)
    finally:
        mp.undo()
    return jres, tres, jtr, ttr, losses, (X, Y, Xt, Yt)


def metrics_match(got, want, rtol=1e-6, skip=()):
    assert list(got) == list(want)
    for k, v in want.items():
        if k in skip:
            continue
        if k in WALL_CLOCK:
            assert np.isfinite(got[k]), k
        elif k == "model":
            assert got[k] == v
        else:
            close(got[k], v, rtol, k)


def test_train_and_eval_matches_jax(trained_pair):
    """Each model's losses step by step (1e-8 relative) and its metrics
    through ``predict_and_metrics``'s route (1e-6): the ICM's cache and
    ``compute_var``, the projected models' ``predict`` and full-likelihood
    factor, the var model's ``sgpr_em`` (``n_iter`` 0, loss −ELBO)."""
    jres, tres, jtr, ttr, losses, _ = trained_pair
    assert list(tres) == list(jres) == ALL
    assert len(losses["torch"]) == len(losses["jax"]) == 4
    for got, want in zip(losses["torch"], losses["jax"]):
        assert got.shape == want.shape == (STEPS,)
        close(got, want, 1e-8)
    for name in ALL:
        metrics_match(tres[name], jres[name], skip=("noise",) * (
            name == "var"))
    assert tres["var"]["n_iter"] == 0
    # sgpr_em's rank-p factor is eigenvectors, equal to JAX's up to column
    # signs, and the noise metric reads its diagonal: held with the signs
    # aligned
    F = ttr["var"].likelihood.task_noise_covar_factor.detach().numpy()
    G = np.asarray(jtr["var"].likelihood.task_noise_covar_factor)
    ttr["var"].likelihood.task_noise_covar_factor.data.mul_(
        torch.as_tensor(np.where(F[0] * G[0] < 0, -1.0, 1.0)))
    H = td._noise_matrix(ttr["var"].likelihood).numpy()
    close((H ** 2).sum() / P, jres["var"]["noise"], 1e-6, "var noise")


def test_trained_leaves_match_jax(trained_pair):
    """Every trained leaf, by key path (1e-7 of its largest entry)."""
    _, _, jtr, ttr, _, _ = trained_pair
    for name in ALL:
        ts = keyed_state(ttr[name])
        for k, v in _keyed_leaves(jtr[name]):
            close(ts[k], v, 1e-7, f"{name} {k}")


def test_var_adam_route_matches_jax(trained_pair):
    """``var_fit="adam"``: the ELBO through ``fit``, against JAX's ``fit``
    with the JAX driver's loss and its ``predict_and_metrics``."""
    X, Y, Xt, Yt = trained_pair[5]
    jm = as_f64(jd.build_models(X, Y, Q, P, ["var"], seed=2)["var"])
    tms = td.build_models(X, Y, Q, P, ["var"], seed=2, device="cpu")
    load_jax_state(tms["var"], {k: np.asarray(v)
                                for k, v in _keyed_leaves(jm)})
    jm, info = jax_fit(jm, jd._loss_fn_for("var", jm), n_iter=STEPS, lr=LR,
                       schedule=const_schedule(LR))
    want = jd.predict_and_metrics("var", jm, info, Xt, Yt,
                                  print_metrics=False)
    mp = pytest.MonkeyPatch()
    mp.setattr(td, "lambda_lr_schedule", const_schedule)
    try:
        got, _ = td.train_and_eval(tms, Xt, Yt, n_iter=STEPS, lr=LR,
                                   print_metrics=False, device="cpu")
    finally:
        mp.undo()
    metrics_match(got["var"], want)


@pytest.mark.parametrize("rank", [0, P])
def test_noise_matrix_matches_jax(trained_pair, rank):
    """``_noise_matrix`` of a diagonal and of a rank-p task noise, on moved
    leaves."""
    from projected_lmc_tpu.likelihoods import \
        MultitaskGaussianLikelihood as JaxLik
    from projected_lmc_tpu_torch import MultitaskGaussianLikelihood
    jl = JaxLik(num_tasks=P, rank=rank, seed=5, dtype=jnp.float64)
    rng = np.random.default_rng(6)
    arrays = {k: np.asarray(v) + rng.uniform(-0.3, 0.3, np.shape(v))
              for k, v in _keyed_leaves(jl)}
    jl = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jl),
        [jnp.asarray(arrays[k]) for k, _ in _keyed_leaves(jl)])
    tl = MultitaskGaussianLikelihood(P, rank=rank, dtype=torch.float64,
                                     device="cpu")
    load_jax_state(tl, arrays)
    close(td._noise_matrix(tl), jd._noise_matrix(jl), 1e-12)


# -- run_study's CSVs ----------------------------------------------------------------

def stub_driver(mp, mod):
    """Data, models and training replaced by fixed metric dicts, a function
    of the run and the model (a mean error on both sides of the
    non-converged threshold, integer n_iter)."""
    names = ["ICM", "PLMC"]

    def metrics(i_run, name, mu_noise):
        rng = np.random.default_rng([i_run, names.index(name),
                                     int(mu_noise * 1e3)])
        m = {k: float(rng.uniform(0.1, 2.0)) for k in (
            "train_time", "pred_time", "loss", "noise", "R2", "RMSE")}
        m["n_iter"] = int(rng.integers(10, 500))
        m["mean_err_abs"] = float(rng.uniform(0.1, 0.9))
        m.update({k: float(rng.uniform(0.0, 3.0)) for k in (
            "max_err_abs", "mean_err_quant05", "mean_err_quant95",
            "mean_err_quant99", "mean_sigma", "PVA", "alpha_CI")})
        return dict(m, model=name)

    mp.setattr(mod, "generate_synthetic",
               lambda seed, mu_noise, **_: dict(X=seed, Y=mu_noise,
                                                X_test=None, Y_test=None))
    mp.setattr(mod, "build_models",
               lambda X, Y, q, qn, models_to_run, seed, **_:
               {name: (seed, Y) for name in models_to_run})
    mp.setattr(mod, "train_and_eval",
               lambda models, *a, **k: ({
                   name: metrics(run[0], name, run[1])
                   for name, run in models.items()}, {}))
    return names


@pytest.mark.parametrize("runs", [1, 2, 11])
@pytest.mark.parametrize("reject", [False, True])
def test_run_study_csvs_read_back_equal_to_jax(tmp_path, runs, reject):
    """Same landmark files (runs 1, 10, … and the last) and the requested
    path, each equal to JAX's under ``pd.read_csv`` (exactly: index, column
    order, dtypes, values), with a sweep over μ_noise (the non-converged
    threshold follows its last value, as in the reference)."""
    out = {}
    for side, mod in (("jax", jd), ("torch", td)):
        with pytest.MonkeyPatch.context() as mp:
            names = stub_driver(mp, mod)
            kw = dict(v_test="mu_noise", n_random_runs=runs,
                      models_to_run=names, sweeps={"mu_noise": [0.05, 0.2]},
                      path=str(tmp_path / side / "study.csv"),
                      reject_nonconverged_runs=reject)
            if side == "torch":
                kw["device"] = "cpu"
            out[side] = mod.run_study(**kw)
    assert out["torch"] == out["jax"]
    files = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == files
    want = sorted({"study.csv", "study_1runs.csv", f"study_{runs}runs.csv"}
                  | ({"study_10runs.csv"} if runs >= 10 else set()))
    assert files == want
    for f in files:
        a = pd.read_csv(tmp_path / "torch" / f, index_col=0)
        b = pd.read_csv(tmp_path / "jax" / f, index_col=0)
        pd.testing.assert_frame_equal(a, b, check_exact=True)
        assert any(i.endswith("_conv") for i in a.index) == reject
        assert ("n_sucess_runs" in a.columns) == reject


def test_run_study_runs_on_the_cpu(tmp_path):
    """One real study at the JAX test's size (tests/test_experiments.py):
    landmark and final CSVs with the _conv rows, every metric finite."""
    res = td.run_study(
        v_test="void", n_random_runs=2, models_to_run=["PLMC_fast"],
        params=dict(n=40, p=4, q=2, q_noise=2, mu_noise=0.1),
        path=str(tmp_path / "study.csv"), n_iter=60, lr=0.05, patience=20,
        n_test=30, reject_nonconverged_runs=True, device="cpu")
    assert list(res) == ["PLMC_fast_void_void_0_0"]
    final = pd.read_csv(tmp_path / "study.csv", index_col=0)
    pd.testing.assert_frame_equal(
        final, pd.read_csv(tmp_path / "study_2runs.csv", index_col=0))
    assert list(final.index) == ["PLMC_fast_void_void_0_0",
                                 "PLMC_fast_void_void_0_0_conv"]
    for col in ("RMSE", "R2", "PVA", "alpha_CI", "train_time", "n_iter"):
        assert np.isfinite(final[col]).all(), col
    assert final["R2"].iloc[0] > 0.5


# -- the loaders -------------------------------------------------------------------

STATIONS = ["bramblemet", "cambermet", "chimet", "sotonmet"]


def write_tidal(root, seed=0, start=datetime(2020, 5, 31, 22, 0),
                days=15.2, gaps=False):
    """Four ``<station>.csv.gz`` files in the bramblemet format (``Date``
    dd/mm/YYYY, ``Time`` HH:MM, ``DEPTH`` and a spare column) on a 5-minute
    clock, one station's clock 2 minutes late (so that interp1d works);
    ``gaps`` leaves some DEPTH fields empty or "NaN"."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "bramblemet")
    os.makedirs(d, exist_ok=True)
    n = int(days * 288)
    for k, station in enumerate(STATIONS):
        t0 = start + timedelta(minutes=2 if k == 2 else 0)
        with gzip.open(os.path.join(d, f"{station}.csv.gz"), "wt",
                       newline="") as f:
            w = csv.writer(f)
            w.writerow(["Date", "Time", "DEPTH", "WSPD"])
            for i in range(n):
                t = t0 + timedelta(minutes=5 * i)
                h = i / 12.0
                depth = f"{2.0 + np.cos(2 * np.pi * h / 12.42 + k) + 0.05 * rng.standard_normal():.3f}"
                if gaps and i % 97 == 5:
                    depth = "" if i % 2 else "NaN"
                w.writerow([t.strftime("%d/%m/%Y"), t.strftime("%H:%M"),
                            depth, f"{rng.uniform(0, 20):.1f}"])


def same_dict(got, want, rtol=1e-12):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "M":
            # datetime64[ns] in the port, as pandas 2 gives; pandas 3 gives
            # datetime64[s]: the same instants
            assert got[k].dtype == np.dtype("datetime64[ns]"), k
            np.testing.assert_array_equal(got[k], v.astype(got[k].dtype),
                                          err_msg=k)
        elif isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            if v.dtype.kind in "iu":
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                close(got[k], v, rtol, k)
        else:
            assert got[k] == v, k


def test_load_tidal_matches_jax(tmp_path):
    """The joined, detrended, float32, ÷4 series with its held-out day and
    its datetime64[ns] dates, from a clock that starts before and ends
    after [start_date, end_date)."""
    write_tidal(str(tmp_path))
    got = treal.load_tidal(str(tmp_path))
    want = jreal.load_tidal(str(tmp_path))
    same_dict(got, want, rtol=1e-6)
    assert got["X"].dtype == np.float32 and got["Y"].shape[1] == 4
    assert str(got["dates"][0]).startswith("2020-06-01T00:00")
    assert got["dates"].dtype == np.dtype("datetime64[ns]")


def test_station_parse_matches_pandas(tmp_path):
    """Empty and "NaN" DEPTH fields read as NaN, and the naive stamps read
    as UTC seconds, as pandas reads them."""
    write_tidal(str(tmp_path), days=2, gaps=True)
    path = os.path.join(tmp_path, "bramblemet", "chimet.csv.gz")
    stamps, depth = treal._read_station(path)
    df = pd.read_csv(path, compression="gzip", low_memory=False)
    when = pd.to_datetime(df["Date"] + " " + df["Time"],
                          format="%d/%m/%Y %H:%M")
    np.testing.assert_array_equal(
        stamps.astype(np.int64).astype(np.float64),
        when.map(lambda x: x.timestamp()).values)
    np.testing.assert_array_equal(depth, df["DEPTH"].values.astype(float))
    assert np.isnan(depth).sum() > 0


def write_ship(root, rows=640, seed=0):
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "ship")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "data.txt"), "w") as f:
        for r in rng.standard_normal((rows, 18)) * rng.uniform(0.1, 100, 18):
            f.write("   " + "   ".join(f"{v:.3e}" for v in r) + "\n")


def test_load_ship_matches_jax(tmp_path):
    """The whitespace text (leading blanks, exponents) read as float64,
    ÷5, columns [0, 16, 17] in, [0, 1, 8, 11, 16, 17] out, z-scored."""
    write_ship(str(tmp_path))
    same_dict(treal.load_ship(str(tmp_path)), jreal.load_ship(str(tmp_path)))


@pytest.mark.parametrize("with_train", [False, True])
def test_load_sarcos_matches_jax(tmp_path, with_train):
    """The .mat files (scipy.io.savemat), with the training file or the
    split fallback and its flag."""
    from scipy.io import savemat
    rng = np.random.default_rng(1)
    d = tmp_path / "SARCOS"
    d.mkdir()
    savemat(d / "sarcos_inv_test.mat",
            {"sarcos_inv_test": rng.standard_normal((300, 28))})
    if with_train:
        savemat(d / "sarcos_inv.mat",
                {"sarcos_inv": rng.standard_normal((900, 28))})
    got = treal.load_sarcos(str(tmp_path))
    same_dict(got, jreal.load_sarcos(str(tmp_path)), rtol=1e-6)
    assert got["split_fallback"] is not with_train


def test_load_neutro_raises_as_jax(tmp_path):
    with pytest.raises(FileNotFoundError) as got:
        treal.load_neutro(str(tmp_path))
    with pytest.raises(FileNotFoundError) as want:
        jreal.load_neutro(str(tmp_path))
    assert str(got.value) == str(want.value)
    assert sorted(treal.LOADERS) == sorted(jreal.LOADERS)
    # the default root is the reference's folder name, under this checkout
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert treal.DEFAULT_DATA_ROOT == os.path.join(repo, "_experiments")
    assert os.path.basename(jreal.DEFAULT_DATA_ROOT) == "_experiments"


# -- the plots ----------------------------------------------------------------------

def study_csv(root, v="mu_noise", runs=3):
    rng = np.random.default_rng(2)
    rows = {}
    for i, x in enumerate([0.01, 0.1, 0.3]):
        for name in ("PLMC", "oilmm", "ICM"):
            rows[f"{name}_{v}_void_{i}_0"] = dict(
                n_iter=float(rng.integers(50, 500)),
                train_time=float(rng.uniform(1, 9)),
                mean_err_abs=float(rng.uniform(0.1, 0.5)),
                mean_err_quant05=0.05, mean_err_quant95=0.9,
                RMSE=float(rng.uniform(0.1, 0.5)),
                PVA=float(rng.normal()), model=name, **{v: x})
    df = pd.DataFrame.from_dict(rows, orient="index")
    conv = df.rename(index=lambda s: s + "_conv")
    pd.concat([df, conv]).to_csv(
        os.path.join(root, f"parameter_study_{v}_void_{runs}runs.csv"))


@pytest.mark.parametrize("metric", ["RMSE", "t_per_iter"])
def test_plots_match_jax(tmp_path, metric):
    """``setup``'s frame and labels (the _conv rows dropped, t_per_iter
    derived) and ``make_plot``'s pivot (Agg backend), against JAX's."""
    study_csv(str(tmp_path))
    got = tplots.setup("mu_noise", metric, 3, results_dir=str(tmp_path))
    want = jplots.setup("mu_noise", metric, 3, results_dir=str(tmp_path))
    pd.testing.assert_frame_equal(got[0][0], want[0][0], check_exact=True)
    assert got[1:] == want[1:]
    pivots = [mod.make_plot(res[0], res[1], metric, *res[2:5],
                            error_bars=True,
                            out_path=str(tmp_path / f"{side}.png"))
              for side, mod, res in (("t", tplots, got), ("j", jplots, want))]
    pd.testing.assert_frame_equal(pivots[0], pivots[1], check_exact=True)
    assert (tmp_path / "t.png").stat().st_size > 0
    for name in ("VARIABLES", "ALL_MODELS", "METRICS", "PLOT_STYLES",
                 "FANCY_LABELS", "SCALES"):
        assert getattr(tplots, name) == getattr(jplots, name), name


# -- no pandas on the card's host ------------------------------------------------------

def test_driver_and_loaders_run_without_pandas_or_matplotlib(tmp_path):
    """In a fresh interpreter with pandas and matplotlib blocked from
    import (and scikit-learn, which the card's host lacks too and which
    reads a blocked pandas as present): the driver and the loaders import,
    a one-model study runs and writes its CSVs, and ``load_tidal`` reads
    fixture files."""
    write_tidal(str(tmp_path))
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "sys.modules['sklearn'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from projected_lmc_tpu_torch.experiments import driver, realdata\n"
        "from projected_lmc_tpu_torch.experiments import plots\n"
        f"root = {str(tmp_path)!r}\n"
        "res = driver.run_study(n_random_runs=1, models_to_run=['PLMC'],\n"
        "    params=dict(n=20, p=3, q=1, q_noise=1), n_test=10, n_iter=3,\n"
        "    path=root + '/s.csv', reject_nonconverged_runs=True,\n"
        "    device='cpu')\n"
        "d = realdata.load_tidal(root)\n"
        "assert d['Y'].shape[1] == 4 and len(d['X_test']) > 0\n"
        "print(sorted(res), 'pandas' in sys.modules and\n"
        "      sys.modules['pandas'] is not None)\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("False"), res.stdout
    assert (tmp_path / "s.csv").exists() and (tmp_path / "s_1runs.csv").exists()
