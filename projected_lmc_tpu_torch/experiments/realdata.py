"""Real-data loaders (port of ``projected_lmc_tpu/experiments/realdata.py``,
the rebuild of realdata_experiments.py:277-551), with numpy, ``gzip``/``csv``
and scipy instead of pandas, so that they run where pandas is not installed.

Each loader returns dict(X, Y, X_test, Y_test, **experiment config) with the
same keys, dtypes and arrays as the JAX package's:

  * tidal/bramblemet (:277-322): 4 station CSVs, datetime join on a common
    clock via interp1d, polynomial detrend (deg 2), ÷4 subsample, a 1-day
    held-out window in the middle; SpectralMixture kernel experiment.
  * ship (:395-410): whitespace txt, ÷5, X = cols [0,16,17], 13 z-scored
    outputs, last 100 rows test, 500 inducing points, float64.
  * sarcos (:503-517): loadmat, 21 joint dims → 7 torques, z-scored, ÷10,
    500 inducing points. (The reference repo ships only the test .mat; when
    the train file is absent we split the test set, flagged in the output.)
  * neutro (:453-461): pre-saved torch tensors — data absent from the
    reference repo; loader raises FileNotFoundError with the expected names.
"""

from __future__ import annotations

import csv
import gzip
import os
from datetime import datetime

import numpy as np

# the reference repository's ``_experiments`` folder (bramblemet/, ship/,
# SARCOS/, neutro_data/), read from the root of this repository; the data
# is not in it yet, so every loader takes ``root``
DEFAULT_DATA_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "_experiments")

# the strings pandas.read_csv reads as NaN by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}


def _read_station(path):
    """(stamps, depths) of a station's ``.csv.gz``: the ``Date`` +
    ``Time`` columns (``%d/%m/%Y %H:%M``) as naive ``datetime64[s]`` and
    ``DEPTH`` as float64, NaN where pandas reads NaN."""
    stamps, depths = [], []
    with gzip.open(path, "rt", newline="") as f:
        for row in csv.DictReader(f):
            stamps.append(datetime.strptime(f"{row['Date']} {row['Time']}",
                                            "%d/%m/%Y %H:%M"))
            d = row["DEPTH"]
            depths.append(np.nan if d is None or d.strip() in _NA
                          else float(d))
    return (np.array(stamps, dtype="datetime64[s]"),
            np.array(depths, dtype=np.float64))


def load_tidal(root: str = None, start_date: str = "2020-06-01",
               end_date: str = "2020-06-15", degree: int = 2, ndiv: int = 4,
               dtype=np.float32):
    from scipy.interpolate import interp1d

    root = os.path.join(root or DEFAULT_DATA_ROOT, "bramblemet")

    def detrend(x, y, degree=1):
        coef = np.polyfit(x, y, degree)
        return y - np.polyval(coef, x)

    dico = {}
    ref_time = ref_time_norm = None
    stations = ["bramblemet", "cambermet", "chimet", "sotonmet"]
    lo, hi = np.datetime64(start_date, "s"), np.datetime64(end_date, "s")
    for station in stations:
        stamps, values = _read_station(
            os.path.join(root, f"{station}.csv.gz"))
        keep = (stamps >= lo) & (stamps < hi)       # [start, end) midnights
        # seconds since the epoch, the naive stamps read as UTC (as
        # pandas' Timestamp.timestamp() reads them)
        time_num = stamps[keep].astype(np.int64).astype(np.float64)
        values = values[keep]
        if ref_time is None:
            ref_time = time_num
            ref_time_norm = ref_time / ref_time.max()
            ref_time_norm = ref_time_norm - ref_time_norm[0]
            dico["time_num"] = ref_time_norm
        else:
            values = interp1d(time_num, values, bounds_error=False,
                              fill_value="extrapolate")(ref_time)
        dico[station] = detrend(ref_time_norm, values, degree=degree)

    # cast to ``dtype`` before the ÷ndiv subsampling, as the JAX loader's
    # DataFrame.astype does
    frame = np.stack([dico[k] for k in dico], axis=1).astype(dtype)[::ndiv]
    # wall-clock dates of the subsampled rows (for the prediction time-series
    # figure, process_graphs.py:155-201)
    dates = np.round(ref_time[::ndiv] * 1e9).astype(np.int64).astype(
        "datetime64[ns]")
    X = frame[:, :1]
    Y = frame[:, 1:]
    num_days = (datetime.strptime(end_date, "%Y-%m-%d")
                - datetime.strptime(start_date, "%Y-%m-%d")).days
    n = len(frame)
    test_idx = np.arange(n // 2, n // 2 + n // num_days)
    X_train, X_test = np.delete(X, test_idx, axis=0), X[test_idx]
    Y_train, Y_test = np.delete(Y, test_idx, axis=0), Y[test_idx]
    return dict(X=X_train, Y=Y_train, X_test=X_test, Y_test=Y_test,
                kernel_type="spectral_mixture", ker_kwargs={"num_mixtures": 5},
                n_ind_points=None, q=Y_train.shape[1], loss_thresh=1e-7,
                n_iter=50000, test_indices=test_idx, dates=dates,
                stations=stations)


def load_ship(root: str = None, ndiv: int = 5, dtype=np.float64):
    root = os.path.join(root or DEFAULT_DATA_ROOT, "ship")
    data = np.loadtxt(os.path.join(root, "data.txt"), dtype=np.float64,
                      ndmin=2)
    data = data[::ndiv]
    X = data[:, [0, 16, 17]].astype(dtype)
    Y = np.delete(data, [0, 1, 8, 11, 16, 17], axis=1).astype(dtype)
    X, X_test = X[:-100], X[-100:]
    Y, Y_test = Y[:-100], Y[-100:]
    mean, std = Y.mean(axis=0), Y.std(axis=0)
    Y, Y_test = (Y - mean) / std, (Y_test - mean) / std
    return dict(X=X, Y=Y, X_test=X_test, Y_test=Y_test, kernel_type="matern",
                n_ind_points=500, q=3, loss_thresh=1e-7, n_iter=50000)


def load_sarcos(root: str = None, ndiv: int = 10, dtype=np.float32):
    from scipy.io import loadmat
    root = os.path.join(root or DEFAULT_DATA_ROOT, "SARCOS")
    test_data = loadmat(os.path.join(root, "sarcos_inv_test.mat"))[
        "sarcos_inv_test"].astype(dtype)
    train_path = os.path.join(root, "sarcos_inv.mat")
    split_fallback = not os.path.exists(train_path)
    if split_fallback:
        # reference repo ships only the test file; hold out the last 20%
        k = int(0.8 * len(test_data))
        train_data, test_data = test_data[:k], test_data[k:]
        train_data = train_data[::max(1, ndiv // 5)]
    else:
        train_data = loadmat(train_path)["sarcos_inv"].astype(dtype)[::ndiv]
    X, Y = train_data[:, :21], train_data[:, 21:]
    X_test, Y_test = test_data[:, :21], test_data[:, 21:]
    mean, std = Y.mean(axis=0), Y.std(axis=0)
    Y, Y_test = (Y - mean) / std, (Y_test - mean) / std
    return dict(X=X, Y=Y, X_test=X_test, Y_test=Y_test, kernel_type="matern",
                n_ind_points=500, q=Y.shape[1], loss_thresh=1e-7,
                n_iter=50000, split_fallback=split_fallback)


def load_neutro(root: str = None):
    root = os.path.join(root or DEFAULT_DATA_ROOT, "neutro_data")
    expected = ["train_x_sobol256.pt", "test_x_LHS512.pt",
                "train_data_02g_FA_Lchain.pt", "test_data_02g_FA_Lchain.pt"]
    paths = [os.path.join(root, f) for f in expected]
    if not all(os.path.exists(p) for p in paths):
        raise FileNotFoundError(
            f"neutro data absent (also absent from the reference repo); "
            f"expected {expected} under {root}")
    import torch
    X, X_test, Y, Y_test = [np.asarray(torch.load(p, weights_only=True))
                            for p in paths]
    return dict(X=X, Y=Y, X_test=X_test, Y_test=Y_test, kernel_type="matern",
                n_ind_points=None, q=20, loss_thresh=1e-7, n_iter=100000)


LOADERS = {"tidal": load_tidal, "ship": load_ship, "sarcos": load_sarcos,
           "neutro": load_neutro}
