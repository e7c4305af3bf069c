"""Study-result plotting (port of ``projected_lmc_tpu/experiments/plots.py``,
the rebuild of process_graphs.py). Host-side plotting of the driver's CSVs:
no torch and no device; pandas and matplotlib are imported inside the
functions, so the rest of the package runs without them.

Reads the CSVs the driver writes (same schema as the reference's
experiments.py exports), pivots model × swept-variable, and renders the
paper-style line plots with per-model styles, log-scale table, and optional
5/95% quantile bands. LaTeX rendering and seaborn styling are optional
(gracefully degraded when unavailable — the reference hard-requires both,
process_graphs.py:2,15).
"""

from __future__ import annotations

import os

VARIABLES = ["p", "q", "q_noise", "n", "mu_noise", "mu_str", "max_scale", "lik_rank"]
ALL_MODELS = ["ICM", "var", "PLMC", "PLMC_fast", "oilmm"]
METRICS = ["mean_err_abs", "PVA", "RMSE", "t_per_iter", "train_time"]

PLOT_STYLES = {  # process_graphs.py:41-46
    "PLMC": dict(ls="-.", lw=2, c="g", marker="x", markersize=8),
    "PLMC_fast": dict(ls=":", lw=2, c="c", marker="v", markersize=8),
    "oilmm": dict(ls="--", lw=2, c="r", marker="+", markersize=8),
    "var": dict(ls="-", lw=3, c="k", marker="o", markersize=10),
    "ICM": dict(ls="-", lw=3, c="y", marker="o", markersize=10),
}

FANCY_LABELS = {  # process_graphs.py:48-61 (plain-text variants of the LaTeX)
    "mu_str": r"$\mu_{str}$ (fraction of structured noise)",
    "n": "Number of training points",
    "p": "Number of tasks",
    "q": "Number of latent processes",
    "q_noise": r"$q_{noise}$ (number of noise latent processes)",
    "mu_noise": r"$\mu_{noise}$ (fraction of noise in the observations)",
    "max_scale": "Maximum lengthscale of the latent data",
    "RMSE": "RMSE",
    "mean_err_abs": "Average L1 error",
    "PVA": "Predictive Variance adequacy",
    "train_time": "Training time (s)",
    "t_per_iter": "Time per training iteration (s)",
}

SCALES = {  # process_graphs.py:63-68
    "t_per_iter": {v: "lin" for v in VARIABLES},
    "train_time": {v: "lin" for v in VARIABLES},
    "PVA": {"p": "lin", "q": "lin", "q_noise": "lin", "n": "lin",
            "mu_noise": "logx", "mu_str": "lin", "max_scale": "logx",
            "lik_rank": "lin"},
    "RMSE": {"p": "lin", "q": "lin", "q_noise": "lin", "n": "lin",
             "mu_noise": "loglog", "mu_str": "lin", "max_scale": "logx",
             "lik_rank": "lin"},
}


def setup(v: str, metric: str, n_runs: int, results_dir: str = "results",
          prefix: str = "_void", post_postfix: str = ""):
    """Load a study CSV and derive t_per_iter (process_graphs.py:73-94)."""
    import pandas as pd
    postfix = f"_{n_runs}runs" + post_postfix
    path = os.path.join(results_dir, f"parameter_study_{v}{prefix}{postfix}.csv")
    df = pd.read_csv(path, index_col=0)
    # drop the converged-only accumulator rows (reject_nonconverged_runs);
    # they duplicate (model, v) pairs and would break the pivot
    df = df[~df.index.str.endswith("_conv")]
    df["t_per_iter"] = df["train_time"] / df["n_iter"]
    scale = SCALES.get(metric, {}).get(v, "lin")
    return [df], v, FANCY_LABELS.get(v, v), FANCY_LABELS.get(metric, metric), \
        scale, scale == "loglog"


def make_plot(dfs, v, metric, xlabel, ylabel, scale="lin",
              mods_to_plot=ALL_MODELS, plot_styles=None, equal_axes=False,
              error_bars=False, out_path=None):
    """Line plot of metric vs v per model (process_graphs.py:98-150)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plot_styles = plot_styles or PLOT_STYLES
    fig, ax = plt.subplots(figsize=(10, 6), tight_layout=True)
    plotfunc = {"logy": ax.semilogy, "logx": ax.semilogx,
                "loglog": ax.loglog}.get(scale, ax.plot)
    full_labels = []
    lineplot = None
    for df in dfs:
        dft = df[df["model"].isin(mods_to_plot)]
        cols = [metric, "model", v] + (
            ["mean_err_quant05", "mean_err_quant95"] if error_bars else [])
        sub = dft[cols].copy()
        lineplot = sub.pivot(index="model", columns=v, values=metric).T
        xvals = lineplot.index.values
        for mod in lineplot.columns.values:
            plotfunc(xvals, lineplot[mod].values, **plot_styles[mod])
            full_labels.append(mod)
            if error_bars:
                lo = sub.pivot(index="model", columns=v,
                               values="mean_err_quant05").T[mod].values
                hi = sub.pivot(index="model", columns=v,
                               values="mean_err_quant95").T[mod].values
                ax.fill_between(xvals, lo, hi,
                                color=plot_styles[mod]["c"], alpha=0.2)

    if metric == "PVA":
        ax.axhline(y=0.0, linestyle="--", color="g")
    ax.grid(True, which="both")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(title="Models", labels=full_labels, title_fontsize=13)
    if equal_axes:
        ax.set_aspect("equal", adjustable="box")
    if out_path is None:
        out_path = f"{v}_{metric}.pdf"
    fig.savefig(out_path, format=out_path.rsplit(".", 1)[-1])
    plt.close("all")
    return lineplot
