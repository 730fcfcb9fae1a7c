"""Plotting utilities: metric-vs-time facet grids and trace plots.

Counterpart of ``sgmcmc_tpu/evaluation/plotting.py`` on matplotlib (and
pandas), which only this module of the port imports.  All functions take
tidy DataFrames in the evaluator schema (iteration, metric, variable,
value[, time]); the data-fit panels call the sampler's ``predict``.
"""
from __future__ import annotations

import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402


def plot_metrics(metrics_df: pd.DataFrame, x: str = "iteration",
                 path: str | None = None):
    """One subplot per metric."""
    metrics = sorted(metrics_df["metric"].unique())
    fig, axes = plt.subplots(1, max(len(metrics), 1),
                             figsize=(4 * max(len(metrics), 1), 3),
                             squeeze=False)
    for ax, metric in zip(axes[0], metrics):
        sub = metrics_df[metrics_df["metric"] == metric]
        for var, g in sub.groupby("variable"):
            ax.plot(g[x], g["value"], label=str(var))
        ax.set_title(metric)
        ax.set_xlabel(x)
        ax.legend(fontsize=6)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig


def compare_metrics(evaluators: dict, metric: str, x: str = "time",
                    path: str | None = None):
    """Overlay one metric across evaluators."""
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, ev in evaluators.items():
        df = ev.get_metrics()
        sub = df[df["metric"] == metric]
        ax.plot(sub[x], sub["value"], label=str(name))
    ax.set_xlabel(x)
    ax.set_ylabel(metric)
    ax.legend(fontsize=7)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig


def plot_trace_plot(samples_df: pd.DataFrame, path: str | None = None):
    """Parameter trace plots."""
    variables = sorted(samples_df["variable"].unique())
    fig, axes = plt.subplots(len(variables), 1,
                             figsize=(6, 2 * len(variables)), squeeze=False)
    for ax, var in zip(axes[:, 0], variables):
        g = samples_df[samples_df["variable"] == var]
        ax.plot(g["iteration"], g["value"])
        ax.set_ylabel(var)
    axes[-1, 0].set_xlabel("iteration")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig


def plot_data_fit(observations, x_mean, x_sd=None, path: str | None = None):
    """Data + smoothed-latent overlay."""
    fig, ax = plt.subplots(figsize=(8, 3))
    t = np.arange(len(observations))
    ax.plot(t, np.ravel(observations), lw=0.4, alpha=0.5, label="y")
    ax.plot(t, np.ravel(x_mean), lw=1.0, label="E[x | y]")
    if x_sd is not None:
        ax.fill_between(t, np.ravel(x_mean) - 2 * np.ravel(x_sd),
                        np.ravel(x_mean) + 2 * np.ravel(x_sd), alpha=0.2)
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig


def _data_fit_panels(observations, transform, true_latent_vars, sampler,
                     N, panel0_label, panel1_label, latent_panel,
                     squared=False):
    observations = np.ravel(np.asarray(observations))
    fig, axes = plt.subplots(2, 1, sharex=True, figsize=(8, 5))
    axes[0].plot(observations, "oC0", ms=2, label=panel0_label)
    axes[0].set_ylabel(panel0_label)
    axes[1].plot(transform(observations), "oC0", ms=2, label=panel1_label)
    axes[1].set_ylabel(panel1_label)
    ax = axes[latent_panel]
    if true_latent_vars is not None:
        ax.plot(np.ravel(true_latent_vars), "-C1", label="latent_var")
    if sampler is not None:
        mean, var = sampler.predict(target="latent", kind="pf", N=N,
                                    squared=squared)
        mean = np.ravel(mean)
        sd = np.sqrt(np.clip(np.ravel(var), 0.0, None))
        ax.plot(mean, "-C2", label="PF E[X|Y] +/- SD(X|Y)")
        ax.plot(mean + sd, "--C2")
        ax.plot(mean - sd, "--C2")
    for a in axes:
        a.legend()
    fig.tight_layout()
    return fig, axes


def plot_svm_data_fit(observations, true_latent_vars=None, sampler=None,
                      N: int = 10000, path: str | None = None):
    """SVM data-fit panels: raw y_t, and demeaned log(y_t^2) with the
    PF-smoothed log-volatility overlay."""
    obs = np.ravel(np.asarray(observations))
    logsq = np.log(obs ** 2)

    fig, axes = _data_fit_panels(
        obs, lambda y: np.log(y ** 2) - np.mean(logsq), true_latent_vars,
        sampler, N, "raw observations", "log(observations^2)",
        latent_panel=1)
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig, axes


def plot_garch_data_fit(observations, true_latent_vars=None, sampler=None,
                        N: int = 10000, path: str | None = None):
    """GARCH data-fit panels: y_t with the PF-smoothed latent x_t overlay,
    and y_t^2."""
    fig, axes = _data_fit_panels(
        observations, lambda y: y ** 2, true_latent_vars, sampler, N,
        "observations", "observations^2", latent_panel=0)
    if sampler is not None:
        mean, _ = sampler.predict(target="latent", kind="pf", N=N)
        axes[1].plot(np.ravel(mean) ** 2, "-C2", label="PF E[X|Y]^2")
        axes[1].legend()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig, axes


def plot_aggregated_metrics(agg: pd.DataFrame, fig_dir: str):
    """Metric-vs-time facets by experiment, one file a metric."""
    if "metric" not in agg.columns:
        return
    for metric in sorted(agg["metric"].dropna().unique()):
        sub = agg[agg["metric"] == metric]
        if "time" not in sub.columns or sub["time"].isna().all():
            xcol = "iteration"
        else:
            xcol = "time"
        fig, ax = plt.subplots(figsize=(7, 4))
        label_col = "name" if "name" in sub.columns else "experiment_id"
        for key, g in sub.groupby(["experiment_id"]):
            g = g.sort_values(xcol)
            lbl = str(g[label_col].iloc[0]) if label_col in g else str(key)
            ax.plot(g[xcol], g["value"], label=lbl, alpha=0.8)
        ax.set_xlabel(xcol)
        ax.set_ylabel(metric)
        ax.legend(fontsize=6)
        fig.tight_layout()
        safe = metric.replace("/", "_")
        fig.savefig(os.path.join(fig_dir, f"{safe}.png"), dpi=100)
        plt.close(fig)
