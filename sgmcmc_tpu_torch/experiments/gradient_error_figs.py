"""Gradient bias against buffer size (the paper's core figure).

Counterpart of ``sgmcmc_tpu/experiments/gradient_error_figs.py``: fix
theta at the truth, take the centred subsequence of length L in a series
of length T, compute the ground-truth gradient of that subsequence (the
LGSSM: exact buffered Kalman messages; the other models: Poyiadjis O(N)
with a very large N over the whole series, averaged over reps), then
sweep buffer sizes x particle counts x replications of the buffered PF
gradient and report each parameter's mean absolute bias, variance and
MSE.  The replications of one (buffer, N) cell are the chains of one
``run_buffered_pf`` call (systematic resampling), on the card unless
``device="cpu"``.

Usage: python -m sgmcmc_tpu_torch.experiments.gradient_error_figs
    --model svm [--device cpu]

The CSV is written without pandas; the PNG needs matplotlib (skipped,
with a message, where it is missing).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..io import tables
from ..models.base import params_map
from ..models.registry import get_model
from ..ops.buffered import run_buffered_pf
from ..ops.subsequence import subsequence_weights

BUFFER_SIZES = (0, 2, 3, 5, 10, 12, 15, 18, 20)
PARTICLE_COUNTS = (100, 1000)


def pf_gradient_batch(model, params, window, step_w, in_win, generator,
                      reps: int, N: int, smoother="poyiadjis_N",
                      resample_mode="auto") -> torch.Tensor:
    """The buffered PF gradient statistic of ``reps`` independent
    replications [reps, H]: one chain each, every chain on the same
    ``window [W, m]`` with step weights ``step_w [W]`` and ``in_win [W]``
    (one chain's ``params``)."""
    dev = window.device
    W = window.shape[0]
    kern = model.get_kernel(None)
    p = params_map(lambda x: x.expand((reps,) + x.shape[1:]), params)
    pm, pv = model.prior_mean_var(p)
    Z = kern.noise_dim
    out = run_buffered_pf(
        kern, model.grad_statistic, p, window.expand(reps, W, -1),
        z0=torch.randn((reps, Z, N), generator=generator, device=dev),
        normals=torch.randn((reps, W, Z, N), generator=generator,
                            device=dev),
        u=torch.rand((reps, W), generator=generator, device=dev),
        statistic_dim=model.grad_statistic_dim, smoother=smoother,
        step_weights=step_w.expand(reps, W),
        in_window=in_win.expand(reps, W), prior_mean=pm, prior_var=pv,
        resampler="systematic", resample_mode=resample_mode)
    return out.mean_statistic


def make_observations(model_name: str, T: int, seed: int = 0,
                      device="cuda"):
    """(true parameters (float32), observations [T, m]) drawn from a
    generator on ``device`` seeded by ``seed``."""
    from .driver import _make_true_params
    params = _make_true_params(model_name, dtype=torch.float32,
                               device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    ys, _ = get_model(model_name).generate_data(gen, params, T)
    return params, ys.to(torch.float32)


def _subsequence(T: int, L: int, ys):
    """(start, weights [L]) of the centred subsequence."""
    start = (T - L) // 2
    w = subsequence_weights(torch.tensor([start], device=ys.device), L, T,
                            "uniform", ys.dtype)[0]
    return start, w


def ground_truth(model_name: str, params, ys, L: int, truth_N: int = 100000,
                 truth_reps: int = 4, generator=None,
                 resample_mode="auto") -> np.ndarray:
    """The subsequence's gradient statistic [H]: for the LGSSM the exact
    buffered Kalman gradient (float64 messages over the whole series),
    else the mean of ``truth_reps`` Poyiadjis O(N) runs at ``truth_N``
    particles over the whole series (buffer B = T)."""
    T = ys.shape[0]
    start, w = _subsequence(T, L, ys)
    if model_name == "lgssm":
        from ..models import lgssm as lgssm_mod
        from ..ops import kalman
        p64 = params_map(lambda x: x.double(), params)
        y = ys.double()[None]
        mats = (p64.A, p64.C, p64.LQinv, p64.LRinv)
        fmsg = kalman.forward_message(
            y[:, :start], *mats, lgssm_mod.default_forward_message(p64))
        bmsg = kalman.backward_message(
            y[:, start + L:], *mats, lgssm_mod.default_backward_message(p64))
        g = lgssm_mod.gradient_marginal_loglikelihood(
            p64, y[:, start:start + L], forward_msg=fmsg, backward_msg=bmsg,
            weights=w.double()[None])
        return np.concatenate([g.LRinv_vec.cpu().numpy().ravel(),
                               g.LQinv_vec.cpu().numpy().ravel(),
                               g.C.cpu().numpy().ravel(),
                               g.A.cpu().numpy().ravel()])
    step_w = torch.zeros(T, dtype=ys.dtype, device=ys.device)
    step_w[start:start + L] = w
    stats = pf_gradient_batch(get_model(model_name), params, ys, step_w,
                              (step_w > 0).to(ys.dtype), generator,
                              truth_reps, truth_N,
                              resample_mode=resample_mode)
    return stats.double().mean(0).cpu().numpy()


def sweep(model_name: str, params, ys, L: int, truth: np.ndarray,
          buffer_sizes=BUFFER_SIZES, particle_counts=PARTICLE_COUNTS,
          reps: int = 20, generator=None, resample_mode="auto") -> list:
    """Rows {buffer, N, param_index, abs_bias, variance, mse} of the
    buffered PF gradient against ``truth`` over buffer sizes and particle
    counts, ``reps`` replications a cell."""
    model = get_model(model_name)
    T = ys.shape[0]
    start, w = _subsequence(T, L, ys)
    rows = []
    for B in buffer_sizes:
        lo, hi = max(0, start - B), min(T, start + L + B)
        step_w = torch.zeros(hi - lo, dtype=ys.dtype, device=ys.device)
        step_w[start - lo:start - lo + L] = w
        in_win = (step_w > 0).to(ys.dtype)
        for N in particle_counts:
            stats = pf_gradient_batch(
                model, params, ys[lo:hi], step_w, in_win, generator, reps,
                N, resample_mode=resample_mode).double().cpu().numpy()
            bias = stats.mean(axis=0) - truth
            var = stats.var(axis=0)
            for j in range(stats.shape[1]):
                rows.append(dict(buffer=B, N=N, param_index=j,
                                 abs_bias=float(abs(bias[j])),
                                 variance=float(var[j]),
                                 mse=float(bias[j] ** 2 + var[j])))
    return rows


def plot(rows: list, model_name: str, path: str) -> bool:
    """The log-scale bias-vs-buffer figure; False where matplotlib is
    missing."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {path} not written")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4))
    for N, j in sorted({(r["N"], r["param_index"]) for r in rows}):
        g = sorted((r for r in rows if r["N"] == N and r["param_index"] == j),
                   key=lambda r: r["buffer"])
        ax.semilogy([r["buffer"] for r in g], [r["abs_bias"] for r in g],
                    marker="o", ms=3, label=f"N={N} param{j}", alpha=0.7)
    ax.set_xlabel("buffer size")
    ax.set_ylabel("|bias|")
    ax.set_title(f"{model_name}: gradient bias vs buffer size")
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def run(model_name: str = "svm", T: int = 100, L: int = 16,
        buffer_sizes=BUFFER_SIZES, particle_counts=PARTICLE_COUNTS,
        reps: int = 20, truth_N: int = 100000, truth_reps: int = 4,
        seed: int = 0, out_dir: str = "./grad_error_out",
        resample_mode="auto", device="cuda") -> list:
    """The whole figure: observations, truth, sweep, then
    ``<model>_grad_error.csv`` and ``.png`` in ``out_dir``.  Returns the
    rows."""
    params, ys = make_observations(model_name, T, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    truth = ground_truth(model_name, params, ys, L, truth_N, truth_reps,
                         gen, resample_mode)
    rows = sweep(model_name, params, ys, L, truth, buffer_sizes,
                 particle_counts, reps, gen, resample_mode)
    os.makedirs(out_dir, exist_ok=True)
    tables.write_csv(os.path.join(out_dir, f"{model_name}_grad_error.csv"),
                     rows)
    plot(rows, model_name,
         os.path.join(out_dir, f"{model_name}_grad_error.png"))
    return rows


def mean_bias_by_buffer(rows: list) -> dict:
    """{buffer: mean |bias| over its rows}."""
    out = {}
    for B in sorted({r["buffer"] for r in rows}):
        out[B] = float(np.mean([r["abs_bias"] for r in rows
                                if r["buffer"] == B]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="svm",
                    choices=["svm", "svjm", "lgssm", "garch"])
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--L", type=int, default=16)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--truth_N", type=int, default=100000)
    ap.add_argument("--out", default="./grad_error_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.model, T=args.T, L=args.L, reps=args.reps,
               truth_N=args.truth_N, out_dir=args.out, device=args.device)
    print(json.dumps({str(k): v
                      for k, v in mean_bias_by_buffer(rows).items()}))


if __name__ == "__main__":
    main()
