"""Plain reference of the stochastic-volatility model (SVM).

x_t = A x_{t-1} + N(0, Q),   y_t ~ N(0, exp(x_t) R)

Parameters in the coordinates the port's sampler holds, each leaf with a
leading chain axis: ``A [C, 1, 1]``, ``LQinv_vec [C, 1]`` = Q^-1/2 and
``LRinv_vec [C, 1]`` = R^-1/2 (Aicher et al. 2019, arXiv:1901.10568,
section 5.2).  The bootstrap particle kernel, the Fisher-identity
statistic of the three leaves, the Wishart / matrix-normal prior's score
(the matrix-normal prior on A contributes no gradient to LQinv), the
projection ``|A| <= 0.9999`` with reflected Cholesky factors, the
initial-state prior N(0, Q / (1 - A^2)) capped at 1e3, and the transition
density of PaRIS's backward weights.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LEAVES = ("A", "LQinv_vec", "LRinv_vec")      # the sampler's field order
SHAPES = {"A": (1, 1), "LQinv_vec": (1,), "LRinv_vec": (1,)}
STATE_DIM, NOISE_DIM, STAT_DIM = 1, 1, 3
LOG_2PI = math.log(2.0 * math.pi)
A_MAX = 0.9999


def from_natural(A, Q, R):
    """Leaves ``[C, ...]`` from natural (A, Q, R) tensors ``[C]``."""
    C = A.shape[0]
    return {"A": A.reshape(C, 1, 1), "LQinv_vec": (Q ** -0.5).reshape(C, 1),
            "LRinv_vec": (R ** -0.5).reshape(C, 1)}


def columns(p):
    """[a, lqinv, lrinv], each ``[C, 1]``."""
    return [p["A"][:, 0, 0:1], p["LQinv_vec"][:, 0:1], p["LRinv_vec"][:, 0:1]]


def prior_moments(p):
    """Initial-state prior (mean, variance), each ``[C, 1]``."""
    a, lqinv, _ = columns(p)
    var = torch.clamp((1.0 / (lqinv * lqinv)) / (1.0 - a * a), max=1e3)
    return torch.zeros_like(var), var


def init(z, mean, var):
    return [mean + torch.sqrt(var) * z[0]]


def propose(pv, z, x, y):
    a, lqinv, _ = pv
    return [a * x[0] + z[0] / lqinv]


def reweight(pv, x, x_new, y):
    """log N(y; 0, exp(x') R), the exponent clipped to [-60, 60]."""
    lrinv = pv[2]
    xn = x_new[0]
    e = torch.exp(torch.clamp(-xn, -60.0, 60.0))
    return (-0.5 * LOG_2PI - 0.5 * (y * y) * e * (lrinv * lrinv)
            + torch.log(torch.abs(lrinv)) - 0.5 * xn)


def transition_log_density(pv, x, x_new):
    """log N(x'; A x, Q), PaRIS's backward kernel."""
    a, lqinv, _ = pv
    diff = x_new[0] - a * x[0]
    return (-0.5 * diff * diff * (lqinv * lqinv) - 0.5 * LOG_2PI
            + torch.log(torch.abs(lqinv)))


def statistic(pv, x, x_new, y):
    """Per-particle gradient of log p(y', x' | x) in the leaves' order of
    ``unpack``: (LRinv, LQinv, A)."""
    a, lqinv, lrinv = pv
    x0, x1 = x[0], x_new[0]
    diff = x1 - a * x0
    g_a = (lqinv * lqinv) * diff * x0
    g_lq = 1.0 / lqinv - diff * diff * lqinv
    g_lr = 1.0 / lrinv - (y * y) * torch.exp(torch.clamp(-x1, -60.0, 60.0)) \
        * lrinv
    return [g_lr, g_lq, g_a]


def unpack(stat):
    """Statistic ``[C, 3]`` as leaves."""
    C = stat.shape[0]
    return {"A": stat[:, 2].reshape(C, 1, 1), "LQinv_vec": stat[:, 1:2],
            "LRinv_vec": stat[:, 0:1]}


def grad_logprior(prior, p):
    """Score of the Wishart(df, scale) priors on Q^-1 and R^-1 in their
    Cholesky factors and of A ~ N(mean_A, Q var_A).  The hyperparameters
    are tensors in the leaves' precision, so each quotient is a true
    division."""
    lq, lr = p["LQinv_vec"], p["LRinv_vec"]
    df, scale, mean_a, var_a = (
        torch.full((), prior[k], dtype=lq.dtype, device=lq.device)
        for k in ("df", "scale", "mean_A", "var_A"))
    return {"A": -(lq * lq)[:, :, None] * (p["A"] - mean_a) / var_a,
            "LQinv_vec": (df - 1.0 - 1.0) / lq - lq / scale,
            "LRinv_vec": (df - 1.0 - 1.0) / lr - lr / scale}


def project(p):
    return {"A": torch.clamp(p["A"], -A_MAX, A_MAX),
            "LQinv_vec": torch.abs(p["LQinv_vec"]),
            "LRinv_vec": torch.abs(p["LRinv_vec"])}


def prior_hyper(cfg):
    """The configuration's prior: Wishart df = 2 + 1 / var, scale 1 / df;
    A's prior mean 0 and column variance ``var``."""
    var = float(cfg["prior"]["var"])
    df = 2.0 + 1.0 / var
    return {"df": df, "scale": 1.0 / df, "mean_A": 0.0, "var_A": var}


def simulate(truth, z):
    """The series ``y [T]`` (float64 numpy) of the true parameters from
    standard normals ``z [2, T + 1]``: x_0 from the stationary law."""
    a, q, r = truth["A"], truth["Q"], truth["R"]
    T = z.shape[1] - 1
    x = np.sqrt(q / (1.0 - a * a)) * z[0, 0]
    ys = np.empty(T)
    for t in range(T):
        x = a * x + np.sqrt(q) * z[0, t + 1]
        ys[t] = np.exp(0.5 * x) * np.sqrt(r) * z[1, t + 1]
    return ys
