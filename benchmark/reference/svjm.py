"""Plain reference of the stochastic-volatility model with jumps (SVJM).

x_t = A x_{t-1} + N(0, Q) + J_t N(0, QJ),   J_t ~ Bernoulli(pJ),
y_t ~ N(0, exp(x_t) R)

Parameters in the coordinates the port's sampler holds, each leaf with a
leading chain axis: ``A [C, 1, 1]``, ``LQinv_vec [C, 1]`` = Q^-1/2,
``LRinv_vec [C, 1]`` = R^-1/2, ``logit_pJ [C, 1]`` and ``LQJinv_vec [C,
1]`` = QJ^-1/2 (the upstream SVJM's pJ, phi, sigma2 and sigmaJ2).

The bootstrap kernel draws two normals a particle: the jump is the second
below the threshold ``ndtri(pJ)`` (probability pJ), and x' = A x + sqrt(Q
+ J QJ) z_1.  The fused window clips pJ to ``[1e-6, 1 - 1e-6]`` before
``ndtri``; the PyTorch step does not.  The projection keeps ``|logit_pJ|
<= 13``, so pJ lies in [2.3e-6, 1 - 2.3e-6] and the clip never binds: both
rules give the same float, which ``jump_threshold`` computes with the
port's float32 operations (sigmoid, clamp, ndtri) in its order.  A
threshold one float off would flip every jump whose normal falls on it.

The statistic is the Fisher-identity score: the transition's is the
mixture of the two branch scores weighted by the jump responsibility
``r1 = P(J = 1 | x, x')``, a sigmoid through ``1 / (1 + exp(-v))`` with
the exponent clipped to [-60, 60].  The emission is the SVM's.  The
prior: Wishart on Q^-1, R^-1 and QJ^-1, matrix-normal on A, Beta(2, 18)
on pJ taken through the logit; the initial state N(0, (Q + pJ QJ) / (1 -
A^2)) capped at 1e3.
"""
from __future__ import annotations

import statistics

import numpy as np
import torch

from . import svm

LEAVES = ("A", "LQinv_vec", "LRinv_vec", "logit_pJ", "LQJinv_vec")
SHAPES = {"A": (1, 1), "LQinv_vec": (1,), "LRinv_vec": (1,),
          "logit_pJ": (1,), "LQJinv_vec": (1,)}
STATE_DIM, NOISE_DIM, STAT_DIM = 1, 2, 5
SERIES_NORMALS = 3              # the state's, the observation's, the jump's
A_MAX = 0.9999
LOGIT_MAX = 13.0
PJ_CLIP = 1e-6


def from_natural(A, Q, R, pJ, QJ):
    """Leaves ``[C, ...]`` from natural (A, Q, R, pJ, QJ) tensors ``[C]``
    (computed in the tensors' dtype)."""
    C = A.shape[0]
    return {"A": A.reshape(C, 1, 1), "LQinv_vec": (Q ** -0.5).reshape(C, 1),
            "LRinv_vec": (R ** -0.5).reshape(C, 1),
            "logit_pJ": torch.log(pJ / (1.0 - pJ)).reshape(C, 1),
            "LQJinv_vec": (QJ ** -0.5).reshape(C, 1)}


def _ndtri(p):
    """The standard normal quantile; a precision without ``ndtri``
    (bfloat16) takes it in float32, rounded back."""
    if p.dtype == torch.bfloat16:
        return torch.special.ndtri(p.float()).to(p.dtype)
    return torch.special.ndtri(p)


def jump_threshold(p, clip: bool = True):
    """``ndtri(pJ)`` ``[C, 1]``: the fused window's rule (pJ clipped to
    ``[1e-6, 1 - 1e-6]``) or, with ``clip=False``, the PyTorch step's."""
    pj = torch.sigmoid(p["logit_pJ"])
    if clip:
        pj = torch.clamp(pj, PJ_CLIP, 1.0 - PJ_CLIP)
    return _ndtri(pj)


def columns(p):
    """[a, lqinv, lrinv, lqjinv, logit_pJ, ndtri(pJ)], each ``[C, 1]``:
    the fused window's parameter vector."""
    return [p["A"][:, 0, 0:1], p["LQinv_vec"][:, 0:1], p["LRinv_vec"][:, 0:1],
            p["LQJinv_vec"][:, 0:1], p["logit_pJ"][:, 0:1],
            jump_threshold(p)]


def prior_moments(p):
    """Initial-state prior (mean, variance), each ``[C, 1]``: the
    stationary variance (Q + pJ QJ) / (1 - A^2), capped at 1e3."""
    a, lqinv, _, lqjinv, logit, _ = columns(p)
    q = 1.0 / (lqinv * lqinv)
    qj = 1.0 / (lqjinv * lqjinv)
    var = torch.clamp((q + torch.sigmoid(logit) * qj) / (1.0 - a ** 2),
                      max=1e3)
    return torch.zeros_like(var), var


def init(z, mean, var):
    """The initial state from the first of the Z = 2 initial normals."""
    return [mean + torch.sqrt(var) * z[0]]


def propose(pv, z, x, y):
    a, lqinv, _, lqjinv, _, thr = pv
    jump = (z[1] < thr).to(z[0].dtype)
    var = 1.0 / (lqinv * lqinv) + jump / (lqjinv * lqjinv)
    return [a * x[0] + torch.sqrt(var) * z[0]]


reweight = svm.reweight        # pv[2] is lrinv here too


def statistic(pv, x, x_new, y):
    """Per-particle gradient of log p(y', x' | x) in the leaves' order of
    ``unpack``: (LRinv, LQinv, A, logit_pJ, LQJinv)."""
    a, lqinv, lrinv, lqjinv, logit_pj, _ = pv
    x0, x1 = x[0], x_new[0]
    d = x1 - a * x0
    v0 = 1.0 / (lqinv * lqinv)
    vj = 1.0 / (lqjinv * lqjinv)
    v1 = v0 + vj
    # log N(d; 0, v1) - log N(d; 0, v0), and the clipped sigmoids
    dlog = (-0.5 * d * d / v1 - 0.5 * torch.log(v1)
            + 0.5 * d * d / v0 + 0.5 * torch.log(v0))
    r1 = 1.0 / (1.0 + torch.exp(torch.clamp(-(logit_pj + dlog), -60.0, 60.0)))
    r0 = 1.0 - r1
    pj = 1.0 / (1.0 + torch.exp(torch.clamp(-logit_pj, -60.0, 60.0)))
    g_a = d * x0 * (r0 / v0 + r1 / v1)
    dn0 = 0.5 * d * d / (v0 * v0) - 0.5 / v0
    dn1 = 0.5 * d * d / (v1 * v1) - 0.5 / v1
    g_lq = (-2.0 * v0 / lqinv) * (r0 * dn0 + r1 * dn1)
    g_lqj = (-2.0 * vj / lqjinv) * r1 * dn1
    g_lr = 1.0 / lrinv - (y * y) * torch.exp(torch.clamp(-x1, -60.0, 60.0)) \
        * lrinv
    return [g_lr, g_lq, g_a, r1 - pj, g_lqj]


def unpack(stat):
    """Statistic ``[C, 5]`` as leaves."""
    C = stat.shape[0]
    return {"A": stat[:, 2].reshape(C, 1, 1), "LQinv_vec": stat[:, 1:2],
            "LRinv_vec": stat[:, 0:1], "logit_pJ": stat[:, 3:4],
            "LQJinv_vec": stat[:, 4:5]}


def grad_logprior(prior, p):
    """Score of the Wishart(df, scale) priors on Q^-1, R^-1 and QJ^-1 in
    their Cholesky factors, of A ~ N(mean_A, Q var_A) and of pJ ~ Beta(a,
    b) in logit_pJ.  The hyperparameters are tensors in the leaves'
    precision, so each quotient is a true division."""
    lq, lr, lqj = p["LQinv_vec"], p["LRinv_vec"], p["LQJinv_vec"]
    df, scale, mean_a, var_a, al, be = (
        torch.full((), prior[k], dtype=lq.dtype, device=lq.device)
        for k in ("df", "scale", "mean_A", "var_A", "alpha_pJ", "beta_pJ"))
    pj = torch.sigmoid(p["logit_pJ"])
    return {"A": -(lq * lq)[:, :, None] * (p["A"] - mean_a) / var_a,
            "LQinv_vec": (df - 2.0) / lq - lq / scale,
            "LRinv_vec": (df - 2.0) / lr - lr / scale,
            "logit_pJ": (al - 1.0) * (1.0 - pj) - (be - 1.0) * pj,
            "LQJinv_vec": (df - 2.0) / lqj - lqj / scale}


def project(p):
    return {"A": torch.clamp(p["A"], -A_MAX, A_MAX),
            "LQinv_vec": torch.abs(p["LQinv_vec"]),
            "LRinv_vec": torch.abs(p["LRinv_vec"]),
            "logit_pJ": torch.clamp(p["logit_pJ"], -LOGIT_MAX, LOGIT_MAX),
            "LQJinv_vec": torch.abs(p["LQJinv_vec"])}


def prior_hyper(cfg):
    """The configuration's prior: the SVM's Wishart df = 2 + 1 / var and
    scale 1 / df (for QJ^-1 too), A's prior mean 0 and column variance
    ``var``, pJ ~ Beta(2, 18)."""
    return dict(svm.prior_hyper(cfg), alpha_pJ=2.0, beta_pJ=18.0)


def simulate(truth, z):
    """The series ``y [T]`` (float64 numpy) of the true parameters from
    standard normals ``z [3, T + 1]``: x_0 from the stationary law, the
    jump at step t where ``z[2, t] < ndtri(pJ)``."""
    a, q, r, pj, qj = (truth[k] for k in ("A", "Q", "R", "pJ", "QJ"))
    T = z.shape[1] - 1
    thr = statistics.NormalDist().inv_cdf(pj)
    x = np.sqrt((q + pj * qj) / (1.0 - a * a)) * z[0, 0]
    ys = np.empty(T)
    for t in range(T):
        jump = float(z[2, t + 1] < thr)
        x = a * x + np.sqrt(q + jump * qj) * z[0, t + 1]
        ys[t] = np.exp(0.5 * x) * np.sqrt(r) * z[1, t + 1]
    return ys
