"""Plain reference of GARCH(1,1) with observation noise.

sigma2_t = alpha + beta x_{t-1}^2 + gamma sigma2_{t-1},
x_t ~ N(0, sigma2_t),   y_t = x_t + N(0, R)

Parameters in the unconstrained coordinates the port's sampler holds, each
``[C, 1]``: ``log_mu``, ``logit_phi``, ``logit_lambduh``, ``LRinv_vec``
with ``alpha = mu (1 - phi)``, ``beta = phi lambduh``, ``gamma = phi (1 -
lambduh)``, ``R = LRinv^-2`` (Aicher et al. 2019, arXiv:1901.10568,
section 5.3).  The state is (x, sigma2); the locally optimal kernel draws
x' from p(x' | x, y') and weighs by p(y' | x) = N(y'; 0, sigma2' + R).  The
prior: InvGamma on mu, Beta at (1 + phi) / 2 and (1 + lambduh) / 2,
Wishart on R^-1; the projection reflects LRinv.
"""
from __future__ import annotations

import math

import numpy as np
import torch

LEAVES = ("log_mu", "logit_phi", "logit_lambduh", "LRinv_vec")
SHAPES = {k: (1,) for k in LEAVES}
STATE_DIM, NOISE_DIM, STAT_DIM = 2, 1, 4
LOG_2PI = math.log(2.0 * math.pi)


def from_natural(alpha, beta, gamma, R):
    """Leaves ``[C, 1]`` from natural (alpha, beta, gamma, R) tensors
    ``[C]`` (computed in the tensors' dtype)."""
    phi = beta + gamma
    mu = alpha / (1.0 - phi)
    lam = beta / phi
    return {"log_mu": torch.log(mu)[:, None],
            "logit_phi": torch.log(phi / (1.0 - phi))[:, None],
            "logit_lambduh": torch.log(lam / (1.0 - lam))[:, None],
            "LRinv_vec": (R ** -0.5)[:, None]}


def columns(p):
    """[mu, phi, lambduh, lrinv], each ``[C, 1]``."""
    return [torch.exp(p["log_mu"]), torch.sigmoid(p["logit_phi"]),
            torch.sigmoid(p["logit_lambduh"]), p["LRinv_vec"]]


def prior_moments(p):
    """x's initial prior: mean 0, the stationary variance
    alpha / (1 - beta - gamma)."""
    mu, phi, lam, _ = columns(p)
    var = (mu * (1.0 - phi)) / (1.0 - phi * lam - phi * (1.0 - lam))
    return torch.zeros_like(var), var


def init(z, mean, var):
    return [mean + torch.sqrt(var) * z[0], torch.zeros_like(z[0])]


def _sigma2(pv, x):
    mu, phi, lam, _ = pv
    return (mu * (1.0 - phi) + (phi * lam) * (x[0] * x[0])
            + (phi * (1.0 - lam)) * x[1])


def propose(pv, z, x, y):
    rinv = pv[3] * pv[3]
    s2 = _sigma2(pv, x)
    var = 1.0 / (rinv + 1.0 / s2)
    return [var * (y * rinv) + torch.sqrt(var) * z[0], s2]


def reweight(pv, x, x_new, y):
    var = x_new[1] + 1.0 / (pv[3] * pv[3])
    return -0.5 * LOG_2PI - 0.5 * (y * y) / var - 0.5 * torch.log(var)


def statistic(pv, x, x_new, y):
    """Chain-rule gradient of log p(y', x' | x) in the order (LRinv,
    log_mu, logit_phi, logit_lambduh)."""
    mu, phi, lam, lrinv = pv
    v, x1, x0, s0 = x_new[1], x_new[0], x[0], x[1]
    g_v = -0.5 * (v - x1 * x1) / (v * v)
    g_mu = g_v * (1.0 - phi) * mu
    g_phi = g_v * (-mu + lam * (x0 * x0) + (1.0 - lam) * s0) \
        * (1.0 - phi) * phi
    g_lam = g_v * phi * (x0 * x0 - s0) * (1.0 - lam) * lam
    d = y - x1
    return [1.0 / lrinv - d * d * lrinv, g_mu, g_phi, g_lam]


def unpack(stat):
    return {"log_mu": stat[:, 1:2], "logit_phi": stat[:, 2:3],
            "logit_lambduh": stat[:, 3:4], "LRinv_vec": stat[:, 0:1]}


def grad_logprior(prior, p):
    """The prior's score in the unconstrained coordinates; the
    hyperparameters are tensors in the leaves' precision, so each quotient
    is a true division."""
    mu, phi, lam, lrinv = columns(p)
    shape, scale_mu, a, b, df, scale = (
        torch.full((), prior[k], dtype=mu.dtype, device=mu.device)
        for k in ("shape_mu", "scale_mu", "alpha_phi", "beta_phi", "df",
                  "scale"))

    def beta_score(v):
        return ((a - 1.0) / (1.0 + v) - (b - 1.0) / (1.0 - v)) * v * (1.0 - v)
    return {"log_mu": -shape - 1.0 + scale_mu / mu,
            "logit_phi": beta_score(phi), "logit_lambduh": beta_score(lam),
            "LRinv_vec": (df - 2.0) / lrinv - lrinv / scale}


def project(p):
    return dict(p, LRinv_vec=torch.abs(p["LRinv_vec"]))


def prior_hyper(cfg):
    """The configuration's prior (var capped at 1): mu ~ InvGamma(var + 3,
    var + 2), phi and lambduh Beta(1 + 19 / var, (1 + 19 / var) / 9) at
    (1 + .) / 2, R^-1 ~ Wishart(2 + 1 / var, 1 / df)."""
    var = min(float(cfg["prior"]["var"]), 1.0)
    a = 1.0 + 19.0 / var
    df = 2.0 + 1.0 / var
    return {"scale_mu": var + 2.0, "shape_mu": var + 3.0, "alpha_phi": a,
            "beta_phi": a / 9.0, "df": df, "scale": 1.0 / df}


def simulate(truth, z):
    """The series ``y [T]`` (float64 numpy) of the true parameters from
    standard normals ``z [2, T + 1]``: sigma2_0 the stationary variance."""
    al, be, ga, r = (truth[k] for k in ("alpha", "beta", "gamma", "R"))
    T = z.shape[1] - 1
    s2 = al / (1.0 - be - ga)
    x = np.sqrt(s2) * z[0, 0]
    ys = np.empty(T)
    for t in range(T):
        s2 = al + be * x * x + ga * s2
        x = np.sqrt(s2) * z[0, t + 1]
        ys[t] = x + np.sqrt(r) * z[1, t + 1]
    return ys
