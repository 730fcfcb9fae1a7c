"""Stochastic-volatility jump model (SVJM), chain-batched PyTorch port.

x_t = A x_{t-1} + N(0, Q) + J_t * N(0, QJ),   J_t ~ Bernoulli(pJ),
y_t ~ N(0, exp(x_t) * R)

Counterpart of the parts of ``sgmcmc_tpu/models/svjm.py`` that
buffered-PF SGLD runs: parameters in the same coordinates (A, the packed
Cholesky precisions LQinv_vec / LRinv_vec / LQJinv_vec and logit_pJ) with
a leading chain axis, the two-component transition mixture, the bootstrap
kernel with its mixture transition density, the Fisher-identity
statistic, the prior and its gradient, the projection, data generation,
the fused-window body (plain PyTorch here, CUDA in
``csrc/svjm_body.cuh``), the EP and EP-avg proposals (unfused: no fused
bundle) and the predict surface.

Every kernel draws its jump from a second standard normal: the bootstrap
kernel ``J = z_2 < ndtri(pJ)`` (the fused body's rule), the EP kernels
``J = z_2 < ndtri(x_pJ)`` with their fitted jump probability, where the
JAX package draws ``uniform < p``; the two agree in law, and on ``z_2 =
ndtri(u)`` draw for draw (except on an exact tie).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.fused_pf import FusedModel
from ..utils.distributions import (beta_logpdf, matrix_normal_logpdf,
                                   sample_beta, sample_wishart,
                                   wishart_logpdf)
from ..utils.linalg import tril_vector_to_mat
from .base import ParticleKernel, horizon_mask, params_map
from .svm import gauss_hermite

_LOG_2PI = 1.8378770664093453
# the clip of pJ before its jump threshold ndtri(pJ) in the fused body
_PJ_CLIP = 1e-6


@dataclasses.dataclass
class SVJMParams:
    """SVJM parameters of C chains (JAX package coordinates)."""
    A: torch.Tensor            # [C, 1, 1] AR coefficient
    LQinv_vec: torch.Tensor    # [C, 1] chol(Q^-1)
    LRinv_vec: torch.Tensor    # [C, 1] chol(R^-1)
    logit_pJ: torch.Tensor     # [C, 1] jump probability, logit space
    LQJinv_vec: torch.Tensor   # [C, 1] chol(QJ^-1)

    @property
    def num_chains(self) -> int:
        return self.A.shape[0]

    @property
    def a(self):
        return self.A[:, 0, 0]

    @property
    def lqinv(self):
        return self.LQinv_vec[:, 0]

    @property
    def lrinv(self):
        return self.LRinv_vec[:, 0]

    @property
    def lqjinv(self):
        return self.LQJinv_vec[:, 0]

    @property
    def Q(self):
        return 1.0 / (self.lqinv * self.lqinv)

    @property
    def R(self):
        return 1.0 / (self.lrinv * self.lrinv)

    @property
    def QJ(self):
        return 1.0 / (self.lqjinv * self.lqjinv)

    @property
    def pJ(self):
        return torch.sigmoid(self.logit_pJ[:, 0])

    # the natural coordinates of the experiments' metrics and KSD [C]
    # (abs, not torch.abs: parameters with numpy leaves have them too)
    @property
    def phi(self):
        return self.a

    @property
    def sigma(self):
        return 1.0 / abs(self.lqinv)

    @property
    def tau(self):
        return 1.0 / abs(self.lrinv)

    @property
    def sigmaJ(self):
        return 1.0 / abs(self.lqjinv)

    def to(self, device) -> "SVJMParams":
        return params_map(lambda x: x.to(device), self)


def from_scalars(A: float, Q: float, R: float, pJ: float = 0.05,
                 QJ: float = 1.0, dtype=torch.float32,
                 device=None) -> SVJMParams:
    """One chain's parameters from natural (A, Q, R, pJ, QJ) scalars."""
    pJ = min(max(float(pJ), 1e-6), 1.0 - 1e-6)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)
    return SVJMParams(A=full((1, 1, 1), A),
                      LQinv_vec=full((1, 1), Q ** -0.5),
                      LRinv_vec=full((1, 1), R ** -0.5),
                      logit_pJ=full((1, 1), float(np.log(pJ / (1.0 - pJ)))),
                      LQJinv_vec=full((1, 1), QJ ** -0.5))


def params_from_jax(p, dtype=torch.float32) -> SVJMParams:
    """Port parameters from a JAX ``SVJMParams`` with numpy (or array)
    leaves, single-chain or stacked over a leading chain axis."""
    def conv(x, shape):
        return torch.as_tensor(np.array(x, dtype=np.float64),
                               dtype=dtype).reshape(shape)
    return SVJMParams(A=conv(p.A, (-1, 1, 1)),
                      LQinv_vec=conv(p.LQinv_vec, (-1, 1)),
                      LRinv_vec=conv(p.LRinv_vec, (-1, 1)),
                      logit_pJ=conv(p.logit_pJ, (-1, 1)),
                      LQJinv_vec=conv(p.LQJinv_vec, (-1, 1)))


def stationary_variance(params: SVJMParams) -> torch.Tensor:
    """Stationary variance (Q + pJ QJ) / (1 - A^2) [C], capped like the
    SVM's."""
    v = (params.Q + params.pJ * params.QJ) / (1.0 - params.a ** 2)
    return torch.clamp(v, max=1e3)


def _col(v):
    return v[:, None]


# --------------------------------------------------------------------------
# Transition mixture density
# --------------------------------------------------------------------------

def _mixture_logpdf(params: SVJMParams, diff):
    """log[(1-pJ) N(d; 0, Q) + pJ N(d; 0, Q+QJ)] over d [C, M]."""
    v0 = _col(params.Q)
    v1 = _col(params.Q + params.QJ)
    lp0 = -0.5 * diff * diff / v0 - 0.5 * (_LOG_2PI + torch.log(v0))
    lp1 = -0.5 * diff * diff / v1 - 0.5 * (_LOG_2PI + torch.log(v1))
    logit = params.logit_pJ
    return torch.logaddexp(F.logsigmoid(-logit) + lp0,
                           F.logsigmoid(logit) + lp1)


def _jump_responsibility(params: SVJMParams, diff):
    """Posterior P(J=1 | x, x') = sigmoid(logit_pJ + logN1 - logN0)."""
    v0 = _col(params.Q)
    v1 = _col(params.Q + params.QJ)
    lp0 = -0.5 * diff * diff / v0 - 0.5 * torch.log(v0)
    lp1 = -0.5 * diff * diff / v1 - 0.5 * torch.log(v1)
    return torch.sigmoid(params.logit_pJ + lp1 - lp0)


# --------------------------------------------------------------------------
# Particle kernel (bootstrap): two normals per particle and step
# --------------------------------------------------------------------------

def _sample_x0(params: SVJMParams, z, prior_mean, prior_var):
    return (prior_mean[:, None, None]
            + torch.sqrt(prior_var)[:, None, None] * z[..., :1])


def _propose(params: SVJMParams, z, x_t, y_next):
    """x' = A x + sqrt(Q + J QJ) z_1 with the jump J = z_2 < ndtri(pJ)."""
    thr = torch.special.ndtri(params.pJ)[:, None, None]
    jump = (z[..., 1:2] < thr).to(x_t.dtype)
    sd = torch.sqrt(params.Q[:, None, None] + jump * params.QJ[:, None, None])
    return params.a[:, None, None] * x_t + sd * z[..., 0:1]


def _reweight(params: SVJMParams, x_t, x_next, y_next):
    """Emission log N(y; 0, exp(x) R) [C, N], the SVM's, with the same
    float32 exp clip."""
    x = x_next[..., 0]
    y = y_next[:, 0:1]
    lrinv = _col(params.lrinv)
    return (-0.5 * _LOG_2PI
            - 0.5 * (y * y) * torch.exp(torch.clamp(-x, -60.0, 60.0))
            * (lrinv * lrinv)
            + torch.log(torch.abs(lrinv))
            - 0.5 * x)


def _prior_log_density(params: SVJMParams, x_t, x_next):
    """log q(x_next | x_t) [C, M] for x_t, x_next [C, M, 1]."""
    return _mixture_logpdf(params,
                           x_next[..., 0] - _col(params.a) * x_t[..., 0])


def _prior_log_density_max(params: SVJMParams):
    """Both mixture branches peak at d = 0: [C]."""
    return _mixture_logpdf(params, torch.zeros_like(params.logit_pJ))[:, 0]


KERNEL = ParticleKernel(sample_x0=_sample_x0, propose=_propose,
                        reweight=_reweight,
                        prior_log_density=_prior_log_density,
                        prior_log_density_max=_prior_log_density_max,
                        state_dim=1, noise_dim=2)


# --------------------------------------------------------------------------
# EP proposals: Gauss-Hermite fits of the two transition branches tilted by
# the emission, and the two-component mixture proposal with the fitted jump
# probability x_pJ.  EP fits every particle; EP-avg fits each chain once,
# to the particle ensemble's predictive N(mean(x) A, var(x) A^2 + Q [+ QJ]).
# Two normals per particle and step: the position and the jump.
# --------------------------------------------------------------------------

def _ep_branch_moments(mean, var, scaled_y2):
    """GH moments of N(x'; mean, var) exp(-0.5 scaled_y2 e^{-x'} - x'/2)
    for ``mean [C, M]``, ``var`` and ``scaled_y2 [C, 1]``: (log Z,
    posterior mean, posterior variance), each [C, M]."""
    nodes, weights = gauss_hermite(mean.dtype, mean.device)
    xs = mean[..., None] + torch.sqrt(var)[..., None] * nodes   # [C, M, G]
    log_tilt = (-0.5 * scaled_y2[..., None]
                * torch.exp(torch.clamp(-xs, -60.0, 60.0))
                - 0.5 * xs - 0.5 * _LOG_2PI)
    lw = torch.log(weights) + log_tilt
    m = lw.amax(-1, keepdim=True)
    w = torch.exp(lw - m)
    z = w.sum(-1)
    logz = torch.log(z) + m[..., 0] - 0.5 * math.log(2 * math.pi)
    m1 = (w * xs).sum(-1) / z
    m2 = (w * xs * xs).sum(-1) / z
    return logz, m1, torch.clamp(m2 - m1 * m1, min=1e-8)


def _ep_from(params: SVJMParams, mean, base_var, y_next):
    """The two branch fits at ``mean [C, M]`` and ``base_var [C, 1]`` and
    the posterior jump probability x_pJ."""
    scaled_y2 = (y_next[:, 0:1] * _col(params.lrinv)) ** 2
    logz1, m1j, v1j = _ep_branch_moments(mean, base_var + _col(params.QJ),
                                         scaled_y2)
    logz0, m10, v10 = _ep_branch_moments(mean, base_var, scaled_y2)
    x_pJ = torch.sigmoid(params.logit_pJ + logz1 - logz0)
    return dict(xJ_bar=m1j, xJ_var=v1j, x_bar=m10, x_var=v10, x_pJ=x_pJ)


def _ep_fit(params: SVJMParams, x_t, y_next):
    """Per-particle fit, each [C, N]."""
    return _ep_from(params, _col(params.a) * x_t[..., 0], _col(params.Q),
                    y_next)


def _ep_avg_fit(params: SVJMParams, x_t, y_next):
    """One fit per chain, each [C, 1], from the mean and the variance
    (ddof 0) of the chain's particles."""
    x = x_t[..., 0]
    a = _col(params.a)
    mean = x.mean(-1, keepdim=True) * a
    base_var = x.var(-1, correction=0, keepdim=True) * a ** 2 + _col(
        params.Q)
    return _ep_from(params, mean, base_var, y_next)


def _ep_mixture_logq(fit, x1):
    lq0 = (-0.5 * _LOG_2PI - 0.5 * torch.log(fit["x_var"])
           - 0.5 * (x1 - fit["x_bar"]) ** 2 / fit["x_var"])
    lq1 = (-0.5 * _LOG_2PI - 0.5 * torch.log(fit["xJ_var"])
           - 0.5 * (x1 - fit["xJ_bar"]) ** 2 / fit["xJ_var"])
    return torch.logaddexp(torch.log1p(-fit["x_pJ"]) + lq0,
                           torch.log(fit["x_pJ"]) + lq1)


def _ep_draw(fit, z):
    """The mixture proposal [C, N, 1] with the jump z_2 < ndtri(x_pJ)."""
    jump = (z[..., 1] < torch.special.ndtri(fit["x_pJ"])).to(z.dtype)
    mean = jump * fit["xJ_bar"] + (1.0 - jump) * fit["x_bar"]
    sd = torch.sqrt(jump * fit["xJ_var"] + (1.0 - jump) * fit["x_var"])
    return (mean + sd * z[..., 0])[..., None]


def _ep_weight(params: SVJMParams, fit, x_t, x_next, y_next):
    return (_prior_log_density(params, x_t, x_next)
            + _reweight(params, x_t, x_next, y_next)
            - _ep_mixture_logq(fit, x_next[..., 0]))


def _propose_ep(params: SVJMParams, z, x_t, y_next):
    return _ep_draw(_ep_fit(params, x_t, y_next), z)


def _reweight_ep(params: SVJMParams, x_t, x_next, y_next):
    return _ep_weight(params, _ep_fit(params, x_t, y_next), x_t, x_next,
                      y_next)


def _propose_ep_avg(params: SVJMParams, z, x_t, y_next):
    return _ep_draw(_ep_avg_fit(params, x_t, y_next), z)


def _reweight_ep_avg(params: SVJMParams, x_t, x_next, y_next):
    return _ep_weight(params, _ep_avg_fit(params, x_t, y_next), x_t, x_next,
                      y_next)


EP_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_ep, reweight=_reweight_ep,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1, noise_dim=2)

EP_AVG_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_ep_avg,
    reweight=_reweight_ep_avg, prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1, noise_dim=2)


def get_kernel(name: str | None = None) -> ParticleKernel:
    if name in (None, "prior"):
        return KERNEL
    if name == "ep":
        return EP_KERNEL
    if name == "ep_avg":
        return EP_AVG_KERNEL
    raise ValueError(f"Unrecognized SVJM kernel '{name}'")


# --------------------------------------------------------------------------
# Additive statistic (Fisher-identity score)
# --------------------------------------------------------------------------

# [grad_LRinv, grad_LQinv, grad_A, grad_logit_pJ, grad_LQJinv]
STATISTIC_DIM = 5


def grad_statistic(params: SVJMParams, x_t, x_next, y_next, t):
    """Per-particle gradient of log Pr(y', x' | x, theta), [C, N, 5]: the
    transition score is the responsibility-weighted mixture of the two
    branch scores.  Computed by the fused body's expression
    (``_fused_stat``: the responsibility and pJ as clipped sigmoids), so
    that the unfused smoother and the fused window give the same
    statistic bit for bit, as the SVM's and GARCH's do."""
    pv = [_col(params.a), _col(params.lqinv), _col(params.lrinv),
          _col(params.lqjinv), params.logit_pJ, None]
    return torch.stack(_fused_stat(pv, [x_t[..., 0]], [x_next[..., 0]],
                                   y_next[:, 0:1]), -1)


def unpack_grad(stat: torch.Tensor) -> SVJMParams:
    """Score vectors [C, 5] -> gradient parameters."""
    C = stat.shape[0]
    return SVJMParams(A=stat[:, 2].reshape(C, 1, 1), LQinv_vec=stat[:, 1:2],
                      LRinv_vec=stat[:, 0:1], logit_pJ=stat[:, 3:4],
                      LQJinv_vec=stat[:, 4:5])


SUFF_STATISTIC_DIM = 3  # [x', x'^2, x x']


def suff_statistic(params: SVJMParams, x_t, x_next, y_next, t):
    """Gaussian sufficient statistics (x', x'^2, x x') per particle, [C, N,
    3] (diagnostics and the particle filter's log-likelihood statistic)."""
    x0, x1 = x_t[..., 0], x_next[..., 0]
    return torch.stack([x1, x1 * x1, x0 * x1], -1)


# --------------------------------------------------------------------------
# Predict surface (the SVM's, with the jump-diffusion moment recursion
# Var[x_{t+1}] = A^2 Var[x_t] + Q + pJ QJ); statistics [C, T, H].
# --------------------------------------------------------------------------

def latent_moments(params: SVJMParams, stats):
    """Sufficient statistics [C, T, 3] -> latent (mean [C, T, 1], cov
    [C, T, 1, 1])."""
    x_mean = stats[..., 0]
    x_cov = stats[..., 1] - x_mean ** 2
    return x_mean[..., None], x_cov[..., None, None]


Y_STATISTIC_DIM = 1


def y_statistic(params: SVJMParams, x_t, x_next, y_next, t):
    """E[exp(x)] feature [C, N, 1]; the emission is the SVM's."""
    return torch.exp(torch.clamp(x_next[..., 0], -60.0, 60.0))[..., None]


def y_moments(params: SVJMParams, stats):
    """[C, T, 1] E[exp(x_t) | y] -> (0, R E[exp(x_t)])."""
    return (torch.zeros_like(stats[..., :1]),
            (params.R[:, None] * stats[..., 0])[..., None, None])


def make_predictive_stat_fn(observations, num_steps_ahead: int, normals,
                            valid_length=None):
    """k-step-ahead predictive log-likelihood statistic [C, N, K+1]; the
    arguments are those of :func:`~.svm.make_predictive_stat_fn`."""
    T = observations.shape[-2]

    def stat_fn(params, x_t, x_next, y_next, t):
        a, R = params.a[:, None, None], params.R[:, None, None]
        q_step = (params.Q + params.pJ * params.QJ)[:, None, None]
        x_mean = x_next                                    # [C, N, 1]
        x_var = torch.zeros_like(q_step)
        out = []
        for k in range(num_steps_ahead + 1):
            y_tk = observations[:, min(t + k, T - 1), 0][:, None, None]
            x_mc = x_mean + torch.sqrt(x_var) * normals[k]
            y_var = R * torch.exp(x_mc)
            ll = (-0.5 * y_tk ** 2 / y_var - 0.5 * _LOG_2PI
                  - 0.5 * torch.log(y_var)).mean(-1)
            out.append(horizon_mask(t + k, T, valid_length, ll.dtype) * ll)
            x_mean = a * x_mean
            x_var = q_step + a * a * x_var
        return torch.stack(out, -1)

    return stat_fn


# --------------------------------------------------------------------------
# Fused-window body (bootstrap proposal).  Same operation order as
# csrc/svjm_body.cuh (and as the JAX package's svjm._fused_*): built
# without FMA contraction, the kernel rounds exactly as these PyTorch
# operators do.  pv = [a, lqinv, lrinv, lqjinv, logit_pJ, ndtri(pJ)] as
# [C, 1] columns; ndtri(pJ) is computed here, on the host side of the
# kernel, so both compare the second normal with the same float.
# --------------------------------------------------------------------------

def _fused_pack(params: SVJMParams) -> torch.Tensor:
    pj = torch.clamp(params.pJ, _PJ_CLIP, 1.0 - _PJ_CLIP)
    return torch.stack([params.a, params.lqinv, params.lrinv, params.lqjinv,
                        params.logit_pJ[:, 0], torch.special.ndtri(pj)], -1)


def _fused_init(z, prior_mean, prior_var):
    return [prior_mean + torch.sqrt(prior_var) * z[0]]


def _fused_propose(pv, z, x, y_t):
    a, lqinv, _, lqjinv, _, ndtri_pj = pv
    jump = (z[1] < ndtri_pj).to(z[0].dtype)
    var = 1.0 / (lqinv * lqinv) + jump / (lqjinv * lqjinv)
    return [a * x[0] + torch.sqrt(var) * z[0]]


def _fused_reweight(pv, x, x_new, y_t):
    lrinv = pv[2]
    xn = x_new[0]
    e = torch.exp(torch.clamp(-xn, -60.0, 60.0))
    return (-0.5 * _LOG_2PI - 0.5 * (y_t * y_t) * e * (lrinv * lrinv)
            + torch.log(torch.abs(lrinv)) - 0.5 * xn)


def _fused_stat(pv, x, x_new, y_t):
    a, lqinv, lrinv, lqjinv, logit_pj, _ = pv
    x0, x1 = x[0], x_new[0]
    d = x1 - a * x0
    v0 = 1.0 / (lqinv * lqinv)
    vj = 1.0 / (lqjinv * lqjinv)
    v1 = v0 + vj
    # r1 = sigmoid(logit_pJ + logN1 - logN0), clipped
    dlog = (-0.5 * d * d / v1 - 0.5 * torch.log(v1)
            + 0.5 * d * d / v0 + 0.5 * torch.log(v0))
    r1 = 1.0 / (1.0 + torch.exp(torch.clamp(-(logit_pj + dlog), -60.0, 60.0)))
    r0 = 1.0 - r1
    pj = 1.0 / (1.0 + torch.exp(torch.clamp(-logit_pj, -60.0, 60.0)))
    grad_A = d * x0 * (r0 / v0 + r1 / v1)
    dlogN0_dv = 0.5 * d * d / (v0 * v0) - 0.5 / v0
    dlogN1_dv = 0.5 * d * d / (v1 * v1) - 0.5 / v1
    grad_LQinv = (-2.0 * v0 / lqinv) * (r0 * dlogN0_dv + r1 * dlogN1_dv)
    grad_LQJinv = (-2.0 * vj / lqjinv) * r1 * dlogN1_dv
    grad_logit_pJ = r1 - pj
    diff_y2 = (y_t * y_t) * torch.exp(torch.clamp(-x1, -60.0, 60.0))
    grad_LRinv = 1.0 / lrinv - diff_y2 * lrinv
    return [grad_LRinv, grad_LQinv, grad_A, grad_logit_pJ, grad_LQJinv]


FUSED = FusedModel(n_state=1, n_stat=STATISTIC_DIM, n_param=6,
                   pack_params=_fused_pack, propose=_fused_propose,
                   reweight=_fused_reweight, stat=_fused_stat, body="svjm",
                   n_noise=2, init=_fused_init)


def get_fused(name: str | None = None):
    """Fused bundle matching `get_kernel` (bootstrap only)."""
    return FUSED if name in (None, "prior") else None


# --------------------------------------------------------------------------
# Prior: Wishart on Qinv, Rinv and QJinv, matrix-normal on A, Beta on pJ
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SVJMPrior:
    mean_A: torch.Tensor        # (1, 1)
    var_col_A: torch.Tensor     # (1,)
    scale_Qinv: torch.Tensor    # (1, 1)
    df_Qinv: torch.Tensor       # ()
    scale_Rinv: torch.Tensor    # (1, 1)
    df_Rinv: torch.Tensor       # ()
    scale_QJinv: torch.Tensor   # (1, 1)
    df_QJinv: torch.Tensor      # ()
    alpha_pJ: torch.Tensor      # ()
    beta_pJ: torch.Tensor       # ()


def default_prior(var: float = 100.0, dtype=torch.float32,
                  device=None) -> SVJMPrior:
    """The JAX package's defaults: the SVM's for (A, Q, R), the Q prior
    for QJ, Beta(2, 18) on pJ."""
    df = 2.0 + 1.0 / var

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)
    return SVJMPrior(mean_A=full((1, 1), 0.0), var_col_A=full((1,), var),
                     scale_Qinv=full((1, 1), 1.0 / df), df_Qinv=full((), df),
                     scale_Rinv=full((1, 1), 1.0 / df), df_Rinv=full((), df),
                     scale_QJinv=full((1, 1), 1.0 / df),
                     df_QJinv=full((), df), alpha_pJ=full((), 2.0),
                     beta_pJ=full((), 18.0))


def logprior(prior: SVJMPrior, params: SVJMParams) -> torch.Tensor:
    """log prior density [C]."""
    LQinv = tril_vector_to_mat(params.LQinv_vec)
    LRinv = tril_vector_to_mat(params.LRinv_vec)
    LQJinv = tril_vector_to_mat(params.LQJinv_vec)
    lp = wishart_logpdf(LQinv @ LQinv.mT, prior.df_Qinv, prior.scale_Qinv)
    lp = lp + wishart_logpdf(LRinv @ LRinv.mT, prior.df_Rinv,
                             prior.scale_Rinv)
    lp = lp + wishart_logpdf(LQJinv @ LQJinv.mT, prior.df_QJinv,
                             prior.scale_QJinv)
    lp = lp + matrix_normal_logpdf(
        params.A, prior.mean_A, Lrowprec=LQinv,
        Lcolprec=torch.diag(prior.var_col_A ** -0.5))
    return lp + beta_logpdf(params.pJ, prior.alpha_pJ, prior.beta_pJ)


def grad_logprior(prior: SVJMPrior, params: SVJMParams) -> SVJMParams:
    """Analytic prior score: the SVM's (A, LQinv, LRinv) terms, the same
    Wishart term for LQJinv, and the Beta term chain-ruled into
    logit_pJ."""
    lqinv, lrinv, lqjinv = params.lqinv, params.lrinv, params.lqjinv
    g_lqinv = (prior.df_Qinv - 2.0) / lqinv - lqinv / prior.scale_Qinv[0, 0]
    g_lrinv = (prior.df_Rinv - 2.0) / lrinv - lrinv / prior.scale_Rinv[0, 0]
    g_lqjinv = ((prior.df_QJinv - 2.0) / lqjinv
                - lqjinv / prior.scale_QJinv[0, 0])
    g_A = (-(lqinv * lqinv)[:, None, None] * (params.A - prior.mean_A)
           / prior.var_col_A)
    pj = params.pJ
    g_logit_pJ = ((prior.alpha_pJ - 1.0) * (1.0 - pj)
                  - (prior.beta_pJ - 1.0) * pj)
    return SVJMParams(A=g_A, LQinv_vec=_col(g_lqinv),
                      LRinv_vec=_col(g_lrinv), logit_pJ=_col(g_logit_pJ),
                      LQJinv_vec=_col(g_lqjinv))


def sample_prior(prior: SVJMPrior, generator: torch.Generator,
                 num_chains: int = 1) -> SVJMParams:
    """``num_chains`` independent prior draws."""
    C = num_chains
    Qinv = sample_wishart(generator, prior.df_Qinv, prior.scale_Qinv, (C,))
    Rinv = sample_wishart(generator, prior.df_Rinv, prior.scale_Rinv, (C,))
    QJinv = sample_wishart(generator, prior.df_QJinv, prior.scale_QJinv,
                           (C,))
    lqinv = torch.sqrt(Qinv[:, 0, 0])
    pj = sample_beta(generator, prior.alpha_pJ, prior.beta_pJ, (C,),
                     lqinv.dtype, lqinv.device)
    a_sd = torch.sqrt(prior.var_col_A[0]) / lqinv
    z = torch.randn((C, 1, 1), generator=generator, dtype=lqinv.dtype,
                    device=lqinv.device)
    return SVJMParams(
        A=prior.mean_A + a_sd[:, None, None] * z, LQinv_vec=_col(lqinv),
        LRinv_vec=_col(torch.sqrt(Rinv[:, 0, 0])),
        logit_pJ=_col(torch.logit(torch.clamp(pj, 1e-6, 1.0 - 1e-6))),
        LQJinv_vec=_col(torch.sqrt(QJinv[:, 0, 0])))


def project_parameters(params: SVJMParams,
                       a_threshold: float = 0.9999) -> SVJMParams:
    """|A| <= threshold, reflected Cholesky diagonals, |logit_pJ| <= 13."""
    return SVJMParams(A=torch.clamp(params.A, -a_threshold, a_threshold),
                      LQinv_vec=torch.abs(params.LQinv_vec),
                      LRinv_vec=torch.abs(params.LRinv_vec),
                      logit_pJ=torch.clamp(params.logit_pJ, -13.0, 13.0),
                      LQJinv_vec=torch.abs(params.LQJinv_vec))


def generate_data(generator: torch.Generator, params: SVJMParams, T: int):
    """Simulate (observations [T, 1], latent [T, 1]) from chain 0 of
    ``params`` on the generator's device."""
    p = params_map(lambda x: x[:1], params)
    dt, dev = p.A.dtype, p.A.device
    x = torch.sqrt(stationary_variance(p)) * torch.randn(
        (1,), generator=generator, dtype=dt, device=dev)
    zx = torch.randn((T,), generator=generator, dtype=dt, device=dev)
    zy = torch.randn((T,), generator=generator, dtype=dt, device=dev)
    jumps = (torch.rand((T,), generator=generator, dtype=dt, device=dev)
             < p.pJ).to(dt)
    sd = torch.sqrt(p.Q + jumps * p.QJ)
    xs = []
    for t in range(T):
        x = p.a * x + sd[t] * zx[t]
        xs.append(x)
    xs = torch.cat(xs)
    ys = torch.exp(0.5 * xs) * torch.sqrt(p.R) * zy
    return ys[:, None], xs[:, None]
