"""Stochastic-volatility jump model (SVJM), chain-batched PyTorch port.

x_t = A x_{t-1} + N(0, Q) + J_t * N(0, QJ),   J_t ~ Bernoulli(pJ),
y_t ~ N(0, exp(x_t) * R)

Counterpart of the parts of ``sgmcmc_tpu/models/svjm.py`` that
buffered-PF SGLD runs: parameters in the same coordinates (A, the packed
Cholesky precisions LQinv_vec / LRinv_vec / LQJinv_vec and logit_pJ) with
a leading chain axis, the two-component transition mixture, the bootstrap
kernel with its mixture transition density, the Fisher-identity
statistic, the prior and its gradient, the projection, data generation,
and the fused-window body (plain PyTorch here, CUDA in
``csrc/svjm_body.cuh``).  The EP / EP-avg proposals and the predict
surface are not ported yet.

The bootstrap kernel draws its jump from a second standard normal,
``J = z_2 < ndtri(pJ)``, the fused body's rule, where the JAX package's
unfused kernel draws ``uniform < pJ``; the two agree in law, and on
``z_2 = ndtri(u)`` draw for draw (except on an exact tie).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.cuda.fused_pf import FusedModel
from ..utils.distributions import (beta_logpdf, matrix_normal_logpdf,
                                   sample_beta, sample_wishart,
                                   wishart_logpdf)
from ..utils.linalg import tril_vector_to_mat
from .base import ParticleKernel, params_map

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


def get_kernel(name: str | None = None) -> ParticleKernel:
    if name in (None, "prior"):
        return KERNEL
    if name in ("ep", "ep_avg"):
        raise NotImplementedError(
            f"SVJM kernel '{name}' (the Gauss-Hermite EP proposal) is not "
            "ported yet (ROADMAP.md, Queue 1 item 10); the port runs the "
            "bootstrap kernel 'prior'")
    raise ValueError(f"Unrecognized SVJM kernel '{name}'")


# --------------------------------------------------------------------------
# Additive statistic (Fisher-identity score)
# --------------------------------------------------------------------------

# [grad_LRinv, grad_LQinv, grad_A, grad_logit_pJ, grad_LQJinv]
STATISTIC_DIM = 5


def grad_statistic(params: SVJMParams, x_t, x_next, y_next, t):
    """Per-particle gradient of log Pr(y', x' | x, theta), [C, N, 5]: the
    transition score is the responsibility-weighted mixture of the two
    branch scores."""
    x0 = x_t[..., 0]
    x1 = x_next[..., 0]
    d = x1 - _col(params.a) * x0
    Q, QJ = _col(params.Q), _col(params.QJ)
    v0 = Q
    v1 = Q + QJ
    r1 = _jump_responsibility(params, d)
    r0 = 1.0 - r1
    lqinv, lqjinv = _col(params.lqinv), _col(params.lqjinv)
    grad_A = d * x0 * (r0 / v0 + r1 / v1)
    dlogN0_dv = 0.5 * d * d / (v0 * v0) - 0.5 / v0
    dlogN1_dv = 0.5 * d * d / (v1 * v1) - 0.5 / v1
    grad_LQinv = (-2.0 * Q / lqinv) * (r0 * dlogN0_dv + r1 * dlogN1_dv)
    grad_LQJinv = (-2.0 * QJ / lqjinv) * r1 * dlogN1_dv
    grad_logit_pJ = r1 - _col(params.pJ)
    y = y_next[:, 0:1]
    diff_y2 = (y * y) * torch.exp(torch.clamp(-x1, -60.0, 60.0))
    lrinv = _col(params.lrinv)
    grad_LRinv = 1.0 / lrinv - diff_y2 * lrinv
    return torch.stack([grad_LRinv, grad_LQinv, grad_A, grad_logit_pJ,
                        grad_LQJinv], -1)


def unpack_grad(stat: torch.Tensor) -> SVJMParams:
    """Score vectors [C, 5] -> gradient parameters."""
    C = stat.shape[0]
    return SVJMParams(A=stat[:, 2].reshape(C, 1, 1), LQinv_vec=stat[:, 1:2],
                      LRinv_vec=stat[:, 0:1], logit_pJ=stat[:, 3:4],
                      LQJinv_vec=stat[:, 4:5])


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
