"""Stochastic-volatility model (SVM), chain-batched PyTorch port.

x_t = A x_{t-1} + N(0, Q),   y_t ~ N(0, exp(x_t) * R)

Counterpart of the parts of ``sgmcmc_tpu/models/svm.py`` that buffered-PF
SGLD runs: parameters in the same coordinates (A, packed Cholesky of the
precisions LQinv_vec / LRinv_vec) with a leading chain axis, the bootstrap
kernel with its transition density, the Fisher-identity statistic, the
prior and its partial-prior gradient, the projection, the fused-window
body (plain PyTorch here, CUDA in ``csrc/svm_body.cuh``), the adaptive
Laplace and EP proposals (unfused: no fused bundle) and the predict
surface: the latent and observation moment maps and the k-step predictive
statistic.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.cuda.fused_pf import FusedModel
from ..utils.distributions import (matrix_normal_logpdf, sample_wishart,
                                   wishart_logpdf)
from ..utils.linalg import tril_vector_to_mat
from .base import ParticleKernel, horizon_mask, params_map

_LOG_2PI = 1.8378770664093453


@dataclasses.dataclass
class SVMParams:
    """SVM parameters of C chains (JAX package coordinates)."""
    A: torch.Tensor            # [C, 1, 1] AR coefficient
    LQinv_vec: torch.Tensor    # [C, 1] chol(Q^-1)
    LRinv_vec: torch.Tensor    # [C, 1] chol(R^-1)

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
    def qinv(self):
        return self.lqinv ** 2

    @property
    def rinv(self):
        return self.lrinv ** 2

    @property
    def Q(self):
        return 1.0 / self.qinv

    @property
    def R(self):
        return 1.0 / self.rinv

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

    def to(self, device) -> "SVMParams":
        return params_map(lambda x: x.to(device), self)


def from_scalars(A: float, Q: float, R: float, dtype=torch.float32,
                 device=None) -> SVMParams:
    """One chain's parameters from natural (A, Q, R) scalars."""
    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)
    return SVMParams(A=full((1, 1, 1), A),
                     LQinv_vec=full((1, 1), Q ** -0.5),
                     LRinv_vec=full((1, 1), R ** -0.5))


def params_from_jax(p) -> SVMParams:
    """Port parameters from a JAX ``SVMParams`` with numpy (or array)
    leaves, single-chain ``(1, 1) / (1,)`` or stacked ``(C, 1, 1) / (C, 1)``
    as the JAX package's ``from_scalars`` and ``fit_scan`` make them."""
    def conv(x, shape):
        return torch.as_tensor(np.array(x, dtype=np.float32)).reshape(shape)
    return SVMParams(A=conv(p.A, (-1, 1, 1)),
                     LQinv_vec=conv(p.LQinv_vec, (-1, 1)),
                     LRinv_vec=conv(p.LRinv_vec, (-1, 1)))


def params_to_numpy(p: SVMParams) -> dict:
    """Leaves as numpy arrays with the chain axis, keyed by the JAX field
    names (``SVMParams(**{k: v[c]})`` rebuilds chain c on the JAX side)."""
    return {f.name: getattr(p, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(p)}


def stationary_variance(params: SVMParams) -> torch.Tensor:
    """Stationary variance Q / (1 - A^2) of the latent AR(1) [C], capped so
    the PF initialization stays inside float32's exp range when the
    projection pins |A| at its boundary."""
    return torch.clamp(params.Q / (1.0 - params.a ** 2), max=1e3)


# --------------------------------------------------------------------------
# Particle kernel (bootstrap / prior)
# --------------------------------------------------------------------------

def _sample_x0(params: SVMParams, z, prior_mean, prior_var):
    return prior_mean[:, None, None] + torch.sqrt(prior_var)[:, None, None] * z


def _propose(params: SVMParams, z, x_t, y_next):
    return params.a[:, None, None] * x_t + z / params.lqinv[:, None, None]


def _reweight(params: SVMParams, x_t, x_next, y_next):
    """log Pr(y_{t+1} | x_{t+1}) [C, N]; the exponent is clipped to
    float32's safe range, as in the JAX package."""
    x = x_next[..., 0]
    y2 = y_next[:, 0:1] ** 2
    return (-0.5 * _LOG_2PI
            - 0.5 * y2 * torch.exp(torch.clamp(-x, -60.0, 60.0))
            * params.rinv[:, None]
            + torch.log(torch.abs(params.lrinv))[:, None]
            - 0.5 * x)


def _prior_log_density(params: SVMParams, x_t, x_next):
    """log q(x_next | x_t) [C, M] for x_t, x_next [C, M, 1]."""
    diff = x_next[..., 0] - params.a[:, None] * x_t[..., 0]
    return (-0.5 * diff * diff * params.qinv[:, None]
            - 0.5 * _LOG_2PI + torch.log(torch.abs(params.lqinv))[:, None])


def _prior_log_density_max(params: SVMParams):
    return -0.5 * _LOG_2PI + torch.log(torch.abs(params.lqinv))


KERNEL = ParticleKernel(sample_x0=_sample_x0, propose=_propose,
                        reweight=_reweight,
                        prior_log_density=_prior_log_density,
                        prior_log_density_max=_prior_log_density_max,
                        state_dim=1, noise_dim=1)


# --------------------------------------------------------------------------
# Adaptive proposals.  Laplace: the mode of log p(x' | x, y') by a fixed
# 10-iteration Newton solve (no early exit) and its curvature; EP: the
# moments of p(x' | x, y') by 32-point Gauss-Hermite quadrature.  One
# normal per particle and step, as the bootstrap kernel.
# --------------------------------------------------------------------------

_NEWTON_ITERS = 10
_GH_POINTS = 32


@functools.lru_cache(maxsize=None)
def gauss_hermite(dtype, device):
    """The probabilists' Gauss-Hermite nodes and weights (numpy's
    ``hermegauss(32)``) as tensors, made once per dtype and device."""
    nodes, weights = np.polynomial.hermite_e.hermegauss(_GH_POINTS)
    return (torch.as_tensor(nodes, dtype=dtype, device=device),
            torch.as_tensor(weights, dtype=dtype, device=device))


def _laplace_mode(params: SVMParams, x_t, y_next):
    """Mode [C, N] and proposal variance of x' -> log p(x'|x) +
    log p(y'|x')."""
    qinv, rinv = params.qinv[:, None], params.rinv[:, None]
    mean = params.a[:, None] * x_t[..., 0]
    y2r = (y_next[:, 0:1] ** 2) * rinv
    mode = mean
    for _ in range(_NEWTON_ITERS):
        g = -(mode - mean) * qinv + 0.5 * y2r * torch.exp(-mode) - 0.5
        h = -qinv - 0.5 * y2r * torch.exp(-mode)
        mode = mode - g / h
    h = -qinv - 0.5 * y2r * torch.exp(-mode)
    return mode, -1.0 / h


def _gaussian_log_q(x1, mean, var):
    return -0.5 * _LOG_2PI - 0.5 * torch.log(var) - 0.5 * (x1 - mean) ** 2 / var


def _propose_laplace(params: SVMParams, z, x_t, y_next):
    mode, var = _laplace_mode(params, x_t, y_next)
    return (mode + torch.sqrt(var) * z[..., 0])[..., None]


def _reweight_laplace(params: SVMParams, x_t, x_next, y_next):
    """w = p(x'|x) p(y'|x') / q(x'|x, y')."""
    mode, var = _laplace_mode(params, x_t, y_next)
    return (_prior_log_density(params, x_t, x_next)
            + _reweight(params, x_t, x_next, y_next)
            - _gaussian_log_q(x_next[..., 0], mode, var))


def _ep_moments(params: SVMParams, x_t, y_next):
    """Gauss-Hermite moment matching of p(x' | x, y'): (mean, variance)
    [C, N]."""
    nodes, gh_w = gauss_hermite(x_t.dtype, x_t.device)
    mean = params.a[:, None] * x_t[..., 0]
    sd = torch.sqrt(params.Q)[:, None, None]
    xs = mean[..., None] + sd * nodes                      # [C, N, G]
    y2 = (y_next[:, 0:1] ** 2)[..., None]
    log_lik = (-0.5 * y2 * torch.exp(-xs) * params.rinv[:, None, None]
               - 0.5 * xs)
    w = gh_w * torch.exp(log_lik - log_lik.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True)
    m1 = (w * xs).sum(-1)
    m2 = (w * xs * xs).sum(-1)
    return m1, torch.clamp(m2 - m1 * m1, min=1e-8)


def _propose_ep(params: SVMParams, z, x_t, y_next):
    m1, var = _ep_moments(params, x_t, y_next)
    return (m1 + torch.sqrt(var) * z[..., 0])[..., None]


def _reweight_ep(params: SVMParams, x_t, x_next, y_next):
    m1, var = _ep_moments(params, x_t, y_next)
    return (_prior_log_density(params, x_t, x_next)
            + _reweight(params, x_t, x_next, y_next)
            - _gaussian_log_q(x_next[..., 0], m1, var))


LAPLACE_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_laplace,
    reweight=_reweight_laplace, prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1, noise_dim=1)

EP_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_ep, reweight=_reweight_ep,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1, noise_dim=1)


def get_kernel(name: str | None = None) -> ParticleKernel:
    if name in (None, "prior"):
        return KERNEL
    if name == "laplace":
        return LAPLACE_KERNEL
    if name == "ep":
        return EP_KERNEL
    raise ValueError(f"Unrecognized SVM kernel '{name}'")


# --------------------------------------------------------------------------
# Additive statistic (Fisher-identity score)
# --------------------------------------------------------------------------

STATISTIC_DIM = 3  # [grad_LRinv, grad_LQinv, grad_A]


def grad_statistic(params: SVMParams, x_t, x_next, y_next, t):
    """Per-particle gradient of log Pr(y', x' | x, theta), [C, N, 3]."""
    x0 = x_t[..., 0]
    x1 = x_next[..., 0]
    a = params.a[:, None]
    lqinv = params.lqinv[:, None]
    lrinv = params.lrinv[:, None]
    diff_x = x1 - a * x0
    grad_A = params.qinv[:, None] * diff_x * x0
    grad_LQinv = 1.0 / lqinv - diff_x * diff_x * lqinv
    diff_y2 = y_next[:, 0:1] ** 2 * torch.exp(torch.clamp(-x1, -60.0, 60.0))
    grad_LRinv = 1.0 / lrinv - diff_y2 * lrinv
    return torch.stack([grad_LRinv, grad_LQinv, grad_A], -1)


def unpack_grad(stat: torch.Tensor) -> SVMParams:
    """Score vectors [C, 3] -> gradient parameters."""
    C = stat.shape[0]
    return SVMParams(A=stat[:, 2].reshape(C, 1, 1),
                     LQinv_vec=stat[:, 1:2], LRinv_vec=stat[:, 0:1])


SUFF_STATISTIC_DIM = 3  # [x', x'^2, x x']


def suff_statistic(params: SVMParams, x_t, x_next, y_next, t):
    """Gaussian sufficient statistics (x', x'^2, x x') per particle, [C, N,
    3] (the particle filter's log-likelihood statistic)."""
    x0, x1 = x_t[..., 0], x_next[..., 0]
    return torch.stack([x1, x1 * x1, x0 * x1], -1)


# --------------------------------------------------------------------------
# Predict surface.  The moment maps take elementwise-averaged statistics
# [C, T, H] of C chains (or sequences) and return (mean [C, T, 1], cov
# [C, T, 1, 1]).
# --------------------------------------------------------------------------

def latent_moments(params: SVMParams, stats):
    """Sufficient statistics [C, T, 3] -> latent (mean, cov)."""
    x_mean = stats[..., 0]
    x_cov = stats[..., 1] - x_mean ** 2
    return x_mean[..., None], x_cov[..., None, None]


Y_STATISTIC_DIM = 1


def y_statistic(params: SVMParams, x_t, x_next, y_next, t):
    """E[exp(x)] feature [C, N, 1] for the observation moments under
    y ~ N(0, exp(x) R)."""
    return torch.exp(torch.clamp(x_next[..., 0], -60.0, 60.0))[..., None]


def y_moments(params: SVMParams, stats):
    """[C, T, 1] E[exp(x_t) | y] -> (y_mean 0 [C, T, 1], y_cov [C, T, 1, 1]
    = R E[exp(x_t)]) by the law of total variance."""
    return (torch.zeros_like(stats[..., :1]),
            (params.R[:, None] * stats[..., 0])[..., None, None])


def make_predictive_stat_fn(observations, num_steps_ahead: int, normals,
                            valid_length=None):
    """k-step-ahead predictive log-likelihood statistic [C, N, K+1]:
    propagate the latent AR(1) moments k steps, average over the latent by
    Monte Carlo and score y_{t+k} under N(0, exp(x) R).

    ``observations [C, T, m]`` are the rows the particle filter runs (one
    chain, or one padded sequence a row); ``normals [K+1, N, n_mc]`` are
    the Monte Carlo draws, the same at every t and in every row (the JAX
    package draws them from a fixed key); ``valid_length [C]`` masks the
    horizons past each row's end (default: the whole row)."""
    T = observations.shape[-2]

    def stat_fn(params, x_t, x_next, y_next, t):
        a = params.a[:, None, None]
        Q, R = params.Q[:, None, None], params.R[:, None, None]
        x_mean = x_next                                    # [C, N, 1]
        x_var = torch.zeros_like(Q)
        out = []
        for k in range(num_steps_ahead + 1):
            y_tk = observations[:, min(t + k, T - 1), 0][:, None, None]
            x_mc = x_mean + torch.sqrt(x_var) * normals[k]
            y_var = R * torch.exp(x_mc)
            ll = (-0.5 * y_tk ** 2 / y_var - 0.5 * _LOG_2PI
                  - 0.5 * torch.log(y_var)).mean(-1)
            out.append(horizon_mask(t + k, T, valid_length, ll.dtype) * ll)
            x_mean = a * x_mean
            x_var = Q + a * a * x_var
        return torch.stack(out, -1)

    return stat_fn


# --------------------------------------------------------------------------
# Fused-window body.  Same operation order as csrc/svm_body.cuh: built
# without FMA contraction, the kernel then rounds exactly as these
# PyTorch operators do.  pv = [a, lqinv, lrinv] as [C, 1] columns.
# --------------------------------------------------------------------------

def _fused_pack(params: SVMParams) -> torch.Tensor:
    return torch.stack([params.a, params.lqinv, params.lrinv], -1)


def _fused_propose(pv, z, x, y_t):
    a, lqinv, _ = pv
    return [a * x[0] + z[0] / lqinv]


def _fused_reweight(pv, x, x_new, y_t):
    _, _, lrinv = pv
    xn = x_new[0]
    e = torch.exp(torch.clamp(-xn, -60.0, 60.0))
    return (-0.5 * _LOG_2PI - 0.5 * (y_t * y_t) * e * (lrinv * lrinv)
            + torch.log(torch.abs(lrinv)) - 0.5 * xn)


def _fused_stat(pv, x, x_new, y_t):
    a, lqinv, lrinv = pv
    x0, x1 = x[0], x_new[0]
    diff_x = x1 - a * x0
    grad_A = (lqinv * lqinv) * diff_x * x0
    grad_LQinv = 1.0 / lqinv - diff_x * diff_x * lqinv
    diff_y2 = (y_t * y_t) * torch.exp(torch.clamp(-x1, -60.0, 60.0))
    grad_LRinv = 1.0 / lrinv - diff_y2 * lrinv
    return [grad_LRinv, grad_LQinv, grad_A]   # STATISTIC_DIM order


FUSED = FusedModel(n_state=1, n_stat=STATISTIC_DIM, n_param=3,
                   pack_params=_fused_pack, propose=_fused_propose,
                   reweight=_fused_reweight, stat=_fused_stat, body="svm")


def get_fused(name: str | None = None):
    """Fused bundle matching `get_kernel` (bootstrap / prior only)."""
    return FUSED if name in (None, "prior") else None


# --------------------------------------------------------------------------
# Prior (Wishart on Qinv / Rinv, matrix-normal on A)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SVMPrior:
    mean_A: torch.Tensor       # (1, 1)
    var_col_A: torch.Tensor    # (1,)
    scale_Qinv: torch.Tensor   # (1, 1)
    df_Qinv: torch.Tensor      # ()
    scale_Rinv: torch.Tensor   # (1, 1)
    df_Rinv: torch.Tensor      # ()


def default_prior(var: float = 100.0, dtype=torch.float32,
                  device=None) -> SVMPrior:
    """The JAX package's default hyperparameters."""
    df = 2.0 + 1.0 / var

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)
    return SVMPrior(mean_A=full((1, 1), 0.0), var_col_A=full((1,), var),
                    scale_Qinv=full((1, 1), 1.0 / df), df_Qinv=full((), df),
                    scale_Rinv=full((1, 1), 1.0 / df), df_Rinv=full((), df))


def logprior(prior: SVMPrior, params: SVMParams) -> torch.Tensor:
    """log prior density [C]."""
    LQinv = tril_vector_to_mat(params.LQinv_vec)
    LRinv = tril_vector_to_mat(params.LRinv_vec)
    Qinv = LQinv @ LQinv.transpose(-1, -2)
    Rinv = LRinv @ LRinv.transpose(-1, -2)
    lp = wishart_logpdf(Qinv, prior.df_Qinv, prior.scale_Qinv)
    lp = lp + wishart_logpdf(Rinv, prior.df_Rinv, prior.scale_Rinv)
    return lp + matrix_normal_logpdf(
        params.A, prior.mean_A, Lrowprec=LQinv,
        Lcolprec=torch.diag(prior.var_col_A ** -0.5))


def grad_logprior(prior: SVMPrior, params: SVMParams) -> SVMParams:
    """Analytic prior score, with the JAX package's (and reference's)
    partial-prior convention: the matrix-normal prior on A contributes no
    gradient to LQinv."""
    lqinv, lrinv = params.lqinv, params.lrinv
    n = 1
    grad_LQinv = ((prior.df_Qinv - n - 1) / lqinv
                  - lqinv / prior.scale_Qinv[0, 0])
    grad_LRinv = ((prior.df_Rinv - n - 1) / lrinv
                  - lrinv / prior.scale_Rinv[0, 0])
    grad_A = (-params.qinv[:, None, None] * (params.A - prior.mean_A)
              / prior.var_col_A)
    return SVMParams(A=grad_A, LQinv_vec=grad_LQinv[:, None],
                     LRinv_vec=grad_LRinv[:, None])


def sample_prior(prior: SVMPrior, generator: torch.Generator,
                 num_chains: int = 1) -> SVMParams:
    """``num_chains`` independent prior draws."""
    C = num_chains
    Qinv = sample_wishart(generator, prior.df_Qinv, prior.scale_Qinv, (C,))
    Rinv = sample_wishart(generator, prior.df_Rinv, prior.scale_Rinv, (C,))
    lqinv = torch.sqrt(Qinv[:, 0, 0])
    lrinv = torch.sqrt(Rinv[:, 0, 0])
    a_sd = torch.sqrt(prior.var_col_A[0]) / lqinv
    z = torch.randn((C, 1, 1), generator=generator, dtype=lqinv.dtype,
                    device=lqinv.device)
    return SVMParams(A=prior.mean_A + a_sd[:, None, None] * z,
                     LQinv_vec=lqinv[:, None], LRinv_vec=lrinv[:, None])


def project_parameters(params: SVMParams,
                       a_threshold: float = 0.9999) -> SVMParams:
    """|A| <= threshold; reflect negative Cholesky diagonals."""
    return SVMParams(A=torch.clamp(params.A, -a_threshold, a_threshold),
                     LQinv_vec=torch.abs(params.LQinv_vec),
                     LRinv_vec=torch.abs(params.LRinv_vec))


def generate_data(generator: torch.Generator, params: SVMParams, T: int):
    """Simulate (observations [T, 1], latent [T, 1]) from chain 0 of
    ``params`` on the generator's device."""
    p = params_map(lambda x: x[:1], params)
    dt, dev = p.A.dtype, p.A.device
    x = torch.sqrt(stationary_variance(p)) * torch.randn(
        (1,), generator=generator, dtype=dt, device=dev)
    zx = torch.randn((T,), generator=generator, dtype=dt, device=dev)
    zy = torch.randn((T,), generator=generator, dtype=dt, device=dev)
    sq_q, sq_r = torch.sqrt(p.Q), torch.sqrt(p.R)
    xs = []
    for t in range(T):
        x = p.a * x + sq_q * zx[t]
        xs.append(x)
    xs = torch.cat(xs)
    ys = torch.exp(0.5 * xs) * sq_r * zy
    return ys[:, None], xs[:, None]
