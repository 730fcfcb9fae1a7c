"""GARCH(1,1) with observation noise, chain-batched PyTorch port.

sigma2_t = alpha + beta x_{t-1}^2 + gamma sigma2_{t-1},
x_t ~ N(0, sigma2_t),   y_t = x_t + N(0, R)

Counterpart of the parts of ``sgmcmc_tpu/models/garch.py`` that
buffered-PF SGLD runs: parameters in the same unconstrained coordinates
(``log_mu``, ``logit_phi``, ``logit_lambduh``, ``LRinv_vec``, with
``alpha = mu (1-phi)``, ``beta = phi lambduh``, ``gamma = phi
(1-lambduh)``) and a leading chain axis, the prior and locally optimal
particle kernels over the 2-D state ``(x, sigma2)``, the chain-rule
statistic, the prior (with the JAX package's Beta densities at ``(1+phi)/2``)
and its gradient, the projection, data generation, and the fused-window
bodies (plain PyTorch here, CUDA in ``csrc/garch_body.cuh``).  The
sufficient statistic, the observation moments and the predictive
statistic belong to the predict surface, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops.cuda.fused_pf import FusedModel
from ..utils.distributions import (beta_logpdf, invgamma_logpdf, sample_beta,
                                   sample_invgamma, sample_wishart,
                                   wishart_logpdf)
from .base import ParticleKernel, params_map

_LOG_2PI = 1.8378770664093453


@dataclasses.dataclass
class GARCHParams:
    """GARCH parameters of C chains (JAX package coordinates)."""
    log_mu: torch.Tensor          # [C, 1]
    logit_phi: torch.Tensor       # [C, 1]
    logit_lambduh: torch.Tensor   # [C, 1]
    LRinv_vec: torch.Tensor       # [C, 1]

    @property
    def num_chains(self) -> int:
        return self.log_mu.shape[0]

    @property
    def mu(self):
        return torch.exp(self.log_mu[:, 0])

    @property
    def phi(self):
        return torch.sigmoid(self.logit_phi[:, 0])

    @property
    def lambduh(self):
        return torch.sigmoid(self.logit_lambduh[:, 0])

    @property
    def alpha(self):
        return self.mu * (1.0 - self.phi)

    @property
    def beta(self):
        return self.phi * self.lambduh

    @property
    def gamma(self):
        return self.phi * (1.0 - self.lambduh)

    @property
    def lrinv(self):
        return self.LRinv_vec[:, 0]

    @property
    def rinv(self):
        return self.lrinv * self.lrinv

    @property
    def R(self):
        return 1.0 / self.rinv

    @property
    def tau(self):
        return 1.0 / torch.abs(self.lrinv)

    def to(self, device) -> "GARCHParams":
        return params_map(lambda x: x.to(device), self)


def from_alpha_beta_gamma(alpha: float, beta: float, gamma: float, R: float,
                          dtype=torch.float32, device=None) -> GARCHParams:
    """One chain's parameters from natural (alpha, beta, gamma, R), in
    float64 on the host and then cast, as the JAX package does."""
    phi = beta + gamma
    mu = alpha / (1.0 - phi)
    lam = beta / phi

    def leaf(v):
        return torch.full((1, 1), v, dtype=dtype, device=device)
    return GARCHParams(log_mu=leaf(math.log(mu)),
                       logit_phi=leaf(math.log(phi / (1 - phi))),
                       logit_lambduh=leaf(math.log(lam / (1 - lam))),
                       LRinv_vec=leaf(float(R) ** -0.5))


def params_from_jax(p, dtype=torch.float32) -> GARCHParams:
    """Port parameters from a JAX ``GARCHParams`` with numpy (or array)
    leaves, single-chain ``(1,)`` or stacked ``(C, 1)``."""
    def conv(x):
        return torch.as_tensor(np.array(x, dtype=np.float64),
                               dtype=dtype).reshape(-1, 1)
    return GARCHParams(*[conv(getattr(p, f.name))
                         for f in dataclasses.fields(GARCHParams)])


def stationary_variance(params: GARCHParams) -> torch.Tensor:
    """Stationary variance of x, alpha / (1 - beta - gamma) [C]."""
    return params.alpha / (1.0 - params.beta - params.gamma)


def _col(v):
    return v[:, None]


def _sigma2_next(params: GARCHParams, x_t):
    """Variance recursion [C, M] for states x_t [C, M, 2] = (x, sigma2)."""
    x = x_t[..., 0]
    return (_col(params.alpha) + _col(params.beta) * (x * x)
            + _col(params.gamma) * x_t[..., 1])


# --------------------------------------------------------------------------
# Particle kernels.  The state is [x, sigma2]: D = 2 dimensions from one
# normal a step (sigma2 is carried deterministically).
# --------------------------------------------------------------------------

def _sample_x0(params: GARCHParams, z, prior_mean, prior_var):
    x = _col(prior_mean) + _col(torch.sqrt(prior_var)) * z[..., 0]
    return torch.stack([x, torch.zeros_like(x)], -1)


def _propose_prior(params: GARCHParams, z, x_t, y_next):
    s2 = _sigma2_next(params, x_t)
    return torch.stack([torch.sqrt(s2) * z[..., 0], s2], -1)


def _reweight_prior(params: GARCHParams, x_t, x_next, y_next):
    """log N(y'; x', R) [C, N]."""
    diff = y_next[:, 0:1] - x_next[..., 0]
    return (-0.5 * _LOG_2PI - 0.5 * diff * diff * _col(params.rinv)
            + _col(torch.log(torch.abs(params.lrinv))))


def _propose_optimal(params: GARCHParams, z, x_t, y_next):
    """x' ~ p(x' | x, y')."""
    s2 = _sigma2_next(params, x_t)
    rinv = _col(params.rinv)
    var = 1.0 / (rinv + 1.0 / s2)
    mean = var * (y_next[:, 0:1] * rinv)
    return torch.stack([mean + torch.sqrt(var) * z[..., 0], s2], -1)


def _reweight_optimal(params: GARCHParams, x_t, x_next, y_next):
    """log p(y' | x) = log N(y'; 0, sigma2' + R) [C, N]."""
    var = x_next[..., 1] + _col(params.R)
    y = y_next[:, 0:1]
    return -0.5 * _LOG_2PI - 0.5 * (y * y) / var - 0.5 * torch.log(var)


def _prior_log_density(params: GARCHParams, x_t, x_next):
    """log q(x_next | x_t) [C, M] for states [C, M, 2]."""
    s2 = _sigma2_next(params, x_t)
    x = x_next[..., 0]
    return -0.5 * (x * x) / s2 - 0.5 * _LOG_2PI - 0.5 * torch.log(s2)


def _prior_log_density_max(params: GARCHParams):
    return -0.5 * _LOG_2PI - 0.5 * torch.log(params.alpha)


PRIOR_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_prior, reweight=_reweight_prior,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=2, noise_dim=1)

OPTIMAL_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_optimal,
    reweight=_reweight_optimal, prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=2, noise_dim=1)


def get_kernel(name: str | None = None) -> ParticleKernel:
    """The JAX package's kernel names: the default is the optimal one."""
    if name in (None, "optimal"):
        return OPTIMAL_KERNEL
    if name == "prior":
        return PRIOR_KERNEL
    raise ValueError(f"Unrecognized GARCH kernel '{name}'")


# --------------------------------------------------------------------------
# Additive statistic (chain-rule score in the unconstrained coordinates)
# --------------------------------------------------------------------------

# [grad_LRinv, grad_log_mu, grad_logit_phi, grad_logit_lambduh]
STATISTIC_DIM = 4


def grad_statistic(params: GARCHParams, x_t, x_next, y_next, t):
    """Per-particle gradient of log Pr(y', x' | x, theta), [C, N, 4]."""
    mu, phi, lam = _col(params.mu), _col(params.phi), _col(params.lambduh)
    lrinv = _col(params.lrinv)
    v = x_next[..., 1]
    x1 = x_next[..., 0]
    x0 = x_t[..., 0]
    grad_v = -0.5 * (v - x1 * x1) / (v * v)
    grad_log_mu = grad_v * (1.0 - phi) * mu
    grad_logit_phi = (grad_v * (-mu + lam * (x0 * x0) + (1.0 - lam)
                                * x_t[..., 1]) * (1.0 - phi) * phi)
    grad_logit_lambduh = (grad_v * phi * (x0 * x0 - x_t[..., 1])
                          * (1.0 - lam) * lam)
    diff_y = y_next[:, 0:1] - x1
    grad_LRinv = 1.0 / lrinv - diff_y * diff_y * lrinv
    return torch.stack([grad_LRinv, grad_log_mu, grad_logit_phi,
                        grad_logit_lambduh], -1)


def unpack_grad(stat: torch.Tensor) -> GARCHParams:
    """Score vectors [C, 4] -> gradient parameters."""
    return GARCHParams(log_mu=stat[:, 1:2], logit_phi=stat[:, 2:3],
                       logit_lambduh=stat[:, 3:4], LRinv_vec=stat[:, 0:1])


# --------------------------------------------------------------------------
# Fused-window bodies.  Same operation order as csrc/garch_body.cuh (and as
# the JAX package's garch._fused_*): built without FMA contraction, the
# kernel rounds exactly as these PyTorch operators do.
# pv = [mu, phi, lam, lrinv] as [C, 1] columns.
# --------------------------------------------------------------------------

def _fused_pack(params: GARCHParams) -> torch.Tensor:
    return torch.stack([params.mu, params.phi, params.lambduh, params.lrinv],
                       -1)


def _fused_s2(pv, x):
    mu, phi, lam, _ = pv
    alpha = mu * (1.0 - phi)
    beta = phi * lam
    gamma = phi * (1.0 - lam)
    return alpha + beta * (x[0] * x[0]) + gamma * x[1]


def _fused_init(z, prior_mean, prior_var):
    return [prior_mean + torch.sqrt(prior_var) * z[0], torch.zeros_like(z[0])]


def _fused_propose_optimal(pv, z, x, y_t):
    lrinv = pv[3]
    s2 = _fused_s2(pv, x)
    rinv = lrinv * lrinv
    var = 1.0 / (rinv + 1.0 / s2)
    mean = var * (y_t * rinv)
    return [mean + torch.sqrt(var) * z[0], s2]


def _fused_reweight_optimal(pv, x, x_new, y_t):
    lrinv = pv[3]
    var = x_new[1] + 1.0 / (lrinv * lrinv)
    return -0.5 * _LOG_2PI - 0.5 * (y_t * y_t) / var - 0.5 * torch.log(var)


def _fused_propose_prior(pv, z, x, y_t):
    s2 = _fused_s2(pv, x)
    return [torch.sqrt(s2) * z[0], s2]


def _fused_reweight_prior(pv, x, x_new, y_t):
    lrinv = pv[3]
    diff = y_t - x_new[0]
    return (-0.5 * _LOG_2PI - 0.5 * diff * diff * (lrinv * lrinv)
            + torch.log(torch.abs(lrinv)))


def _fused_stat(pv, x, x_new, y_t):
    mu, phi, lam, lrinv = pv
    v = x_new[1]
    grad_v = -0.5 * (v - x_new[0] * x_new[0]) / (v * v)
    grad_log_mu = grad_v * (1.0 - phi) * mu
    grad_logit_phi = (grad_v * (-mu + lam * (x[0] * x[0]) + (1.0 - lam) * x[1])
                      * (1.0 - phi) * phi)
    grad_logit_lambduh = (grad_v * phi * (x[0] * x[0] - x[1]) * (1.0 - lam)
                          * lam)
    diff_y = y_t - x_new[0]
    grad_LRinv = 1.0 / lrinv - diff_y * diff_y * lrinv
    return [grad_LRinv, grad_log_mu, grad_logit_phi, grad_logit_lambduh]


_COMMON = dict(n_state=2, n_stat=STATISTIC_DIM, n_param=4,
               pack_params=_fused_pack, stat=_fused_stat, init=_fused_init,
               n_noise=1)
FUSED = FusedModel(propose=_fused_propose_optimal,
                   reweight=_fused_reweight_optimal, body="garch_optimal",
                   **_COMMON)
FUSED_PRIOR = FusedModel(propose=_fused_propose_prior,
                         reweight=_fused_reweight_prior, body="garch_prior",
                         **_COMMON)


def get_fused(name: str | None = None):
    """Fused bundle matching `get_kernel`."""
    if name in (None, "optimal"):
        return FUSED
    if name == "prior":
        return FUSED_PRIOR
    raise ValueError(f"Unrecognized GARCH kernel '{name}'")


# --------------------------------------------------------------------------
# Prior: InvGamma on mu, Beta on phi and lambduh, Wishart on Rinv
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GARCHPrior:
    scale_mu: torch.Tensor
    shape_mu: torch.Tensor
    alpha_phi: torch.Tensor
    beta_phi: torch.Tensor
    alpha_lambduh: torch.Tensor
    beta_lambduh: torch.Tensor
    scale_Rinv: torch.Tensor     # (1, 1)
    df_Rinv: torch.Tensor        # ()


def default_prior(var: float = 1.0, dtype=torch.float32,
                  device=None) -> GARCHPrior:
    """The JAX package's default hyperparameters (var capped at 1)."""
    var = min(var, 1.0)
    scale_mu = var + 2.0
    alpha = 1.0 + 19.0 / var
    df_r = 2.0 + 1.0 / var

    def full(v, shape=()):
        return torch.full(shape, v, dtype=dtype, device=device)
    return GARCHPrior(scale_mu=full(scale_mu), shape_mu=full(scale_mu + 1.0),
                      alpha_phi=full(alpha), beta_phi=full(alpha / 9.0),
                      alpha_lambduh=full(alpha),
                      beta_lambduh=full(alpha / 9.0),
                      scale_Rinv=full(1.0 / df_r, (1, 1)), df_Rinv=full(df_r))


def logprior(prior: GARCHPrior, params: GARCHParams) -> torch.Tensor:
    """log prior density [C].  The Beta densities are evaluated at
    (1+phi)/2 and (1+lambduh)/2, as in the JAX package (and its
    reference)."""
    lp = invgamma_logpdf(params.mu, prior.shape_mu, prior.scale_mu)
    lp = lp + beta_logpdf((1.0 + params.phi) / 2.0, prior.alpha_phi,
                          prior.beta_phi)
    lp = lp + beta_logpdf((1.0 + params.lambduh) / 2.0, prior.alpha_lambduh,
                          prior.beta_lambduh)
    Rinv = params.rinv[:, None, None]
    return lp + wishart_logpdf(Rinv, prior.df_Rinv, prior.scale_Rinv)


def grad_logprior(prior: GARCHPrior, params: GARCHParams) -> GARCHParams:
    """The JAX package's hand-derived prior score in the unconstrained
    coordinates."""
    mu, phi, lam = params.mu, params.phi, params.lambduh
    g_log_mu = -prior.shape_mu - 1.0 + prior.scale_mu / mu
    g_logit_phi = ((prior.alpha_phi - 1.0) / (1.0 + phi)
                   - (prior.beta_phi - 1.0) / (1.0 - phi)) * phi * (1.0 - phi)
    g_logit_lam = ((prior.alpha_lambduh - 1.0) / (1.0 + lam)
                   - (prior.beta_lambduh - 1.0) / (1.0 - lam)) \
        * lam * (1.0 - lam)
    g_lrinv = ((prior.df_Rinv - 2.0) / params.lrinv
               - params.lrinv / prior.scale_Rinv[0, 0])
    return GARCHParams(log_mu=_col(g_log_mu), logit_phi=_col(g_logit_phi),
                       logit_lambduh=_col(g_logit_lam),
                       LRinv_vec=_col(g_lrinv))


def sample_prior(prior: GARCHPrior, generator: torch.Generator,
                 num_chains: int = 1) -> GARCHParams:
    """``num_chains`` independent prior draws."""
    C = num_chains
    dt, dev = prior.scale_mu.dtype, prior.scale_mu.device
    mu = sample_invgamma(generator, prior.shape_mu, prior.scale_mu, (C,), dt,
                         dev)
    phi = sample_beta(generator, prior.alpha_phi, prior.beta_phi, (C,), dt,
                      dev)
    lam = sample_beta(generator, prior.alpha_lambduh, prior.beta_lambduh,
                      (C,), dt, dev)
    Rinv = sample_wishart(generator, prior.df_Rinv, prior.scale_Rinv, (C,))
    return GARCHParams(log_mu=_col(torch.log(mu)),
                       logit_phi=_col(torch.logit(phi)),
                       logit_lambduh=_col(torch.logit(lam)),
                       LRinv_vec=_col(torch.sqrt(Rinv[:, 0, 0])))


def project_parameters(params: GARCHParams) -> GARCHParams:
    """The unconstrained coordinates need no projection beyond reflecting
    LRinv."""
    return dataclasses.replace(params, LRinv_vec=torch.abs(params.LRinv_vec))


def generate_data(generator: torch.Generator, params: GARCHParams, T: int):
    """Simulate (observations [T, 1], latent x [T, 1]) from chain 0 of
    ``params`` on the generator's device, started from the stationary
    variance."""
    p = params_map(lambda x: x[:1], params)
    dt, dev = p.log_mu.dtype, p.log_mu.device
    zx = torch.randn((T,), generator=generator, dtype=dt, device=dev)
    zy = torch.randn((T,), generator=generator, dtype=dt, device=dev)
    s2 = stationary_variance(p)
    x = torch.sqrt(s2) * torch.randn((1,), generator=generator, dtype=dt,
                                     device=dev)
    alpha, beta, gamma = p.alpha, p.beta, p.gamma
    xs = []
    for t in range(T):
        s2 = alpha + beta * (x * x) + gamma * s2
        x = torch.sqrt(s2) * zx[t]
        xs.append(x)
    xs = torch.cat(xs)
    ys = xs + torch.sqrt(p.R) * zy
    return ys[:, None], xs[:, None]
