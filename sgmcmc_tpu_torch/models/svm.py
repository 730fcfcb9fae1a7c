"""Stochastic-volatility model (SVM), chain-batched PyTorch port.

x_t = A x_{t-1} + N(0, Q),   y_t ~ N(0, exp(x_t) * R)

Counterpart of the parts of ``sgmcmc_tpu/models/svm.py`` that buffered-PF
SGLD runs: parameters in the same coordinates (A, packed Cholesky of the
precisions LQinv_vec / LRinv_vec) with a leading chain axis, the bootstrap
kernel with its transition density, the Fisher-identity statistic, the
prior and its partial-prior gradient, the projection, and the fused-window
body (plain PyTorch here, CUDA in ``csrc/svm_body.cuh``).  The Laplace /
EP proposals and the predict surface are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.cuda.fused_pf import FusedModel
from ..utils.distributions import (matrix_normal_logpdf, sample_wishart,
                                   wishart_logpdf)
from ..utils.linalg import tril_vector_to_mat
from .base import ParticleKernel, params_map

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


def get_kernel(name: str | None = None) -> ParticleKernel:
    if name in (None, "prior"):
        return KERNEL
    raise NotImplementedError(f"SVM kernel '{name}' is not ported yet")


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
