"""Scalar linear-Gaussian state-space model (LGSSM), chain-batched port.

x_t = A x_{t-1} + N(0, Q),   y_t = C x_t + N(0, R),   n = m = 1.

Counterpart of the parts of ``sgmcmc_tpu/models/lgssm.py`` that
buffered-PF SGLD and its exact oracle run, for the scalar model (the
configuration of every reference experiment): parameters in the same
coordinates (A, C, packed Cholesky of the precisions LQinv_vec /
LRinv_vec) with a leading chain axis, the prior and locally optimal
particle kernels, the Fisher-identity statistic, the prior, its
partial-prior gradient and the projection, the fused-window bodies (plain
PyTorch here, CUDA in ``csrc/lgssm_body.cuh``), and the exact Kalman
marginal log-likelihood and gradient through ``ops/kalman.py`` in
float64.  The vector model, the Gibbs updates, the preconditioner and the
predict surface are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import kalman
from ..ops.cuda.fused_pf import FusedModel
from ..utils.distributions import (matrix_normal_logpdf, sample_wishart,
                                   wishart_logpdf)
from ..utils.linalg import (mat_to_tril_vector, spectral_norm_projection,
                            tril_vector_to_mat)
from .base import ParticleKernel, params_map

_LOG_2PI = 1.8378770664093453


@dataclasses.dataclass
class LGSSMParams:
    """LGSSM parameters of C chains (JAX package coordinates)."""
    A: torch.Tensor            # [C, 1, 1]
    C: torch.Tensor            # [C, 1, 1]
    LQinv_vec: torch.Tensor    # [C, 1] chol(Q^-1)
    LRinv_vec: torch.Tensor    # [C, 1] chol(R^-1)

    @property
    def num_chains(self) -> int:
        return self.A.shape[0]

    @property
    def a(self):
        return self.A[:, 0, 0]

    @property
    def c(self):
        return self.C[:, 0, 0]

    @property
    def lqinv(self):
        return self.LQinv_vec[:, 0]

    @property
    def lrinv(self):
        return self.LRinv_vec[:, 0]

    @property
    def LQinv(self):
        return tril_vector_to_mat(self.LQinv_vec)

    @property
    def LRinv(self):
        return tril_vector_to_mat(self.LRinv_vec)

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

    def to(self, device) -> "LGSSMParams":
        return params_map(lambda x: x.to(device), self)


def from_matrices(A, C, Q, R, dtype=torch.float32,
                  device=None) -> LGSSMParams:
    """One chain's parameters from natural 1x1 (or scalar) A, C, Q, R."""
    def leaf(v, shape):
        return torch.as_tensor(np.asarray(v, np.float64).reshape(shape),
                               dtype=dtype, device=device)
    q = float(np.asarray(Q).reshape(()))
    r = float(np.asarray(R).reshape(()))
    return LGSSMParams(A=leaf(A, (1, 1, 1)), C=leaf(C, (1, 1, 1)),
                       LQinv_vec=leaf(q ** -0.5, (1, 1)),
                       LRinv_vec=leaf(r ** -0.5, (1, 1)))


def from_scalars(A: float, Q: float, R: float, C: float = 1.0,
                 dtype=torch.float32, device=None) -> LGSSMParams:
    """One chain's parameters from natural (A, Q, R) scalars and C."""
    return from_matrices(A, C, Q, R, dtype, device)


def params_from_jax(p, dtype=torch.float32) -> LGSSMParams:
    """Port parameters from a JAX ``LGSSMParams`` with numpy (or array)
    leaves, single-chain ``(1, 1) / (1,)`` or stacked ``(C, 1, 1) / (C, 1)``
    (scalar model only)."""
    def conv(x, shape):
        return torch.as_tensor(np.array(x, dtype=np.float64),
                               dtype=dtype).reshape(shape)
    return LGSSMParams(A=conv(p.A, (-1, 1, 1)), C=conv(p.C, (-1, 1, 1)),
                       LQinv_vec=conv(p.LQinv_vec, (-1, 1)),
                       LRinv_vec=conv(p.LRinv_vec, (-1, 1)))


def stationary_variance(params: LGSSMParams, num_iters: int = 10):
    """Variance [C] of the JAX package's initial state for data
    generation: Sigma <- A Sigma A^T + Q iterated from Q ``num_iters - 1``
    times (its truncated stationary precision, inverted)."""
    a2, q = params.a ** 2, params.Q
    sigma = q
    for _ in range(1, num_iters):
        sigma = a2 * sigma + q
    return sigma


def generate_data(generator: torch.Generator, params: LGSSMParams, T: int):
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
    ys = p.c * xs + sq_r * zy
    return ys[:, None], xs[:, None]


# --------------------------------------------------------------------------
# Exact (Kalman) interface: the correctness oracle, in float64
# --------------------------------------------------------------------------

def _kalman_args(params: LGSSMParams):
    p = params_map(lambda x: x.double(), params)
    return p.A, p.C, p.LQinv, p.LRinv


def _default_messages(params: LGSSMParams):
    dev = params.A.device
    return (kalman.init_forward_message(1, device=dev),
            kalman.init_backward_message(1, device=dev))


def gradient_marginal_loglikelihood(params: LGSSMParams,
                                    observations) -> LGSSMParams:
    """Exact gradient of log p(y) per chain under the default diffuse prior
    message, as float64 LGSSMParams."""
    fwd, bwd = _default_messages(params)
    g = kalman.gradient_marginal_loglikelihood(
        observations.double(), *_kalman_args(params), fwd, bwd)
    return LGSSMParams(A=g["A"], C=g["C"],
                       LQinv_vec=mat_to_tril_vector(g["LQinv"]),
                       LRinv_vec=mat_to_tril_vector(g["LRinv"]))


# --------------------------------------------------------------------------
# Particle kernels (prior / locally optimal)
# --------------------------------------------------------------------------

def _col(v):
    return v[:, None, None]


def _sample_x0(params: LGSSMParams, z, prior_mean, prior_var):
    return _col(prior_mean) + _col(torch.sqrt(prior_var)) * z


def _propose_prior(params: LGSSMParams, z, x_t, y_next):
    """x' ~ N(A x, Q)."""
    return x_t * _col(params.a) + z / _col(params.lqinv)


def _reweight_prior(params: LGSSMParams, x_t, x_next, y_next):
    """log N(y'; C x', R) [C, N]."""
    z = (y_next[:, 0:1] - x_next[..., 0] * params.c[:, None]) \
        * params.lrinv[:, None]
    return (-0.5 * _LOG_2PI + torch.log(torch.abs(params.lrinv))[:, None]
            - 0.5 * z * z)


def _propose_optimal(params: LGSSMParams, z, x_t, y_next):
    """x' ~ p(x' | x, y'), the locally optimal proposal."""
    qinv, rinv, c = params.qinv, params.rinv, params.c
    sigma = 1.0 / (qinv + c * rinv * c)
    mean = (x_t * _col(params.a)) * _col(qinv) \
        + y_next[:, None, :] * _col(c * rinv)
    return mean * _col(sigma) + z * _col(torch.sqrt(sigma))


def _reweight_optimal(params: LGSSMParams, x_t, x_next, y_next):
    """log p(y' | x) = log N(y'; C A x, C Q C^T + R) [C, N]."""
    c = params.c
    y_cov = c * params.Q * c + params.R
    diff = y_next[:, 0:1] - (x_t[..., 0] * params.a[:, None]) * c[:, None]
    quad = diff * (1.0 / y_cov)[:, None] * diff
    return (-0.5 * _LOG_2PI - 0.5 * torch.log(y_cov)[:, None] - 0.5 * quad)


def _prior_log_density(params: LGSSMParams, x_t, x_next):
    """log q(x_next | x_t) [C, M] for x_t, x_next [C, M, 1]."""
    z = (x_next[..., 0] - x_t[..., 0] * params.a[:, None]) \
        * params.lqinv[:, None]
    return (-0.5 * _LOG_2PI + torch.log(torch.abs(params.lqinv))[:, None]
            - 0.5 * z * z)


def _prior_log_density_max(params: LGSSMParams):
    return -0.5 * _LOG_2PI + torch.log(torch.abs(params.lqinv))


PRIOR_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_prior, reweight=_reweight_prior,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1, noise_dim=1)

OPTIMAL_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_optimal,
    reweight=_reweight_optimal, prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1, noise_dim=1)


def get_kernel(name: str | None = None) -> ParticleKernel:
    """The JAX package's kernel names: the default is the optimal one."""
    if name in (None, "optimal", "highdim"):
        return OPTIMAL_KERNEL
    if name == "prior":
        return PRIOR_KERNEL
    raise ValueError(f"Unrecognized LGSSM kernel '{name}'")


# --------------------------------------------------------------------------
# Additive statistic (Fisher-identity score)
# --------------------------------------------------------------------------

STATISTIC_DIM = 4  # [grad_LRinv_vec, grad_LQinv_vec, grad_C, grad_A]


def grad_statistic(params: LGSSMParams, x_t, x_next, y_next, t):
    """Per-particle gradient of log Pr(y', x' | x, theta), [C, N, 4]."""
    x0, x1 = x_t[..., 0], x_next[..., 0]
    a, c = params.a[:, None], params.c[:, None]
    lqinv, lrinv = params.lqinv[:, None], params.lrinv[:, None]
    diff = x1 - x0 * a
    grad_A = params.qinv[:, None] * diff * x0
    grad_LQinv = 1.0 / lqinv - diff * diff * lqinv
    diff_y = y_next[:, 0:1] - x1 * c
    grad_C = params.rinv[:, None] * diff_y * x1
    grad_LRinv = 1.0 / lrinv - diff_y * diff_y * lrinv
    return torch.stack([grad_LRinv, grad_LQinv, grad_C, grad_A], -1)


def unpack_grad(stat: torch.Tensor) -> LGSSMParams:
    """Score vectors [C, 4] -> gradient parameters."""
    C = stat.shape[0]
    return LGSSMParams(A=stat[:, 3].reshape(C, 1, 1),
                       C=stat[:, 2].reshape(C, 1, 1),
                       LQinv_vec=stat[:, 1:2], LRinv_vec=stat[:, 0:1])


# --------------------------------------------------------------------------
# Fused-window bodies.  Same operation order as csrc/lgssm_body.cuh (and as
# the JAX package's lgssm._fused_*): built without FMA contraction, the
# kernel rounds exactly as these PyTorch operators do.
# pv = [a, c, lqinv, lrinv] as [C, 1] columns.
# --------------------------------------------------------------------------

def _fused_pack(params: LGSSMParams) -> torch.Tensor:
    return torch.stack([params.a, params.c, params.lqinv, params.lrinv], -1)


def _fused_propose_prior(pv, z, x, y_t):
    a, _, lqinv, _ = pv
    return [a * x[0] + z[0] / lqinv]


def _fused_reweight_prior(pv, x, x_new, y_t):
    _, c, _, lrinv = pv
    diff = (y_t - c * x_new[0]) * lrinv
    return -0.5 * _LOG_2PI + torch.log(torch.abs(lrinv)) - 0.5 * diff * diff


def _fused_propose_optimal(pv, z, x, y_t):
    a, c, lqinv, lrinv = pv
    qinv = lqinv * lqinv
    rinv = lrinv * lrinv
    sigma = 1.0 / (qinv + c * c * rinv)
    mean = sigma * (a * x[0] * qinv + y_t * c * rinv)
    return [mean + torch.sqrt(sigma) * z[0]]


def _fused_reweight_optimal(pv, x, x_new, y_t):
    a, c, lqinv, lrinv = pv
    y_var = c * c / (lqinv * lqinv) + 1.0 / (lrinv * lrinv)
    diff = y_t - c * a * x[0]
    return (-0.5 * _LOG_2PI - 0.5 * torch.log(y_var)
            - 0.5 * diff * diff / y_var)


def _fused_stat(pv, x, x_new, y_t):
    a, c, lqinv, lrinv = pv
    diff = x_new[0] - a * x[0]
    grad_A = (lqinv * lqinv) * diff * x[0]
    grad_LQinv = 1.0 / lqinv - diff * diff * lqinv
    diff_y = y_t - c * x_new[0]
    grad_C = (lrinv * lrinv) * diff_y * x_new[0]
    grad_LRinv = 1.0 / lrinv - diff_y * diff_y * lrinv
    return [grad_LRinv, grad_LQinv, grad_C, grad_A]   # STATISTIC_DIM order


_COMMON = dict(n_state=1, n_stat=STATISTIC_DIM, n_param=4,
               pack_params=_fused_pack, stat=_fused_stat)
FUSED = FusedModel(propose=_fused_propose_optimal,
                   reweight=_fused_reweight_optimal, body="lgssm_optimal",
                   **_COMMON)
FUSED_PRIOR = FusedModel(propose=_fused_propose_prior,
                         reweight=_fused_reweight_prior, body="lgssm_prior",
                         **_COMMON)


def get_fused(name: str | None = None):
    """Fused bundle matching `get_kernel`."""
    if name in (None, "optimal", "highdim"):
        return FUSED
    if name == "prior":
        return FUSED_PRIOR
    raise ValueError(f"Unrecognized LGSSM kernel '{name}'")


# --------------------------------------------------------------------------
# Prior (Wishart on Qinv / Rinv, matrix-normal on A and C)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LGSSMPrior:
    mean_A: torch.Tensor       # (1, 1)
    var_col_A: torch.Tensor    # (1,)
    mean_C: torch.Tensor       # (1, 1)
    var_col_C: torch.Tensor    # (1,)
    scale_Qinv: torch.Tensor   # (1, 1)
    df_Qinv: torch.Tensor      # ()
    scale_Rinv: torch.Tensor   # (1, 1)
    df_Rinv: torch.Tensor      # ()


def default_prior(var: float = 100.0, dtype=torch.float32,
                  device=None) -> LGSSMPrior:
    """The JAX package's default hyperparameters at n = m = 1."""
    df = 2.0 + 1.0 / var

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)
    return LGSSMPrior(mean_A=full((1, 1), 0.0), var_col_A=full((1,), var),
                      mean_C=full((1, 1), 0.0), var_col_C=full((1,), var),
                      scale_Qinv=full((1, 1), 1.0 / df), df_Qinv=full((), df),
                      scale_Rinv=full((1, 1), 1.0 / df), df_Rinv=full((), df))


def logprior(prior: LGSSMPrior, params: LGSSMParams) -> torch.Tensor:
    """log prior density [C]."""
    LQinv, LRinv = params.LQinv, params.LRinv
    lp = wishart_logpdf(LQinv @ LQinv.mT, prior.df_Qinv, prior.scale_Qinv)
    lp = lp + wishart_logpdf(LRinv @ LRinv.mT, prior.df_Rinv,
                             prior.scale_Rinv)
    lp = lp + matrix_normal_logpdf(
        params.A, prior.mean_A, Lrowprec=LQinv,
        Lcolprec=torch.diag(prior.var_col_A ** -0.5))
    return lp + matrix_normal_logpdf(
        params.C, prior.mean_C, Lrowprec=LRinv,
        Lcolprec=torch.diag(prior.var_col_C ** -0.5))


def grad_logprior(prior: LGSSMPrior, params: LGSSMParams) -> LGSSMParams:
    """Analytic prior score with the JAX package's (and reference's)
    convention: the matrix-normal priors on A and C treat their row
    covariances (Q, R) as constants.  At n = m = 1 the Wishart terms
    ``(df - n - 1) inv(L)^T - solve(scale, L)`` are scalar."""
    n = 1
    lqinv, lrinv = params.lqinv, params.lrinv
    grad_LQinv = ((prior.df_Qinv - n - 1) / lqinv
                  - lqinv / prior.scale_Qinv[0, 0])
    grad_LRinv = ((prior.df_Rinv - n - 1) / lrinv
                  - lrinv / prior.scale_Rinv[0, 0])
    grad_A = (-params.qinv[:, None, None] * (params.A - prior.mean_A)
              / prior.var_col_A)
    grad_C = (-params.rinv[:, None, None] * (params.C - prior.mean_C)
              / prior.var_col_C)
    return LGSSMParams(A=grad_A, C=grad_C, LQinv_vec=grad_LQinv[:, None],
                       LRinv_vec=grad_LRinv[:, None])


def sample_prior(prior: LGSSMPrior, generator: torch.Generator,
                 num_chains: int = 1) -> LGSSMParams:
    """``num_chains`` independent prior draws."""
    C = num_chains
    Qinv = sample_wishart(generator, prior.df_Qinv, prior.scale_Qinv, (C,))
    Rinv = sample_wishart(generator, prior.df_Rinv, prior.scale_Rinv, (C,))
    lqinv = torch.sqrt(Qinv[:, 0, 0])
    lrinv = torch.sqrt(Rinv[:, 0, 0])
    z = torch.randn((C, 2), generator=generator, dtype=lqinv.dtype,
                    device=lqinv.device)
    A = prior.mean_A + (z[:, 0] / lqinv * torch.sqrt(
        prior.var_col_A[0]))[:, None, None]
    Cm = prior.mean_C + (z[:, 1] / lrinv * torch.sqrt(
        prior.var_col_C[0]))[:, None, None]
    return LGSSMParams(A=A, C=Cm, LQinv_vec=lqinv[:, None],
                       LRinv_vec=lrinv[:, None])


def project_parameters(params: LGSSMParams, a_threshold: float = 0.9999,
                       fix_C_eye: bool = True) -> LGSSMParams:
    """|A| <= threshold, positive Cholesky diagonals and, by default, the
    C = 1 identifiability constraint."""
    C = torch.ones_like(params.C) if fix_C_eye else params.C
    return LGSSMParams(A=spectral_norm_projection(params.A, a_threshold),
                       C=C, LQinv_vec=torch.abs(params.LQinv_vec),
                       LRinv_vec=torch.abs(params.LRinv_vec))
