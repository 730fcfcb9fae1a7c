"""AR(p) hidden Markov model (ARPHMM), chain-batched port.

z_t ~ Markov(pi),   y_t | z_t = k ~ N(D_k [y_{t-1}; ...; y_{t-p}], R_k)

Counterpart of ``sgmcmc_tpu/models/arphmm.py``.  Observations are
lag-stacked, ``[T, p+1, m]`` with slot 0 the current y (:func:`stack_y`);
the exact surface is ``gauss_hmm.py``'s, bound to this model's emission,
and this module adds the regression block: its gradient, prior, the
matrix-normal-Wishart Gibbs update (its normals an input, as the
Dirichlet's gammas and the Wishart's draws are), the projection (the
spectral norm of each D_k) and data generation.
``parallel_marginal_loglikelihood`` is ROADMAP.md, Queue 1, slice 12b.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.distributions import sample_wishart, wishart_logpdf
from ..utils.linalg import (cholesky, inv, mat_to_tril_vector, solve_upper,
                            spectral_norm_projection, tril_vector_to_mat)
from ..utils.simplex import unit_gamma
from . import gauss_hmm as g
from .base import params_map
from .gauss_hmm import (DTYPE, GibbsDraws, PriorDraws,  # noqa: F401
                        default_backward_message, default_forward_message)

_LOG_2PI = g._LOG_2PI


@dataclasses.dataclass
class ARPHMMParams:
    """ARPHMM parameters of C chains (JAX package coordinates)."""
    logit_pi: torch.Tensor     # [C, K, K]
    D: torch.Tensor            # [C, K, m, d], d = m p
    LRinv_vec: torch.Tensor    # [C, K, m(m+1)/2] chol(R_k^-1), packed

    @property
    def num_chains(self) -> int:
        return self.logit_pi.shape[0]

    @property
    def num_states(self) -> int:
        return self.logit_pi.shape[-1]

    @property
    def m(self) -> int:
        return self.D.shape[-2]

    @property
    def d(self) -> int:
        return self.D.shape[-1]

    @property
    def p(self) -> int:
        return self.d // self.m

    @property
    def pi(self):
        return torch.softmax(self.logit_pi, -1)

    @property
    def LRinv(self):
        return tril_vector_to_mat(self.LRinv_vec)

    @property
    def Rinv(self):
        L = self.LRinv
        return L @ L.mT

    @property
    def R(self):
        return inv(self.Rinv)

    @property
    def tau(self):
        """The per-state emission scale 1 / |diag LRinv|."""
        return g._tau(self.LRinv_vec, self.D.shape[-2])

    def to(self, device) -> "ARPHMMParams":
        return params_map(lambda x: x.to(device), self)


def from_values(pi, D, R, dtype=DTYPE, device=None) -> ARPHMMParams:
    """One chain's parameters from pi [K, K], D [K, m, d] and R [K, m, m]
    (or one [m, m] for every state)."""
    pi = np.asarray(pi, np.float64)
    R = np.asarray(R, np.float64)
    if R.ndim == 2:
        R = np.repeat(R[None], pi.shape[0], axis=0)
    return ARPHMMParams(logit_pi=g._leaf(np.log(pi + 1e-99), dtype, device),
                        D=g._leaf(D, dtype, device),
                        LRinv_vec=g._leaf(g._packed_chol_inv(R), dtype,
                                          device))


def params_from_jax(p, dtype=DTYPE) -> ARPHMMParams:
    """Port parameters from a JAX ``ARPHMMParams`` (one chain's or
    stacked)."""
    return g._from_jax(ARPHMMParams, p, dtype)


def stack_y(y, p: int) -> torch.Tensor:
    """[T+p, m] (or [T+p]) -> [T, p+1, m]: slot l of row t is y[p + t -
    l]."""
    y = torch.as_tensor(y)
    y = y[:, None] if y.dim() == 1 else y
    T = y.shape[0] - p
    return torch.stack([y[p - lag:p - lag + T] for lag in range(p + 1)], 1)


def _regression(params: ARPHMMParams, observations):
    """(residuals y_t - D_k x_t [..., T, K, m], regressors x_t [..., T,
    d]) of lag-stacked observations [..., T, p+1, m]."""
    y0 = observations[..., 0, :]
    x = observations[..., 1:, :].flatten(-2)
    mean = (params.D[..., None, :, :, :] @ x[..., :, None, :, None])[..., 0]
    return y0[..., :, None, :] - mean, x


def emission_logliks(params: ARPHMMParams, observations) -> torch.Tensor:
    """logP [..., T, K] for lag-stacked observations [..., T, p+1, m]."""
    return g._gauss_logliks(_regression(params, observations)[0],
                            params.LRinv)


def marginal_loglikelihood(params: ARPHMMParams, observations,
                           forward_msg=None, backward_msg=None, weights=None,
                           valid=None) -> torch.Tensor:
    """Exact log p(y) per chain."""
    return g._marginal_loglikelihood(emission_logliks, params, observations,
                                     forward_msg, backward_msg, weights,
                                     valid)


def gradient_marginal_loglikelihood(params: ARPHMMParams, observations,
                                    forward_msg=None, backward_msg=None,
                                    weights=None, use_scir: bool = False,
                                    valid=None) -> ARPHMMParams:
    """The exact gradient of log p(y) per chain (``use_scir``: the
    Dirichlet statistic in the logit_pi slot)."""
    diff, x = _regression(params, observations)
    logP = g._gauss_logliks(diff, params.LRinv)
    g_pi, w_marg = g._exact_statistics(params, logP, forward_msg,
                                       backward_msg, weights, use_scir, valid)
    wd = diff * w_marg[..., None]                              # [..., T, K, m]
    s = (wd[..., :, :, :, None] * x[..., :, None, None, :]).sum(-4)
    return ARPHMMParams(logit_pi=g_pi, D=params.Rinv @ s,
                        LRinv_vec=g._noise_gradient(params, diff, w_marg))


def predictive_loglikelihood(params: ARPHMMParams, observations, lag=1,
                             forward_msg=None) -> torch.Tensor:
    return g._predictive_loglikelihood(emission_logliks, params,
                                       observations, lag, forward_msg)


def windowed_marginal_gradient(params: ARPHMMParams, window, valid, weights,
                               B: int, S: int, use_scir: bool = False):
    """The buffered exact-gradient estimator over windows ``[R, W, p+1,
    m]``: (gradient parameters, loglik [R])."""
    return g._windowed_marginal(emission_logliks,
                                gradient_marginal_loglikelihood, params,
                                window, valid, weights, B, S, use_scir)


def latent_var_distr(params: ARPHMMParams, observations, lag=None,
                     forward_msg=None, backward_msg=None) -> torch.Tensor:
    return g._latent_var_distr(emission_logliks, params, observations,
                               forward_msg, backward_msg, lag)


def latent_var_sample(params: ARPHMMParams, generator, observations,
                      forward_msg=None, num_samples: int = 1,
                      distr: str = "joint", lag=None, backward_msg=None,
                      valid=None, uniforms=None) -> torch.Tensor:
    return g._latent_var_sample(emission_logliks, params, generator,
                                observations, forward_msg, num_samples, distr,
                                lag, backward_msg, valid, uniforms)


def complete_data_loglikelihood(params: ARPHMMParams, observations, z,
                                z_prev=None, weights=None) -> torch.Tensor:
    return g._complete_data_loglikelihood(emission_logliks, params,
                                          observations, z, z_prev, weights)


def windowed_complete_gradient(params: ARPHMMParams, window, valid, weights,
                               B: int, S: int, generator=None,
                               num_samples: int = 1, uniforms=None,
                               completion=None, z=None, z_init=None):
    return g._windowed_complete(emission_logliks, ARPHMMParams, params,
                                window, valid, weights, B, S, generator,
                                num_samples, uniforms, completion, z, z_init)


# --------------------------------------------------------------------------
# Prior / projection / preconditioner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ARPHMMPrior:
    alpha_pi: torch.Tensor     # (K, K)
    mean_D: torch.Tensor       # (K, m, d)
    var_col_D: torch.Tensor    # (K, d)
    scale_Rinv: torch.Tensor   # (K, m, m)
    df_Rinv: torch.Tensor      # ()


def default_prior(num_states: int, m: int, d: int, var: float = 100.0,
                  dtype=DTYPE, device=None) -> ARPHMMPrior:
    """The JAX package's default hyperparameters."""
    df = m + 1.0 + 1.0 / var
    K = num_states

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)
    return ARPHMMPrior(
        alpha_pi=full((K, K), 1.0 / var), mean_D=full((K, m, d), 0.0),
        var_col_D=full((K, d), var),
        scale_Rinv=(torch.eye(m, dtype=dtype, device=device) / df).repeat(
            K, 1, 1),
        df_Rinv=full((), df))


def logprior(prior: ARPHMMPrior, params: ARPHMMParams) -> torch.Tensor:
    """log prior density [C] (the JAX package's normalisation)."""
    lp = g._dirichlet_logprior(prior.alpha_pi, params.pi)
    Rinv = params.Rinv
    lp = lp + wishart_logpdf(Rinv, prior.df_Rinv, prior.scale_Rinv).sum(-1)
    diff = params.D - prior.mean_D
    quad = ((diff * (Rinv @ diff)).sum(-2) / prior.var_col_D).sum((-2, -1))
    m, d = params.m, params.d
    lp = lp + (d * g._half_logdet(params.LRinv)
               - 0.5 * m * torch.log(prior.var_col_D).sum(-1)
               - 0.5 * m * d * _LOG_2PI / m).sum(-1)
    return lp - 0.5 * quad


def grad_logprior(prior: ARPHMMPrior, params: ARPHMMParams,
                  use_scir: bool = False) -> ARPHMMParams:
    if use_scir:
        g_pi = prior.alpha_pi.expand(params.logit_pi.shape)
    else:
        g_pi = g.hmm.dirichlet_grad_logit_pi(prior.alpha_pi, params.pi)
    g_D = -(params.Rinv @ (params.D - prior.mean_D)) \
        / prior.var_col_D[:, None, :]
    return ARPHMMParams(logit_pi=g_pi, D=g_D,
                        LRinv_vec=g._wishart_grad(prior, params.LRinv))


def sample_prior(prior: ARPHMMPrior, generator, num_chains: int = 1,
                 draws: PriorDraws | None = None) -> ARPHMMParams:
    """``num_chains`` independent prior draws (``draws.normals`` [C, K, m,
    d]); ``draws`` replace the generator's."""
    C = num_chains
    K, m, d = prior.mean_D.shape
    dr = draws or PriorDraws(None, None, None, None)
    alpha = prior.alpha_pi.expand(C, K, K)
    gam = unit_gamma(generator, alpha) if dr.gamma is None else dr.gamma
    pi = gam / gam.sum(-1, keepdim=True)
    LRinv = cholesky(sample_wishart(generator, prior.df_Rinv,
                                    prior.scale_Rinv, (C, K), chi2=dr.r_chi2,
                                    off=dr.r_off))
    z = dr.normals
    if z is None:
        z = torch.randn((C, K, m, d), generator=generator, dtype=LRinv.dtype,
                        device=LRinv.device)
    D = prior.mean_D + solve_upper(LRinv.mT, z) \
        * torch.sqrt(prior.var_col_D)[:, None, :]
    return ARPHMMParams(logit_pi=torch.log(pi + 1e-99), D=D,
                        LRinv_vec=mat_to_tril_vector(LRinv))


def project_parameters(params: ARPHMMParams, d_threshold: float = 0.9999,
                       center_logit: bool = True) -> ARPHMMParams:
    """Centred logits, each D_k's spectral norm at most ``d_threshold``
    and positive Cholesky diagonals."""
    return ARPHMMParams(
        logit_pi=g._center(params.logit_pi) if center_logit
        else params.logit_pi,
        D=spectral_norm_projection(params.D, d_threshold),
        LRinv_vec=g._abs_diag(params.LRinv_vec, params.m))


def precondition(params: ARPHMMParams, grad: ARPHMMParams) -> ARPHMMParams:
    """D(theta) grad: (g_pi, R g_D, tril(Rinv g_LR) / 2)."""
    return ARPHMMParams(
        logit_pi=grad.logit_pi, D=params.R @ grad.D,
        LRinv_vec=mat_to_tril_vector(
            0.5 * params.Rinv @ tril_vector_to_mat(grad.LRinv_vec)))


def precondition_normals(generator, params: ARPHMMParams) -> ARPHMMParams:
    """Standard normals shaped like logit_pi and D, and a full square
    [C, K, m, m] in the Cholesky field."""
    dt, dev = params.D.dtype, params.D.device
    C, K, m, d = params.D.shape
    return ARPHMMParams(*[torch.randn(s, generator=generator, dtype=dt,
                                      device=dev)
                          for s in ((C, K, K), (C, K, m, d), (C, K, m, m))])


def precondition_noise(params: ARPHMMParams, z: ARPHMMParams
                       ) -> ARPHMMParams:
    """sqrt(D(theta)) z: (z_pi, LRinv^-T z_D, tril(LRinv z_R) / sqrt 2)."""
    g_pi, g_LR = g._precondition_noise_block(params, z)
    return ARPHMMParams(logit_pi=g_pi, D=solve_upper(params.LRinv.mT, z.D),
                        LRinv_vec=g_LR)


def correction_term(params: ARPHMMParams) -> ARPHMMParams:
    """Gamma(theta): (m + 1) / 2 LRinv for the Cholesky factors."""
    return ARPHMMParams(
        logit_pi=torch.zeros_like(params.logit_pi),
        D=torch.zeros_like(params.D),
        LRinv_vec=0.5 * (params.m + 1) * params.LRinv_vec)


# --------------------------------------------------------------------------
# Blocked Gibbs: z | theta by FFBS, then the per-state
# matrix-normal-Wishart posterior of (D_k, R_k^-1) and the Dirichlet rows
# --------------------------------------------------------------------------

def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def gibbs_parameters_sample(generator, prior: ARPHMMPrior, observations,
                            z, draws: GibbsDraws | None = None
                            ) -> ARPHMMParams:
    """theta | z, y per chain for z [C, T] (``draws.normals`` [C, K, m,
    d])."""
    K, m, d = prior.mean_D.shape
    dt = observations.dtype
    dr = draws or GibbsDraws(None, None, None, None, None)
    zo, pi = g._gibbs_common(generator, prior.alpha_pi, z, K, dt, dr.gamma)
    y0 = observations[..., 0, :]                               # [T, m]
    x = observations[..., 1:, :].flatten(-2)                   # [T, d]
    n_k = zo.sum(-2)
    prec0 = 1.0 / prior.var_col_D                              # [K, d]

    def scatter(a, b):
        """sum_t zo_tk a_t b_t^T [C, K, i, j]."""
        ab = (a[..., :, None] * b[..., None, :]).flatten(-2)
        return (zo.mT @ ab).unflatten(-1, (a.shape[-1], b.shape[-1]))
    Spp = scatter(x, x) + torch.diag_embed(prec0)              # [C, K, d, d]
    Scp = scatter(y0, x) + prior.mean_D * prec0[:, None, :]    # [C, K, m, d]
    Scc = scatter(y0, y0) + (prior.mean_D * prec0[:, None, :]) \
        @ prior.mean_D.mT                                      # [C, K, m, m]
    Lpp = cholesky(Spp)
    D_post = solve_upper(Lpp.mT, _solve_lower(Lpp, Scp.mT)).mT
    schur = Scc - D_post @ Scp.mT
    schur = 0.5 * (schur + schur.mT)
    LRinv = g._wishart_block(generator, prior, n_k, schur, dr.r_chi2,
                             dr.r_off)
    zD = dr.normals
    if zD is None:
        zD = torch.randn((z.shape[0], K, m, d), generator=generator,
                         dtype=dt, device=observations.device)
    # D | R ~ MN(D_post, row covariance R, column covariance Spp^-1)
    noise = solve_upper(Lpp.mT, solve_upper(LRinv.mT, zD).mT).mT
    return ARPHMMParams(logit_pi=torch.log(pi + 1e-99), D=D_post + noise,
                        LRinv_vec=mat_to_tril_vector(LRinv))


def gibbs_step(generator, prior: ARPHMMPrior, params: ARPHMMParams,
               observations, forward_msg=None,
               draws: GibbsDraws | None = None) -> ARPHMMParams:
    """One blocked-Gibbs sweep of every chain over lag-stacked
    observations [T, p+1, m]."""
    z = latent_var_sample(params, generator, observations, forward_msg,
                          uniforms=None if draws is None else draws.ffbs)
    return gibbs_parameters_sample(generator, prior, observations, z, draws)


def generate_data(generator, params: ARPHMMParams, T: int, draws=None):
    """Simulate (lag-stacked observations [T, p+1, m], z [T]) from chain 0
    of ``params``: T + p steps from a zero history, the first p dropped.
    ``draws = (uniforms [T + p + 1], normals [T + p, m])`` replace the
    generator's (the Markov path as in ``gauss_hmm.generate_data``)."""
    p0 = params_map(lambda x: x[:1], params)
    m, p = p0.m, p0.p
    u, eps = (None, None) if draws is None else draws
    z = g._markov_path(generator, p0, T + p, u)
    dev = p0.D.device
    if eps is None:
        eps = torch.randn((T + p, m), generator=generator, dtype=p0.D.dtype,
                          device=dev)
    # the recursion on the host: T + p steps of [m, d] products
    D = p0.D[0].detach().cpu()
    L = cholesky(p0.R[0]).detach().cpu()
    zc, ec = z.cpu(), eps.detach().cpu()
    hist = torch.zeros((p, m), dtype=D.dtype)
    ys = []
    for t in range(T + p):
        k = int(zc[t])
        y = D[k] @ hist.reshape(-1) + L[k] @ ec[t]
        hist = torch.cat([y[None], hist[:-1]], 0)
        ys.append(y)
    ys = torch.stack(ys).to(dev)
    return stack_y(ys, p), z[p:]

