"""Switching linear dynamical system (SLDS), chain-batched port.

z_t ~ Markov(pi),   x_t = A_{z_t} x_{t-1} + N(0, Q_{z_t}),
y_t = C x_t + N(0, R)

Counterpart of ``sgmcmc_tpu/models/slds.py``: parameters in the same
coordinates (the transition logits, per-state A_k and packed Cholesky
factors of Q_k^-1, the shared C and packed chol(R^-1)) with a leading
chain axis; conditional message passing (x | z: a time-varying
information-form Kalman filter over the per-step matrices gathered along
z; z | x: the discrete messages of ``ops/hmm.py`` with the Gaussian
transition likelihoods as emissions); blocked Gibbs over (x, z, theta);
the complete-data likelihood and its score (autograd, as the JAX package
takes ``jax.grad``), the windowed complete-data pair of the SG-MCMC score,
the prior, the projection and data generation.  As in the JAX package
(and its reference) the marginal likelihood raises unless x or z is
given.  The model computes in float64: the complete likelihood's
``log(pi + 1e-99)`` underflows in float32.

Random draws are inputs where a test holds them against the JAX package
(:class:`SLDSDraws`): the x | z FFBS normals, the z | x FFBS uniforms,
the Dirichlet's unit gammas, the Wishart draws and the matrix-normal
normals.  The z | x draw is by the inverse CDF (``ops/hmm.py``), where
the JAX package draws Gumbel-max: the two are equal in law.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import hmm
from ..utils.distributions import sample_wishart, wishart_logpdf
from ..utils.linalg import (cholesky, inv, logdet, mat_to_tril_vector,
                            matmul, matvec, solve, solve_upper, solve_vec,
                            spectral_norm_projection, tril_vector_to_mat)
from ..utils.simplex import unit_gamma
from . import gauss_hmm as g
from .base import params_map

_LOG_2PI = g._LOG_2PI
DTYPE = torch.float64


@dataclasses.dataclass
class SLDSParams:
    """SLDS parameters of C chains (JAX package coordinates)."""
    logit_pi: torch.Tensor     # [C, K, K]
    A: torch.Tensor            # [C, K, n, n]
    LQinv_vec: torch.Tensor    # [C, K, n(n+1)/2] chol(Q_k^-1), packed
    C: torch.Tensor            # [C, m, n]
    LRinv_vec: torch.Tensor    # [C, m(m+1)/2] chol(R^-1), packed

    @property
    def num_chains(self) -> int:
        return self.logit_pi.shape[0]

    @property
    def num_states(self) -> int:
        return self.logit_pi.shape[-1]

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.C.shape[-2]

    @property
    def pi(self):
        return torch.softmax(self.logit_pi, -1)

    @property
    def LQinv(self):
        return tril_vector_to_mat(self.LQinv_vec)

    @property
    def Qinv(self):
        L = self.LQinv
        return L @ L.mT

    @property
    def Q(self):
        return inv(self.Qinv)

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
    def sigma(self):
        """The per-state latent scale 1 / |diag LQinv_k| [C, K, n] (the
        experiments' natural coordinate; abs, not torch.abs: a saved
        trace's parameters have numpy leaves)."""
        return 1.0 / abs(self.LQinv_vec[..., g._diag_index(self.n)])

    @property
    def tau(self):
        """The emission scale 1 / |diag LRinv| [C, m]."""
        return 1.0 / abs(self.LRinv_vec[..., g._diag_index(self.m)])

    def to(self, device) -> "SLDSParams":
        return params_map(lambda x: x.to(device), self)


def _packed_chol_inv(M):
    """Packed chol(M^-1) [..., d] of covariances M [..., k, k]."""
    L = np.linalg.cholesky(np.linalg.inv(M))
    rows, cols = np.tril_indices(L.shape[-1])
    return L[..., rows, cols]


def from_values(pi, A, Q, C, R, dtype=DTYPE, device=None) -> SLDSParams:
    """One chain's parameters from pi [K, K], A [K, n, n], Q [K, n, n], C
    [m, n] and R [m, m]."""
    def leaf(x):
        return g._leaf(x, dtype, device)
    pi = np.asarray(pi, np.float64)
    return SLDSParams(
        logit_pi=leaf(np.log(pi + 1e-99)), A=leaf(A),
        LQinv_vec=leaf(_packed_chol_inv(np.asarray(Q, np.float64))),
        C=leaf(np.atleast_2d(np.asarray(C, np.float64))),
        LRinv_vec=leaf(_packed_chol_inv(np.atleast_2d(np.asarray(
            R, np.float64)))))


def params_from_jax(p, dtype=DTYPE) -> SLDSParams:
    """Port parameters from a JAX ``SLDSParams`` with numpy (or array)
    leaves, one chain's (``logit_pi [K, K]``) or stacked over chains."""
    return g._from_jax(SLDSParams, p, dtype)


# --------------------------------------------------------------------------
# x | z: a time-varying information-form Kalman filter
# --------------------------------------------------------------------------

def _x_step_mats(params: SLDSParams, z):
    """The per-step transition matrices gathered along the z path ``[C,
    T]``: (A_t, Qinv_t, A_tᵀ Qinv_t, A_tᵀ Qinv_t A_t), each [C, T, n, n]."""
    idx = z[..., None, None]
    A_t = torch.take_along_dim(params.A, idx, dim=-3)
    Qinv_t = torch.take_along_dim(params.Qinv, idx, dim=-3)
    AtQinv_t = matmul(A_t.mT, Qinv_t)
    return A_t, Qinv_t, AtQinv_t, matmul(AtQinv_t, A_t)


def _x_filter(params: SLDSParams, observations, mats, log_constants: bool):
    """The filter of :func:`x_forward_messages` over the step matrices
    ``mats`` of :func:`_x_step_mats`; without ``log_constants`` it skips
    the predictive likelihoods (most of a step's operations), which the
    FFBS draw does not read."""
    T = observations.shape[-2]
    n, m = params.n, params.m
    dt, dev = params.A.dtype, params.A.device
    Rinv, C = params.Rinv, params.C
    CtRinv = matmul(C.mT, Rinv)
    CtRinvC = matmul(CtRinv, C)
    # the prior message N(0, 10 I)
    h = torch.zeros((n,), dtype=dt, device=dev)
    J = torch.eye(n, dtype=dt, device=dev) * 0.1
    _, Qinv_t, AtQinv_t, AtQinvA_t = mats
    # the observations' information Cᵀ R⁻¹ y_t of every step at once
    CtRinv_y = matvec(CtRinv[..., None, :, :], observations)
    log_cs, hs, Js = [], [], []
    for t in range(T):
        Qinv, AtQinv = Qinv_t[..., t, :, :], AtQinv_t[..., t, :, :]
        K = solve(AtQinvA_t[..., t, :, :] + J, AtQinv)
        h_pred = matvec(K.mT, h)
        J_pred = Qinv - matmul(AtQinv.mT, K)
        if log_constants:
            y_mean = matvec(C, solve_vec(J_pred, h_pred))
            y_prec = Rinv - matmul(CtRinv.mT,
                                   solve(CtRinvC + J_pred, CtRinv))
            diff = observations[..., t, :] - y_mean
            log_cs.append(-0.5 * (diff * matvec(y_prec, diff)).sum(-1)
                          + 0.5 * logdet(y_prec) - 0.5 * m * _LOG_2PI)
        h = h_pred + CtRinv_y[..., t, :]
        J = J_pred + CtRinvC
        hs.append(h)
        Js.append(J)
    return (torch.stack(log_cs, -1) if log_constants else None,
            torch.stack(hs, -2), torch.stack(Js, -3))


def x_forward_messages(params: SLDSParams, observations, z):
    """The filtered messages p(x_t | y_{<=t}, z) of every chain: (log_cs
    [C, T], hs [C, T, n], Js [C, T, n, n]), from the prior message
    (h, J) = (0, 0.1 I).  ``observations`` are ``[T, m]`` (or one series a
    chain, ``[C, T, m]``) and ``z`` the paths ``[C, T]``."""
    return _x_filter(params, observations, _x_step_mats(params, z), True)


def x_marginal_loglikelihood(params: SLDSParams, observations, z):
    """log p(y | z, theta) per chain."""
    return x_forward_messages(params, observations, z)[0].sum(-1)


def x_latent_var_sample(params: SLDSParams, generator, observations, z,
                        normals=None):
    """FFBS draws of x | y, z per chain, [C, T, n].  ``normals [C, T, n]``
    replace the generator's: row T-1 draws the last state, row t < T-1 the
    step x_t | x_{t+1}, which conditions on transition t+1's matrices."""
    T = observations.shape[-2]
    mats = _x_step_mats(params, z)
    _, hs, Js = _x_filter(params, observations, mats, False)
    _, _, AtQinv_t, AtQinvA_t = mats
    if normals is None:
        normals = torch.randn(hs.shape, generator=generator, dtype=hs.dtype,
                              device=hs.device)
    # the precisions of x_t | x_{t+1}, y (the last state's: its filtered
    # one), their factors and the draws' noise, every step at once
    J = torch.cat([Js[..., :-1, :, :] + AtQinvA_t[..., 1:, :, :],
                   Js[..., -1:, :, :]], -3)
    noise = solve_upper(cholesky(J).mT, normals[..., None])[..., 0]
    x = solve_vec(J[..., -1, :, :], hs[..., -1, :]) + noise[..., -1, :]
    xs = [x]
    for t in range(T - 2, -1, -1):
        x = solve_vec(J[..., t, :, :], hs[..., t, :] + matvec(
            AtQinv_t[..., t + 1, :, :], x)) + noise[..., t, :]
        xs.append(x)
    return torch.stack(xs[::-1], -2)


# --------------------------------------------------------------------------
# z | x: discrete messages with the Gaussian transitions as emissions
# --------------------------------------------------------------------------

def ar_logliks(params: SLDSParams, x) -> torch.Tensor:
    """logP [C, T, K] = log N(x_t; A_k x_{t-1}, Q_k); row 0 is a flat zero
    pseudo-likelihood (the initial state's transition is not scored)."""
    A = params.A[..., None, :, :, :]                    # [C, 1, K, n, n]
    mean = matvec(A, x[..., :-1, None, :])              # [C, T-1, K, n]
    diff = x[..., 1:, None, :] - mean
    LQ = params.LQinv
    zq = matvec(LQ.mT[..., None, :, :, :], diff)
    ll = (-0.5 * params.n * _LOG_2PI + g._half_logdet(LQ)[..., None, :]
          - 0.5 * (zq * zq).sum(-1))
    return torch.cat([torch.zeros_like(ll[..., :1, :]), ll], -2)


def _emission_logliks(params: SLDSParams, observations, x):
    """log N(y_t; C x_t, R) [C, T]."""
    diff = observations - matvec(params.C[..., None, :, :], x)
    LR = params.LRinv
    zr = matvec(LR.mT[..., None, :, :], diff)
    return (-0.5 * params.m * _LOG_2PI + g._half_logdet(LR)[..., None]
            - 0.5 * (zr * zr).sum(-1))


def _discrete_messages(params: SLDSParams):
    K, dt, dev = params.num_states, params.A.dtype, params.A.device
    return (hmm.default_forward_message(K, dt, dev),
            hmm.default_backward_message(K, dt, dev))


def z_marginal_loglikelihood(params: SLDSParams, observations, x):
    """log p(x | theta) with z summed out, plus the y | x emission terms,
    per chain."""
    fwd0, bwd0 = _discrete_messages(params)
    ll = hmm.marginal_loglikelihood(ar_logliks(params, x), params.pi, fwd0,
                                    bwd0)
    return ll + _emission_logliks(params, observations, x).sum(-1)


def z_latent_var_sample(params: SLDSParams, generator, observations, x,
                        uniforms=None):
    """FFBS draws of z | x per chain, [C, T] (int64), by the inverse CDF
    of ``uniforms [C, T]`` (from the generator if None)."""
    fwd0, bwd0 = _discrete_messages(params)
    return hmm.latent_var_sample(ar_logliks(params, x), params.pi, fwd0,
                                 bwd0, u=uniforms, generator=generator)


# --------------------------------------------------------------------------
# Likelihoods and scores
# --------------------------------------------------------------------------

def marginal_loglikelihood(params: SLDSParams, observations, x=None,
                           z=None):
    """The conditional marginals only: log p(y | z) given z, log p(y, x)
    with z summed out given x."""
    if z is not None:
        return x_marginal_loglikelihood(params, observations, z)
    if x is not None:
        return z_marginal_loglikelihood(params, observations, x)
    raise NotImplementedError(
        "SLDS marginal likelihood requires conditioning on x or z")


def _transition_logliks(params: SLDSParams, x, z):
    """(log pi[z_{t-1}, z_t], log N(x_t; A_{z_t} x_{t-1}, Q_{z_t})) of the
    steps t >= 1, each [C, T-1]."""
    log_pi = torch.log(params.pi + 1e-99)
    trans_z = g._log_transitions(log_pi, z[..., :-1], z[..., 1:])
    trans_x = torch.gather(ar_logliks(params, x)[..., 1:, :], -1,
                           z[..., 1:, None])[..., 0]
    return trans_z, trans_x


def complete_data_loglikelihood(params: SLDSParams, observations, x, z):
    """log p(y, x, z | theta) per chain (the initial state's terms
    excluded, as in the JAX package)."""
    trans_z, trans_x = _transition_logliks(params, x, z)
    return (trans_z.sum(-1) + trans_x.sum(-1)
            + _emission_logliks(params, observations, x).sum(-1))


def windowed_complete_data_loglikelihood(params: SLDSParams, window, x, z,
                                         step_weights) -> torch.Tensor:
    """The per-step weighted complete-data log-likelihood over buffered
    windows ``[C, W, m]`` per chain: step t carries its emission term and
    its (t-1 -> t) transition terms weighted by ``step_weights [C, W]``
    (the subsequence weights, zero on the buffers); step 0 carries no
    transition term."""
    trans_z, trans_x = _transition_logliks(params, x, z)
    trans = torch.cat([torch.zeros_like(trans_z[..., :1]),
                       trans_z + trans_x], -1)
    return (step_weights * (trans + _emission_logliks(params, window, x))
            ).sum(-1)


def _value_and_grad(fn, params: SLDSParams):
    """(fn(params) [C] detached, its gradient per chain as SLDSParams) by
    autograd on detached copies of the leaves."""
    leaves = [getattr(params, f.name).detach().requires_grad_()
              for f in dataclasses.fields(SLDSParams)]
    with torch.enable_grad():
        value = fn(SLDSParams(*leaves))
        grads = torch.autograd.grad(value.sum(), leaves)
    return value.detach(), SLDSParams(*grads)


def gradient_complete_data_loglikelihood(params: SLDSParams, observations,
                                         x, z) -> SLDSParams:
    """The complete-data score per chain (autograd of the closed form)."""
    return _value_and_grad(lambda p: complete_data_loglikelihood(
        p, observations, x, z), params)[1]


def windowed_complete_gradient(params: SLDSParams, window, x, z,
                               step_weights):
    """(gradient parameters, weighted log-likelihood [C]) of one buffered
    window per chain given the latent draws (x, z) on it."""
    ll, grad = _value_and_grad(lambda p: windowed_complete_data_loglikelihood(
        p, window, x, z, step_weights), params)
    return grad, ll


# --------------------------------------------------------------------------
# Prior: Dirichlet(pi rows), matrix-normal-Wishart (A_k, Q_k^-1) and (C,
# R^-1)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SLDSPrior:
    alpha_pi: torch.Tensor     # (K, K)
    mean_A: torch.Tensor       # (K, n, n)
    var_col_A: torch.Tensor    # (K, n)
    scale_Qinv: torch.Tensor   # (K, n, n)
    df_Qinv: torch.Tensor      # ()
    mean_C: torch.Tensor       # (m, n)
    var_col_C: torch.Tensor    # (n,)
    scale_Rinv: torch.Tensor   # (m, m)
    df_Rinv: torch.Tensor      # ()


def default_prior(num_states: int, n: int = 1, m: int = 1,
                  var: float = 100.0, dtype=DTYPE, device=None) -> SLDSPrior:
    """The JAX package's default hyperparameters."""
    df_q = n + 1.0 + 1.0 / var
    df_r = m + 1.0 + 1.0 / var
    K = num_states

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    def eye(k):
        return torch.eye(k, dtype=dtype, device=device)
    return SLDSPrior(
        alpha_pi=full((K, K), 1.0 / var), mean_A=full((K, n, n), 0.0),
        var_col_A=full((K, n), var),
        scale_Qinv=(eye(n) / df_q).repeat(K, 1, 1), df_Qinv=full((), df_q),
        mean_C=full((m, n), 0.0), var_col_C=full((n,), var),
        scale_Rinv=eye(m) / df_r, df_Rinv=full((), df_r))


def prior_from_jax(prior, dtype=DTYPE, device=None) -> SLDSPrior:
    """Port hyperparameters from a JAX ``SLDSPrior`` (numpy leaves)."""
    return SLDSPrior(**{f.name: torch.as_tensor(
        np.asarray(getattr(prior, f.name), np.float64), dtype=dtype,
        device=device) for f in dataclasses.fields(SLDSPrior)})


def _diag_quad(diff, prec, var_col):
    """sum_j (diffᵀ prec diff)_jj / var_col_j [...] (a matrix-normal's
    quadratic form with a diagonal column covariance)."""
    M = matmul(matmul(diff.mT, prec), diff)
    return (torch.diagonal(M, dim1=-2, dim2=-1) / var_col).sum(-1)


def logprior(prior: SLDSPrior, params: SLDSParams) -> torch.Tensor:
    """log prior density [C]: Dirichlet rows of pi, Wishart Q_k^-1 and
    A_k | Q_k ~ MN(mean_A, Q_k, diag(var_col_A)), Wishart R^-1 and C | R ~
    MN(mean_C, R, diag(var_col_C))."""
    K, n = prior.mean_A.shape[0], prior.mean_A.shape[-1]
    m = prior.mean_C.shape[0]
    lp = g._dirichlet_logprior(prior.alpha_pi, params.pi)
    Qinv, Rinv = params.Qinv, params.Rinv
    lp = lp + wishart_logpdf(Qinv, prior.df_Qinv, prior.scale_Qinv).sum(-1)
    lp = lp + wishart_logpdf(Rinv, prior.df_Rinv, prior.scale_Rinv)
    quad_a = _diag_quad(params.A - prior.mean_A, Qinv,
                        prior.var_col_A).sum(-1)
    lp = lp + (n * g._half_logdet(params.LQinv).sum(-1)
               - 0.5 * n * torch.log(prior.var_col_A).sum()
               - 0.5 * n * n * K * _LOG_2PI - 0.5 * quad_a)
    quad_c = _diag_quad(params.C - prior.mean_C, Rinv, prior.var_col_C)
    return lp + (n * g._half_logdet(params.LRinv)
                 - 0.5 * m * torch.log(prior.var_col_C).sum()
                 - 0.5 * m * n * _LOG_2PI - 0.5 * quad_c)


def grad_logprior(prior: SLDSPrior, params: SLDSParams) -> SLDSParams:
    """The prior's score in the stored coordinates (autograd)."""
    return _value_and_grad(lambda p: logprior(prior, p), params)[1]


class SLDSDraws(NamedTuple):
    """The random draws of a prior draw, a conjugate theta update and a
    Gibbs sweep over C chains: the Dirichlet's unit gammas, the Wishart
    draws of Q_k^-1 and R^-1 (chi-square diagonals and off-diagonal
    normals, see :func:`~..utils.distributions.sample_wishart`), the
    matrix-normal normals of A_k and C, and the sweep's x | z FFBS normals
    and z | x FFBS uniforms.  A missing field comes from the generator."""
    gamma: torch.Tensor | None = None        # [C, K, K]
    q_chi2: torch.Tensor | None = None       # [C, K, n]
    q_off: torch.Tensor | None = None        # [C, K, n(n-1)/2]
    a_normals: torch.Tensor | None = None    # [C, K, n, n]
    r_chi2: torch.Tensor | None = None       # [C, m]
    r_off: torch.Tensor | None = None        # [C, m(m-1)/2]
    c_normals: torch.Tensor | None = None    # [C, m, n]
    x_normals: torch.Tensor | None = None    # [C, T, n]
    z_uniforms: torch.Tensor | None = None   # [C, T]


def _normals(generator, shape, like, given):
    if given is not None:
        return given
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def sample_prior(prior: SLDSPrior, generator, num_chains: int = 1,
                 draws: SLDSDraws | None = None) -> SLDSParams:
    """``num_chains`` independent prior draws; ``draws`` replace the
    generator's."""
    C = num_chains
    K, n = prior.mean_A.shape[0], prior.mean_A.shape[-1]
    m = prior.mean_C.shape[0]
    d = draws or SLDSDraws()
    gam = (unit_gamma(generator, prior.alpha_pi.expand(C, K, K))
           if d.gamma is None else d.gamma)
    pi = gam / gam.sum(-1, keepdim=True)
    LQinv = cholesky(sample_wishart(generator, prior.df_Qinv,
                                    prior.scale_Qinv, (C, K), chi2=d.q_chi2,
                                    off=d.q_off))
    zA = _normals(generator, (C, K, n, n), LQinv, d.a_normals)
    A = prior.mean_A + solve_upper(LQinv.mT, zA) * torch.sqrt(
        prior.var_col_A)[:, None, :]
    LRinv = cholesky(sample_wishart(generator, prior.df_Rinv,
                                    prior.scale_Rinv, (C,), chi2=d.r_chi2,
                                    off=d.r_off))
    zC = _normals(generator, (C, m, n), LRinv, d.c_normals)
    Cm = prior.mean_C + solve_upper(LRinv.mT, zC) * torch.sqrt(
        prior.var_col_C)
    return SLDSParams(logit_pi=torch.log(pi + 1e-99), A=A,
                      LQinv_vec=mat_to_tril_vector(LQinv), C=Cm,
                      LRinv_vec=mat_to_tril_vector(LRinv))


def project_parameters(params: SLDSParams, a_threshold: float = 0.9999,
                       fix_C_eye: bool = True) -> SLDSParams:
    """Centred logits, each A_k of spectral norm <= ``a_threshold`` (a
    clip at n = 1), positive Cholesky diagonals and, by default, the C = I
    identifiability constraint."""
    C = params.C
    if fix_C_eye:
        C = torch.eye(params.m, params.n, dtype=C.dtype,
                      device=C.device).expand(C.shape).contiguous()
    return SLDSParams(
        logit_pi=g._center(params.logit_pi),
        A=spectral_norm_projection(params.A, a_threshold),
        LQinv_vec=g._abs_diag(params.LQinv_vec, params.n), C=C,
        LRinv_vec=g._abs_diag(params.LRinv_vec, params.m))


# --------------------------------------------------------------------------
# Blocked Gibbs: x | z, theta by FFBS; z | x, theta by FFBS; theta | x, z
# --------------------------------------------------------------------------

def _mniw_posterior(Spp, Scp, Scc, count, mean_M, var_col, scale_Vinv,
                    df_Vinv):
    """The matrix-normal-Wishart conjugate update: (df_post, scale_post,
    M_mean, Spp_post), the posterior of Vinv being W(df_post, scale_post)
    and M | V ~ MN(M_mean, V, inv(Spp_post))."""
    Spp = torch.diag_embed(1.0 / var_col) + Spp
    Mv = mean_M / var_col[..., None, :]
    Scp = Mv + Scp
    Scc = matmul(Mv, mean_M.mT) + Scc
    S_schur = Scc - matmul(Scp, solve(Spp, Scp.mT))
    scale_post = inv(inv(scale_Vinv) + S_schur)
    M_mean = solve(Spp, Scp.mT).mT
    return df_Vinv + count, scale_post, M_mean, Spp


def _mniw_sample(generator, Spp, Scp, Scc, count, mean_M, var_col,
                 scale_Vinv, df_Vinv, chi2=None, off=None, normals=None):
    """(Vinv, M) from the matrix-normal-Wishart posterior; the draws
    (Wishart ``chi2``, ``off``; matrix-normal ``normals`` shaped like M)
    replace the generator's."""
    df_post, scale_post, M_mean, Spp_post = _mniw_posterior(
        Spp, Scp, Scc, count, mean_M, var_col, scale_Vinv, df_Vinv)
    Vinv = sample_wishart(generator, df_post, scale_post, chi2=chi2, off=off)
    L_col = cholesky(inv(Spp_post))
    Z = _normals(generator, M_mean.shape, M_mean, normals)
    M = M_mean + matmul(solve_upper(cholesky(Vinv).mT, Z), L_col.mT)
    return Vinv, M


def _scatter(w, u, v):
    """sum_t w[t, k] u_t v_tᵀ [..., K, a, b] of w [..., T, K], u [..., T,
    a] and v [..., T, b]."""
    outer = (u[..., :, None] * v[..., None, :]).flatten(-2)
    return (w.mT @ outer).unflatten(-1, (u.shape[-1], v.shape[-1]))


def _gibbs_sufficient_stats(observations, x, z, K: int):
    """(pi counts, per-state transition statistics (Spp, Scp, Scc, n_k),
    emission statistics (Spp, Scp, Scc)) of the conjugate blocks.  As in
    the JAX package, the Q_k counts are the transitions into state k,
    sum(z[1:] == k) (the reference also counts z_0's state)."""
    zo = torch.nn.functional.one_hot(z, K).to(x.dtype)
    counts = zo[..., :-1, :].mT @ zo[..., 1:, :]
    w = zo[..., 1:, :]
    xp, xc = x[..., :-1, :], x[..., 1:, :]
    y = observations
    return counts, (_scatter(w, xp, xp), _scatter(w, xc, xp),
                    _scatter(w, xc, xc), w.sum(-2)), \
        (x.mT @ x, y.mT @ x, y.mT @ y)


def gibbs_posterior_params(prior: SLDSPrior, observations, x, z) -> dict:
    """The conjugate posterior hyperparameters of theta | x, z, y per
    chain (what the Gibbs update draws from): 'alpha_pi' [C, K, K], per
    state 'df_Q' / 'scale_Q' / 'mean_A' / 'Spp_A', and 'df_R' / 'scale_R'
    / 'mean_C' / 'Spp_C'."""
    counts, (Spp, Scp, Scc, n_k), (Spp_y, Scp_y, Scc_y) = \
        _gibbs_sufficient_stats(observations, x, z, prior.alpha_pi.shape[0])
    df_q, scale_q, mean_a, spp_a = _mniw_posterior(
        Spp, Scp, Scc, n_k, prior.mean_A, prior.var_col_A, prior.scale_Qinv,
        prior.df_Qinv)
    df_r, scale_r, mean_c, spp_c = _mniw_posterior(
        Spp_y, Scp_y, Scc_y, observations.shape[-2], prior.mean_C,
        prior.var_col_C, prior.scale_Rinv, prior.df_Rinv)
    return dict(alpha_pi=prior.alpha_pi + counts, df_Q=df_q, scale_Q=scale_q,
                mean_A=mean_a, Spp_A=spp_a, df_R=df_r, scale_R=scale_r,
                mean_C=mean_c, Spp_C=spp_c)


def gibbs_parameters_sample(generator, prior: SLDSPrior, observations, x, z,
                            draws: SLDSDraws | None = None) -> SLDSParams:
    """theta | x, z, y per chain: the Dirichlet rows of pi, each state's
    (A_k, Q_k^-1) from the transitions into it and the shared (C, R^-1)
    from every emission."""
    d = draws or SLDSDraws()
    counts, (Spp, Scp, Scc, n_k), (Spp_y, Scp_y, Scc_y) = \
        _gibbs_sufficient_stats(observations, x, z, prior.alpha_pi.shape[0])
    a = prior.alpha_pi + counts
    gam = unit_gamma(generator, a) if d.gamma is None else d.gamma
    pi = gam / gam.sum(-1, keepdim=True)
    Qinv, A = _mniw_sample(generator, Spp, Scp, Scc, n_k, prior.mean_A,
                           prior.var_col_A, prior.scale_Qinv, prior.df_Qinv,
                           d.q_chi2, d.q_off, d.a_normals)
    Rinv, Cm = _mniw_sample(generator, Spp_y, Scp_y, Scc_y,
                            observations.shape[-2], prior.mean_C,
                            prior.var_col_C, prior.scale_Rinv, prior.df_Rinv,
                            d.r_chi2, d.r_off, d.c_normals)
    return SLDSParams(logit_pi=torch.log(pi + 1e-99), A=A,
                      LQinv_vec=mat_to_tril_vector(cholesky(Qinv)), C=Cm,
                      LRinv_vec=mat_to_tril_vector(cholesky(Rinv)))


def gibbs_step(generator, prior: SLDSPrior, params: SLDSParams, observations,
               x, z, draws: SLDSDraws | None = None):
    """One blocked sweep of every chain: x | z, theta, then z | x, theta,
    then theta | x, z.  Returns (params, x [C, T, n], z [C, T])."""
    d = draws or SLDSDraws()
    x = x_latent_var_sample(params, generator, observations, z, d.x_normals)
    z = z_latent_var_sample(params, generator, observations, x,
                            d.z_uniforms)
    return (gibbs_parameters_sample(generator, prior, observations, x, z, d),
            x, z)


def generate_data(generator, params: SLDSParams, T: int, draws=None):
    """Simulate (y [T, m], x [T, n], z [T]) from chain 0 of ``params`` on
    its device, x_0 = 0 before the first step.  ``draws = (uniforms [T +
    1], eps_x [T, n], eps_y [T, m])`` replace the generator's: the z path
    draws by the inverse CDF of its row (on the host), the initial state
    uniformly."""
    p = params_map(lambda v: v[:1], params)
    n, m = p.n, p.m
    u, eps_x, eps_y = (None, None, None) if draws is None else draws
    z = g._markov_path(generator, p, T, u)
    dt, dev = p.A.dtype, p.A.device
    eps_x = _normals(generator, (T, n), p.A, eps_x)
    eps_y = _normals(generator, (T, m), p.A, eps_y)
    A_t = p.A[0][z].cpu()
    noise = matvec(cholesky(p.Q[0])[z], eps_x).cpu()
    # the recursion on the host: T steps of an n x n product
    x_prev = torch.zeros((n,), dtype=dt)
    xs = []
    for t in range(T):
        x_prev = A_t[t] @ x_prev + noise[t]
        xs.append(x_prev)
    xs = torch.stack(xs).to(dev)
    ys = matvec(p.C[0], xs) + matvec(cholesky(p.R[0]), eps_y)
    return ys, xs, z
