"""Gaussian hidden Markov model (GaussHMM), chain-batched port.

z_t ~ Markov(pi),   y_t | z_t = k ~ N(mu_k, R_k)

Counterpart of ``sgmcmc_tpu/models/gauss_hmm.py``: parameters in the same
coordinates (the transition logits, per-state means and packed Cholesky
factors of the precisions) with a leading chain axis, the emission
log-likelihoods, the exact discrete messages through ``ops/hmm.py`` (the
marginal likelihood, its closed-form gradient with or without SCIR's
Dirichlet statistic, the windowed estimators, the lagged marginals, FFBS,
the predictive likelihood), the complete-data score by autograd, the
prior, the projection, the SGRLD preconditioner, SCIR's transition update,
the conjugate Gibbs updates and data generation.  The family computes in
float64 (its parameters' dtype): SCIR's 1e-99 floor underflows in float32.

Random draws are inputs where a test holds them against the JAX package:
the FFBS and completion uniforms, the Dirichlet's unit gammas, the
Wishart's chi-squares and off-diagonal normals and the means' normals
(:class:`GibbsDraws`, :class:`PriorDraws`), SCIR's Poisson counts and
gammas.  ``parallel_marginal_loglikelihood`` is the full-data likelihood
in O(log T) depth (``ops/hmm.parallel_forward_messages``).

The exact surface of the family (everything but the emission, the
location block of the gradient, prior and Gibbs update, and data
generation) lives here once, as functions of the model's emission;
``arphmm.py`` binds them to its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import hmm
from ..utils.distributions import sample_wishart, wishart_logpdf
from ..utils.linalg import (cholesky, inv, mat_to_tril_vector, solve,
                            solve_upper, tril_vector_to_mat)
from ..utils.simplex import unit_gamma
from .base import params_map

_LOG_2PI = 1.8378770664093453
DTYPE = torch.float64


def _diag_index(m: int) -> list:
    """The diagonal's positions in a row-major packed lower triangle."""
    return [i * (i + 3) // 2 for i in range(m)]


def _tau(LRinv_vec, m: int):
    """1 / |diag LRinv| per state, [C, K, m] (abs, not torch.abs: the
    parameters of a saved trace have numpy leaves)."""
    return 1.0 / abs(LRinv_vec[..., _diag_index(m)])


@dataclasses.dataclass
class GaussHMMParams:
    """GaussHMM parameters of C chains (JAX package coordinates)."""
    logit_pi: torch.Tensor     # [C, K, K]
    mu: torch.Tensor           # [C, K, m]
    LRinv_vec: torch.Tensor    # [C, K, m(m+1)/2] chol(R_k^-1), packed

    @property
    def num_chains(self) -> int:
        return self.logit_pi.shape[0]

    @property
    def num_states(self) -> int:
        return self.logit_pi.shape[-1]

    @property
    def m(self) -> int:
        return self.mu.shape[-1]

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
        """The per-state emission scale 1 / |diag LRinv| (the natural
        coordinate of the experiments' metrics and KSD)."""
        return _tau(self.LRinv_vec, self.mu.shape[-1])

    def to(self, device) -> "GaussHMMParams":
        return params_map(lambda x: x.to(device), self)


def _packed_chol_inv(R):
    """Packed chol(R_k^-1) [K, d] of covariances R [K, m, m]."""
    L = np.linalg.cholesky(np.linalg.inv(R))
    rows, cols = np.tril_indices(L.shape[-1])
    return L[:, rows, cols]


def _leaf(x, dtype, device):
    return torch.as_tensor(np.asarray(x, np.float64)[None], dtype=dtype,
                           device=device)


def from_values(pi, mu, R, dtype=DTYPE, device=None) -> GaussHMMParams:
    """One chain's parameters from pi [K, K], mu [K, m] and R [K, m, m]
    (or one [m, m] for every state)."""
    pi = np.asarray(pi, np.float64)
    mu = np.atleast_2d(np.asarray(mu, np.float64))
    R = np.asarray(R, np.float64)
    if R.ndim == 2:
        R = np.repeat(R[None], pi.shape[0], axis=0)
    return GaussHMMParams(logit_pi=_leaf(np.log(pi + 1e-99), dtype, device),
                          mu=_leaf(mu, dtype, device),
                          LRinv_vec=_leaf(_packed_chol_inv(R), dtype, device))


def _from_jax(cls, p, dtype):
    """``cls`` parameters from a JAX parameter object with numpy (or
    array) leaves, one chain's or stacked over chains."""
    single = np.ndim(p.logit_pi) == 2

    def conv(x):
        a = np.array(x, dtype=np.float64)
        return torch.as_tensor(a[None] if single else a, dtype=dtype)
    return cls(**{f.name: conv(getattr(p, f.name))
                  for f in dataclasses.fields(cls)})


def params_from_jax(p, dtype=DTYPE) -> GaussHMMParams:
    """Port parameters from a JAX ``GaussHMMParams`` (``logit_pi [K, K]``
    for one chain or ``[C, K, K]`` stacked)."""
    return _from_jax(GaussHMMParams, p, dtype)


# --------------------------------------------------------------------------
# Emission log-likelihoods (the model-specific part of the exact surface)
# --------------------------------------------------------------------------

def _half_logdet(L):
    """sum log |diag L| [..., K] of Cholesky factors [..., K, m, m]."""
    return torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))).sum(-1)


def _gauss_logliks(diff, LR):
    """log N of residuals diff [..., T, K, m] under chol(R^-1) LR [..., K,
    m, m]: [..., T, K]."""
    m = diff.shape[-1]
    z = (diff[..., None, :] @ LR[..., None, :, :, :])[..., 0, :]
    return (-0.5 * m * _LOG_2PI + _half_logdet(LR)[..., None, :]
            - 0.5 * (z * z).sum(-1))


def _residuals(params: GaussHMMParams, observations):
    """y_t - mu_k [..., T, K, m] for observations [..., T, m] (shared by
    every chain when they have no chain axis)."""
    return observations[..., :, None, :] - params.mu[..., None, :, :]


def emission_logliks(params: GaussHMMParams, observations) -> torch.Tensor:
    """logP [..., T, K] = log N(y_t; mu_k, R_k)."""
    return _gauss_logliks(_residuals(params, observations), params.LRinv)


def default_forward_message(params) -> hmm.HMMMessage:
    return hmm.default_forward_message(params.num_states,
                                       params.logit_pi.dtype,
                                       params.logit_pi.device)


def default_backward_message(params) -> hmm.HMMMessage:
    return hmm.default_backward_message(params.num_states,
                                        params.logit_pi.dtype,
                                        params.logit_pi.device)


def _messages(params, forward_msg, backward_msg):
    return (forward_msg or default_forward_message(params),
            backward_msg or default_backward_message(params))


# --------------------------------------------------------------------------
# The family's exact surface, as functions of the emission
# --------------------------------------------------------------------------

def _marginal_loglikelihood(emission, params, observations, forward_msg=None,
                            backward_msg=None, weights=None, valid=None):
    fwd, bwd = _messages(params, forward_msg, backward_msg)
    return hmm.marginal_loglikelihood(emission(params, observations),
                                      params.pi, fwd, bwd, weights, valid)


def _parallel_marginal_loglikelihood(emission, params, observations,
                                     forward_msg=None, backward_msg=None):
    fwd, bwd = _messages(params, forward_msg, backward_msg)
    return hmm.parallel_marginal_loglikelihood(emission(params, observations),
                                               params.pi, fwd, bwd)


def _exact_statistics(params, logP, forward_msg, backward_msg, weights,
                      use_scir: bool, valid):
    """(gradient of logit_pi, or with ``use_scir`` the summed pairwise
    posteriors; the weighted singleton posteriors w_marg [..., T, K])."""
    T = logP.shape[-2]
    if weights is None:
        weights = torch.ones((T,), dtype=logP.dtype, device=logP.device)
    if valid is not None:
        weights = weights * valid
    fwd, bwd = _messages(params, forward_msg, backward_msg)
    pi = params.pi
    joint, marg = hmm.posterior_marginals(logP, pi, fwd, bwd, valid=valid)
    joint_sum = (weights[..., None, None] * joint).sum(-3)
    g_pi = joint_sum if use_scir else hmm.grad_logit_pi(joint_sum, pi)
    return g_pi, weights[..., None] * marg


def _noise_gradient(params, diff, w_marg):
    """The packed gradient of the Cholesky factors: (sum_t w_t R - sum_t
    w_t d d^T) LRinv per state, from residuals diff [..., T, K, m]."""
    sum_marg = w_marg.sum(-2)
    wd = diff * w_marg[..., None]
    outer = (diff[..., :, :, :, None] * wd[..., :, :, None, :]).sum(-4)
    g_LR = (sum_marg[..., None, None] * params.R - outer) @ params.LRinv
    return mat_to_tril_vector(g_LR)


def _windowed_marginal(emission, gradient, params, window, valid, weights,
                       B: int, S: int, use_scir: bool):
    """The buffered exact-gradient estimator over windows ``[R, B + S + B,
    ...]`` of R rows: the boundary messages over the buffers (rows masked
    by ``valid [R, W]`` pass through) from the default ones, then the
    weighted gradient and log-likelihood over the central S steps."""
    logP = emission(params, window)
    pi = params.pi
    fwd0, bwd0 = _messages(params, None, None)
    if B:
        fwd = hmm.last_message(hmm.forward_messages(
            logP[..., :B, :], pi, fwd0, valid=valid[..., :B]))
        bwd = hmm.first_message(hmm.backward_messages(
            logP[..., B + S:, :], pi, bwd0, valid=valid[..., B + S:]))
    else:
        fwd, bwd = fwd0, bwd0
    v_sub = valid[..., B:B + S]
    grad = gradient(params, window[:, B:B + S], fwd, bwd, weights,
                    use_scir=use_scir, valid=v_sub)
    loglik = hmm.marginal_loglikelihood(logP[..., B:B + S, :], pi, fwd, bwd,
                                        weights, valid=v_sub)
    return grad, loglik


def _predictive_loglikelihood(emission, params, observations, lag=1,
                              forward_msg=None):
    fwd, _ = _messages(params, forward_msg, None)
    return hmm.predictive_loglikelihood(emission(params, observations),
                                        params.pi, fwd, lag)


def _latent_var_distr(emission, params, observations, forward_msg=None,
                      backward_msg=None, lag=None):
    fwd, bwd = _messages(params, forward_msg, backward_msg)
    return hmm.latent_var_distr(emission(params, observations), params.pi,
                                fwd, bwd, lag=lag)


def _latent_var_sample(emission, params, generator, observations,
                       forward_msg=None, num_samples: int = 1,
                       distr: str = "joint", lag=None, backward_msg=None,
                       valid=None, uniforms=None):
    """z draws [C, T] (``[C, num_samples, T]`` for more than one):
    ``distr='joint'`` FFBS paths; ``'marginal'`` independent per-t draws
    from the (lagged) marginals.  ``uniforms [C, num_samples, T]`` (or
    ``[C, T]``) replace the generator's."""
    fwd, bwd = _messages(params, forward_msg, backward_msg)
    logP = emission(params, observations)
    S = num_samples
    if uniforms is None:
        uniforms = torch.rand(logP.shape[:-2] + (S, logP.shape[-2]),
                              generator=generator, dtype=logP.dtype,
                              device=logP.device)
    elif uniforms.dim() == logP.dim() - 1:
        uniforms = uniforms[..., None, :]
    if distr == "joint":
        if lag is not None:
            raise ValueError("Must set distr to 'marginal' for lag != None")
        z = hmm.latent_var_sample(
            logP[..., None, :, :], params.pi[..., None, :, :],
            hmm.HMMMessage(fwd.prob[..., None, :], fwd.log_constant),
            hmm.HMMMessage(bwd.prob[..., None, :], bwd.log_constant),
            valid=None if valid is None else valid[..., None, :],
            u=uniforms)
    else:
        if valid is not None:
            raise ValueError(
                "valid masking is only supported for distr='joint'")
        if distr != "marginal":
            raise ValueError(f"Unrecognized distr '{distr}'")
        probs = hmm.latent_var_distr(logP, params.pi, fwd, bwd, lag=lag)
        z = hmm.categorical_icdf(probs[..., None, :, :], uniforms)
    return z[..., 0, :] if S == 1 else z


def _log_transitions(log_pi, z_from, z_to):
    """log_pi[z_from, z_to] per batch entry, log_pi [..., K, K]."""
    K = log_pi.shape[-1]
    flat = log_pi.flatten(-2)
    idx = z_from * K + z_to
    return torch.gather(flat.expand(idx.shape[:-1] + flat.shape[-1:]), -1,
                        idx)


def _complete_data_loglikelihood(emission, params, observations, z,
                                 z_prev=None, weights=None):
    """log p(y, z | theta) [...] for z [..., T], differentiable in the
    parameters (one-hot emission selection, gathered log-transitions)."""
    T = z.shape[-1]
    logP = emission(params, observations)
    if weights is None:
        weights = torch.ones((T,), dtype=logP.dtype, device=logP.device)
    onehot = torch.nn.functional.one_hot(z, params.num_states).to(logP.dtype)
    total = (weights * (onehot * logP).sum(-1)).sum(-1)
    log_pi = torch.log(params.pi + 1e-32)
    total = total + (weights[..., 1:] * _log_transitions(
        log_pi, z[..., :-1], z[..., 1:])).sum(-1)
    if z_prev is not None:
        total = total + weights[..., 0] * _log_transitions(
            log_pi, z_prev[..., None], z[..., :1])[..., 0]
    return total


def _windowed_complete(emission, cls, params, window, valid, weights,
                       B: int, S: int, generator=None,
                       num_samples: int = 1, uniforms=None, completion=None,
                       z=None, z_init=None):
    """kind='complete' buffered estimator over the windows of
    :func:`_windowed_marginal`: FFBS z draws over each window, then the
    weighted complete-data score over the subsequence by autograd (the
    draws held fixed), averaged over ``num_samples`` draws.

    The state before the subsequence is the buffer's draw where that row
    is a real observation, else its exact completion z_prev | z_B ~
    p0[i] Pi[i, z_B], so that E[grad complete] = grad marginal at the
    edge windows too.  Draws: ``uniforms [R, K, W]`` (FFBS) and
    ``completion [R, K]``, K = ``num_samples``; or the paths themselves,
    ``z [R, K, W]`` and ``z_init [R, K]``."""
    K = num_samples
    fwd0, _ = _messages(params, None, None)
    with torch.no_grad():
        pi = params.pi
        if z is None:
            z = _latent_var_sample(emission, params, generator, window,
                                   num_samples=K, valid=valid,
                                   uniforms=uniforms)
            if K == 1:
                z = z[..., None, :]
        if z_init is None:
            if completion is None:
                completion = torch.rand(z.shape[:-1], generator=generator,
                                        dtype=pi.dtype, device=pi.device)
            col = torch.gather(pi.mT, -2, z[..., B, None].expand(
                z.shape[:-1] + (pi.shape[-1],)))          # Pi[:, z_B]
            z_init = hmm.categorical_icdf(fwd0.prob * col, completion)
        z_prev = z_init if B == 0 else torch.where(
            valid[..., B - 1, None] > 0, z[..., B - 1], z_init)
    leaves = [getattr(params, f.name).detach().requires_grad_()
              for f in dataclasses.fields(params)]
    with torch.enable_grad():
        p = cls(*[leaf[:, None] for leaf in leaves])       # draw axis
        ll = _complete_data_loglikelihood(
            emission, p, window[:, None, B:B + S], z[..., B:B + S], z_prev,
            weights[:, None, :]).mean(-1)                  # [R]
        grads = torch.autograd.grad(ll.sum(), leaves)
    return cls(*grads), ll.detach()


def _gibbs_common(generator, alpha_pi, z, K: int, dtype, gamma=None):
    """(one-hot z [C, T, K], the Dirichlet posterior draw of pi [C, K, K])
    of z [C, T]."""
    zo = torch.nn.functional.one_hot(z, K).to(dtype)
    counts = zo[..., :-1, :].mT @ zo[..., 1:, :]
    a = alpha_pi + counts
    g = unit_gamma(generator, a) if gamma is None else gamma
    return zo, g / g.sum(-1, keepdim=True)


def _wishart_block(generator, prior, n_k, schur, chi2=None, off=None):
    """chol(R_k^-1) [C, K, m, m] from the Wishart posterior with scatter
    ``schur`` [C, K, m, m] and counts ``n_k`` [C, K]."""
    scale_post = inv(inv(prior.scale_Rinv) + schur)
    Rinv = sample_wishart(generator, prior.df_Rinv + n_k, scale_post,
                          chi2=chi2, off=off)
    return cholesky(Rinv)


def _dirichlet_logprior(alpha, pi):
    lp = ((alpha - 1.0) * torch.log(pi + 1e-16)).sum((-2, -1))
    return lp + (torch.lgamma(alpha.sum(-1))
                 - torch.lgamma(alpha).sum(-1)).sum(-1)


def _tril_inv_t(L):
    """inv(L)^T of lower-triangular L [..., k, k]."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand(L.shape),
                                         upper=False).mT


def _wishart_grad(prior, LR):
    """(df - m - 1) inv(LR)^T - solve(scale, LR) per state, packed."""
    m = LR.shape[-1]
    return mat_to_tril_vector((prior.df_Rinv - m - 1) * _tril_inv_t(LR)
                              - solve(prior.scale_Rinv, LR))


def _abs_diag(LRinv_vec, m: int):
    """The packed factors with their diagonals made positive."""
    mask = torch.zeros(LRinv_vec.shape[-1], dtype=torch.bool,
                       device=LRinv_vec.device)
    mask[_diag_index(m)] = True
    return torch.where(mask, torch.abs(LRinv_vec), LRinv_vec)


def _center(logit_pi):
    return logit_pi - logit_pi.mean(-1, keepdim=True)


def _precondition_noise_block(params, z):
    """(logit noise, packed Cholesky noise sqrt(1/2) tril(LRinv z_R)) of
    the normals ``z`` (square z_R)."""
    LR = params.LRinv
    return z.logit_pi, mat_to_tril_vector(math.sqrt(0.5) * LR
                                          @ z.LRinv_vec)


def scir_transition_update(generator, params, a, epsilon: float, J=None,
                           gamma=None) -> torch.Tensor:
    """One SCIR step on the transition simplex in logit storage: theta =
    exp(logit_pi), the exact Gamma-process update with the Dirichlet
    statistic ``a``, the new centred logits."""
    theta = torch.exp(params.logit_pi)
    theta_new = hmm.scir_update(generator, theta, a, epsilon, J, gamma)
    return _center(torch.log(torch.abs(theta_new) + 1e-99))


def _categorical_path(pi_row_cdf, u):
    """A Markov path on the host: z_t = #{k: cdf[z_{t-1}, k] <= u_t}, z_0
    drawn from the uniform initial row (``u`` of T + 1 uniforms)."""
    K = pi_row_cdf.shape[-1]
    z_prev = min(int(u[0] * K), K - 1)
    zs = []
    for t in range(1, u.shape[0]):
        z_prev = min(int(np.searchsorted(pi_row_cdf[z_prev], u[t],
                                         side="right")), K - 1)
        zs.append(z_prev)
    return np.array(zs, np.int64)


def _markov_path(generator, params, T: int, uniforms=None):
    """z [T] of chain 0 from ``uniforms [T + 1]`` (the initial state's,
    then one a step; from ``generator`` if None), on the host."""
    pi = params.pi[0]
    if uniforms is None:
        uniforms = torch.rand((T + 1,), generator=generator, dtype=pi.dtype,
                              device=pi.device)
    cdf = np.cumsum(pi.detach().cpu().double().numpy(), -1)
    cdf /= cdf[:, -1:]
    return torch.from_numpy(_categorical_path(
        cdf, uniforms.detach().cpu().double().numpy())).to(pi.device)


# --------------------------------------------------------------------------
# The GaussHMM's public surface
# --------------------------------------------------------------------------

def marginal_loglikelihood(params: GaussHMMParams, observations,
                           forward_msg=None, backward_msg=None, weights=None,
                           valid=None) -> torch.Tensor:
    """Exact log p(y) per chain."""
    return _marginal_loglikelihood(emission_logliks, params, observations,
                                   forward_msg, backward_msg, weights, valid)


def parallel_marginal_loglikelihood(params: GaussHMMParams, observations,
                                    forward_msg=None, backward_msg=None
                                    ) -> torch.Tensor:
    """Exact log p(y) per chain by associative prefix products of the
    per-step transition-emission matrices, in O(log T) depth."""
    return _parallel_marginal_loglikelihood(emission_logliks, params,
                                            observations, forward_msg,
                                            backward_msg)


def gradient_marginal_loglikelihood(params: GaussHMMParams, observations,
                                    forward_msg=None, backward_msg=None,
                                    weights=None, use_scir: bool = False,
                                    valid=None) -> GaussHMMParams:
    """The exact gradient of log p(y) per chain; with ``use_scir`` the
    logit_pi slot carries the Dirichlet statistic sum_t w_t joint_t."""
    diff = _residuals(params, observations)
    logP = _gauss_logliks(diff, params.LRinv)
    g_pi, w_marg = _exact_statistics(params, logP, forward_msg, backward_msg,
                                     weights, use_scir, valid)
    s = (diff * w_marg[..., None]).sum(-3)                     # [..., K, m]
    g_mu = (params.Rinv @ s[..., None])[..., 0]
    return GaussHMMParams(logit_pi=g_pi, mu=g_mu,
                          LRinv_vec=_noise_gradient(params, diff, w_marg))


def predictive_loglikelihood(params: GaussHMMParams, observations, lag=1,
                             forward_msg=None) -> torch.Tensor:
    """Sum_t log p(y_t | y_{<= t-lag}) per chain."""
    return _predictive_loglikelihood(emission_logliks, params, observations,
                                     lag, forward_msg)


def windowed_marginal_gradient(params: GaussHMMParams, window, valid,
                               weights, B: int, S: int,
                               use_scir: bool = False):
    """The buffered exact-gradient estimator over windows ``[R, W, m]``:
    (gradient parameters, loglik [R])."""
    return _windowed_marginal(emission_logliks,
                              gradient_marginal_loglikelihood, params,
                              window, valid, weights, B, S, use_scir)


def latent_var_distr(params: GaussHMMParams, observations, lag=None,
                     forward_msg=None, backward_msg=None) -> torch.Tensor:
    """Pr(z_t | y_{<= t+lag}) [C, T, K]; smoothed for ``lag=None``."""
    return _latent_var_distr(emission_logliks, params, observations,
                             forward_msg, backward_msg, lag)


def latent_var_sample(params: GaussHMMParams, generator, observations,
                      forward_msg=None, num_samples: int = 1,
                      distr: str = "joint", lag=None, backward_msg=None,
                      valid=None, uniforms=None) -> torch.Tensor:
    """Posterior z draws per chain (see :func:`_latent_var_sample`)."""
    return _latent_var_sample(emission_logliks, params, generator,
                              observations, forward_msg, num_samples, distr,
                              lag, backward_msg, valid, uniforms)


def complete_data_loglikelihood(params: GaussHMMParams, observations, z,
                                z_prev=None, weights=None) -> torch.Tensor:
    """log p(y, z | theta) per batch entry."""
    return _complete_data_loglikelihood(emission_logliks, params,
                                        observations, z, z_prev, weights)


def windowed_complete_gradient(params: GaussHMMParams, window, valid,
                               weights, B: int, S: int, generator=None,
                               num_samples: int = 1, uniforms=None,
                               completion=None, z=None, z_init=None):
    """kind='complete' buffered estimator (see
    :func:`_windowed_complete`)."""
    return _windowed_complete(emission_logliks, GaussHMMParams, params,
                              window, valid, weights, B, S, generator,
                              num_samples, uniforms, completion, z, z_init)


# --------------------------------------------------------------------------
# Prior: Dirichlet(pi rows), Wishart(R_k^-1), Normal(mu_k | R_k)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GaussHMMPrior:
    alpha_pi: torch.Tensor     # (K, K)
    mean_mu: torch.Tensor      # (K, m)
    var_col_mu: torch.Tensor   # (K,)
    scale_Rinv: torch.Tensor   # (K, m, m)
    df_Rinv: torch.Tensor      # ()


def default_prior(num_states: int, m: int = 1, var: float = 100.0,
                  dtype=DTYPE, device=None) -> GaussHMMPrior:
    """The JAX package's default hyperparameters."""
    df = m + 1.0 + 1.0 / var

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)
    K = num_states
    return GaussHMMPrior(
        alpha_pi=full((K, K), 1.0 / var), mean_mu=full((K, m), 0.0),
        var_col_mu=full((K,), var),
        scale_Rinv=(torch.eye(m, dtype=dtype, device=device) / df).repeat(
            K, 1, 1),
        df_Rinv=full((), df))


def logprior(prior: GaussHMMPrior, params: GaussHMMParams) -> torch.Tensor:
    """log prior density [C]."""
    lp = _dirichlet_logprior(prior.alpha_pi, params.pi)
    Rinv = params.Rinv
    lp = lp + wishart_logpdf(Rinv, prior.df_Rinv, prior.scale_Rinv).sum(-1)
    diff = params.mu - prior.mean_mu
    quad = (diff * (Rinv @ diff[..., None])[..., 0]).sum(-1) \
        / prior.var_col_mu
    m = params.m
    return lp + (-0.5 * m * _LOG_2PI + _half_logdet(params.LRinv)
                 - 0.5 * m * torch.log(prior.var_col_mu) - 0.5 * quad).sum(-1)


def grad_logprior(prior: GaussHMMPrior, params: GaussHMMParams,
                  use_scir: bool = False) -> GaussHMMParams:
    """The prior's score with the JAX package's convention (the mean's
    prior treats R as constant); with ``use_scir`` the logit_pi slot is
    the Dirichlet's alpha."""
    if use_scir:
        g_pi = prior.alpha_pi.expand(params.logit_pi.shape)
    else:
        g_pi = hmm.dirichlet_grad_logit_pi(prior.alpha_pi, params.pi)
    g_mu = -(params.Rinv @ (params.mu - prior.mean_mu)[..., None])[..., 0] \
        / prior.var_col_mu[:, None]
    return GaussHMMParams(logit_pi=g_pi, mu=g_mu,
                          LRinv_vec=_wishart_grad(prior, params.LRinv))


class PriorDraws(NamedTuple):
    """The random draws of :func:`sample_prior` over C chains."""
    gamma: torch.Tensor         # [C, K, K] unit gammas of the Dirichlet
    r_chi2: torch.Tensor        # [C, K, m] Wishart chi-squares
    r_off: torch.Tensor         # [C, K, m(m-1)/2] Wishart off-diagonals
    normals: torch.Tensor       # [C, K, m] the means' normals


def sample_prior(prior: GaussHMMPrior, generator, num_chains: int = 1,
                 draws: PriorDraws | None = None) -> GaussHMMParams:
    """``num_chains`` independent prior draws; ``draws`` replace the
    generator's."""
    C = num_chains
    K, m = prior.mean_mu.shape
    d = draws or PriorDraws(None, None, None, None)
    alpha = prior.alpha_pi.expand(C, K, K)
    g = unit_gamma(generator, alpha) if d.gamma is None else d.gamma
    pi = g / g.sum(-1, keepdim=True)
    LRinv = cholesky(sample_wishart(generator, prior.df_Rinv,
                                    prior.scale_Rinv, (C, K), chi2=d.r_chi2,
                                    off=d.r_off))
    z = d.normals
    if z is None:
        z = torch.randn((C, K, m), generator=generator, dtype=LRinv.dtype,
                        device=LRinv.device)
    noise = solve_upper(LRinv.mT, z[..., None])[..., 0]
    mu = prior.mean_mu + torch.sqrt(prior.var_col_mu)[:, None] * noise
    return GaussHMMParams(logit_pi=torch.log(pi + 1e-99), mu=mu,
                          LRinv_vec=mat_to_tril_vector(LRinv))


def project_parameters(params: GaussHMMParams,
                       center_logit: bool = True) -> GaussHMMParams:
    """Centred logits (for stability) and positive Cholesky diagonals."""
    return GaussHMMParams(
        logit_pi=_center(params.logit_pi) if center_logit
        else params.logit_pi, mu=params.mu,
        LRinv_vec=_abs_diag(params.LRinv_vec, params.m))


# --------------------------------------------------------------------------
# SGRLD preconditioner
# --------------------------------------------------------------------------

def precondition(params: GaussHMMParams, grad: GaussHMMParams
                 ) -> GaussHMMParams:
    """D(theta) grad: (g_pi, R g_mu, tril(Rinv g_LR) / 2)."""
    return GaussHMMParams(
        logit_pi=grad.logit_pi, mu=(params.R @ grad.mu[..., None])[..., 0],
        LRinv_vec=mat_to_tril_vector(
            0.5 * params.Rinv @ tril_vector_to_mat(grad.LRinv_vec)))


def precondition_normals(generator, params: GaussHMMParams
                         ) -> GaussHMMParams:
    """The standard normals :func:`precondition_noise` takes: shaped like
    logit_pi and mu, and a full square [C, K, m, m] in the Cholesky
    field."""
    dt, dev = params.mu.dtype, params.mu.device
    C, K, m = params.mu.shape
    return GaussHMMParams(*[torch.randn(s, generator=generator, dtype=dt,
                                        device=dev)
                            for s in ((C, K, K), (C, K, m), (C, K, m, m))])


def precondition_noise(params: GaussHMMParams, z: GaussHMMParams
                       ) -> GaussHMMParams:
    """sqrt(D(theta)) z: (z_pi, LRinv^-T z_mu, tril(LRinv z_R) /
    sqrt 2)."""
    g_pi, g_LR = _precondition_noise_block(params, z)
    return GaussHMMParams(
        logit_pi=g_pi, mu=solve_upper(params.LRinv.mT, z.mu[..., None])[
            ..., 0], LRinv_vec=g_LR)


def correction_term(params: GaussHMMParams) -> GaussHMMParams:
    """Gamma(theta): (m + 1) / 2 LRinv for the Cholesky factors."""
    return GaussHMMParams(
        logit_pi=torch.zeros_like(params.logit_pi),
        mu=torch.zeros_like(params.mu),
        LRinv_vec=0.5 * (params.m + 1) * params.LRinv_vec)


# --------------------------------------------------------------------------
# Blocked Gibbs: z | theta by FFBS, then the conjugate theta | z, y
# --------------------------------------------------------------------------

class GibbsDraws(NamedTuple):
    """The random draws of one Gibbs sweep over C chains: the FFBS
    uniforms, the Dirichlet's unit gammas, the Wishart draws of R_k^-1
    (chi-square diagonals and off-diagonal normals, see
    :func:`~..utils.distributions.sample_wishart`) and the locations'
    normals (mu [C, K, m]; ARPHMM's D [C, K, m, d])."""
    ffbs: torch.Tensor | None       # [C, T]
    gamma: torch.Tensor             # [C, K, K]
    r_chi2: torch.Tensor            # [C, K, m]
    r_off: torch.Tensor             # [C, K, m(m-1)/2]
    normals: torch.Tensor           # the locations'


def gibbs_parameters_sample(generator, prior: GaussHMMPrior, observations,
                            z, draws: GibbsDraws | None = None
                            ) -> GaussHMMParams:
    """theta | z, y per chain for z [C, T]: the Dirichlet posterior of the
    pi rows and the normal-Wishart posterior of (mu_k, R_k^-1)."""
    K, m = prior.mean_mu.shape
    y = observations
    d = draws or GibbsDraws(None, None, None, None, None)
    zo, pi = _gibbs_common(generator, prior.alpha_pi, z, K, y.dtype, d.gamma)
    n_k = zo.sum(-2)                                       # [C, K]
    sum_y = zo.mT @ y                                      # [C, K, m]
    yy = (y[..., :, None] * y[..., None, :]).flatten(-2)   # [..., T, m*m]
    sum_yy = (zo.mT @ yy).unflatten(-1, (m, m))
    prec0 = 1.0 / prior.var_col_mu
    Spp = prec0 + n_k
    Scp = prior.mean_mu * prec0[:, None] + sum_y
    Scc = (prior.mean_mu[:, :, None]
           * (prior.mean_mu * prec0[:, None])[:, None, :]) + sum_yy
    mu_post = Scp / Spp[..., None]
    schur = Scc - Scp[..., :, None] * Scp[..., None, :] / Spp[..., None, None]
    LRinv = _wishart_block(generator, prior, n_k, schur, d.r_chi2, d.r_off)
    zm = d.normals
    if zm is None:
        zm = torch.randn((z.shape[0], K, m), generator=generator,
                         dtype=y.dtype, device=y.device)
    noise = solve_upper(LRinv.mT, zm[..., None])[..., 0] \
        / torch.sqrt(Spp)[..., None]
    return GaussHMMParams(logit_pi=torch.log(pi + 1e-99), mu=mu_post + noise,
                          LRinv_vec=mat_to_tril_vector(LRinv))


def gibbs_step(generator, prior: GaussHMMPrior, params: GaussHMMParams,
               observations, forward_msg=None,
               draws: GibbsDraws | None = None) -> GaussHMMParams:
    """One blocked-Gibbs sweep of every chain: z | theta by FFBS over the
    observations [T, m], then theta | z, y."""
    z = latent_var_sample(params, generator, observations, forward_msg,
                          uniforms=None if draws is None else draws.ffbs)
    return gibbs_parameters_sample(generator, prior, observations, z, draws)


def generate_data(generator, params: GaussHMMParams, T: int, draws=None):
    """Simulate (observations [T, m], z [T]) from chain 0 of ``params`` on
    the generator's device.  ``draws = (uniforms [T + 1], normals [T,
    m])`` replace the generator's: the Markov path draws z_t by the
    inverse CDF of its row (on the host), the initial state uniformly."""
    p = params_map(lambda x: x[:1], params)
    m = p.m
    u, eps = (None, None) if draws is None else draws
    z = _markov_path(generator, p, T, u)
    if eps is None:
        eps = torch.randn((T, m), generator=generator, dtype=p.mu.dtype,
                          device=p.mu.device)
    L = cholesky(p.R[0])                                   # [K, m, m]
    ys = p.mu[0][z] + (L[z] @ eps[..., None])[..., 0]
    return ys, z
