"""Linear-Gaussian state-space model (LGSSM), chain-batched port.

x_t = A x_{t-1} + N(0, Q),   y_t = C x_t + N(0, R),   x in R^n, y in R^m.

Counterpart of ``sgmcmc_tpu/models/lgssm.py``: parameters in the same
coordinates (A, C, packed Cholesky of the precisions LQinv_vec /
LRinv_vec) with a leading chain axis, the prior and locally optimal
particle kernels, the Fisher-identity and sufficient statistics, the
prior, its partial-prior gradient and the projection, the fused-window
bodies (plain PyTorch here, CUDA in ``csrc/lgssm_body.cuh``; the scalar
model only, as in the JAX package), the exact Kalman oracle in float64
through ``ops/kalman.py``, the windowed marginal and complete-data
gradients, the latent draws and moments, the conjugate Gibbs updates, the
SGRLD preconditioner, data generation and the predict surface: the exact
observation moments and draws, prior simulation, and the particle
filter's moment maps and k-step predictive statistic.

Every function is general in n and m.  The scalar model (n = m = 1, the
configuration of every reference experiment) keeps its own elementwise
code where the two differ in their operations: the kernels, the
statistics, the prior's gradient and draw, the projection, the
preconditioner and data generation, so that its numbers (and K1's bitwise
checks against them) do not move.  Random draws are inputs where a test
holds them against the JAX package: the kernels' normals (``[C, N, n]``),
the Gibbs sweep's (:class:`GibbsDraws`), the prior draw's
(:class:`PriorDraws`), data generation's and the preconditioner's noise.
The associative-scan functions of the JAX module
(``parallel_marginal_loglikelihood`` and its two companions) need
``ops/kalman_parallel.py``, which is ROADMAP.md, Queue 1, slice 12b.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import kalman
from ..ops.cuda.fused_pf import FusedModel
from ..utils.distributions import (matrix_normal_logpdf, sample_wishart,
                                   wishart_logpdf)
from ..utils.linalg import (cholesky, inv, logdet, mat_to_tril_vector,
                            matmul, matvec, solve, solve_upper, solve_vec,
                            spectral_norm_projection, tril_vector_to_mat)
from .base import ParticleKernel, horizon_mask, params_map

_LOG_2PI = 1.8378770664093453


@dataclasses.dataclass
class LGSSMParams:
    """LGSSM parameters of C chains (JAX package coordinates).  The
    lower-case properties (``a``, ``c``, ``lqinv``, ``lrinv``, ``qinv``,
    ``rinv``, ``Q``, ``R``) are the scalar model's [C] values; the
    upper-case ``LQinv``, ``LRinv``, ``Qinv`` and ``Rinv`` are matrices of
    any size."""
    A: torch.Tensor            # [C, n, n]
    C: torch.Tensor            # [C, m, n]
    LQinv_vec: torch.Tensor    # [C, n(n+1)/2] chol(Q^-1), packed
    LRinv_vec: torch.Tensor    # [C, m(m+1)/2] chol(R^-1), packed

    @property
    def num_chains(self) -> int:
        return self.A.shape[0]

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.C.shape[-2]

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
    def Qinv(self):
        L = self.LQinv
        return L @ L.mT

    @property
    def Rinv(self):
        L = self.LRinv
        return L @ L.mT

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


def _is_scalar(params: LGSSMParams) -> bool:
    """Whether ``params`` are the scalar model's (n = m = 1)."""
    return params.A.shape[-1] == 1 and params.C.shape[-2] == 1


def from_matrices(A, C, Q, R, dtype=torch.float32,
                  device=None) -> LGSSMParams:
    """One chain's parameters from natural A [n, n], C [m, n], Q [n, n]
    and R [m, m] (scalars for the scalar model)."""
    A, C, Q, R = [np.atleast_2d(np.asarray(v, np.float64))
                  for v in (A, C, Q, R)]

    def leaf(v):
        return torch.as_tensor(np.asarray(v)[None], dtype=dtype,
                               device=device)
    if A.shape == C.shape == (1, 1):
        q, r = float(Q.reshape(())), float(R.reshape(()))
        return LGSSMParams(A=leaf(A), C=leaf(C), LQinv_vec=leaf([q ** -0.5]),
                           LRinv_vec=leaf([r ** -0.5]))

    def packed_chol_inv(M):
        L = np.linalg.cholesky(np.linalg.inv(M))
        return L[np.tril_indices(L.shape[-1])]
    return LGSSMParams(A=leaf(A), C=leaf(C),
                       LQinv_vec=leaf(packed_chol_inv(Q)),
                       LRinv_vec=leaf(packed_chol_inv(R)))


def from_scalars(A: float, Q: float, R: float, C: float = 1.0,
                 dtype=torch.float32, device=None) -> LGSSMParams:
    """One chain's parameters from natural (A, Q, R) scalars and C."""
    return from_matrices(A, C, Q, R, dtype, device)


def params_from_jax(p, dtype=torch.float32) -> LGSSMParams:
    """Port parameters from a JAX ``LGSSMParams`` with numpy (or array)
    leaves of any n, m: one chain's (``A [n, n]``, ``LQinv_vec [d]``) or
    stacked (``A [C, n, n]``, ``LQinv_vec [C, d]``)."""
    single = np.ndim(p.A) == 2

    def conv(x):
        a = np.array(x, dtype=np.float64)
        return torch.as_tensor(a[None] if single else a, dtype=dtype)
    return LGSSMParams(A=conv(p.A), C=conv(p.C), LQinv_vec=conv(p.LQinv_vec),
                       LRinv_vec=conv(p.LRinv_vec))


def stationary_variance(params: LGSSMParams, num_iters: int = 10):
    """Variance [C] of the JAX package's initial state for data
    generation at n = 1: Sigma <- A Sigma A^T + Q iterated from Q
    ``num_iters - 1`` times (its truncated stationary precision,
    inverted)."""
    a2, q = params.a ** 2, params.Q
    sigma = q
    for _ in range(1, num_iters):
        sigma = a2 * sigma + q
    return sigma


def stationary_covariance(params: LGSSMParams, num_iters: int = 10):
    """The same [C, n, n] for any n (the JAX package's
    ``var_stationary_precision``, inverted)."""
    Q, _ = _noise_covariances(params)
    sigma = Q
    for _ in range(1, num_iters):
        sigma = params.A @ sigma @ params.A.mT + Q
    return 0.5 * (sigma + sigma.mT)


def generate_data(generator: torch.Generator, params: LGSSMParams, T: int,
                  normals=None):
    """Simulate (observations [T, m], latent [T, n]) from chain 0 of
    ``params`` on the generator's device.  ``normals = (z0 [n], zx [T,
    n], zy [T, m])`` replace the generator's draws (the vector model)."""
    p = params_map(lambda x: x[:1], params)
    dt, dev = p.A.dtype, p.A.device
    if _is_scalar(p) and normals is None:
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
    n, m = p.n, p.m
    if normals is None:
        normals = [torch.randn(shape, generator=generator, dtype=dt,
                               device=dev) for shape in ((n,), (T, n),
                                                         (T, m))]
    z0, zx, zy = [torch.as_tensor(z, dtype=dt, device=dev) for z in normals]
    Q, R = _noise_covariances(p)
    LQ, LR = cholesky(Q)[0], cholesky(R)[0]
    A = p.A[0]
    x = cholesky(stationary_covariance(p))[0] @ z0
    xs = []
    for t in range(T):
        x = A @ x + LQ @ zx[t]
        xs.append(x)
    xs = torch.stack(xs)
    return xs @ p.C[0].mT + zy @ LR.mT, xs


# --------------------------------------------------------------------------
# Exact (Kalman) interface.  The oracle functions (marginal log-likelihood
# and gradient) compute in float64; the window scores, the latent draws and
# the moments in the parameters' dtype.  All of them act on every chain (or
# window row) of ``params`` at once.
# --------------------------------------------------------------------------

def default_forward_message(params: LGSSMParams) -> kalman.GaussianMessage:
    return kalman.init_forward_message(params.n, params.A.dtype,
                                       params.A.device)


def default_backward_message(params: LGSSMParams) -> kalman.GaussianMessage:
    return kalman.init_backward_message(params.n, params.A.dtype,
                                        params.A.device)


def _mats(params: LGSSMParams):
    return params.A, params.C, params.LQinv, params.LRinv


def _f64(params: LGSSMParams, observations, *msgs):
    """The oracle's float64 copies of its inputs."""
    def msg64(msg):
        return None if msg is None else kalman.GaussianMessage(
            *[x.double() for x in msg])
    return (params_map(lambda x: x.double(), params), observations.double(),
            *[msg64(m) for m in msgs])


def _as_params(g: dict) -> LGSSMParams:
    return LGSSMParams(A=g["A"], C=g["C"],
                       LQinv_vec=mat_to_tril_vector(g["LQinv"]),
                       LRinv_vec=mat_to_tril_vector(g["LRinv"]))


def marginal_loglikelihood(params: LGSSMParams, observations,
                           forward_msg=None, backward_msg=None, weights=None,
                           valid=None) -> torch.Tensor:
    """Exact log p(y) per chain in float64, under the default diffuse
    prior message unless ``forward_msg`` is given."""
    params, observations, forward_msg, backward_msg = _f64(
        params, observations, forward_msg, backward_msg)
    return kalman.marginal_loglikelihood(
        observations, *_mats(params),
        forward_msg or default_forward_message(params),
        backward_msg or default_backward_message(params),
        None if weights is None else weights.double(),
        None if valid is None else valid.double())


def gradient_marginal_loglikelihood(params: LGSSMParams, observations,
                                    forward_msg=None, backward_msg=None,
                                    weights=None, include_init: bool = True,
                                    valid=None) -> LGSSMParams:
    """Exact gradient of log p(y) per chain, as float64 LGSSMParams."""
    params, observations, forward_msg, backward_msg = _f64(
        params, observations, forward_msg, backward_msg)
    return _as_params(kalman.gradient_marginal_loglikelihood(
        observations, *_mats(params),
        forward_msg or default_forward_message(params),
        backward_msg or default_backward_message(params),
        None if weights is None else weights.double(), include_init,
        None if valid is None else valid.double()))


def predictive_loglikelihood(params: LGSSMParams, observations, lag: int = 1,
                             forward_msg=None) -> torch.Tensor:
    """Sum_t log p(y_t | y_{<= t-lag}) per chain."""
    return kalman.predictive_loglikelihood(
        observations, *_mats(params),
        forward_msg or default_forward_message(params), lag)


def latent_var_distr(params: LGSSMParams, observations, lag=None,
                     forward_msg=None, backward_msg=None):
    """Marginals p(x_t | y_{<= t+lag}), smoothed for ``lag=None``:
    (mean [C, T, n], cov [C, T, n, n])."""
    fwd = forward_msg or default_forward_message(params)
    bwd = backward_msg or default_backward_message(params)
    if lag is None:
        return kalman.pairwise_smoothed_moments(observations, *_mats(params),
                                                fwd, bwd)
    return kalman.lagged_moments(observations, *_mats(params), fwd, bwd,
                                 int(lag))


def latent_var_sample(params: LGSSMParams, generator, observations,
                      forward_msg=None, num_samples: int = 1,
                      distr: str = "joint", lag=None, backward_msg=None,
                      valid=None, normals=None) -> torch.Tensor:
    """Posterior latent draws per chain: ``distr='joint'`` FFBS paths
    (``[C, T, n]``, or ``[C, num_samples, T, n]``); ``distr='marginal'``
    independent per-t draws from the (optionally lagged) marginals.
    ``normals`` shaped like the output replace the generator's."""
    if distr == "joint":
        if lag is not None:
            raise ValueError("Must set distr to 'marginal' for lag != None")
        return kalman.ffbs_sample(
            observations, *_mats(params),
            forward_msg or default_forward_message(params), num_samples,
            valid=valid, normals=normals, generator=generator)
    if valid is not None:
        raise ValueError("valid masking is only supported for distr='joint'")
    if distr != "marginal":
        raise ValueError(f"Unrecognized distr '{distr}'")
    mean, cov = latent_var_distr(params, observations, lag, forward_msg,
                                 backward_msg)
    if normals is None:
        normals = torch.randn(mean.shape[:-2] + (num_samples,)
                              + mean.shape[-2:], generator=generator,
                              dtype=mean.dtype, device=mean.device)
    elif num_samples == 1:
        normals = normals[..., None, :, :]
    x = mean[..., None, :, :] + torch.einsum("...tij,...stj->...sti",
                                             cholesky(cov), normals)
    return x[..., 0, :, :] if num_samples == 1 else x


def _noise_covariances(params: LGSSMParams):
    """(Q [C, n, n], R [C, m, m]) from the Cholesky precision factors."""
    LQinv, LRinv = params.LQinv, params.LRinv
    return (inv(matmul(LQinv, LQinv.mT)), inv(matmul(LRinv, LRinv.mT)))


def _observation_moments(params: LGSSMParams, x_mean, x_cov):
    """Latent moments [C, T, n] / [C, T, n, n] -> observation moments:
    y_mean = C x_mean, y_cov = C P C^T + R."""
    Cm = params.C[:, None]                           # [C, 1, m, n]
    _, R = _noise_covariances(params)
    y_mean = matvec(Cm, x_mean)
    y_cov = matmul(matmul(Cm, x_cov), Cm.mT) + R[:, None]
    return y_mean, y_cov


def y_distr(params: LGSSMParams, observations, lag=None,
            forward_msg=None, backward_msg=None):
    """Observation marginals per chain: (y_mean [C, T, m], y_cov
    [C, T, m, m]) of the (lagged) latent marginals."""
    return _observation_moments(params, *latent_var_distr(
        params, observations, lag, forward_msg, backward_msg))


def y_sample(params: LGSSMParams, generator, observations,
             num_samples: int = 1, forward_msg=None, distr: str = "joint",
             lag=None, normals=None, eps=None):
    """Posterior-predictive draws of y_{0:T-1} per chain: latent draws
    (:func:`latent_var_sample`, with its ``normals``) plus emission noise
    (standard normals ``eps`` shaped like the output, else drawn from
    ``generator``)."""
    x = latent_var_sample(params, generator, observations, forward_msg,
                          num_samples, distr=distr, lag=lag, normals=normals)
    _, R = _noise_covariances(params)
    Cm, LR = params.C, cholesky(R)
    lead = (slice(None),) + (None,) * (x.dim() - 2)
    if eps is None:
        eps = torch.randn(x.shape[:-1] + (Cm.shape[-2],), generator=generator,
                          dtype=x.dtype, device=x.device)
    return matvec(Cm[lead], x) + matvec(LR[lead], eps)


def _initial_moments(params: LGSSMParams, init_message):
    msg = init_message or default_forward_message(params)
    return solve_vec(msg.precision, msg.mean_precision), inv(msg.precision)


def simulate_distr(params: LGSSMParams, T: int, init_message=None,
                   include_init: bool = True) -> dict:
    """Prior moment trajectories per chain from the initial message: dict
    of latent and observation means ``[C, T+1, .]`` and covariances
    ``[C, T+1, ., .]`` (T without the initial element)."""
    A = params.A
    Q, _ = _noise_covariances(params)
    m0, P0 = _initial_moments(params, init_message)
    mean = m0.expand(A.shape[:-1])
    cov = P0.expand(A.shape)
    means, covs = [mean], [cov]
    for _ in range(T):
        mean = matvec(A, mean)
        cov = matmul(matmul(A, cov), A.mT) + Q
        means.append(mean)
        covs.append(cov)
    means, covs = torch.stack(means, 1), torch.stack(covs, 1)
    if not include_init:
        means, covs = means[:, 1:], covs[:, 1:]
    y_mean, y_cov = _observation_moments(params, means, covs)
    return dict(latent_vars_mean=means, latent_vars_cov=covs,
                obs_mean=y_mean, obs_cov=y_cov)


def simulate_paths(params: LGSSMParams, generator, T: int,
                   num_samples: int = 1, init_message=None,
                   include_init: bool = True, normals=None) -> dict:
    """Joint prior draws of (x, y) trajectories per chain: dict(latent_vars
    [C, S, T+1, n], observations [C, S, T+1, m]), the sample axis dropped
    for one sample and the initial element without ``include_init``.
    ``normals = (z0 [C, S, n], zx [C, S, T, n], zy [C, S, T+1, m])``
    replace the generator's draws."""
    A, Cm = params.A, params.C
    Q, R = _noise_covariances(params)
    LQ, LR = cholesky(Q)[:, None], cholesky(R)[:, None, None]
    m0, P0 = _initial_moments(params, init_message)
    L0 = cholesky(P0)
    C, n, m = A.shape[0], A.shape[-1], Cm.shape[-2]
    if normals is None:
        normals = tuple(torch.randn(shape, generator=generator,
                                    dtype=A.dtype, device=A.device)
                        for shape in ((C, num_samples, n),
                                      (C, num_samples, T, n),
                                      (C, num_samples, T + 1, m)))
    z0, zx, zy = normals
    x = m0 + matvec(L0, z0)                          # [C, S, n]
    A_s = A[:, None]
    xs = [x]
    for t in range(T):
        x = matvec(A_s, x) + matvec(LQ, zx[:, :, t])
        xs.append(x)
    xs = torch.stack(xs, 2)                          # [C, S, T+1, n]
    ys = matvec(Cm[:, None, None], xs) + matvec(LR, zy)
    if not include_init:
        xs, ys = xs[:, :, 1:], ys[:, :, 1:]
    if num_samples == 1:
        xs, ys = xs[:, 0], ys[:, 0]
    return dict(latent_vars=xs, observations=ys)


def windowed_marginal_gradient(params: LGSSMParams, window, valid, weights,
                               B: int, S: int):
    """The buffered exact-gradient estimator over fixed-shape windows
    ``[R, B + S + B, m]`` of R rows (``params`` with R chains): boundary
    messages over the buffers (rows masked by ``valid [R, W]`` pass
    through) from the default messages, then the weighted gradient and
    marginal log-likelihood over the central S steps (weights
    ``[R, S]``).  Returns (gradient LGSSMParams, loglik [R])."""
    mats = _mats(params)
    fwd0 = default_forward_message(params)
    bwd0 = default_backward_message(params)
    fwd = kalman.forward_message(window[..., :B, :], *mats, fwd0,
                                 valid=valid[..., :B]) if B else fwd0
    bwd = kalman.backward_message(window[..., B + S:, :], *mats, bwd0,
                                  valid=valid[..., B + S:]) if B else bwd0
    loglik, g = kalman.marginal_loglikelihood_and_gradient(
        window[..., B:B + S, :], *mats, fwd, bwd, weights,
        valid[..., B:B + S])
    return _as_params(g), loglik


def _upper_draw(J, z):
    """chol(J)^-T z: a N(0, J^-1) draw from standard normals z."""
    return solve_upper(cholesky(J).mT, z[..., None])[..., 0]


def windowed_complete_gradient(params: LGSSMParams, window, valid, weights,
                               B: int, S: int, generator=None,
                               num_samples: int = 1, normals=None,
                               completion=None):
    """kind='complete' buffered estimator over the windows of
    :func:`windowed_marginal_gradient`: FFBS latent draws over each window,
    then the weighted complete-data score over the subsequence, by autograd
    of :func:`complete_data_loglikelihood` per row (the draws held fixed),
    averaged over ``num_samples`` draws.

    The latent before the subsequence is the sampled buffer row when that
    row is a real observation, else its exact completion given the first
    subsequence draw, x_prev | x_B ~ N(J_c^-1 h_c, J_c^-1) with J_c = J_0 +
    A'Q^-1 A and h_c = h_0 + A'Q^-1 x_B (y never touches it), so that the
    Fisher identity E[grad complete] = grad marginal holds exactly.

    Draws: ``normals [R, K, W, n]`` (the FFBS normals of
    :func:`~..ops.kalman.ffbs_sample`) and ``completion [R, K, n]``, K =
    ``num_samples``; without them they come from ``generator``."""
    batch, W, dt, dev = window.shape[:-2], window.shape[-2], window.dtype, \
        window.device
    K, n = num_samples, params.n
    if normals is None:
        normals = torch.randn(batch + (K, W, n), generator=generator,
                              dtype=dt, device=dev)
    if completion is None:
        completion = torch.randn(batch + (K, n), generator=generator,
                                 dtype=dt, device=dev)
    fmsg0 = default_forward_message(params)
    with torch.no_grad():
        z = normals if K > 1 else normals[..., 0, :, :]
        x = kalman.ffbs_sample(window, *_mats(params), fmsg0, K, valid=valid,
                               normals=z).reshape(batch + (K, W, n))
        Qinv = params.LQinv @ params.LQinv.mT
        AtQinv = (params.A.mT @ Qinv)[..., None, :, :]
        Jc = fmsg0.precision + AtQinv @ params.A[..., None, :, :]
        hc = fmsg0.mean_precision + (AtQinv @ x[..., B, :, None])[..., 0]
        x_init = solve_vec(Jc, hc) + _upper_draw(Jc, completion)
        x_prev = x_init if B == 0 else torch.where(
            valid[..., B - 1, None, None] > 0, x[..., B - 1, :], x_init)
    leaves = [v.detach().requires_grad_() for v in
              (params.A, params.C, params.LQinv_vec, params.LRinv_vec)]
    with torch.enable_grad():
        p = LGSSMParams(*[leaf[:, None] for leaf in leaves])   # sample axis
        ll = complete_data_loglikelihood(
            p, window[..., None, B:B + S, :], x[..., B:B + S, :], x_prev,
            weights[..., None, :]).mean(-1)                       # [R]
        grads = torch.autograd.grad(ll.sum(), leaves)
    return LGSSMParams(*grads), ll.detach()


def complete_data_loglikelihood(params: LGSSMParams, observations,
                                latent_vars, x_prev=None, weights=None):
    """log p(y, x | theta) [...] for observations ``[..., T, m]`` and
    latents ``[..., T, n]``, each step weighted by ``weights [..., T]``;
    ``x_prev [..., n]`` (the latent before the first step) adds the first
    transition."""
    A, C, LQinv, LRinv = _mats(params)
    n, m = A.shape[-1], C.shape[-2]
    x = latent_vars
    T = x.shape[-2]
    if weights is None:
        weights = torch.ones((T,), dtype=x.dtype, device=x.device)
    half_logdet_R = torch.log(torch.abs(torch.diagonal(
        LRinv, dim1=-2, dim2=-1))).sum(-1)
    half_logdet_Q = torch.log(torch.abs(torch.diagonal(
        LQinv, dim1=-2, dim2=-1))).sum(-1)
    z = (observations - x @ C.mT) @ LRinv
    log_emit = (-0.5 * m * _LOG_2PI + half_logdet_R[..., None]
                - 0.5 * (z * z).sum(-1))
    total = (weights * log_emit).sum(-1)
    zx = (x[..., 1:, :] - x[..., :-1, :] @ A.mT) @ LQinv
    log_trans = (-0.5 * n * _LOG_2PI + half_logdet_Q[..., None]
                 - 0.5 * (zx * zx).sum(-1))
    total = total + (weights[..., 1:] * log_trans).sum(-1)
    if x_prev is not None:
        d0 = ((x[..., 0, :] - (A @ x_prev[..., None])[..., 0])[..., None, :]
              @ LQinv)[..., 0, :]
        total = total + weights[..., 0] * (
            -0.5 * n * _LOG_2PI + half_logdet_Q - 0.5 * (d0 * d0).sum(-1))
    return total


# --------------------------------------------------------------------------
# Particle kernels (prior / locally optimal)
# --------------------------------------------------------------------------

def _col(v):
    return v[:, None, None]


def _sample_x0(params: LGSSMParams, z, prior_mean, prior_var):
    """x0 = mean + chol(prior_var) z for z [C, N, n]: a variance [C] (or
    scalar) scales every coordinate, a covariance [C, n, n] by its
    Cholesky factor."""
    if prior_var.dim() < 3:
        return _col(prior_mean) + _col(torch.sqrt(prior_var)) * z
    return prior_mean[:, None, :] + z @ cholesky(prior_var).mT


# The scalar model's kernels: elementwise on [C, N, 1] particles.

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


# The same kernels for any n, m: particles [C, N, n], observations [C, m].

def _half_logdet(L):
    """sum log |diag L| [C] of Cholesky factors [C, k, k]."""
    return torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))).sum(-1)


def _gauss_logpdf(z, half_logdet):
    """log N of whitened residuals z [C, N, k] [C, N]."""
    k = z.shape[-1]
    return (-0.5 * k * _LOG_2PI + half_logdet[:, None]
            - 0.5 * (z * z).sum(-1))


def _propose_prior_n(params: LGSSMParams, z, x_t, y_next):
    """x' = A x + LQinv^-T z."""
    noise = solve_upper(params.LQinv.mT, z.mT).mT
    return x_t @ params.A.mT + noise


def _reweight_prior_n(params: LGSSMParams, x_t, x_next, y_next):
    """log N(y'; C x', R) [C, N]."""
    LRinv = params.LRinv
    diff = y_next[:, None, :] - x_next @ params.C.mT
    return _gauss_logpdf(diff @ LRinv, _half_logdet(LRinv))


def _propose_optimal_n(params: LGSSMParams, z, x_t, y_next):
    """x' ~ N(Sigma (Q^-1 A x + C^T R^-1 y'), Sigma), Sigma^-1 = Q^-1 +
    C^T R^-1 C."""
    Qinv, Rinv = params.Qinv, params.Rinv
    CtRinv = params.C.mT @ Rinv                          # [C, n, m]
    Sigma = inv(Qinv + CtRinv @ params.C)
    mean = ((x_t @ params.A.mT) @ Qinv.mT
            + y_next[:, None, :] @ CtRinv.mT) @ Sigma.mT
    return mean + z @ cholesky(Sigma).mT


def _reweight_optimal_n(params: LGSSMParams, x_t, x_next, y_next):
    """log p(y' | x) = log N(y'; C A x, C Q C^T + R) [C, N]."""
    Q, R = _noise_covariances(params)
    Cm = params.C
    y_cov = Cm @ Q @ Cm.mT + R
    diff = y_next[:, None, :] - (x_t @ params.A.mT) @ Cm.mT
    quad = ((diff @ inv(y_cov)) * diff).sum(-1)
    return (-0.5 * Cm.shape[-2] * _LOG_2PI - 0.5 * logdet(y_cov)[:, None]
            - 0.5 * quad)


def _prior_log_density_n(params: LGSSMParams, x_t, x_next):
    """log q(x_next | x_t) [C, M] for x_t, x_next [C, M, n]."""
    LQinv = params.LQinv
    return _gauss_logpdf((x_next - x_t @ params.A.mT) @ LQinv,
                         _half_logdet(LQinv))


def _prior_log_density_max_n(params: LGSSMParams):
    return -0.5 * params.n * _LOG_2PI + _half_logdet(params.LQinv)


PRIOR_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_prior, reweight=_reweight_prior,
    prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1, noise_dim=1)

OPTIMAL_KERNEL = ParticleKernel(
    sample_x0=_sample_x0, propose=_propose_optimal,
    reweight=_reweight_optimal, prior_log_density=_prior_log_density,
    prior_log_density_max=_prior_log_density_max, state_dim=1, noise_dim=1)


@functools.lru_cache(maxsize=None)
def _vector_kernels(n: int):
    """(optimal, prior) kernels of an n-dimensional state: they draw (and
    take) n normals a particle and step."""
    common = dict(sample_x0=_sample_x0,
                  prior_log_density=_prior_log_density_n,
                  prior_log_density_max=_prior_log_density_max_n,
                  state_dim=n, noise_dim=n)
    return (ParticleKernel(propose=_propose_optimal_n,
                           reweight=_reweight_optimal_n, **common),
            ParticleKernel(propose=_propose_prior_n,
                           reweight=_reweight_prior_n, **common))


def get_kernel(name: str | None = None, n: int = 1,
               m: int = 1) -> ParticleKernel:
    """The JAX package's kernel names (the default is the optimal one) for
    an n-dimensional state and m-dimensional observations.  Unlike the
    JAX package's kernels, which draw their own normals, these declare
    ``state_dim = noise_dim = n``: the port sizes its drawn normals by
    them."""
    if name not in (None, "optimal", "highdim", "prior"):
        raise ValueError(f"Unrecognized LGSSM kernel '{name}'")
    prior = name == "prior"
    if n == 1 and m == 1:
        return PRIOR_KERNEL if prior else OPTIMAL_KERNEL
    return _vector_kernels(n)[1 if prior else 0]


# --------------------------------------------------------------------------
# Additive statistics (Fisher-identity score; sufficient statistics)
# --------------------------------------------------------------------------

# [grad_LRinv_vec, grad_LQinv_vec, grad_C, grad_A] of the scalar model
STATISTIC_DIM = 4


def statistic_dim(n: int, m: int) -> int:
    """[grad_LRinv_vec, grad_LQinv_vec, grad_C, grad_A] packed size."""
    return (m * (m + 1)) // 2 + (n * (n + 1)) // 2 + m * n + n * n


def _tril_inv_t(L):
    """inv(L)^T of lower-triangular L [..., k, k]."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand(L.shape),
                                         upper=False).mT


def _outer(u, v):
    return u[..., :, None] * v[..., None, :]


def grad_statistic(params: LGSSMParams, x_t, x_next, y_next, t):
    """Per-particle gradient of log Pr(y', x' | x, theta), [C, N,
    statistic_dim(n, m)], in :func:`unpack_grad`'s order."""
    if not _is_scalar(params):
        return _grad_statistic_n(params, x_t, x_next, y_next)
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


def _grad_statistic_n(params: LGSSMParams, x_t, x_next, y_next):
    # (d d^T) L is formed as d (d^T L): one [C, N, k] x [C, k, k] product
    # a chain, not a [C * N]-batch of k x k products
    LQinv, LRinv = params.LQinv, params.LRinv
    diff = x_next - x_t @ params.A.mT                        # [C, N, n]
    grad_A = _outer(diff @ params.Qinv.mT, x_t)
    grad_LQinv = _tril_inv_t(LQinv)[:, None] - _outer(diff, diff @ LQinv)
    diff_y = y_next[:, None, :] - x_next @ params.C.mT       # [C, N, m]
    grad_C = _outer(diff_y @ params.Rinv.mT, x_next)
    grad_LRinv = (_tril_inv_t(LRinv)[:, None]
                  - _outer(diff_y, diff_y @ LRinv))
    return torch.cat([mat_to_tril_vector(grad_LRinv),
                      mat_to_tril_vector(grad_LQinv),
                      grad_C.flatten(-2), grad_A.flatten(-2)], -1)


SUFF_STATISTIC_DIM = 3  # [x', x'^2, x x'] of the scalar model


def suff_statistic(params: LGSSMParams, x_t, x_next, y_next, t):
    """Gaussian sufficient statistics per particle: [C, N, 3] at n = 1,
    else [x', vec(x' x'^T), vec(x x'^T)], [C, N, n + 2 n^2]."""
    if x_t.shape[-1] == 1:
        x0, x1 = x_t[..., 0], x_next[..., 0]
        return torch.stack([x1, x1 * x1, x0 * x1], -1)
    return torch.cat([x_next, _outer(x_next, x_next).flatten(-2),
                      _outer(x_t, x_next).flatten(-2)], -1)


# --------------------------------------------------------------------------
# The particle filter's predict surface: moment maps of elementwise-averaged
# sufficient statistics [C, T, H], and the k-step predictive statistic.
# --------------------------------------------------------------------------

# the observation moments come from the latent ones: the observation
# statistic is the sufficient statistic
y_statistic = suff_statistic
Y_STATISTIC_DIM = SUFF_STATISTIC_DIM

def latent_moments(params: LGSSMParams, stats):
    """Sufficient statistics [C, T, H] -> latent (x_mean [C, T, n], x_cov
    [C, T, n, n])."""
    n = params.A.shape[-1]
    if n == 1:
        return (stats[..., 0:1],
                (stats[..., 1] - stats[..., 0] ** 2)[..., None, None])
    x_mean = stats[..., :n]
    second = stats[..., n:n + n * n].reshape(stats.shape[:-1] + (n, n))
    return x_mean, second - x_mean[..., :, None] * x_mean[..., None, :]


def y_moments(params: LGSSMParams, stats):
    """Sufficient statistics [C, T, H] -> observation moments (y_mean = C
    x_mean, y_cov = C P C^T + R) of the estimated latent moments."""
    return _observation_moments(params, *latent_moments(params, stats))


def make_predictive_stat_fn(observations, num_steps_ahead: int,
                            normals=None, valid_length=None):
    """k-step-ahead Gaussian predictive log-likelihood statistic
    [C, N, K+1]: propagate each particle's moments through (A, Q) and
    score y_{t+k} under N(C x_pred, C P_pred C^T + R).  The arguments are
    those of :func:`~.svm.make_predictive_stat_fn`; this statistic is
    exact and takes no ``normals``."""
    T = observations.shape[-2]

    def stat_fn(params, x_t, x_next, y_next, t):
        A, Cm = params.A, params.C
        Q, R = _noise_covariances(params)
        m = Cm.shape[-2]
        x_pred = x_next                                   # [C, N, n]
        P_pred = torch.zeros_like(Q)
        out = []
        for k in range(num_steps_ahead + 1):
            y_tk = observations[:, min(t + k, T - 1)]
            diff = y_tk[:, None, :] - matvec(Cm[:, None], x_pred)
            y_cov = R + matmul(matmul(Cm, P_pred), Cm.mT)     # [C, m, m]
            sol = solve_vec(y_cov[:, None], diff)
            ll = (-0.5 * (diff * sol).sum(-1) - 0.5 * m * _LOG_2PI
                  - 0.5 * logdet(y_cov)[:, None])
            out.append(horizon_mask(t + k, T, valid_length, ll.dtype) * ll)
            x_pred = matvec(A[:, None], x_pred)
            P_pred = Q + matmul(matmul(A, P_pred), A.mT)
        return torch.stack(out, -1)

    return stat_fn


def unpack_grad(stat: torch.Tensor, n: int = 1, m: int = 1) -> LGSSMParams:
    """Score vectors [C, statistic_dim(n, m)] -> gradient parameters."""
    C = stat.shape[0]
    dr, dq = (m * (m + 1)) // 2, (n * (n + 1)) // 2
    i = dr + dq
    return LGSSMParams(A=stat[:, i + m * n:i + m * n + n * n].reshape(C, n, n),
                       C=stat[:, i:i + m * n].reshape(C, m, n),
                       LQinv_vec=stat[:, dr:i], LRinv_vec=stat[:, 0:dr])


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
# SGRLD preconditioner: D(theta) in the JAX package's coordinates (its
# precondition, precondition_noise and correction_term)
# --------------------------------------------------------------------------

def precondition(params: LGSSMParams, grad: LGSSMParams) -> LGSSMParams:
    """D(theta) grad: (Q gA, R gC, tril(Qinv gLQ) / 2, tril(Rinv gLR) /
    2)."""
    if not _is_scalar(params):
        Q, R = _noise_covariances(params)
        return LGSSMParams(
            A=Q @ grad.A, C=R @ grad.C,
            LQinv_vec=mat_to_tril_vector(
                0.5 * params.Qinv @ tril_vector_to_mat(grad.LQinv_vec)),
            LRinv_vec=mat_to_tril_vector(
                0.5 * params.Rinv @ tril_vector_to_mat(grad.LRinv_vec)))
    qinv, rinv = params.qinv[:, None], params.rinv[:, None]
    return LGSSMParams(A=params.Q[:, None, None] * grad.A,
                       C=params.R[:, None, None] * grad.C,
                       LQinv_vec=0.5 * qinv * grad.LQinv_vec,
                       LRinv_vec=0.5 * rinv * grad.LRinv_vec)


def precondition_normals(generator: torch.Generator,
                         params: LGSSMParams) -> LGSSMParams:
    """The standard normals :func:`precondition_noise` takes beyond the
    scalar model: zA [C, n, n], zC [C, m, n], and full square zQ [C, n, n]
    and zR [C, m, m] in the Cholesky fields (the noise of a Cholesky factor
    is tril(L z) of a full z)."""
    C, n, m = params.num_chains, params.n, params.m
    dt, dev = params.A.dtype, params.A.device
    return LGSSMParams(*[torch.randn(shape, generator=generator, dtype=dt,
                                     device=dev)
                         for shape in ((C, n, n), (C, m, n), (C, n, n),
                                       (C, m, m))])


def precondition_noise(params: LGSSMParams, z: LGSSMParams) -> LGSSMParams:
    """sqrt(D(theta)) z for standard normals ``z``: (LQinv^-T zA,
    LRinv^-T zC, tril(LQinv zQ) / sqrt 2, tril(LRinv zR) / sqrt 2).  The
    scalar model takes ``z`` shaped like the parameters, any other the
    square zQ, zR of :func:`precondition_normals`."""
    if _is_scalar(params):
        lqinv, lrinv = params.LQinv_vec, params.LRinv_vec
        return LGSSMParams(
            A=z.A / lqinv[:, :, None], C=z.C / lrinv[:, :, None],
            LQinv_vec=np.sqrt(0.5) * lqinv * z.LQinv_vec,
            LRinv_vec=np.sqrt(0.5) * lrinv * z.LRinv_vec)
    if z.LQinv_vec.dim() != 3:
        raise ValueError("precondition_noise beyond n = m = 1 takes the "
                         "square normals of precondition_normals")
    LQinv, LRinv = params.LQinv, params.LRinv
    return LGSSMParams(
        A=solve_upper(LQinv.mT, z.A), C=solve_upper(LRinv.mT, z.C),
        LQinv_vec=mat_to_tril_vector(np.sqrt(0.5) * LQinv @ z.LQinv_vec),
        LRinv_vec=mat_to_tril_vector(np.sqrt(0.5) * LRinv @ z.LRinv_vec))


def correction_term(params: LGSSMParams) -> LGSSMParams:
    """Gamma(theta): 0 for A and C, (n + 1) / 2 LQinv and (m + 1) / 2
    LRinv for the Cholesky factors."""
    return LGSSMParams(A=torch.zeros_like(params.A),
                       C=torch.zeros_like(params.C),
                       LQinv_vec=0.5 * (params.n + 1) * params.LQinv_vec,
                       LRinv_vec=0.5 * (params.m + 1) * params.LRinv_vec)


# --------------------------------------------------------------------------
# Prior (Wishart on Qinv / Rinv, matrix-normal on A and C)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LGSSMPrior:
    mean_A: torch.Tensor       # (n, n)
    var_col_A: torch.Tensor    # (n,)
    mean_C: torch.Tensor       # (m, n)
    var_col_C: torch.Tensor    # (n,)
    scale_Qinv: torch.Tensor   # (n, n)
    df_Qinv: torch.Tensor      # ()
    scale_Rinv: torch.Tensor   # (m, m)
    df_Rinv: torch.Tensor      # ()


def default_prior(n: int = 1, m: int = 1, var: float = 100.0,
                  dtype=torch.float32, device=None) -> LGSSMPrior:
    """The JAX package's default hyperparameters."""
    df_q = n + 1.0 + 1.0 / var
    df_r = m + 1.0 + 1.0 / var

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    def eye(k, v):
        return torch.eye(k, dtype=dtype, device=device) * v
    return LGSSMPrior(mean_A=full((n, n), 0.0), var_col_A=full((n,), var),
                      mean_C=full((m, n), 0.0), var_col_C=full((n,), var),
                      scale_Qinv=eye(n, 1.0 / df_q), df_Qinv=full((), df_q),
                      scale_Rinv=eye(m, 1.0 / df_r), df_Rinv=full((), df_r))


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


def _cov_grad_logprior(L, df, scale):
    """(df - k - 1) inv(L)^T - solve(scale, L) for Cholesky factors L
    [C, k, k]."""
    return (df - L.shape[-1] - 1) * _tril_inv_t(L) - solve(scale, L)


def grad_logprior(prior: LGSSMPrior, params: LGSSMParams) -> LGSSMParams:
    """Analytic prior score with the JAX package's (and reference's)
    convention: the matrix-normal priors on A and C treat their row
    covariances (Q, R) as constants.  At n = m = 1 the Wishart terms
    ``(df - n - 1) inv(L)^T - solve(scale, L)`` are scalar."""
    if not _is_scalar(params):
        gq = _cov_grad_logprior(params.LQinv, prior.df_Qinv,
                                prior.scale_Qinv)
        gr = _cov_grad_logprior(params.LRinv, prior.df_Rinv,
                                prior.scale_Rinv)
        return LGSSMParams(
            A=-(params.Qinv @ (params.A - prior.mean_A)) / prior.var_col_A,
            C=-(params.Rinv @ (params.C - prior.mean_C)) / prior.var_col_C,
            LQinv_vec=mat_to_tril_vector(gq),
            LRinv_vec=mat_to_tril_vector(gr))
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


class PriorDraws(NamedTuple):
    """The random draws of :func:`sample_prior` over C chains: the
    Wishart draws of Q^-1 and R^-1 (see :class:`GibbsDraws`) and the
    matrix-normal normals of A and C."""
    q_chi2: torch.Tensor        # [C, n]
    q_off: torch.Tensor         # [C, n(n-1)/2]
    r_chi2: torch.Tensor        # [C, m]
    r_off: torch.Tensor         # [C, m(m-1)/2]
    a_normals: torch.Tensor     # [C, n, n]
    c_normals: torch.Tensor     # [C, m, n]


def sample_prior(prior: LGSSMPrior, generator: torch.Generator,
                 num_chains: int = 1,
                 draws: PriorDraws | None = None) -> LGSSMParams:
    """``num_chains`` independent prior draws; ``draws`` replace the
    generator's."""
    C = num_chains
    n, m = prior.mean_A.shape[-1], prior.mean_C.shape[-2]
    if n == 1 and m == 1 and draws is None:
        Qinv = sample_wishart(generator, prior.df_Qinv, prior.scale_Qinv,
                              (C,))
        Rinv = sample_wishart(generator, prior.df_Rinv, prior.scale_Rinv,
                              (C,))
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
    d = draws or PriorDraws(*[None] * 6)
    LQinv = cholesky(sample_wishart(generator, prior.df_Qinv,
                                    prior.scale_Qinv, (C,), chi2=d.q_chi2,
                                    off=d.q_off))
    LRinv = cholesky(sample_wishart(generator, prior.df_Rinv,
                                    prior.scale_Rinv, (C,), chi2=d.r_chi2,
                                    off=d.r_off))
    zA, zC = d.a_normals, d.c_normals
    if zA is None:
        zA, zC = [torch.randn(shape, generator=generator,
                              dtype=LQinv.dtype, device=LQinv.device)
                  for shape in ((C, n, n), (C, m, n))]
    A = prior.mean_A + solve_upper(LQinv.mT, zA) * torch.sqrt(
        prior.var_col_A)
    Cm = prior.mean_C + solve_upper(LRinv.mT, zC) * torch.sqrt(
        prior.var_col_C)
    return LGSSMParams(A=A, C=Cm, LQinv_vec=mat_to_tril_vector(LQinv),
                       LRinv_vec=mat_to_tril_vector(LRinv))


def project_parameters(params: LGSSMParams, a_threshold: float = 0.9999,
                       fix_C_eye: bool = True) -> LGSSMParams:
    """Spectral norm of A <= threshold (a clip at n = 1), positive
    Cholesky diagonals and, by default, the C = I identifiability
    constraint."""
    if not _is_scalar(params):
        def fix_chol(vec):
            L = tril_vector_to_mat(vec)
            return mat_to_tril_vector(
                L.tril(-1) + torch.diag_embed(torch.abs(torch.diagonal(
                    L, dim1=-2, dim2=-1))))
        Cm = (torch.eye(params.m, params.n, dtype=params.C.dtype,
                        device=params.C.device).expand(params.C.shape)
              .contiguous() if fix_C_eye else params.C)
        return LGSSMParams(A=spectral_norm_projection(params.A, a_threshold),
                           C=Cm, LQinv_vec=fix_chol(params.LQinv_vec),
                           LRinv_vec=fix_chol(params.LRinv_vec))
    C = torch.ones_like(params.C) if fix_C_eye else params.C
    return LGSSMParams(A=spectral_norm_projection(params.A, a_threshold),
                       C=C, LQinv_vec=torch.abs(params.LQinv_vec),
                       LRinv_vec=torch.abs(params.LRinv_vec))


# --------------------------------------------------------------------------
# Blocked Gibbs: x | theta by FFBS, then the conjugate theta | x, per chain
# --------------------------------------------------------------------------

class GibbsDraws(NamedTuple):
    """The random draws of one Gibbs sweep over C chains:
    the FFBS normals, then the Wishart draws of Q^-1 and R^-1 (chi-square
    diagonals and off-diagonal normals, see
    :func:`~..utils.distributions.sample_wishart`) and the matrix-normal
    normals of A (and of C when it is not fixed)."""
    ffbs: torch.Tensor                      # [C, T, n]
    q_chi2: torch.Tensor                    # [C, n]
    q_off: torch.Tensor                     # [C, n(n-1)/2]
    a_normals: torch.Tensor                 # [C, n, n]
    r_chi2: torch.Tensor                    # [C, m]
    r_off: torch.Tensor                     # [C, m(m-1)/2]
    c_normals: torch.Tensor | None = None   # [C, m, n] (fix_C_eye=False)


def gibbs_sufficient_statistics(observations, latent_vars) -> dict:
    """Fox-thesis sufficient statistics of latents ``[..., T, n]`` and
    observations ``[..., T, m]`` (scatter matrices with the batch axes)."""
    x, y = latent_vars, observations
    return dict(
        Sx_prevprev=x[..., :-1, :].mT @ x[..., :-1, :],
        Sx_curprev=x[..., 1:, :].mT @ x[..., :-1, :],
        Sx_curcur=x[..., 1:, :].mT @ x[..., 1:, :],
        x_count=x.shape[-2] - 1,
        Sy_prevprev=x.mT @ x,
        Sy_curprev=y.mT @ x,
        Sy_curcur=y.mT @ y,
        y_count=y.shape[-2],
    )


def _conjugate_mniw_sample(generator, S_prevprev, S_curprev, S_curcur, count,
                           mean_M, var_col, scale_Vinv, df_Vinv, chi2=None,
                           off=None, normals=None):
    """(Vinv, M) per chain from the matrix-normal-Wishart posterior of the
    scatter matrices ``[C, ...]``; the draws (Wishart ``chi2``, ``off``;
    matrix-normal ``normals`` shaped like ``[C] + mean_M``) replace the
    generator's."""
    Spp = torch.diag(1.0 / var_col) + S_prevprev
    Scp = mean_M / var_col[None, :] + S_curprev
    Scc = (mean_M / var_col[None, :]) @ mean_M.mT + S_curcur
    M_mean = solve(Spp, Scp.mT).mT
    S_schur = Scc - Scp @ M_mean.mT
    scale_post = inv(inv(scale_Vinv) + S_schur)
    Vinv = sample_wishart(generator, df_Vinv + count, scale_post,
                          chi2=chi2, off=off)
    L_col = cholesky(inv(Spp))
    if normals is None:
        normals = torch.randn(M_mean.shape, generator=generator,
                              dtype=M_mean.dtype, device=M_mean.device)
    M = M_mean + solve_upper(cholesky(Vinv).mT, normals) @ L_col.mT
    return Vinv, M


def gibbs_parameters_sample(generator, prior: LGSSMPrior, observations,
                            latent_vars, fix_C_eye: bool = True,
                            draws: GibbsDraws | None = None) -> LGSSMParams:
    """theta | x, y per chain for latents ``[C, T, n]``: conjugate block
    updates for (Q, A) and (R, C).  With ``fix_C_eye`` (the default
    identifiability constraint) R^-1 is drawn given C = I, a Wishart with
    the residual scatter of y - x, so the chain targets the fixed-C
    posterior; ``fix_C_eye=False`` draws the free (R, C) block."""
    ss = gibbs_sufficient_statistics(observations, latent_vars)
    d = draws or GibbsDraws(*[None] * 6)
    Qinv, A = _conjugate_mniw_sample(
        generator, ss["Sx_prevprev"], ss["Sx_curprev"], ss["Sx_curcur"],
        ss["x_count"], prior.mean_A, prior.var_col_A, prior.scale_Qinv,
        prior.df_Qinv, d.q_chi2, d.q_off, d.a_normals)
    if fix_C_eye:
        Cm = torch.eye(observations.shape[-1], latent_vars.shape[-1],
                       dtype=A.dtype, device=A.device).expand(
                           A.shape[:-2] + (observations.shape[-1],
                                           latent_vars.shape[-1]))
        S_emit = (ss["Sy_curcur"] - Cm @ ss["Sy_curprev"].mT
                  - ss["Sy_curprev"] @ Cm.mT + Cm @ ss["Sy_prevprev"] @ Cm.mT)
        scale_post = inv(inv(prior.scale_Rinv) + S_emit)
        Rinv = sample_wishart(generator, prior.df_Rinv + ss["y_count"],
                              scale_post, chi2=d.r_chi2, off=d.r_off)
    else:
        Rinv, Cm = _conjugate_mniw_sample(
            generator, ss["Sy_prevprev"], ss["Sy_curprev"], ss["Sy_curcur"],
            ss["y_count"], prior.mean_C, prior.var_col_C, prior.scale_Rinv,
            prior.df_Rinv, d.r_chi2, d.r_off, d.c_normals)
    return LGSSMParams(A=A, C=Cm, LQinv_vec=mat_to_tril_vector(cholesky(Qinv)),
                       LRinv_vec=mat_to_tril_vector(cholesky(Rinv)))


def gibbs_step(generator, prior: LGSSMPrior, params: LGSSMParams,
               observations, forward_msg=None,
               draws: GibbsDraws | None = None) -> LGSSMParams:
    """One blocked-Gibbs sweep for every chain of ``params``: x | theta by
    FFBS over the observations ``[T, m]``, then theta | x."""
    x = latent_var_sample(params, generator, observations, forward_msg,
                          normals=None if draws is None else draws.ffbs)
    return gibbs_parameters_sample(generator, prior, observations, x,
                                   draws=draws)
