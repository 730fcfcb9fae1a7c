"""Parallel-in-time Kalman filtering and smoothing by associative scans.

Counterpart of ``sgmcmc_tpu/ops/kalman_parallel.py`` (Särkkä and
García-Fernández, "Temporal Parallelization of Bayesian Smoothers", IEEE
TAC 2021): the sequential filter of ``ops/kalman.py`` re-derived as an
associative operation on Gaussian conditionals, so that every filtered and
smoothed moment comes from ceil(log2 T) rounds of batched operations
(``ops/scan.py``) instead of T steps.

Filtering elements are 5-tuples (A, b, C, eta, J) representing
p(x_t | x_{t-1}, y) ∝ N(x_t; A x_{t-1} + b, C) exp(eta·x_{t-1}
- ½ x_{t-1}ᵀ J x_{t-1}); smoothing elements are affine Gaussian
conditionals (E, g, L), combined from the end.  Every operand carries
leading batch axes (one per chain): ``A [..., n, n]``, ``C_emit [..., m,
n]``, ``LQinv [..., n, n]``, ``LRinv [..., m, m]``, the observations
``[..., T, m]`` (or ``[T, m]`` shared by every chain) and the prior
message; the results are ``[..., T, ...]``.  The solves are those of
``utils/linalg.py``.  No sampler routes here: these are the full-data
counterparts of the sequential functions, as in the JAX package.

Conventions match ``ops/kalman.py``: x_t = A x_{t-1} + N(0, Q), y_t =
C_emit x_t + N(0, R); the prior message is information-form (mean
precision h0, precision J0), the distribution of the state before the
first transition.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.linalg import inv, logdet, matmul, matvec, solve, solve_vec
from .kalman import GaussianMessage, init_forward_message
from .scan import associative_scan

_LOG_2PI = math.log(2.0 * math.pi)


class FilterMoments(NamedTuple):
    mean: torch.Tensor        # [..., T, n] filtered means E[x_t | y_{<=t}]
    cov: torch.Tensor         # [..., T, n, n] filtered covariances
    pred_mean: torch.Tensor   # [..., T, n] predicted means E[x_t | y_{<t}]
    pred_cov: torch.Tensor    # [..., T, n, n]


def _sym(M):
    return 0.5 * (M + M.mT)


def _filter_combine(e1, e2):
    """Associative combination of filtering elements (Lemma 8); ``e1``
    the earlier."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    IC = eye + matmul(C1, J2)
    ICt = eye + matmul(J2, C1)
    A = matmul(A2, solve(IC, A1))
    b = matvec(A2, solve_vec(IC, b1 + matvec(C1, eta2))) + b2
    C = matmul(matmul(A2, solve(IC, C1)), A2.mT) + C2
    eta = matvec(A1.mT, solve_vec(ICt, eta2 - matvec(J2, b1))) + eta1
    J = matmul(matmul(A1.mT, solve(ICt, J2)), A1) + J1
    return A, b, _sym(C), eta, _sym(J)


def _noise(LQinv, LRinv):
    """(Q, R) from the Cholesky factors of the precisions."""
    LQi, LRi = inv(LQinv), inv(LRinv)
    return matmul(LQi.mT, LQi), matmul(LRi.mT, LRi)


def _filter_elements(observations, A, C_emit, Q, R, m0, P0):
    """Per-step filtering elements ``[..., T, ...]`` (element 0 absorbs the
    prior) and the first predicted moments (m1, P1)."""
    T = observations.shape[-2]
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)

    # the elements of steps t >= 1
    S = matmul(matmul(C_emit, Q), C_emit.mT) + R             # [..., m, m]
    K = solve(S, matmul(C_emit, Q)).mT                       # Q Cᵀ S⁻¹
    ImKC = eye - matmul(K, C_emit)
    A_g = matmul(ImKC, A)
    C_g = matmul(ImKC, Q)
    CtSinv = solve(S, C_emit).mT                             # Cᵀ S⁻¹
    b_all = observations @ K.mT                              # [..., T, n]
    eta_all = observations @ matmul(A.mT, CtSinv).mT
    J_g = matmul(matmul(matmul(A.mT, CtSinv), C_emit), A)

    # element 0 absorbs the prior predictive N(A m0, A P0 Aᵀ + Q)
    m1 = matvec(A, m0)
    P1 = matmul(matmul(A, P0), A.mT) + Q
    S1 = matmul(matmul(C_emit, P1), C_emit.mT) + R
    K1 = solve(S1, matmul(C_emit, P1)).mT
    b0 = m1 + matvec(K1, observations[..., 0, :] - matvec(C_emit, m1))
    C0 = _sym(matmul(eye - matmul(K1, C_emit), P1))

    batch = torch.broadcast_shapes(b_all.shape[:-2], b0.shape[:-1],
                                   C0.shape[:-2], A_g.shape[:-2])
    zeros_nn = torch.zeros((n, n), dtype=A.dtype, device=A.device)

    def steps(first, rest, event):
        """[first; rest_1..rest_{T-1}] along the time axis, the batch
        broadcast: ``first [..., *event]``, ``rest [..., T-1 or 1,
        *event]``."""
        return torch.cat([first.unsqueeze(-1 - len(event)).expand(
            batch + (1,) + event), rest.expand(batch + (T - 1,) + event)],
            len(batch))

    A_el = steps(zeros_nn, A_g.unsqueeze(-3), (n, n))
    b_el = steps(b0, b_all[..., 1:, :], (n,))
    C_el = steps(C0, C_g.unsqueeze(-3), (n, n))
    eta_el = steps(zeros_nn[0], eta_all[..., 1:, :], (n,))
    J_el = steps(zeros_nn, J_g.unsqueeze(-3), (n, n))
    return (A_el, b_el, C_el, eta_el, J_el), (m1, P1), len(batch)


def _prior_moments(forward_msg: GaussianMessage):
    J0 = forward_msg.precision
    return solve_vec(J0, forward_msg.mean_precision), inv(J0)


def parallel_filtered_moments(observations, A, C_emit, LQinv, LRinv,
                              forward_msg: GaussianMessage | None = None
                              ) -> FilterMoments:
    """Every filtered and one-step-predicted moment in O(log T) depth;
    equal, up to rounding, to ``kalman.filtered_moments``."""
    if forward_msg is None:
        forward_msg = init_forward_message(A.shape[-1], A.dtype, A.device)
    Q, R = _noise(LQinv, LRinv)
    m0, P0 = _prior_moments(forward_msg)
    elements, (m1, P1), dim = _filter_elements(observations, A, C_emit, Q,
                                               R, m0, P0)
    _, b, C, _, _ = associative_scan(_filter_combine, elements, dim)
    # the predicted moments, from the filtered ones
    At = A.unsqueeze(-3)
    pred_mean = torch.cat([m1.unsqueeze(-2).expand(b[..., :1, :].shape),
                           matvec(At, b[..., :-1, :])], -2)
    pred_cov = torch.cat([P1.unsqueeze(-3).expand(C[..., :1, :, :].shape),
                          matmul(matmul(At, C[..., :-1, :, :]), At.mT)
                          + Q.unsqueeze(-3)], -3)
    return FilterMoments(mean=b, cov=C, pred_mean=pred_mean,
                         pred_cov=pred_cov)


def parallel_marginal_loglikelihood(observations, A, C_emit, LQinv, LRinv,
                                    forward_msg: GaussianMessage | None =
                                    None) -> torch.Tensor:
    """log p(y_{1:T}) [...] = sum_t log N(y_t; C m_{t|t-1}, C P_{t|t-1} Cᵀ
    + R), every normaliser from the parallel filter's predicted moments."""
    fm = parallel_filtered_moments(observations, A, C_emit, LQinv, LRinv,
                                   forward_msg)
    _, R = _noise(LQinv, LRinv)
    Ct = C_emit.unsqueeze(-3)
    y_mean = matvec(Ct, fm.pred_mean)                          # [..., T, m]
    S = matmul(matmul(Ct, fm.pred_cov), Ct.mT) + R.unsqueeze(-3)
    diff = observations - y_mean
    sol = solve_vec(S, diff)
    m = observations.shape[-1]
    return (-0.5 * (diff * sol).sum(-1) - 0.5 * logdet(S)
            - 0.5 * m * _LOG_2PI).sum(-1)


def _smoother_combine(a, b):
    """Associative combination of smoothing elements (Lemma 10).  Under
    ``associative_scan(..., reverse=True)`` the operands arrive flipped:
    ``a`` is the already-combined suffix (later in time) and ``b`` the
    earlier element, whose gain left-multiplies: E_b · suffix + g_b."""
    E_a, g_a, L_a = a
    E_b, g_b, L_b = b
    E = matmul(E_b, E_a)
    g = g_b + matvec(E_b, g_a)
    L = matmul(matmul(E_b, L_a), E_b.mT) + L_b
    return E, g, _sym(L)


def parallel_smoothed_moments(observations, A, C_emit, LQinv, LRinv,
                              forward_msg: GaussianMessage | None = None):
    """Every smoothed moment (E[x_t | y] [..., T, n], Cov[x_t | y] [..., T,
    n, n]) in O(log T) depth: the parallel filter, then a reverse scan of
    the RTS gain elements."""
    fm = parallel_filtered_moments(observations, A, C_emit, LQinv, LRinv,
                                   forward_msg)
    Q, _ = _noise(LQinv, LRinv)
    At, Qt = A.unsqueeze(-3), Q.unsqueeze(-3)
    P = fm.cov
    # E_t = P_t Aᵀ inv(A P_t Aᵀ + Q): x_t given x_{t+1}
    Ppred_next = matmul(matmul(At, P), At.mT) + Qt
    E = solve(Ppred_next, matmul(At, P)).mT
    g = fm.mean - matvec(E, matvec(At, fm.mean))
    L = P - matmul(matmul(E, Ppred_next), E.mT)
    # the terminal element: the last filtered moment itself
    E = torch.cat([E[..., :-1, :, :], torch.zeros_like(E[..., -1:, :, :])],
                  -3)
    g = torch.cat([g[..., :-1, :], fm.mean[..., -1:, :]], -2)
    L = torch.cat([L[..., :-1, :, :], fm.cov[..., -1:, :, :]], -3)
    _, g_s, L_s = associative_scan(_smoother_combine, (E, g, L),
                                   g.dim() - 2, reverse=True)
    return g_s, _sym(L_s)
