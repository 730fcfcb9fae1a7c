"""Exact Kalman message passing in information form (the LGSSM oracle).

Counterpart of ``sgmcmc_tpu/ops/kalman.py``: forward and backward
messages, the marginal log-likelihood and its Fisher-identity gradient,
smoothed, filtered and lagged moments, forward-filter backward-sample
(FFBS) and the predictive log-likelihood, general in the state size n and
the observation size m.  Every input may carry leading batch axes (one
per chain or window row): ``A [..., n, n]``, ``C [..., m, n]``,
``LQinv [..., n, n]``, ``LRinv [..., m, m]``, the observations
``[..., T, m]``, the step weights and the ``valid`` gates ``[..., T]``,
and the messages; they broadcast against each other.  The time loop is a
Python loop of batched operations; the solves are those of
``utils/linalg.py`` (elementwise at n = 1, and never a wait for the
card).  The oracle runs it in float64.

Messages are Gaussian potentials ``exp(-0.5 x^T J x + h^T x) * exp(log_c)``
with ``h = mean_precision`` and ``J = precision``.  Stacked messages put
the time axis right after the batch axes: ``log_constant [..., T+1]``,
``mean_precision [..., T+1, n]``, ``precision [..., T+1, n, n]``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.linalg import (cholesky, inv, logdet, matmul, matvec, solve,
                            solve_upper, solve_vec)

_LOG_2PI = math.log(2.0 * math.pi)


class GaussianMessage(NamedTuple):
    log_constant: torch.Tensor    # [...]
    mean_precision: torch.Tensor  # [..., n]
    precision: torch.Tensor       # [..., n, n]


def init_forward_message(n: int, dtype=torch.float64, device=None,
                         precision_scale: float = 0.1) -> GaussianMessage:
    """The default diffuse prior message N(0, I / precision_scale)."""
    return GaussianMessage(
        torch.zeros((), dtype=dtype, device=device),
        torch.zeros((n,), dtype=dtype, device=device),
        torch.eye(n, dtype=dtype, device=device) * precision_scale)


def init_backward_message(n: int, dtype=torch.float64,
                          device=None) -> GaussianMessage:
    """The default trivial likelihood message."""
    return GaussianMessage(torch.zeros((), dtype=dtype, device=device),
                           torch.zeros((n,), dtype=dtype, device=device),
                           torch.zeros((n, n), dtype=dtype, device=device))


def _dot(a, b):
    return (a * b).sum(-1)


def _mats(A, C, LQinv, LRinv):
    Qinv = matmul(LQinv, LQinv.mT)
    Rinv = matmul(LRinv, LRinv.mT)
    return Qinv, Rinv, matmul(A.mT, Qinv), matmul(C.mT, Rinv)


def _setup(observations, A, C, LQinv, LRinv, weights, valid,
           msg: GaussianMessage | None = None):
    """(batch shape, T, observations, weights, valid) broadcast to the
    batch of every input."""
    shapes = [A.shape[:-2], C.shape[:-2], LQinv.shape[:-2], LRinv.shape[:-2],
              observations.shape[:-2]]
    shapes += [x.shape[:-1] for x in (weights, valid) if x is not None]
    if msg is not None:
        shapes.append(msg.mean_precision.shape[:-1])
    batch = torch.broadcast_shapes(*shapes)
    T, m = observations.shape[-2:]
    y = observations.expand(batch + (T, m))
    ones = torch.ones((T,), dtype=A.dtype, device=A.device)
    w = (ones if weights is None else weights).expand(batch + (T,))
    v = (ones if valid is None else valid).expand(batch + (T,))
    return batch, T, y, w, v


def _expand_message(msg: GaussianMessage, batch, n):
    return GaussianMessage(msg.log_constant.expand(batch),
                           msg.mean_precision.expand(batch + (n,)),
                           msg.precision.expand(batch + (n, n)))


def forward_messages(observations, A, C, LQinv, LRinv,
                     forward_message: GaussianMessage, weights=None,
                     valid=None) -> GaussianMessage:
    """All filtered messages p(x_t | y_{<=t}) for t = -1..T-1 (element 0 is
    the input message).  ``valid`` (float {0, 1} per step) passes invalid
    steps' messages through unchanged."""
    batch, T, y, w, vld = _setup(observations, A, C, LQinv, LRinv, weights,
                                 valid, forward_message)
    n, m = A.shape[-1], C.shape[-2]
    Qinv, Rinv, AtQinv, CtRinv = _mats(A, C, LQinv, LRinv)
    AtQinvA = matmul(AtQinv, A)
    CtRinvC = matmul(CtRinv, C)
    msg = _expand_message(forward_message, batch, n)
    h, J = msg.mean_precision, msg.precision
    log_cs, hs, Js = [], [h], [J]
    for t in range(T):
        y_t, w_t, v_t = y[..., t, :], w[..., t], vld[..., t]
        K = solve(AtQinvA + J, AtQinv)
        h_pred = matvec(K.mT, h)
        J_pred = Qinv - matmul(AtQinv.mT, K)
        y_mean = matvec(C, solve_vec(J_pred, h_pred))
        y_prec = Rinv - matmul(CtRinv.mT, solve(CtRinvC + J_pred, CtRinv))
        diff = y_t - y_mean
        log_c = (-0.5 * _dot(diff, matvec(y_prec, diff))
                 + 0.5 * logdet(y_prec) - 0.5 * m * _LOG_2PI)
        h = (v_t[..., None] * (h_pred + matvec(CtRinv, y_t))
             + (1.0 - v_t[..., None]) * h)
        J = (v_t[..., None, None] * (J_pred + CtRinvC)
             + (1.0 - v_t[..., None, None]) * J)
        log_cs.append(v_t * w_t * log_c)
        hs.append(h)
        Js.append(J)
    zero = torch.zeros(batch + (1,), dtype=A.dtype, device=A.device)
    log_constants = msg.log_constant[..., None] + torch.cat(
        [zero, torch.cumsum(torch.stack(log_cs, -1), -1)], -1)
    return GaussianMessage(log_constants, torch.stack(hs, -2),
                           torch.stack(Js, -3))


def forward_message(observations, A, C, LQinv, LRinv,
                    forward_message: GaussianMessage, weights=None,
                    valid=None) -> GaussianMessage:
    """Only the final filtered message."""
    return _at(forward_messages(observations, A, C, LQinv, LRinv,
                                forward_message, weights, valid), -1)


def backward_messages(observations, A, C, LQinv, LRinv,
                      backward_message: GaussianMessage, weights=None,
                      valid=None) -> GaussianMessage:
    """All likelihood messages p(y_{>=t} | x_{t-1}): element [t] has
    consumed y_t..y_{T-1}, element [T] is the input message."""
    batch, T, y, w, vld = _setup(observations, A, C, LQinv, LRinv, weights,
                                 valid, backward_message)
    n, m = A.shape[-1], C.shape[-2]
    Qinv, Rinv, AtQinv, CtRinv = _mats(A, C, LQinv, LRinv)
    AtQinvA = matmul(AtQinv, A)
    CtRinvC = matmul(CtRinv, C)
    half_logdet_R = torch.log(torch.abs(torch.diagonal(
        LRinv, dim1=-2, dim2=-1))).sum(-1)
    half_logdet_Q = torch.log(torch.abs(torch.diagonal(
        LQinv, dim1=-2, dim2=-1))).sum(-1)
    msg = _expand_message(backward_message, batch, n)
    h, J = msg.mean_precision, msg.precision
    log_cs, hs, Js = [], [], []
    for t in range(T - 1, -1, -1):
        y_t, w_t, v_t = y[..., t, :], w[..., t], vld[..., t]
        xi = Qinv + J + CtRinvC
        L = solve(xi, AtQinv.mT)
        v = h + matvec(CtRinv, y_t)
        log_c = (-0.5 * m * _LOG_2PI + half_logdet_R + half_logdet_Q
                 - 0.5 * logdet(xi) - 0.5 * _dot(y_t, matvec(Rinv, y_t))
                 + 0.5 * _dot(v, solve_vec(xi, v)))
        h = v_t[..., None] * matvec(L.mT, v) + (1.0 - v_t[..., None]) * h
        J = (v_t[..., None, None] * (AtQinvA - matmul(AtQinv, L))
             + (1.0 - v_t[..., None, None]) * J)
        log_cs.append(v_t * w_t * log_c)
        hs.append(h)
        Js.append(J)
    # produced in reverse time; element [t] sums the constants of s >= t
    zero = torch.zeros(batch + (1,), dtype=A.dtype, device=A.device)
    log_constants = msg.log_constant[..., None] + torch.cat(
        [torch.flip(torch.cumsum(torch.stack(log_cs, -1), -1), (-1,)), zero],
        -1)
    hs = torch.stack(hs[::-1] + [msg.mean_precision], -2)
    Js = torch.stack(Js[::-1] + [msg.precision], -3)
    return GaussianMessage(log_constants, hs, Js)


def backward_message(observations, A, C, LQinv, LRinv,
                     backward_message: GaussianMessage, weights=None,
                     valid=None) -> GaussianMessage:
    """Only the first likelihood message (it has consumed every step)."""
    return _at(backward_messages(observations, A, C, LQinv, LRinv,
                                 backward_message, weights, valid), 0)


def _at(msgs: GaussianMessage, t: int) -> GaussianMessage:
    return GaussianMessage(msgs.log_constant[..., t],
                           msgs.mean_precision[..., t, :],
                           msgs.precision[..., t, :, :])


def _fuse_boundary(f: GaussianMessage, backward_msg: GaussianMessage,
                   weights):
    """log p(y) from the final forward message and the boundary backward
    message; the boundary terms carry the last step's weight."""
    hf, Jf = f.mean_precision, f.precision
    hc = hf + backward_msg.mean_precision
    Jc = Jf + backward_msg.precision
    w_last = 1.0 if weights is None else weights[..., -1]
    return f.log_constant + w_last * (
        backward_msg.log_constant
        + 0.5 * logdet(Jf) - 0.5 * logdet(Jc)
        - 0.5 * _dot(hf, solve_vec(Jf, hf))
        + 0.5 * _dot(hc, solve_vec(Jc, hc)))


def marginal_loglikelihood(observations, A, C, LQinv, LRinv,
                           forward_msg: GaussianMessage,
                           backward_msg: GaussianMessage, weights=None,
                           valid=None) -> torch.Tensor:
    """Exact log p(y_{1:T}) [...], the final forward message fused with the
    backward boundary message."""
    return _fuse_boundary(
        forward_message(observations, A, C, LQinv, LRinv, forward_msg,
                        weights, valid), backward_msg, weights)


def _gradient(y, w, fmsgs: GaussianMessage, bmsgs: GaussianMessage, A, C,
              LQinv, LRinv, include_init: bool) -> dict:
    """The Fisher-identity gradient from the stacked messages; ``w`` holds
    the step weights times the validity gates."""
    n = A.shape[-1]
    Qinv, Rinv, AtQinv, CtRinv = _mats(A, C, LQinv, LRinv)
    QinvA = Qinv @ A
    AtQinvA = AtQinv @ A
    CtRinvC = CtRinv @ C
    RinvC = Rinv @ C
    LQinv_diaginv = torch.diag_embed(
        1.0 / torch.diagonal(LQinv, dim1=-2, dim2=-1))
    LRinv_diaginv = torch.diag_embed(
        1.0 / torch.diagonal(LRinv, dim1=-2, dim2=-1))

    # emission gradients: smoothed p(x_t | y), t = 0..T-1
    hc = fmsgs.mean_precision[..., 1:, :] + bmsgs.mean_precision[..., 1:, :]
    Jc = fmsgs.precision[..., 1:, :, :] + bmsgs.precision[..., 1:, :, :]
    x_mean = solve_vec(Jc, hc)                                    # [..., T, n]
    xxt = inv(Jc) + x_mean[..., :, None] * x_mean[..., None, :]
    C_grad = (torch.einsum("...t,...tm,...tn->...mn", w, y @ Rinv.mT, x_mean)
              - RinvC @ torch.einsum("...t,...tnk->...nk", w, xxt))
    Cxyt = torch.einsum("...tn,...tm->...tnm", x_mean @ C.mT, y)
    CxxtCt = torch.einsum("...nj,...tjk,...mk->...tnm", C, xxt, C)
    yyt = torch.einsum("...tm,...tk->...tmk", y, y)
    S_emit = torch.einsum("...t,...tmk->...mk", w,
                          yyt - Cxyt - Cxyt.mT + CxxtCt)
    LRinv_grad = (w.sum(-1)[..., None, None] * LRinv_diaginv
                  - S_emit @ LRinv)

    # transition gradients: pairwise p(x_t, x_{t+1} | y); with include_init
    # the first pair couples the prior message to y_0
    if include_init:
        f_h, f_J = fmsgs.mean_precision[..., :-1, :], fmsgs.precision[..., :-1,
                                                                      :, :]
        b_h, b_J = bmsgs.mean_precision[..., 1:, :], bmsgs.precision[..., 1:,
                                                                     :, :]
        y_p, w_p = y, w
    else:
        f_h, f_J = (fmsgs.mean_precision[..., 1:-1, :],
                    fmsgs.precision[..., 1:-1, :, :])
        b_h, b_J = bmsgs.mean_precision[..., 2:, :], bmsgs.precision[..., 2:,
                                                                     :, :]
        y_p, w_p = y[..., 1:, :], w[..., 1:]
    hp = torch.cat([f_h, b_h + y_p @ RinvC], -1)                # [..., Tp, 2n]
    full = f_J.shape
    Jp = torch.cat([
        torch.cat([f_J + AtQinvA[..., None, :, :],
                   (-QinvA.mT)[..., None, :, :].expand(full)], -1),
        torch.cat([(-QinvA)[..., None, :, :].expand(full),
                   b_J + (CtRinvC + Qinv)[..., None, :, :]], -1)], -2)
    c_mean = solve_vec(Jp, hp)
    c_cov = inv(Jp)
    xp, xn = c_mean[..., :n], c_mean[..., n:]
    xpxpt = c_cov[..., :n, :n] + xp[..., :, None] * xp[..., None, :]
    xnxpt = c_cov[..., n:, :n] + xn[..., :, None] * xp[..., None, :]
    xnxnt = c_cov[..., n:, n:] + xn[..., :, None] * xn[..., None, :]
    sum_xpxpt = torch.einsum("...t,...tij->...ij", w_p, xpxpt)
    sum_xnxpt = torch.einsum("...t,...tij->...ij", w_p, xnxpt)
    sum_xnxnt = torch.einsum("...t,...tij->...ij", w_p, xnxnt)
    A_grad = Qinv @ (sum_xnxpt - A @ sum_xpxpt)
    Axpxnt = A @ sum_xnxpt.mT
    S_trans = sum_xnxnt - Axpxnt - Axpxnt.mT + A @ sum_xpxpt @ A.mT
    LQinv_grad = (w_p.sum(-1)[..., None, None] * LQinv_diaginv
                  - S_trans @ LQinv)
    return dict(A=A_grad, C=C_grad, LQinv=LQinv_grad, LRinv=LRinv_grad)


def gradient_marginal_loglikelihood(observations, A, C, LQinv, LRinv,
                                    forward_msg: GaussianMessage,
                                    backward_msg: GaussianMessage,
                                    weights=None, include_init: bool = True,
                                    valid=None) -> dict:
    """Fisher-identity gradient of log p(y) with respect to (A, C, LQinv,
    LRinv): smoothed singleton moments give the emission gradients,
    smoothed pairwise moments the transition gradients.  Returns a dict of
    matrix gradients ``{A, C, LQinv, LRinv}`` with the batch axes."""
    _, _, y, w, _ = _setup(observations, A, C, LQinv, LRinv, weights, None)
    if valid is not None:
        w = w * valid
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg,
                             valid=valid)
    bmsgs = backward_messages(observations, A, C, LQinv, LRinv,
                              backward_msg, valid=valid)
    return _gradient(y, w, fmsgs, bmsgs, A, C, LQinv, LRinv, include_init)


def marginal_loglikelihood_and_gradient(observations, A, C, LQinv, LRinv,
                                        forward_msg: GaussianMessage,
                                        backward_msg: GaussianMessage,
                                        weights=None, valid=None):
    """(:func:`marginal_loglikelihood`, :func:`gradient_marginal_loglikelihood`
    with ``include_init``) from one forward and one backward pass: the step
    weights scale only the forward log-constants, not the messages, so the
    weighted forward pass serves both."""
    _, _, y, w, _ = _setup(observations, A, C, LQinv, LRinv, weights, None)
    w_grad = w if valid is None else w * valid
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg,
                             weights, valid)
    bmsgs = backward_messages(observations, A, C, LQinv, LRinv,
                              backward_msg, valid=valid)
    loglik = _fuse_boundary(_at(fmsgs, -1), backward_msg, weights)
    return loglik, _gradient(y, w_grad, fmsgs, bmsgs, A, C, LQinv, LRinv,
                             True)


def _moments(h, J):
    return solve_vec(J, h), inv(J)


def pairwise_smoothed_moments(observations, A, C, LQinv, LRinv,
                              forward_msg, backward_msg):
    """Smoothed marginals p(x_t | y): (means [..., T, n], covs
    [..., T, n, n])."""
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg)
    bmsgs = backward_messages(observations, A, C, LQinv, LRinv, backward_msg)
    return _moments(
        fmsgs.mean_precision[..., 1:, :] + bmsgs.mean_precision[..., 1:, :],
        fmsgs.precision[..., 1:, :, :] + bmsgs.precision[..., 1:, :, :])


def filtered_moments(observations, A, C, LQinv, LRinv, forward_msg):
    """Filtered marginals p(x_t | y_{<=t}) for t = 0..T-1."""
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg)
    return _moments(fmsgs.mean_precision[..., 1:, :],
                    fmsgs.precision[..., 1:, :, :])


def lagged_moments(observations, A, C, LQinv, LRinv, forward_msg,
                   backward_msg, lag: int):
    """Lagged marginals p(x_t | y_{<= t+lag}) for t = 0..T-1.

    ``lag <= 0`` takes the filtered moments at ``t+lag`` (the prior message
    before the sequence start) and propagates ``-lag`` transition steps;
    ``lag > 0`` is fixed-lag smoothing: the filtered message at ``t``
    combines with a backward message over the validity-masked window
    ``y_{t+1 .. t+lag}``, all T windows as one batch."""
    T = observations.shape[-2]
    dt, dev = observations.dtype, observations.device
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg)
    if lag <= 0:
        idx = torch.clamp(torch.arange(T, device=dev) + lag + 1, 0, T)
        mean, cov = _moments(fmsgs.mean_precision[..., idx, :],
                             fmsgs.precision[..., idx, :, :])
        Qinv = LQinv @ LQinv.mT
        Q = inv(Qinv + 1e-16 * torch.eye(Qinv.shape[-1], dtype=dt,
                                         device=dev))
        for _ in range(-lag):
            mean = mean @ A.mT
            cov = (torch.einsum("...ij,...tjk,...lk->...til", A, cov, A)
                   + Q[..., None, :, :])
        return mean, cov
    idx2 = (torch.arange(T, device=dev)[:, None] + 1
            + torch.arange(lag, device=dev)[None, :])              # [T, lag]
    valid = (idx2 < T).to(dt)
    windows = observations[..., torch.clamp(idx2, 0, T - 1), :]
    b = backward_message(windows, A[..., None, :, :], C[..., None, :, :],
                         LQinv[..., None, :, :], LRinv[..., None, :, :],
                         backward_msg, valid=valid)               # [..., T]
    return _moments(fmsgs.mean_precision[..., 1:, :] + b.mean_precision,
                    fmsgs.precision[..., 1:, :, :] + b.precision)


def ffbs_sample(observations, A, C, LQinv, LRinv, forward_msg,
                num_samples: int = 1, valid=None, normals=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Forward-filter backward-sample of the latent path x_{0:T-1} | y:
    ``[..., T, n]``, or ``[..., num_samples, T, n]`` for more than one
    sample.

    ``normals`` (shaped like the output) are the standard normals of the
    draw: row T-1's draws the last row from its filtered marginal, row t
    the step x_t | x_{t+1}; without them they come from ``generator``.
    ``valid`` gates rows with the message passes' truncated-window
    semantics: invalid rows are transparent (their x is a copy of the
    neighbouring valid draw, a placeholder callers must not condition on)
    and the last valid row is drawn from its filtered marginal."""
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg,
                             valid=valid)
    hs, Js = fmsgs.mean_precision[..., 1:, :], fmsgs.precision[..., 1:, :, :]
    batch, (T, n) = hs.shape[:-2], hs.shape[-2:]
    dt, dev = hs.dtype, hs.device
    K = num_samples
    if normals is None:
        normals = torch.randn(batch + (K, T, n), generator=generator,
                              dtype=dt, device=dev)
    elif K == 1:
        normals = normals[..., None, :, :]
    v = (torch.ones((T,), dtype=dt, device=dev) if valid is None
         else valid).expand(batch + (T,))
    Qinv = LQinv @ LQinv.mT
    AtQinv = (A.mT @ Qinv)[..., None, :, :]                 # the time axis
    # everything but the dependence on x_{t+1} for all rows at once: row
    # t < T-1 draws x_t = P_t + G_t x_{t+1} + e_t with Jcond = J_t +
    # A'Q^-1 A, P = Jcond^-1 h, G = Jcond^-1 A'Q^-1, e = chol(Jcond)^-T z;
    # row T-1 draws x = J^-1 h + chol(J)^-T z
    Jcond = Js + torch.cat([
        (AtQinv @ A[..., None, :, :]).expand(
            batch + (T - 1, n, n)),
        torch.zeros(batch + (1, n, n), dtype=dt, device=dev)], -3)
    P = solve_vec(Jcond, hs)[..., None, :, :]                  # [..., 1, T, n]
    G = solve(Jcond[..., :-1, :, :], AtQinv)[..., None, :, :, :]
    e = solve_upper(cholesky(Jcond).mT[..., None, :, :, :],
                    normals[..., None])[..., 0]                # [..., K, T, n]
    use = v > 0
    x = P[..., -1, :] + e[..., -1, :]
    started = use[..., -1, None]                               # [..., 1]
    xs = [x]
    for t in range(T - 2, -1, -1):
        x_cond = P[..., t, :] + matvec(G[..., t, :, :], x) + e[..., t, :]
        vt = use[..., t, None]
        x = torch.where((vt & started)[..., None], x_cond, x)
        started = started | vt
        xs.append(x)
    out = torch.stack(xs[::-1], -2)
    return out[..., 0, :, :] if K == 1 else out


def predictive_loglikelihood(observations, A, C, LQinv, LRinv, forward_msg,
                             lag: int = 1) -> torch.Tensor:
    """Sum_t log p(y_t | y_{<= t-lag}) [...]."""
    T, m = observations.shape[-2], C.shape[-2]
    Q = inv(LQinv @ LQinv.mT)
    R = inv(LRinv @ LRinv.mT)
    obs_f = observations if lag == 0 else observations[..., :T - lag, :]
    mean, cov = filtered_moments(obs_f, A, C, LQinv, LRinv, forward_msg)
    A_, Q_ = A[..., None, :, :], Q[..., None, :, :]
    for _ in range(lag):
        mean = matvec(A_, mean)
        cov = A_ @ cov @ A_.mT + Q_
    C_ = C[..., None, :, :]
    y_var = C_ @ cov @ C_.mT + R[..., None, :, :]
    diff = observations[..., lag:, :] - matvec(C_, mean)
    ll = (-0.5 * _dot(diff, solve_vec(y_var, diff)) - 0.5 * logdet(y_var)
          - 0.5 * m * _LOG_2PI)
    return ll.sum(-1)
