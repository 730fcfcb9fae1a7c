"""Exact Kalman message passing in information form (the LGSSM oracle).

Counterpart of ``sgmcmc_tpu/ops/kalman.py``: forward and backward
messages, the marginal log-likelihood and its Fisher-identity gradient,
general in the state size n and the observation size m.  Every matrix may
carry leading batch axes (one per chain): ``A [..., n, n]``,
``C [..., m, n]``, ``LQinv [..., n, n]``, ``LRinv [..., m, m]``.  The
observations ``[T, m]`` (or ``[..., T, m]``), the step weights and the
``valid`` gates ``[T]`` (or ``[..., T]``) broadcast against them.  The
time loop is a Python loop of batched ``torch.linalg`` solves; run it in
float64 for oracle use.

Messages are Gaussian potentials ``exp(-0.5 x^T J x + h^T x) * exp(log_c)``
with ``h = mean_precision`` and ``J = precision``.  Stacked messages put
the time axis right after the batch axes: ``log_constant [..., T+1]``,
``mean_precision [..., T+1, n]``, ``precision [..., T+1, n, n]``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

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


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1)


def _logdet(M):
    return torch.linalg.slogdet(M)[1]


def _mats(A, C, LQinv, LRinv):
    Qinv = LQinv @ LQinv.mT
    Rinv = LRinv @ LRinv.mT
    return Qinv, Rinv, A.mT @ Qinv, C.mT @ Rinv


def _setup(observations, A, C, weights, valid):
    """(batch shape, T, observations, weights, valid) broadcast to the
    batch."""
    batch = torch.broadcast_shapes(A.shape[:-2], C.shape[:-2])
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
    batch, T, y, w, vld = _setup(observations, A, C, weights, valid)
    n, m = A.shape[-1], C.shape[-2]
    Qinv, Rinv, AtQinv, CtRinv = _mats(A, C, LQinv, LRinv)
    AtQinvA = AtQinv @ A
    CtRinvC = CtRinv @ C
    msg = _expand_message(forward_message, batch, n)
    h, J = msg.mean_precision, msg.precision
    log_cs, hs, Js = [], [h], [J]
    for t in range(T):
        y_t, w_t, v_t = y[..., t, :], w[..., t], vld[..., t]
        K = torch.linalg.solve(AtQinvA + J, AtQinv)
        h_pred = _mv(K.mT, h)
        J_pred = Qinv - AtQinv.mT @ K
        y_mean = _mv(C, torch.linalg.solve(J_pred, h_pred[..., None])[..., 0])
        y_prec = Rinv - CtRinv.mT @ torch.linalg.solve(CtRinvC + J_pred,
                                                       CtRinv)
        diff = y_t - y_mean
        log_c = (-0.5 * _dot(diff, _mv(y_prec, diff))
                 + 0.5 * _logdet(y_prec) - 0.5 * m * _LOG_2PI)
        h = (v_t[..., None] * (h_pred + _mv(CtRinv, y_t))
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


def backward_messages(observations, A, C, LQinv, LRinv,
                      backward_message: GaussianMessage, weights=None,
                      valid=None) -> GaussianMessage:
    """All likelihood messages p(y_{>=t} | x_{t-1}): element [t] has
    consumed y_t..y_{T-1}, element [T] is the input message."""
    batch, T, y, w, vld = _setup(observations, A, C, weights, valid)
    n, m = A.shape[-1], C.shape[-2]
    Qinv, Rinv, AtQinv, CtRinv = _mats(A, C, LQinv, LRinv)
    AtQinvA = AtQinv @ A
    CtRinvC = CtRinv @ C
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
        L = torch.linalg.solve(xi, AtQinv.mT)
        v = h + _mv(CtRinv, y_t)
        log_c = (-0.5 * m * _LOG_2PI + half_logdet_R + half_logdet_Q
                 - 0.5 * _logdet(xi) - 0.5 * _dot(y_t, _mv(Rinv, y_t))
                 + 0.5 * _dot(v, torch.linalg.solve(xi, v[..., None])[..., 0]))
        h = v_t[..., None] * _mv(L.mT, v) + (1.0 - v_t[..., None]) * h
        J = (v_t[..., None, None] * (AtQinvA - AtQinv @ L)
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


def _last(msgs: GaussianMessage) -> GaussianMessage:
    return GaussianMessage(msgs.log_constant[..., -1],
                           msgs.mean_precision[..., -1, :],
                           msgs.precision[..., -1, :, :])


def marginal_loglikelihood(observations, A, C, LQinv, LRinv,
                           forward_msg: GaussianMessage,
                           backward_msg: GaussianMessage, weights=None,
                           valid=None) -> torch.Tensor:
    """Exact log p(y_{1:T}) [...], the final forward message fused with the
    backward boundary message."""
    f = _last(forward_messages(observations, A, C, LQinv, LRinv, forward_msg,
                               weights, valid))
    hf, Jf = f.mean_precision, f.precision
    hc = hf + backward_msg.mean_precision
    Jc = Jf + backward_msg.precision
    w_last = 1.0 if weights is None else weights[..., -1]
    return f.log_constant + w_last * (
        backward_msg.log_constant
        + 0.5 * _logdet(Jf) - 0.5 * _logdet(Jc)
        - 0.5 * _dot(hf, torch.linalg.solve(Jf, hf[..., None])[..., 0])
        + 0.5 * _dot(hc, torch.linalg.solve(Jc, hc[..., None])[..., 0]))


def gradient_marginal_loglikelihood(observations, A, C, LQinv, LRinv,
                                    forward_msg: GaussianMessage,
                                    backward_msg: GaussianMessage,
                                    weights=None, include_init: bool = True,
                                    valid=None) -> dict:
    """Fisher-identity gradient of log p(y) with respect to (A, C, LQinv,
    LRinv): smoothed singleton moments give the emission gradients,
    smoothed pairwise moments the transition gradients.  Returns a dict of
    matrix gradients ``{A, C, LQinv, LRinv}`` with the batch axes."""
    batch, T, y, w, _ = _setup(observations, A, C, weights, None)
    n = A.shape[-1]
    if valid is not None:
        w = w * valid
    fmsgs = forward_messages(observations, A, C, LQinv, LRinv, forward_msg,
                             valid=valid)
    bmsgs = backward_messages(observations, A, C, LQinv, LRinv,
                              backward_msg, valid=valid)
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
    x_mean = torch.linalg.solve(Jc, hc[..., None])[..., 0]        # [..., T, n]
    xxt = torch.linalg.inv(Jc) + x_mean[..., :, None] * x_mean[..., None, :]
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
    hp = torch.cat([f_h, b_h + y_p @ RinvC], -1)                 # [..., Tp, 2n]
    full = f_J.shape
    Jp = torch.cat([
        torch.cat([f_J + AtQinvA[..., None, :, :],
                   (-QinvA.mT)[..., None, :, :].expand(full)], -1),
        torch.cat([(-QinvA)[..., None, :, :].expand(full),
                   b_J + (CtRinvC + Qinv)[..., None, :, :]], -1)], -2)
    c_mean = torch.linalg.solve(Jp, hp[..., None])[..., 0]
    c_cov = torch.linalg.inv(Jp)
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
