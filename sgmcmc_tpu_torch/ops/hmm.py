"""Discrete-state (HMM) message passing, chain-batched.

Counterpart of ``sgmcmc_tpu/ops/hmm.py``: the forward and backward
normalised probability messages with their weighted log-constants, the
marginal likelihood, the pairwise and singleton posterior marginals of the
gradient, the lagged marginals, FFBS, the predictive likelihood, the
gradient of the transition logits and SCIR's exact Gamma-process update.

Every function takes the emission log-likelihoods ``logP [..., T, K]``
and the transition matrices ``Pi [..., K, K]``; the leading axes (chains,
window rows, draws) broadcast, as do those of the messages ``prob [...,
K]`` / ``log_constant [...]`` and of ``weights`` / ``valid [..., T]``.
The JAX package's ``lax.scan`` is a Python loop over T.  The
associative-scan functions (``parallel_forward_messages``,
``parallel_marginal_loglikelihood``) are ROADMAP.md, Queue 1, slice 12b.

Random draws are inputs where a test holds them against the JAX package:
FFBS takes one uniform a row and draws by the inverse CDF (equal in law to
the JAX package's Gumbel-max ``jax.random.categorical``); SCIR takes its
Poisson counts and unit gamma draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class HMMMessage(NamedTuple):
    prob: torch.Tensor           # [..., K] (forward: filtered probabilities;
    #                              backward: normalised likelihood vector)
    log_constant: torch.Tensor   # [...]


def default_forward_message(K: int, dtype=torch.float64,
                            device=None) -> HMMMessage:
    return HMMMessage(torch.full((K,), 1.0 / K, dtype=dtype, device=device),
                      torch.zeros((), dtype=dtype, device=device))


def default_backward_message(K: int, dtype=torch.float64,
                             device=None) -> HMMMessage:
    return HMMMessage(torch.full((K,), 1.0 / K, dtype=dtype, device=device),
                      torch.full((), math.log(K), dtype=dtype,
                                 device=device))


def _step_inputs(logP, weights, valid):
    """(max [..., T], exp(logP - max) [..., T, K], weights, valid), the
    missing weights and validity as ones."""
    m = logP.amax(-1)
    P = torch.exp(logP - m[..., None])
    one = torch.ones((), dtype=logP.dtype, device=logP.device)
    return (m, P, one if weights is None else weights,
            one if valid is None else valid)


def _at(x, t):
    """Step t of [..., T] (a scalar passes through)."""
    return x if x.dim() == 0 else x[..., t]


def _finish(init: HMMMessage, probs: list, log_cs: list, reverse: bool):
    """Stack the per-step messages, in the order they were made, with the
    initial one and accumulate the log-constants (forward: element 0 the
    initial message; backward, made from step T-1 down: element T, and
    element t the sum of the constants of steps t..T-1)."""
    log_cs = torch.stack(log_cs, -1)
    prob0 = init.prob.expand(probs[0].shape)
    zero = torch.zeros(log_cs.shape[:-1] + (1,), dtype=log_cs.dtype,
                       device=log_cs.device)
    if reverse:
        probs = torch.stack(probs[::-1] + [prob0], -2)
        acc = torch.cat([torch.flip(torch.cumsum(log_cs, -1), (-1,)), zero],
                        -1)
    else:
        probs = torch.stack([prob0] + probs, -2)
        acc = torch.cat([zero, torch.cumsum(log_cs, -1)], -1)
    return HMMMessage(probs, init.log_constant[..., None] + acc)


def forward_messages(logP, Pi, init: HMMMessage, weights=None,
                     valid=None) -> HMMMessage:
    """All filtered messages, [..., T+1, K] (element 0 the initial one).
    ``valid`` gates steps: an invalid step passes the message through."""
    T = logP.shape[-2]
    m, P, w, v = _step_inputs(logP, weights, valid)
    prob = init.prob
    probs, log_cs = [], []
    for t in range(T):
        vt = _at(v, t)
        p = (prob[..., None, :] @ Pi)[..., 0, :] * P[..., t, :]
        s = p.sum(-1)
        log_cs.append(vt * _at(w, t) * (m[..., t] + torch.log(s)))
        vt = vt[..., None] if vt.dim() else vt
        prob = vt * (p / s[..., None]) + (1.0 - vt) * prob
        probs.append(prob)
    return _finish(init, probs, log_cs, reverse=False)


def backward_messages(logP, Pi, init: HMMMessage, weights=None,
                      valid=None) -> HMMMessage:
    """All backward messages, [..., T+1, K]: element t has consumed
    y_t..y_{T-1}."""
    T = logP.shape[-2]
    m, P, w, v = _step_inputs(logP, weights, valid)
    prob = init.prob
    probs, log_cs = [], []
    for t in range(T - 1, -1, -1):
        vt = _at(v, t)
        p = (Pi @ (P[..., t, :] * prob)[..., None])[..., 0]
        s = p.sum(-1)
        log_cs.append(vt * _at(w, t) * (m[..., t] + torch.log(s)))
        vt = vt[..., None] if vt.dim() else vt
        prob = vt * (p / s[..., None]) + (1.0 - vt) * prob
        probs.append(prob)
    return _finish(init, probs, log_cs, reverse=True)


def last_message(msg: HMMMessage) -> HMMMessage:
    return HMMMessage(msg.prob[..., -1, :], msg.log_constant[..., -1])


def first_message(msg: HMMMessage) -> HMMMessage:
    return HMMMessage(msg.prob[..., 0, :], msg.log_constant[..., 0])


def marginal_loglikelihood(logP, Pi, forward_msg: HMMMessage,
                           backward_msg: HMMMessage, weights=None,
                           valid=None) -> torch.Tensor:
    """log p(y) [...] through the forward messages; ``valid`` gates steps
    of fixed-shape padded sequences."""
    last = last_message(forward_messages(logP, Pi, forward_msg, weights,
                                         valid))
    lik = (last.prob * backward_msg.prob).sum(-1)
    w_last = 1.0 if weights is None else weights[..., -1]
    return last.log_constant + w_last * (torch.log(lik)
                                         + backward_msg.log_constant)


def posterior_marginals(logP, Pi, forward_msg, backward_msg, valid=None):
    """(joint [..., T, K, K], marg [..., T, K]): joint[t] = Pr(z_{t-1},
    z_t | y), marg[t] = Pr(z_t | y).  With ``valid`` invalid steps pass
    the messages through (their rows are placeholders the caller's weights
    must gate)."""
    fwd = forward_messages(logP, Pi, forward_msg, valid=valid)
    bwd = backward_messages(logP, Pi, backward_msg, valid=valid)
    r = fwd.prob[..., :-1, :]
    q = bwd.prob[..., 1:, :]
    P = torch.exp(logP - logP.amax(-1, keepdim=True))
    joint = r[..., :, None] * Pi[..., None, :, :] * (P * q)[..., None, :]
    joint = joint / joint.sum((-2, -1), keepdim=True)
    return joint, joint.sum(-2)


def _fuse(fwd_prob, bwd_prob):
    """Normalised fwd * bwd in log space."""
    logp = torch.log(fwd_prob + 1e-300) + torch.log(bwd_prob + 1e-300)
    p = torch.exp(logp - logp.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def latent_var_distr(logP, Pi, forward_msg, backward_msg, lag=None):
    """Pr(z_t | y_{<= t+lag}) [..., T, K]: ``lag=None`` smoothed, ``0``
    filtered, ``< 0`` the filtered distribution at t+lag propagated
    ``-lag`` steps through Pi, ``> 0`` fixed-lag: the filtered
    distribution times the likelihood of y_{t+1..t+lag}, whose T windows
    (masked past the end of the series) run as the rows of one batched
    backward pass."""
    T = logP.shape[-2]
    fwd = forward_messages(logP, Pi, forward_msg)
    if lag is None:
        bwd = backward_messages(logP, Pi, backward_msg)
        return _fuse(fwd.prob[..., 1:, :], bwd.prob[..., 1:, :])
    lag = int(lag)
    if lag == 0:
        return fwd.prob[..., 1:, :]
    dev = logP.device
    if lag < 0:
        idx = torch.clamp(torch.arange(T, device=dev) + 1 + lag, 0, T)
        base = fwd.prob[..., idx, :]
        for _ in range(-lag):
            base = base @ Pi
        return base / base.sum(-1, keepdim=True)
    t_idx = (torch.arange(T, device=dev)[:, None] + 1
             + torch.arange(lag, device=dev)[None, :])          # [T, lag]
    valid = (t_idx < T).to(logP.dtype)
    win_logP = logP[..., torch.clamp(t_idx, 0, T - 1), :]  # [..., T, lag, K]
    bwd0 = HMMMessage(backward_msg.prob[..., None, :],
                      backward_msg.log_constant[..., None])
    bprob = backward_messages(win_logP, Pi[..., None, :, :], bwd0,
                              valid=valid).prob[..., 0, :]      # [..., T, K]
    return _fuse(fwd.prob[..., 1:, :], bprob)


def categorical_icdf(probs, u):
    """Inverse-CDF draws [...] of the unnormalised ``probs [..., K]``, one
    uniform ``u [...]`` each (``side="right"``: index = #{k: cdf_k <=
    u})."""
    cdf = torch.cumsum(probs, -1)
    cdf = (cdf / cdf[..., -1:]).expand(u.shape + cdf.shape[-1:])
    z = torch.searchsorted(cdf.contiguous(), u[..., None].to(cdf.dtype)
                           .contiguous(), right=True)[..., 0]
    return torch.clamp(z, max=probs.shape[-1] - 1)


def latent_var_sample(logP, Pi, forward_msg, backward_msg, valid=None,
                      u=None, generator=None) -> torch.Tensor:
    """Joint FFBS draws z [..., T] (int64): the backward messages, then a
    forward pass drawing z_t | z_{t-1}, y from its normalised row by the
    inverse CDF of ``u [..., T]`` (uniforms; from ``generator`` if None).

    ``valid`` gates rows as the message passes do: an invalid row is
    transparent (no transition or emission across it) and its z a copy of
    the neighbouring valid draw, a placeholder; the first valid row draws
    from the initial message's prior, as row 0 does without ``valid``."""
    T = logP.shape[-2]
    bwd = backward_messages(logP, Pi, backward_msg, valid=valid)
    P = torch.exp(logP - logP.amax(-1, keepdim=True))
    if u is None:
        shape = torch.broadcast_shapes(logP.shape[:-1], Pi.shape[:-2] + (T,))
        u = torch.rand(shape, generator=generator, dtype=logP.dtype,
                       device=logP.device)
    batch = u.shape[:-1]
    q = bwd.prob[..., 1:, :]
    prior0 = (forward_msg.prob[..., None, :] @ Pi)[..., 0, :]
    K = Pi.shape[-1]
    rows = torch.arange(K, device=logP.device)
    z_prev = torch.zeros(batch, dtype=torch.int64, device=logP.device)
    started = torch.zeros(batch, dtype=torch.bool, device=logP.device)
    zs = []
    for t in range(T):
        # Pi[z_prev]: the row of the previous draw
        onehot = (z_prev[..., None] == rows).to(Pi.dtype)
        prior = torch.where(started[..., None],
                            (onehot[..., None, :] @ Pi)[..., 0, :], prior0)
        if valid is None:
            post = prior * P[..., t, :] * q[..., t, :]
            z = categorical_icdf(post, u[..., t])
        else:
            vt = (valid[..., t] > 0).expand(batch)
            post = prior * torch.where(vt[..., None], P[..., t, :],
                                       torch.ones_like(P[..., t, :])) \
                * q[..., t, :]
            z = torch.where(vt, categorical_icdf(post, u[..., t]), z_prev)
            started = started | vt
        if valid is None:
            started = torch.ones_like(started)
        zs.append(z)
        z_prev = z
    zs = torch.stack(zs, -1)
    if valid is None:
        return zs
    # invalid rows copy the next valid draw (the backward fill); the last
    # rows keep the forward copy
    v = (valid > 0).expand(zs.shape)
    out = [zs[..., -1]]
    for t in range(T - 2, -1, -1):
        out.append(torch.where(v[..., t], zs[..., t], out[-1]))
    return torch.stack(out[::-1], -1)


def predictive_loglikelihood(logP, Pi, forward_msg, lag: int = 1
                             ) -> torch.Tensor:
    """Sum_t log p(y_t | y_{<= t-lag}) [...]."""
    T, K = logP.shape[-2:]
    obs_f = logP if lag == 0 else logP[..., :T - lag, :]
    prob = forward_messages(obs_f, Pi, forward_msg).prob[..., 1:, :]
    if lag > 0:
        pred = prob @ torch.linalg.matrix_power(Pi, lag)
    else:
        pred = prob
    m = logP.amax(-1)
    P = torch.exp(logP - m[..., None])
    lik = (pred * P[..., lag:, :]).sum(-1)
    return (torch.log(lik) + m[..., lag:]).sum(-1)


def grad_logit_pi(joint_sum, Pi) -> torch.Tensor:
    """The marginal log-likelihood's gradient in logit_pi from the summed
    pairwise posteriors: joint_sum - diag(rowsum) Pi."""
    return joint_sum - joint_sum.sum(-1, keepdim=True) * Pi


def dirichlet_grad_logit_pi(alpha, pi) -> torch.Tensor:
    """The Dirichlet prior's score in logit coordinates: (alpha - 1) - pi
    rowsum(alpha - 1)."""
    a1 = alpha - 1.0
    return a1 - pi * a1.sum(-1, keepdim=True)


# torch.poisson's count wraps around in int64 near a rate of 9.2e18; above
# this rate J is drawn as N(rate, rate), whose error in law is
# O(rate^-1/2).  SCIR meets such rates where a centred logit passes ~35.
POISSON_EXACT_MAX = 1e15


def sample_noncentral_chi2(generator, df, nonc, J=None, gamma=None):
    """NoncentralChi2(df, nonc) by its Poisson mixture: J ~ Poisson(nonc /
    2), X = 2 G with G ~ Gamma((df + 2 J) / 2, 1).  ``J`` and ``gamma``
    (G itself) replace the generator's draws.

    Rates above ``POISSON_EXACT_MAX`` take J's normal approximation.  An
    entry whose rate or shape is not a finite nonnegative number (a
    diverged chain's) is NaN, and a zero shape gives 0, without reaching
    the samplers: on the card a NaN Poisson rate is a device-side assert,
    and the gamma sampler's rejection loop would not end on a NaN
    shape."""
    if gamma is None:
        if J is None:
            rate = nonc / 2.0
            ok = torch.isfinite(rate) & (rate >= 0)
            big = ok & (rate > POISSON_EXACT_MAX)
            J = torch.poisson(torch.where(ok & ~big, rate, 0.0).contiguous(),
                              generator=generator)
            z = torch.randn(rate.shape, generator=generator,
                            dtype=rate.dtype, device=rate.device)
            J = torch.where(big, rate + torch.sqrt(torch.where(
                big, rate, 0.0)) * z, J)
            J = torch.where(ok, J, torch.nan)
        shape = (df + 2.0 * J.to(df.dtype)) / 2.0
        ok = torch.isfinite(shape) & (shape > 0)
        gamma = torch._standard_gamma(torch.where(ok, shape, 1.0).contiguous(),
                                      generator=generator)
        gamma = torch.where(ok, gamma, torch.where(shape == 0, 0.0,
                                                   torch.nan))
    return 2.0 * gamma


def scir_update(generator, theta, a, epsilon: float, J=None, gamma=None):
    """Stochastic Cox-Ingersoll-Ross exact Gamma-process update of simplex
    weights (Baker et al. 2018): W ~ NoncentralChi2(2 a, 2 theta e^-eps /
    (1 - e^-eps)), theta' = (1 - e^-eps) W / 2 + 1e-99 (in float64 the
    1e-99 keeps theta' > 0 where W is 0)."""
    decay = math.exp(-epsilon)
    W = sample_noncentral_chi2(generator, 2.0 * a,
                               2.0 * theta * decay / (1.0 - decay), J, gamma)
    return 0.5 * (1.0 - decay) * W + 1e-99
