"""Plain reference of the buffered PaRIS particle smoother.

PaRIS (Olsson and Westerborn 2017, "Efficient particle-based online
smoothing in general hidden Markov models: the PaRIS algorithm"; Aicher
et al. 2019, arXiv:1901.10568, algorithm 2 with the PaRIS smoother) over
one buffered window of ``W`` steps per chain, in the order of the
program's unfused step: at each step

* the particles alone are resampled: the float64 CDF of the weights,
  rounded once, and the ancestors ``#{j : cdf_j <= position}`` clipped
  to N-1 (``pf._cdf``);
* the proposal and the reweighting;
* the backward log-weights ``log w_j + log q(x'_i | x_j)`` of every pair
  (j the previous step's particle, i the new one), one float64 CDF a row
  ``i``, rounded once, and ``n_tilde`` backward indices ``J_ik`` a row by
  the same inverse CDF at the backward uniforms ``v``;
* the statistic ``s'_i = mean_k(s[J_ik] + w_t h(x_{J_ik}, x'_i))``;
* the log-likelihood ``w_t (logsumexp(log w') - log N)``.

The output is the weight-averaged final statistic (the weights
normalised by their float32 sum) and the log-likelihood.

One departure from upstream: upstream's ``paris_smoother`` draws the
backward indices by accept-reject, while the program's ``paris`` (the
experiment driver's ``PARIS_100``) draws them exactly from the normalised
backward weights, which is the same law; this reference draws them as
the program does.
"""
from __future__ import annotations

import math

import torch

from .pf import _cdf


def _inverse_cdf(cdf, v):
    """Indices ``#{j : cdf_j <= v}`` clipped to N-1, row by row."""
    idx = torch.searchsorted(cdf, v.contiguous(), right=True)
    return idx.clamp_(max=cdf.shape[-1] - 1)


def backward_indices(model, pv, x, logw, x_new, v, dtype,
                     uniform: bool = False):
    """``J [C, N, K]``: K backward indices into the previous particles
    ``x`` (weights ``logw [C, N]``) for each new particle of ``x_new``,
    at the uniforms ``v [C, N, K]``; ``uniform`` ignores the backward
    weights (a planted fault)."""
    C, N = logw.shape
    K = v.shape[-1]
    if uniform:
        return (v * N).long().clamp_(max=N - 1)
    # every pair (x_j, x'_i), j running fastest within a row i
    x_t = [xi[:, None, :].expand(C, N, N).reshape(C, N * N) for xi in x]
    x_next = [xi[:, :, None].expand(C, N, N).reshape(C, N * N)
              for xi in x_new]
    log_bw = logw[:, None, :] + model.transition_log_density(
        pv, x_t, x_next).reshape(C, N, N)
    cdf = _cdf(log_bw.reshape(C * N, N), dtype)[0]
    return _inverse_cdf(cdf, v.reshape(C * N, K)).reshape(C, N, K)


def window_score(model, pv, x0, ys, step_w, positions, normals, backward,
                 dtype, variant: str | None = None):
    """``(statistic [C, H] float32, loglik [C] float32)`` of one window.

    The arguments are ``pf.window_score``'s, and ``backward(t)`` the
    step's backward uniforms ``[C, N, K]``.  Everything the smoother
    computes in float32 it computes in ``dtype``.  ``variant``:
    ``"uniform_backward"`` draws the backward indices uniformly (a
    planted fault); ``"reorder"`` (a sound variant) adds each step's
    log-likelihood as ``m + log(total) - log N`` of the float64 total and
    sums the final weighted mean in float64, the fused window's order."""
    pv = [p.to(dtype) for p in pv]
    x = [xi.to(dtype) for xi in x0]
    C, N = x[0].shape
    W = ys.shape[1]
    ys, step_w = ys.to(dtype), step_w.to(dtype)
    H = model.STAT_DIM
    dev = ys.device
    stats = torch.zeros((C, N, H), dtype=dtype, device=dev)
    logw = torch.zeros((C, N), dtype=dtype, device=dev)
    ll = torch.zeros((C,), dtype=dtype, device=dev)
    j = torch.arange(N, dtype=dtype, device=dev)
    reorder = variant == "reorder"
    log_n = torch.log(torch.full((), float(N), dtype=dtype, device=dev))
    for t in range(W):
        cdf = _cdf(logw, dtype)[0]
        idx = _inverse_cdf(cdf, positions(t, j).to(dtype))
        x_anc = [torch.gather(xi, 1, idx) for xi in x]
        z = [zq.to(dtype) for zq in normals(t)]
        y = ys[:, t:t + 1]
        x_new = model.propose(pv, z, x_anc, y)
        logw_new = model.reweight(pv, x_anc, x_new, y)
        v = backward(t).to(dtype)
        K = v.shape[-1]
        J = backward_indices(model, pv, x, logw, x_new, v, dtype,
                             uniform=variant == "uniform_backward")
        flat = J.reshape(C, N * K)
        x_J = [torch.gather(xi, 1, flat) for xi in x]
        s_J = torch.gather(stats, 1, flat[..., None].expand(-1, -1, H))
        x_rep = [xi.repeat_interleave(K, 1) for xi in x_new]
        h = torch.stack(model.statistic(pv, x_J, x_rep, y), -1)
        stats = (s_J + step_w[:, t, None, None] * h).reshape(
            C, N, K, H).mean(2)
        inside = (step_w[:, t] > 0).to(dtype)
        if reorder:
            _, m, _, tot, ok = _cdf(logw_new, dtype)
            inc = m[:, 0] + torch.log(tot[:, 0].to(dtype)) - log_n
            inc = torch.where(ok[:, 0], inc, torch.full_like(inc, -math.inf))
        else:
            inc = torch.logsumexp(logw_new, -1) - math.log(N)
        ll = ll + step_w[:, t] * inside * inc
        x, logw = x_new, logw_new
    _, m, w, tot, ok = _cdf(logw, dtype)
    if reorder:
        probs = torch.where(ok, w / tot.to(dtype), 1.0 / N)
        stat = (stats * probs[..., None]).double().sum(1)
    else:
        total = w.sum(-1, keepdim=True)
        good = total > 0
        probs = torch.where(good, w / torch.where(good, total, 1.0), 1.0 / N)
        stat = (stats * probs[..., None]).sum(1)
    return stat.float(), ll.float()
