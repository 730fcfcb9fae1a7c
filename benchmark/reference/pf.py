"""Plain reference of the buffered Poyiadjis O(N) particle smoother.

One buffered window of ``W`` steps per chain: at each step the normalised
weights' CDF (the prefix sum in float64, rounded once to the working
precision; uniform where the weights are degenerate), the ancestors
``#{j : cdf_j <= position}`` clipped to N-1, the particles and their
running statistics resampled together, the proposal, the reweighting and
the statistic added with the step's subsequence weight.  The
log-likelihood adds ``weight_t * log mean_j w_j`` of each step's new
weights.  The output is the weight-averaged statistic and the
log-likelihood (Poyiadjis et al. 2011; Aicher et al. 2019, algorithm 2).
"""
from __future__ import annotations

import math

import torch


def _cdf(logw: torch.Tensor, dtype):
    """(cdf [C, N] in ``dtype``, shift m [C, 1], w [C, N], total [C, 1]
    float64, ok [C, 1])."""
    N = logw.shape[-1]
    m = logw.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(logw - m)
    csum = torch.cumsum(w.double(), -1)
    tot = csum[:, -1:]
    ok = torch.isfinite(tot) & (tot > 0)
    uniform = torch.arange(1, N + 1, dtype=torch.float64,
                           device=logw.device) / N
    cdf = torch.where(ok, csum / torch.where(ok, tot, 1.0), uniform)
    return cdf.to(dtype), m, w, tot, ok


def _increment(m, tot, ok, log_n):
    """log mean_j w_j from the shift and the float64 total (rounded to the
    working precision before its log, as the fused window does)."""
    inc = m[:, 0] + torch.log(tot[:, 0].to(m.dtype)) - log_n
    return torch.where(ok[:, 0], inc, torch.full_like(inc, -math.inf))


def window_score(model, pv, x0, ys, step_w, positions, normals, dtype,
                 route: str = "fused"):
    """``(statistic [C, H] float32, loglik [C] float32)`` of one window.

    ``pv``: the model's parameter columns ``[C, 1]``; ``x0``: the initial
    state, a list of ``[C, N]``; ``ys``, ``step_w``: ``[C, W]``;
    ``positions(t, j)`` the resampling positions ``[C, N]`` of step t for
    the particle offsets ``j`` (0..N-1 in ``dtype``); ``normals(t)`` the
    step's proposal normals, a list of ``[C, N]``.  Everything the filter computes in float32 it
    computes in ``dtype``.  ``route`` picks the summation order of the
    route being checked, the same arithmetic in another order:
    ``"fused"`` (the fused window's) adds each step's log-likelihood
    increment ``m + log(total) - log N`` at the next step and sums the
    weighted mean's products in float64; ``"unfused"`` (the unfused
    smoother's) adds ``logsumexp(log w) - log N`` at the step itself and
    normalises the weights by their sum in the working precision, summing
    over the particles of ``[C, N, H]`` statistics."""
    pv = [p.to(dtype) for p in pv]
    x = [xi.to(dtype) for xi in x0]
    C, N = x[0].shape
    W = ys.shape[1]
    ys, step_w = ys.to(dtype), step_w.to(dtype)
    H = model.STAT_DIM
    stats = torch.zeros((C, H, N), dtype=dtype, device=ys.device)
    logw = torch.zeros((C, N), dtype=dtype, device=ys.device)
    ll = torch.zeros((C,), dtype=dtype, device=ys.device)
    j = torch.arange(N, dtype=dtype, device=ys.device)
    fused = route == "fused"
    log_n = torch.log(torch.full((), float(N), dtype=dtype,
                                 device=ys.device))
    for t in range(W):
        cdf, m, _, tot, ok = _cdf(logw, dtype)
        if t and fused:
            ll = ll + step_w[:, t - 1] * _increment(m, tot, ok, log_n)
        pos = positions(t, j).to(dtype).contiguous()
        idx = torch.searchsorted(cdf, pos, right=True).clamp_(max=N - 1)
        x_anc = [torch.gather(xi, 1, idx) for xi in x]
        s_anc = torch.gather(stats, 2, idx[:, None, :].expand(-1, H, -1))
        z = [zq.to(dtype) for zq in normals(t)]
        y = ys[:, t:t + 1]
        x = model.propose(pv, z, x_anc, y)
        logw = model.reweight(pv, x_anc, x, y)
        h = torch.stack(model.statistic(pv, x_anc, x, y), 1)
        stats = s_anc + step_w[:, t, None, None] * h
        if not fused:
            inside = (step_w[:, t] > 0).to(dtype)
            ll = ll + step_w[:, t] * inside * (
                torch.logsumexp(logw, -1) - math.log(N))
    _, m, w, tot, ok = _cdf(logw, dtype)
    if fused:
        ll = ll + step_w[:, W - 1] * _increment(m, tot, ok, log_n)
        probs = torch.where(ok, w / tot.to(dtype), 1.0 / N)
        stat = (stats * probs[:, None, :]).double().sum(-1)
    else:
        total = w.sum(-1, keepdim=True)
        good = total > 0
        probs = torch.where(good, w / torch.where(good, total, 1.0), 1.0 / N)
        stat = (stats.transpose(1, 2).contiguous() * probs[..., None]).sum(1)
    return stat.float(), ll.float()
