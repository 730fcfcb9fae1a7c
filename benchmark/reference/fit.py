"""Plain reference of one SG-MCMC fit call: SGLD on the buffered PF score.

Each of the call's iterations draws a subsequence start per chain
(uniform over the T - S + 1 starts), lays out the buffered window of
``W = S + 2B`` steps (``clip(start - B, 0, T - W)``) and the unbiasedness
weights ``(T - S + 1) / n(t)``, runs the particle smoother of ``pf.py``,
adds the prior's score, scales by 1 / T, and takes the Langevin step
``theta + eps * grad + sqrt(2 eps) * sqrt(1 / T) * noise`` followed by the
model's projection (Welling and Teh 2011; Aicher et al. 2019).

The particle smoother is the configuration's ``pf``: Poyiadjis O(N)
(``pf.py``) or PaRIS (``paris.py``); any other raises.

Randomness is replayed, not taken from the program: the reference holds a
``torch.Generator`` set to the seed's stream at the call's start and makes
the draws the call makes, in its order and shapes (``_filter_draws``: Z
normals a particle, the model's ``NOISE_DIM``, and PaRIS's backward
uniforms), and it computes the initial-state and proposal normals of
``rng="kernel"`` with the frozen Philox copy of ``philox.py``.  The
island route (P particle ranks, each its own filter of N / P particles,
the statistic and log-likelihood averaged over the ranks) derives each
rank's generator seed from one draw of the shared stream as the parallel
layer documents (numpy's ``SeedSequence`` of (draw, chain block, rank),
shifted right by one).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import paris, pf, philox

SMOOTHERS = ("poyiadjis_N", "paris")


@dataclass(frozen=True)
class CallPlan:
    """What one call does: sizes, options and the draws' route."""
    T: int
    S: int
    B: int
    N: int                      # particles of one filter (N / P per island)
    iters: int
    epsilon: float
    resampler: str              # "systematic" | "multinomial"
    kernel_rng: bool            # normals from per-chain Philox seeds
    route: str = "k1"           # "k1" (fused window) | "unfused"
    islands: int = 1            # P particle ranks of the island route
    pf: str = "poyiadjis_N"     # the smoother: one of SMOOTHERS
    n_tilde: int = 2            # PaRIS's backward draws a particle
    noise_dim: int = 1          # Z, the model's normals a particle a step
    # a planted variant, for the check's own tests and readings: the
    # filter runs on the first half of its draws only ("half"), the island
    # route keeps rank 0's island ("own_island"), PaRIS takes one backward
    # draw a particle ("one_backward") or draws its backward indices
    # uniformly, ignoring the backward weights ("uniform_backward"), or the
    # same arithmetic runs in another summation order ("reorder": the
    # islands averaged from the last rank on the island route, PaRIS's
    # final mean and log-likelihood in the fused window's order, else the
    # other route's order of the filter's sums), a sound variant
    fault: str | None = None

    @property
    def W(self) -> int:
        return min(self.S + 2 * self.B, self.T)


def rank_seed(*words) -> int:
    """A rank generator's seed from (draw, chain block, rank)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def window_layout(start, plan: CallPlan, observations):
    """(windows [C, W], step weights [C, W]) of subsequences at ``start``."""
    T, S, B, W = plan.T, plan.S, plan.B, plan.W
    dev = start.device
    wstart = torch.clamp(start - B, 0, T - W)
    t1 = start - wstart
    t = start[:, None] + torch.arange(S, device=dev)
    cover = torch.minimum(torch.clamp(t + 1, max=S),
                          torch.clamp(T - t, max=T - S + 1))
    cover = cover.to(torch.float32)
    sub_w = torch.full_like(cover, float(T - S + 1)) / cover
    tau = torch.arange(W, device=dev)
    rel = tau[None, :] - t1[:, None]
    inside = (rel >= 0) & (rel < S)
    step_w = torch.where(inside, torch.gather(sub_w, 1, rel.clamp(0, S - 1)),
                         torch.zeros((), device=dev))
    windows = observations[wstart[:, None] + tau[None, :]]
    return windows, step_w


def _filter_draws(gen, plan: CallPlan, C: int, device):
    """The draws of one filter a window, in the program's order and shapes
    (``PFScore._noise``): Philox seeds, or the initial normals ``[C, Z,
    N]`` and then the proposal normals ``[C, W, Z, N]``; then the
    resampling uniforms; then, for PaRIS, the backward uniforms ``[C, W,
    N, n_tilde]``.  Returns ``(z0, normals, positions, backward)``: the Z
    initial normals ``[C, N]``, ``normals(t)`` the step's Z ``[C, N]``,
    ``positions(t, j)`` and ``backward(t)`` ``[C, N, n_tilde]`` (None
    without PaRIS)."""
    N, W, Z = plan.N, plan.W, plan.noise_dim
    if plan.kernel_rng:
        seeds = torch.randint(-2 ** 63, 2 ** 63 - 1, (C,), generator=gen,
                              dtype=torch.int64, device=device)
        z0 = [philox.normals(seeds, 0, q, N, philox.STREAM_INIT)
              for q in range(Z)]

        def normals(t):
            return [philox.normals(seeds, t, q, N, philox.STREAM_PROPOSAL)
                    for q in range(Z)]
    else:
        z0 = list(torch.randn((C, Z, N), generator=gen,
                              device=device).unbind(1))
        prop = torch.randn((C, W, Z, N), generator=gen, device=device)

        def normals(t):
            return list(prop[:, t].unbind(1))
    if plan.resampler == "systematic":
        xi = torch.rand((C, W), generator=gen, device=device)

        n_t = torch.full((), float(N), dtype=torch.float32, device=device)

        def positions(t, j):
            # divided by a tensor: a true division (a tensor divided by a
            # Python number is a product with its reciprocal on the card)
            return (j + xi[:, t:t + 1].to(j.dtype)) / n_t.to(j.dtype)
    elif plan.resampler == "multinomial":
        u = torch.rand((C, W, N), generator=gen, device=device)

        def positions(t, j):
            return u[:, t]
    else:
        raise ValueError(f"no reference for resampler {plan.resampler!r}")
    backward = None
    if plan.pf == "paris":
        v = torch.rand((C, W, N, plan.n_tilde), generator=gen, device=device)

        def backward(t):
            return v[:, t]
    return z0, normals, positions, backward


def _score(model, plan, p, windows, step_w, gen, C, dtype, device):
    """One filter's (statistic, loglik) on its own draws from ``gen``."""
    if plan.pf not in SMOOTHERS:
        raise ValueError(f"no reference for the smoother {plan.pf!r}")
    z0, normals, positions, backward = _filter_draws(gen, plan, C, device)
    if plan.fault == "half":
        n = plan.N // 2
        z0 = [z[:, :n] for z in z0]
        full_normals, full_positions = normals, positions
        full_backward = backward

        def normals(t):
            return [z[:, :n] for z in full_normals(t)]

        def positions(t, j):
            if plan.resampler == "systematic":
                return full_positions(t, j) * (plan.N / float(n))
            return full_positions(t, j)[:, :n]
        if full_backward is not None:
            def backward(t):
                return full_backward(t)[:, :n]
    elif plan.fault == "one_backward":
        all_backward = backward

        def backward(t):
            return all_backward(t)[..., :1]
    mean, var = model.prior_moments(p)
    x0 = model.init([z.to(dtype) for z in z0], mean, var)
    if plan.pf == "paris":
        variant = plan.fault if plan.fault in ("reorder",
                                               "uniform_backward") else None
        return paris.window_score(model, model.columns(p), x0, windows,
                                  step_w, positions, normals, backward,
                                  dtype, variant)
    fused = plan.route == "k1"
    if plan.fault == "reorder" and plan.islands == 1:
        fused = not fused
    return pf.window_score(model, model.columns(p), x0, windows, step_w,
                           positions, normals, dtype,
                           "fused" if fused else "unfused")


def replay_call(model, prior, plan: CallPlan, leaves, observations,
                gen_state, dtype=torch.float32, path=None):
    """Replay one call from ``leaves`` (the chains' parameters at its
    start, float32 ``[C, ...]``) and the generator state at its start.

    With ``path`` (the program's parameters after each of the call's
    iterations, leaves ``[C, iters, ...]``) iteration k > 0 starts from
    the program's parameters after iteration k - 1: the reference follows
    the program step by step.  Without it each iteration starts from the
    reference's own last one.

    Returns ``(loglik [C, iters], the leaves after each iteration [C,
    iters, ...] float32)``; every quantity the filter and the step compute
    in float32 is computed in ``dtype``."""
    device = observations.device
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    T, eps = plan.T, plan.epsilon
    C = leaves[model.LEAVES[0]].shape[0]
    obs = observations.reshape(-1)
    p = {k: v.to(dtype) for k, v in leaves.items()}
    owns = None
    if plan.islands > 1:
        base = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=device))
        owns = [torch.Generator(device=device).manual_seed(
            rank_seed(base, 0, r)) for r in range(plan.islands)]
    lls, outs = [], []
    for i in range(plan.iters):
        if i and path is not None:
            p = {k: path[k][:, i - 1].to(dtype) for k in model.LEAVES}
        start = torch.randint(0, T - plan.S + 1, (C,), generator=gen,
                              device=device)
        windows, step_w = window_layout(start, plan, obs)
        if owns is None:
            stat, ll = _score(model, plan, p, windows, step_w, gen, C,
                              dtype, device)
        else:
            parts = [_score(model, plan, p, windows, step_w, own, C, dtype,
                            device) for own in owns]
            if plan.fault == "own_island":
                parts = parts[:1]
            elif plan.fault == "reorder":
                parts = parts[::-1]
            stat = sum(s for s, _ in parts) / len(parts)
            ll = sum(v for _, v in parts) / len(parts)
        g_ll = model.unpack(stat.to(dtype))
        g_pr = model.grad_logprior(prior, p)
        noise = {k: torch.randn(p[k].shape, generator=gen,
                                dtype=torch.float32, device=device)
                 for k in model.LEAVES}
        scale = 1.0 / T
        new = {}
        for k in model.LEAVES:
            g = (g_ll[k] + g_pr[k]) * scale
            new[k] = p[k] + eps * g + math.sqrt(2.0 * eps) * (
                math.sqrt(scale) * noise[k].to(dtype))
        p = model.project(new)
        lls.append(ll)
        outs.append(p)
    return torch.stack(lls, 1), {
        k: torch.stack([o[k].float() for o in outs], 1) for k in model.LEAVES}
