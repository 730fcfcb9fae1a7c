"""Particle-axis-sharded particle smoothers over ``torch.distributed``.

Counterpart of ``sgmcmc_tpu/parallel/pf_shard.py``.  One particle filter's
N particles are split over the P ranks of a particle group; every tensor
keeps the port's leading chain axis, so each rank holds particles
``[C, N_loc, D]``, log-weights ``[C, N_loc]`` and statistics ``[C, N_loc,
H]``.  A step all-gathers the (small) filter state once per carried
tensor, so every rank resamples its own slice from the *global* ancestor
distribution and computes its slice of the new state; the O(N^2)
smoother's backward weights are each rank's ``[N_loc, N]`` row block.
The log-likelihood increments and the final average are max- and
sum-reductions over the group.

Randomness is an input, in ``ops/buffered.run_buffered_pf``'s layout over
the local particles: ``z0 [C, Z, N_loc]``, ``normals [C, W, Z, N_loc]``,
the resampling uniforms ``u`` (``[C, W]`` for systematic: the comb's
uniform, the same on every rank; ``[C, W, N_loc]`` for multinomial) and
PaRIS's backward uniforms ``v`` or indices ``J`` (global), ``[C, W, N_loc,
n_tilde]``.  Rank p's comb positions are ``(p * N_loc + i + u) / N``, so on
the same draws the sharded filter chooses the unsharded one's ancestors.

Named exceptions to the JAX module (choices, not faults):
* the comb and the multinomial draw select ``searchsorted(side="right")``
  on the float64-accumulated CDF of the gathered weights, the port's one
  ancestor rule; JAX's sharded comb searches ``side="left"`` and clips
  (``pf_shard.py:47-48``): the two differ only on exact ties;
* the multinomial draw is an inverse CDF at per-rank uniforms where JAX
  draws Gumbel-max categoricals (``pf_shard.py:30-34``): equal in law;
* PaRIS's backward draw is the port's inverse CDF (``ops/smoothers.py``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..models.base import ParticleKernel, StatisticFn
from ..ops.cuda.resample import ancestors, weights_cdf
from ..ops.resampling import normalize_log_weights
from ..ops.smoothers import (PFCarry, PFStepInput, _backward_indices,
                             _check_n_tilde, _ess_gate, _rewired_statistics,
                             poyiadjis_n2_statistics)
from ..utils.profiling import span
from .sharding import all_gather_cat, all_reduce

SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX


def _group_rank_size(group) -> tuple[int, int]:
    """(particle index, P) of this rank in ``group`` (None: one rank)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _global_categorical(u, all_log_w, n_local, p_idx):
    """Multinomial: the rank's ``n_local`` global ancestors [C, n_local]
    by inverse CDF at its own uniforms ``u [C, n_local]``."""
    return ancestors(u, weights_cdf(all_log_w))


def _global_systematic(u, all_log_w, n_local, p_idx):
    """The globally coherent comb: one uniform ``u [C]`` shared by the
    group, rank p taking positions ``(p * n_local + i + u) / N``."""
    N = all_log_w.shape[-1]
    j = torch.arange(n_local, dtype=u.dtype, device=u.device) + \
        p_idx * n_local
    n_t = torch.full((), float(N), dtype=u.dtype, device=u.device)
    return ancestors((j + u[:, None]) / n_t, weights_cdf(all_log_w))


_SHARD_RESAMPLERS = {
    "multinomial": _global_categorical,
    "systematic": _global_systematic,
}


def _global_ess_gate(all_log_w, ess_threshold):
    """(do_resample [C], carried log-weights [C, N]) of the gathered
    weights: the port's unfused ``_ess_gate``, which zeroes non-finite
    carried log-weights as the JAX package's unfused gate does."""
    return _ess_gate(all_log_w, ess_threshold)


def _normalised_increment(new_w, group, n_total: int):
    """log mean exp of the group's weights, per chain [C]: pmax + psum."""
    m = all_reduce(new_w.amax(-1), MAX, group)
    total = all_reduce(torch.exp(new_w - m[:, None]).sum(-1), SUM, group)
    return m + torch.log(total) - math.log(n_total)


def make_sharded_smoother_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                               smoother: str, group=None,
                               resampler: str = "multinomial",
                               lambduh: float = 0.95, n_tilde: int = 2,
                               ess_threshold: float | None = None,
                               bw_chunk: int | None = None):
    """Smoother step over the local particle shards of ``group``:
    ``step(params, carry, inp) -> carry`` with carries of local shards and
    the step input's draws of the local particles.  Smoothers:
    ``filter``, ``nemeth`` (``poyiadjis_N`` is lambda = 1),
    ``poyiadjis_N2`` (the local ``[N_loc, N]`` backward-weight block
    streamed in ``bw_chunk`` rows) and ``paris`` (``n_tilde`` backward
    draws a row; ``inp.J``, global indices, replaces them when given).
    ``ess_threshold`` gates resampling on the global effective sample
    size."""
    if resampler not in _SHARD_RESAMPLERS:
        raise ValueError(f"sharded resampler must be one of "
                         f"{sorted(_SHARD_RESAMPLERS)}")
    draw = _SHARD_RESAMPLERS[resampler]
    if smoother == "poyiadjis_N":
        smoother, lambduh = "nemeth", 1.0
    if smoother not in ("nemeth", "poyiadjis_N2", "paris", "filter"):
        raise ValueError(f"Unsupported sharded smoother '{smoother}'")

    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        p_idx, P = _group_rank_size(group)
        n_local = carry.log_weights.shape[-1]
        all_x = all_gather_cat(carry.particles, group, 1)       # [C, N, D]
        all_w = all_gather_cat(carry.log_weights, group, 1)     # [C, N]
        idx = draw(inp.u, all_w, n_local, p_idx)                # [C, N_loc]
        if ess_threshold is not None:
            do_res, carried_all = _global_ess_gate(all_w, ess_threshold)
            own = torch.arange(n_local, device=idx.device) + p_idx * n_local
            idx = torch.where(do_res[:, None], idx, own)
        D = all_x.shape[-1]
        parents = torch.gather(all_x, 1, idx[..., None].expand(-1, -1, D))
        new_x = kernel.propose(params, inp.z, parents, inp.y)
        new_w = kernel.reweight(params, parents, new_x, inp.y)
        if ess_threshold is not None:
            new_w = new_w + torch.where(do_res[:, None], 0.0,
                                        torch.gather(carried_all, 1, idx))
        scale = inp.weight * inp.in_window                      # [C]

        if smoother == "filter":
            h = stat_fn(params, parents, new_x, inp.y, inp.t)   # [C, n, H]
            m = all_reduce(new_w.amax(-1), MAX, group)
            probs_loc = torch.exp(new_w - m[:, None])
            denom = all_reduce(probs_loc.sum(-1), SUM, group)
            inc = all_reduce((h * (probs_loc / denom[:, None])[..., None])
                             .sum(1), SUM, group)
            stats = carry.statistics + scale[:, None] * inc
        else:
            all_s = all_gather_cat(carry.statistics, group, 1)  # [C, N, H]
            if smoother == "nemeth":
                h = stat_fn(params, parents, new_x, inp.y, inp.t)
                s_anc = torch.gather(
                    all_s, 1, idx[..., None].expand(-1, -1, all_s.shape[-1]))
                if lambduh != 1.0:
                    probs = normalize_log_weights(all_w)
                    S_bar = (all_s * probs[..., None]).sum(1)   # [C, H]
                    s_anc = (lambduh * s_anc
                             + (1.0 - lambduh) * S_bar[:, None, :])
                stats = s_anc + scale[:, None, None] * h
            else:
                prev = PFCarry(all_x, all_w, all_s, carry.loglik)
                if smoother == "poyiadjis_N2":
                    stats = poyiadjis_n2_statistics(
                        kernel, stat_fn, params, prev, new_x, inp, bw_chunk)
                else:
                    _check_n_tilde(inp, n_tilde)
                    J = inp.J
                    if J is None:
                        J = _backward_indices(kernel, params, all_x, all_w,
                                              new_x, inp.v, bw_chunk)
                    stats = _rewired_statistics(stat_fn, params, prev,
                                                new_x, J, inp)

        inc = _normalised_increment(new_w, group, P * n_local)
        loglik = carry.loglik + scale * inc
        return PFCarry(new_x, new_w, stats, loglik)

    return step


def run_buffered_pf_sharded(kernel: ParticleKernel, stat_fn: StatisticFn,
                            params, observations: torch.Tensor, *,
                            z0: torch.Tensor, normals: torch.Tensor,
                            u: torch.Tensor, statistic_dim: int, group=None,
                            smoother: str = "poyiadjis_N",
                            step_weights: torch.Tensor | None = None,
                            in_window: torch.Tensor | None = None,
                            prior_mean=0.0, prior_var=1.0,
                            resampler: str = "multinomial",
                            lambduh: float = 0.95, n_tilde: int = 2,
                            ess_threshold: float | None = None,
                            bw_chunk: int | None = None,
                            v: torch.Tensor | None = None,
                            J: torch.Tensor | None = None):
    """Sharded counterpart of ``ops.buffered.run_buffered_pf`` over the
    windows ``observations [C, W, m]``, this rank holding ``N_loc =
    z0.shape[-1]`` particles of each chain's filter: returns
    ``(mean_statistic [C, H], loglikelihood [C])``, reduced over
    ``group`` (the same on every rank of it).  Every rank of the group
    calls it with the same windows, weights and shared uniforms."""
    C, W = observations.shape[:2]
    dtype, dev = observations.dtype, observations.device
    if step_weights is None:
        step_weights = torch.ones((C, W), dtype=dtype, device=dev)
    if in_window is None:
        in_window = (step_weights > 0).to(dtype)
    step = make_sharded_smoother_step(kernel, stat_fn, smoother, group,
                                      resampler, lambduh, n_tilde,
                                      ess_threshold, bw_chunk)
    D, n_local = kernel.state_dim, z0.shape[-1]
    pm = torch.as_tensor(prior_mean, dtype=dtype, device=dev)
    pv = torch.as_tensor(prior_var, dtype=dtype, device=dev)
    if pv.dim() < 3:            # a variance per chain (or one for all)
        pm, pv = pm.reshape(-1), pv.reshape(-1)
    x0 = kernel.sample_x0(params, z0[:, :D].transpose(1, 2), pm, pv)
    stats_shape = ((C, statistic_dim) if smoother == "filter"
                   else (C, n_local, statistic_dim))
    carry = PFCarry(x0, torch.zeros((C, n_local), dtype=dtype, device=dev),
                    torch.zeros(stats_shape, dtype=dtype, device=dev),
                    torch.zeros((C,), dtype=dtype, device=dev))
    for t in range(W):
        with span("sgmcmc.smoother.step"):
            carry = step(params, carry, PFStepInput(
                z=normals[:, t].transpose(1, 2), u=u[:, t],
                y=observations[:, t], weight=step_weights[:, t],
                in_window=in_window[:, t], t=t,
                v=None if v is None else v[:, t],
                J=None if J is None else J[:, t]))
    if smoother == "filter":
        return carry.statistics, carry.loglik
    m = all_reduce(carry.log_weights.amax(-1), MAX, group)
    w_loc = torch.exp(carry.log_weights - m[:, None])
    denom = all_reduce(w_loc.sum(-1), SUM, group)
    mean_stat = all_reduce((carry.statistics * w_loc[..., None]).sum(1),
                           SUM, group) / denom[:, None]
    return mean_stat, carry.loglik
