"""Particle smoother steps over chain-batched tensors.

Counterpart of the Nemeth / Poyiadjis-O(N) part of
``sgmcmc_tpu/ops/smoothers.py``: ``lambduh = 1`` is Poyiadjis O(N)
(``poyiadjis_N``), ``lambduh < 1`` the Nemeth shrinkage smoother.  The
step consumes its randomness as inputs (proposal normals and the
systematic offset), so the same draws can drive the CUDA fused kernel and
the JAX package.  The other smoothers and the ESS gate are not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.base import ParticleKernel, StatisticFn
from .resampling import get_resampler, normalize_log_weights


class PFCarry(NamedTuple):
    particles: torch.Tensor     # [C, N, D]
    log_weights: torch.Tensor   # [C, N]
    statistics: torch.Tensor    # [C, N, H]
    loglik: torch.Tensor        # [C] running loglikelihood estimate


class PFStepInput(NamedTuple):
    z: torch.Tensor             # [C, N, Z] proposal standard normals
    u: torch.Tensor             # [C] resampling offset in [0, 1)
    y: torch.Tensor             # [C, m] observation y_t
    weight: torch.Tensor        # [C] subsequence weight w_t (0 off-window)
    in_window: torch.Tensor     # [C] {0., 1.}: t in [t1, tL)
    t: int                      # step index within the window


def _propagate(kernel: ParticleKernel, resampler, params, u, z, particles,
               log_weights, y):
    """Bootstrap PF step: resample -> propose -> reweight."""
    anc = resampler(u, log_weights)                          # [C, N]
    parents = torch.gather(
        particles, 1, anc[..., None].expand(-1, -1, particles.shape[-1]))
    new_particles = kernel.propose(params, z, parents, y)
    new_log_weights = kernel.reweight(params, parents, new_particles, y)
    return parents, new_particles, new_log_weights, anc


def _loglik_increment(new_log_weights: torch.Tensor) -> torch.Tensor:
    """log(mean(exp(log_w))) per chain, via logsumexp."""
    n = new_log_weights.shape[-1]
    return torch.logsumexp(new_log_weights, -1) - math.log(n)


def make_nemeth_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                     lambduh: float = 0.95,
                     resampler_name: str = "systematic",
                     ess_threshold: float | None = None):
    """Nemeth et al. (2015) O(N) shrinkage smoother step;
    ``lambduh = 1.0`` recovers Poyiadjis O(N)."""
    if ess_threshold is not None:
        raise NotImplementedError("the ESS gate is not ported yet")
    resampler = get_resampler(resampler_name)

    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        if lambduh != 1.0:
            probs = normalize_log_weights(carry.log_weights)     # [C, N]
            S_bar = (carry.statistics * probs[..., None]).sum(1)  # [C, H]
        parents, particles, log_w, anc = _propagate(
            kernel, resampler, params, inp.u, inp.z, carry.particles,
            carry.log_weights, inp.y)
        stats_anc = torch.gather(
            carry.statistics, 1,
            anc[..., None].expand(-1, -1, carry.statistics.shape[-1]))
        h = stat_fn(params, parents, particles, inp.y, inp.t)   # [C, N, H]
        scale = (inp.weight * inp.in_window)[:, None, None]
        if lambduh == 1.0:
            stats = stats_anc + scale * h
        else:
            stats = (lambduh * stats_anc
                     + (1.0 - lambduh) * S_bar[:, None, :] + scale * h)
        loglik = carry.loglik + inp.weight * inp.in_window * \
            _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def make_smoother_step(name: str, kernel: ParticleKernel,
                       stat_fn: StatisticFn, resampler_name: str,
                       lambduh: float = 0.95,
                       ess_threshold: float | None = None):
    """Step function for the smoother ``name``."""
    if name == "poyiadjis_N":
        lambduh = 1.0
    elif name != "nemeth":
        raise NotImplementedError(f"smoother '{name}' is not ported yet")
    return make_nemeth_step(kernel, stat_fn, lambduh, resampler_name,
                            ess_threshold)
