"""Particle filter / smoother steps over chain-batched tensors.

Counterpart of ``sgmcmc_tpu/ops/smoothers.py``:
* ``filter``       — filtering accumulator, statistics [C, H];
* ``nemeth``       — O(N) shrinkage smoother (``lambduh < 1``);
* ``poyiadjis_N``  — Nemeth with ``lambduh = 1``;
* ``poyiadjis_N2`` — O(N^2) backward-weight smoother, streamed in row
  blocks of ``bw_chunk``.
Every step resamples ``[particles | statistics]`` jointly with
``resample_rows`` (the resample-apply kernel for CUDA tensors), applies the
optional ESS gate, proposes and reweights.  The step consumes its
randomness as inputs (proposal normals ``z`` and the resampling uniforms
``u``), so the same draws can drive the JAX package.  PaRIS is not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.base import ParticleKernel, StatisticFn
from .cuda.resample import resample_rows
from .resampling import get_resampler, normalize_log_weights


class PFCarry(NamedTuple):
    particles: torch.Tensor     # [C, N, D]
    log_weights: torch.Tensor   # [C, N]
    statistics: torch.Tensor    # [C, N, H] (smoothers) or [C, H] (filter)
    loglik: torch.Tensor        # [C] running loglikelihood estimate


class PFStepInput(NamedTuple):
    z: torch.Tensor             # [C, N, Z] proposal standard normals
    u: torch.Tensor             # resampling uniforms [C] or [C, N]
    y: torch.Tensor             # [C, m] observation y_t
    weight: torch.Tensor        # [C] subsequence weight w_t (0 off-window)
    in_window: torch.Tensor     # [C] {0., 1.}: t in [t1, tL)
    t: int                      # step index within the window


def _ess_gate(log_weights: torch.Tensor, ess_threshold: float | None):
    """(do_resample [C], carried_log_weights [C, N]) for ESS-adaptive
    resampling; ``(None, None)`` when the gate is off.  The carried log
    weights are normalized to ``logsumexp == log N``."""
    if ess_threshold is None:
        return None, None
    n = log_weights.shape[-1]
    lwn = log_weights - torch.logsumexp(log_weights, -1, keepdim=True)
    ess = 1.0 / torch.exp(2.0 * lwn).sum(-1)
    do_res = ess < ess_threshold * n
    carried = lwn + math.log(n)
    return do_res, torch.where(torch.isfinite(carried), carried, 0.0)


def _propagate_apply(kernel: ParticleKernel, scheme: str, mode: str, params,
                     u, z, particles, log_weights, extra_vals, y,
                     ess_threshold: float | None = None):
    """Bootstrap PF step: resample ``particles`` (and the per-particle
    ``extra_vals``, e.g. running statistics) in one resample-apply, then
    propose and reweight.  Returns (parents, new_particles,
    new_log_weights, resampled extra_vals).  With ``ess_threshold`` set,
    chains whose ESS is at least ``ess_threshold * N`` keep their
    un-resampled values and carry their normalized weights."""
    V = particles if extra_vals is None else torch.cat(
        [particles, extra_vals], -1)
    Vr = resample_rows(u, log_weights, V, scheme, mode)
    do_res, carried = _ess_gate(log_weights, ess_threshold)
    if do_res is not None:
        Vr = torch.where(do_res[:, None, None], Vr, V)
    D = particles.shape[-1]
    parents = Vr[..., :D]
    extras = None if extra_vals is None else Vr[..., D:]
    new_particles = kernel.propose(params, z, parents, y)
    new_log_weights = kernel.reweight(params, parents, new_particles, y)
    if do_res is not None:
        new_log_weights = new_log_weights + torch.where(
            do_res[:, None], 0.0, carried)
    return parents, new_particles, new_log_weights, extras


def _loglik_increment(new_log_weights: torch.Tensor) -> torch.Tensor:
    """log(mean(exp(log_w))) per chain, via logsumexp."""
    n = new_log_weights.shape[-1]
    return torch.logsumexp(new_log_weights, -1) - math.log(n)


def make_filter_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                     resampler_name: str = "multinomial",
                     logsumexp_mode: bool = False,
                     resample_mode: str = "auto",
                     ess_threshold: float | None = None):
    """Filtering accumulator step: statistics [C, H] += E[h_t | y_{<=t}];
    with ``logsumexp_mode``, += log E_w[exp(h_t)] per statistic
    dimension."""
    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        parents, particles, log_w, _ = _propagate_apply(
            kernel, resampler_name, resample_mode, params, inp.u, inp.z,
            carry.particles, carry.log_weights, None, inp.y, ess_threshold)
        h = stat_fn(params, parents, particles, inp.y, inp.t)   # [C, N, H]
        scale = (inp.weight * inp.in_window)[:, None]
        probs = normalize_log_weights(log_w)[..., None]         # [C, N, 1]
        if logsumexp_mode:
            h = h * scale[..., None]
            m = h.amax(1)                                       # [C, H]
            inc = m + torch.log((torch.exp(h - m[:, None]) * probs).sum(1))
            stats = carry.statistics + inc * inp.in_window[:, None]
        else:
            stats = carry.statistics + scale * (h * probs).sum(1)
        loglik = carry.loglik + inp.weight * inp.in_window * \
            _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def make_nemeth_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                     lambduh: float = 0.95,
                     resampler_name: str = "multinomial",
                     resample_mode: str = "auto",
                     ess_threshold: float | None = None):
    """Nemeth et al. (2015) O(N) shrinkage smoother step;
    ``lambduh = 1.0`` recovers Poyiadjis O(N).  The carried statistics are
    resampled jointly with the particles."""
    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        if lambduh != 1.0:
            probs = normalize_log_weights(carry.log_weights)     # [C, N]
            S_bar = (carry.statistics * probs[..., None]).sum(1)  # [C, H]
        parents, particles, log_w, stats_anc = _propagate_apply(
            kernel, resampler_name, resample_mode, params, inp.u, inp.z,
            carry.particles, carry.log_weights, carry.statistics, inp.y,
            ess_threshold)
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


def _pairs(particles: torch.Tensor, new_rows: torch.Tensor):
    """Every (x_j, x'_i) pair of ``particles [C, N, D]`` and
    ``new_rows [C, R, D]``, flattened to two ``[C, R*N, D]`` tensors with
    j running fastest."""
    C, N, D = particles.shape
    R = new_rows.shape[1]
    x_t = particles[:, None].expand(C, R, N, D).reshape(C, R * N, D)
    x_next = new_rows[:, :, None].expand(C, R, N, D).reshape(C, R * N, D)
    return x_t, x_next


def _backward_log_weights(kernel: ParticleKernel, params, log_weights,
                          x_t, x_next) -> torch.Tensor:
    """log BW[c, i, j] = log_w[c, j] + log q(x'_i | x_j) (un-normalized)
    [C, R, N] from the pairs of :func:`_pairs`."""
    C, N = log_weights.shape
    return log_weights[:, None, :] + kernel.prior_log_density(
        params, x_t, x_next).reshape(C, -1, N)


# Above this N, bw_chunk=None streams the [N, N] backward weights in blocks
# of the largest divisor of N at most _BW_AUTO_CHUNK rows, as the JAX
# package does.
_BW_AUTO_DENSE_MAX_N = 8192
_BW_AUTO_CHUNK = 4096


def _bw_row_chunks(bw_chunk: int | None, n: int) -> int:
    """Validated row-chunk count for streaming the [N, N] backward weights
    (None: dense up to N=8192, chunked above; bw_chunk >= N: dense)."""
    if bw_chunk is None:
        if n <= _BW_AUTO_DENSE_MAX_N:
            return 1
        bw_chunk = next(d for d in range(min(_BW_AUTO_CHUNK, n), 0, -1)
                        if n % d == 0)
    if bw_chunk >= n:
        return 1
    if n % bw_chunk != 0:
        raise ValueError(
            f"bw_chunk={bw_chunk} must divide n_particles={n}")
    return n // bw_chunk


def make_poyiadjis_n2_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                           resampler_name: str = "multinomial",
                           resample_mode: str = "auto",
                           ess_threshold: float | None = None,
                           bw_chunk: int | None = None):
    """Poyiadjis et al. (2011) O(N^2) smoother step:
    ``new_stats[i] = sum_j BW[i, j] * (stats[j] + h(x_j, x'_i))``.

    The statistics term is a batched matmul; the pairwise-h term evaluates
    the statistic on every pair of a block of ``bw_chunk`` rows, so the
    live memory is O(C * bw_chunk * N * H) instead of O(C * N^2 * H)."""
    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        parents, particles, log_w, _ = _propagate_apply(
            kernel, resampler_name, resample_mode, params, inp.u, inp.z,
            carry.particles, carry.log_weights, None, inp.y, ess_threshold)
        scale = (inp.weight * inp.in_window)[:, None, None]
        C, n = log_w.shape
        rows = n // _bw_row_chunks(bw_chunk, n)

        def rows_to_stats(x_next_c):
            """[C, R, D] new-particle rows -> [C, R, H] statistics."""
            x_t, x_next = _pairs(carry.particles, x_next_c)
            bw = torch.softmax(_backward_log_weights(
                kernel, params, carry.log_weights, x_t, x_next), -1)
            smoothed = bw @ carry.statistics                    # [C, R, H]
            h = stat_fn(params, x_t, x_next, inp.y, inp.t)      # [C, R*N, H]
            h_term = (bw[:, :, None, :]
                      @ h.reshape(C, x_next_c.shape[1], n, -1))[:, :, 0]
            return smoothed + scale * h_term

        stats = torch.cat([rows_to_stats(particles[:, r:r + rows])
                           for r in range(0, n, rows)], 1)
        loglik = carry.loglik + inp.weight * inp.in_window * \
            _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def make_smoother_step(name: str, kernel: ParticleKernel,
                       stat_fn: StatisticFn,
                       resampler_name: str = "multinomial",
                       lambduh: float = 0.95,
                       logsumexp_mode: bool = False,
                       resample_mode: str = "auto",
                       ess_threshold: float | None = None,
                       bw_chunk: int | None = None):
    """Step function for the smoother ``name``."""
    get_resampler(resampler_name)
    if name == "filter":
        return make_filter_step(kernel, stat_fn, resampler_name,
                                logsumexp_mode, resample_mode, ess_threshold)
    if name == "nemeth":
        return make_nemeth_step(kernel, stat_fn, lambduh, resampler_name,
                                resample_mode, ess_threshold)
    if name == "poyiadjis_N":
        return make_nemeth_step(kernel, stat_fn, 1.0, resampler_name,
                                resample_mode, ess_threshold)
    if name == "poyiadjis_N2":
        return make_poyiadjis_n2_step(kernel, stat_fn, resampler_name,
                                      resample_mode, ess_threshold, bw_chunk)
    if name in ("paris", "paris_ar"):
        raise NotImplementedError(
            f"smoother '{name}' is not ported yet (ROADMAP.md, Queue 1)")
    raise ValueError(f"Unrecognized pf = '{name}'")
