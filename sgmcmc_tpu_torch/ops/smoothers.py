"""Particle filter / smoother steps over chain-batched tensors.

Counterpart of ``sgmcmc_tpu/ops/smoothers.py``:
* ``filter``       — filtering accumulator, statistics [C, H];
* ``nemeth``       — O(N) shrinkage smoother (``lambduh < 1``);
* ``poyiadjis_N``  — Nemeth with ``lambduh = 1``;
* ``poyiadjis_N2`` — O(N^2) backward-weight smoother, streamed in row
  blocks of ``bw_chunk``;
* ``paris``        — PaRIS with exact backward sampling: ``n_tilde``
  backward indices per particle drawn from the normalised backward
  weights, streamed in the same row blocks;
* ``paris_ar``     — PaRIS with accept-reject backward sampling and the
  exact draw as its fallback.
Every step resamples ``[particles | statistics]`` jointly with
``resample_rows`` (the resample-apply kernel for CUDA tensors; PaRIS
resamples the particles only), applies the optional ESS gate, proposes and
reweights.  With ``ElementwiseSlots`` the statistic is elementwise: step
t adds its statistic to its own slot of a ``[length * dim]`` statistic.
The step consumes its randomness as inputs (proposal normals
``z``, the resampling uniforms ``u`` and PaRIS's backward uniforms ``v``),
so the same draws can drive the JAX package.  Two named exceptions to the
JAX module: the backward indices are drawn by inverse CDF
(``searchsorted(side="right")`` on each normalised row, the port's one
selection rule) where JAX draws Gumbel-max categoricals, which agree in
law; and ``paris_ar`` draws its accept-reject rounds from the
``torch.Generator`` of the step input, since their number depends on the
data.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.base import ParticleKernel, StatisticFn
from .cuda.resample import ancestors, resample_rows, weights_cdf
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
    # PaRIS: backward uniforms [C, N, n_tilde]; J [C, N, n_tilde] (the
    # backward indices themselves) replaces them when given
    v: torch.Tensor | None = None
    J: torch.Tensor | None = None
    # paris_ar: the generator of its accept-reject rounds
    generator: torch.Generator | None = None


class ElementwiseSlots(NamedTuple):
    """The elementwise statistic's layout: each chain's statistic is
    ``length`` slots of ``dim``, and step ``t`` adds its statistic to slot
    ``t - t1`` (clipped to the window) alone."""
    t1: torch.Tensor            # [C] first in-window step of each chain
    length: int
    dim: int


def _add_statistic(stats: torch.Tensor, inc: torch.Tensor, t: int,
                   slots: ElementwiseSlots | None) -> torch.Tensor:
    """``stats + inc``; with ``slots``, ``inc [C, ..., dim]`` is added to
    step t's slot of ``stats [C, ..., length * dim]`` in place, and the
    other slots are not written (the JAX package adds a one-hot product,
    which gives the same numbers for a finite ``inc``)."""
    if slots is None:
        return stats + inc
    C = stats.shape[0]
    slot = (t - slots.t1).clamp(0, slots.length - 1)
    cols = slot[:, None] * slots.dim + torch.arange(
        slots.dim, device=stats.device)
    cols = cols.reshape((C,) + (1,) * (inc.dim() - 2) + (slots.dim,))
    return stats.scatter_add_(-1, cols.expand(inc.shape), inc)


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
                     ess_threshold: float | None = None,
                     slots: ElementwiseSlots | None = None):
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
            inc = inc * inp.in_window[:, None]
        else:
            inc = scale * (h * probs).sum(1)
        stats = _add_statistic(carry.statistics if slots is None
                               else carry.statistics.clone(), inc, inp.t,
                               slots)
        loglik = carry.loglik + inp.weight * inp.in_window * \
            _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def make_nemeth_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                     lambduh: float = 0.95,
                     resampler_name: str = "multinomial",
                     resample_mode: str = "auto",
                     ess_threshold: float | None = None,
                     slots: ElementwiseSlots | None = None):
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
        if lambduh != 1.0:
            stats_anc = (lambduh * stats_anc
                         + (1.0 - lambduh) * S_bar[:, None, :])
        stats = _add_statistic(stats_anc, scale * h, inp.t, slots)
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


def poyiadjis_n2_statistics(kernel: ParticleKernel, stat_fn: StatisticFn,
                            params, carry: PFCarry, new_particles,
                            inp: PFStepInput, bw_chunk: int | None = None,
                            slots: ElementwiseSlots | None = None):
    """The O(N^2) smoother's new statistics [C, R, H] of the rows
    ``new_particles [C, R, D]`` over the previous cloud ``carry`` (N
    particles): ``sum_j BW[i, j] * (stats[j] + scale * h(x_j, x'_i))``,
    the rows streamed in blocks of ``bw_chunk``."""
    scale = (inp.weight * inp.in_window)[:, None, None]
    C, n = carry.log_weights.shape
    R = new_particles.shape[1]
    rows = R // _bw_row_chunks(bw_chunk, R)

    def rows_to_stats(x_next_c):
        """[C, r, D] new-particle rows -> [C, r, H] statistics."""
        x_t, x_next = _pairs(carry.particles, x_next_c)
        bw = torch.softmax(_backward_log_weights(
            kernel, params, carry.log_weights, x_t, x_next), -1)
        smoothed = bw @ carry.statistics                        # [C, r, H]
        h = stat_fn(params, x_t, x_next, inp.y, inp.t)          # [C, r*N, H]
        h_term = (bw[:, :, None, :]
                  @ h.reshape(C, x_next_c.shape[1], n, -1))[:, :, 0]
        return _add_statistic(smoothed, scale * h_term, inp.t, slots)

    return torch.cat([rows_to_stats(new_particles[:, r:r + rows])
                      for r in range(0, R, rows)], 1)


def make_poyiadjis_n2_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                           resampler_name: str = "multinomial",
                           resample_mode: str = "auto",
                           ess_threshold: float | None = None,
                           bw_chunk: int | None = None,
                           slots: ElementwiseSlots | None = None):
    """Poyiadjis et al. (2011) O(N^2) smoother step:
    ``new_stats[i] = sum_j BW[i, j] * (stats[j] + h(x_j, x'_i))``.

    The statistics term is a batched matmul; the pairwise-h term evaluates
    the statistic on every pair of a block of ``bw_chunk`` rows, so the
    live memory is O(C * bw_chunk * N * H) instead of O(C * N^2 * H)."""
    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        parents, particles, log_w, _ = _propagate_apply(
            kernel, resampler_name, resample_mode, params, inp.u, inp.z,
            carry.particles, carry.log_weights, None, inp.y, ess_threshold)
        stats = poyiadjis_n2_statistics(kernel, stat_fn, params, carry,
                                        particles, inp, bw_chunk, slots)
        loglik = carry.loglik + inp.weight * inp.in_window * \
            _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def _backward_indices(kernel: ParticleKernel, params, particles,
                      log_weights, new_particles, v, bw_chunk):
    """Backward indices J [C, R, K] of the rows ``new_particles [C, R,
    D]`` over the N particles: ``J[c, i, k]`` is the inverse CDF of row i
    of the normalised backward weights at ``v[c, i, k]``, with the rows
    streamed in blocks of ``bw_chunk`` (float64 CDF, rounded once, as
    every selection of the port)."""
    C, n = log_weights.shape
    K = v.shape[-1]
    R = new_particles.shape[1]
    rows = R // _bw_row_chunks(bw_chunk, R)
    out = []
    for r in range(0, R, rows):
        x_t, x_next = _pairs(particles, new_particles[:, r:r + rows])
        log_bw = _backward_log_weights(kernel, params, log_weights, x_t,
                                       x_next)                  # [C, R, N]
        cdf = weights_cdf(log_bw.reshape(-1, n))
        out.append(ancestors(v[:, r:r + rows].reshape(-1, K), cdf)
                   .reshape(C, -1, K))
    return torch.cat(out, 1)


def _rewired_statistics(stat_fn: StatisticFn, params, carry: PFCarry,
                        new_particles, J, inp: PFStepInput,
                        slots: ElementwiseSlots | None = None):
    """PaRIS's update ``mean_k(stats[J_ik] + scale * h(x_{J_ik}, x'_i))``
    [C, N, H] from the previous carry and the backward indices J."""
    C, N, K = J.shape
    flat = J.reshape(C, N * K, 1)
    x_J = torch.gather(carry.particles, 1,
                       flat.expand(-1, -1, carry.particles.shape[-1]))
    s_J = torch.gather(carry.statistics, 1,
                       flat.expand(-1, -1, carry.statistics.shape[-1]))
    x_next = new_particles.repeat_interleave(K, 1)             # [C, NK, D]
    h = stat_fn(params, x_J, x_next, inp.y, inp.t)             # [C, NK, H]
    scale = (inp.weight * inp.in_window)[:, None, None]
    return _add_statistic(s_J, scale * h, inp.t, slots).reshape(
        C, N, K, -1).mean(2)


def _check_n_tilde(inp: PFStepInput, n_tilde: int) -> None:
    draws = inp.J if inp.J is not None else inp.v
    if draws is None or draws.shape[-1] != n_tilde:
        raise ValueError(f"PaRIS with n_tilde={n_tilde} needs backward "
                         f"uniforms v (or indices J) [C, N, {n_tilde}]")


def make_paris_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                    n_tilde: int = 2,
                    resampler_name: str = "multinomial",
                    resample_mode: str = "auto",
                    ess_threshold: float | None = None,
                    bw_chunk: int | None = None,
                    slots: ElementwiseSlots | None = None):
    """PaRIS (Olsson & Westerborn) step with exact backward sampling:
    ``n_tilde`` backward indices per particle from the normalised backward
    weights (``inp.J`` or the inverse CDF at ``inp.v``), streamed in row
    blocks of ``bw_chunk`` (the live memory is O(C * bw_chunk * N))."""
    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        _, particles, log_w, _ = _propagate_apply(
            kernel, resampler_name, resample_mode, params, inp.u, inp.z,
            carry.particles, carry.log_weights, None, inp.y, ess_threshold)
        _check_n_tilde(inp, n_tilde)
        J = inp.J
        if J is None:
            J = _backward_indices(kernel, params, carry.particles,
                                  carry.log_weights, particles, inp.v,
                                  bw_chunk)
        stats = _rewired_statistics(stat_fn, params, carry, particles, J,
                                    inp, slots)
        loglik = carry.loglik + inp.weight * inp.in_window * \
            _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


# paris_ar reads whether every lane has accepted (one host synchronisation
# on the card) once per this many rounds; the rounds in between are masked,
# so the law does not depend on it.
AR_CHECK_EVERY = 8


def _default_ar_budget(n: int) -> int:
    """The JAX package's (and the reference's) accept-reject budget."""
    return max(int(100 * math.log10(n / 10)), 8) if n > 10 else 8


def accept_reject_backward_indices(generator: torch.Generator,
                                   kernel: ParticleKernel, params,
                                   particles, log_weights, new_particles,
                                   v, max_accept_reject: int | None = None,
                                   bw_chunk: int | None = None):
    """PaRIS backward indices [C, N, K] by accept-reject (K = ``v``'s last
    axis): every (i, k) lane proposes an ancestor I by inverse CDF of the
    weights and accepts it with probability q(x_I -> x'_i) / q_max, for at
    most ``max_accept_reject`` masked rounds drawn from ``generator``
    (default 100 log10(N/10), at least 8); lanes still open then take the
    exact draw at ``v`` (:func:`make_paris_step`'s), so a budget of 0 gives
    that step's indices.  Counts its calls, rounds and host reads in
    ``accept_reject_backward_indices.calls`` / ``.rounds`` / ``.syncs``."""
    C, N = log_weights.shape
    K = v.shape[-1]
    budget = (_default_ar_budget(N) if max_accept_reject is None
              else max_accept_reject)
    dev, dt = log_weights.device, log_weights.dtype
    log_q_max = kernel.prior_log_density_max(params)[:, None]  # [C, 1]
    cdf = weights_cdf(log_weights)
    x_next = new_particles.repeat_interleave(K, 1)              # [C, NK, D]
    D = particles.shape[-1]
    accepted = torch.zeros((C, N * K), dtype=torch.bool, device=dev)
    J = torch.zeros((C, N * K), dtype=torch.int64, device=dev)
    rounds, done = 0, False
    while rounds < budget and not done:
        pos = torch.rand((C, N * K), generator=generator, dtype=dt,
                         device=dev)
        U = torch.rand((C, N * K), generator=generator, dtype=dt,
                       device=dev)
        I = ancestors(pos, cdf)
        x_prop = torch.gather(particles, 1, I[..., None].expand(-1, -1, D))
        log_q = kernel.prior_log_density(params, x_prop, x_next)
        now = (U <= torch.exp(log_q - log_q_max)) & ~accepted
        J = torch.where(now, I, J)
        accepted = accepted | now
        rounds += 1
        if rounds % AR_CHECK_EVERY == 0 or rounds == budget:
            accept_reject_backward_indices.syncs += 1
            done = bool(accepted.all())
    accept_reject_backward_indices.calls += 1
    accept_reject_backward_indices.rounds += rounds
    accepted, J = accepted.reshape(C, N, K), J.reshape(C, N, K)
    if not done:
        J_exact = _backward_indices(kernel, params, particles, log_weights,
                                    new_particles, v, bw_chunk)
        J = torch.where(accepted, J, J_exact)
    return J


accept_reject_backward_indices.calls = 0
accept_reject_backward_indices.rounds = 0
accept_reject_backward_indices.syncs = 0


def make_paris_ar_step(kernel: ParticleKernel, stat_fn: StatisticFn,
                       n_tilde: int = 2,
                       resampler_name: str = "multinomial",
                       resample_mode: str = "auto",
                       max_accept_reject: int | None = None,
                       ess_threshold: float | None = None,
                       bw_chunk: int | None = None,
                       slots: ElementwiseSlots | None = None):
    """PaRIS step with accept-reject backward sampling (O(N K) expected
    per round), its rounds drawn from ``inp.generator`` and its exact
    fallback at ``inp.v``."""
    def step(params, carry: PFCarry, inp: PFStepInput) -> PFCarry:
        if inp.generator is None:
            raise ValueError("paris_ar draws its accept-reject rounds from "
                             "the step input's generator, which is None")
        _check_n_tilde(inp, n_tilde)
        _, particles, log_w, _ = _propagate_apply(
            kernel, resampler_name, resample_mode, params, inp.u, inp.z,
            carry.particles, carry.log_weights, None, inp.y, ess_threshold)
        J = accept_reject_backward_indices(
            inp.generator, kernel, params, carry.particles,
            carry.log_weights, particles, inp.v, max_accept_reject,
            bw_chunk)
        stats = _rewired_statistics(stat_fn, params, carry, particles, J,
                                    inp, slots)
        loglik = carry.loglik + inp.weight * inp.in_window * \
            _loglik_increment(log_w)
        return PFCarry(particles, log_w, stats, loglik)

    return step


def make_smoother_step(name: str, kernel: ParticleKernel,
                       stat_fn: StatisticFn,
                       resampler_name: str = "multinomial",
                       lambduh: float = 0.95, n_tilde: int = 2,
                       logsumexp_mode: bool = False,
                       resample_mode: str = "auto",
                       ess_threshold: float | None = None,
                       bw_chunk: int | None = None,
                       slots: ElementwiseSlots | None = None):
    """Step function for the smoother ``name``; ``slots`` selects the
    elementwise statistic layout."""
    get_resampler(resampler_name)
    if name == "filter":
        return make_filter_step(kernel, stat_fn, resampler_name,
                                logsumexp_mode, resample_mode, ess_threshold,
                                slots)
    if name == "nemeth":
        return make_nemeth_step(kernel, stat_fn, lambduh, resampler_name,
                                resample_mode, ess_threshold, slots)
    if name == "poyiadjis_N":
        return make_nemeth_step(kernel, stat_fn, 1.0, resampler_name,
                                resample_mode, ess_threshold, slots)
    if name == "poyiadjis_N2":
        return make_poyiadjis_n2_step(kernel, stat_fn, resampler_name,
                                      resample_mode, ess_threshold, bw_chunk,
                                      slots)
    if name == "paris":
        return make_paris_step(kernel, stat_fn, n_tilde, resampler_name,
                               resample_mode, ess_threshold, bw_chunk, slots)
    if name == "paris_ar":
        return make_paris_ar_step(kernel, stat_fn, n_tilde, resampler_name,
                                  resample_mode, max_accept_reject=None,
                                  ess_threshold=ess_threshold,
                                  bw_chunk=bw_chunk, slots=slots)
    raise ValueError(f"Unrecognized pf = '{name}'")
