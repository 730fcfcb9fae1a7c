"""Buffered particle smoother over one window, as a plain PyTorch loop.

Counterpart of ``sgmcmc_tpu/ops/buffered.py``: every smoother of
``ops/smoothers.py``, one resample-apply per window step (the CUDA kernel
of ``ops/cuda/resample.py`` for CUDA tensors).  For systematic resampling
the fused kernel (``ops/cuda/fused_pf.py``) computes the same window in
one launch.  Randomness is an input, in the fused kernel's layout:
``z0 [C, Z, N]``, ``normals [C, W, Z, N]`` and the resampling uniforms
``u``, ``[C, W]`` for systematic and ``[C, W, N]`` for multinomial and
stratified resampling, and PaRIS's backward uniforms ``v [C, W, N,
n_tilde]`` (or its backward indices ``J`` of that shape).

On CUDA float32 tensors the Poyiadjis O(N) smoother of a model with a
fused body in ``ops/cuda/smoother_step.STEP_BODIES`` (``fused_model``),
without the ESS gate, ``step_valid`` or the predict modes, keeps its carry
as one ``[C, N, D + H]`` buffer and runs each window step as two kernels:
resample-apply on the buffer, then the step kernel of
``ops/cuda/smoother_step.py`` (proposal, reweighting, statistic, the next
step's CDF and the log-likelihood).  It gives the same carry and CDF, bit
for bit, as the PyTorch step of ``ops/smoothers.py`` that every other
configuration runs; only the log-likelihood's sum takes another order.

The predict surface runs three more modes: ``elementwise`` (step t's
statistic in its own slot of a ``[window_length * dim]`` statistic),
``fixed_lag`` (slot t - lag read at step t) and ``save_all`` (every
step's carry).  The elementwise statistic is resampled with the particles
by the same resample-apply kernel, however wide it is.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.base import ParticleKernel, StatisticFn
from ..utils.profiling import span
from .cuda.resample import (check_mode, resample_apply,
                            resample_positions, weights_cdf)
from .cuda.smoother_step import STEP_BODIES, smoother_step
from .resampling import get_resampler, normalize_log_weights
from .smoothers import (ElementwiseSlots, PFCarry, PFStepInput,
                        make_smoother_step)


class PFOutput(NamedTuple):
    statistics: torch.Tensor      # [C, N, H] (smoothers) / [C, H] (filter)
    log_weights: torch.Tensor     # [C, N]
    particles: torch.Tensor       # [C, N, D]
    loglikelihood: torch.Tensor   # [C]
    mean_statistic: torch.Tensor  # [C, H] weight-averaged final statistic


def average_statistic(statistics: torch.Tensor,
                      log_weights: torch.Tensor) -> torch.Tensor:
    """Weight-averaged final statistic [C, H]."""
    if statistics.dim() == 2:
        return statistics
    probs = normalize_log_weights(log_weights)
    return (statistics * probs[..., None]).sum(1)


def run_buffered_pf(
        kernel: ParticleKernel,
        stat_fn: StatisticFn,
        params,
        observations: torch.Tensor,      # [C, W, m] buffered windows
        *,
        z0: torch.Tensor,                # [C, Z, N] initial-state normals
        normals: torch.Tensor,           # [C, W, Z, N] proposal normals
        u: torch.Tensor,                 # [C, W] or [C, W, N] uniforms
        statistic_dim: int,
        smoother: str = "poyiadjis_N",
        step_weights: torch.Tensor | None = None,   # [C, W]
        in_window: torch.Tensor | None = None,      # [C, W] {0., 1.}
        prior_mean=0.0,                  # [C] or scalar, or [C, D]
        prior_var=1.0,                   # [C] or scalar, or [C, D, D]
        resampler: str = "multinomial",
        resample_mode: str = "auto",
        lambduh: float = 0.95,
        n_tilde: int = 2,
        logsumexp_mode: bool = False,
        ess_threshold: float | None = None,
        bw_chunk: int | None = None,
        elementwise: bool = False,
        window_length: int | None = None,
        save_all: bool = False,
        fixed_lag: int | None = None,
        step_valid: torch.Tensor | None = None,     # [C, W] {0., 1.}
        v: torch.Tensor | None = None,              # [C, W, N, n_tilde]
        J: torch.Tensor | None = None,              # [C, W, N, n_tilde]
        generator: torch.Generator | None = None,   # paris_ar's rounds
        fused_model=None,                           # FusedModel of kernel
) -> PFOutput:
    """Run ``W`` steps of a buffered particle smoother over each chain's
    window.  ``step_weights`` carries both the buffering (zero outside
    ``[t1, tL)``) and the subsequence-unbiasedness weights; ``in_window``
    gates the log-likelihood accumulation.  ``step_valid`` freezes the
    whole carry (running log-likelihood included) of a chain on the steps
    where it is not positive: the padded tails of multi-sequence
    windows.  PaRIS takes its backward uniforms ``v`` (or indices ``J``)
    and, for ``paris_ar``, the ``generator`` of its accept-reject
    rounds.  ``fused_model``, the fused-window bundle of ``kernel`` and
    ``stat_fn``, lets the step kernel run the window where the module
    docstring says.

    ``elementwise`` (with ``window_length`` L) keeps step t's statistic in
    slot ``t - t1`` of a ``[C, (N,) L * statistic_dim]`` statistic, t1
    being each chain's first in-window step.  ``fixed_lag`` (elementwise
    smoothers only) returns in ``mean_statistic`` the fixed-lag smoothed
    statistics E[h_t | y_{<= t+lag}]: slot t weighted at step t + lag, the
    last ``min(lag, W)`` slots the final smoothed value.  ``save_all``
    returns ``(out, saved)`` with every step's carry stacked along a
    leading step axis ``[W, ...]``.

    Each window step that takes the PyTorch step, not the step kernel,
    counts one in ``run_buffered_pf.pytorch_steps``."""
    C, W = observations.shape[:2]
    dtype, dev = observations.dtype, observations.device
    if step_weights is None:
        step_weights = torch.ones((C, W), dtype=dtype, device=dev)
    if in_window is None:
        in_window = (step_weights > 0).to(dtype)
    H, slots = statistic_dim, None
    if elementwise:
        if window_length is None:
            raise ValueError("elementwise mode needs static window_length")
        t1 = (in_window > 0).to(torch.int32).argmax(1)
        slots = ElementwiseSlots(t1, int(window_length), statistic_dim)
        H = statistic_dim * int(window_length)
    if fixed_lag is not None:
        if not elementwise or smoother == "filter":
            raise ValueError("fixed_lag requires an elementwise smoother")
        if save_all:
            raise ValueError("fixed_lag and save_all are exclusive")
    if (fused_model is not None and fused_model.body in STEP_BODIES
            and smoother == "poyiadjis_N" and ess_threshold is None
            and step_valid is None and not elementwise and not save_all
            and fixed_lag is None and dev.type == "cuda"
            and all(x.dtype == torch.float32
                    for x in (observations, z0, normals, u, step_weights,
                              in_window))):
        return run_step_kernel(fused_model, kernel, params, observations,
                               z0=z0, normals=normals, u=u,
                               statistic_dim=statistic_dim,
                               step_weights=step_weights,
                               in_window=in_window, prior_mean=prior_mean,
                               prior_var=prior_var, resampler=resampler,
                               resample_mode=resample_mode)
    step = make_smoother_step(smoother, kernel, stat_fn, resampler,
                              lambduh=lambduh, n_tilde=n_tilde,
                              logsumexp_mode=logsumexp_mode,
                              resample_mode=resample_mode,
                              ess_threshold=ess_threshold, bw_chunk=bw_chunk,
                              slots=slots)
    D = kernel.state_dim
    N = z0.shape[-1]
    x0 = _initial_particles(kernel, params, z0, prior_mean, prior_var,
                            dtype, dev)
    stats_shape = (C, H) if smoother == "filter" else (C, N, H)
    carry = PFCarry(x0, torch.zeros((C, N), dtype=dtype, device=dev),
                    torch.zeros(stats_shape, dtype=dtype, device=dev),
                    torch.zeros((C,), dtype=dtype, device=dev))
    saved = []
    for t in range(W):
        run_buffered_pf.pytorch_steps += 1
        with span("sgmcmc.smoother.step"):
            new = step(params, carry, PFStepInput(
                z=normals[:, t].transpose(1, 2), u=u[:, t],
                y=observations[:, t], weight=step_weights[:, t],
                in_window=in_window[:, t], t=t,
                v=None if v is None else v[:, t],
                J=None if J is None else J[:, t], generator=generator))
            if step_valid is not None:
                act = step_valid[:, t] > 0
                new = PFCarry(*[torch.where(
                    act.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                    for n, o in zip(new, carry)])
            carry = new
            if fixed_lag is not None:
                # slot t - lag over the current cloud: E[h_{t-lag} | y_{<= t}]
                c0 = max(t - fixed_lag, 0) * statistic_dim
                probs = normalize_log_weights(carry.log_weights)
                saved.append((probs[:, None, :] @ carry.statistics[
                    ..., c0:c0 + statistic_dim])[:, 0])            # [C, dim]
            elif save_all:
                saved.append(carry)
    mean_stat = average_statistic(carry.statistics, carry.log_weights)
    if fixed_lag is not None:
        lag = min(fixed_lag, W)
        final = mean_stat.reshape(C, -1, statistic_dim)
        # lagged[t] was read at step t + lag; the last `lag` slots keep the
        # final smoothed value (the same observations), and slots beyond W
        # (zero-padded) their final value
        lagged = torch.cat([torch.stack(saved, 1)[:, lag:],
                            final[:, W - lag:W], final[:, W:]], 1)
        mean_stat = lagged.reshape(C, -1)
    out = PFOutput(statistics=carry.statistics,
                   log_weights=carry.log_weights,
                   particles=carry.particles,
                   loglikelihood=carry.loglik,
                   mean_statistic=mean_stat)
    if save_all:
        return out, PFCarry(*[torch.stack(x) for x in zip(*saved)])
    return out


# window steps run by the PyTorch step of ops/smoothers.py (every route but
# the step kernel's)
run_buffered_pf.pytorch_steps = 0


def _initial_particles(kernel: ParticleKernel, params, z0, prior_mean,
                       prior_var, dtype, dev) -> torch.Tensor:
    """The initial particles [C, N, D] from the normals ``z0 [C, Z, N]``."""
    pm = torch.as_tensor(prior_mean, dtype=dtype, device=dev)
    pv = torch.as_tensor(prior_var, dtype=dtype, device=dev)
    if pv.dim() < 3:            # a variance per chain (or one for all)
        pm, pv = pm.reshape(-1), pv.reshape(-1)
    D = kernel.state_dim
    return kernel.sample_x0(params, z0[:, :D].transpose(1, 2), pm, pv)


def run_step_kernel(fused_model, kernel: ParticleKernel, params,
                    observations: torch.Tensor, *, z0: torch.Tensor,
                    normals: torch.Tensor, u: torch.Tensor,
                    statistic_dim: int, step_weights: torch.Tensor,
                    in_window: torch.Tensor, prior_mean=0.0, prior_var=1.0,
                    resampler: str = "multinomial",
                    resample_mode: str = "auto") -> PFOutput:
    """The Poyiadjis O(N) window on one ``[C, N, D + H]`` carry buffer:
    each step resample-apply on the buffer at the previous step's CDF, then
    :func:`~.cuda.smoother_step.smoother_step` back into it (the kernel on
    CUDA tensors, its plain version on CPU tensors).  The arguments are
    :func:`run_buffered_pf`'s, with the step weights and in-window flags
    given; ``run_buffered_pf`` takes this route where its docstring
    says."""
    get_resampler(resampler)
    check_mode(resample_mode)
    C, W = observations.shape[:2]
    D, N = kernel.state_dim, z0.shape[-1]
    dtype, dev = observations.dtype, observations.device
    carry = torch.zeros((C, N, D + statistic_dim), dtype=dtype, device=dev)
    carry[..., :D] = _initial_particles(kernel, params, z0, prior_mean,
                                        prior_var, dtype, dev)
    log_w = torch.zeros((C, N), dtype=dtype, device=dev)
    cdf = weights_cdf(log_w)
    loglik = torch.zeros((C,), dtype=dtype, device=dev)
    pvec = fused_model.pack_params(params).contiguous()
    for t in range(W):
        with span("sgmcmc.smoother.step"):
            pos = resample_positions(resampler, u[:, t], N).contiguous()
            rows = resample_apply(pos, cdf, carry)
            smoother_step(fused_model, pvec, rows, normals[:, t],
                          observations[:, t, 0], step_weights[:, t],
                          in_window[:, t], carry, log_w, cdf, loglik)
    stats = carry[..., D:]
    return PFOutput(statistics=stats, log_weights=log_w,
                    particles=carry[..., :D], loglikelihood=loglik,
                    mean_statistic=average_statistic(stats, log_w))


def window_weights(t1: torch.Tensor, tL: torch.Tensor,
                   subseq_weights: torch.Tensor, window: int,
                   dtype=torch.float32):
    """Expand subsequence weights [C, S] into step weights [C, W]: steps in
    ``[t1, tL)`` get ``subseq_weights[t - t1]``, all others 0.  Returns
    ``(step_weights, in_window)``."""
    t = torch.arange(window, device=t1.device)
    rel = t - t1[:, None]
    S = subseq_weights.shape[-1]
    valid = (rel >= 0) & (t < tL[:, None])
    w = torch.gather(subseq_weights, 1, rel.clamp(0, S - 1))
    return (torch.where(valid, w, torch.zeros_like(w)).to(dtype),
            valid.to(dtype))
