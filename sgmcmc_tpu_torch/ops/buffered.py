"""Buffered particle smoother over one window, as a plain PyTorch loop.

Counterpart of ``sgmcmc_tpu/ops/buffered.py``: every smoother of
``ops/smoothers.py``, one resample-apply per window step (the CUDA kernel
of ``ops/cuda/resample.py`` for CUDA tensors).  For systematic resampling
the fused kernel (``ops/cuda/fused_pf.py``) computes the same window in
one launch.  Randomness is an input, in the fused kernel's layout:
``z0 [C, Z, N]``, ``normals [C, W, Z, N]`` and the resampling uniforms
``u``, ``[C, W]`` for systematic and ``[C, W, N]`` for multinomial and
stratified resampling.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.base import ParticleKernel, StatisticFn
from .resampling import normalize_log_weights
from .smoothers import PFCarry, PFStepInput, make_smoother_step


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
        prior_mean=0.0,                  # [C] or scalar
        prior_var=1.0,                   # [C] or scalar
        resampler: str = "multinomial",
        resample_mode: str = "auto",
        lambduh: float = 0.95,
        logsumexp_mode: bool = False,
        ess_threshold: float | None = None,
        bw_chunk: int | None = None,
        elementwise: bool = False,
        save_all: bool = False,
        fixed_lag: int | None = None,
        step_valid: torch.Tensor | None = None,     # [C, W] {0., 1.}
) -> PFOutput:
    """Run ``W`` steps of a buffered particle smoother over each chain's
    window.  ``step_weights`` carries both the buffering (zero outside
    ``[t1, tL)``) and the subsequence-unbiasedness weights; ``in_window``
    gates the log-likelihood accumulation.  ``step_valid`` freezes the
    whole carry (running log-likelihood included) of a chain on the steps
    where it is not positive: the padded tails of multi-sequence
    windows."""
    if elementwise or save_all or fixed_lag is not None:
        raise NotImplementedError(
            "elementwise, fixed-lag and save_all modes are not ported yet")
    C, W = observations.shape[:2]
    dtype, dev = observations.dtype, observations.device
    if step_weights is None:
        step_weights = torch.ones((C, W), dtype=dtype, device=dev)
    if in_window is None:
        in_window = (step_weights > 0).to(dtype)
    step = make_smoother_step(smoother, kernel, stat_fn, resampler,
                              lambduh=lambduh, logsumexp_mode=logsumexp_mode,
                              resample_mode=resample_mode,
                              ess_threshold=ess_threshold, bw_chunk=bw_chunk)
    D = kernel.state_dim
    N = z0.shape[-1]
    pm = torch.as_tensor(prior_mean, dtype=dtype, device=dev).reshape(-1)
    pv = torch.as_tensor(prior_var, dtype=dtype, device=dev).reshape(-1)
    x0 = kernel.sample_x0(params, z0[:, :D].transpose(1, 2), pm, pv)
    stats_shape = ((C, statistic_dim) if smoother == "filter"
                   else (C, N, statistic_dim))
    carry = PFCarry(x0, torch.zeros((C, N), dtype=dtype, device=dev),
                    torch.zeros(stats_shape, dtype=dtype, device=dev),
                    torch.zeros((C,), dtype=dtype, device=dev))
    for t in range(W):
        new = step(params, carry, PFStepInput(
            z=normals[:, t].transpose(1, 2), u=u[:, t],
            y=observations[:, t], weight=step_weights[:, t],
            in_window=in_window[:, t], t=t))
        if step_valid is not None:
            act = step_valid[:, t] > 0
            new = PFCarry(*[torch.where(
                act.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
                for n, o in zip(new, carry)])
        carry = new
    return PFOutput(statistics=carry.statistics,
                    log_weights=carry.log_weights,
                    particles=carry.particles,
                    loglikelihood=carry.loglik,
                    mean_statistic=average_statistic(carry.statistics,
                                                     carry.log_weights))


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
