"""Buffered-PF score, noisy gradient, SGLD step and fit loop.

Counterpart of the SGLD part of ``sgmcmc_tpu/inference/sgmcmc.py``.  All
functions act on C chains at once (parameters with a leading chain axis)
and draw from an explicit ``torch.Generator``; the iteration loop is host
Python.  For CUDA tensors the score runs the whole window in the fused
CUDA kernel when the smoother is ``poyiadjis_N`` or ``nemeth`` with
systematic resampling (with or without the ESS gate); every other
configuration, and every configuration on the CPU, runs
``run_buffered_pf``, whose window steps launch the resample-apply kernel
for CUDA tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch import nn

from ..models.base import ParticleKernel, StatisticFn, params_map
from ..ops.buffered import run_buffered_pf, window_weights
from ..ops.cuda.fused_pf import fused_pf_score
from ..ops.cuda.philox import STREAM_INIT, philox_normals
from ..ops.subsequence import (buffered_window, sample_start, slice_window,
                               window_length)

RNG_MODES = ("host", "kernel")


@dataclasses.dataclass(frozen=True)
class PFScoreConfig:
    """Static configuration of the buffered PF score estimator."""
    n_particles: int = 1000
    subsequence_length: int = -1        # -1: full sequence
    buffer_length: int = 0
    minibatch_size: int = 1
    # nemeth | poyiadjis_N | poyiadjis_N2 | filter
    smoother: str = "poyiadjis_N"
    resampler: str = "multinomial"      # multinomial|systematic|stratified
    # the JAX package's mode names; all select identically (one kernel)
    resample_mode: str = "gather"
    lambduh: float = 0.95
    partition_style: str = "uniform"
    # ESS-adaptive resampling: resample only when ESS < ess_threshold * N.
    # None resamples every step.
    ess_threshold: float | None = None
    # row-block size of the poyiadjis_N2 backward weights (None: dense up
    # to N=8192)
    bw_chunk: int | None = None
    # 'kernel' generates the fused window's normals on the card from one
    # Philox seed per chain row (the proposal normals inside the kernel,
    # the initial-state normals with the standalone generator) instead of
    # drawing [R, W, Z, N] normals with the torch generator.  As in the JAX
    # package it only affects the fused route; the unfused path and the
    # CPU ignore it.
    rng: str = "host"

    def __post_init__(self):
        if self.rng not in RNG_MODES:
            raise ValueError(f"rng={self.rng!r} must be one of {RNG_MODES}")


def _fused_eligible(config: PFScoreConfig, fused_model) -> bool:
    """The fused window kernel handles the systematic-resampled Nemeth /
    Poyiadjis-O(N) smoothers (with or without the ESS gate) of models that
    provide a FusedModel."""
    return (fused_model is not None
            and config.smoother in ("poyiadjis_N", "nemeth")
            and config.resampler == "systematic")


class WindowDraws(NamedTuple):
    """Randomness of one score evaluation, R = chains x minibatch rows."""
    start: torch.Tensor     # [R] int64 subsequence starts
    z0: torch.Tensor        # [R, Z, N] initial-state normals
    # [R, W, Z, N] proposal normals; None when the kernel generates them
    normals: torch.Tensor | None
    # resampling uniforms in [0, 1): [R, W] systematic, else [R, W, N]
    u: torch.Tensor
    # [R] int64 Philox seeds of the in-kernel normals (rng='kernel')
    seeds: torch.Tensor | None = None


class PFScore(nn.Module):
    """Buffered particle-filter score estimator.

    ``score(generator, params, observations[T, m], draws=None)`` returns
    ``(gradient parameters, loglik [C])`` for C chains.  Each minibatch
    element is one buffered subsequence window run through the particle
    smoother; ``draws`` (see :meth:`draw`) replaces the generator's draws.
    """

    def __init__(self, kernel: ParticleKernel, stat_fn: StatisticFn,
                 statistic_dim: int, unpack, config: PFScoreConfig, T: int,
                 prior_mean_var_fn=None, fused_model=None):
        super().__init__()
        self.kernel, self.stat_fn = kernel, stat_fn
        self.statistic_dim, self.unpack = statistic_dim, unpack
        self.config, self.T = config, T
        self.prior_mean_var_fn = prior_mean_var_fn
        self.fused_model = fused_model
        S = config.subsequence_length
        self.full = (S == -1) or (S >= T)
        self.W = T if self.full else window_length(S, config.buffer_length,
                                                   T)
        self.fused_lambduh = (1.0 if config.smoother == "poyiadjis_N"
                              else config.lambduh)

    def uses_fused(self, device) -> bool:
        """Whether the score runs the fused window kernel on ``device``."""
        return (torch.device(device).type == "cuda"
                and _fused_eligible(self.config, self.fused_model))

    def draw(self, generator: torch.Generator, num_chains: int,
             device) -> WindowDraws:
        """The score's draws.  With ``rng='kernel'`` on the fused route no
        ``[R, W, Z, N]`` normals are allocated: each row gets a Philox seed,
        whose stream 1 gives the initial-state normals and stream 0 the
        proposal normals inside the kernel."""
        cfg = self.config
        R = num_chains * cfg.minibatch_size
        N, W, Z = cfg.n_particles, self.W, self.kernel.noise_dim
        if self.full:
            start = torch.zeros((R,), dtype=torch.int64, device=device)
        else:
            start = sample_start(generator, cfg.subsequence_length, self.T,
                                 R, cfg.partition_style, device)
        if cfg.rng == "kernel" and self.uses_fused(device):
            seeds = torch.randint(-2 ** 63, 2 ** 63 - 1, (R,),
                                  generator=generator, dtype=torch.int64,
                                  device=device)
            z0 = philox_normals(seeds, 1, Z, N, stream=STREAM_INIT)[:, 0]
            normals = None
        else:
            seeds = None
            z0 = torch.randn((R, Z, N), generator=generator, device=device)
            normals = torch.randn((R, W, Z, N), generator=generator,
                                  device=device)
        u_shape = (R, W) if cfg.resampler == "systematic" else (R, W, N)
        u = torch.rand(u_shape, generator=generator, device=device)
        return WindowDraws(start, z0, normals, u, seeds)

    def forward(self, generator, params, observations: torch.Tensor,
                draws: WindowDraws | None = None):
        cfg = self.config
        C, M = params.num_chains, cfg.minibatch_size
        R, W, dt = C * M, self.W, observations.dtype
        dev = observations.device
        if draws is None:
            draws = self.draw(generator, C, dev)
        rows = params if M == 1 else params_map(
            lambda x: x.repeat_interleave(M, 0), params)
        if self.full:
            window = observations[None].expand(R, -1, -1)
            step_w = torch.ones((R, W), dtype=dt, device=dev)
            in_win = step_w
        else:
            win = buffered_window(draws.start, cfg.subsequence_length,
                                  cfg.buffer_length, self.T,
                                  cfg.partition_style, dt)
            window = slice_window(observations, win.window_start, W)
            step_w, in_win = window_weights(win.t1, win.tL, win.weights, W,
                                            dt)
        if self.prior_mean_var_fn is None:
            pm = torch.zeros((R,), dtype=dt, device=dev)
            pv = torch.full((R,), 10.0, dtype=dt, device=dev)
        else:
            pm, pv = self.prior_mean_var_fn(rows)
        if self.uses_fused(dev):
            stat, ll = fused_pf_score(
                self.fused_model, rows, window[..., 0], step_w, draws.z0,
                draws.normals, draws.u, pm, pv, self.fused_lambduh,
                cfg.ess_threshold, draws.seeds)
        else:
            out = run_buffered_pf(
                self.kernel, self.stat_fn, rows, window, z0=draws.z0,
                normals=draws.normals, u=draws.u,
                statistic_dim=self.statistic_dim, smoother=cfg.smoother,
                step_weights=step_w, in_window=in_win, prior_mean=pm,
                prior_var=pv, resampler=cfg.resampler,
                resample_mode=cfg.resample_mode, lambduh=cfg.lambduh,
                ess_threshold=cfg.ess_threshold, bw_chunk=cfg.bw_chunk)
            stat, ll = out.mean_statistic, out.loglikelihood
        stat = stat.reshape(C, M, -1).mean(1)
        return self.unpack(stat), ll.reshape(C, M).mean(1)


def make_pf_score_fn(kernel: ParticleKernel, stat_fn: StatisticFn,
                     statistic_dim: int, unpack, config: PFScoreConfig,
                     T: int, prior_mean_var_fn=None,
                     fused_model=None) -> PFScore:
    """Build the buffered PF score estimator (see :class:`PFScore`)."""
    return PFScore(kernel, stat_fn, statistic_dim, unpack, config, T,
                   prior_mean_var_fn, fused_model)


def make_noisy_grad_fn(score_fn, grad_logprior_fn, T: int,
                       is_scaled: bool = True):
    """grad = (grad loglike estimate + grad logprior) / T."""
    scale = (1.0 / T) if is_scaled else 1.0

    def noisy_grad(generator, params, observations, draws=None):
        grad_ll, loglik = score_fn(generator, params, observations, draws)
        grad = params_map(lambda g, p: (g + p) * scale, grad_ll,
                          grad_logprior_fn(params))
        return grad, loglik

    return noisy_grad


def sgld_step(generator, params, observations, noisy_grad_fn, epsilon, T,
              is_scaled: bool = True, draws=None, noise=None):
    """theta += eps * grad + sqrt(2 eps) * N(0, 1/T).

    ``draws`` (the score's) and ``noise`` (standard normals shaped like
    ``params``) replace the generator's draws."""
    grad, loglik = noisy_grad_fn(generator, params, observations, draws)
    scale = (1.0 / T) if is_scaled else 1.0
    if noise is None:
        noise = params_map(lambda x: torch.randn(
            x.shape, generator=generator, dtype=x.dtype, device=x.device),
            params)
    std, sq = math.sqrt(scale), math.sqrt(2.0 * epsilon)
    new = params_map(lambda p, g, n: p + epsilon * g + sq * (std * n),
                     params, grad, noise)
    return new, loglik


def fit(generator, params, observations, step_fn, num_iters: int,
        project_fn=None, steps_per_iter: int = 1, output_all: bool = True):
    """Run ``num_iters`` iterations of ``step_fn(generator, params,
    observations) -> (params, loglik [C])``, each of ``steps_per_iter``
    steps followed by the projection.

    Returns ``(final_params, trace, aux)``: the trace stacks the parameters
    after each iteration along axis 1 (``[C, num_iters, ...]``; None
    without ``output_all``), aux the last step's loglik ``[C, num_iters]``.
    """
    trace, aux = [], []
    for _ in range(num_iters):
        for _ in range(steps_per_iter):
            params, ll = step_fn(generator, params, observations)
            if project_fn is not None:
                params = project_fn(params)
        if output_all:
            trace.append(params)
        aux.append(ll)
    stacked = (params_map(lambda *xs: torch.stack(xs, 1), *trace)
               if output_all else None)
    return params, stacked, torch.stack(aux, 1)
