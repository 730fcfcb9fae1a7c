"""Buffered-PF score, noisy gradient, SGLD step and fit loop.

Counterpart of the SGLD part of ``sgmcmc_tpu/inference/sgmcmc.py``, with
the multi-sequence score of ``make_seq_pf_score_fn``.  All functions act
on C chains at once (parameters with a leading chain axis) and draw from
an explicit ``torch.Generator``; the iteration loop is host Python.  For
CUDA tensors the score runs the whole window in the fused CUDA kernel when
the smoother is ``poyiadjis_N`` or ``nemeth`` with systematic resampling
(with or without the ESS gate and the valid gate); every other
configuration, and every configuration on the CPU, runs
``run_buffered_pf``, whose window steps launch the resample-apply kernel
for CUDA tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..models.base import ParticleKernel, StatisticFn, params_map
from ..ops.buffered import run_buffered_pf, window_weights
from ..ops.cuda.fused_pf import fused_pf_score
from ..ops.cuda.philox import STREAM_INIT, philox_normals
from ..ops.subsequence import (buffered_window, sample_start,
                               sequence_window, slice_window, window_length)

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
    # [R] int64 sequence that each row reads (the multi-sequence score)
    seq: torch.Tensor | None = None


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

    @property
    def rows_per_chain(self) -> int:
        return self.config.minibatch_size

    def draw(self, generator: torch.Generator, num_chains: int,
             device) -> WindowDraws:
        """The score's draws.  With ``rng='kernel'`` on the fused route no
        ``[R, W, Z, N]`` normals are allocated: each row gets a Philox seed,
        whose stream 1 gives the initial-state normals and stream 0 the
        proposal normals inside the kernel."""
        cfg = self.config
        R = num_chains * cfg.minibatch_size
        if self.full:
            start = torch.zeros((R,), dtype=torch.int64, device=device)
        else:
            start = sample_start(generator, cfg.subsequence_length, self.T,
                                 R, cfg.partition_style, device)
        return self._noise(generator, device, start)

    def _noise(self, generator, device, start, seq=None) -> WindowDraws:
        """The particle filter's draws for the rows of ``start``."""
        cfg = self.config
        R = start.shape[0]
        N, W, Z = cfg.n_particles, self.W, self.kernel.noise_dim
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
        return WindowDraws(start, z0, normals, u, seeds, seq)

    def _layout(self, draws: WindowDraws, observations: torch.Tensor):
        """(windows [R, W, m], step weights [R, W], in-window [R, W],
        step validity [R, W] or None)."""
        cfg = self.config
        R, W, dt = draws.start.shape[0], self.W, observations.dtype
        if self.full:
            window = observations[None].expand(R, -1, -1)
            step_w = torch.ones((R, W), dtype=dt, device=observations.device)
            return window, step_w, step_w, None
        win = buffered_window(draws.start, cfg.subsequence_length,
                              cfg.buffer_length, self.T,
                              cfg.partition_style, dt)
        window = slice_window(observations, win.window_start, W)
        step_w, in_win = window_weights(win.t1, win.tL, win.weights, W, dt)
        return window, step_w, in_win, None

    def _combine(self, stat, loglik, draws: WindowDraws):
        """Per-chain score from the rows' ``stat [C, M, H]`` and
        ``loglik [C, M]``: the minibatch mean."""
        return stat.mean(1), loglik.mean(1)

    def forward(self, generator, params, observations: torch.Tensor,
                draws: WindowDraws | None = None):
        cfg = self.config
        C, M = params.num_chains, self.rows_per_chain
        R, dt = C * M, observations.dtype
        dev = observations.device
        if draws is None:
            draws = self.draw(generator, C, dev)
        rows = params if M == 1 else params_map(
            lambda x: x.repeat_interleave(M, 0), params)
        window, step_w, in_win, valid = self._layout(draws, observations)
        if self.prior_mean_var_fn is None:
            pm = torch.zeros((R,), dtype=dt, device=dev)
            pv = torch.full((R,), 10.0, dtype=dt, device=dev)
        else:
            pm, pv = self.prior_mean_var_fn(rows)
        if self.uses_fused(dev):
            stat, ll = fused_pf_score(
                self.fused_model, rows, window[..., 0], step_w, draws.z0,
                draws.normals, draws.u, pm, pv, self.fused_lambduh,
                cfg.ess_threshold, draws.seeds, valid)
        else:
            out = run_buffered_pf(
                self.kernel, self.stat_fn, rows, window, z0=draws.z0,
                normals=draws.normals, u=draws.u,
                statistic_dim=self.statistic_dim, smoother=cfg.smoother,
                step_weights=step_w, in_window=in_win, prior_mean=pm,
                prior_var=pv, resampler=cfg.resampler,
                resample_mode=cfg.resample_mode, lambduh=cfg.lambduh,
                ess_threshold=cfg.ess_threshold, bw_chunk=cfg.bw_chunk,
                step_valid=valid)
            stat, ll = out.mean_statistic, out.loglikelihood
        stat, ll = self._combine(stat.reshape(C, M, -1), ll.reshape(C, M),
                                 draws)
        return self.unpack(stat), ll


class SeqPFScore(PFScore):
    """Multi-sequence buffered particle-filter score (counterpart of
    ``make_seq_pf_score_fn``).

    The observations are packed ``[n_seq, T_max, m]`` with true
    ``lengths``.  Each chain draws ``num_sequences`` sequences without
    replacement (-1: all of them, in order) and runs one buffered
    subsequence per chosen sequence, on ``C * k`` rows at once; the
    statistics and log-likelihoods are summed over the chosen sequences
    and rescaled by ``T_total / sum(T_chosen)``.  With
    ``subsequence_length == -1`` (the full-sequence estimator) or
    ``buffer_length == -1`` (full buffers) the window is the whole padded
    sequence and the steps past ``T_i`` are validity-gated, so padding
    cannot reach the filter.  ``minibatch_size`` is not used.
    """

    def __init__(self, kernel: ParticleKernel, stat_fn: StatisticFn,
                 statistic_dim: int, unpack, config: PFScoreConfig, lengths,
                 num_sequences: int = -1, prior_mean_var_fn=None,
                 fused_model=None):
        lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64)
        super().__init__(kernel, stat_fn, statistic_dim, unpack, config,
                         int(lengths.sum()), prior_mean_var_fn, fused_model)
        self.lengths = lengths
        n_seq, T_max = len(lengths), int(lengths.max())
        min_len = int(lengths.min())
        S, B = config.subsequence_length, config.buffer_length
        self.full = S == -1
        if self.full or B == -1:
            self.W = T_max
            if not self.full and S > min_len:
                raise ValueError(f"subsequence {S} exceeds shortest "
                                 f"sequence {min_len}")
        else:
            self.W = S + 2 * B
            if self.W > min_len:
                raise ValueError(f"window {self.W} exceeds shortest "
                                 f"sequence {min_len}")
        if num_sequences != -1 and not 1 <= num_sequences <= n_seq:
            raise ValueError(f"num_sequences={num_sequences} must be -1 or "
                             f"in [1, {n_seq}]")
        self.num_sequences = num_sequences
        self.k = n_seq if num_sequences == -1 else num_sequences

    @property
    def rows_per_chain(self) -> int:
        return self.k

    def draw(self, generator: torch.Generator, num_chains: int, device,
             seq: torch.Tensor | None = None) -> WindowDraws:
        """The score's draws for ``num_chains * k`` rows: the sequences
        ``seq`` (chain-major; drawn without replacement per chain unless
        given), the starts ``floor(u * (T_i - S + 1))`` and the particle
        filter's draws."""
        n_seq = len(self.lengths)
        if seq is None:
            if self.num_sequences == -1:
                seq = torch.arange(n_seq, device=device).repeat(num_chains)
            else:
                seq = torch.rand((num_chains, n_seq), generator=generator,
                                 device=device).argsort(1)[:, :self.k]
        seq = seq.reshape(-1).to(device)
        S = self.config.subsequence_length
        if self.full:
            start = torch.zeros_like(seq)
        else:
            n = self.lengths.to(device)[seq] - S + 1
            u = torch.rand(seq.shape, generator=generator,
                           dtype=torch.float64, device=device)
            start = torch.minimum((u * n).long(), n - 1)
        return self._noise(generator, device, start, seq)

    def _layout(self, draws: WindowDraws, observations: torch.Tensor):
        cfg = self.config
        W, dt = self.W, observations.dtype
        T_i = self.lengths.to(observations.device)[draws.seq]
        win = sequence_window(draws.start, T_i, cfg.subsequence_length,
                              cfg.buffer_length, observations.shape[1], dt)
        t = torch.arange(W, device=observations.device)
        window = observations[draws.seq[:, None],
                              win.window_start[:, None] + t]
        step_w, in_win = window_weights(win.t1, win.tL, win.weights, W, dt)
        valid = None
        if self.full or cfg.buffer_length == -1:    # whole padded sequences
            valid = (t < T_i[:, None]).to(dt)
        return window, step_w, in_win, valid

    def _combine(self, stat, loglik, draws: WindowDraws):
        """Sum over the chosen sequences, rescaled by
        ``T_total / sum(T_chosen)``."""
        C, dt = stat.shape[0], stat.dtype
        chosen = self.lengths.to(stat.device)[draws.seq].reshape(C, -1)
        scale = torch.full((C,), float(self.T), dtype=dt,
                           device=stat.device) / chosen.sum(1).to(dt)
        return stat.sum(1) * scale[:, None], loglik.sum(1) * scale


def make_pf_score_fn(kernel: ParticleKernel, stat_fn: StatisticFn,
                     statistic_dim: int, unpack, config: PFScoreConfig,
                     T: int, prior_mean_var_fn=None,
                     fused_model=None) -> PFScore:
    """Build the buffered PF score estimator (see :class:`PFScore`)."""
    return PFScore(kernel, stat_fn, statistic_dim, unpack, config, T,
                   prior_mean_var_fn, fused_model)


def make_seq_pf_score_fn(kernel: ParticleKernel, stat_fn: StatisticFn,
                         statistic_dim: int, unpack, config: PFScoreConfig,
                         lengths, num_sequences: int = -1,
                         prior_mean_var_fn=None,
                         fused_model=None) -> SeqPFScore:
    """Build the multi-sequence score (see :class:`SeqPFScore`)."""
    return SeqPFScore(kernel, stat_fn, statistic_dim, unpack, config,
                      lengths, num_sequences, prior_mean_var_fn, fused_model)


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
