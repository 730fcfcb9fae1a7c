"""Buffered-PF and exact-message scores, noisy gradient, steppers and fit
loops.

Counterpart of ``sgmcmc_tpu/inference/sgmcmc.py``: the scores (with the
multi-sequence ``make_seq_pf_score_fn`` / ``make_seq_marginal_score_fn``
and the exact-message ``make_marginal_score_fn``), the SGLD, SGRLD,
SGLD-CV, SGD and ADAGRAD steps, the preconditioner protocol and the fit
loops.  All functions act on C chains at once (parameters with a leading
chain axis) and draw from an explicit ``torch.Generator``; the iteration
loop is host Python.

The route rule of the particle-filter score: for CUDA tensors it runs the
whole window in the fused CUDA kernel when the smoother is
``poyiadjis_N`` or ``nemeth`` with systematic resampling (with or without
the ESS gate and the valid gate), the resample mode is one of
``FUSED_RESAMPLE_MODES`` (the default ``"auto"`` is) and one block of the
window fits the card's shared memory; every other configuration, and
every configuration on the CPU, runs ``run_buffered_pf``, whose window
steps launch the resample-apply kernel for CUDA tensors.  Unlike the JAX
package's rule, any particle count takes the fused route (its
``n_particles % 8 == 0`` is a TPU layout constraint); the two routes
agree in law.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ..models.base import ParticleKernel, StatisticFn, params_map
from ..ops.buffered import run_buffered_pf, window_weights
from ..ops.cuda import fused_pf
from ..ops.cuda.fused_pf import fused_pf_score
from ..ops.cuda.philox import STREAM_INIT, philox_normals
from ..ops.subsequence import (buffered_window, sample_start,
                               sequence_window, slice_window,
                               subsequence_weights, window_length)

RNG_MODES = ("host", "kernel")
PARIS_SMOOTHERS = ("paris", "paris_ar")
# The JAX package's resample modes under which the fused kernel may run;
# an explicit other mode ("gather", "xla", ...) takes the unfused route.
FUSED_RESAMPLE_MODES = ("auto", "pallas", "pallas2", "fused")


@dataclasses.dataclass(frozen=True)
class PFScoreConfig:
    """Static configuration of the buffered PF score estimator."""
    n_particles: int = 1000
    subsequence_length: int = -1        # -1: full sequence
    buffer_length: int = 0
    minibatch_size: int = 1
    # nemeth | poyiadjis_N | poyiadjis_N2 | paris | paris_ar | filter
    smoother: str = "poyiadjis_N"
    resampler: str = "multinomial"      # multinomial|systematic|stratified
    # the JAX package's mode names: all select identically (one kernel);
    # those outside FUSED_RESAMPLE_MODES, the default among them, also keep
    # the score off the fused kernel (the samplers pass "auto")
    resample_mode: str = "gather"
    lambduh: float = 0.95
    # PaRIS's backward draws per particle
    n_tilde: int = 2
    partition_style: str = "uniform"
    # ESS-adaptive resampling: resample only when ESS < ess_threshold * N.
    # None resamples every step.
    ess_threshold: float | None = None
    # row-block size of the poyiadjis_N2 / PaRIS backward weights (None:
    # dense up to N=8192)
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
    provide a FusedModel, under the resample modes that allow it."""
    return (fused_model is not None
            and config.smoother in ("poyiadjis_N", "nemeth")
            and config.resampler == "systematic"
            and config.resample_mode in FUSED_RESAMPLE_MODES)


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
    # PaRIS's backward uniforms [R, W, N, n_tilde]
    v: torch.Tensor | None = None


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
        self.valid_gate = False

    def uses_fused(self, device) -> bool:
        """Whether the score runs the fused window kernel on ``device``:
        the route rule of the module docstring.  A particle count whose
        block exceeds the card's shared memory takes the unfused route."""
        return (torch.device(device).type == "cuda"
                and _fused_eligible(self.config, self.fused_model)
                and fused_pf.fits_shared_memory(
                    self.fused_model.body, self.W, self.config.n_particles,
                    self.valid_gate))

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
        v = (torch.rand((R, W, N, cfg.n_tilde), generator=generator,
                        device=device)
             if cfg.smoother in PARIS_SMOOTHERS else None)
        return WindowDraws(start, z0, normals, u, seeds, seq, v)

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
                n_tilde=cfg.n_tilde, ess_threshold=cfg.ess_threshold,
                bw_chunk=cfg.bw_chunk, step_valid=valid, v=draws.v,
                generator=generator)
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
        self.valid_gate = self.full or B == -1
        self.num_sequences = num_sequences
        self.k = _chosen_count(num_sequences, n_seq)

    @property
    def rows_per_chain(self) -> int:
        return self.k

    def draw(self, generator: torch.Generator, num_chains: int, device,
             seq: torch.Tensor | None = None) -> WindowDraws:
        """The score's draws for ``num_chains * k`` rows: the sequences
        ``seq`` (chain-major; drawn without replacement per chain unless
        given), the starts ``floor(u * (T_i - S + 1))`` and the particle
        filter's draws."""
        seq, start = _sequence_draw(generator, self.lengths, self.k,
                                    self.num_sequences,
                                    self.config.subsequence_length,
                                    self.full, num_chains, device, seq)
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
        if self.valid_gate:                         # whole padded sequences
            valid = (t < T_i[:, None]).to(dt)
        return window, step_w, in_win, valid

    def _combine(self, stat, loglik, draws: WindowDraws):
        """Sum over the chosen sequences, rescaled by
        ``T_total / sum(T_chosen)``."""
        scale = _sequence_scale(self.lengths, self.T, draws.seq,
                                stat.shape[0], stat.dtype)
        return stat.sum(1) * scale[:, None], loglik.sum(1) * scale


def _chosen_count(num_sequences: int, n_seq: int) -> int:
    if num_sequences != -1 and not 1 <= num_sequences <= n_seq:
        raise ValueError(f"num_sequences={num_sequences} must be -1 or "
                         f"in [1, {n_seq}]")
    return n_seq if num_sequences == -1 else num_sequences


def _sequence_draw(generator, lengths, k: int, num_sequences: int, S: int,
                   full: bool, num_chains: int, device, seq=None):
    """(seq, start) of ``num_chains * k`` rows, chain-major: the sequences
    (drawn without replacement per chain unless given; all of them in order
    for ``num_sequences == -1``) and the starts ``floor(u * (T_i - S +
    1))`` (0 for the full-sequence estimators)."""
    n_seq = len(lengths)
    if seq is None:
        if num_sequences == -1:
            seq = torch.arange(n_seq, device=device).repeat(num_chains)
        else:
            seq = torch.rand((num_chains, n_seq), generator=generator,
                             device=device).argsort(1)[:, :k]
    seq = seq.reshape(-1).to(device)
    if full:
        return seq, torch.zeros_like(seq)
    n = lengths.to(device)[seq] - S + 1
    u = torch.rand(seq.shape, generator=generator, dtype=torch.float64,
                   device=device)
    return seq, torch.minimum((u * n).long(), n - 1)


def _sequence_scale(lengths, T_total: int, seq, C: int, dt):
    """T_total / sum(T_chosen) per chain, [C]."""
    chosen = lengths.to(seq.device)[seq].reshape(C, -1)
    return torch.full((C,), float(T_total), dtype=dt,
                      device=seq.device) / chosen.sum(1).to(dt)


class ExactDraws(NamedTuple):
    """Randomness of one exact-message score evaluation, R = chains x
    rows per chain."""
    start: torch.Tensor                   # [R] int64 subsequence starts
    # kind='complete': [R, K, W, n] FFBS normals (row W-1 draws the last
    # row, row t the step x_t | x_{t+1}) and [R, K, n] normals of the
    # pre-window completion, K = num_samples
    ffbs: torch.Tensor | None = None
    completion: torch.Tensor | None = None
    seq: torch.Tensor | None = None       # [R] sequences (Seq score)


class MarginalScore(nn.Module):
    """Buffered exact-message score estimator (kind='marginal', and
    kind='complete' with ``pass_draws``).

    ``windowed_fn(rows, window [R, W, m], valid [R, W], weights [R, S], B,
    S)`` (the model's ``windowed_marginal_gradient``, or its
    ``windowed_complete_gradient``, which also takes ``num_samples``,
    ``normals`` and ``completion``) returns ``(gradient parameters,
    loglik [R])``.  Each minibatch row's window is the JAX package's
    rolled one: ``idx = start - B + arange(S + 2B)``, rows outside
    ``[0, T)`` masked by ``valid`` and clipped, so the subsequence always
    fills the central S rows (not the PF score's shifted window).
    ``buffer_length=-1`` means B = T; ``subsequence_length=-1`` the whole
    series with B = 0.  ``score(generator, params, observations,
    draws=None)`` returns the minibatch means ``(gradient parameters,
    loglik [C])``.
    """

    def __init__(self, windowed_fn, config: PFScoreConfig, T: int,
                 pass_draws: bool = False, num_samples: int = 1,
                 state_dim: int = 1):
        super().__init__()
        self.windowed_fn, self.config, self.T = windowed_fn, config, T
        self.pass_draws, self.num_samples = pass_draws, num_samples
        self.state_dim = state_dim
        S = config.subsequence_length
        self.full = (S == -1) or (S >= T)
        self.B = 0 if self.full else (T if config.buffer_length == -1
                                      else max(config.buffer_length, 0))
        self.S = T if self.full else S
        self.W = self.S + 2 * self.B

    @property
    def rows_per_chain(self) -> int:
        return self.config.minibatch_size

    def draw(self, generator: torch.Generator, num_chains: int,
             device) -> ExactDraws:
        cfg = self.config
        R = num_chains * self.rows_per_chain
        if self.full:
            start = torch.zeros((R,), dtype=torch.int64, device=device)
        else:
            start = sample_start(generator, self.S, self.T, R,
                                 cfg.partition_style, device)
        return self._noise(generator, device, start)

    def _noise(self, generator, device, start, seq=None) -> ExactDraws:
        if not self.pass_draws:
            return ExactDraws(start, seq=seq)
        R, K, n = start.shape[0], self.num_samples, self.state_dim
        # n normals per latent row and draw
        ffbs = torch.randn((R, K, self.W, n), generator=generator,
                           device=device)
        completion = torch.randn((R, K, n), generator=generator,
                                 device=device)
        return ExactDraws(start, ffbs, completion, seq)

    def _layout(self, draws: ExactDraws, observations: torch.Tensor):
        """(windows [R, W, m], valid [R, W], weights [R, S])."""
        R, dt, dev = draws.start.shape[0], observations.dtype, \
            observations.device
        if self.full:
            ones = torch.ones((R, self.T), dtype=dt, device=dev)
            return observations[None].expand(R, -1, -1), ones, ones
        idx = draws.start[:, None] - self.B + torch.arange(self.W,
                                                           device=dev)
        valid = ((idx >= 0) & (idx < self.T)).to(dt)
        weights = subsequence_weights(draws.start, self.S, self.T,
                                      self.config.partition_style, dt)
        return observations[torch.clamp(idx, 0, self.T - 1)], valid, weights

    def _combine(self, grad, loglik, draws: ExactDraws, C: int):
        """Per-chain score from the rows': the minibatch mean."""
        return (params_map(lambda g: g.reshape((C, -1) + g.shape[1:]).mean(1),
                           grad), loglik.reshape(C, -1).mean(1))

    def forward(self, generator, params, observations: torch.Tensor,
                draws: ExactDraws | None = None):
        C, M = params.num_chains, self.rows_per_chain
        if draws is None:
            draws = self.draw(generator, C, observations.device)
        rows = params if M == 1 else params_map(
            lambda x: x.repeat_interleave(M, 0), params)
        window, valid, weights = self._layout(draws, observations)
        kw = {}
        if self.pass_draws:
            kw = dict(num_samples=self.num_samples,
                      normals=draws.ffbs.to(observations.dtype),
                      completion=draws.completion.to(observations.dtype))
        grad, loglik = self.windowed_fn(rows, window, valid, weights, self.B,
                                        self.S, **kw)
        return self._combine(grad, loglik, draws, C)


class SeqMarginalScore(MarginalScore):
    """Multi-sequence buffered exact-message score (counterpart of
    ``make_seq_marginal_score_fn``; kind='marginal' only).

    The observations are packed ``[n_seq, T_max, m]`` with true
    ``lengths``.  Each chain draws ``num_sequences`` sequences (as
    :class:`SeqPFScore` does) and each chosen sequence gives one row: with
    a finite subsequence length, a rolled ``[B | S | B]`` window clipped at
    that sequence's own edges by the validity mask, with that sequence's
    weights (B = T_max for ``buffer_length=-1``); with
    ``subsequence_length=-1``, the whole padded sequence with its validity
    mask as the weights too.  The rows are summed per chain and rescaled by
    ``T_total / sum(T_chosen)``.
    """

    def __init__(self, windowed_fn, config: PFScoreConfig, lengths,
                 num_sequences: int = -1):
        lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64)
        super().__init__(windowed_fn, config, int(lengths.sum()))
        self.lengths = lengths
        n_seq, T_max = len(lengths), int(lengths.max())
        S = config.subsequence_length
        self.full = S == -1
        if self.full:
            self.B, self.S = 0, T_max
        else:
            if S > int(lengths.min()):
                raise ValueError(f"subsequence {S} exceeds shortest sequence "
                                 f"{int(lengths.min())}")
            self.B = (T_max if config.buffer_length == -1
                      else max(config.buffer_length, 0))
            self.S = S
        self.W = self.S + 2 * self.B
        self.num_sequences = num_sequences
        self.k = _chosen_count(num_sequences, n_seq)

    @property
    def rows_per_chain(self) -> int:
        return self.k

    def draw(self, generator: torch.Generator, num_chains: int, device,
             seq: torch.Tensor | None = None) -> ExactDraws:
        seq, start = _sequence_draw(generator, self.lengths, self.k,
                                    self.num_sequences, self.S, self.full,
                                    num_chains, device, seq)
        return self._noise(generator, device, start, seq)

    def _layout(self, draws: ExactDraws, observations: torch.Tensor):
        dt, dev = observations.dtype, observations.device
        T_max = observations.shape[1]
        T_i = self.lengths.to(dev)[draws.seq][:, None]
        if self.full:
            vld = (torch.arange(T_max, device=dev) < T_i).to(dt)
            return observations[draws.seq], vld, vld
        weights = sequence_window(draws.start, T_i[:, 0], self.S, -1, T_max,
                                  dt).weights
        idx = draws.start[:, None] - self.B + torch.arange(self.W,
                                                           device=dev)
        valid = ((idx >= 0) & (idx < T_i)).to(dt)
        return (observations[draws.seq[:, None],
                             torch.clamp(idx, 0, T_max - 1)], valid, weights)

    def _combine(self, grad, loglik, draws: ExactDraws, C: int):
        scale = _sequence_scale(self.lengths, self.T, draws.seq, C,
                                loglik.dtype)
        return (params_map(lambda g: g.reshape((C, -1) + g.shape[1:]).sum(1)
                           * scale.reshape((C,) + (1,) * (g.dim() - 1)),
                           grad), loglik.reshape(C, -1).sum(1) * scale)


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


def make_marginal_score_fn(windowed_fn, config: PFScoreConfig, T: int,
                           pass_draws: bool = False, num_samples: int = 1,
                           state_dim: int = 1) -> MarginalScore:
    """Build the buffered exact-message score (see :class:`MarginalScore`);
    ``pass_draws`` gives the windowed function its random draws (the
    complete kind's FFBS and completion normals, ``state_dim`` a latent
    row)."""
    return MarginalScore(windowed_fn, config, T, pass_draws, num_samples,
                         state_dim)


def make_seq_marginal_score_fn(windowed_fn, config: PFScoreConfig, lengths,
                               num_sequences: int = -1) -> SeqMarginalScore:
    """Build the multi-sequence exact-message score (see
    :class:`SeqMarginalScore`)."""
    return SeqMarginalScore(windowed_fn, config, lengths, num_sequences)


def make_noisy_grad_fn(score_fn, grad_logprior_fn, T: int,
                       is_scaled: bool = True, preconditioner=None):
    """grad = (grad loglike estimate + grad logprior) / T, preconditioned
    by ``preconditioner.precondition`` when given.  The function carries
    the score's ``draw``, so a stepper can evaluate two gradients on one
    set of draws."""
    scale = (1.0 / T) if is_scaled else 1.0

    def noisy_grad(generator, params, observations, draws=None):
        grad_ll, loglik = score_fn(generator, params, observations, draws)
        grad = params_map(lambda g, p: g + p, grad_ll,
                          grad_logprior_fn(params))
        if preconditioner is not None:
            grad = preconditioner.precondition(params, grad)
        return params_map(lambda g: g * scale, grad), loglik

    noisy_grad.draw = getattr(score_fn, "draw", None)
    return noisy_grad


@dataclasses.dataclass(frozen=True)
class Preconditioner:
    """Riemannian preconditioner D(theta) as three functions of C chains:
    ``precondition(params, grad)`` (D grad), ``precondition_noise(params,
    z)`` (sqrt(D) z for standard normals ``z``, shaped like the parameters
    unless ``noise_normals(generator, params)`` draws them) and
    ``correction_term(params)`` (Gamma(theta))."""
    precondition: Callable
    precondition_noise: Callable
    correction_term: Callable
    noise_normals: Callable | None = None


def _normals_like(generator, params):
    return params_map(lambda x: torch.randn(
        x.shape, generator=generator, dtype=x.dtype, device=x.device),
        params)


def _langevin(params, grad, noise, epsilon, scale):
    """theta + eps * grad + sqrt(2 eps) * sqrt(scale) * noise."""
    std, sq = math.sqrt(scale), math.sqrt(2.0 * epsilon)
    return params_map(lambda p, g, n: p + epsilon * g + sq * (std * n),
                      params, grad, noise)


def sgd_step(generator, params, observations, noisy_grad_fn, epsilon,
             draws=None):
    """theta += eps * grad."""
    grad, loglik = noisy_grad_fn(generator, params, observations, draws)
    return params_map(lambda p, g: epsilon * g + p, params, grad), loglik


def sgld_step(generator, params, observations, noisy_grad_fn, epsilon, T,
              is_scaled: bool = True, draws=None, noise=None):
    """theta += eps * grad + sqrt(2 eps) * N(0, 1/T).

    ``draws`` (the score's) and ``noise`` (standard normals shaped like
    ``params``) replace the generator's draws."""
    grad, loglik = noisy_grad_fn(generator, params, observations, draws)
    if noise is None:
        noise = _normals_like(generator, params)
    return (_langevin(params, grad, noise, epsilon,
                      (1.0 / T) if is_scaled else 1.0), loglik)


def sgrld_step(generator, params, observations, noisy_grad_fn,
               preconditioner: Preconditioner, epsilon, T,
               is_scaled: bool = True, draws=None, noise=None):
    """Riemannian SGLD: theta += eps * (grad + Gamma / T) + sqrt(2 eps)
    sqrt(D) N(0, 1/T).  ``noisy_grad_fn`` must already apply
    ``preconditioner.precondition``; ``noise`` (standard normals shaped
    like ``params``, or those of ``preconditioner.noise_normals``) replaces
    the generator's."""
    grad, loglik = noisy_grad_fn(generator, params, observations, draws)
    scale = (1.0 / T) if is_scaled else 1.0
    if noise is None:
        noise = (preconditioner.noise_normals or _normals_like)(generator,
                                                                params)
    noise = preconditioner.precondition_noise(params, noise)
    corr = preconditioner.correction_term(params)
    grad = params_map(lambda g, c: g + scale * c, grad, corr)
    return _langevin(params, grad, noise, epsilon, scale), loglik


class AdagradState(NamedTuple):
    G: object                 # accumulated squared gradients (parameters)
    t: torch.Tensor           # [C] int64 steps taken


ADAGRAD_NUGGET = 1e-9


def adagrad_init(params) -> AdagradState:
    G = params_map(torch.zeros_like, params)
    device = getattr(G, dataclasses.fields(G)[0].name).device
    return AdagradState(G=G, t=torch.zeros((params.num_chains,),
                                           dtype=torch.int64, device=device))


def adagrad_step(generator, params, state: AdagradState, observations,
                 noisy_grad_fn, epsilon, draws=None):
    """ADAGRAD: G += grad^2, theta += eps * grad / sqrt(G + nugget)."""
    grad, loglik = noisy_grad_fn(generator, params, observations, draws)
    G = params_map(lambda Gi, g: Gi + g * g, state.G, grad)
    new = params_map(
        lambda p, g, Gi: p + epsilon * g / torch.sqrt(Gi + ADAGRAD_NUGGET),
        params, grad, G)
    return new, AdagradState(G=G, t=state.t + 1), loglik


def sgld_cv_step(generator, params, observations, noisy_grad_fn,
                 centering_params, centering_grad, epsilon, T,
                 is_scaled: bool = True, draws=None, noise=None):
    """SGLD with control variates: grad = centering_grad + (grad(theta) -
    grad(centre)), both noisy gradients on one and the same draws (the
    score's ``draw`` unless ``draws`` is given), so the two cancel where
    theta is the centre."""
    if draws is None:
        draws = noisy_grad_fn.draw(generator, params.num_chains,
                                   observations.device)
    grad_cur, loglik = noisy_grad_fn(generator, params, observations, draws)
    grad_cen, _ = noisy_grad_fn(generator, centering_params, observations,
                                draws)
    delta = params_map(lambda full, c, cc: full + (c - cc), centering_grad,
                       grad_cur, grad_cen)
    if noise is None:
        noise = _normals_like(generator, params)
    return (_langevin(params, delta, noise, epsilon,
                      (1.0 / T) if is_scaled else 1.0), loglik)


def fit(generator, params, observations, step_fn, num_iters: int,
        project_fn=None, steps_per_iter: int = 1, output_all: bool = True):
    """Run ``num_iters`` iterations of ``step_fn(generator, params,
    observations) -> (params, loglik [C])``, each of ``steps_per_iter``
    steps followed by the projection.

    Returns ``(final_params, trace, aux)``: the trace stacks the parameters
    after each iteration along axis 1 (``[C, num_iters, ...]``; None
    without ``output_all``), aux the last step's loglik ``[C, num_iters]``.
    """
    def state_step(gen, p, state, obs):
        p, ll = step_fn(gen, p, obs)
        return p, state, ll

    params, _, trace, aux = fit_with_state(
        generator, params, None, observations, state_step, num_iters,
        project_fn, steps_per_iter, output_all)
    return params, trace, aux


def fit_with_state(generator, params, state, observations, step_fn,
                   num_iters: int, project_fn=None, steps_per_iter: int = 1,
                   output_all: bool = True):
    """:func:`fit` for steppers that carry optimiser state (ADAGRAD):
    ``step_fn(generator, params, state, observations) -> (params, state,
    loglik)``.  Returns ``(params, state, trace, aux)``."""
    trace, aux = [], []
    for _ in range(num_iters):
        for _ in range(steps_per_iter):
            params, state, ll = step_fn(generator, params, state,
                                        observations)
            if project_fn is not None:
                params = project_fn(params)
        if output_all:
            trace.append(params)
        aux.append(ll)
    stacked = (params_map(lambda *xs: torch.stack(xs, 1), *trace)
               if output_all else None)
    return params, state, stacked, torch.stack(aux, 1)
