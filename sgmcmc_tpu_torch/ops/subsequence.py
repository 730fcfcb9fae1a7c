"""Buffered-subsequence sampling with unbiasedness weights.

Counterpart of ``sgmcmc_tpu/ops/subsequence.py``, batched over a leading
chain axis.  Index ``t`` is covered by ``n(t) = min(t+1, S, T-S+1, T-t)``
of the ``T-S+1`` equally likely subsequences, so weighting by
``(T-S+1)/n(t)`` makes the subsequence gradient unbiased.  The window has
the static length ``W = S + 2B`` and slides inside ``[0, T]``
(``window_start = clip(start - B, 0, T - W)``).  The same ``start`` gives
the same weights and window bounds as the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SubsequenceWindow(NamedTuple):
    window_start: torch.Tensor   # [C] int64 absolute start of the window
    t1: torch.Tensor             # [C] int64 relative start of the subsequence
    tL: torch.Tensor             # [C] int64 relative end (exclusive)
    weights: torch.Tensor        # [C, S] unbiasedness weights


def coverage_counts(start: torch.Tensor, S: int, T: int,
                    dtype=torch.float32) -> torch.Tensor:
    """n(t) [C, S] for t = start..start+S-1 (exact closed form)."""
    t = start[:, None] + torch.arange(S, device=start.device)
    n = torch.minimum(torch.clamp(t + 1, max=S),
                      torch.clamp(T - t, max=T - S + 1))
    return n.to(dtype)


def subsequence_weights(start: torch.Tensor, S: int, T: int,
                        partition_style: str = "uniform",
                        dtype=torch.float32) -> torch.Tensor:
    """Unbiasedness weights [C, S] for subsequences starting at ``start``."""
    if partition_style == "uniform":
        n = coverage_counts(start, S, T, dtype)
        # a true division (scalar / tensor would multiply by 1/n)
        return torch.full_like(n, float(T - S + 1)) / n
    if partition_style in ("strict", "naive"):
        return torch.full((start.shape[0], S), T / S, dtype=dtype,
                          device=start.device)
    raise ValueError(f"Unrecognized partition_style = '{partition_style}'")


def sample_start(generator: torch.Generator, S: int, T: int, num: int,
                 partition_style: str = "uniform",
                 device=None) -> torch.Tensor:
    """Random subsequence starts [num]: a partition block for 'strict'
    (requires S | T), else uniform over the T-S+1 starts."""
    if partition_style == "strict":
        if T % S != 0:
            raise ValueError(f"S={S} does not evenly divide T={T}")
        return torch.randint(0, T // S, (num,), generator=generator,
                             device=device) * S
    return torch.randint(0, T - S + 1, (num,), generator=generator,
                         device=device)


def sample_subsequence(generator: torch.Generator, S: int, T: int, num: int,
                       partition_style: str = "uniform",
                       dtype=torch.float32, device=None):
    """Draw ``num`` subsequence starts and their weights:
    ``(start [num], weights [num, S])``."""
    start = sample_start(generator, S, T, num, partition_style, device)
    return start, subsequence_weights(start, S, T, partition_style, dtype)


def buffered_window(start: torch.Tensor, S: int, buffer_length: int, T: int,
                    partition_style: str = "uniform",
                    dtype=torch.float32) -> SubsequenceWindow:
    """Lay out the fixed-shape buffered window of subsequences starting at
    ``start [C]``; ``buffer_length == -1`` buffers to the whole sequence."""
    if buffer_length == -1:
        buffer_length = T
    W = min(S + 2 * buffer_length, T)
    window_start = torch.clamp(start - buffer_length, 0, T - W)
    t1 = start - window_start
    return SubsequenceWindow(window_start, t1, t1 + S,
                             subsequence_weights(start, S, T,
                                                 partition_style, dtype))


def sample_buffered_window(generator: torch.Generator, S: int,
                           buffer_length: int, T: int, num: int,
                           partition_style: str = "uniform",
                           dtype=torch.float32,
                           device=None) -> SubsequenceWindow:
    """Sample ``num`` subsequences and lay out their buffered windows."""
    start = sample_start(generator, S, T, num, partition_style, device)
    return buffered_window(start, S, buffer_length, T, partition_style,
                           dtype)


def window_length(S: int, buffer_length: int, T: int) -> int:
    """Static buffered-window length."""
    if S == -1 or S >= T:
        return T
    if buffer_length == -1:
        return T
    return min(S + 2 * buffer_length, T)


def slice_window(observations: torch.Tensor, window_start: torch.Tensor,
                 W: int) -> torch.Tensor:
    """Windows [C, W, m] of ``observations [T, m]`` starting at
    ``window_start [C]``."""
    idx = window_start[:, None] + torch.arange(W, device=window_start.device)
    return observations[idx]


def sequence_window(start: torch.Tensor, lengths: torch.Tensor, S: int,
                    buffer_length: int, T_max: int,
                    dtype=torch.float32) -> SubsequenceWindow:
    """Windows of rows that each read one sequence of a packed batch
    (``make_seq_pf_score_fn``'s layout): ``lengths [R]`` are the rows'
    sequence lengths T_i, ``start [R]`` their subsequence starts and
    ``T_max`` the packed length.

    * ``S == -1``: the whole padded sequence, weight 1 on ``t < T_i``
      (weights ``[R, T_max]`` are all ones, ``tL = T_i``);
    * otherwise the coverage weights ``(T_i-S+1) / n(t)`` of the S steps
      from ``start``, in the whole padded sequence (``buffer_length ==
      -1``) or in a window of ``W = S + 2B`` steps from
      ``clip(start - B, 0, T_i - W)``.
    """
    zero = torch.zeros_like(lengths)
    if S == -1:
        ones = torch.ones((lengths.shape[0], T_max), dtype=dtype,
                          device=lengths.device)
        return SubsequenceWindow(zero, zero, lengths, ones)
    t = start[:, None] + torch.arange(S, device=start.device)
    T_i = lengths[:, None]
    n_cov = torch.minimum(torch.clamp(t + 1, max=S),
                          torch.minimum(T_i - S + 1, T_i - t))
    weights = (T_i - S + 1).to(dtype) / n_cov.to(dtype)
    if buffer_length == -1:
        return SubsequenceWindow(zero, start, start + S, weights)
    W = S + 2 * buffer_length
    window_start = torch.minimum(torch.clamp(start - buffer_length, min=0),
                                 lengths - W)
    t1 = start - window_start
    return SubsequenceWindow(window_start, t1, t1 + S, weights)
