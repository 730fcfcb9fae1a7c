"""Resampling for particle filters (counterpart of
``sgmcmc_tpu/ops/resampling.py``).

Only systematic resampling is ported so far.  It uses the port's one
ancestor rule, ``searchsorted(side="right")`` on the CDF of
``ops/cuda/resample.py``; the JAX module's gather path searches
``side="left"`` on ``cumsum(probs)``, which differs only when a position
lands exactly on a CDF value.
"""
from __future__ import annotations

import torch

from .cuda.resample import ancestors, resample_positions, weights_cdf


def normalize_log_weights(log_weights: torch.Tensor) -> torch.Tensor:
    """exp-normalize log weights [..., N] to probabilities; degenerate
    inputs (all -inf / non-finite) fall back to uniform weights."""
    m = log_weights.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(log_weights - m)
    total = w.sum(-1, keepdim=True)
    n = log_weights.shape[-1]
    ok = total > 0
    return torch.where(ok, w / torch.where(ok, total, 1.0), 1.0 / n)


def systematic_resampling(u0: torch.Tensor,
                          log_weights: torch.Tensor) -> torch.Tensor:
    """Systematic (single-uniform comb) resampling: ancestors [C, N] at
    positions ``(i + u0) / N`` for the offsets ``u0 [C]``."""
    n = log_weights.shape[-1]
    return ancestors(resample_positions("systematic", u0, n),
                     weights_cdf(log_weights))


RESAMPLERS = {"systematic": systematic_resampling}


def get_resampler(name: str):
    if name not in RESAMPLERS:
        raise NotImplementedError(
            f"resampler '{name}' is not ported yet; "
            f"choose from {sorted(RESAMPLERS)}")
    return RESAMPLERS[name]
