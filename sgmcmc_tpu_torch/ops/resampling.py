"""Resampling for particle filters (counterpart of
``sgmcmc_tpu/ops/resampling.py``).

Every scheme is position based: ``u`` holds the scheme's uniform draws
(``[C]`` for systematic, ``[C, N]`` for multinomial and stratified) and the
ancestors are ``searchsorted(cdf, positions, side="right")``, the port's
one ancestor rule (``ops/cuda/resample.py``).  Two named exceptions to the
JAX module, which match the port in law but not draw for draw: its
multinomial draws Gumbel-max categoricals for N <= 8192, and its
inverse-CDF gather searches ``side="left"`` on ``cumsum(probs)`` (the two
sides differ only when a position lands exactly on a CDF value).
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


def _resample(scheme: str, u: torch.Tensor,
              log_weights: torch.Tensor) -> torch.Tensor:
    n = log_weights.shape[-1]
    return ancestors(resample_positions(scheme, u, n),
                     weights_cdf(log_weights))


def multinomial_resampling(u: torch.Tensor,
                           log_weights: torch.Tensor) -> torch.Tensor:
    """Multinomial resampling: ancestors [C, N] at the iid uniform
    positions ``u [C, N]``."""
    return _resample("multinomial", u, log_weights)


def systematic_resampling(u0: torch.Tensor,
                          log_weights: torch.Tensor) -> torch.Tensor:
    """Systematic (single-uniform comb) resampling: ancestors [C, N] at
    positions ``(i + u0) / N`` for the offsets ``u0 [C]``."""
    return _resample("systematic", u0, log_weights)


def stratified_resampling(u: torch.Tensor,
                          log_weights: torch.Tensor) -> torch.Tensor:
    """Stratified (one uniform per stratum) resampling: ancestors [C, N]
    at positions ``(i + u_i) / N`` for ``u [C, N]``."""
    return _resample("stratified", u, log_weights)


RESAMPLERS = {
    "multinomial": multinomial_resampling,
    "systematic": systematic_resampling,
    "stratified": stratified_resampling,
}


def get_resampler(name: str):
    if name not in RESAMPLERS:
        raise ValueError(f"Unrecognized resampler '{name}'; "
                         f"choose from {sorted(RESAMPLERS)}")
    return RESAMPLERS[name]


def effective_sample_size(log_weights: torch.Tensor) -> torch.Tensor:
    """ESS = 1 / sum(w_i^2) of the normalized weights [..., N] -> [...]."""
    w = normalize_log_weights(log_weights)
    return 1.0 / (w * w).sum(-1)
