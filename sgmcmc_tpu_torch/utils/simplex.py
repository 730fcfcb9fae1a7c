"""Simplex (transition-matrix / Bernoulli) coordinates, pure functions.

Counterpart of ``sgmcmc_tpu/utils/simplex.py``: a stochastic matrix ``pi``
in its three interchangeable parameterizations (``logit``: rows are
softmax(logit_pi); ``expanded``: nonnegative weights, pi = |e| / sum |e|;
``pi``: the probabilities), the chain-rule transport of a gradient dL/dpi
into each coordinate, the Dirichlet prior pieces and the Bernoulli
helpers.  Every function is row-wise over the last axis and batched over
any leading axes (chains first).

The Dirichlet draws take their unit gamma draws (Gamma(alpha, 1), shaped
like ``alpha``) as the input ``gamma``, else draw them from ``generator``.
"""
from __future__ import annotations

import torch

# --------------------------------------------------------------------------
# Transition-matrix coordinates
# --------------------------------------------------------------------------


def pi_from_logit(logit_pi: torch.Tensor) -> torch.Tensor:
    """Rows of pi = softmax(logit_pi)."""
    return torch.softmax(logit_pi, dim=-1)


def logit_from_pi(pi: torch.Tensor) -> torch.Tensor:
    """Centered row-wise log(pi + 1e-99)."""
    lp = torch.log(pi + 1e-99)
    return lp - lp.mean(-1, keepdim=True)


def pi_from_expanded(expanded_pi: torch.Tensor) -> torch.Tensor:
    """pi = |e| / sum(|e|)."""
    e = torch.abs(expanded_pi)
    return e / e.sum(-1, keepdim=True)


def expanded_from_pi(pi: torch.Tensor) -> torch.Tensor:
    """The identity embedding."""
    return pi


def project_logit(logit_pi: torch.Tensor, center: bool = True
                  ) -> torch.Tensor:
    """Stability projection of the logit storage: centred rows."""
    if center:
        return logit_pi - logit_pi.mean(-1, keepdim=True)
    return logit_pi


def project_expanded(expanded_pi: torch.Tensor, center: bool = False
                     ) -> torch.Tensor:
    """abs, and with ``center`` rows normalised to sum 1."""
    e = torch.abs(expanded_pi)
    if center:
        e = e / e.sum(-1, keepdim=True)
    return e


def grad_logit_from_grad_pi(grad_pi: torch.Tensor, pi: torch.Tensor
                            ) -> torch.Tensor:
    """dL/dpi into the logit coordinate: pi * (g - <g, pi>) per row."""
    inner = (grad_pi * pi).sum(-1, keepdim=True)
    return pi * (grad_pi - inner)


def grad_expanded_from_grad_pi(grad_pi: torch.Tensor,
                               expanded_pi: torch.Tensor) -> torch.Tensor:
    """dL/dpi into the expanded coordinate under the expanded-mean metric:
    e * pi * (g - <g, pi>), the Euclidean gradient dL/de scaled by e^2."""
    e = torch.abs(expanded_pi)
    pi = e / e.sum(-1, keepdim=True)
    inner = (grad_pi * pi).sum(-1, keepdim=True)
    return e * pi * (grad_pi - inner)


# --------------------------------------------------------------------------
# Dirichlet prior on the rows of pi
# --------------------------------------------------------------------------


def dirichlet_logprior(pi: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """sum_k log Dirichlet(pi_k | alpha_k) over the rows of the last two
    axes: [...] for pi [..., K, K]."""
    lognorm = torch.lgamma(alpha).sum(-1) - torch.lgamma(alpha.sum(-1))
    return ((alpha - 1.0) * torch.log(pi + 1e-16)).sum(-1).sub(
        lognorm).sum(-1)


def dirichlet_grad_logit(pi: torch.Tensor, alpha: torch.Tensor,
                         use_scir: bool = False) -> torch.Tensor:
    """The Dirichlet prior's score in the logit coordinate; with
    ``use_scir`` the raw statistic alpha (SCIR's exact Gamma update)."""
    if use_scir:
        return alpha.expand(pi.shape)
    return (alpha - 1.0) - pi * (alpha - 1.0).sum(-1, keepdim=True)


def dirichlet_grad_expanded(expanded_pi: torch.Tensor, alpha: torch.Tensor,
                            use_scir: bool = False) -> torch.Tensor:
    """The Dirichlet prior's score in the expanded coordinate."""
    if use_scir:
        return alpha.expand(expanded_pi.shape)
    e = torch.abs(expanded_pi)
    s = e.sum(-1, keepdim=True)
    return ((alpha - 1.0) - e * (alpha - 1.0).sum(-1, keepdim=True) / s) * e


def unit_gamma(generator, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws shaped like ``alpha``."""
    return torch._standard_gamma(alpha.contiguous(), generator=generator)


def dirichlet_sample(generator, alpha: torch.Tensor,
                     gamma: torch.Tensor | None = None) -> torch.Tensor:
    """Row-wise Dirichlet(alpha) draws from unit gammas."""
    g = unit_gamma(generator, alpha) if gamma is None else gamma
    return g / g.sum(-1, keepdim=True)


def dirichlet_posterior_sample(generator, alpha: torch.Tensor,
                               counts: torch.Tensor,
                               gamma: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """The conjugate posterior draw given (expected) transition counts."""
    return dirichlet_sample(generator, alpha + counts, gamma)


# --------------------------------------------------------------------------
# Bernoulli helpers
# --------------------------------------------------------------------------


def prob_from_logit(logit_p: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(logit_p)


def logit_from_prob(p: torch.Tensor) -> torch.Tensor:
    return torch.log(p + 1e-99) - torch.log1p(-p + 1e-99)


def grad_logit_from_grad_prob(grad_p: torch.Tensor, p: torch.Tensor
                              ) -> torch.Tensor:
    """Chain rule through the sigmoid: g_logit = g_p p (1 - p)."""
    return grad_p * p * (1.0 - p)


def beta_logprior(p: torch.Tensor, a, b) -> torch.Tensor:
    """Summed log Beta(p | a, b) (the normaliser included)."""
    a = torch.as_tensor(a, dtype=p.dtype, device=p.device)
    b = torch.as_tensor(b, dtype=p.dtype, device=p.device)
    lognorm = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    return ((a - 1.0) * torch.log(p + 1e-16)
            + (b - 1.0) * torch.log1p(-p + 1e-16) - lognorm).sum()


def beta_grad_logit(logit_p: torch.Tensor, a, b) -> torch.Tensor:
    """d/dlogit of log Beta(sigmoid(logit) | a, b): (a - 1)(1 - p) -
    (b - 1) p."""
    p = torch.sigmoid(logit_p)
    return (a - 1.0) * (1.0 - p) - (b - 1.0) * p
