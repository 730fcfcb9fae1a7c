"""Distribution log-pdfs and samplers used by the priors.

Counterpart of ``sgmcmc_tpu/utils/distributions.py`` for the functions the
SVM prior needs.  Batched over leading axes; samplers take an explicit
``torch.Generator``.
"""
from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _diag(mat: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(mat, dim1=-2, dim2=-1)


def matrix_normal_logpdf(X: torch.Tensor, mean: torch.Tensor,
                         Lrowprec: torch.Tensor,
                         Lcolprec: torch.Tensor) -> torch.Tensor:
    """Matrix-normal log density with Cholesky row/col precisions:
    MN(X; M, U, V) with U^-1 = Lrowprec Lrowprec^T, V^-1 = Lcolprec
    Lcolprec^T."""
    n, m = X.shape[-2], X.shape[-1]
    logdet_row = torch.log(torch.abs(_diag(Lrowprec))).sum(-1)
    logdet_col = torch.log(torch.abs(_diag(Lcolprec))).sum(-1)
    Z = Lrowprec.transpose(-1, -2) @ (X - mean) @ Lcolprec
    return (-0.5 * n * m * _LOG_2PI + m * logdet_row + n * logdet_col
            - 0.5 * (Z * Z).sum((-2, -1)))


def sample_wishart(generator: torch.Generator, df, scale: torch.Tensor,
                   batch_shape: tuple = ()) -> torch.Tensor:
    """Wishart(df, scale) samples [*batch_shape, n, n] via the Bartlett
    decomposition W = L A A^T L^T, L = chol(scale), A lower-triangular with
    diag(A)_i^2 ~ chi2(df - i) and N(0, 1) below the diagonal."""
    n = scale.shape[-1]
    dt, dev = scale.dtype, scale.device
    i = torch.arange(n, dtype=dt, device=dev)
    alpha = ((torch.as_tensor(df, dtype=dt, device=dev) - i) / 2.0).expand(
        tuple(batch_shape) + (n,)).contiguous()
    chi2 = 2.0 * torch._standard_gamma(alpha, generator=generator)
    A = torch.randn(tuple(batch_shape) + (n, n), generator=generator,
                    dtype=dt, device=dev).tril(-1)
    A = A + torch.diag_embed(torch.sqrt(chi2))
    LA = torch.linalg.cholesky(scale) @ A
    return LA @ LA.transpose(-1, -2)


def wishart_logpdf(X: torch.Tensor, df, scale: torch.Tensor) -> torch.Tensor:
    """log pdf of Wishart(df, scale) at X [..., n, n]."""
    n = X.shape[-1]
    df = torch.as_tensor(df, dtype=X.dtype, device=X.device)
    _, logdet_X = torch.linalg.slogdet(X)
    _, logdet_S = torch.linalg.slogdet(scale)
    i = torch.arange(1, n + 1, dtype=X.dtype, device=X.device)
    log_mgamma = (n * (n - 1) / 4.0) * math.log(math.pi) + torch.lgamma(
        (df + 1 - i) / 2.0).sum(-1)
    trace = _diag(torch.linalg.inv(scale) @ X).sum(-1)
    return (0.5 * (df - n - 1) * logdet_X - 0.5 * trace
            - 0.5 * df * n * math.log(2.0) - 0.5 * df * logdet_S
            - log_mgamma)
