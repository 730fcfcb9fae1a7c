"""Linear-algebra helpers (counterpart of ``sgmcmc_tpu/utils/linalg.py``)."""
from __future__ import annotations

import numpy as np
import torch


def tril_dim(n: int) -> int:
    """Number of entries in the lower triangle of an (n, n) matrix."""
    return (n * (n + 1)) // 2


def tril_n_from_dim(d: int) -> int:
    """Inverse of :func:`tril_dim`: matrix size n with n(n+1)/2 == d."""
    n = int((np.sqrt(8 * d + 1) - 1) / 2)
    if tril_dim(n) != d:
        raise ValueError(f"{d} is not a triangular number")
    return n


def tril_vector_to_mat(vec: torch.Tensor) -> torch.Tensor:
    """Expand a packed lower-triangle vector [..., d] into [..., n, n].

    Row-major packing over the lower triangle, as in the JAX package."""
    n = tril_n_from_dim(vec.shape[-1])
    rows, cols = np.tril_indices(n)
    mat = vec.new_zeros(vec.shape[:-1] + (n, n))
    mat[..., torch.as_tensor(rows), torch.as_tensor(cols)] = vec
    return mat


def mat_to_tril_vector(mat: torch.Tensor) -> torch.Tensor:
    """Pack the lower triangle of [..., n, n] row-major into [..., d]."""
    rows, cols = np.tril_indices(mat.shape[-1])
    return mat[..., torch.as_tensor(rows), torch.as_tensor(cols)]


def spectral_norm_projection(A: torch.Tensor,
                             threshold: float = 0.9999) -> torch.Tensor:
    """The JAX package's VAR-stability projection of [..., n, n] matrices
    to spectral norm <= threshold, for n = 1 (the ported scalar models): a
    clip of A to [-threshold, threshold]."""
    if A.shape[-1] != 1:
        raise NotImplementedError("spectral_norm_projection is ported for "
                                  "1 x 1 matrices only")
    return torch.clamp(A, -threshold, threshold)
