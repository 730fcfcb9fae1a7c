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

    Row-major packing over the lower triangle, as in the JAX package (a
    reshape at n = 1, which needs no index tensor on the device)."""
    n = tril_n_from_dim(vec.shape[-1])
    if n == 1:
        return vec[..., None]
    rows, cols = np.tril_indices(n)
    mat = vec.new_zeros(vec.shape[:-1] + (n, n))
    mat[..., torch.as_tensor(rows), torch.as_tensor(cols)] = vec
    return mat


def mat_to_tril_vector(mat: torch.Tensor) -> torch.Tensor:
    """Pack the lower triangle of [..., n, n] row-major into [..., d]."""
    if mat.shape[-1] == 1:
        return mat[..., 0]
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


# Batched solves, inverses, factors and log-determinants of [..., n, n]
# matrices.  At n = 1 each is one elementwise operation; otherwise each is
# the ``_ex`` variant of ``torch.linalg``.  Neither checks for errors, so
# neither waits for the card: a singular or indefinite matrix gives inf or
# NaN, as ``jnp.linalg`` does.  The message loops call them on every step.

def solve(M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """M^-1 B for M [..., n, n] and B [..., n, k] (batch axes broadcast)."""
    if M.shape[-1] == 1:
        return B / M
    return torch.linalg.solve_ex(M, B)[0]


def solve_vec(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M^-1 b for M [..., n, n] and b [..., n]."""
    return solve(M, b[..., None])[..., 0]


def inv(M: torch.Tensor) -> torch.Tensor:
    if M.shape[-1] == 1:
        return 1.0 / M
    return torch.linalg.inv_ex(M)[0]


def cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor."""
    if M.shape[-1] == 1:
        return torch.sqrt(M)
    return torch.linalg.cholesky_ex(M)[0]


def logdet(M: torch.Tensor) -> torch.Tensor:
    """log |det M| [...]."""
    if M.shape[-1] == 1:
        return torch.log(torch.abs(M[..., 0, 0]))
    return torch.linalg.slogdet(M)[1]


def solve_upper(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """U^-1 B for upper-triangular U [..., n, n] and B [..., n, k]."""
    if U.shape[-1] == 1:
        return B / U
    return torch.linalg.solve_triangular(U, B, upper=True)


def matmul(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X @ Y; an elementwise product when the contracted axis has size 1
    (an outer product), which avoids a batched GEMM per call."""
    if X.shape[-1] == 1:
        return X * Y
    return X @ Y


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v for M [..., m, n] and v [..., n]."""
    if M.shape[-1] == 1:
        return M[..., 0] * v
    return (M @ v[..., None])[..., 0]
