"""Bytes of one resample-apply launch (``out[c, i] = vals[c, idx(c, i)]``
for ``vals [C, N, K]`` at n positions), over the rows it draws: the
positions [C, n] and the CDF [C, N] read, each drawn row of K float32
read once and written once; frozen from ``chip_smoke.py:3559``
(``nbytes = 4 * (pos.numel() + cdf.numel() + 2 * vals.numel())``, there
at n = N).  The search's compares (``n * (log2 N + 1)`` a chain,
``chip_smoke.py:3560``) count as operations."""
from . import peaks


def nbytes(C, n, N, K):
    return 4 * (C * n + C * N + 2 * C * n * K)


def ops(C, n, N):
    return C * n * (N.bit_length() + 1)


def bound_s(C, n, N, K):
    return peaks.bound_s(ops(C, n, N), nbytes(C, n, N, K))
