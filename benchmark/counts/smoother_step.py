"""Bytes and operations of one launch of the unfused smoother's step
kernel (``csrc/smoother_step.cuh``) from its shapes: C chains, N
particles, a model body with D state dimensions, Z normals a particle
and H statistics.

Bytes: the resampled ``[C, N, D + H]`` row read and the carry's row
written, the step's normals ``[C, Z, N]`` read, the new log-weights and
the next step's CDF ``[C, N]`` written, all float32 (the per-chain
parameters, observation, weights and log-likelihood, a few bytes a
chain, are left out).  At C=8192, N=1000, GARCH optimal (D=2, H=4, Z=1)
this is 0.49 GB, 0.1467 ms at the HBM peak.

Operations: the model's body a particle (``<body>_body.BODY_OPS``); the
kernel is bound by its bytes at every shape the benchmark runs."""
from . import peaks


def nbytes(C, N, D, Z, H):
    return 4 * C * N * (2 * (D + H) + Z + 2)


def ops(C, N, body_ops):
    return C * N * body_ops


def bound_s(C, N, D, Z, H, body_ops):
    return peaks.bound_s(ops(C, N, body_ops), nbytes(C, N, D, Z, H))
