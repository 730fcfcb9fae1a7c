"""Model abstraction of the port: particle kernels over chain-batched tensors.

Counterpart of ``sgmcmc_tpu/models/base.py``.  The JAX kernels act on one
chain's ``[N, D]`` particles and are vmapped over chains; a hand-written
kernel does not vmap, so here every function takes the chain axis
explicitly: particles are ``[C, N, D]``, log-weights ``[C, N]``,
observations ``[C, m]`` and parameters a dataclass of ``[C, ...]`` tensors.

Randomness is an input (standard normals drawn by the caller from a
``torch.Generator``), so the same draws can be fed to the JAX package in
the parity tests.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

# Signatures (Params is a model dataclass of [C, ...] tensors):
#   sample_x0(params, z [C, N, min(D, Z)], prior_mean [C], prior_var [C])
#       -> [C, N, D]
#   propose(params, z [C, N, Z], x_t [C, N, D], y_next [C, m]) -> [C, N, D]
#   reweight(params, x_t [C, N, D], x_next [C, N, D], y_next [C, m]) -> [C, N]
#   prior_log_density(params, x_t [C, M, D], x_next [C, M, D]) -> [C, M]
#   prior_log_density_max(params) -> [C]
#
# StatisticFn (additive statistics h_t):
#   stat_fn(params, x_t [C, N, D], x_next [C, N, D], y_next [C, m], t)
#       -> [C, N, H]


@dataclasses.dataclass(frozen=True)
class ParticleKernel:
    """Bootstrap particle kernel as a bundle of batched pure functions;
    the transition density ``prior_log_density`` feeds the backward
    weights of the O(N^2) smoother."""
    sample_x0: Callable
    propose: Callable
    reweight: Callable
    prior_log_density: Callable
    prior_log_density_max: Callable
    state_dim: int = 1
    # standard normals consumed per particle and step
    noise_dim: int = 1


StatisticFn = Callable
Params = Any


def params_map(fn, *params):
    """Apply ``fn`` field by field over parameter dataclasses of one type
    (the port's ``jax.tree_util.tree_map``)."""
    first = params[0]
    return dataclasses.replace(first, **{
        f.name: fn(*(getattr(p, f.name) for p in params))
        for f in dataclasses.fields(first)})
