"""Uniform model adapter (counterpart of ``sgmcmc_tpu/models/registry.py``,
with the fields buffered-PF SGLD reads and the SVM and scalar LGSSM
entries)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import lgssm as lgssm_mod
from . import svm as svm_mod


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    name: str
    get_kernel: Callable
    grad_statistic: Callable
    grad_statistic_dim: int
    unpack_grad: Callable        # stat [C, H] -> gradient parameters
    default_prior: Callable
    logprior: Callable           # (prior, params) -> [C]
    grad_logprior: Callable      # (prior, params) -> params
    sample_prior: Callable       # (prior, generator, num_chains) -> params
    project_parameters: Callable
    generate_data: Callable      # (generator, params, T) -> (ys, xs)
    prior_mean_var: Callable     # params -> (prior_mean [C], prior_var [C])
    get_fused: Callable | None = None   # kernel_name -> FusedModel | None


SVM = ModelAPI(
    name="svm",
    get_kernel=svm_mod.get_kernel,
    grad_statistic=svm_mod.grad_statistic,
    grad_statistic_dim=svm_mod.STATISTIC_DIM,
    unpack_grad=svm_mod.unpack_grad,
    default_prior=svm_mod.default_prior,
    logprior=svm_mod.logprior,
    grad_logprior=svm_mod.grad_logprior,
    sample_prior=svm_mod.sample_prior,
    project_parameters=svm_mod.project_parameters,
    generate_data=svm_mod.generate_data,
    prior_mean_var=lambda p: (torch.zeros_like(p.a),
                              svm_mod.stationary_variance(p)),
    get_fused=svm_mod.get_fused,
)


LGSSM = ModelAPI(
    name="lgssm_1_1",
    get_kernel=lgssm_mod.get_kernel,
    grad_statistic=lgssm_mod.grad_statistic,
    grad_statistic_dim=lgssm_mod.STATISTIC_DIM,
    unpack_grad=lgssm_mod.unpack_grad,
    default_prior=lgssm_mod.default_prior,
    logprior=lgssm_mod.logprior,
    grad_logprior=lgssm_mod.grad_logprior,
    sample_prior=lgssm_mod.sample_prior,
    project_parameters=lgssm_mod.project_parameters,
    generate_data=lgssm_mod.generate_data,
    # the JAX package's (0, 10 I) initial-state prior, per chain
    prior_mean_var=lambda p: (torch.zeros_like(p.a),
                              torch.full_like(p.a, 10.0)),
    get_fused=lgssm_mod.get_fused,
)


def get_model(name: str, **kwargs) -> ModelAPI:
    """The model adapter ``name``; the LGSSM takes ``n`` and ``m``, of
    which only the scalar model (n = m = 1) is ported."""
    if name == "svm" and not kwargs:
        return SVM
    if name == "lgssm" and set(kwargs) <= {"n", "m"}:
        n, m = kwargs.get("n", 1), kwargs.get("m", 1)
        if (n, m) == (1, 1):
            return LGSSM
        raise NotImplementedError(
            f"lgssm with n={n}, m={m} is not ported yet: the port has the "
            "scalar model (n = m = 1)")
    raise NotImplementedError(f"model '{name}' with {kwargs} is not ported "
                              "yet")
