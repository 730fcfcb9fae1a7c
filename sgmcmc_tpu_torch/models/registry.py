"""Uniform model adapter (counterpart of ``sgmcmc_tpu/models/registry.py``,
with the fields buffered-PF SGLD reads and the SVM entry only)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

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


def get_model(name: str) -> ModelAPI:
    if name == "svm":
        return SVM
    raise NotImplementedError(f"model '{name}' is not ported yet")
