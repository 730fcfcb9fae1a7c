"""Uniform model adapter (counterpart of ``sgmcmc_tpu/models/registry.py``,
with the fields buffered-PF SGLD reads and the SVM, scalar LGSSM, GARCH
and SVJM entries)."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import garch as garch_mod
from . import lgssm as lgssm_mod
from . import svjm as svjm_mod
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


def _api(name: str, mod, prior_mean_var) -> ModelAPI:
    return ModelAPI(
        name=name, get_kernel=mod.get_kernel,
        grad_statistic=mod.grad_statistic,
        grad_statistic_dim=mod.STATISTIC_DIM, unpack_grad=mod.unpack_grad,
        default_prior=mod.default_prior, logprior=mod.logprior,
        grad_logprior=mod.grad_logprior, sample_prior=mod.sample_prior,
        project_parameters=mod.project_parameters,
        generate_data=mod.generate_data, prior_mean_var=prior_mean_var,
        get_fused=mod.get_fused)


def _stationary_prior(mod):
    """The JAX package's (0, stationary variance) initial-state prior."""
    def prior_mean_var(p):
        var = mod.stationary_variance(p)
        return torch.zeros_like(var), var
    return prior_mean_var


SVM = _api("svm", svm_mod, _stationary_prior(svm_mod))
# the JAX package's (0, 10 I) initial-state prior, per chain
LGSSM = _api("lgssm_1_1", lgssm_mod,
             lambda p: (torch.zeros_like(p.a), torch.full_like(p.a, 10.0)))
GARCH = _api("garch", garch_mod, _stationary_prior(garch_mod))
SVJM = _api("svjm", svjm_mod, _stationary_prior(svjm_mod))
_MODELS = {"svm": SVM, "garch": GARCH, "svjm": SVJM}


def get_model(name: str, **kwargs) -> ModelAPI:
    """The model adapter ``name``; the LGSSM takes ``n`` and ``m``, of
    which only the scalar model (n = m = 1) is ported."""
    if name in _MODELS and not kwargs:
        return _MODELS[name]
    if name == "lgssm" and set(kwargs) <= {"n", "m"}:
        n, m = kwargs.get("n", 1), kwargs.get("m", 1)
        if (n, m) == (1, 1):
            return LGSSM
        raise NotImplementedError(
            f"lgssm with n={n}, m={m} is not ported yet: the port has the "
            "scalar model (n = m = 1)")
    raise NotImplementedError(f"model '{name}' with {kwargs} is not ported "
                              "yet")
