"""Uniform model adapter (counterpart of ``sgmcmc_tpu/models/registry.py``,
with the fields the particle and exact-message scores, the steppers,
Gibbs and the predict surface read, and the SVM, scalar LGSSM, GARCH and
SVJM entries)."""
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
    # the particle filter's log-likelihood statistic
    suff_statistic: Callable | None = None
    suff_statistic_dim: int = 0
    # the SGRLD preconditioner triple (LGSSM; None: SGRLD / SGRD raise)
    precondition: Callable | None = None
    precondition_noise: Callable | None = None
    correction_term: Callable | None = None
    # the exact-message oracle and scores and Gibbs (LGSSM)
    marginal_loglikelihood: Callable | None = None
    gradient_marginal_loglikelihood: Callable | None = None
    windowed_marginal_gradient: Callable | None = None
    windowed_complete_gradient: Callable | None = None
    latent_var_sample: Callable | None = None
    latent_var_distr: Callable | None = None
    # the exact observation predict and prior trajectories (LGSSM)
    y_distr: Callable | None = None
    y_sample: Callable | None = None
    simulate_distr: Callable | None = None
    simulate_paths: Callable | None = None
    gibbs_step: Callable | None = None
    # the particle filter's predict surface: moment maps of elementwise-
    # averaged statistics ((params, stats [C, T, H]) -> (mean, cov)), the
    # observation statistic, and the k-step predictive statistic factory;
    # the exact predictive log-likelihood (message passing)
    latent_moments: Callable | None = None
    y_statistic: Callable | None = None
    y_statistic_dim: int = 0
    y_moments: Callable | None = None
    make_predictive_stat_fn: Callable | None = None
    predictive_loglikelihood: Callable | None = None


def _api(name: str, mod, prior_mean_var, **extra) -> ModelAPI:
    return ModelAPI(
        name=name, get_kernel=mod.get_kernel,
        grad_statistic=mod.grad_statistic,
        grad_statistic_dim=mod.STATISTIC_DIM, unpack_grad=mod.unpack_grad,
        default_prior=mod.default_prior, logprior=mod.logprior,
        grad_logprior=mod.grad_logprior, sample_prior=mod.sample_prior,
        project_parameters=mod.project_parameters,
        generate_data=mod.generate_data, prior_mean_var=prior_mean_var,
        get_fused=mod.get_fused, suff_statistic=mod.suff_statistic,
        suff_statistic_dim=mod.SUFF_STATISTIC_DIM,
        latent_moments=mod.latent_moments,
        y_statistic=mod.y_statistic, y_statistic_dim=mod.Y_STATISTIC_DIM,
        y_moments=mod.y_moments,
        make_predictive_stat_fn=mod.make_predictive_stat_fn, **extra)


def _stationary_prior(mod):
    """The JAX package's (0, stationary variance) initial-state prior."""
    def prior_mean_var(p):
        var = mod.stationary_variance(p)
        return torch.zeros_like(var), var
    return prior_mean_var


SVM = _api("svm", svm_mod, _stationary_prior(svm_mod))
# the JAX package's (0, 10 I) initial-state prior, per chain
LGSSM = _api("lgssm_1_1", lgssm_mod,
             lambda p: (torch.zeros_like(p.a), torch.full_like(p.a, 10.0)),
             precondition=lgssm_mod.precondition,
             precondition_noise=lgssm_mod.precondition_noise,
             correction_term=lgssm_mod.correction_term,
             marginal_loglikelihood=lgssm_mod.marginal_loglikelihood,
             gradient_marginal_loglikelihood=(
                 lgssm_mod.gradient_marginal_loglikelihood),
             windowed_marginal_gradient=lgssm_mod.windowed_marginal_gradient,
             windowed_complete_gradient=lgssm_mod.windowed_complete_gradient,
             latent_var_sample=lgssm_mod.latent_var_sample,
             latent_var_distr=lgssm_mod.latent_var_distr,
             y_distr=lgssm_mod.y_distr, y_sample=lgssm_mod.y_sample,
             simulate_distr=lgssm_mod.simulate_distr,
             simulate_paths=lgssm_mod.simulate_paths,
             predictive_loglikelihood=lgssm_mod.predictive_loglikelihood,
             gibbs_step=lgssm_mod.gibbs_step)
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
            "scalar model (n = m = 1); the vector model is ROADMAP.md, "
            "Queue 1, slice 9b")
    raise NotImplementedError(f"model '{name}' with {kwargs} is not ported "
                              "yet")
