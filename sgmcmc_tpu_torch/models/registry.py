"""Uniform model adapter (counterpart of ``sgmcmc_tpu/models/registry.py``,
with the fields the particle and exact-message scores, the steppers,
Gibbs and the predict surface read, and the SVM, LGSSM (any n, m), GARCH,
SVJM, GaussHMM and ARPHMM entries; the SLDS is ROADMAP.md, Queue 1, slice
13)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from . import arphmm as arphmm_mod
from . import garch as garch_mod
from . import gauss_hmm as gauss_hmm_mod
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
    # (generator, params) -> the normals precondition_noise takes, when
    # they are not shaped like the parameters (the vector LGSSM)
    precondition_normals: Callable | None = None
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
    # whether the model has a particle filter (False: the discrete-state
    # models, whose default score kind is then the exact messages' and
    # whose complete kind's FFBS draws uniforms, not normals), and the
    # dtype its samplers hold their observations and parameters in
    has_pf: bool = True
    dtype: torch.dtype = torch.float32


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


# the exact-message, preconditioner, Gibbs and exact-predict fields only
# the LGSSM module fills, under the module's own names
_LGSSM_ONLY = ("precondition", "precondition_noise", "correction_term",
               "marginal_loglikelihood", "gradient_marginal_loglikelihood",
               "windowed_marginal_gradient", "windowed_complete_gradient",
               "latent_var_sample", "latent_var_distr", "y_distr",
               "y_sample", "simulate_distr", "simulate_paths", "gibbs_step",
               "predictive_loglikelihood")


@functools.lru_cache(maxsize=None)
def _lgssm_api(n: int = 1, m: int = 1) -> ModelAPI:
    """The LGSSM with an n-dimensional state and m-dimensional
    observations.  Its initial-state prior is the JAX package's (0, 10 I)
    per chain ([C] values at n = 1); the fused window (K1) is the scalar
    model's alone, as in the JAX package."""
    scalar = n == 1 and m == 1
    stat_dim = 3 if n == 1 else n + 2 * n * n
    if n == 1:
        def prior_mean_var(p):
            return torch.zeros_like(p.a), torch.full_like(p.a, 10.0)
    else:
        def prior_mean_var(p):
            C, dt, dev = p.num_chains, p.A.dtype, p.A.device
            return (torch.zeros((C, n), dtype=dt, device=dev),
                    10.0 * torch.eye(n, dtype=dt, device=dev).expand(C, n, n))
    # only the fields that depend on n and m differ from the module's
    return dataclasses.replace(
        _api(f"lgssm_{n}_{m}", lgssm_mod, prior_mean_var,
             **{f: getattr(lgssm_mod, f) for f in _LGSSM_ONLY}),
        get_kernel=functools.partial(lgssm_mod.get_kernel, n=n, m=m),
        grad_statistic_dim=lgssm_mod.statistic_dim(n, m),
        unpack_grad=functools.partial(lgssm_mod.unpack_grad, n=n, m=m),
        default_prior=functools.partial(lgssm_mod.default_prior, n, m),
        get_fused=lgssm_mod.get_fused if scalar else None,
        suff_statistic_dim=stat_dim, y_statistic_dim=stat_dim,
        precondition_normals=(None if scalar
                              else lgssm_mod.precondition_normals))


LGSSM = _lgssm_api(1, 1)
GARCH = _api("garch", garch_mod, _stationary_prior(garch_mod))
SVJM = _api("svjm", svjm_mod, _stationary_prior(svjm_mod))
_MODELS = {"svm": SVM, "garch": GARCH, "svjm": SVJM}


def _no_particle_filter(*_, **__):
    raise NotImplementedError("discrete-state models have no particle "
                              "filter")


# the exact-message, preconditioner, Gibbs and predict fields of the HMM
# family, under its modules' own names
_HMM_FIELDS = ("logprior", "grad_logprior", "sample_prior",
               "project_parameters", "generate_data",
               "marginal_loglikelihood", "gradient_marginal_loglikelihood",
               "windowed_marginal_gradient", "windowed_complete_gradient",
               "latent_var_sample", "latent_var_distr", "gibbs_step",
               "predictive_loglikelihood", "precondition",
               "precondition_noise", "correction_term",
               "precondition_normals")


def _hmm_api(name: str, mod, default_prior) -> ModelAPI:
    """A discrete-state model: exact messages, no particle filter, float64
    (the JAX package's registry entries, ``has_pf=False``)."""
    return ModelAPI(
        name=name, get_kernel=_no_particle_filter, grad_statistic=None,
        grad_statistic_dim=0, unpack_grad=None, default_prior=default_prior,
        prior_mean_var=lambda p: (0.0, 1.0), has_pf=False,
        dtype=gauss_hmm_mod.DTYPE,
        **{f: getattr(mod, f) for f in _HMM_FIELDS})


@functools.lru_cache(maxsize=None)
def _gauss_hmm_api(num_states: int = 2, m: int = 1) -> ModelAPI:
    return _hmm_api(f"gauss_hmm_{num_states}_{m}", gauss_hmm_mod,
                    functools.partial(gauss_hmm_mod.default_prior,
                                      num_states, m))


@functools.lru_cache(maxsize=None)
def _arphmm_api(num_states: int = 2, m: int = 1, p: int = 1) -> ModelAPI:
    return _hmm_api(f"arphmm_{num_states}_{m}_{p}", arphmm_mod,
                    functools.partial(arphmm_mod.default_prior, num_states,
                                      m, m * p))


def get_model(name: str, **kwargs) -> ModelAPI:
    """The model adapter ``name``; the LGSSM takes ``n`` and ``m`` (the
    scalar entry ``LGSSM`` without them, or at n = m = 1), the GaussHMM
    ``num_states`` and ``m``, the ARPHMM also ``p``."""
    if name in _MODELS and not kwargs:
        return _MODELS[name]
    if name == "lgssm" and set(kwargs) <= {"n", "m"}:
        return _lgssm_api(int(kwargs.get("n", 1)), int(kwargs.get("m", 1)))
    if name == "gauss_hmm" and set(kwargs) <= {"num_states", "m"}:
        return _gauss_hmm_api(int(kwargs.get("num_states", 2)),
                              int(kwargs.get("m", 1)))
    if name == "arphmm" and set(kwargs) <= {"num_states", "m", "p"}:
        return _arphmm_api(int(kwargs.get("num_states", 2)),
                           int(kwargs.get("m", 1)), int(kwargs.get("p", 1)))
    if name == "slds":
        raise NotImplementedError("model 'slds' is not ported yet "
                                  "(ROADMAP.md, Queue 1, slice 13: the "
                                  "SLDS)")
    raise NotImplementedError(f"model '{name}' with {kwargs} is not ported "
                              "yet")
