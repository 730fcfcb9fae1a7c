"""User-facing sampler classes (counterpart of
``sgmcmc_tpu/inference/samplers.py``: the steppers, ``fit``,
``fit_timed``, ``fit_scan`` for every gradient iter type and
``fit_scan_chunked``, the chain plumbing, the likelihood surface, the
predict surface (``predict``, ``predictive_loglikelihood``, ``simulate``
and their aliases), the multi-sequence samplers, blocked Gibbs (LGSSM,
GaussHMM, ARPHMM), SCIR's SGLD on the HMMs' transition simplex and the
SLDS's blocked Gibbs and complete-data SGLD (:class:`SLDSSampler`)).

A :class:`Sampler` holds the model, the observations (in the model's
dtype: float32, float64 for the HMM family), the prior, the parameters
(always with a leading chain axis: ``[1, ...]`` for one chain), a seeded
``torch.Generator`` and its ``device``: the card unless the caller passes
``device="cpu"``.  The default score kind is the particle filter's, or
the exact messages' (``"marginal"``) for a model without one.  Without a
card the default raises; it never falls back to the CPU.  The
likelihoods return a float when the sampler holds one chain and a ``[C]``
tensor for C chains.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from ..io.checkpoint import unstack_trace
from ..models.base import params_map
from ..models import slds as slds_mod
from ..models.registry import ModelAPI, get_model
from ..ops import hmm as hmm_ops
from ..ops.buffered import run_buffered_pf, window_weights
from ..ops.subsequence import (sample_buffered_window, slice_window,
                               window_length)
from ..utils.profiling import sync
from . import sgmcmc


def _pf_options(kwargs: dict, names=("kernel", "resampler", "resample_mode")):
    """The particle filter options among a predict call's keywords (the
    others are ignored, as in the JAX package)."""
    return {k: kwargs[k] for k in names if k in kwargs}


def _step_valid(lengths: torch.Tensor, observations) -> torch.Tensor:
    """[R, T_max] 1 on the steps of each row of ``observations [R, T_max,
    m]`` up to its length, 0 on its padded tail."""
    T_max = observations.shape[1]
    return (torch.arange(T_max, device=observations.device)
            < lengths[:, None]).to(observations.dtype)


# fit_scan's iter types that run one stepper of Sampler._step
_STEP_OF = {"SGLD": "sgld", "SGRLD": "sgrld", "SGD": "sgd", "SGRD": "sgrd"}
FIT_SCAN_TYPES = (*_STEP_OF, "ADAGRAD", "SGLD-CV")


def _device(device) -> torch.device:
    """``device`` as a torch.device; the card raises when there is none
    (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} needs a CUDA card but no "
                           "CUDA device is available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def _as_observations(observations, device, dtype) -> torch.Tensor:
    """Observations (array or tensor) on ``device`` in ``dtype``, a 1-D
    series as ``[T, 1]``."""
    obs = torch.as_tensor(np.asarray(observations) if not isinstance(
        observations, torch.Tensor) else observations)
    obs = obs.to(device=device, dtype=dtype)
    return obs[:, None] if obs.ndim == 1 else obs


def _per_chain(values: torch.Tensor):
    """A float for one chain's ``[1]`` values, else the ``[C]`` tensor;
    NaNs raise."""
    if bool(torch.isnan(values).any()):
        raise ValueError("NaNs in loglikelihood")
    return float(values[0]) if values.shape[0] == 1 else values


def _check_gradient(grad) -> None:
    """Raise on a NaN in any field of ``grad`` (one host read)."""
    if bool(torch.stack([torch.isnan(x).any() for x in _leaves(grad)]).any()):
        raise ValueError("NaNs in gradient")


def _to_cpu(params):
    return None if params is None else params_map(lambda x: x.cpu(), params)


def _leaves(params):
    return [getattr(params, f.name) for f in dataclasses.fields(params)]


class Sampler:
    """Stateful wrapper over the chain-batched SG-MCMC core."""

    def __init__(self, model: ModelAPI | str, observations=None, prior=None,
                 parameters=None, seed: int = 0, device="cuda"):
        self.device = _device(device)
        self.model = get_model(model) if isinstance(model, str) else model
        self.observations = (None if observations is None else
                             _as_observations(observations, self.device,
                                              self.model.dtype))
        self.prior = (self.model.default_prior(device=self.device)
                      if prior is None else prior)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._cache: dict = {}
        self._num_chains: int | None = None
        self._adagrad_state: sgmcmc.AdagradState | None = None
        # without explicit parameters, one projected prior draw (callers
        # such as the benchmark then overwrite it)
        self.parameters = (parameters if parameters is not None else
                           self.model.project_parameters(
                               self.model.sample_prior(self.prior,
                                                       self.generator, 1)))

    @property
    def parameters(self):
        return self._parameters

    @parameters.setter
    def parameters(self, params):
        self._parameters = params.to(self.device)

    @property
    def T(self) -> int:
        return int(self.observations.shape[0])

    def _default_kind(self) -> str:
        """The score kind that ``kind=None`` means."""
        return "pf" if self.model.has_pf else "marginal"

    def _score_config(self, **kwargs) -> sgmcmc.PFScoreConfig:
        if (kwargs.get("mesh") is not None
                or kwargs.get("n_particle_devices") is not None
                or kwargs.get("island_fused")):
            raise NotImplementedError(
                "mesh=, n_particle_devices= and island_fused= (the sharded "
                "fits) are not ported yet (ROADMAP.md, Queue 1, slice 14: "
                "parallel)")
        return sgmcmc.PFScoreConfig(
            n_particles=kwargs.get("N", kwargs.get("n_particles", 1000)),
            subsequence_length=kwargs.get("subsequence_length", -1),
            buffer_length=kwargs.get("buffer_length", 0),
            minibatch_size=kwargs.get("minibatch_size", 1),
            smoother=kwargs.get("pf", kwargs.get("smoother", "poyiadjis_N")),
            resampler=kwargs.get("resampler", "multinomial"),
            resample_mode=kwargs.get("resample_mode", "auto"),
            lambduh=kwargs.get("lambduh", 0.95),
            n_tilde=kwargs.get("Ntilde", kwargs.get("n_tilde", 2)),
            partition_style=kwargs.get("partition_style", "uniform"),
            ess_threshold=kwargs.get("ess_threshold", None),
            bw_chunk=kwargs.get("bw_chunk", None),
            rng=kwargs.get("rng", "host"),
        )

    def _grad_fn(self, preconditioned: bool = False, is_scaled: bool = True,
                 kind: str | None = None, **kwargs):
        """The noisy-gradient function of the score ``kind``: the particle
        filter's (``"pf"``) or, for models with exact message passing, the
        buffered exact-message score (``"marginal"``) or the FFBS
        complete-data score (``"complete"``, ``num_samples`` draws a
        window); ``None`` is :meth:`_default_kind`.  ``preconditioned``
        applies the model's SGRLD preconditioner; ``is_scaled=False`` drops
        the 1/T of the gradient."""
        m = self.model
        kind = self._default_kind() if kind is None else kind
        cfg = self._score_config(**kwargs)
        kernel_name = kwargs.get("kernel")
        key = ("grad", cfg, kind, kernel_name, preconditioned, is_scaled,
               self.T, self._score_key(**kwargs),
               kwargs.get("num_samples", 1))
        if key not in self._cache:
            precond = self._preconditioner() if preconditioned else None
            score = self._make_score(cfg, kernel_name, kind, **kwargs)
            self._cache[key] = sgmcmc.make_noisy_grad_fn(
                score, lambda p: m.grad_logprior(self.prior, p), self.T,
                is_scaled=is_scaled, preconditioner=precond)
        return self._cache[key]

    def _preconditioner(self) -> sgmcmc.Preconditioner:
        m = self.model
        if m.precondition is None:
            raise NotImplementedError(f"{m.name} has no preconditioner")
        return sgmcmc.Preconditioner(m.precondition, m.precondition_noise,
                                     m.correction_term,
                                     m.precondition_normals)

    def _score_key(self, **kwargs):
        """What else than the config and kernel selects the score."""
        return None

    def _make_score(self, cfg: sgmcmc.PFScoreConfig, kernel_name,
                    kind: str = "pf", **kwargs):
        m = self.model
        if kind == "marginal":
            if m.windowed_marginal_gradient is None:
                raise NotImplementedError(
                    f"{m.name} has no analytic message passing")
            return sgmcmc.make_marginal_score_fn(
                m.windowed_marginal_gradient, cfg, self.T)
        if kind == "complete":
            if m.windowed_complete_gradient is None:
                raise NotImplementedError(
                    f"{m.name} has no complete-data gradient path")
            return sgmcmc.make_marginal_score_fn(
                m.windowed_complete_gradient, cfg, self.T, pass_draws=True,
                num_samples=kwargs.get("num_samples", 1),
                state_dim=(m.get_kernel(kernel_name).state_dim if m.has_pf
                           else 1),
                discrete=not m.has_pf)
        if kind != "pf":
            raise ValueError(f"Unrecognized kind = '{kind}'")
        return sgmcmc.make_pf_score_fn(
            m.get_kernel(kernel_name), m.grad_statistic,
            m.grad_statistic_dim, m.unpack_grad, cfg, self.T,
            prior_mean_var_fn=m.prior_mean_var,
            fused_model=m.get_fused(kernel_name) if m.get_fused else None)

    def _loglik_fn(self, **kwargs) -> sgmcmc.PFScore:
        """The particle filter's log-likelihood estimator: the PF score of
        the model's sufficient statistic (on the unfused route)."""
        m = self.model
        cfg = self._score_config(**kwargs)
        kernel_name = kwargs.get("kernel")
        key = ("loglik", cfg, kernel_name, self.T)
        if key not in self._cache:
            self._cache[key] = sgmcmc.make_pf_score_fn(
                m.get_kernel(kernel_name), m.suff_statistic,
                m.suff_statistic_dim, lambda s: s, cfg, self.T,
                prior_mean_var_fn=m.prior_mean_var)
        return self._cache[key]

    # -- likelihoods -------------------------------------------------------
    def noisy_loglikelihood(self, kind: str | None = None, **kwargs):
        """A noisy log-likelihood per chain: the particle filter's
        (``"pf"``) or the exact-message score's buffered one
        (``"marginal"``; the exact one for ``subsequence_length=-1``) or the
        FFBS complete-data one (``"complete"``); ``None`` is
        :meth:`_default_kind`."""
        kind = self._default_kind() if kind is None else kind
        if kind in ("marginal", "complete"):
            if kind == "marginal" and kwargs.get("subsequence_length",
                                                 -1) == -1:
                return self.exact_loglikelihood()
            _, loglik = self._grad_fn(kind=kind, **kwargs)(
                self.generator, self.parameters, self.observations)
        elif kind == "pf":
            _, loglik = self._loglik_fn(**kwargs)(
                self.generator, self.parameters, self.observations)
        else:
            raise ValueError(f"Unrecognized kind = '{kind}'")
        return _per_chain(loglik)

    def noisy_logjoint(self, return_loglike: bool = False, **kwargs):
        """noisy_loglikelihood + logprior per chain."""
        ll = self.noisy_loglikelihood(**kwargs)
        return self._joint(ll, return_loglike)

    def exact_logjoint(self, return_loglike: bool = False):
        """exact_loglikelihood + logprior per chain."""
        return self._joint(self.exact_loglikelihood(), return_loglike)

    def _joint(self, ll, return_loglike: bool):
        lp = _per_chain(self.model.logprior(self.prior, self.parameters))
        if return_loglike:
            return dict(logjoint=ll + lp, loglikelihood=ll)
        return ll + lp

    def exact_loglikelihood(self):
        """The exact marginal log-likelihood per chain (float64)."""
        if self.model.marginal_loglikelihood is None:
            raise NotImplementedError(
                f"{self.model.name} has no exact marginal likelihood")
        return _per_chain(self.model.marginal_loglikelihood(
            self.parameters, self.observations))

    def exact_gradient(self):
        """The exact gradient of the log-likelihood per chain, as float64
        parameters."""
        if self.model.marginal_loglikelihood is None:
            raise NotImplementedError(
                f"{self.model.name} has no exact marginal likelihood")
        return self.model.gradient_marginal_loglikelihood(
            self.parameters, self.observations)

    # -- gradient / steps --------------------------------------------------
    def noisy_gradient(self, preconditioner: bool = False,
                       is_scaled: bool = True, check_finite: bool = True,
                       **kwargs):
        """The noisy gradient at the current parameters (with the model's
        preconditioner applied if ``preconditioner``); NaNs raise unless
        ``check_finite=False``, which skips that one host read."""
        grad, _ = self._grad_fn(preconditioned=bool(preconditioner),
                                is_scaled=is_scaled, **kwargs)(
            self.generator, self.parameters, self.observations)
        if check_finite:
            _check_gradient(grad)
        return grad

    def _step(self, name: str, epsilon: float, **kwargs):
        """The stepper ``name`` (``sgld``, ``sgrld``, ``sgd`` or ``sgrd``,
        preconditioned SGD) as ``step(generator, params, observations) ->
        (params, loglik)``, without the projection."""
        T = self.T
        if name == "sgld":
            grad_fn = self._grad_fn(**kwargs)
            return lambda gen, p, obs: sgmcmc.sgld_step(
                gen, p, obs, grad_fn, epsilon, T)
        if name == "sgrld":
            precond = self._preconditioner()
            grad_fn = self._grad_fn(preconditioned=True, **kwargs)
            return lambda gen, p, obs: sgmcmc.sgrld_step(
                gen, p, obs, grad_fn, precond, epsilon, T)
        if name in ("sgd", "sgrd"):
            grad_fn = self._grad_fn(preconditioned=name == "sgrd", **kwargs)
            return lambda gen, p, obs: sgmcmc.sgd_step(
                gen, p, obs, grad_fn, epsilon)
        raise ValueError(name)

    def _advance(self, name: str, epsilon: float, **kwargs):
        new, _ = self._step(name, epsilon, **kwargs)(
            self.generator, self.parameters, self.observations)
        self.parameters = self.model.project_parameters(new)
        return self.parameters

    def sample_sgld(self, epsilon, **kwargs):
        return self._advance("sgld", epsilon, **kwargs)

    def sample_sgrld(self, epsilon, **kwargs):
        return self._advance("sgrld", epsilon, **kwargs)

    def step_sgd(self, epsilon, **kwargs):
        return self._advance("sgd", epsilon, **kwargs)

    def step_precondition_sgd(self, epsilon, **kwargs):
        """Preconditioned SGD (MAP ascent in the Riemannian metric)."""
        return self._advance("sgrd", epsilon, **kwargs)

    def _centre(self, centering_parameters, centering_gradient, C: int):
        """The centre's parameters and gradient over the C chains the step
        runs (each given for one chain or for C)."""
        def over_chains(p, what):
            p = p.to(self.device)
            if p.num_chains == C:
                return p
            if p.num_chains != 1:
                raise ValueError(f"{what} has {p.num_chains} chains, "
                                 f"expected 1 or {C}")
            return params_map(lambda x: x.expand((C,) + x.shape[1:]), p)
        return (over_chains(centering_parameters, "centering_parameters"),
                over_chains(centering_gradient, "centering_gradient"))

    def sample_sgld_cv(self, epsilon, centering_parameters,
                       centering_gradient, **kwargs):
        """SGLD with control variates: grad = centering_gradient +
        grad(theta) - grad(centre) on one draw of the score."""
        grad_fn = self._grad_fn(**kwargs)
        centre, c_grad = self._centre(centering_parameters,
                                      centering_gradient,
                                      self.parameters.num_chains)
        new, _ = sgmcmc.sgld_cv_step(
            self.generator, self.parameters, self.observations, grad_fn,
            centre, c_grad, epsilon, self.T)
        self.parameters = self.model.project_parameters(new)
        return self.parameters

    def _adagrad_state_for(self, params) -> sgmcmc.AdagradState:
        """The held ADAGRAD state if it matches ``params``' chains, else a
        fresh one."""
        st = self._adagrad_state
        if st is None or st.t.shape[0] != params.num_chains:
            st = sgmcmc.adagrad_init(params)
        return st

    def step_adagrad(self, epsilon, **kwargs):
        grad_fn = self._grad_fn(**kwargs)
        new, self._adagrad_state, _ = sgmcmc.adagrad_step(
            self.generator, self.parameters,
            self._adagrad_state_for(self.parameters), self.observations,
            grad_fn, epsilon)
        self.parameters = self.model.project_parameters(new)
        return self.parameters

    def project_parameters(self, **kwargs):
        self.parameters = self.model.project_parameters(self.parameters,
                                                        **kwargs)
        return self.parameters

    # -- fit ---------------------------------------------------------------
    def get_iter_step(self, iter_type: str):
        """iter_type -> bound step method; ``"custom"`` takes
        ``iter_funcs=[(method_name, kwargs), ...]`` per iteration."""
        if iter_type == "custom":
            def custom_step(epsilon=None, iter_funcs=(), **_):
                for name, fkw in iter_funcs:
                    getattr(self, name)(**fkw)
                return self.parameters

            return custom_step
        table = {"SGLD": self.sample_sgld, "SGRLD": self.sample_sgrld,
                 "SGD": self.step_sgd, "SGRD": self.step_precondition_sgd,
                 "ADAGRAD": self.step_adagrad}
        if iter_type not in table:
            raise ValueError(f"Unrecognized iter_type '{iter_type}'")
        return table[iter_type]

    def fit(self, iter_type: str, num_iters: int, epsilon: float = 0.1,
            output_all: bool = False, steps_per_iteration: int = 1,
            tqdm=None, **kwargs):
        """Python-loop fit, one step method call at a time; returns the
        final parameters, or with ``output_all`` the list of parameters
        (the initial ones first)."""
        step = self.get_iter_step(iter_type)
        params_list = [self.parameters] if output_all else None
        it = range(num_iters) if tqdm is None else tqdm(range(num_iters))
        for _ in it:
            for _ in range(steps_per_iteration):
                step(epsilon, **kwargs)
            if output_all:
                params_list.append(self.parameters)
        return params_list if output_all else self.parameters

    def _trace_entries(self, trace) -> list:
        """``fit_scan(num_chains=None)``'s trace as a list of parameters
        shaped as the sampler holds them."""
        stacked = self._num_chains is not None
        return unstack_trace(params_map(
            lambda x: x.transpose(0, 1) if stacked else x[:, None], trace))

    def fit_timed(self, iter_type: str, max_time: float,
                  epsilon: float = 0.1, steps_per_iteration: int = 1,
                  max_samples: int = 2000, chunk_iters: int | None = None,
                  **kwargs):
        """Wall-clock-budgeted fit: ``(parameters list, times)``, thinned
        (every stride-th iterate, the stride doubling) to at most about
        ``2 * max_samples`` entries.  ``chunk_iters`` runs ``fit_scan``
        chunks of that many iterations between clock checks (the chunk's
        times interpolated) instead of one step call at a time."""
        params_list, times = [self.parameters], [0.0]
        stride, it = 1, 0
        start = time.perf_counter()
        step = None if chunk_iters is not None else \
            self.get_iter_step(iter_type)
        while time.perf_counter() - start < max_time:
            prev = times[-1]
            if chunk_iters is not None:
                chunk = self._trace_entries(self.fit_scan(
                    iter_type, num_iters=chunk_iters, epsilon=epsilon,
                    steps_per_iteration=steps_per_iteration, **kwargs))
            else:
                for _ in range(steps_per_iteration):
                    step(epsilon, **kwargs)
                chunk = [self.parameters]
            now = time.perf_counter() - start
            for i, p in enumerate(chunk):
                it += 1
                if it % stride:
                    continue
                params_list.append(p)
                times.append(prev + (now - prev) * (i + 1) / len(chunk))
                if max_samples and len(params_list) > 2 * max_samples:
                    params_list, times = params_list[::2], times[::2]
                    stride *= 2
        return params_list, times

    def fit_evaluate(self, iter_type: str, max_time: float,
                     epsilon: float = 0.1, metric_functions=None,
                     sample_functions=None, eval_freq: float = 5.0,
                     steps_per_iteration: int = 1, **kwargs):
        """Wall-clock-budgeted fit with an inline evaluator: the sampler's
        clock counts the steps alone (each step's time up to the host read
        of its parameters), the evaluation's is kept apart; the metric and
        sample functions run every ``eval_freq`` seconds of sampler time
        and once at the end.  Returns the
        :class:`~..evaluation.evaluator.SamplerEvaluator`."""
        from ..evaluation.evaluator import SamplerEvaluator
        evaluator = SamplerEvaluator(self, metric_functions=metric_functions,
                                     sample_functions=sample_functions)
        step = self.get_iter_step(iter_type)
        sampler_time = last_eval = 0.0
        while sampler_time < max_time:
            t0 = time.perf_counter()
            for _ in range(steps_per_iteration):
                step(epsilon, **kwargs)
            sync(self.parameters)
            sampler_time += time.perf_counter() - t0
            evaluator.iteration += 1
            evaluator.elapsed_time = sampler_time
            if sampler_time - last_eval >= eval_freq:
                evaluator.eval_metric_functions(self, evaluator.iteration,
                                                time=sampler_time)
                evaluator.eval_sample_functions(self, evaluator.iteration,
                                                time=sampler_time)
                last_eval = sampler_time
        evaluator.eval_metric_functions(self, evaluator.iteration,
                                        time=sampler_time)
        return evaluator

    # -- multi-chain plumbing ----------------------------------------------
    def prior_chain_draws(self, num_chains: int, first=None):
        """Stacked ``[C, ...]`` parameters with chain 0 at ``first``
        (default: the sampler's one chain) and chains 1..C-1 independent
        projected prior draws; the sampler's parameters do not change."""
        C = int(num_chains)
        if first is None:
            if self._num_chains is not None:
                raise ValueError(
                    "sampler holds stacked chains; pass `first` "
                    "explicitly (e.g. select_chain() output)")
            first = self.parameters
        first = first.to(self.device)
        if C == 1:
            return first
        m = self.model
        draws = m.project_parameters(m.sample_prior(self.prior,
                                                    self.generator, C - 1))
        return params_map(lambda f, d: torch.cat([f, d.to(f.dtype)], 0),
                          first, draws)

    def select_chain(self, i: int = 0):
        """Collapse a stacked multi-chain state (and the ADAGRAD state) to
        chain ``i``."""
        if self._num_chains is None:
            return self.parameters
        self.parameters = params_map(lambda x: x[i:i + 1], self.parameters)
        st = self._adagrad_state
        if st is not None and st.t.shape[0] == self._num_chains:
            self._adagrad_state = sgmcmc.AdagradState(
                G=params_map(lambda x: x[i:i + 1], st.G), t=st.t[i:i + 1])
        self._num_chains = None
        return self.parameters

    def _chain_init_params(self, num_chains: int, chain_init):
        """Initial [C, ...] parameters: a stacked parameter object (used
        as-is), ``"prior"`` (C independent prior draws) or ``"replicate"``
        (copies of the current parameters; continues the chains if the
        sampler already holds C of them)."""
        C = int(num_chains)
        if not isinstance(chain_init, str):
            if chain_init.num_chains != C:
                raise ValueError(
                    f"chain_init has {chain_init.num_chains} chains, "
                    f"expected num_chains={C}")
            params = chain_init
        elif chain_init == "replicate":
            if self._num_chains == C:
                return self.parameters
            if self._num_chains is not None:
                raise ValueError(
                    f"sampler holds {self._num_chains} stacked chains; "
                    f"cannot re-fit with num_chains={C}")
            params = params_map(
                lambda x: x.expand((C,) + x.shape[1:]).contiguous(),
                self.parameters)
        elif chain_init == "prior":
            m = self.model
            params = m.project_parameters(
                m.sample_prior(self.prior, self.generator, C))
        else:
            raise ValueError(f"Unrecognized chain_init '{chain_init}'")
        self._num_chains = C
        self.parameters = params
        return self.parameters

    # a recorded trace beyond this size warns (record=k or "none" thin it)
    TRACE_WARN_BYTES = 2 << 30

    def _record_plan(self, num_iters: int, steps_per_iteration: int, record,
                     num_chains: int | None = None):
        """(recorded iterations, steps per recorded iteration, output_all).

        A ``record`` interval that does not divide ``num_iters`` truncates
        the run to the largest multiple, with a warning; a trace larger
        than ``TRACE_WARN_BYTES`` over the chains that run (``num_chains``,
        else the chains the sampler holds) warns too."""
        if record == "none":
            return num_iters, steps_per_iteration, False
        thin = 1 if record == "all" else int(record)
        if thin < 1:
            raise ValueError(f"record={record!r} must be >= 1")
        if thin > num_iters:
            raise ValueError(f"record={record!r} exceeds num_iters="
                             f"{num_iters}: nothing would be recorded")
        n_rec = num_iters // thin
        if n_rec * thin != num_iters:
            warnings.warn(
                f"record={record!r} does not divide num_iters={num_iters}; "
                f"running {n_rec * thin} iterations", stacklevel=3)
        held = self.parameters.num_chains
        per_iter = sum(x.numel() * x.element_size()
                       for x in _leaves(self.parameters)) // held
        C = held if num_chains is None else int(num_chains)
        total = per_iter * n_rec * C
        if total > self.TRACE_WARN_BYTES:
            warnings.warn(
                f"recorded trace would be ~{total / 2 ** 30:.1f} GiB ({C} "
                f"chains x {n_rec} recorded iters); thin with record=k or "
                f"pass record='none'", stacklevel=3)
        return n_rec, steps_per_iteration * thin, True

    def fit_scan(self, iter_type: str, num_iters: int, epsilon: float = 0.1,
                 steps_per_iteration: int = 1, num_chains: int | None = None,
                 chain_init="replicate", record="all",
                 return_aux: bool = False, **kwargs):
        """Run a fit of ``iter_type`` (SGLD, SGRLD, SGD, SGRD, ADAGRAD or
        SGLD-CV) and return the parameter trace.

        ``num_chains=C`` runs C independent chains batched in every kernel;
        the trace has a leading chain axis ``[C, iters, ...]`` and the
        sampler then holds the stacked ``[C, ...]`` parameters.  Without
        ``num_chains`` the sampler's chains run: one chain gives an
        ``[iters, ...]`` trace, held stacked chains continue.  ``record``
        is ``"all"``, an int k (keep every k-th iterate) or ``"none"``
        (trace None).  ``return_aux=True`` also returns the per-iteration
        log-likelihoods ``[C, iters]``.  ADAGRAD carries its state across
        calls; SGLD-CV takes ``centering_parameters`` (one chain or C) and
        ``centering_gradient``.
        """
        if iter_type not in FIT_SCAN_TYPES:
            raise NotImplementedError(
                f"fit_scan supports {'/'.join(FIT_SCAN_TYPES)}, not "
                f"'{iter_type}'")
        m, T = self.model, self.T
        if iter_type == "SGLD-CV":
            c_params = kwargs.pop("centering_parameters")
            c_grad = kwargs.pop("centering_gradient")
        n_rec, steps, output_all = self._record_plan(
            num_iters, steps_per_iteration, record, num_chains)
        if iter_type in _STEP_OF:
            step = self._step(_STEP_OF[iter_type], epsilon, **kwargs)
        else:
            grad_fn = self._grad_fn(**kwargs)
        squeeze = num_chains is None and self._num_chains is None
        params0 = (self.parameters if num_chains is None else
                   self._chain_init_params(int(num_chains), chain_init))
        if iter_type == "ADAGRAD":
            def state_step(gen, p, st, obs):
                return sgmcmc.adagrad_step(gen, p, st, obs, grad_fn, epsilon)

            params, self._adagrad_state, trace, aux = sgmcmc.fit_with_state(
                self.generator, params0, self._adagrad_state_for(params0),
                self.observations, state_step, n_rec,
                project_fn=m.project_parameters, steps_per_iter=steps,
                output_all=output_all)
        else:
            if iter_type == "SGLD-CV":
                centre, c_grad = self._centre(c_params, c_grad,
                                              params0.num_chains)

                def step(gen, p, obs):
                    return sgmcmc.sgld_cv_step(gen, p, obs, grad_fn, centre,
                                               c_grad, epsilon, T)

            params, trace, aux = sgmcmc.fit(
                self.generator, params0, self.observations, step, n_rec,
                project_fn=m.project_parameters, steps_per_iter=steps,
                output_all=output_all)
        self.parameters = params
        if squeeze:
            aux = aux[0]
            if trace is not None:
                trace = params_map(lambda x: x[0], trace)
        return (trace, aux) if return_aux else trace

    def fit_scan_chunked(self, iter_type: str, num_iters: int,
                         chunk_iters: int = 250, epsilon: float = 0.1,
                         num_chains: int | None = None,
                         chain_init="replicate", record="all", **kwargs):
        """``fit_scan`` in chunks of ``chunk_iters`` iterations, the
        generator threading through the chunks, so the chains are those of
        one long ``fit_scan``.  Returns the trace on the host: a list of
        parameters for the sampler's chain, or with ``num_chains=C`` one
        set of parameters with ``[C, num_recorded, ...]`` leaves.  Chunks
        are multiples of the ``record`` interval; a final remainder below
        it is dropped with a warning."""
        thin = 1 if record in ("all", "none") else int(record)
        if thin < 1:
            raise ValueError(f"record={record!r} must be >= 1")
        if thin > min(chunk_iters, num_iters):
            raise ValueError(
                f"record={record!r} exceeds chunk_iters={chunk_iters} / "
                f"num_iters={num_iters}: nothing would be recorded")
        if num_chains is None and record == "none":
            raise ValueError("fit_scan_chunked exists to return the trace; "
                             "use fit_scan(record='none') directly")

        def next_chunk(done):
            n = (min(chunk_iters, num_iters - done) // thin) * thin
            if n == 0 and num_iters - done > 0:
                warnings.warn(
                    f"fit_scan_chunked: dropping the final "
                    f"{num_iters - done} iterations (< record={record!r})",
                    stacklevel=3)
            return n

        chunks, done = [], 0
        while (n := next_chunk(done)) > 0:
            if num_chains is None:
                trace = self.fit_scan(iter_type, num_iters=n,
                                      epsilon=epsilon, record=record,
                                      **kwargs)
                chunks.extend(self._trace_entries(_to_cpu(trace)))
            else:
                trace = self.fit_scan(iter_type, num_iters=n,
                                      epsilon=epsilon, num_chains=num_chains,
                                      chain_init=chain_init, record=record,
                                      **kwargs)
                chain_init = "replicate"    # continue the stacked chains
                chunks.append(_to_cpu(trace))
            done += n
        if num_chains is None:
            return chunks
        if record == "none":
            return None
        return params_map(lambda *xs: torch.cat(xs, 1), *chunks)

    # -- prediction / latent recovery --------------------------------------
    def _one_chain(self, what: str):
        """The sampler's parameters, which must be one chain's."""
        C = self.parameters.num_chains
        if C != 1:
            raise ValueError(
                f"{what} works on one chain's parameters, but the sampler "
                f"holds {C} chains; call select_chain(i) first")
        return self.parameters

    def _exact_inputs(self, what: str):
        """(float64 parameters, float64 observations [1, T, m]) for the
        exact-message predict functions."""
        p = self._one_chain(what)
        return (params_map(lambda x: x.double(), p),
                self.observations.double()[None])

    def _pf_draws(self, R: int, W: int, N: int, kernel, resampler: str,
                  pf: str):
        """The particle filter's draws for R rows of W steps, in
        ``run_buffered_pf``'s layout."""
        gen, dev = self.generator, self.device
        Z = kernel.noise_dim
        z0 = torch.randn((R, Z, N), generator=gen, device=dev)
        normals = torch.randn((R, W, Z, N), generator=gen, device=dev)
        # systematic resampling takes one uniform a step, the others one a
        # particle
        u = torch.rand((R, W) if resampler == "systematic" else (R, W, N),
                       generator=gen, device=dev)
        # PaRIS's backward uniforms at its default n_tilde = 2
        v = (torch.rand((R, W, N, 2), generator=gen, device=dev)
             if pf in sgmcmc.PARIS_SMOOTHERS else None)
        return dict(z0=z0, normals=normals, u=u, v=v)

    def _run_pf(self, params, observations, stat_fn, statistic_dim: int,
                N: int, pf: str, kernel=None, resampler="multinomial",
                resample_mode="auto", **modes):
        """``run_buffered_pf`` over the rows of ``observations [R, W, m]``
        (``params`` of one chain, repeated for every row) with the
        smoother's ``modes``."""
        m = self.model
        R, W = observations.shape[:2]
        params = params_map(lambda x: x.expand((R,) + x.shape[1:]), params)
        kern = m.get_kernel(kernel)
        pm, pv = m.prior_mean_var(params)
        return run_buffered_pf(
            kern, stat_fn, params, observations,
            **self._pf_draws(R, W, N, kern, resampler, pf),
            statistic_dim=statistic_dim, smoother=pf, prior_mean=pm,
            prior_var=pv, resampler=resampler, resample_mode=resample_mode,
            generator=self.generator, **modes)

    def predict(self, target: str = "latent", kind: str | None = None,
                pf: str | None = None, N: int = 1000, squared=False,
                lag=None, num_samples: int | None = None,
                distr: str | None = None, **kwargs):
        """Latent or observation prediction for the sampler's one chain
        (``select_chain`` first when it holds more): ``(mean [T, .], cov
        [T, ., .])`` numpy arrays, or with ``num_samples`` posterior draws.

        ``target`` is ``"latent"`` or ``"y"``; ``lag`` selects
        p(. | y_{<= t+lag}): None smoothed, 0 filtered (the PF path then
        needs ``pf="filter"``, its default there), k >= 1 fixed-lag.
        ``kind="marginal"`` (the default of the discrete-state models) runs
        the exact messages in float64: the LGSSM's moments, the HMMs' state
        probabilities ``[T, K]`` (latent target only), and with
        ``num_samples`` draws ``distr="joint"`` (FFBS) or ``"marginal"``
        paths; ``kind="pf"`` runs the particle filter with elementwise
        statistics over the whole series (``kernel``, ``resampler`` and
        ``resample_mode`` in ``kwargs``)."""
        if target not in ("latent", "y"):
            raise ValueError(f"Unrecognized target '{target}'")
        m = self.model
        kind = self._default_kind() if kind is None else kind
        if kind == "marginal":
            if m.latent_var_distr is None:
                raise NotImplementedError(
                    f"{m.name} has no exact messages: no analytic predict "
                    f"for target='{target}'")
            sample_fn = (m.latent_var_sample if target == "latent"
                         else m.y_sample)
            distr_fn = m.latent_var_distr if target == "latent" else m.y_distr
            if distr_fn is None:
                raise NotImplementedError(
                    f"{m.name} has no analytic predict for target="
                    f"'{target}'")
            p, obs = self._exact_inputs("predict")
            if num_samples is not None:
                return sample_fn(p, self.generator, obs,
                                 num_samples=num_samples,
                                 distr=distr or "joint",
                                 lag=lag)[0].cpu().numpy()
            out = distr_fn(p, obs, lag=lag)
            if not isinstance(out, tuple):       # state probabilities
                return out[0].cpu().numpy()
            return out[0][0].cpu().numpy(), out[1][0].cpu().numpy()
        if num_samples is not None:
            raise NotImplementedError(
                "joint posterior sampling is not available on the PF path")
        pf, fixed_lag, stat_fn, stat_dim = self._pf_predict_setup(
            target, pf, lag, squared)
        p = self._one_chain("predict")
        out = self._run_pf(p, self.observations[None], stat_fn, stat_dim, N,
                           pf, elementwise=True, window_length=self.T,
                           fixed_lag=fixed_lag, **_pf_options(kwargs))
        mean, cov = self._pf_stat_to_moments(
            target, squared, p, out.mean_statistic.reshape(1, self.T, -1))
        return mean[0].cpu().numpy(), cov[0].cpu().numpy()

    def _pf_predict_setup(self, target, pf, lag, squared):
        """The PF predict contract for a checked ``target``, before the
        filter runs: (pf, fixed lag, statistic, its dimension).  lag=0 needs
        the filter and smoothing must not use it; ``squared`` is GARCH's."""
        m = self.model
        if pf is None:
            pf = "filter" if lag == 0 else "poyiadjis_N"
        if lag == 0 and pf != "filter":
            raise ValueError("pf must be 'filter' for lag = 0")
        if lag is None and pf == "filter":
            raise ValueError("pf must not be 'filter' for smoothing")
        fixed_lag = int(lag) if (lag is not None and lag > 0) else None
        if squared and target != "y" and m.name != "garch":
            raise NotImplementedError(
                f"squared=True latent moments are GARCH-only, not {m.name}")
        if target == "y":
            return pf, fixed_lag, m.y_statistic, m.y_statistic_dim
        return pf, fixed_lag, m.suff_statistic, m.suff_statistic_dim

    def _pf_stat_to_moments(self, target, squared, params, stats):
        """Elementwise smoothed statistics [R, T, dim] -> per-t (mean, cov)
        by the model's moment maps (``params`` of one chain)."""
        m = self.model
        params = params_map(
            lambda x: x.expand((stats.shape[0],) + x.shape[1:]), params)
        if target == "y":
            return m.y_moments(params, stats)
        if squared:
            return m.latent_moments(params, stats, squared=True)
        return m.latent_moments(params, stats)

    def _predictive_normals(self, num_steps_ahead: int, N: int):
        """The predictive statistic's Monte Carlo (or, for GARCH, forward-
        simulation) normals [K+1, N, 1]."""
        return torch.randn((num_steps_ahead + 1, N, 1),
                           generator=self.generator, device=self.device)

    def _pf_predictive(self, params, observations, num_steps_ahead: int,
                       N: int, valid_length=None, **kwargs):
        """The k-step predictive statistic's filter over the rows of
        ``observations [R, T, m]``: (statistics [R, K+1], loglik [R]).  Its
        Monte Carlo normals are drawn once and shared by every step and
        row."""
        m = self.model
        normals = self._predictive_normals(num_steps_ahead, N)
        stat_fn = m.make_predictive_stat_fn(
            observations, num_steps_ahead, normals, valid_length=valid_length)
        step_valid = (None if valid_length is None
                      else _step_valid(valid_length, observations))
        out = self._run_pf(params, observations, stat_fn,
                           num_steps_ahead + 1, N, "filter",
                           step_valid=step_valid, logsumexp_mode=True,
                           **_pf_options(kwargs, ("kernel", "resample_mode")))
        return out.statistics, out.loglikelihood

    def predictive_loglikelihood(self, num_steps_ahead: int = 5,
                                 kind: str | None = None, N: int = 1000,
                                 lag: int = 1, **kwargs):
        """k-step-ahead predictive log-likelihood of the sampler's one
        chain: the particle filter's ``[K+1]`` numpy array (slot 0 the
        filter's log-likelihood, slot k the summed k-step-ahead predictive
        log-likelihood), or for ``kind="marginal"`` the exact
        sum_t log p(y_t | y_{<= t-lag}) (float64); ``None`` is
        :meth:`_default_kind`."""
        m = self.model
        kind = self._default_kind() if kind is None else kind
        if kind == "marginal":
            if m.predictive_loglikelihood is None:
                raise NotImplementedError(
                    f"{m.name} has no exact predictive loglikelihood")
            p, obs = self._exact_inputs("predictive_loglikelihood")
            return float(m.predictive_loglikelihood(p, obs, lag=int(lag))[0])
        p = self._one_chain("predictive_loglikelihood")
        stats, loglik = self._pf_predictive(p, self.observations[None],
                                            num_steps_ahead, N, **kwargs)
        out = stats[0].cpu().numpy().copy()
        out[0] = float(loglik[0])
        return out

    # -- simulate ----------------------------------------------------------
    def simulate(self, T: int, parameters=None, return_distr: bool = False,
                 num_samples: int | None = None, include_init: bool = True):
        """One ``(ys, xs)`` draw of chain 0 from the model's data generator;
        for the LGSSM ``return_distr=True`` gives the prior moment
        trajectories (:func:`~..models.lgssm.simulate_distr`) and
        ``num_samples`` joint prior trajectories
        (:func:`~..models.lgssm.simulate_paths`), numpy arrays in float64,
        of one chain's parameters."""
        p = (self.parameters if parameters is None
             else parameters.to(self.device))
        m = self.model
        if return_distr or num_samples is not None:
            if m.simulate_distr is None:
                raise NotImplementedError(
                    "distributional simulate supports the LGSSM")
            if p.num_chains != 1:
                raise ValueError(
                    f"simulate works on one chain's parameters, got "
                    f"{p.num_chains}; call select_chain(i) first")
            p = params_map(lambda x: x.double(), p)
            if return_distr:
                out = m.simulate_distr(p, T, include_init=include_init)
            else:
                out = m.simulate_paths(p, self.generator, T,
                                       num_samples=num_samples,
                                       include_init=include_init)
            return {k: v[0].cpu().numpy() for k, v in out.items()}
        return m.generate_data(self.generator, p, T)

    # -- the JAX package's (and the reference's) method names ---------------
    def prior_init(self):
        """Fresh parameters of one chain from the prior, projected."""
        m = self.model
        self._num_chains = None
        self.parameters = m.project_parameters(
            m.sample_prior(self.prior, self.generator, 1))
        return self.parameters

    def latent_var_distr(self, lag=None, **kwargs):
        return self.predict(target="latent", lag=lag, **kwargs)

    def latent_var_sample(self, num_samples: int = 1, **kwargs):
        return self.predict(target="latent", num_samples=num_samples,
                            **kwargs)

    def y_distr(self, lag=None, **kwargs):
        return self.predict(target="y", lag=lag, **kwargs)

    def y_sample(self, num_samples: int = 1, **kwargs):
        return self.predict(target="y", num_samples=num_samples, **kwargs)

    def simulate_distr(self, T: int, parameters=None, include_init=True):
        return self.simulate(T, parameters=parameters, return_distr=True,
                             include_init=include_init)


class SVMSampler(Sampler):
    def __init__(self, observations=None, **kw):
        super().__init__("svm", observations, **kw)


class GARCHSampler(Sampler):
    def __init__(self, observations=None, **kw):
        super().__init__("garch", observations, **kw)


class SVJMSampler(Sampler):
    def __init__(self, observations=None, **kw):
        super().__init__("svjm", observations, **kw)


class GibbsSamplerMixin:
    """Blocked Gibbs for conjugate models (LGSSM, GaussHMM, ARPHMM)."""

    def sample_gibbs(self):
        """One Gibbs sweep (the latents | theta by FFBS, then the conjugate
        theta | latents) for every chain the sampler holds, then the
        projection."""
        m = self.model
        if m.gibbs_step is None:
            raise NotImplementedError(
                f"{m.name} has no conjugate Gibbs sampler")
        self.parameters = m.project_parameters(m.gibbs_step(
            self.generator, self.prior, self.parameters, self.observations))
        return self.parameters

    def get_iter_step(self, iter_type: str):
        """``"Gibbs"``: one sweep, then the projection; else the
        sampler's steppers."""
        if iter_type == "Gibbs":
            def step(*_, **__):
                self.sample_gibbs()
                return self.project_parameters()

            return step
        return super().get_iter_step(iter_type)


class SCIRSamplerMixin:
    """SGLD with the stochastic Cox-Ingersoll-Ross exact Gamma-process
    update of the transition simplex (Baker et al. 2018): the logit_pi
    slot of the score carries the unscaled Dirichlet statistic (the summed
    pairwise posteriors plus the prior's alpha), which SCIR turns into new
    simplex weights; every other parameter takes the Langevin update.  For
    models whose parameters hold ``logit_pi`` and whose
    ``windowed_marginal_gradient`` and ``grad_logprior`` take
    ``use_scir`` (GaussHMM, ARPHMM)."""

    def sample_sgld_scir(self, epsilon, **kwargs):
        """One SCIR step of every chain the sampler holds (the projection,
        without centring the new logits twice, inside the step)."""
        m, T = self.model, self.T
        cfg = self._score_config(**kwargs)
        key = ("sgld_scir", cfg, T)
        if key not in self._cache:
            self._cache[key] = sgmcmc.make_marginal_score_fn(
                lambda p, w, v, wt, B, S: m.windowed_marginal_gradient(
                    p, w, v, wt, B, S, use_scir=True), cfg, T)
        params = self.parameters
        grad_ll, _ = self._cache[key](self.generator, params,
                                      self.observations)
        grad = params_map(lambda g, q: g + q, grad_ll,
                          m.grad_logprior(self.prior, params, use_scir=True))
        theta_new = hmm_ops.scir_update(self.generator,
                                        torch.exp(params.logit_pi),
                                        grad.logit_pi, epsilon)
        new_logit = torch.log(torch.abs(theta_new) + 1e-99)
        new_logit = new_logit - new_logit.mean(-1, keepdim=True)
        scale = 1.0 / T
        new = sgmcmc._langevin(params, params_map(lambda g: g * scale, grad),
                               sgmcmc._normals_like(self.generator, params),
                               epsilon, scale)
        new = dataclasses.replace(new, logit_pi=new_logit)
        self.parameters = m.project_parameters(new, center_logit=False)
        return self.parameters


class LGSSMSampler(GibbsSamplerMixin, Sampler):
    """Linear-Gaussian state-space model, with the exact likelihood surface
    and blocked Gibbs: the scalar model by default, the vector one with
    ``n`` (the state's size) and ``m`` (the observations')."""
    def __init__(self, observations=None, n: int = 1, m: int = 1, **kw):
        super().__init__(get_model("lgssm", n=n, m=m), observations, **kw)


def pack_sequences(sequences):
    """List of ``[T_i, ...]`` arrays or tensors -> (padded
    ``[n_seq, T_max, ...]`` tensor, zero beyond each length; lengths
    ``[n_seq]`` int64 numpy)."""
    arrays = [np.asarray(s.detach().cpu() if isinstance(s, torch.Tensor)
                         else s) for s in sequences]
    lengths = np.array([a.shape[0] for a in arrays], np.int64)
    packed = np.zeros((len(arrays), int(lengths.max())) + arrays[0].shape[1:],
                      dtype=arrays[0].dtype)
    for i, a in enumerate(arrays):
        packed[i, :a.shape[0]] = a
    return torch.from_numpy(packed), lengths


class SeqSampler(Sampler):
    """Multi-sequence sampler: the observations are a list of sequences,
    and each gradient subsamples ``num_sequences`` of them (-1: all) and a
    subsequence within each (:class:`~.sgmcmc.SeqPFScore`, or
    :class:`~.sgmcmc.SeqMarginalScore` for ``kind="marginal"``).  ``T`` is
    the total length.  The particle filter's predict surface runs every
    sequence as one row of one padded program, its tails frozen by the
    step validity gate."""

    def __init__(self, model, observations: list, num_sequences: int = -1,
                 **kw):
        packed, lengths = pack_sequences(observations)
        self.lengths = lengths
        self.num_sequences = num_sequences
        super().__init__(model, packed[..., None] if packed.ndim == 2
                         else packed, **kw)

    @property
    def T(self) -> int:
        return int(self.lengths.sum())

    def _score_key(self, **kwargs):
        return kwargs.get("num_sequences", self.num_sequences)

    def _make_score(self, cfg: sgmcmc.PFScoreConfig, kernel_name,
                    kind: str = "pf", **kwargs):
        m = self.model
        num_sequences = self._score_key(**kwargs)
        if kind == "marginal":
            if m.windowed_marginal_gradient is None:
                raise NotImplementedError(
                    f"{m.name} has no analytic message passing")
            return sgmcmc.make_seq_marginal_score_fn(
                m.windowed_marginal_gradient, cfg, self.lengths,
                num_sequences)
        if kind != "pf":
            raise ValueError(f"Unrecognized kind = '{kind}' for SeqSampler")
        return sgmcmc.make_seq_pf_score_fn(
            m.get_kernel(kernel_name), m.grad_statistic,
            m.grad_statistic_dim, m.unpack_grad, cfg, self.lengths,
            num_sequences=num_sequences, prior_mean_var_fn=m.prior_mean_var,
            fused_model=m.get_fused(kernel_name) if m.get_fused else None)

    def noisy_loglikelihood(self, **kwargs):
        """The score's log-likelihood per chain (any ``kind``)."""
        _, loglik = self._grad_fn(**kwargs)(self.generator, self.parameters,
                                            self.observations)
        return _per_chain(loglik)

    def exact_loglikelihood(self):
        """Sum of the sequences' exact marginal log-likelihoods per chain
        (float64), as one validity-masked message pass over the padded
        sequences."""
        m = self.model
        if m.windowed_marginal_gradient is None:
            raise NotImplementedError(
                f"{m.name} has no exact marginal loglikelihood")
        score = sgmcmc.make_seq_marginal_score_fn(
            m.windowed_marginal_gradient,
            sgmcmc.PFScoreConfig(n_particles=1, subsequence_length=-1),
            self.lengths)
        params = params_map(lambda x: x.double(), self.parameters)
        return _per_chain(score(None, params,
                                self.observations.double())[1])

    def _sub_sampler(self, i: int) -> Sampler:
        """A single-sequence view of sequence i, sharing the model, the
        prior, the parameters and the generator."""
        key = ("sub", i)
        if key not in self._cache:
            self._cache[key] = Sampler(
                self.model, self.observations[i, :int(self.lengths[i])],
                prior=self.prior, parameters=self.parameters,
                device=self.device)
        sub = self._cache[key]
        sub.parameters = self.parameters
        sub.generator = self.generator
        return sub

    def predict(self, target: str = "latent", kind: str | None = None,
                pf: str | None = None, N: int = 1000, squared=False,
                lag=None, num_samples: int | None = None,
                distr: str | None = None, **kwargs) -> list:
        """Per-sequence predictions, a list of :meth:`Sampler.predict`'s
        results.  The particle filter runs every sequence as one row of one
        padded program (the tails frozen by the step validity gate); the
        exact-message and sampling paths loop over the sequences."""
        if target not in ("latent", "y"):
            raise ValueError(f"Unrecognized target '{target}'")
        kind = self._default_kind() if kind is None else kind
        if kind == "marginal" or num_samples is not None:
            return [self._sub_sampler(i).predict(
                target=target, kind=kind, pf=pf, N=N, squared=squared,
                lag=lag, num_samples=num_samples, distr=distr, **kwargs)
                for i in range(len(self.lengths))]
        pf, fixed_lag, stat_fn, stat_dim = self._pf_predict_setup(
            target, pf, lag, squared)
        p = self._one_chain("predict")
        obs = self.observations
        T_max = obs.shape[1]
        out = self._run_pf(p, obs, stat_fn, stat_dim, N, pf,
                           step_valid=_step_valid(torch.as_tensor(
                               self.lengths, device=self.device), obs),
                           elementwise=True, window_length=T_max,
                           fixed_lag=fixed_lag, **_pf_options(kwargs))
        mean, cov = self._pf_stat_to_moments(
            target, squared, p, out.mean_statistic.reshape(
                len(self.lengths), T_max, -1))
        mean, cov = mean.cpu().numpy(), cov.cpu().numpy()
        return [(mean[i, :T_i], cov[i, :T_i])
                for i, T_i in enumerate(self.lengths)]

    def predictive_loglikelihood(self, num_sequences: int = -1,
                                 num_steps_ahead: int = 5,
                                 kind: str | None = None, N: int = 1000,
                                 lag: int = 1, **kwargs):
        """Sum of the per-sequence predictive log-likelihoods over
        ``num_sequences`` sequences drawn without replacement (-1: all),
        rescaled by T_total / T_chosen.  The particle filter runs the
        chosen sequences as the rows of one padded program (the tails
        frozen by the step validity gate and masked in the statistic by
        each row's length); ``kind="marginal"`` loops over them."""
        kind = self._default_kind() if kind is None else kind
        n_seq = len(self.lengths)
        idx = np.arange(n_seq)
        if num_sequences != -1:
            seed = int(torch.randint(0, 2 ** 31, (), generator=self.generator,
                                     device=self.device))
            idx = np.random.default_rng(seed).choice(idx, num_sequences,
                                                     replace=False)
        scale = (float(self.lengths.sum()) / float(self.lengths[idx].sum())
                 if num_sequences != -1 else 1.0)
        if kind == "marginal":
            total = sum(self._sub_sampler(int(i)).predictive_loglikelihood(
                num_steps_ahead=num_steps_ahead, kind=kind, N=N, lag=lag,
                **kwargs) for i in idx)
            return total * scale
        p = self._one_chain("predictive_loglikelihood")
        stats, loglik = self._pf_predictive(
            p, self.observations[torch.as_tensor(idx, device=self.device)],
            num_steps_ahead, N, valid_length=torch.as_tensor(
                self.lengths[idx], device=self.device), **kwargs)
        out = stats.sum(0).cpu().numpy()
        out[0] = float(loglik.sum())
        return out * scale


class GaussHMMSampler(GibbsSamplerMixin, SCIRSamplerMixin, Sampler):
    """Gaussian HMM with ``num_states`` states and m-dimensional
    observations: exact-message SGLD (the default kind), the complete kind,
    SCIR and blocked Gibbs, in float64."""
    def __init__(self, observations=None, num_states: int = 2, m: int = 1,
                 **kw):
        super().__init__(get_model("gauss_hmm", num_states=num_states, m=m),
                         observations, **kw)


class ARPHMMSampler(GibbsSamplerMixin, SCIRSamplerMixin, Sampler):
    """AR(p) HMM over lag-stacked observations ``[T, p+1, m]``
    (``models/arphmm.stack_y``)."""
    def __init__(self, observations=None, num_states: int = 2, m: int = 1,
                 p: int = 1, **kw):
        super().__init__(get_model("arphmm", num_states=num_states, m=m,
                                   p=p), observations, **kw)


class SeqSVMSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("svm", observations, **kw)


class SeqSVJMSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("svjm", observations, **kw)


class SeqGARCHSampler(SeqSampler):
    def __init__(self, observations, **kw):
        super().__init__("garch", observations, **kw)


class SeqLGSSMSampler(SeqSampler):
    def __init__(self, observations, n: int = 1, m: int = 1, **kw):
        super().__init__(get_model("lgssm", n=n, m=m), observations, **kw)


class SeqGaussHMMSampler(SeqSampler):
    def __init__(self, observations, num_states: int = 2, m: int = 1, **kw):
        super().__init__(get_model("gauss_hmm", num_states=num_states, m=m),
                         observations, **kw)


class SeqARPHMMSampler(SeqSampler):
    """Sequences of lag-stacked observations ``[T_i, p+1, m]``."""
    def __init__(self, observations, num_states: int = 2, m: int = 1,
                 p: int = 1, **kw):
        super().__init__(get_model("arphmm", num_states=num_states, m=m,
                                   p=p), observations, **kw)


class SLDSSampler:
    """Blocked Gibbs and buffered complete-data SGLD for the switching LDS
    (counterpart of the JAX package's ``SLDSSampler``): the sampler holds
    the latent states beside the parameters of every chain, ``x [C, T,
    n]`` and ``z [C, T]``, and alternates x | z, z | x and theta | x, z.
    The SLDS has no marginal-likelihood gradient; its SG-MCMC score is the
    complete-data one, averaged over latent Gibbs draws on the window.
    Float64 on the card unless ``device="cpu"``, with a seeded
    ``torch.Generator``; the likelihoods return a float for one chain and
    a ``[C]`` tensor for C."""

    # the score's own options, and the generic driver and evaluator
    # keywords it takes and ignores (the SLDS has one gradient family);
    # anything else is a mistyped latent option and raises
    _SCORE_KWARGS = frozenset((
        "subsequence_length", "buffer_length", "latent_draws",
        "latent_burnin", "latent_thinning"))
    _IGNORED_KWARGS = frozenset((
        "kind", "pf", "N", "kernel", "resampler", "resample_mode",
        "minibatch_size", "partition_style", "lambduh", "Ntilde",
        "bw_chunk", "ess_threshold"))

    def __init__(self, observations, num_states: int = 2, n: int = 1,
                 m: int = 1, prior=None, parameters=None, seed: int = 0,
                 device="cuda"):
        self.device = _device(device)
        self.model = get_model("slds", num_states=num_states, n=n, m=m)
        self.observations = _as_observations(observations, self.device,
                                             self.model.dtype)
        self.prior = (self.model.default_prior(device=self.device)
                      if prior is None else prior)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._cache: dict = {}
        # the driver's resume state reads it; the SLDS has no ADAGRAD
        self._adagrad_state = None
        self.x = self.z = None
        self.parameters = (parameters if parameters is not None else
                           slds_mod.project_parameters(slds_mod.sample_prior(
                               self.prior, self.generator, 1)))

    @property
    def parameters(self):
        return self._parameters

    @parameters.setter
    def parameters(self, params):
        self._parameters = params.to(self.device)

    @property
    def T(self) -> int:
        return int(self.observations.shape[0])

    def _latents(self):
        """(x, z) of every chain, zeros for chains that have none yet (a
        new sampler, or a new number of chains)."""
        C, n = self.parameters.num_chains, self.parameters.n
        if self.z is None or self.z.shape[0] != C:
            self.z = torch.zeros((C, self.T), dtype=torch.int64,
                                 device=self.device)
            self.x = torch.zeros((C, self.T, n), dtype=self.model.dtype,
                                 device=self.device)
        return self.x, self.z

    def sample_gibbs(self):
        """One blocked sweep (x | z, z | x, theta | x, z) of every chain."""
        x, z = self._latents()
        self.parameters, self.x, self.z = slds_mod.gibbs_step(
            self.generator, self.prior, self.parameters, self.observations,
            x, z)
        return self.parameters

    def project_parameters(self):
        self.parameters = slds_mod.project_parameters(self.parameters)
        return self.parameters

    def exact_loglikelihood(self, given: str = "z"):
        """log p(y | z) at the sampler's z (``given="z"``) or log p(y, x)
        with z summed out at its x (``given="x"``), per chain."""
        if given not in ("z", "x"):
            raise ValueError(f"given must be 'z' or 'x', not {given!r}")
        x, z = self._latents()
        fn = (slds_mod.x_marginal_loglikelihood if given == "z"
              else slds_mod.z_marginal_loglikelihood)
        return _per_chain(fn(self.parameters, self.observations,
                             z if given == "z" else x))

    def fit(self, num_iters: int, output_all: bool = False):
        """``num_iters`` Gibbs sweeps, each projected; ``output_all``
        returns the parameters before and after every sweep."""
        out = [self.parameters] if output_all else None
        for _ in range(num_iters):
            self.sample_gibbs()
            self.project_parameters()
            if output_all:
                out.append(self.parameters)
        return out if output_all else self.parameters

    # -- SG-MCMC on buffered complete-data gradients ----------------------
    def _score_fn(self, S: int, B: int, latent_draws: int,
                  latent_burnin: int, latent_thinning: int):
        """score(generator, params, observations, draws=None) -> (gradient,
        weighted loglik [C]): each chain samples a buffered window (the
        whole series for ``S == -1`` or ``S >= T``), starts its latents
        from a uniform z and an x draw, runs ``latent_burnin`` sweeps of
        x | z and z | x on the window, then averages the weighted
        complete-data score over ``latent_draws`` draws taken
        ``latent_thinning`` sweeps apart."""
        T = self.T
        full = (S == -1) or (S >= T)
        W = window_length(S, B, T)

        def sweep(params, window, x, z, gen):
            x = slds_mod.x_latent_var_sample(params, gen, window, z)
            return x, slds_mod.z_latent_var_sample(params, gen, window, x)

        def score(generator, params, observations, draws=None):
            C, dt, dev = params.num_chains, observations.dtype, \
                observations.device
            if full:
                window = observations
                step_w = torch.ones((T,), dtype=dt, device=dev)
            else:
                win = sample_buffered_window(generator, S, B, T, C,
                                             dtype=dt, device=dev)
                window = slice_window(observations, win.window_start, W)
                step_w, _ = window_weights(win.t1, win.tL, win.weights, W,
                                           dt)
            z = torch.randint(0, params.num_states, (C, W),
                              generator=generator, device=dev)
            x = slds_mod.x_latent_var_sample(params, generator, window, z)
            for _ in range(latent_burnin):
                x, z = sweep(params, window, x, z, generator)
            grads, lls = [], []
            for _ in range(latent_draws):
                for _ in range(latent_thinning):
                    x, z = sweep(params, window, x, z, generator)
                grad, ll = slds_mod.windowed_complete_gradient(
                    params, window, x, z, step_w)
                grads.append(grad)
                lls.append(ll)
            return (params_map(lambda *gs: torch.stack(gs).mean(0), *grads),
                    torch.stack(lls).mean(0))

        return score

    def _grad_fn(self, is_scaled: bool = True, **kwargs):
        unknown = set(kwargs) - self._SCORE_KWARGS - self._IGNORED_KWARGS
        if unknown:
            raise TypeError(f"SLDSSampler got unknown options {unknown}")
        S = kwargs.get("subsequence_length", -1)
        B = max(kwargs.get("buffer_length", 0), 0)
        latent = (kwargs.get("latent_draws", 1),
                  kwargs.get("latent_burnin", 5),
                  kwargs.get("latent_thinning", 5))
        key = ("grad", S, B, latent, is_scaled)
        if key not in self._cache:
            self._cache[key] = sgmcmc.make_noisy_grad_fn(
                self._score_fn(S, B, *latent),
                lambda p: slds_mod.grad_logprior(self.prior, p), self.T,
                is_scaled=is_scaled)
        return self._cache[key]

    def noisy_gradient(self, is_scaled: bool = True,
                       check_finite: bool = True, **kwargs):
        """The noisy complete-data gradient at the current parameters;
        NaNs raise unless ``check_finite=False``."""
        grad, _ = self._grad_fn(is_scaled=is_scaled, **kwargs)(
            self.generator, self.parameters, self.observations)
        if check_finite:
            _check_gradient(grad)
        return grad

    def noisy_loglikelihood(self, **kwargs):
        """The weighted complete-data log-likelihood of the score, per
        chain."""
        _, ll = self._grad_fn(**kwargs)(self.generator, self.parameters,
                                        self.observations)
        return _per_chain(ll)

    def noisy_logjoint(self, return_loglike: bool = False, **kwargs):
        """noisy_loglikelihood + logprior per chain."""
        ll = self.noisy_loglikelihood(**kwargs)
        lp = _per_chain(slds_mod.logprior(self.prior, self.parameters))
        if return_loglike:
            return dict(logjoint=ll + lp, loglikelihood=ll)
        return ll + lp

    def sample_sgld(self, epsilon, **kwargs):
        """One projected SGLD step of every chain on the complete-data
        score."""
        new, _ = sgmcmc.sgld_step(self.generator, self.parameters,
                                  self.observations, self._grad_fn(**kwargs),
                                  epsilon, self.T)
        self.parameters = slds_mod.project_parameters(new)
        return self.parameters


def sampler_for_model(model_name: str, **kwargs):
    """Model name -> sampler instance (the one dispatch point generic code
    uses); ``kwargs`` go to the sampler's constructor."""
    classes = {"svm": SVMSampler, "svjm": SVJMSampler,
               "garch": GARCHSampler, "lgssm": LGSSMSampler,
               "gauss_hmm": GaussHMMSampler, "arphmm": ARPHMMSampler,
               "slds": SLDSSampler}
    if model_name not in classes:
        raise ValueError(f"Unknown model '{model_name}' (choose from "
                         f"{sorted(classes)})")
    return classes[model_name](**kwargs)
