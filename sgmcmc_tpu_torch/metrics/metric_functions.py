"""Metric / sample function factories for evaluators.

Counterpart of ``sgmcmc_tpu/metrics/metric_functions.py``: each factory
returns ``sampler -> dict(metric=..., variable=..., value=...)`` (or a list
of such dicts) consumed by the evaluators.  Parameter comparisons read the
fields of the sampler's parameter dataclass (one chain's, on any device)
as NumPy; the error metrics are {mse, logmse, rmse, mae}.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from ..io.checkpoint import tree_to_numpy


def _error(metric: str, a: np.ndarray, b: np.ndarray) -> float:
    diff = np.ravel(a) - np.ravel(b)
    mse = float(np.mean(diff ** 2))
    if metric == "mse":
        return mse
    if metric == "logmse":
        return float(np.log10(mse)) if mse > 0 else -np.inf
    if metric == "rmse":
        return float(np.sqrt(mse))
    if metric == "mae":
        return float(np.mean(np.abs(diff)))
    raise ValueError(f"Unrecognized metric '{metric}'")


def metric_function_parameters(target_parameters, variables: list[str],
                               metric: str = "logmse",
                               target_variables: list[str] | None = None
                               ) -> Callable:
    """Per-variable error of sampler.parameters vs target parameters."""
    target_variables = target_variables or variables

    def metric_fn(sampler):
        rows = []
        for var, tvar in zip(variables, target_variables):
            value = _error(metric,
                           tree_to_numpy(getattr(sampler.parameters, var)),
                           tree_to_numpy(getattr(target_parameters, tvar)))
            rows.append(dict(metric=f"{var}_{metric}", variable=var,
                             value=value))
        return rows

    return metric_fn


def sample_function_parameters(variables: list[str]) -> Callable:
    """Record current parameter values."""
    def sample_fn(sampler):
        rows = []
        for var in variables:
            val = tree_to_numpy(getattr(sampler.parameters, var))
            if val.size == 1:
                rows.append(dict(variable=var, value=float(val.ravel()[0])))
            else:
                for idx, v in enumerate(val.ravel()):
                    rows.append(dict(variable=f"{var}_{idx}",
                                     value=float(v)))
        return rows

    return sample_fn


def noisy_logjoint_loglike_metric(**kwargs) -> Callable:
    """Noisy log-joint + log-likelihood rows."""
    def metric_fn(sampler):
        out = sampler.noisy_logjoint(return_loglike=True, **kwargs)
        return [
            dict(metric="logjoint", variable="all",
                 value=float(out["logjoint"])),
            dict(metric="loglikelihood", variable="all",
                 value=float(out["loglikelihood"])),
        ]

    return metric_fn


def metric_function_from_sampler(sampler_func_name: str,
                                 metric_name: str | None = None,
                                 return_variable_name: str = "sampler",
                                 **sampler_func_kwargs) -> Callable:
    """Generic metric = the value of a named sampler method.

    Example: ``metric_function_from_sampler("exact_loglikelihood")``.
    """
    if metric_name is None:
        metric_name = sampler_func_name

    def metric_fn(sampler):
        func = getattr(sampler, sampler_func_name, None)
        if func is None:
            raise ValueError(
                f"sampler has no method '{sampler_func_name}'")
        return dict(variable=return_variable_name, metric=metric_name,
                    value=float(func(**sampler_func_kwargs)))

    return metric_fn


def noisy_predictive_logjoint_loglike_metric(num_steps_ahead: int,
                                             kind: str = "marginal",
                                             metric_name_prefix: str = "",
                                             **kwargs) -> Callable:
    """k-step predictive-loglikelihood rows: on the PF path one row per
    horizon (slot 0 = the filter loglikelihood); on the exact path a
    single row."""
    names = [f"{metric_name_prefix}{ii}_pred_loglikelihood"
             for ii in range(num_steps_ahead + 1)]

    def metric_fn(sampler):
        res = sampler.predictive_loglikelihood(
            num_steps_ahead=num_steps_ahead, lag=num_steps_ahead,
            kind=kind, **kwargs)
        if kind == "pf":
            return [dict(variable="sampler", metric=names[ii],
                         value=float(res[ii]))
                    for ii in range(num_steps_ahead + 1)]
        return [dict(variable="sampler", metric=names[-1],
                     value=float(res))]

    return metric_fn


def metric_compare_x(true_x, metric: str = "rmse", N: int = 1000,
                     **predict_kwargs) -> Callable:
    """Latent-path recovery error.  LGSSM samplers use the exact Kalman
    smoothed means (float64); the particle-filter models (SVM, GARCH,
    SVJM) the smoothed PF latent means through the ``predict`` surface
    (``N`` particles, ``predict_kwargs`` forwarded, e.g. ``pf='paris'``)."""
    true_x = np.asarray(true_x)

    def metric_fn(sampler):
        model = getattr(sampler, "model", None)
        if model is not None and model.name.startswith("lgssm"):
            mean, _ = sampler.predict(target="latent", kind="marginal")
        else:
            mean, _ = sampler.predict(target="latent", kind="pf", N=N,
                                      **predict_kwargs)
        return dict(metric=f"x_{metric}", variable="x",
                    value=_error(metric, np.asarray(mean), true_x))

    return metric_fn


def best_permutation_metric_function_parameters(
        target_parameters, variables: list[str], metric: str = "logmse",
        num_states: int | None = None) -> Callable:
    """Label-permutation-invariant comparison for HMM-family state-indexed
    parameters: minimizes over state relabelings."""
    from itertools import permutations

    def metric_fn(sampler):
        rows = []
        K = num_states
        if K is None:
            K = tree_to_numpy(getattr(sampler.parameters,
                                      variables[0])).shape[0]
        best = None
        for perm in permutations(range(K)):
            perm = list(perm)
            total = 0.0
            for var in variables:
                a = tree_to_numpy(getattr(sampler.parameters, var))
                b = tree_to_numpy(getattr(target_parameters, var))
                if var == "pi":
                    a_p = a[perm][:, perm]
                else:
                    a_p = a[perm]
                total += float(np.mean((np.ravel(a_p) - np.ravel(b)) ** 2))
            if best is None or total < best[0]:
                best = (total, perm)
        _, perm = best
        for var in variables:
            a = tree_to_numpy(getattr(sampler.parameters, var))
            b = tree_to_numpy(getattr(target_parameters, var))
            a_p = a[perm][:, perm] if var == "pi" else a[perm]
            rows.append(dict(metric=f"{var}_{metric}", variable=var,
                             value=_error(metric, a_p, b)))
        return rows

    return metric_fn


def z_metric_rows(true_z, probs) -> list[dict]:
    """Discrete-latent recovery rows of posterior state probabilities
    ``probs [T, K]`` against ``true_z [T]``: NMI (NaN without scikit-learn),
    precision / recall by the cluster-matching definition on the
    true-by-predicted confusion matrix C (precision = sum_j max_i C_ij /
    sum(C), recall = sum_i max_j C_ij / sum(C)) and the best single
    global permutation's accuracy."""
    true_z = np.asarray(true_z)
    probs = np.asarray(probs)
    pred = np.argmax(probs, axis=-1)
    try:
        from sklearn.metrics import normalized_mutual_info_score
        nmi = float(normalized_mutual_info_score(true_z, pred))
    except ImportError:     # pragma: no cover
        nmi = float("nan")
    K = probs.shape[-1]
    Kt = max(K, int(true_z.max()) + 1)
    cm = np.bincount(true_z.astype(int) * Kt + pred.astype(int),
                     minlength=Kt * Kt).reshape(Kt, Kt).astype(float)
    total = cm.sum()
    precision = float(cm.max(axis=0).sum() / total)
    recall = float(cm.max(axis=1).sum() / total)
    from itertools import permutations
    acc = max(np.mean(np.take(np.asarray(perm), pred) == true_z)
              for perm in permutations(range(K)))
    return [dict(metric="z_nmi", variable="z", value=nmi),
            dict(metric="precision", variable="z", value=precision),
            dict(metric="recall", variable="z", value=recall),
            dict(metric="z_accuracy", variable="z", value=float(acc))]


def metric_compare_z(true_z, num_states: int | None = None) -> Callable:
    """Discrete-latent recovery rows (:func:`z_metric_rows`) of the
    smoothed state probabilities of the sampler's one chain, through its
    model's ``latent_var_distr`` (GaussHMM, ARPHMM); a model whose latents
    are Gaussian (its ``latent_var_distr`` gives moments) raises
    ``ValueError``, one without exact messages ``NotImplementedError``."""
    true_z = np.asarray(true_z)

    def metric_fn(sampler):
        distr = getattr(sampler.model, "latent_var_distr", None)
        if distr is None:
            raise NotImplementedError(
                "metric_compare_z needs a model with latent_var_distr")
        params = sampler.parameters
        if params.num_chains != 1:
            raise ValueError(
                f"metric_compare_z works on one chain's parameters, but the "
                f"sampler holds {params.num_chains}; call select_chain(i)")
        out = distr(params, sampler.observations)
        if isinstance(out, tuple):
            raise ValueError(
                "metric_compare_z requires a discrete-latent model "
                "(latent_var_distr returned Gaussian moments)")
        return z_metric_rows(true_z, out[0].detach().cpu().numpy())

    return metric_fn
