"""Evaluators: tidy metric collection around samplers.

Counterpart of ``sgmcmc_tpu/evaluation/evaluator.py``:

* `BaseEvaluator`    — metric / sample rows (lists of dicts; DataFrames
  when read)
* `SamplerEvaluator` — online wrapper timing each sampler step, state
  save / load for resume
* `OfflineEvaluator` — re-evaluates a saved parameter trace in
  recursive-bisection order
* `average_parameters_list` / `half_average_parameters_list` — running
  means in flattened-vector space

pandas is imported only when ``metrics`` / ``samples`` (or
``get_metrics`` / ``get_samples``) are read, so the rows can be gathered
where pandas is not installed: ``metric_rows`` / ``sample_rows`` give them
as lists of dicts.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from ..utils.profiling import sync


def ravel_params(params):
    """(flat float64 NumPy vector, unravel) of a parameter dataclass: its
    fields in order, each flattened; ``unravel(vec)`` rebuilds the
    dataclass with tensors of each field's shape, dtype and device."""
    fields = [(f.name, getattr(params, f.name))
              for f in dataclasses.fields(params)]
    specs = [(name, tuple(x.shape), x.dtype,
              x.device if isinstance(x, torch.Tensor) else None)
             for name, x in fields]
    flat = np.concatenate([
        (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
         else np.asarray(x)).astype(np.float64).ravel() for _, x in fields])

    def unravel(vec):
        out, i = {}, 0
        for name, shape, dtype, device in specs:
            size = int(np.prod(shape))
            piece = np.asarray(vec[i:i + size]).reshape(shape)
            out[name] = (torch.as_tensor(piece, dtype=dtype, device=device)
                         if device is not None else piece.astype(dtype))
            i += size
        return dataclasses.replace(params, **out)

    return flat, unravel


def _as_rows(result) -> list[dict]:
    if isinstance(result, dict):
        return [result]
    return list(result)


def _frame(df, rows: list[dict]):
    """``df`` (a DataFrame or None) with ``rows`` appended."""
    import pandas as pd
    new = pd.DataFrame(rows)
    if df is None:
        return new
    return pd.concat([df, new], ignore_index=True) if rows else df


def _frame_rows(df) -> list[dict]:
    return [] if df is None else df.to_dict("records")


class BaseEvaluator:
    """Collects metric / sample rows.

    Rows are kept in plain lists; a DataFrame is built (with pandas) only
    when ``metrics`` / ``samples`` is read, and rows added later are
    appended to it then.
    """

    def __init__(self, metric_functions=None, sample_functions=None):
        self.metric_functions = list(metric_functions or [])
        self.sample_functions = list(sample_functions or [])
        self._metrics_df = None
        self._metric_rows: list[dict] = []
        self._samples_df = None
        self._sample_rows: list[dict] = []

    @property
    def metric_rows(self) -> list[dict]:
        """Every metric row so far, as dicts (no pandas needed unless a
        DataFrame was set or read)."""
        return _frame_rows(self._metrics_df) + list(self._metric_rows)

    @property
    def sample_rows(self) -> list[dict]:
        return _frame_rows(self._samples_df) + list(self._sample_rows)

    @property
    def metrics(self):
        self._metrics_df = _frame(self._metrics_df, self._metric_rows)
        self._metric_rows = []
        return self._metrics_df

    @metrics.setter
    def metrics(self, df):
        self._metrics_df = df
        self._metric_rows = []

    @property
    def samples(self):
        self._samples_df = _frame(self._samples_df, self._sample_rows)
        self._sample_rows = []
        return self._samples_df

    @samples.setter
    def samples(self, df):
        self._samples_df = df
        self._sample_rows = []

    def eval_metric_functions(self, sampler, iteration, **extra):
        rows = []
        for fn in self.metric_functions:
            for row in _as_rows(fn(sampler)):
                rows.append(dict(iteration=iteration, **row, **extra))
        self._metric_rows.extend(rows)
        return rows

    def eval_sample_functions(self, sampler, iteration, **extra):
        rows = []
        for fn in self.sample_functions:
            for row in _as_rows(fn(sampler)):
                rows.append(dict(iteration=iteration, **row, **extra))
        self._sample_rows.extend(rows)
        return rows

    def get_metrics(self):
        return self.metrics

    def get_samples(self):
        return self.samples


class SamplerEvaluator(BaseEvaluator):
    """Online evaluator: wraps sampler steps, timing and recording."""

    def __init__(self, sampler, metric_functions=None, sample_functions=None,
                 init_state=None):
        super().__init__(metric_functions, sample_functions)
        self.sampler = sampler
        self.iteration = 0
        self.elapsed_time = 0.0
        if init_state is not None:
            self.load_state(init_state)
        else:
            self.eval_metric_functions(sampler, self.iteration)
            self.eval_sample_functions(sampler, self.iteration)

    def evaluate_sampler_step(self, func_names: list[str],
                              func_kwargs: list[dict] | None = None,
                              evaluate: bool = True):
        """Call the named sampler methods, time them, record metrics."""
        if isinstance(func_names, str):
            func_names = [func_names]
        if func_kwargs is None:
            func_kwargs = [{} for _ in func_names]
        start = time.perf_counter()
        out = None
        for name, kwargs in zip(func_names, func_kwargs):
            out = getattr(self.sampler, name)(**kwargs)
        sync(getattr(self.sampler, "parameters", None))
        step_time = time.perf_counter() - start
        self.iteration += 1
        self.elapsed_time += step_time
        if evaluate:
            self.eval_metric_functions(self.sampler, self.iteration,
                                       time=self.elapsed_time)
            self._metric_rows.append(dict(
                iteration=self.iteration, metric="runtime", variable="all",
                value=step_time, time=self.elapsed_time))
            self.eval_sample_functions(self.sampler, self.iteration,
                                       time=self.elapsed_time)
        return out

    def save_state(self) -> dict:
        """The evaluator's state: counters, rows (lists of dicts) and the
        sampler's parameters."""
        return dict(
            iteration=self.iteration,
            elapsed_time=self.elapsed_time,
            metric_rows=self.metric_rows,
            sample_rows=self.sample_rows,
            parameters=self.sampler.parameters,
        )

    def load_state(self, state: dict):
        self.iteration = state["iteration"]
        self.elapsed_time = state["elapsed_time"]
        self._metrics_df, self._metric_rows = None, list(
            state["metric_rows"])
        self._samples_df, self._sample_rows = None, list(
            state["sample_rows"])
        self.sampler.parameters = state["parameters"]


class OfflineEvaluator(BaseEvaluator):
    """Evaluate a saved parameter trace out of order: first, last, then
    always the midpoint of the largest unevaluated gap."""

    def __init__(self, sampler, parameters_list: list,
                 parameters_times: Iterable | None = None,
                 metric_functions=None, sample_functions=None,
                 init_state=None):
        super().__init__(metric_functions, sample_functions)
        self.sampler = sampler
        self.parameters_list = list(parameters_list)
        self.parameters_times = (list(parameters_times)
                                 if parameters_times is not None else None)
        self.eval_flag = np.zeros(len(self.parameters_list), dtype=bool)
        if init_state is not None:
            self._metric_rows = list(init_state["metric_rows"])
            self._sample_rows = list(init_state["sample_rows"])
            self.eval_flag = init_state["eval_flag"]

    def num_to_eval(self) -> int:
        return int((~self.eval_flag).sum())

    def _next_eval_index(self) -> int | None:
        """Recursive bisection order."""
        n = len(self.eval_flag)
        if n == 0 or self.eval_flag.all():
            return None
        if not self.eval_flag[0]:
            return 0
        if not self.eval_flag[-1]:
            return n - 1
        done = np.flatnonzero(self.eval_flag)
        gaps = np.diff(done)
        i = int(np.argmax(gaps))
        if gaps[i] <= 1:
            return None
        return int(done[i] + gaps[i] // 2)

    def evaluate(self, num_to_eval: int | None = None, tqdm=None,
                 iter_func_name: str | list[str] | None = None,
                 iter_func_kwargs: dict | list[dict] | None = None):
        """Evaluate trace points in bisection order.

        ``iter_func_name`` / ``iter_func_kwargs`` are a per-iteration
        sampler hook: after loading each trace point's parameters and
        BEFORE the metric functions run, call the named
        sampler method(s) — e.g. ``"project_parameters"``, or a Gibbs
        refinement step.  A string names one method; a list names several,
        with ``iter_func_kwargs`` a matching list of kwarg dicts.
        """
        if iter_func_name is None:
            iter_calls = []
        elif isinstance(iter_func_name, str):
            if iter_func_kwargs is not None and not isinstance(
                    iter_func_kwargs, dict):
                raise TypeError("iter_func_kwargs must be a dict when "
                                "iter_func_name is a string")
            iter_calls = [(iter_func_name, iter_func_kwargs or {})]
        elif isinstance(iter_func_name, list):
            if iter_func_kwargs is None:
                iter_func_kwargs = [{} for _ in iter_func_name]
            if (not isinstance(iter_func_kwargs, list)
                    or len(iter_func_kwargs) != len(iter_func_name)):
                raise ValueError("iter_func_kwargs must be a list of dicts "
                                 "matching iter_func_name")
            iter_calls = list(zip(iter_func_name, iter_func_kwargs))
        else:
            raise TypeError("Invalid iter_func_name")
        for name, _ in iter_calls:
            if not callable(getattr(self.sampler, name, None)):
                raise ValueError(
                    f"iter_func_name '{name}' is not a sampler method")

        count = 0
        it = range(num_to_eval) if num_to_eval else iter(int, 1)
        if tqdm is not None and num_to_eval:
            it = tqdm(it)
        for _ in it:
            idx = self._next_eval_index()
            if idx is None:
                break
            self.sampler.parameters = self.parameters_list[idx]
            for name, kwargs in iter_calls:
                getattr(self.sampler, name)(**kwargs)
            extra = {}
            if self.parameters_times is not None:
                extra["time"] = self.parameters_times[idx]
            self.eval_metric_functions(self.sampler, idx, **extra)
            self.eval_sample_functions(self.sampler, idx, **extra)
            self.eval_flag[idx] = True
            count += 1
        return count

    def save_state(self) -> dict:
        return dict(metric_rows=self.metric_rows,
                    sample_rows=self.sample_rows, eval_flag=self.eval_flag)


def average_parameters_list(parameters_list: list, burnin: int = 0) -> list:
    """Running mean of the trace in flattened-vector space (float64)."""
    if not parameters_list:
        return []
    flat0, unravel = ravel_params(parameters_list[0])
    out = []
    acc = np.zeros_like(flat0)
    count = 0
    for i, p in enumerate(parameters_list):
        if i < burnin:
            out.append(p)
            continue
        acc = acc + ravel_params(p)[0]
        count += 1
        out.append(unravel(acc / count))
    return out


def half_average_parameters_list(parameters_list: list) -> list:
    """Mean of the most recent half of the trace at each index."""
    if not parameters_list:
        return []
    _, unravel = ravel_params(parameters_list[0])
    flats = np.stack([ravel_params(p)[0] for p in parameters_list])
    cumsum = np.concatenate([np.zeros((1, flats.shape[1])),
                             np.cumsum(flats, axis=0)])
    out = []
    for i in range(len(parameters_list)):
        lo = (i + 1) // 2  # average over indices [lo, i]
        mean = (cumsum[i + 1] - cumsum[lo]) / (i + 1 - lo)
        out.append(unravel(mean))
    return out
