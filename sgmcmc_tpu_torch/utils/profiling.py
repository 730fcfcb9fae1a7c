"""Tracing / profiling helpers.

Counterpart of ``sgmcmc_tpu/utils/profiling.py``.  ``trace(dir)`` wraps a
region in a ``torch.profiler`` trace (CPU and, where there is one, CUDA
activity) and writes it as a Chrome trace that loads in Perfetto;
``sync`` waits for the card's work behind a result by reading one of its
elements on the host; ``Timer`` is a named wall-clock split timer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile a region: ``with profiling.trace(dir) as prof: ...``;
    writes ``dir/name`` (a Chrome trace) when the region ends and yields
    the ``torch.profiler.profile`` object (``prof.key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, name))


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> float | None:
    """Wait for the computation behind ``x`` (a tensor, or a dataclass /
    dict / sequence holding one) by reading its first element on the
    host; returns that element as a float (None if ``x`` holds no
    tensor)."""
    t = _first_tensor(x)
    return None if t is None else float(t.reshape(-1)[0])


class Timer:
    """Named wall-clock split timer.

    >>> t = Timer()
    >>> with t.section("sampler"):
    ...     out = step(...)
    ...     sync(out)
    >>> t.totals  # {"sampler": seconds}
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def rows(self):
        """Tidy metric rows (metric, variable, value, count)."""
        return [dict(metric="runtime", variable=k,
                     value=self.totals[k], count=self.counts[k])
                for k in sorted(self.totals)]
