"""Tracing / profiling helpers.

Counterpart of ``sgmcmc_tpu/utils/profiling.py``.  ``trace(dir)`` wraps a
region in a ``torch.profiler`` trace (CPU and, where there is one, CUDA
activity) and writes it as a Chrome trace that loads in Perfetto;
``span(name)`` marks a region of the program in that trace; ``sync``
waits for the card's work behind a result by reading one of its elements
on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
from torch.autograd import _profiler_enabled

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks a region named ``name`` in the profiler's
    trace: ``with profiling.span("sgmcmc.iter"): ...``.  Under an active
    ``torch.profiler`` it is ``record_function(name)`` (a user annotation
    on the trace's own clock, beside the kernels it launched); otherwise
    one shared no-op context, so a span costs one check when no profiler
    runs."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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

