"""Checkpoint / resume and atomic file IO.

Counterpart of ``sgmcmc_tpu/io/checkpoint.py``: atomic write via
tempfile + rename, race-tolerant mkdir, and pickles of parameter
dataclasses converted to NumPy (so a checkpoint needs neither the card nor
torch's device state to load), and the stacking of parameter traces.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time

import numpy as np
import torch


def make_path(path: str) -> str:
    """Race-tolerant mkdir -p."""
    for _ in range(5):
        try:
            os.makedirs(path, exist_ok=True)
            return path
        except OSError:
            time.sleep(np.random.rand())
    os.makedirs(path, exist_ok=True)
    return path


def atomic_write(path: str, write_fn) -> None:
    """Write through a temporary file in the same directory, then an
    atomic rename."""
    d = os.path.dirname(os.path.abspath(path))
    make_path(d)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _map_leaves(fn, obj):
    """``fn`` over every tensor or array of a parameter dataclass (or
    dict, list, tuple of them); other values pass through."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_leaves(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _map_leaves(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_leaves(fn, v) for v in obj)
    return obj


def tree_to_numpy(tree):
    """Tensors (on any device) -> NumPy arrays on the host."""
    return _map_leaves(lambda x: x.detach().cpu().numpy()
                       if isinstance(x, torch.Tensor) else np.asarray(x),
                       tree)


def tree_to_torch(tree, device=None, dtype=None):
    """NumPy arrays (or tensors) -> tensors on ``device``."""
    return _map_leaves(lambda x: torch.as_tensor(x, device=device,
                                                 dtype=dtype), tree)


def save_pickle(path: str, obj) -> None:
    atomic_write(path, lambda f: pickle.dump(obj, f, protocol=4))


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_checkpoint(path: str, *, parameters, generator_state=None,
                    iteration=0, extra=None) -> None:
    """Fit-state checkpoint: the parameters (as NumPy), the state of the
    fit's ``torch.Generator`` (``generator.get_state()``, a CPU byte
    tensor, kept as NumPy) and the counters."""
    state = dict(
        parameters=tree_to_numpy(parameters),
        generator_state=(None if generator_state is None
                         else tree_to_numpy(generator_state)),
        iteration=int(iteration),
        extra=extra,
    )
    save_pickle(path, state)


def load_checkpoint(path: str):
    return load_pickle(path)


def save_dataframe(path: str, df) -> None:
    """Atomic CSV write of a pandas DataFrame."""
    atomic_write(path, lambda f: f.write(df.to_csv(index=False).encode()))


def stack_trace(parameters_list):
    """A list of parameter dataclasses -> one with a leading trace axis,
    on the host as NumPy (one transfer a field)."""
    first = parameters_list[0]

    def stacked(name):
        xs = [getattr(p, name) for p in parameters_list]
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(xs).cpu().numpy()
        return np.stack([np.asarray(x) for x in xs])
    return dataclasses.replace(first, **{
        f.name: stacked(f.name) for f in dataclasses.fields(first)})


def unstack_trace(stacked) -> list:
    """Inverse of :func:`stack_trace`: parameters with a leading trace
    axis -> list of parameters."""
    fields = dataclasses.fields(stacked)
    n = getattr(stacked, fields[0].name).shape[0]
    return [dataclasses.replace(stacked, **{
        f.name: getattr(stacked, f.name)[i] for f in fields})
        for i in range(n)]


def save_trace(path: str, parameters_list, times=None, extra=None) -> None:
    """Persist a parameter trace (a list of parameter dataclasses) and its
    wall times; ``extra`` adds top-level entries."""
    out = dict(parameters_list=unstack_trace(stack_trace(parameters_list)),
               times=None if times is None else list(times))
    if extra:
        out.update(extra)
    save_pickle(path, out)


def load_trace(path: str):
    return load_pickle(path)
