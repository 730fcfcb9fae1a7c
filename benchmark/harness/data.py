"""Inputs made from ``--seed``: the observed series and each chain's start.

The seed is split by numpy's ``SeedSequence`` into independent streams
for the series, the chains' starts and the sampler's own generator.  The
series' normals and the starts are drawn on the run's device with a
``torch.Generator`` in one call each; the series' recursion (T steps of a
scalar) runs in float64 on the host.  Every seed gives the same sizes:
only values change with it.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seeds(seed: int) -> dict:
    """Independent 63-bit seeds of the run's streams."""
    words = np.random.SeedSequence(int(seed)).generate_state(3, np.uint64)
    return dict(zip(("series", "starts", "sampler"),
                    (int(w >> np.uint64(1)) for w in words)))


def series(ref_model, config: dict, seed: int, device) -> torch.Tensor:
    """The observed series ``[T]`` float32 of the configuration's true
    parameters, from the model's ``SERIES_NORMALS`` normals a time step
    (2 where its reference does not say)."""
    T = int(config["T"])
    gen = torch.Generator(device=device).manual_seed(sub_seeds(seed)["series"])
    k = int(getattr(ref_model, "SERIES_NORMALS", 2))
    z = torch.randn((k, T + 1), generator=gen, dtype=torch.float64,
                    device=device).cpu().numpy()
    ys = ref_model.simulate(config["truth"], z)
    return torch.as_tensor(ys, dtype=torch.float32, device=device)


def starts(ref_model, config: dict, seed: int, C: int, device) -> dict:
    """Each chain's start parameters as the model's leaves ``[C, ...]``
    float32: natural parameters uniform in the configuration's ranges."""
    ranges = config["starts"]
    gen = torch.Generator(device=device).manual_seed(sub_seeds(seed)["starts"])
    u = torch.rand((len(ranges), C), generator=gen, device=device)
    natural = {k: lo + (hi - lo) * u[i]
               for i, (k, (lo, hi)) in enumerate(ranges.items())}
    return ref_model.from_natural(**natural)
