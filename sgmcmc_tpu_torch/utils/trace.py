"""Parameter traces (the port's copy of ``unstack_trace`` from
``sgmcmc_tpu/io/checkpoint.py``, which the sampler's chunked fits need)."""
from __future__ import annotations

import dataclasses


def unstack_trace(stacked) -> list:
    """Parameters with a leading trace axis -> list of parameters."""
    n = getattr(stacked, dataclasses.fields(stacked)[0].name).shape[0]
    return [dataclasses.replace(stacked, **{
        f.name: getattr(stacked, f.name)[i]
        for f in dataclasses.fields(stacked)}) for i in range(n)]
