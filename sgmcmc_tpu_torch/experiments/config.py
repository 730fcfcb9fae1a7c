"""Experiment configuration: option dicts, grids, and defaults.

Counterpart of ``sgmcmc_tpu/experiments/config.py``, the port's own copy
(the port imports nothing of the JAX package): per-experiment option
dicts over `DEFAULT_OPTIONS`, grid expansion (`parameter_grid`,
`dict_product`) and the sampler keywords of an option dict.
"""
from __future__ import annotations

import itertools
from typing import Any, Iterable

# `DEFAULT_OPTIONS` (`svm/driver.py:52-63`)
DEFAULT_OPTIONS: dict[str, Any] = dict(
    max_num_iters=1000000,
    max_time=60,
    eval_freq=5,
    checkpoint_num_iters=1000,
    checkpoint_time=60 * 30,
    steps_per_iteration=1,
    epsilon=0.1,
    subsequence_length=-1,
    buffer_length=0,
    minibatch_size=1,
    iter_type="SGLD",
    kind=None,
    pf="poyiadjis_N",
    N=1000,
    kernel=None,
    resample_mode="auto",
    partition_style="uniform",
    seed=0,
)


def parameter_grid(grid: dict[str, list] | list[dict[str, list]]
                   ) -> list[dict]:
    """Expand {key: [values]} (or a list of such dicts) into the cross
    product of option dicts — `sklearn.model_selection.ParameterGrid`
    semantics (`svm/demo_setup.py:76-141`)."""
    if isinstance(grid, dict):
        grid = [grid]
    out = []
    for g in grid:
        keys = sorted(g)
        for combo in itertools.product(*[g[k] for k in keys]):
            out.append(dict(zip(keys, combo)))
    return out


def dict_product(*dict_lists: Iterable[dict]) -> list[dict]:
    """Cross product of lists of dicts, merged left-to-right
    (`svm/driver.py` do_setup)."""
    out = [{}]
    for dicts in dict_lists:
        out = [dict(a, **b) for a in out for b in dicts]
    return out


def with_defaults(options: dict, defaults: dict | None = None) -> dict:
    merged = dict(DEFAULT_OPTIONS if defaults is None else defaults)
    merged.update(options)
    return merged


def sampler_kwargs(options: dict) -> dict:
    """Extract the per-step sampler kwargs from an option dict."""
    kw = dict(
        subsequence_length=options.get("subsequence_length", -1),
        buffer_length=options.get("buffer_length", 0),
        minibatch_size=options.get("minibatch_size", 1),
        N=options.get("N", 1000),
        pf=options.get("pf", "poyiadjis_N"),
        kernel=options.get("kernel"),
        resample_mode=options.get("resample_mode", "auto"),
        partition_style=options.get("partition_style", "uniform"),
    )
    if options.get("kind") is not None:
        kw["kind"] = options["kind"]
    if options.get("lambduh") is not None:
        kw["lambduh"] = options["lambduh"]
    if options.get("Ntilde") is not None:
        kw["Ntilde"] = options["Ntilde"]
    if options.get("bw_chunk") is not None:
        kw["bw_chunk"] = options["bw_chunk"]
    if options.get("rng") is not None:
        # 'kernel': the fused window draws its normals in-kernel
        kw["rng"] = options["rng"]
    for k in ("latent_draws", "latent_burnin", "latent_thinning"):
        # SLDS complete-data latent-Gibbs controls (`slds/sampler.py`)
        if options.get(k) is not None:
            kw[k] = options[k]
    return kw
