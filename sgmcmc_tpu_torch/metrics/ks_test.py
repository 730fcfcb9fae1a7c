"""KS two-sample tests of parameter traces vs a reference trace.

Counterpart of ``sgmcmc_tpu/metrics/ks_test.py``: each scalar
parameter's SG-MCMC trace (after burn-in) is compared to a Gibbs
reference trace with the two-sample Kolmogorov-Smirnov statistic.
"""
from __future__ import annotations

import numpy as np
from scipy import stats

from ..io.checkpoint import tree_to_numpy


def _flatten_trace(parameters_list, var: str) -> np.ndarray:
    return np.stack([np.ravel(tree_to_numpy(getattr(p, var)))
                     for p in parameters_list])


def ks_test_traces(parameters_list, reference_list, variables: list[str],
                   burnin_frac: float = 1.0 / 3.0) -> list[dict]:
    """Rows of {metric, variable, value(statistic), pvalue} per scalar."""
    rows = []
    b1 = int(len(parameters_list) * burnin_frac)
    b2 = int(len(reference_list) * burnin_frac)
    for var in variables:
        a = _flatten_trace(parameters_list[b1:], var)
        b = _flatten_trace(reference_list[b2:], var)
        for j in range(a.shape[1]):
            stat, pvalue = stats.ks_2samp(a[:, j], b[:, j])
            name = var if a.shape[1] == 1 else f"{var}_{j}"
            rows.append(dict(metric="ks_statistic", variable=name,
                             value=float(stat), pvalue=float(pvalue)))
    return rows
