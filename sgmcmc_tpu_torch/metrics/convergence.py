"""MCMC convergence diagnostics: split-R-hat, ESS, IACT.

Counterpart of ``sgmcmc_tpu/metrics/convergence.py`` (the port keeps its
own copy; the estimators are the standard ones, Gelman et al., BDA3
§11.4-11.5, and Vehtari et al. 2021's split-chain, rank-normalized and
folded forms):

  * `split_rhat`  — potential scale reduction over split chains,
  * `rhat_rank`   — max of rank-normalized split-R-hat and folded
    rank-normalized split-R-hat (Vehtari et al. 2021 eqs. 13-14),
  * `ess` / `iact` — effective sample size via per-chain FFT
    autocovariances combined across chains, Geyer initial-monotone-
    positive-sequence truncation,
  * `ess_bulk` / `ess_tail` — rank-normalized ESS (bulk) and the min of
    the 5%/95% quantile-indicator ESS (tail),
  * `convergence_summary` — tidy per-coordinate rows for a stacked
    multi-chain parameter trace (the `fit_scan(num_chains=C)` output).

All estimators are host-side NumPy post-processing of already-
transferred traces — they never touch the device.
"""
from __future__ import annotations

import numpy as np

from ..io.checkpoint import tree_to_numpy


def _as_chains(x, num_splits: int = 2) -> np.ndarray:
    """[N] or [C, N] -> split-chain matrix [C * num_splits, N // num_splits].

    Splitting each chain into ``num_splits`` segments makes R-hat detect
    non-stationarity (a trending single chain splits into segments with
    different means), per the split-R-hat recommendation.
    """
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"expected [N] or [C, N] trace, got {x.shape}")
    C, N = x.shape
    n = N // num_splits
    while n < 2 and num_splits > 1:    # degrade gracefully on tiny runs
        num_splits -= 1
        n = N // num_splits
    if n < 2:
        raise ValueError(f"chains too short to split: N={N}")
    return x[:, : n * num_splits].reshape(C * num_splits, n)


def split_rhat(x, num_splits: int = 2) -> float:
    """Split-chain potential scale reduction factor (BDA3 eq. 11.4).

    ~1.0 at convergence; > ~1.1 signals unmixed / non-stationary chains
    (the usual threshold).
    """
    c = _as_chains(x, num_splits)
    M, n = c.shape
    means = c.mean(axis=1)
    W = float(np.mean(np.var(c, axis=1, ddof=1)))
    if W == 0.0:
        return 1.0 if np.var(means) == 0.0 else np.inf
    B_over_n = float(np.var(means, ddof=1))
    var_plus = (n - 1) / n * W + B_over_n
    return float(np.sqrt(var_plus / W))


def rank_normalize(x) -> np.ndarray:
    """Pooled fractional ranks -> normal scores (Vehtari et al. 2021 eq. 14).

    ``x``: [N] or [C, N].  Ranks are computed over ALL chains pooled
    (average ranks on ties), mapped through the Blom offset
    z = Phi^-1((r - 3/8) / (S + 1/4)).  Shape-preserving.
    """
    from scipy.special import ndtri
    from scipy.stats import rankdata

    x = np.asarray(x, np.float64)
    r = rankdata(x.ravel(), method="average").reshape(x.shape)
    return ndtri((r - 0.375) / (x.size + 0.25))


def _fold(x) -> np.ndarray:
    """|x - median| — folding exposes chains that agree in location but
    differ in spread (Vehtari et al. 2021 §4.2)."""
    x = np.asarray(x, np.float64)
    return np.abs(x - np.median(x))


def rhat_rank(x, num_splits: int = 2) -> float:
    """Rank-normalized + folded split-R-hat (Vehtari et al. 2021) — the
    max of split-R-hat on the rank-normal scores of x and of |x - med|.

    Robust to heavy tails / infinite variance (where plain split-R-hat is
    noise) and sensitive to variance non-stationarity (which plain
    split-R-hat cannot see at matched means).
    """
    return max(split_rhat(rank_normalize(x), num_splits),
               split_rhat(rank_normalize(_fold(x)), num_splits))


def ess_bulk(x, num_splits: int = 2) -> float:
    """Rank-normalized bulk ESS (Stan's `ess_bulk`)."""
    return ess(rank_normalize(x), num_splits)


def ess_tail(x, num_splits: int = 2) -> float:
    """Tail ESS: min ESS of the 5% / 95% quantile indicator chains
    (rank-normalized), per Vehtari et al. 2021 §4.3."""
    x = np.asarray(x, np.float64)
    lo, hi = np.quantile(x.ravel(), [0.05, 0.95])
    return min(ess(rank_normalize(x <= lo), num_splits),
               ess(rank_normalize(x <= hi), num_splits))


def _autocov_fft(c: np.ndarray) -> np.ndarray:
    """Per-chain biased autocovariances [M, n] via FFT (O(n log n))."""
    M, n = c.shape
    d = c - c.mean(axis=1, keepdims=True)
    size = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(d, size, axis=1)
    acov = np.fft.irfft(f * np.conj(f), size, axis=1)[:, :n].real
    return acov / n


def ess(x, num_splits: int = 2) -> float:
    """Multi-chain effective sample size (BDA3 §11.5 / Stan's `ess_bulk`
    estimator without rank-normalization).

    Combines per-chain FFT autocovariances with the between-chain
    variance, then truncates the autocorrelation sum at Geyer's initial
    monotone positive sequence.  Returns a value in (0, C*N].
    """
    c = _as_chains(x, num_splits)
    M, n = c.shape
    total = M * n
    acov = _autocov_fft(c)                    # biased: acov[:, 0] ~ var
    chain_var = acov[:, 0] * n / (n - 1)
    W = float(np.mean(chain_var))
    mean_acov = acov.mean(axis=0)
    if M > 1:
        var_plus = (n - 1) / n * W + float(np.var(c.mean(axis=1), ddof=1))
    else:
        var_plus = (n - 1) / n * W
    if var_plus <= 0.0:
        return float(total)
    rho = 1.0 - (W - mean_acov) / var_plus    # rho[0] == 1 up to fp error

    # Geyer pairwise sums P_k = rho_{2k} + rho_{2k+1}: truncate at the
    # first negative pair, then enforce monotone non-increase
    # (vectorised: the running minimum and the sequential cumulative sum
    # give the loop's numbers bit for bit)
    max_pairs = (n - 1) // 2
    pairs = rho[0:2 * max_pairs:2] + rho[1:2 * max_pairs:2]
    negative = np.flatnonzero(pairs < 0.0)
    pairs = pairs[:negative[0] if negative.size else max_pairs]
    pairs = np.minimum.accumulate(pairs)
    tau = float(np.cumsum(np.concatenate([[-1.0], 2.0 * pairs]))[-1])
    tau = max(tau, 1.0 / np.log10(total + 10.0))   # Stan's positivity guard
    return float(min(total, total / tau))


def iact(x, num_splits: int = 2) -> float:
    """Integrated autocorrelation time tau = (C*N) / ESS (>= 1)."""
    c = _as_chains(x, num_splits)
    return float(c.size / ess(x, num_splits))


def mean_se(x, num_splits: int = 2) -> tuple[float, float]:
    """(pooled mean, MC standard error of the mean = sd / sqrt(ESS))."""
    flat = np.asarray(x, np.float64).ravel()
    return float(flat.mean()), float(flat.std(ddof=1) /
                                     np.sqrt(max(ess(x, num_splits), 1.0)))


def _named_leaves(params):
    """(name, leaf) of a parameter dataclass's fields (or a dict's
    items), in field order."""
    import dataclasses
    if dataclasses.is_dataclass(params):
        return [(f.name, getattr(params, f.name))
                for f in dataclasses.fields(params)]
    return list(params.items())


def _named_coords(params) -> dict[str, np.ndarray]:
    """Parameters with leaves [C, N, ...] -> flat named scalar coordinate
    traces {'A[0,0]': [C, N], ...}."""
    out = {}
    for name, leaf in _named_leaves(params):
        arr = tree_to_numpy(leaf)
        if arr.ndim < 2:
            raise ValueError(
                f"leaf {name} has shape {arr.shape}; expected leading "
                f"[num_chains, num_iters] axes (fit_scan(num_chains=C))")
        C, N = arr.shape[:2]
        flat = arr.reshape(C, N, -1)
        for j in range(flat.shape[2]):
            idx = np.unravel_index(j, arr.shape[2:]) if arr.ndim > 2 else ()
            suffix = ("[" + ",".join(map(str, idx)) + "]") if idx else ""
            out[f"{name}{suffix}"] = flat[:, :, j]
    return out


def convergence_summary(trace, burn_frac: float = 0.5,
                        num_splits: int = 2) -> list[dict]:
    """Per-coordinate diagnostic rows for a stacked multi-chain trace.

    ``trace``: parameters with leaves [C, N, ...] (the
    `fit_scan(num_chains=C)` output, on any device), or a dict of named
    [C, N] (or [N]) scalar traces.  Discards the first ``burn_frac`` of
    each chain, then emits one row per scalar coordinate:
    {variable, rhat, ess, iact, mean, sd, se_mean, num_chains, num_iters}.
    """
    if isinstance(trace, dict):
        coords = {k: np.atleast_2d(np.asarray(v, np.float64))
                  for k, v in trace.items()}
    else:
        coords = _named_coords(trace)
    rows = []
    for name, x in coords.items():
        C, N = x.shape
        burn = int(N * burn_frac)
        xb = x[:, burn:]
        e = ess(xb, num_splits)
        m, se = mean_se(xb, num_splits)
        # rank-normalize once and reuse (rank_normalize is an O(S log S)
        # sort per call; rhat_rank + ess_bulk would otherwise redo it)
        zb = rank_normalize(xb)
        zf = rank_normalize(_fold(xb))
        rows.append(dict(
            variable=name, rhat=split_rhat(xb, num_splits),
            rhat_rank=max(split_rhat(zb, num_splits),
                          split_rhat(zf, num_splits)),
            ess=e, ess_bulk=ess(zb, num_splits),
            ess_tail=ess_tail(xb, num_splits),
            iact=float(xb.size / e), mean=m, sd=float(xb.std(ddof=1)),
            se_mean=se, num_chains=C, num_iters=N - burn))
    return rows
