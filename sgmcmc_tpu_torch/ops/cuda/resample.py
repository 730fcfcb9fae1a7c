"""Host side of resampling: CDF, positions, and the index-based apply.

Counterpart of the plain half of ``sgmcmc_tpu/ops/pallas/resample.py``
(``weights_cdf``, ``resample_positions``, ``resample_apply_gather``), over
chain-batched ``[C, N]`` weights.  The TPU resample-apply kernels of that
file are not ported yet (see ROADMAP.md).

One ancestor rule holds everywhere in the port:
``idx_i = #{j : cdf_j <= pos_i}`` (``searchsorted(side="right")``),
clipped to N-1.

The CDF is accumulated in float64 and rounded to float32 once.  The CUDA
fused-window kernel does the same, so the kernel and the plain version
produce the same float32 CDF whatever order their prefix sums take, and
choose the same ancestors.
"""
from __future__ import annotations

import torch


def cdf_parts(log_weights: torch.Tensor):
    """(cdf [C, N] f32, shift m [C, 1], w [C, N], total [C, 1] f64, ok).

    ``w = exp(log_weights - m)`` with the max shift ``m`` (0 when the max
    is not finite); ``ok`` is False for degenerate weights (total not
    positive or not finite), whose CDF is the uniform ``(j+1)/N``."""
    N = log_weights.shape[-1]
    m = log_weights.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(log_weights - m)
    csum = torch.cumsum(w.double(), -1)
    tot = csum[..., -1:]
    ok = torch.isfinite(tot) & (tot > 0)
    n_t = torch.full((), float(N), dtype=log_weights.dtype,
                     device=log_weights.device)
    uniform = torch.arange(1, N + 1, dtype=log_weights.dtype,
                           device=log_weights.device) / n_t
    cdf = torch.where(ok, (csum / torch.where(ok, tot, 1.0)).to(
        log_weights.dtype), uniform)
    return cdf, m, w, tot, ok


def weights_cdf(log_weights: torch.Tensor) -> torch.Tensor:
    """Inclusive normalized CDF of exp(log_weights) [C, N]; degenerate
    weight vectors fall back to the uniform CDF instead of NaN."""
    return cdf_parts(log_weights)[0]


def resample_positions(scheme: str, u: torch.Tensor, n: int) -> torch.Tensor:
    """Resampling positions [C, n] from the scheme's uniform draws ``u``:
    [C] for ``systematic``, [C, n] for ``multinomial`` / ``stratified``."""
    j = torch.arange(n, dtype=u.dtype, device=u.device)
    n_t = torch.full((), float(n), dtype=u.dtype, device=u.device)
    if scheme == "systematic":
        return (j + u[:, None]) / n_t
    if scheme == "multinomial":
        return u
    if scheme == "stratified":
        return (j + u) / n_t
    raise ValueError(f"Unrecognized resampling scheme '{scheme}'")


def ancestors(pos: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Ancestor indices [C, n]: #{j : cdf_j <= pos_i}, clipped to N-1."""
    idx = torch.searchsorted(cdf, pos.contiguous(), right=True)
    return idx.clamp_(max=cdf.shape[-1] - 1)


def resample_apply_gather(pos: torch.Tensor, cdf: torch.Tensor,
                          vals: torch.Tensor) -> torch.Tensor:
    """Index-based resample-apply: ``out[c, i] = vals[c, idx(c, i)]`` for
    ``vals [C, N, K]``."""
    idx = ancestors(pos, cdf)
    return torch.gather(vals, 1, idx[..., None].expand(-1, -1,
                                                       vals.shape[-1]))
