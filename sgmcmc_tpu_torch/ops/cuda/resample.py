"""Resampling on the device: CDF, positions and the resample-apply kernel.

Counterpart of ``sgmcmc_tpu/ops/pallas/resample.py`` over chain-batched
``[C, N]`` weights.  ``resample_apply`` launches the hand-written kernel of
``csrc/resample_apply.cu`` for CUDA tensors; it replaces the TPU kernels
``_resample2_kernel`` (K2a), ``_resample2_batched_kernel`` (K2b) and
``_resample_kernel`` (K3), which compute the same function.  For CPU
tensors it runs ``resample_apply_reference``, the plain PyTorch version.

The kernel has two launches of one function: tiles of 1024 positions of a
chain, and for wide rows (the predict surface's elementwise statistics,
K in the thousands) a warp a position and tiles of 1024 columns, which
fill the card; :func:`wide_launch` chooses.

One ancestor rule holds everywhere in the port:
``idx_i = #{j : cdf_j <= pos_i}`` (``searchsorted(side="right")``),
clipped to N-1.

The CDF is accumulated in float64 and rounded to float32 once.  The CUDA
fused-window kernel does the same, so the kernel and the plain version
produce the same float32 CDF whatever order their prefix sums take, and
choose the same ancestors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import check_launch, load_library

# The JAX package's resample_mode names.  Its docstring states that all
# modes select identically; they differ only in how a TPU computes the
# selection, so every one of them runs `resample_apply` here.
RESAMPLE_MODES = ("auto", "gather", "pallas", "pallas2", "xla", "xla2")
# positions and columns per block of the wide launch of
# csrc/resample_apply.cu (kWarps, kWideCols; the tiled launch takes kTile
# = 1024 positions)
_WIDE_ROWS, _WIDE_COLS, _TILE = 8, 1024, 1024
# Where the wide launch takes over, from the crossovers that
# scripts/time_fused_window.py's resample-apply sweep measured on an H100
# (PERF.md, section 6): it wins at every K >= 128, and at K >= 64 while
# the tiled launch has fewer blocks than the card has SMs; below 128 on
# more blocks the tiled launch's shared-memory search wins.
_WIDE_K, _WIDE_K_ANY_C = 64, 128


def check_mode(mode: str) -> None:
    if mode not in RESAMPLE_MODES:
        raise ValueError(f"Unrecognized resample mode '{mode}'")


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


def resample_apply_reference(pos: torch.Tensor, cdf: torch.Tensor,
                             vals: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``out[c, i] = vals[c, idx(c, i)]`` for
    ``vals [C, N, K]``, by ``torch.searchsorted`` and ``torch.gather``."""
    idx = ancestors(pos, cdf)
    return torch.gather(vals, 1, idx[..., None].expand(-1, -1,
                                                       vals.shape[-1]))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with the resample-apply entry points bound."""
    lib = load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sgmcmc_resample_apply.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.sgmcmc_resample_apply.restype = I
    lib.sgmcmc_resample_apply_max_shared_n.argtypes = []
    lib.sgmcmc_resample_apply_max_shared_n.restype = I
    return lib


def max_shared_n() -> int:
    """Largest N whose CDF the kernel keeps in shared memory; beyond it the
    kernel searches the CDF in device memory."""
    return _library().sgmcmc_resample_apply_max_shared_n()


def wide_launch(C: int, n: int, K: int, device) -> bool:
    """Whether a call at (C, n, K) on ``device`` takes the kernel's wide
    launch (a warp a position, 1024 columns a block) rather than the tiled
    one (a block a chain's 1024 positions)."""
    if K < _WIDE_K:
        return False
    if K >= _WIDE_K_ANY_C:
        return True
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return C * -(-n // _TILE) < sms


def _check_inputs(pos, cdf, vals):
    if vals.dim() != 3 or pos.dim() != 2 or cdf.dim() != 2:
        raise ValueError(
            f"expected pos [C, n], cdf [C, N], vals [C, N, K]; got "
            f"{tuple(pos.shape)}, {tuple(cdf.shape)}, {tuple(vals.shape)}")
    C, N, K = vals.shape
    if tuple(cdf.shape) != (C, N) or pos.shape[0] != C:
        raise ValueError(
            f"pos {tuple(pos.shape)} and cdf {tuple(cdf.shape)} do not "
            f"match vals {tuple(vals.shape)}")
    if min(C, N, K, pos.shape[1]) < 1:
        raise ValueError("resample-apply needs C, n, N, K >= 1")
    for name, t in (("pos", pos), ("cdf", cdf), ("vals", vals)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on "
                             f"{vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def resample_apply(pos: torch.Tensor, cdf: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """Resample rows: ``out[c, i, :] = vals[c, idx(c, i), :]`` with
    ``idx(c, i) = min(#{j : cdf[c, j] <= pos[c, i]}, N-1)``.

    ``pos [C, n]``, ``cdf [C, N]`` (non-decreasing), ``vals [C, N, K]``,
    all float32 and contiguous, on one device; returns ``[C, n, K]``.
    CUDA tensors launch the kernel on the current stream (no
    synchronisation) and count one in ``resample_apply.launches``; CPU
    tensors run :func:`resample_apply_reference`.
    """
    _check_inputs(pos, cdf, vals)
    if vals.device.type == "cpu":
        return resample_apply_reference(pos, cdf, vals)
    if vals.device.type != "cuda":
        raise ValueError(f"no resample-apply for device {vals.device}")
    C, _, K = vals.shape
    return _launch(pos, cdf, vals, wide_launch(C, pos.shape[1], K,
                                               vals.device))


resample_apply.launches = 0


def _launch(pos, cdf, vals, wide: bool) -> torch.Tensor:
    """One launch of the kernel on checked CUDA inputs, the wide launch
    when ``wide`` (:func:`resample_apply` chooses; timing scripts compare
    the two)."""
    C, N, K = vals.shape
    n = pos.shape[1]
    if C * -(-n // _WIDE_ROWS) >= 2 ** 31:
        raise ValueError(f"C={C}, n={n} needs more than 2^31 - 1 blocks")
    if wide and -(-K // _WIDE_COLS) > 65535:
        raise ValueError(f"K={K} needs more than 65535 column tiles")
    lib = _library()
    out = torch.empty((C, n, K), dtype=torch.float32, device=vals.device)
    # the library's runtime launches on the thread's current device
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sgmcmc_resample_apply(pos.data_ptr(), cdf.data_ptr(),
                                       vals.data_ptr(), out.data_ptr(),
                                       C, n, N, K, int(wide), stream)
    check_launch(rc, "resample-apply")
    resample_apply.launches += 1
    return out


def resample_rows(u: torch.Tensor, log_weights: torch.Tensor,
                  vals: torch.Tensor, scheme: str,
                  mode: str = "auto") -> torch.Tensor:
    """Resample rows of ``vals [C, N, K]`` by ``log_weights [C, N]`` at the
    positions of ``scheme`` made from the uniforms ``u`` (see
    :func:`resample_positions`): the counterpart of the JAX package's
    ``resample_apply(key, log_weights, vals, scheme, mode)``."""
    check_mode(mode)
    cdf = weights_cdf(log_weights)
    pos = resample_positions(scheme, u, log_weights.shape[-1])
    return resample_apply(pos.contiguous(), cdf, vals.contiguous())
