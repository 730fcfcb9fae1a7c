"""The unfused Poyiadjis O(N) smoother's window step: CUDA kernel and plain
version.

``ops/buffered.py`` keeps the smoother's carry as one ``[C, N, D + H]``
buffer (each particle's state, then its running statistic) and resamples
it with the resample-apply kernel (``ops/cuda/resample.py``).
``smoother_step`` does the rest of the window step on the resampled rows
in one launch of ``csrc/smoother_step.cuh``: the proposal, the
reweighting and the statistic ``s' = s + w_t in_t h`` of the model's
fused-window body (``csrc/<model>_body.cuh``), the next step's CDF by the
fused window's rule, and the running log-likelihood's increment
``w_t in_t (logsumexp(log w) - log N)``.  For CPU tensors it runs
``smoother_step_reference``, the same function in plain PyTorch.

The kernel library is built at first use by ``ops/cuda/build.py`` and
bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import check_launch, load_library
from .resample import cdf_parts

# Fused-window bodies whose unfused particle kernel and statistic run the
# same operations in the same order, so that the kernel reproduces the
# PyTorch step bit for bit.  The LGSSM's and the SVJM's unfused kernels
# compute in another order (a product reassociated, Q where the body has
# 1 / LQinv^2) and keep the PyTorch step.
STEP_BODIES = ("svm", "garch_optimal", "garch_prior")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with the smoother-step entry points bound."""
    lib = load_library()
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for body in STEP_BODIES:
        fn = getattr(lib, f"sgmcmc_smoother_step_{body}")
        fn.argtypes = [P, P, P, L, L, L, P, L, P, L, P, L, ctypes.c_float,
                       P, P, P, P, I, I, P]
        fn.restype = I
    return lib


def _check_inputs(model, pvec, vr, z, y, weight, in_window, out, log_w, cdf,
                  loglik):
    C, N, K = vr.shape
    want = {"pvec": (C, model.n_param), "vr": (C, N, K),
            "z": (C, model.noise_dims, N), "y": (C,), "weight": (C,),
            "in_window": (C,), "out": (C, N, K), "log_weights": (C, N),
            "cdf": (C, N), "loglik": (C,)}
    got = {"pvec": pvec, "vr": vr, "z": z, "y": y, "weight": weight,
           "in_window": in_window, "out": out, "log_weights": log_w,
           "cdf": cdf, "loglik": loglik}
    if K != model.n_state + model.n_stat:
        raise ValueError(f"rows of {K} floats; the body carries "
                         f"{model.n_state} states and {model.n_stat} "
                         f"statistics")
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != vr.device:
            raise ValueError(f"{name} is on {t.device}, vr on {vr.device}")
    for name in ("pvec", "vr", "out", "log_weights", "cdf", "loglik"):
        if not got[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def smoother_step(model, pvec: torch.Tensor, vr: torch.Tensor,
                  z: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                  in_window: torch.Tensor, out: torch.Tensor,
                  log_weights: torch.Tensor, cdf: torch.Tensor,
                  loglik: torch.Tensor) -> None:
    """One window step of the Poyiadjis O(N) smoother on the resampled
    rows ``vr [C, N, D + H]`` of ``model`` (a ``FusedModel`` whose body is
    in ``STEP_BODIES``), in place: the new rows into ``out [C, N, D + H]``,
    the new log-weights into ``log_weights [C, N]``, their CDF (the
    resampling CDF of the next step) into ``cdf [C, N]``, and the step's
    increment added to ``loglik [C]``.

    ``pvec [C, P]`` is ``model.pack_params(params)``; the step's normals
    ``z [C, Z, N]``, observation ``y [C]``, weight and in-window flag
    ``[C]`` may be views of any strides.  ``out`` may be the buffer that
    ``vr`` was drawn from.  CUDA tensors launch the kernel on the current
    stream (no synchronisation) and count one in
    ``smoother_step.launches``; CPU tensors run
    :func:`smoother_step_reference`."""
    _check_inputs(model, pvec, vr, z, y, weight, in_window, out,
                  log_weights, cdf, loglik)
    if vr.device.type == "cpu":
        smoother_step_reference(model, pvec, vr, z, y, weight, in_window,
                                out, log_weights, cdf, loglik)
        return
    if vr.device.type != "cuda":
        raise ValueError(f"no smoother step for device {vr.device}")
    if model.body not in STEP_BODIES:
        raise ValueError(f"no smoother step for the body '{model.body}'")
    C, N, _ = vr.shape
    entry = getattr(_library(), f"sgmcmc_smoother_step_{model.body}")
    # the library's runtime launches on the thread's current device
    with torch.cuda.device(vr.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(vr.data_ptr(), pvec.data_ptr(), z.data_ptr(),
                   *z.stride(), y.data_ptr(), y.stride(0),
                   weight.data_ptr(), weight.stride(0),
                   in_window.data_ptr(), in_window.stride(0), math.log(N),
                   out.data_ptr(), log_weights.data_ptr(), cdf.data_ptr(),
                   loglik.data_ptr(), C, N, stream)
    check_launch(rc, "smoother step")
    smoother_step.launches += 1


smoother_step.launches = 0


def smoother_step_reference(model, pvec, vr, z, y, weight, in_window, out,
                            log_weights, cdf, loglik) -> None:
    """Plain-PyTorch version of the kernel (same inputs and outputs as
    :func:`smoother_step`): the body's PyTorch twin over ``[C, N]``
    columns, the CDF of :func:`~.resample.cdf_parts` and the increment
    ``log(tot) + m - log N`` of its float64 total ``tot`` and shift
    ``m``."""
    D, N = model.n_state, vr.shape[1]
    pv = [pvec[:, i:i + 1] for i in range(model.n_param)]
    x = list(vr[..., :D].unbind(-1))
    y_t = y[:, None]
    x_new = model.propose(pv, list(z.unbind(1)), x, y_t)
    log_w = model.reweight(pv, x, x_new, y_t)
    h = torch.stack(model.stat(pv, x, x_new, y_t), -1)         # [C, N, H]
    scale = weight * in_window
    stats = vr[..., D:] + scale[:, None, None] * h
    out[..., :D] = torch.stack(x_new, -1)
    out[..., D:] = stats
    new_cdf, m, _, tot, _ = cdf_parts(log_w)
    log_weights.copy_(log_w)
    cdf.copy_(new_cdf)
    inc = torch.log(tot[:, 0].to(log_w.dtype)) + m[:, 0] - math.log(N)
    loglik.copy_(loglik + scale * inc)
