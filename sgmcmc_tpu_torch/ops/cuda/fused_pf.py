"""Fused buffered particle-smoother window: CUDA kernel and plain version.

Counterpart of ``sgmcmc_tpu/ops/pallas/fused_pf.py``.  The whole W-step
window (weight normalisation and CDF, systematic resampling of state and
statistics, proposal, reweighting, additive-statistic update and the
log-likelihood) runs in one launch of the kernel in
``csrc/fused_window.cuh`` (one ``csrc/fused_window_<body>.cu`` per model
body), which replaces the TPU kernel ``_fused_window_kernel``.
``fused_window`` launches it for CUDA tensors and runs
``fused_window_reference``, the same function in plain PyTorch, for CPU
tensors.

Three options of the TPU kernel come with it: proposal normals generated
inside the kernel from a per-chain seed (the JAX package's
``rng="kernel"``; here the Philox generator of ``ops/cuda/philox.py``)
instead of a ``[C, W, Z, N]`` array; the ESS gate (``ess_threshold``),
under which a chain resamples only at steps whose effective sample size
falls below ``ess_threshold * N``; and the valid gate (``vs``, the JAX
package's ``valid_gate``), under which a chain keeps its carries and
log-weights through the steps it marks invalid (the padded tails of the
multi-sequence windows).

The kernel library is built at first use by ``ops/cuda/build.py`` and
bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import torch

from .build import SMEM_LIMIT, check_launch, load_library
from .philox import philox_normals_reference
from .resample import ancestors, cdf_parts

# model bodies with an entry point in the library (FusedModel.body)
_BODIES = ("svm", "lgssm_optimal", "lgssm_prior", "garch_optimal",
           "garch_prior", "svjm")


@dataclasses.dataclass(frozen=True)
class FusedModel:
    """Model bundle of the fused window.

    ``propose``, ``reweight`` and ``stat`` are the plain PyTorch body:
    elementwise functions over lists of ``[C, N]`` tensors (one per state
    dimension / normal / statistic) with parameters as a list of ``[C, 1]``
    columns of ``pack_params(params) -> [C, P]``.  ``body`` names the CUDA
    twin of the same body (``csrc/<model>_body.cuh``), whose entry point is
    ``sgmcmc_fused_window_<body>``.  ``init(z, prior_mean, prior_var)``
    makes the initial state, a list of D ``[C, N]`` tensors, from the Z
    initial normals and the ``[C, 1]`` prior moments; without it every
    state dimension is Gaussian from the first D normals.  ``n_noise`` = Z
    (normals per particle and step) defaults to D.
    """
    n_state: int
    n_stat: int
    n_param: int
    pack_params: Callable
    propose: Callable
    reweight: Callable
    stat: Callable
    body: str
    n_noise: int | None = None
    init: Callable | None = None

    @property
    def noise_dims(self) -> int:
        return self.n_state if self.n_noise is None else self.n_noise


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library with the fused-window entry points bound."""
    lib = load_library()
    P, I = ctypes.c_void_p, ctypes.c_int
    for body in _BODIES:
        fn = getattr(lib, f"sgmcmc_fused_window_{body}")
        fn.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, ctypes.c_float,
                       ctypes.c_double, P]
        fn.restype = I
        smem = getattr(lib, f"sgmcmc_fused_window_{body}_smem")
        smem.argtypes = [I, I, I]
        smem.restype = ctypes.c_size_t
    return lib


def _check_inputs(model, pvec, x0, normals, seeds, ys, weights, xi, vs):
    C, W = ys.shape
    D, Z, P = model.n_state, model.noise_dims, model.n_param
    N = x0.shape[-1]
    if (normals is None) == (seeds is None):
        raise ValueError("pass exactly one of normals (host normals) and "
                         "seeds (in-kernel normals)")
    want = {"pvec": (C, P), "x0": (C, D, N), "normals": (C, W, Z, N),
            "seeds": (C,), "ys": (C, W), "weights": (C, W), "xi": (C, W),
            "vs": (C, W)}
    got = {"pvec": pvec, "x0": x0, "normals": normals, "seeds": seeds,
           "ys": ys, "weights": weights, "xi": xi, "vs": vs}
    for name, t in got.items():
        if t is None:
            continue
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        dtype = torch.int64 if name == "seeds" else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x0.device:
            raise ValueError(f"{name} is on {t.device}, x0 on {x0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N < 1 or W < 1:
        raise ValueError("the window needs N >= 1 particles and W >= 1 "
                         "steps")


def fused_window(model: FusedModel, pvec: torch.Tensor, x0: torch.Tensor,
                 normals: torch.Tensor | None, ys: torch.Tensor,
                 weights: torch.Tensor, xi: torch.Tensor,
                 lambduh: float = 1.0, ess_threshold: float | None = None,
                 seeds: torch.Tensor | None = None,
                 vs: torch.Tensor | None = None) -> torch.Tensor:
    """Run the fused window for a batch of chains: ``[C, H+1]``, the
    weight-averaged statistic then the log-likelihood.

    Inputs: ``pvec [C, P]``, ``x0 [C, D, N]``, the proposal normals
    ``normals [C, W, Z, N]`` (particle j in natural order) or, for normals
    generated inside the kernel, ``seeds [C]`` int64 with ``normals=None``
    (the draws of :func:`~.philox.philox_normals` of stream 0), ``ys``,
    ``weights`` and the systematic offsets ``xi``, each ``[C, W]``; all
    float32 except the seeds, and contiguous.  ``ess_threshold`` turns on
    the ESS gate, ``vs [C, W]`` the valid gate (step t of chain c runs
    only where ``vs[c, t] > 0``).  CUDA tensors launch the kernel on the
    current stream (no synchronisation) and count one in
    ``fused_window.launches``; CPU tensors run
    :func:`fused_window_reference`.
    """
    _check_inputs(model, pvec, x0, normals, seeds, ys, weights, xi, vs)
    if ess_threshold is not None and ess_threshold < 0:
        raise ValueError(f"ess_threshold={ess_threshold} must be >= 0")
    if x0.device.type == "cpu":
        return fused_window_reference(model, pvec, x0, normals, ys, weights,
                                      xi, lambduh, ess_threshold, seeds, vs)
    if x0.device.type != "cuda":
        raise ValueError(f"no fused window for device {x0.device}")
    C, W = ys.shape
    N = x0.shape[-1]
    lib = _library()
    smem = getattr(lib, f"sgmcmc_fused_window_{model.body}_smem")(
        W, N, int(vs is not None))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"N={N}, W={W} needs {smem} bytes of shared memory per block; "
            f"the card gives at most {SMEM_LIMIT}")
    entry = getattr(lib, f"sgmcmc_fused_window_{model.body}")
    out = torch.empty((C, model.n_stat + 1), dtype=torch.float32,
                      device=x0.device)
    thr = -1.0 if ess_threshold is None else float(ess_threshold)
    # the library's runtime launches on the thread's current device
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(pvec.data_ptr(), x0.data_ptr(),
                   None if normals is None else normals.data_ptr(),
                   None if seeds is None else seeds.data_ptr(),
                   ys.data_ptr(), weights.data_ptr(), xi.data_ptr(),
                   None if vs is None else vs.data_ptr(),
                   out.data_ptr(), C, W, N, float(lambduh), thr, stream)
    check_launch(rc, "fused window")
    fused_window.launches += 1
    return out


fused_window.launches = 0


def _weighted_mean(S, w, tot, ok, n_t):
    """sum_j S[c, h, j] * p[c, j] with p = w / tot (uniform when
    degenerate), accumulated in float64 as the kernel does."""
    probs = torch.where(ok, w / tot.to(w.dtype), 1.0 / n_t)
    return (S * probs[:, None, :]).double().sum(-1).to(w.dtype)


def _ll_increment(m, tot, ok, log_n):
    inc = m[:, 0] + torch.log(tot[:, 0].to(m.dtype)) - log_n
    return torch.where(ok[:, 0], inc, torch.full_like(inc, -float("inf")))


def fused_window_reference(model: FusedModel, pvec, x0, normals, ys,
                           weights, xi, lambduh: float = 1.0,
                           ess_threshold: float | None = None, seeds=None,
                           vs=None):
    """Plain-PyTorch version of the fused window kernel (same inputs and
    output as :func:`fused_window`), step by step in the kernel's order:
    float64 prefix sum (``torch.cumsum``), ancestors by
    ``torch.searchsorted(right=True)``, gathers by ``torch.gather``.  With
    ``seeds`` each step's normals come from
    :func:`~.philox.philox_normals_reference` (stream 0, the kernel's
    layout).  The ESS gate follows the JAX package's fused kernel: the sums
    of w and w^2 in float64, and the carried log-weights
    ``log w - m - log tot + log N`` of a chain that does not resample.
    The valid gate follows it too: on a step with ``vs <= 0`` the chain's
    carries and log-weights stay as they were, while the deferred
    log-likelihood increment of the step before is still added."""
    C, D, N = x0.shape
    W = ys.shape[1]
    H, Z = model.n_stat, model.noise_dims
    dt, dev = x0.dtype, x0.device
    pv = [pvec[:, i:i + 1] for i in range(model.n_param)]
    V = torch.cat([x0, torch.zeros((C, H, N), dtype=dt, device=dev)], 1)
    logw = torch.zeros((C, N), dtype=dt, device=dev)
    ll = torch.zeros((C,), dtype=dt, device=dev)
    n_t = torch.full((), float(N), dtype=dt, device=dev)
    log_n = torch.log(n_t)
    j = torch.arange(N, dtype=dt, device=dev)
    own = torch.arange(N, device=dev)
    lam = torch.full((), lambduh, dtype=dt, device=dev)
    om = 1.0 - lam
    for t in range(W):
        cdf, m, w, tot, ok = cdf_parts(logw)
        if t > 0:
            ll = ll + weights[:, t - 1] * _ll_increment(m, tot, ok, log_n)
        if lambduh != 1.0:
            S_bar = _weighted_mean(V[:, D:], w, tot, ok, n_t)     # [C, H]
        idx = ancestors((j + xi[:, t:t + 1]) / n_t, cdf)         # [C, N]
        if ess_threshold is not None:
            sumsq = (w.double() ** 2).sum(-1, keepdim=True)
            ess = tot * tot / torch.where(sumsq > 0, sumsq, 1.0)
            do_res = ~ok | (ess < ess_threshold * N)              # [C, 1]
            idx = torch.where(do_res, idx, own)
            carried = logw - m - torch.log(tot.to(dt)) + log_n
        Vr = torch.gather(V, 2, idx[:, None, :].expand(-1, D + H, -1))
        xr = list(Vr[:, :D].unbind(1))
        z_t = (normals[:, t] if seeds is None else philox_normals_reference(
            seeds, 1, Z, N, t0=t)[:, 0])                         # [C, Z, N]
        z = list(z_t.unbind(1))
        y_t = ys[:, t:t + 1]
        x_new = model.propose(pv, z, xr, y_t)
        logw_new = model.reweight(pv, xr, x_new, y_t)
        if ess_threshold is not None:
            logw_new = logw_new + torch.where(do_res, 0.0, carried)
        h = torch.stack(model.stat(pv, xr, x_new, y_t), 1)      # [C, H, N]
        w_t = weights[:, t, None, None]
        if lambduh == 1.0:
            s_new = Vr[:, D:] + w_t * h
        else:
            s_new = lam * Vr[:, D:] + om * S_bar[..., None] + w_t * h
        V_new = torch.cat([torch.stack(x_new, 1), s_new], 1)
        if vs is None:
            V, logw = V_new, logw_new
        else:
            act = vs[:, t:t + 1] > 0                              # [C, 1]
            V = torch.where(act[..., None], V_new, V)
            logw = torch.where(act, logw_new, logw)
    _, m, w, tot, ok = cdf_parts(logw)
    ll = ll + weights[:, W - 1] * _ll_increment(m, tot, ok, log_n)
    stat = _weighted_mean(V[:, D:], w, tot, ok, n_t)
    return torch.cat([stat, ll[:, None]], 1)


def initial_state(model: FusedModel, z0: torch.Tensor,
                  prior_mean: torch.Tensor,
                  prior_var: torch.Tensor) -> torch.Tensor:
    """Initial state ``x0 [C, D, N]`` from the normals ``z0 [C, Z, N]`` and
    the per-chain prior moments ``[C]``: ``model.init`` where the model has
    one, else ``prior_mean + sqrt(prior_var) * z0[:, :D]``."""
    if model.init is None:
        return (prior_mean[:, None, None]
                + torch.sqrt(prior_var)[:, None, None] * z0[:, :model.n_state])
    return torch.stack(model.init(list(z0.unbind(1)), prior_mean[:, None],
                                  prior_var[:, None]), 1)


def fused_pf_score(model: FusedModel, params, window: torch.Tensor,
                   step_weights: torch.Tensor, z0: torch.Tensor,
                   normals: torch.Tensor | None, xi: torch.Tensor,
                   prior_mean: torch.Tensor, prior_var: torch.Tensor,
                   lambduh: float = 1.0, ess_threshold: float | None = None,
                   seeds: torch.Tensor | None = None,
                   step_valid: torch.Tensor | None = None):
    """Chain-batched fused buffered-PF score: ``(mean_stat [C, H],
    loglik [C])`` for windows ``[C, W]`` with the draws ``z0 [C, Z, N]``,
    ``xi [C, W]`` and either ``normals [C, W, Z, N]`` or, for normals
    generated in the kernel, ``seeds [C]`` (``normals=None``); the initial
    state is :func:`initial_state`.  ``step_valid [C, W]`` turns on the
    valid gate."""
    H = model.n_stat
    x0 = initial_state(model, z0, prior_mean, prior_var).contiguous()
    out = fused_window(model, model.pack_params(params).contiguous(), x0,
                       None if normals is None else normals.contiguous(),
                       window.contiguous(), step_weights.contiguous(),
                       xi.contiguous(), lambduh, ess_threshold,
                       None if seeds is None else seeds.contiguous(),
                       None if step_valid is None
                       else step_valid.contiguous())
    return out[:, :H], out[:, H]
