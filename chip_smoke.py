#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):
  1. the card's name and power limit; TF32 matmuls off;
  2. build and load the kernel library from every source in ``csrc/``
     (the fused window and the resample-apply kernel), with their ptxas
     lines;
  3. the fused-window kernel (K1) against its plain PyTorch version on the
     card, on the same draws, at C=256, N=1024, W=60 for lambda=1 and 0.95,
     and at the benchmark shape C=8192, N=1024, W=60 for lambda=1; then
     both timed at the benchmark shape;
  4. K1's path: ``SVMSampler.fit_scan("SGLD", ..., resampler="systematic")``
     with 8192 chains, N=1024, S=40, B=10 on T=1000 synthetic observations,
     one warm-up and one timed run of 20 iterations, each of which must
     launch K1 once per iteration and the resample-apply kernel never;
  5. parameter recovery on K1's path: 256 chains, 200 iterations from
     A=0.3 must move the chain-mean A toward the true 0.9;
  6. the resample-apply kernel against its plain PyTorch version on the
     card, which must agree bitwise, at the shapes the TPU kernels it
     replaces ran (K2b: C=8192, N=1024, K=4; K3: C=8192, N=1000, K=4; K2a:
     C=1, N=1024, K=4), at K=1, at an N beyond its shared-memory CDF and on
     degenerate weights; then the kernel and its plain version, which is
     the PyTorch call ``torch.searchsorted`` + ``torch.gather``, timed at
     the first three;
  7. the default path: ``SVMSampler(observations=ys).fit_scan("SGLD", ...)``
     with the JAX package's defaults (no device argument: the card;
     multinomial resampling, Poyiadjis O(N)), 8192 chains, S=40, B=10, at
     N=1000 and N=1024, 20 timed iterations each, which must launch the
     resample-apply kernel once per window step (20 * 60) and K1 never;
  8. the other unfused smoothers at 256 chains, N=1000: poyiadjis_N2 (with
     bw_chunk), filter, and stratified resampling with the ESS gate;
  9. parameter recovery on the default path: 256 chains, 200 iterations,
     multinomial, from A=0.3.
The last three lines are the kernel report (JSON), the card's
``nvidia-smi`` name and power limit, and the result (JSON).
Exits non-zero without a result when no CUDA device is available.
"""
import json
import subprocess
import sys
import time

import torch

C_CHECK, C_BENCH, N, S, B, T = 256, 8192, 1024, 40, 10, 1000
W = S + 2 * B
ITERS = 20
# Published H100 SXM peaks (NVIDIA data sheet): device memory and float32
# outside the tensor cores.
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12
# Scalar operations of K1 per particle and window step, counted in
# csrc/fused_window.cu and csrc/svm_body.cuh (max, exp-shift, prefix sum,
# position, ~11 search compares, propose 3, reweight 14, statistic 18,
# update 6; the few float64 ones counted at the float32 rate).
K1_OPS = 60


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def window_inputs(gen, C, ys, svm, subsequence, buffered):
    """Kernel inputs for C chains on random buffered windows of ``ys``."""
    dev = ys.device
    u = torch.rand((C, 3), generator=gen, device=dev)
    params = svm.SVMParams(A=(0.5 + 0.45 * u[:, 0]).reshape(C, 1, 1),
                           LQinv_vec=(0.3 + 1.2 * u[:, 1:2]) ** -0.5,
                           LRinv_vec=(0.5 + 1.5 * u[:, 2:3]) ** -0.5)
    start = subsequence.sample_start(gen, S, T, C, device=dev)
    win = subsequence.buffered_window(start, S, B, T)
    window = subsequence.slice_window(ys, win.window_start, W)[..., 0]
    step_w, _ = buffered.window_weights(win.t1, win.tL, win.weights, W)
    z0 = torch.randn((C, 1, N), generator=gen, device=dev)
    x0 = torch.sqrt(svm.stationary_variance(params))[:, None, None] * z0
    normals = torch.randn((C, W, 1, N), generator=gen, device=dev)
    xi = torch.rand((C, W), generator=gen, device=dev)
    return (svm._fused_pack(params).contiguous(), x0.contiguous(), normals,
            window.contiguous(), step_w.contiguous(), xi)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, ops):
    """(least time in ms, what bounds it) on the published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def reset_counts(fused_pf, resample):
    fused_pf.fused_window.launches = 0
    resample.resample_apply.launches = 0


def check_finite(what, *tensors):
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values in {what}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    from sgmcmc_tpu_torch.inference.samplers import SVMSampler
    from sgmcmc_tpu_torch.models import svm
    from sgmcmc_tpu_torch.ops import buffered, subsequence
    from sgmcmc_tpu_torch.ops.cuda import build, fused_pf, resample

    # 1. the card
    name = torch.cuda.get_device_name(0)
    card = smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("1 card", f"{name} | nvidia-smi: {card} | torch "
          f"{torch.__version__} CUDA {torch.version.cuda} | TF32 off")

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    build_s = time.perf_counter() - t0
    log = build.build_log_path()
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln] \
        if log.exists() else []
    phase("2 build", f"{build_s:.2f} s, sources "
          f"{[p.name for p in build.sources()]} -> "
          f"{build.library_path().name}; " + " | ".join(ptxas))

    # 3. K1 vs plain version on the card
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ys, _ = svm.generate_data(gen, svm.from_scalars(0.9, 0.5, 1.0,
                                                    device=dev), T)
    k1_err = 0.0

    def check(out_k, out_r, lam, C):
        check_finite(f"the K1 output at lambda={lam}", out_k)
        ll_k, ll_r = out_k[:, -1], out_r[:, -1]
        ll_bad = int(((ll_k - ll_r).abs() > 1e-4 * ll_r.abs()).sum())
        st_k, st_r = out_k[:, :-1], out_r[:, :-1]
        st_ok = ((st_k - st_r).abs() <= 1e-3 + 1e-3 * st_r.abs()).all(1)
        n_flip = int((~st_ok).sum())
        err = float((out_k - out_r).abs().max())
        phase("3 check", f"lambda={lam}: C={C} N={N} W={W}; loglik "
              f"off rtol 1e-4 in {ll_bad} chains; statistic off rtol=atol="
              f"1e-3 in {n_flip} chains (selection flips at CDF near-ties); "
              f"max |kernel - plain| = {err:.3e}")
        if ll_bad:
            raise AssertionError(f"loglik mismatch in {ll_bad} chains")
        if n_flip > 0.01 * C:
            raise AssertionError(f"statistic mismatch in {n_flip} chains")
        return err

    for lam in (1.0, 0.95):
        args = window_inputs(gen, C_CHECK, ys, svm, subsequence, buffered)
        out_k = fused_pf.fused_window(svm.FUSED, *args, lambduh=lam)
        out_r = fused_pf.fused_window_reference(svm.FUSED, *args,
                                                lambduh=lam)
        k1_err = max(k1_err, check(out_k, out_r, lam, C_CHECK))
    # the benchmark shape the main path gives the kernel: checked, then timed
    args = window_inputs(gen, C_BENCH, ys, svm, subsequence, buffered)
    out_k = fused_pf.fused_window(svm.FUSED, *args)
    out_r = fused_pf.fused_window_reference(svm.FUSED, *args)
    k1_err = max(k1_err, check(out_k, out_r, 1.0, C_BENCH))
    del out_k, out_r
    k1_ms = cuda_ms(lambda: fused_pf.fused_window(svm.FUSED, *args), 5)
    k1_plain = cuda_ms(lambda: fused_pf.fused_window_reference(svm.FUSED,
                                                               *args), 2)
    m = svm.FUSED
    k1_bytes = 4 * (sum(a.numel() for a in args) + C_BENCH * (m.n_stat + 1))
    k1_bound, k1_by = bound_ms(k1_bytes, C_BENCH * W * N * K1_OPS)
    del args
    phase("3 time", f"one window call C={C_BENCH} N={N} W={W}: kernel "
          f"{k1_ms:.3f} ms, plain PyTorch {k1_plain:.3f} ms, bound "
          f"{k1_bound:.3f} ms by {k1_by} ({k1_bytes / 1e9:.3f} GB) ({card})")

    # 4. K1's path
    sampler = SVMSampler(observations=ys, device="cuda", seed=2)
    sampler.parameters = svm.from_scalars(0.5, 1.0, 2.0)
    kw = dict(N=N, subsequence_length=S, buffer_length=B, pf="poyiadjis_N",
              resampler="systematic")

    def run_k1():
        reset_counts(fused_pf, resample)
        _, aux = sampler.fit_scan("SGLD", num_iters=ITERS, epsilon=0.1,
                                  num_chains=C_BENCH, record="none",
                                  return_aux=True, **kw)
        float(aux[:, -1].sum())                   # synchronises
        launches = (fused_pf.fused_window.launches,
                    resample.resample_apply.launches)
        if launches != (ITERS, 0):
            raise AssertionError(f"(K1, resample-apply) launches {launches} "
                                 f"in a {ITERS}-iteration fit")
        check_finite("the K1 path's loglik", aux)
        return launches[0]

    run_k1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k1_launches = run_k1()
    dt = time.perf_counter() - t0
    p = sampler.parameters
    check_finite("the K1 path's parameters", p.A, p.LQinv_vec, p.LRinv_vec)
    phase("4 K1 path", f"fit_scan SGLD systematic C={C_BENCH} N={N} S={S} "
          f"B={B} T={T}: {ITERS} iterations in {dt:.3f} s, {k1_launches} "
          f"K1 launches, {C_BENCH * ITERS / dt:.1f} aggregate steps/s "
          f"({card})")

    # 5. parameter recovery on K1's path
    rec = SVMSampler(observations=ys, device="cuda", seed=3)
    rec.parameters = svm.from_scalars(0.3, 1.5, 3.0)
    trace = rec.fit_scan("SGLD", num_iters=200, epsilon=0.05,
                         num_chains=256, record="all", **kw)
    a_mean = float(trace.A[:, -50:].mean())
    phase("5 recovery", f"K1 path: chain-mean A over the last 50 of 200 "
          f"iterations: {a_mean:.4f} (start 0.3, truth 0.9)")
    if not abs(a_mean - 0.9) < abs(a_mean - 0.3):
        raise AssertionError(f"A did not move toward 0.9: {a_mean}")

    # 6. resample-apply kernel vs plain version on the card
    shared_n = resample.max_shared_n()

    def ra_inputs(C, n_part, K, degenerate=False):
        lw = 2.0 * torch.randn((C, n_part), generator=gen, device=dev)
        if degenerate:
            lw[::2] = -float("inf")
        pos = torch.rand((C, n_part), generator=gen, device=dev)
        vals = torch.randn((C, n_part, K), generator=gen, device=dev)
        return pos, resample.weights_cdf(lw), vals

    cases = [("K2b", 8192, 1024, 4, False), ("K3", 8192, 1000, 4, False),
             ("K2a", 1, 1024, 4, False), ("K=1", 8192, 1024, 1, False),
             ("N>shared", 16, 131072, 1, False),
             ("degenerate", 64, 1024, 4, True)]
    if not 131072 > shared_n:
        raise AssertionError(f"N=131072 is within the shared-memory limit "
                             f"N={shared_n}")
    ra_err, ra_times = 0.0, {}
    for label, C, n_part, K, degenerate in cases:
        pos, cdf, vals = ra_inputs(C, n_part, K, degenerate)
        out_k = resample.resample_apply(pos, cdf, vals)
        out_r = resample.resample_apply_reference(pos, cdf, vals)
        torch.cuda.synchronize()
        err = float((out_k - out_r).abs().max())
        same = bool(torch.equal(out_k, out_r))
        ra_err = max(ra_err, err)
        msg = (f"{label}: C={C} N={n_part} K={K}: max |kernel - plain| = "
               f"{err!r}, bitwise equal {same}")
        if label in ("K2b", "K3", "K2a"):
            reps = 200 if C == 1 else 50
            ms = cuda_ms(lambda: resample.resample_apply(pos, cdf, vals),
                         reps)
            plain = cuda_ms(lambda: resample.resample_apply_reference(
                pos, cdf, vals), reps)
            # the plain version is itself the PyTorch call that computes
            # this function (torch.searchsorted + torch.gather): timed twice
            lib = cuda_ms(lambda: resample.resample_apply_reference(
                pos, cdf, vals), reps)
            nbytes = 4 * (pos.numel() + cdf.numel() + 2 * vals.numel())
            compares = C * n_part * (n_part.bit_length() + 1)
            bnd, by = bound_ms(nbytes, compares)
            ra_times[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                   bound_ms=bnd, bound_by=by)
            msg += (f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, PyTorch "
                    f"call {lib:.4f} ms, bound {bnd:.4f} ms by {by} "
                    f"({nbytes / 1e6:.1f} MB) ({card})")
        phase("6 resample-apply", msg)
        if not same:
            raise AssertionError(f"resample-apply differs from its plain "
                                 f"version at {label}")
        del pos, cdf, vals, out_k, out_r

    # 7. the default path: the JAX package's defaults, no device argument
    ra_launches = {}
    for n_part in (1000, 1024):
        dflt = SVMSampler(observations=ys, seed=4)
        if dflt.device.type != "cuda":
            raise AssertionError(f"the default device is {dflt.device}")
        dflt.parameters = svm.from_scalars(0.5, 1.0, 2.0)
        dkw = dict(N=n_part, subsequence_length=S, buffer_length=B)
        dflt.fit_scan("SGLD", num_iters=2, epsilon=0.1, num_chains=C_BENCH,
                      record="none", **dkw)           # warm-up
        torch.cuda.synchronize()
        reset_counts(fused_pf, resample)
        t0 = time.perf_counter()
        _, aux = dflt.fit_scan("SGLD", num_iters=ITERS, epsilon=0.1,
                               num_chains=C_BENCH, record="none",
                               return_aux=True, **dkw)
        float(aux[:, -1].sum())                   # synchronises
        dt = time.perf_counter() - t0
        launches = (resample.resample_apply.launches,
                    fused_pf.fused_window.launches)
        if launches != (ITERS * W, 0):
            raise AssertionError(f"(resample-apply, K1) launches {launches} "
                                 f"in a {ITERS}-iteration default fit")
        p = dflt.parameters
        check_finite("the default path", aux, p.A, p.LQinv_vec, p.LRinv_vec)
        ra_launches[n_part] = launches[0]
        phase("7 default path", f"fit_scan SGLD multinomial poyiadjis_N "
              f"C={C_BENCH} N={n_part} S={S} B={B} T={T}: {ITERS} "
              f"iterations in {dt:.3f} s, {launches[0]} resample-apply and "
              f"{launches[1]} K1 launches, {C_BENCH * ITERS / dt:.1f} "
              f"aggregate steps/s ({card})")
        del dflt, aux

    # 8. the other unfused smoothers, briefly
    for iters, okw in ((2, dict(pf="poyiadjis_N2", bw_chunk=200)),
                       (3, dict(pf="filter")),
                       (3, dict(resampler="stratified", ess_threshold=0.5))):
        other = SVMSampler(observations=ys, seed=5)
        other.parameters = svm.from_scalars(0.5, 1.0, 2.0)
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fused_pf, resample)
        t0 = time.perf_counter()
        _, aux = other.fit_scan("SGLD", num_iters=iters, epsilon=0.1,
                                num_chains=C_CHECK, record="none",
                                return_aux=True, N=1000, subsequence_length=S,
                                buffer_length=B, **okw)
        float(aux.sum())
        dt = time.perf_counter() - t0
        launches = (resample.resample_apply.launches,
                    fused_pf.fused_window.launches)
        if launches != (iters * W, 0):
            raise AssertionError(f"(resample-apply, K1) launches {launches} "
                                 f"for {okw}")
        p = other.parameters
        check_finite(f"the {okw} fit", aux, p.A, p.LQinv_vec, p.LRinv_vec)
        phase("8 unfused", f"{okw}: C={C_CHECK} N=1000, {iters} iterations "
              f"in {dt:.3f} s, {launches[0]} resample-apply launches, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # 9. parameter recovery on the default path
    rec = SVMSampler(observations=ys, seed=6)
    rec.parameters = svm.from_scalars(0.3, 1.5, 3.0)
    trace = rec.fit_scan("SGLD", num_iters=200, epsilon=0.05,
                         num_chains=256, record="all",
                         subsequence_length=S, buffer_length=B)
    a_mean = float(trace.A[:, -50:].mean())
    phase("9 recovery", f"default path (multinomial, N=1000): chain-mean A "
          f"over the last 50 of 200 iterations: {a_mean:.4f} (start 0.3, "
          f"truth 0.9)")
    if not abs(a_mean - 0.9) < abs(a_mean - 0.3):
        raise AssertionError(f"A did not move toward 0.9: {a_mean}")

    main_shape = ra_times["K2b"]
    print(json.dumps({"kernels": [
        {"name": "fused_window_svm", "route": "cuda",
         "source": "sgmcmc_tpu_torch/csrc/fused_window.cu",
         "replaces": "sgmcmc_tpu/ops/pallas/fused_pf.py:121",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "resample_apply", "route": "cuda",
         "source": "sgmcmc_tpu_torch/csrc/resample_apply.cu",
         "replaces": "sgmcmc_tpu/ops/pallas/resample.py:178 (K2a), "
                     ":232 (K2b), :31 (K3)",
         "launches": ra_launches[1024], "max_abs_err": ra_err,
         **main_shape}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
