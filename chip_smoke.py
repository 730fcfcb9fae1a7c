#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):
  1. the card's name and power limit; TF32 matmuls off;
  2. build and load the kernel library from every source in ``csrc/``
     (the fused window, the Philox generator and the resample-apply
     kernel), with their ptxas lines;
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
     C=1, N=1024, K=4), at K=1, at the LGSSM default path's K=5 (state and
     4-wide statistic), at the GARCH / SVJM default paths' K=6 (N=1000
     and 1024), at an N beyond its shared-memory CDF and on
     degenerate weights; then the kernel and its plain version, which is
     the PyTorch call ``torch.searchsorted`` + ``torch.gather``, timed at
     the first three and at K=6;
  7. the default path: ``SVMSampler(observations=ys).fit_scan("SGLD", ...)``
     with the JAX package's defaults (no device argument: the card;
     multinomial resampling, Poyiadjis O(N)), 8192 chains, S=40, B=10, at
     N=1000 and N=1024, 20 timed iterations each, which must launch the
     resample-apply kernel once per window step (20 * 60) and K1 never;
  8. the other unfused smoothers at 256 chains, N=1000: poyiadjis_N2 (with
     bw_chunk), filter, and stratified resampling with the ESS gate;
  9. parameter recovery on the default path: 256 chains, 200 iterations,
     multinomial, from A=0.3;
 10. the standalone Philox normal generator (the counterpart of the TPU
     probe kernel K4) against its plain PyTorch version: raw words bitwise
     equal and normals equal at K4's shape (256 x 512) and at the shape of
     the headline path's initial-state draw (8192 chains x 1024); the
     probe's moment gate at 256 x 512; a Kolmogorov-Smirnov test against
     N(0, 1) at 8192 x 1024; a sub-block drawn alone (t0 > 0) equal to the
     same slice of a full draw; then kernel and plain version timed;
 11. K1 with in-kernel normals against its plain version (which draws the
     same Philox normals) at C=256 and at the benchmark shape, and against
     K1 fed the standalone generator's normals (bitwise); then timed;
 12. the headline configuration with ``rng="kernel"``: ``fit_scan`` as in
     phase 4, 20 timed iterations, which must launch K1 and the generator
     once per iteration and the resample-apply kernel never, with a peak
     device memory below the size of the normals it no longer allocates;
 13. K1's ESS gate against its plain version at C=256 and the benchmark
     shape (some steps skip, some resample), timed; then
     ``fit_scan(resampler="systematic", ess_threshold=0.5)`` at 8192 chains,
     which must launch only K1;
 14. the scalar LGSSM: K1's optimal and prior bodies against their plain
     versions at C=256 (host and in-kernel normals) and at the benchmark
     shape (in-kernel normals, the fits' configuration), then timed there;
     the fused score over 1024 chains (T=16, N=1024, full window) against
     ``ops/kalman.py``'s exact gradient for ``rng="host"``, ``rng="kernel"``
     and ``ess_threshold=0.5`` (|z| < 5 per component);
     ``LGSSMSampler.fit_scan`` at 8192 chains, N=1024, S=40, B=10, T=1000:
     systematic with in-kernel normals for the optimal and the prior
     kernel (K1 only) and the default multinomial resampler (the
     resample-apply kernel only); parameter recovery from A=0.5 toward 0.9;
 15. GARCH and SVJM on K1: the garch_optimal, garch_prior and svjm bodies
     against their plain versions, bitwise (max |kernel - plain| = 0), with
     host and in-kernel normals at C=256 and at the fits' shape (C=8192,
     N=1024, W=60); then each timed there;
 16. GARCH and SVJM fits: ``GARCHSampler`` / ``SVJMSampler.fit_scan`` at
     8192 chains, N=1024, S=40, B=10, T=1000, systematic (K1 only:
     optimal and prior with in-kernel normals, optimal with host normals;
     SVJM with both) and the default multinomial resampler at N=1000 and
     N=1024 (the resample-apply kernel only, at K = D + H = 6); the fused
     score against the unfused one over 1024 chains (|z| < 5 per
     component); the SVJM score at pJ = 1e-6 against the SVM's on the same
     first normals (|z| < 5 for the shared components);
 17. the valid gate and the Seq samplers: K1 with ``vs`` against its plain
     version, bitwise, at C=8192 on buffered windows (W=60) with padded
     tails; K1 on the inputs the Seq score builds for each Seq fit below
     (SGLD setting: 8192 rows, W=24, for the svm, garch_optimal and svjm
     bodies; LD setting: 1024 chains x 8 sequences, W = T_max, with the
     valid gate), bitwise, then timed and bounded there; padding
     invariance of the Seq score on both routes (bitwise);
     ``SeqSVMSampler`` / ``SeqGARCHSampler`` / ``SeqSVJMSampler.fit_scan``
     at 8192 chains on 8 sequences of 200-1000 steps with the
     exchange-rate demo's SGLD setting (S=16, B=4, one sequence per
     gradient) and ``SeqSVMSampler`` at 1024 chains with its LD setting
     (S=-1, every sequence: K1 with the valid gate).
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
# csrc/fused_window.cuh and csrc/svm_body.cuh (max, exp-shift, prefix sum,
# position, ~11 search compares, propose 3, reweight 14, statistic 18,
# update 6; the few float64 ones counted at the float32 rate).
K1_OPS = 60
# The same count split into the body (propose + reweight + statistic) and
# the rest, and the options: csrc/lgssm_body.cuh (optimal: propose 15,
# reweight 16, statistic 18; prior: 3, 9, 18); in-kernel normals, half a
# Philox4x32-10 call (98 integer operations, counted at the float32 rate)
# and one Box-Muller transform (14, log and cos counted as one each); the
# ESS gate (w^2, its sum, the carried weight: 5).
K1_BODY_OPS = {"svm": 35, "lgssm_optimal": 49, "lgssm_prior": 30}
K1_FRAME_OPS = K1_OPS - K1_BODY_OPS["svm"]
# Of the frame, parts 1-2 run on every step (max 1, exp-shift 2, prefix
# sum and CDF 3); position 2, search 11 and update 6 run in part 4, which
# a step the valid gate turns off skips with the body and the normals.
K1_STEP_OPS = 6
RNG_OPS, ESS_OPS = 49 + 14, 5
# The GARCH and SVJM bodies (csrc/garch_body.cuh: optimal propose 19,
# reweight 10, statistic 30; prior 12, 9, 30; csrc/svjm_body.cuh: propose
# 11, reweight 14, statistic 70), each with 2 more update operations per
# statistic beyond the SVM's three.
K1_BODY_OPS.update(garch_optimal=61, garch_prior=53, svjm=99)
# Operations of the standalone generator per pair of normals (see
# csrc/philox_normals.cu).
PHILOX_PAIR_OPS = 98 + 2 * 14


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


def k1_ops(C, body, rng=False, ess=False, Z=1, steps=W, active=None):
    """Operations of one K1 call over C chains of a ``steps``-step window
    (Z normals per particle and step), of which ``active`` chain-steps
    (default: all) run part 4; the others run parts 1-2 only."""
    every = K1_STEP_OPS + (ESS_OPS if ess else 0)
    part4 = (K1_FRAME_OPS - K1_STEP_OPS + K1_BODY_OPS[body]
             + (Z * RNG_OPS if rng else 0))
    active = C * steps if active is None else active
    return N * (C * steps * every + active * part4)


def reset_counts(fused_pf, resample, philox=None):
    fused_pf.fused_window.launches = 0
    resample.resample_apply.launches = 0
    if philox is not None:
        philox.philox_normals.launches = 0


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
    from sgmcmc_tpu_torch.ops.cuda import build, fused_pf, philox, resample

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
    lines = log.read_text().splitlines() if log.exists() else []
    spills = [f"{lines[i - 1].split()[-1]}: {ln.strip()}"
              for i, ln in enumerate(lines) if "spill stores" in ln
              and "0 bytes spill stores, 0 bytes spill loads" not in ln]
    phase("2 build", f"functions that spill registers: {len(spills)}"
          + "".join(f" | {ln}" for ln in spills))

    # 3. K1 vs plain version on the card
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ys, _ = svm.generate_data(gen, svm.from_scalars(0.9, 0.5, 1.0,
                                                    device=dev), T)
    k1_err = 0.0

    def check(out_k, out_r, lam, C, tag="3 check", what=""):
        """K1's gate against its plain version: every chain's loglik within
        rtol 1e-4, the statistic within rtol=atol=1e-3 in >= 99% of them."""
        check_finite(f"the K1 output {what} at lambda={lam}", out_k)
        ll_k, ll_r = out_k[:, -1], out_r[:, -1]
        ll_bad = int(((ll_k - ll_r).abs() > 1e-4 * ll_r.abs()).sum())
        st_k, st_r = out_k[:, :-1], out_r[:, :-1]
        st_ok = ((st_k - st_r).abs() <= 1e-3 + 1e-3 * st_r.abs()).all(1)
        n_flip = int((~st_ok).sum())
        err = float((out_k - out_r).abs().max())
        phase(tag, f"{what}lambda={lam}: C={C} N={N} W={W}; loglik "
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
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    k1_launches = run_k1()
    dt = time.perf_counter() - t0
    host_peak = torch.cuda.max_memory_allocated()
    host_rate = C_BENCH * ITERS / dt
    p = sampler.parameters
    check_finite("the K1 path's parameters", p.A, p.LQinv_vec, p.LRinv_vec)
    phase("4 K1 path", f"fit_scan SGLD systematic C={C_BENCH} N={N} S={S} "
          f"B={B} T={T}: {ITERS} iterations in {dt:.3f} s, {k1_launches} "
          f"K1 launches, {host_rate:.1f} aggregate steps/s, peak device "
          f"memory {host_peak / 2 ** 30:.3f} GiB ({card})")

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
             ("LGSSM default", 8192, 1024, 5, False),
             ("GARCH/SVJM default N=1024", 8192, 1024, 6, False),
             ("GARCH/SVJM default N=1000", 8192, 1000, 6, False),
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
        if label in ("K2b", "K3", "K2a") or K == 6:
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

    # 10. the standalone Philox generator (K4's counterpart)
    ph_err = 0.0
    seeds_k4 = torch.tensor([123], dtype=torch.int64, device=dev)
    seeds_main = torch.randint(-2 ** 63, 2 ** 63 - 1, (C_BENCH,),
                               generator=gen, dtype=torch.int64, device=dev)
    for label, sd, shape, stream in (
            ("K4 shape", seeds_k4, (256, 1, 512), philox.STREAM_PROPOSAL),
            ("initial-state draw", seeds_main, (1, 1, N),
             philox.STREAM_INIT),
            ("SVJM initial-state draw, Z=2", seeds_main, (1, 2, N),
             philox.STREAM_INIT)):
        words_k = philox.philox_words(sd, *shape, stream=stream)
        words_r = philox.philox_words_reference(sd, *shape, stream=stream)
        same_words = bool(torch.equal(words_k.long() & philox.MASK, words_r))
        z_k = philox.philox_normals(sd, *shape, stream=stream)
        z_r = philox.philox_normals_reference(sd, *shape, stream=stream)
        err = float((z_k - z_r).abs().max())
        ph_err = max(ph_err, err)
        phase("10 philox", f"{label}: C={sd.numel()} W,Z,N={shape}: raw "
              f"words bitwise equal {same_words}; normals max |kernel - "
              f"plain| = {err!r} (tolerance 1e-5)")
        if not same_words or not err <= 1e-5:
            raise AssertionError(f"the Philox kernel differs from its plain "
                                 f"version at {label}")
    # layout independence on the card: steps t0 .. t0+3 drawn alone equal
    # the same slice of a full window's draw
    full_w = philox.philox_words(seeds_main[:64], W, 1, N)
    full_z = philox.philox_normals(seeds_main[:64], W, 1, N)
    part_w = philox.philox_words(seeds_main[16:48], 4, 1, N, t0=7)
    part_z = philox.philox_normals(seeds_main[16:48], 4, 1, N, t0=7)
    sliced = bool(torch.equal(part_w, full_w[16:48, 7:11])
                  and torch.equal(part_z, full_z[16:48, 7:11]))
    phase("10 philox", f"chains 16..47, steps 7..10 drawn alone (t0=7) == "
          f"the same slice of a {W}-step draw, words and normals: {sliced}")
    if not sliced:
        raise AssertionError("the Philox kernel's stream depends on the "
                             "block it is drawn in")
    del full_w, full_z, part_w, part_z
    z = philox.philox_normals(seeds_k4, 256, 1, 512)[0, :, 0].double()
    mean, std = float(z.mean()), float(z.std(unbiased=False))
    kurt = float((((z - z.mean()) / z.std(unbiased=False)) ** 4).mean())
    same = bool(torch.equal(philox.philox_normals(seeds_k4, 256, 1, 512),
                            philox.philox_normals(seeds_k4, 256, 1, 512)))
    other = bool(torch.equal(philox.philox_normals(seeds_k4 + 1, 256, 1, 512),
                             philox.philox_normals(seeds_k4, 256, 1, 512)))
    from scipy import stats
    z_ks = philox.philox_normals(seeds_main, 1, 1, N).reshape(-1)
    ks = stats.kstest(z_ks.double().cpu().numpy(), "norm")
    phase("10 philox", f"probe gate at 256 x 512: mean {mean:.5f}, std "
          f"{std:.5f}, kurtosis {kurt:.4f}, deterministic {same}, seed-"
          f"sensitive {not other}; KS against N(0, 1) at {C_BENCH} x {N}: "
          f"D = {ks.statistic:.3e}, p = {ks.pvalue:.4f}")
    if not (abs(mean) < 0.02 and abs(std - 1) < 0.02 and abs(kurt - 3) < 0.2
            and same and not other):
        raise AssertionError("the Philox normals fail the probe's gate")
    if not ks.pvalue > 1e-3:
        raise AssertionError(f"KS test p = {ks.pvalue} below 1e-3")
    # free the checks' ~0.3 GB so that later phases' peaks are their fits'
    del words_k, words_r, z_k, z_r, z, z_ks
    ph_ms = cuda_ms(lambda: philox.philox_normals(
        seeds_main, 1, 1, N, stream=philox.STREAM_INIT), 50)
    ph_plain = cuda_ms(lambda: philox.philox_normals_reference(
        seeds_main, 1, 1, N, stream=philox.STREAM_INIT), 5)
    ph_bytes = 8 * C_BENCH + 4 * C_BENCH * N
    ph_bound, ph_by = bound_ms(ph_bytes, C_BENCH * N // 2 * PHILOX_PAIR_OPS)
    # a yardstick only: torch's own generator, other bits from other seeds
    randn_ms = cuda_ms(lambda: torch.randn((C_BENCH, 1, N), device=dev), 50)
    phase("10 philox", f"{C_BENCH} x {N} normals: kernel {ph_ms:.4f} ms, "
          f"plain {ph_plain:.4f} ms, bound {ph_bound:.4f} ms by {ph_by}; "
          f"torch.randn of the same shape {randn_ms:.4f} ms ({card})")

    # 11. K1 with in-kernel normals
    def seeded(C):
        args = window_inputs(gen, C, ys, svm, subsequence, buffered)
        sd = torch.randint(-2 ** 63, 2 ** 63 - 1, (C,), generator=gen,
                           dtype=torch.int64, device=dev)
        return (args[0], args[1], None, *args[3:]), sd

    rng_err = 0.0
    for C in (C_CHECK, C_BENCH):
        args, sd = seeded(C)
        out_k = fused_pf.fused_window(svm.FUSED, *args, seeds=sd)
        out_r = fused_pf.fused_window_reference(svm.FUSED, *args, seeds=sd)
        rng_err = max(rng_err, check(out_k, out_r, 1.0, C, "11 K1 rng",
                                     "in-kernel normals, "))
        fed = fused_pf.fused_window(
            svm.FUSED, args[0], args[1], philox.philox_normals(sd, W, 1, N),
            *args[3:])
        same = bool(torch.equal(out_k, fed))
        phase("11 K1 rng", f"C={C}: kernel with seeds == kernel fed the "
              f"generator's normals, bitwise: {same}")
        if not same:
            raise AssertionError("in-kernel normals differ from the "
                                 "standalone generator's")
        del out_k, out_r, fed
    rng_ms = cuda_ms(lambda: fused_pf.fused_window(svm.FUSED, *args,
                                                   seeds=sd), 5)
    rng_plain = cuda_ms(lambda: fused_pf.fused_window_reference(
        svm.FUSED, *args, seeds=sd), 2)
    rng_bytes = 4 * (sum(a.numel() for a in args if a is not None)
                     + C_BENCH * (svm.FUSED.n_stat + 1)) + 8 * C_BENCH
    rng_bound, rng_by = bound_ms(rng_bytes, k1_ops(C_BENCH, "svm", rng=True))
    phase("11 K1 rng", f"one window call C={C_BENCH} N={N} W={W}: kernel "
          f"{rng_ms:.3f} ms (host normals, phase 3: {k1_ms:.3f} ms), plain "
          f"{rng_plain:.3f} ms, bound {rng_bound:.3f} ms by {rng_by} "
          f"({rng_bytes / 1e6:.1f} MB) ({card})")
    del args

    # 12. the headline configuration with rng="kernel"
    def run_fit(smp, expect, n_iters=ITERS, C=C_BENCH, **fkw):
        """One timed fit_scan from zeroed counts: (seconds, launches of
        (K1, resample-apply, Philox), peak device memory)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fused_pf, resample, philox)
        t0 = time.perf_counter()
        _, aux = smp.fit_scan("SGLD", num_iters=n_iters, epsilon=0.1,
                              num_chains=C, record="none", return_aux=True,
                              **fkw)
        float(aux[:, -1].sum())                   # synchronises
        dt = time.perf_counter() - t0
        launches = (fused_pf.fused_window.launches,
                    resample.resample_apply.launches,
                    philox.philox_normals.launches)
        if launches != expect:
            raise AssertionError(f"(K1, resample-apply, Philox) launches "
                                 f"{launches}, expected {expect}, for {fkw}")
        p = smp.parameters
        check_finite(f"the fit {fkw}", aux,
                     *[getattr(p, f) for f in p.__dataclass_fields__])
        return dt, launches, torch.cuda.max_memory_allocated()

    kkw = dict(kw, rng="kernel")
    run_fit(sampler, (ITERS, 0, ITERS), **kkw)    # warm-up
    dt, (rng_launches, _, ph_launches), rng_peak = run_fit(
        sampler, (ITERS, 0, ITERS), **kkw)
    normals_bytes = 4 * C_BENCH * W * N
    phase("12 headline rng", f"fit_scan SGLD systematic rng='kernel' "
          f"C={C_BENCH} N={N} S={S} B={B} T={T}: {ITERS} iterations in "
          f"{dt:.3f} s, {rng_launches} K1 and {ph_launches} Philox launches, "
          f"0 resample-apply, {C_BENCH * ITERS / dt:.1f} aggregate steps/s "
          f"(rng='host', phase 4: {host_rate:.1f}); peak device memory "
          f"{rng_peak / 2 ** 30:.3f} GiB (rng='host': "
          f"{host_peak / 2 ** 30:.3f} GiB; the normals alone "
          f"{normals_bytes / 2 ** 30:.3f} GiB) ({card})")
    if not rng_peak < normals_bytes:
        raise AssertionError("the rng='kernel' fit's peak memory leaves room "
                             "for the [C, W, Z, N] normals")

    # 13. K1's ESS gate
    ess_err = 0.0
    for C in (C_CHECK, C_BENCH):
        args = window_inputs(gen, C, ys, svm, subsequence, buffered)
        out_k = fused_pf.fused_window(svm.FUSED, *args, ess_threshold=0.5)
        out_r = fused_pf.fused_window_reference(svm.FUSED, *args,
                                                ess_threshold=0.5)
        ess_err = max(ess_err, check(out_k, out_r, 1.0, C, "13 K1 ESS",
                                     "ESS gate 0.5, "))
        always = fused_pf.fused_window(svm.FUSED, *args)
        never = fused_pf.fused_window(svm.FUSED, *args, ess_threshold=0.0)
        skip = float((out_k != always).any(1).float().mean())
        res = float((out_k != never).any(1).float().mean())
        phase("13 K1 ESS", f"C={C}: chains whose gated window differs from "
              f"always resampling {skip:.2%} (steps skipped), from never "
              f"resampling {res:.2%} (steps resampled)")
        if not (skip > 0.5 and res > 0.5):
            raise AssertionError("the ESS gate did not both skip and "
                                 "resample")
        del out_k, out_r, always, never
    ess_ms = cuda_ms(lambda: fused_pf.fused_window(svm.FUSED, *args,
                                                   ess_threshold=0.5), 5)
    ess_plain = cuda_ms(lambda: fused_pf.fused_window_reference(
        svm.FUSED, *args, ess_threshold=0.5), 2)
    ess_bytes = 4 * (sum(a.numel() for a in args)
                     + C_BENCH * (svm.FUSED.n_stat + 1))
    ess_bound, ess_by = bound_ms(ess_bytes, k1_ops(C_BENCH, "svm", ess=True))
    phase("13 K1 ESS", f"one window call C={C_BENCH}: kernel {ess_ms:.3f} "
          f"ms, plain {ess_plain:.3f} ms, bound {ess_bound:.3f} ms by "
          f"{ess_by} ({card})")
    del args
    ekw = dict(kw, ess_threshold=0.5)
    dt, (ess_launches, _, _), _ = run_fit(sampler, (ITERS, 0, 0), **ekw)
    phase("13 K1 ESS", f"fit_scan SGLD systematic ess_threshold=0.5 "
          f"C={C_BENCH}: {ITERS} iterations in {dt:.3f} s, {ess_launches} "
          f"K1 launches, 0 resample-apply, {C_BENCH * ITERS / dt:.1f} "
          f"aggregate steps/s ({card})")

    # 14. the scalar LGSSM
    from sgmcmc_tpu_torch.inference import sgmcmc
    from sgmcmc_tpu_torch.inference.samplers import LGSSMSampler
    from sgmcmc_tpu_torch.models import lgssm, registry
    ys_l, _ = lgssm.generate_data(gen, lgssm.from_scalars(
        0.9, 0.5, 1.0, device=dev), T)

    def lgssm_inputs(C):
        """K1 inputs for C chains of the LGSSM on random windows of ys_l
        (x0 from the (0, 10) initial-state prior)."""
        svm_args = window_inputs(gen, C, ys_l, svm, subsequence, buffered)
        u = torch.rand((C, 3), generator=gen, device=dev)
        pvec = torch.stack([0.5 + 0.45 * u[:, 0], torch.ones_like(u[:, 0]),
                            (0.3 + 1.2 * u[:, 1]) ** -0.5,
                            (0.5 + 1.5 * u[:, 2]) ** -0.5], -1).contiguous()
        x0 = (10.0 ** 0.5 * torch.randn((C, 1, N), generator=gen,
                                        device=dev)).contiguous()
        return (pvec, x0) + svm_args[2:]

    lg = {}
    for body, model in (("lgssm_optimal", lgssm.FUSED),
                        ("lgssm_prior", lgssm.FUSED_PRIOR)):
        args = lgssm_inputs(C_CHECK)
        out_k = fused_pf.fused_window(model, *args)
        out_r = fused_pf.fused_window_reference(model, *args)
        err = check(out_k, out_r, 1.0, C_CHECK, "14 LGSSM K1",
                    f"{body}, host normals, ")
        args = args[:2] + (None,) + args[3:]
        sd = torch.randint(-2 ** 63, 2 ** 63 - 1, (C_CHECK,), generator=gen,
                           dtype=torch.int64, device=dev)
        out_k = fused_pf.fused_window(model, *args, seeds=sd)
        out_r = fused_pf.fused_window_reference(model, *args, seeds=sd)
        err = max(err, check(out_k, out_r, 1.0, C_CHECK, "14 LGSSM K1",
                             f"{body}, in-kernel normals, "))
        # the fit's configuration (in-kernel normals) at the shape the fit
        # gives the kernel: checked, then timed
        args = lgssm_inputs(C_BENCH)
        args = args[:2] + (None,) + args[3:]
        sd = torch.randint(-2 ** 63, 2 ** 63 - 1, (C_BENCH,), generator=gen,
                           dtype=torch.int64, device=dev)
        out_k = fused_pf.fused_window(model, *args, seeds=sd)
        out_r = fused_pf.fused_window_reference(model, *args, seeds=sd)
        err = max(err, check(out_k, out_r, 1.0, C_BENCH, "14 LGSSM K1",
                             f"{body}, in-kernel normals, "))
        del out_k, out_r
        ms = cuda_ms(lambda: fused_pf.fused_window(model, *args, seeds=sd), 5)
        plain = cuda_ms(lambda: fused_pf.fused_window_reference(
            model, *args, seeds=sd), 2)
        nbytes = 4 * (sum(a.numel() for a in args if a is not None)
                      + C_BENCH * (model.n_stat + 1)) + 8 * C_BENCH
        bnd, by = bound_ms(nbytes, k1_ops(C_BENCH, body, rng=True))
        lg[body] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                        bound_by=by)
        phase("14 LGSSM K1", f"{body}, in-kernel normals, one window call "
              f"C={C_BENCH} N={N} W={W}: kernel {ms:.3f} ms, plain "
              f"{plain:.3f} ms, bound {bnd:.3f} ms by {by} ({card})")
        del args

    # the oracle: the full-window fused score against the exact gradient
    T_OR, C_OR = 16, 1024
    truth = lgssm.from_scalars(0.8, 0.5, 1.0, device=dev)
    ys_o, _ = lgssm.generate_data(gen, truth, T_OR)
    exact = lgssm.gradient_marginal_loglikelihood(truth, ys_o)
    exact_vec = torch.stack([exact.LRinv_vec[0, 0], exact.LQinv_vec[0, 0],
                             exact.C[0, 0, 0], exact.A[0, 0, 0]])
    rows = lgssm.LGSSMParams(*[x.expand((C_OR,) + x.shape[1:]).contiguous()
                               for x in (truth.A, truth.C, truth.LQinv_vec,
                                         truth.LRinv_vec)])
    for label, okw in (("rng='host'", {}), ("rng='kernel'", {"rng": "kernel"}),
                       ("ess_threshold=0.5", {"ess_threshold": 0.5})):
        cfg = sgmcmc.PFScoreConfig(n_particles=N, resampler="systematic",
                                   **okw)
        score = sgmcmc.make_pf_score_fn(
            lgssm.OPTIMAL_KERNEL, lgssm.grad_statistic, 4, lgssm.unpack_grad,
            cfg, T_OR, prior_mean_var_fn=registry.LGSSM.prior_mean_var,
            fused_model=lgssm.FUSED)
        reset_counts(fused_pf, resample, philox)
        g, ll = score(gen, rows, ys_o)
        f = torch.stack([g.LRinv_vec[:, 0], g.LQinv_vec[:, 0], g.C[:, 0, 0],
                         g.A[:, 0, 0]], 1).double()
        check_finite(f"the oracle score {label}", f, ll)
        zval = (f.mean(0) - exact_vec) / (f.std(0) / C_OR ** 0.5 + 1e-9)
        phase("14 LGSSM oracle", f"{label}: T={T_OR} N={N} over {C_OR} "
              f"chains, {fused_pf.fused_window.launches} K1 launch; z "
              f"[LRinv, LQinv, C, A] = "
              f"{[round(float(v), 3) for v in zval]}; exact "
              f"{[round(float(v), 4) for v in exact_vec]}")
        if fused_pf.fused_window.launches != 1:
            raise AssertionError("the oracle score did not run K1")
        if not bool((zval.abs() < 5).all()):
            raise AssertionError(f"the fused score is off the exact "
                                 f"gradient at {label}: z = {zval}")

    # the full-width fits
    lkw = dict(N=N, subsequence_length=S, buffer_length=B)
    lg_launches = {}
    for label, fkw, expect in (
            ("systematic rng='kernel', optimal",
             dict(lkw, resampler="systematic", rng="kernel"),
             (ITERS, 0, ITERS)),
            ("systematic rng='kernel', prior",
             dict(lkw, resampler="systematic", rng="kernel", kernel="prior"),
             (ITERS, 0, ITERS)),
            ("multinomial (default), optimal", lkw, (0, ITERS * W, 0))):
        fit = LGSSMSampler(observations=ys_l, seed=7)
        fit.parameters = lgssm.from_scalars(0.5, 1.0, 2.0)
        # warm-up of 2 iterations, then the chains continue for ITERS
        run_fit(fit, tuple(2 * e // ITERS for e in expect), 2, **fkw)
        dt, launches, peak = run_fit(fit, expect, **fkw)
        if "prior" in label:
            lg_launches["lgssm_prior"] = launches[0]
        elif "systematic" in label:
            lg_launches["lgssm_optimal"] = launches[0]
        phase("14 LGSSM fit", f"LGSSMSampler.fit_scan SGLD {label} "
              f"C={C_BENCH} N={N} S={S} B={B} T={T}: {ITERS} iterations in "
              f"{dt:.3f} s, (K1, resample-apply, Philox) launches "
              f"{launches}, {C_BENCH * ITERS / dt:.1f} aggregate steps/s, "
              f"peak {peak / 2 ** 30:.3f} GiB ({card})")
        del fit

    rec = LGSSMSampler(observations=ys_l, seed=8)
    rec.parameters = lgssm.from_scalars(0.5, 1.0, 2.0)
    trace = rec.fit_scan("SGLD", num_iters=200, epsilon=0.05,
                         num_chains=256, record="all", resampler="systematic",
                         rng="kernel", **lkw)
    a_mean = float(trace.A[:, -50:].mean())
    phase("14 LGSSM recovery", f"systematic rng='kernel': chain-mean A over "
          f"the last 50 of 200 iterations: {a_mean:.4f} (start 0.5, truth "
          f"0.9)")
    if not abs(a_mean - 0.9) < abs(a_mean - 0.5):
        raise AssertionError(f"A did not move toward 0.9: {a_mean}")

    # 15. GARCH and SVJM on K1
    from sgmcmc_tpu_torch.inference import samplers
    from sgmcmc_tpu_torch.models import garch, svjm
    garch_truth = garch.from_alpha_beta_gamma(0.1, 0.6, 0.2, 0.5, device=dev)
    svjm_truth = svjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0, device=dev)
    ys_g, _ = garch.generate_data(gen, garch_truth, T)
    ys_j, _ = svjm.generate_data(gen, svjm_truth, T)

    def random_params(mod, C):
        """Parameters of C chains around the models' test truths."""
        u = torch.rand((C, 5), generator=gen, device=dev)
        if mod is garch:
            return garch.GARCHParams(
                log_mu=torch.log(0.2 + 0.8 * u[:, 0:1]),
                logit_phi=torch.logit(0.5 + 0.4 * u[:, 1:2]),
                logit_lambduh=torch.logit(0.1 + 0.4 * u[:, 2:3]),
                LRinv_vec=(0.5 + 1.5 * u[:, 3:4]) ** -0.5)
        sv = dict(A=(0.5 + 0.45 * u[:, 0]).reshape(C, 1, 1),
                  LQinv_vec=(0.3 + 1.2 * u[:, 1:2]) ** -0.5,
                  LRinv_vec=(0.5 + 1.5 * u[:, 2:3]) ** -0.5)
        if mod is svm:
            return svm.SVMParams(**sv)
        return svjm.SVJMParams(
            **sv, logit_pJ=torch.logit(0.02 + 0.28 * u[:, 3:4]),
            LQJinv_vec=(0.5 + 2.0 * u[:, 4:5]) ** -0.5)

    def body_inputs(mod, model, ys_m, C, seeded):
        """K1 inputs of C chains of a GARCH or SVJM body on random windows
        of ys_m (x0 from the model's init hook and its stationary prior),
        and the seeds of in-kernel normals or None."""
        params = random_params(mod, C)
        start = subsequence.sample_start(gen, S, T, C, device=dev)
        win = subsequence.buffered_window(start, S, B, T)
        window = subsequence.slice_window(ys_m, win.window_start, W)[..., 0]
        step_w, _ = buffered.window_weights(win.t1, win.tL, win.weights, W)
        Z = model.noise_dims
        var = mod.stationary_variance(params)
        x0 = fused_pf.initial_state(
            model, torch.randn((C, Z, N), generator=gen, device=dev),
            torch.zeros_like(var), var)
        xi = torch.rand((C, W), generator=gen, device=dev)
        normals = None if seeded else torch.randn(
            (C, W, Z, N), generator=gen, device=dev)
        sd = torch.randint(-2 ** 63, 2 ** 63 - 1, (C,), generator=gen,
                           dtype=torch.int64, device=dev) if seeded else None
        return (model.pack_params(params).contiguous(), x0.contiguous(),
                normals, window.contiguous(), step_w.contiguous(), xi), sd

    def check_exact(model, args, sd, tag, what, vs=None):
        """K1 against its plain version, bitwise: (max |kernel - plain|,
        the plain version's time in ms)."""
        out_k = fused_pf.fused_window(model, *args, seeds=sd, vs=vs)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out_r = fused_pf.fused_window_reference(model, *args, seeds=sd,
                                                vs=vs)
        end.record()
        torch.cuda.synchronize()
        check_finite(f"the K1 output {what}", out_k, out_r)
        err = float((out_k - out_r).abs().max())
        n_diff = int((out_k != out_r).any(1).sum())
        C, Wc = args[3].shape
        phase(tag, f"{what}C={C} N={N} W={Wc}: max |kernel - plain| = "
              f"{err!r}, chains that differ {n_diff}")
        if n_diff:
            raise AssertionError(f"K1 {what}differs from its plain version "
                                 f"in {n_diff} chains")
        return err, start.elapsed_time(end)

    def k1_bytes(model, args, sd):
        return (4 * (sum(a.numel() for a in args if a is not None)
                     + args[0].shape[0] * (model.n_stat + 1))
                + (0 if sd is None else 8 * sd.numel()))

    new_k1 = {}
    for body, mod, model, ys_m in (
            ("garch_optimal", garch, garch.FUSED, ys_g),
            ("garch_prior", garch, garch.FUSED_PRIOR, ys_g),
            ("svjm", svjm, svjm.FUSED, ys_j)):
        for seeded in (False, True):
            what = (f"{body}, " + ("in-kernel" if seeded else "host")
                    + " normals, ")
            err = 0.0
            for C in (C_CHECK, C_BENCH):
                args, sd = body_inputs(mod, model, ys_m, C, seeded)
                e, plain = check_exact(model, args, sd, "15 K1 bodies", what)
                err = max(err, e)
            ms = cuda_ms(lambda: fused_pf.fused_window(model, *args,
                                                       seeds=sd), 5)
            nbytes = k1_bytes(model, args, sd)
            bnd, by = bound_ms(nbytes, k1_ops(C_BENCH, body, rng=seeded,
                                              Z=model.noise_dims))
            smem = getattr(fused_pf._library(),
                           f"sgmcmc_fused_window_{body}_smem")(W, N, 0)
            name_k = body + ("_rng_kernel" if seeded else "")
            new_k1[name_k] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=bnd, bound_by=by)
            phase("15 K1 bodies", f"{what}one window call C={C_BENCH} "
                  f"N={N} W={W}: kernel {ms:.3f} ms, plain {plain:.3f} ms, "
                  f"bound {bnd:.3f} ms by {by} ({nbytes / 1e6:.1f} MB); "
                  f"{smem} bytes of shared memory a block (above 48 KB: "
                  f"launched after cudaFuncSetAttribute) ({card})")
            del args

    # 16. GARCH and SVJM fits
    new_launches = {}

    def fit_pair(cls, ys_m, start_params, expect, label, C=C_BENCH,
                 **fkw):
        """A 2-iteration warm-up, then ITERS timed iterations."""
        smp = cls(observations=ys_m, seed=12)
        smp.parameters = start_params
        run_fit(smp, tuple(2 * e // ITERS for e in expect), 2, C=C, **fkw)
        dt, launches, peak = run_fit(smp, expect, C=C, **fkw)
        phase(label, f"{cls.__name__}.fit_scan SGLD {fkw} C={C}: {ITERS} "
              f"iterations in {dt:.3f} s, (K1, resample-apply, Philox) "
              f"launches {launches}, {C * ITERS / dt:.1f} aggregate "
              f"steps/s, peak {peak / 2 ** 30:.3f} GiB ({card})")
        return launches

    fkw = dict(N=N, subsequence_length=S, buffer_length=B,
               resampler="systematic")
    garch_start = garch.from_alpha_beta_gamma(0.2, 0.3, 0.3, 1.0)
    svjm_start = svjm.from_scalars(0.5, 1.0, 2.0, 0.05, 1.0)
    for name_k, cls, ys_m, start_p, kw_k, expect in (
            ("garch_optimal_rng_kernel", samplers.GARCHSampler, ys_g,
             garch_start, dict(rng="kernel"), (ITERS, 0, ITERS)),
            ("garch_prior_rng_kernel", samplers.GARCHSampler, ys_g,
             garch_start, dict(rng="kernel", kernel="prior"),
             (ITERS, 0, ITERS)),
            ("garch_optimal", samplers.GARCHSampler, ys_g, garch_start,
             dict(rng="host"), (ITERS, 0, 0)),
            ("svjm_rng_kernel", samplers.SVJMSampler, ys_j, svjm_start,
             dict(rng="kernel"), (ITERS, 0, ITERS)),
            ("svjm", samplers.SVJMSampler, ys_j, svjm_start,
             dict(rng="host"), (ITERS, 0, 0))):
        new_launches[name_k] = fit_pair(cls, ys_m, start_p, expect,
                                        "16 K1 fit", **fkw, **kw_k)[0]
    ra6 = {}
    for cls, ys_m, start_p in ((samplers.GARCHSampler, ys_g, garch_start),
                               (samplers.SVJMSampler, ys_j, svjm_start)):
        for n_part in (1000, 1024):
            ra6[(cls.__name__, n_part)] = fit_pair(
                cls, ys_m, start_p, (0, ITERS * W, 0), "16 default fit",
                N=n_part, subsequence_length=S, buffer_length=B)[1]

    # the fused score against the unfused one, 1024 chains, full window
    T_X, C_X = 20, 1024
    for label, model_name, truth, kern_name in (
            ("garch optimal", "garch", garch_truth, None),
            ("garch prior", "garch", garch_truth, "prior"),
            ("svjm", "svjm", svjm_truth, None)):
        api = registry.get_model(model_name)
        ys_x, _ = api.generate_data(gen, truth, T_X)
        rows = type(truth)(*[x.expand((C_X,) + x.shape[1:]).contiguous()
                             for x in vars(truth).values()])
        cfg = sgmcmc.PFScoreConfig(n_particles=N, resampler="systematic")
        stats = []
        for fused_model, expect in ((api.get_fused(kern_name), (1, 0)),
                                    (None, (0, T_X))):
            score = sgmcmc.make_pf_score_fn(
                api.get_kernel(kern_name), api.grad_statistic,
                api.grad_statistic_dim, lambda s: s, cfg, T_X,
                prior_mean_var_fn=api.prior_mean_var,
                fused_model=fused_model)
            reset_counts(fused_pf, resample, philox)
            f, ll = score(gen, rows, ys_x)
            launches = (fused_pf.fused_window.launches,
                        resample.resample_apply.launches)
            if launches != expect:
                raise AssertionError(f"(K1, resample-apply) launches "
                                     f"{launches} for the {label} score")
            check_finite(f"the {label} score", f, ll)
            stats.append(f.double())
        f, g = stats
        zval = (f.mean(0) - g.mean(0)) / torch.sqrt(
            f.var(0) / C_X + g.var(0) / C_X + 1e-18)
        phase("16 cross-route", f"{label}: fused vs unfused score, T={T_X} "
              f"N={N} over {C_X} chains each: z per component "
              f"{[round(float(v), 3) for v in zval]}")
        if not bool((zval.abs() < 5).all()):
            raise AssertionError(f"the fused {label} score is off the "
                                 f"unfused one: z = {zval}")

    # the SVJM oracle: at pJ = 1e-6 (the projection's floor) its shared
    # statistic components equal the SVM's on the same first normals
    C_O, T_O = 1024, 60
    svm_p = svm.from_scalars(0.9, 0.5, 1.0, device=dev)
    svjm_p = svjm.from_scalars(0.9, 0.5, 1.0, 1e-6, 2.0, device=dev)
    z0 = torch.randn((C_O, 2, N), generator=gen, device=dev)
    normals = torch.randn((C_O, T_O, 2, N), generator=gen, device=dev)
    xi = torch.rand((C_O, T_O), generator=gen, device=dev)
    window = ys[:T_O, 0].expand(C_O, T_O)
    ones = torch.ones((C_O, T_O), device=dev)
    pm = torch.zeros((C_O,), device=dev)
    pv = svm.stationary_variance(svm_p).expand(C_O)
    outs = []
    for mod, p_o, Z in ((svm, svm_p, 1), (svjm, svjm_p, 2)):
        rows = type(p_o)(*[x.expand((C_O,) + x.shape[1:]).contiguous()
                           for x in vars(p_o).values()])
        stat, _ = fused_pf.fused_pf_score(
            mod.FUSED, rows, window, ones, z0[:, :Z], normals[:, :, :Z], xi,
            pm, pv)
        outs.append(stat[:, :3].double())
    # Its proposal is sqrt(1/lqinv^2 + 0) z, the SVM's z / lqinv: the two
    # differ in the last bit, which flips the odd ancestor at a CDF
    # near-tie, so chains agree in law, not bit for bit.
    g_s, g_j = outs
    rel = ((g_j - g_s).abs() / (1.0 + g_s.abs())).amax(1)
    zval = (g_j.mean(0) - g_s.mean(0)) / torch.sqrt(
        g_j.var(0) / C_O + g_s.var(0) / C_O)
    close = float((rel <= 1e-3).float().mean())
    phase("16 SVJM oracle", f"pJ=1e-6 vs the SVM, T={T_O} N={N} over {C_O} "
          f"chains on shared first normals: z of [grad_LRinv, grad_LQinv, "
          f"grad_A] {[round(float(v), 3) for v in zval]}; chains within "
          f"1e-3 (relative to 1 + |SVM|) {close:.2%}, median relative "
          f"difference {float(rel.median()):.3e}")
    if not bool((zval.abs() < 5).all()):
        raise AssertionError(f"SVJM at pJ=1e-6 is off the SVM: z = {zval}")
    del z0, normals, outs

    # 17. the valid gate and the Seq samplers
    n_seq = 8
    lengths = torch.randint(200, 1001, (n_seq,), generator=gen,
                            device=dev).tolist()
    seqs = {m: [registry.get_model(m).generate_data(gen, truth, T_i)[0]
                for T_i in lengths]
            for m, truth in (("svm", svm.from_scalars(0.9, 0.5, 1.0,
                                                         device=dev)),
                                ("garch", garch_truth),
                                ("svjm", svjm_truth))}
    T_max = max(lengths)
    phase("17 seq data", f"{n_seq} sequences per model, lengths {lengths}")

    # K1 with vs on buffered windows with padded tails of 0-30 steps (a
    # check of the gate alone: no path launches this shape) ...
    vg_err = 0.0
    for seeded in (False, True):
        args = window_inputs(gen, C_BENCH, ys, svm, subsequence, buffered)
        t_valid = torch.randint(W - 30, W + 1, (C_BENCH, 1), generator=gen,
                                device=dev)
        vs = (torch.arange(W, device=dev) < t_valid).float()
        args = args[:4] + ((args[4] * vs).contiguous(), args[5])
        sd = None
        if seeded:
            sd = torch.randint(-2 ** 63, 2 ** 63 - 1, (C_BENCH,),
                               generator=gen, dtype=torch.int64, device=dev)
            args = args[:2] + (None,) + args[3:]
        what = ("valid gate, " + ("in-kernel" if seeded else "host")
                + " normals, ")
        err, _ = check_exact(svm.FUSED, args, sd, "17 valid gate", what,
                             vs=vs)
        vg_err = max(vg_err, err)
        free = fused_pf.fused_window(svm.FUSED, *args, seeds=sd)
        gated = fused_pf.fused_window(svm.FUSED, *args, seeds=sd, vs=vs)
        full_rows = (t_valid[:, 0] == W)
        same = (gated == free).all(1)
        phase("17 valid gate", f"{what}chains with no padding equal the "
              f"ungated kernel: {bool(same[full_rows].all())}; padded "
              f"chains that differ from it: "
              f"{float((~same[~full_rows]).float().mean()):.2%}")
        if not bool(same[full_rows].all()) or bool(same[~full_rows].all()):
            raise AssertionError("the valid gate is not applied as set")
        del free, gated, args
    # ... and on the inputs the Seq score builds for the Seq fits below:
    # the SGLD setting's window (W = 16 + 2 * 4, no gate; 8192 rows) and
    # the LD setting's full sequences (W = T_max, gated; 1024 chains x 8
    # sequences), each checked bitwise, then timed and bounded there
    sgld_kw = dict(N=N, subsequence_length=16, buffer_length=4,
                   num_sequences=1, resampler="systematic", rng="kernel")
    ld_kw = dict(N=N, subsequence_length=-1, resampler="systematic",
                 rng="kernel")
    seq_cls = {"svm": samplers.SeqSVMSampler,
               "garch": samplers.SeqGARCHSampler,
               "svjm": samplers.SeqSVJMSampler}
    seq_k1 = {}
    for name_k, model_name, mod, C, skw in (
            ("svm_rng_kernel_seq", "svm", svm, C_BENCH, sgld_kw),
            ("garch_optimal_rng_kernel_seq", "garch", garch, C_BENCH,
             sgld_kw),
            ("svjm_rng_kernel_seq", "svjm", svjm, C_BENCH, sgld_kw),
            ("svm_valid_gate_rng_kernel", "svm", svm, 1024, ld_kw)):
        smp = seq_cls[model_name](seqs[model_name])
        score = smp._make_score(smp._score_config(**skw), None, **skw)
        model = score.fused_model
        draws = score.draw(gen, C, dev)
        rows = random_params(mod, C * score.rows_per_chain)
        window, step_w, _, vs = score._layout(draws, smp.observations)
        pm, pv = smp.model.prior_mean_var(rows)
        x0 = fused_pf.initial_state(model, draws.z0, pm, pv)
        args = (model.pack_params(rows).contiguous(), x0.contiguous(), None,
                window[..., 0].contiguous(), step_w.contiguous(), draws.u)
        sd = draws.seeds
        err, plain = check_exact(model, args, sd, "17 seq K1",
                                 f"{name_k}, the Seq score's inputs, ",
                                 vs=vs)
        ms = cuda_ms(lambda: fused_pf.fused_window(model, *args, seeds=sd,
                                                   vs=vs), 3)
        R, Wk = args[3].shape
        nbytes = k1_bytes(model, args, sd) + (0 if vs is None
                                              else 4 * vs.numel())
        active = None if vs is None else int((vs > 0).sum())
        bnd, by = bound_ms(nbytes, k1_ops(
            R, model.body, rng=True, Z=model.noise_dims, steps=Wk,
            active=active))
        seq_k1[name_k] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=bnd, bound_by=by)
        phase("17 seq K1", f"{name_k}: one window call, {R} rows N={N} "
              f"W={Wk} ({'all' if vs is None else active} row-steps run "
              f"part 4): kernel {ms:.3f} ms, plain {plain:.3f} ms, bound "
              f"{bnd:.3f} ms by {by} ({card})")
        del args, draws, x0, window, step_w, vs
    seq_k1["svm_valid_gate_rng_kernel"]["max_abs_err"] = max(
        vg_err, seq_k1["svm_valid_gate_rng_kernel"]["max_abs_err"])
    packed, lengths_np = samplers.pack_sequences(seqs["svm"])
    packed = packed.to(dev)

    # padding invariance of the Seq score on both routes
    for route, okw, C_P in (("fused", dict(resampler="systematic",
                                           rng="kernel"), 256),
                            ("unfused", dict(resampler="multinomial"), 32)):
        cfg = sgmcmc.PFScoreConfig(n_particles=N, subsequence_length=-1,
                                   **okw)
        score = sgmcmc.make_seq_pf_score_fn(
            svm.KERNEL, svm.grad_statistic, 3, svm.unpack_grad, cfg,
            lengths_np, prior_mean_var_fn=registry.SVM.prior_mean_var,
            fused_model=svm.FUSED)
        rows = svm.SVMParams(A=torch.full((C_P, 1, 1), 0.8, device=dev),
                             LQinv_vec=torch.full((C_P, 1), 1.2, device=dev),
                             LRinv_vec=torch.full((C_P, 1), 0.9, device=dev))
        draws = score.draw(gen, C_P, dev)
        outs = []
        for pad in (0.0, -12.25):
            obs = packed.clone()
            for i, T_i in enumerate(lengths_np):
                obs[i, T_i:] = pad
            reset_counts(fused_pf, resample, philox)
            g, ll = score(gen, rows, obs, draws)
            outs.append(torch.cat([g.A[:, 0], g.LQinv_vec, g.LRinv_vec,
                                   ll[:, None]], 1))
        launches = (fused_pf.fused_window.launches,
                    resample.resample_apply.launches)
        same = bool(torch.equal(outs[0], outs[1]))
        check_finite(f"the padded Seq score ({route})", outs[0])
        phase("17 padding", f"{route} route ({okw}), {C_P} chains x "
              f"{n_seq} sequences, W={T_max}: padding 0 and -12.25 give "
              f"bitwise equal scores {same}; (K1, resample-apply) "
              f"launches {launches}")
        if not same or launches[0 if route == "fused" else 1] == 0:
            raise AssertionError(f"the {route} Seq score depends on its "
                                 f"padding, or did not run its kernel")
        del draws, outs

    # the Seq fits: the exchange-rate demo's SGLD and LD settings
    seq_launches = {}
    for name_k, model_name, start_p in (
            ("svm_rng_kernel_seq", "svm", svm.from_scalars(0.5, 1.0, 2.0)),
            ("garch_optimal_rng_kernel_seq", "garch", garch_start),
            ("svjm_rng_kernel_seq", "svjm", svjm_start)):
        seq_launches[name_k] = fit_pair(
            seq_cls[model_name], seqs[model_name], start_p,
            (ITERS, 0, ITERS), "17 seq fit", **sgld_kw)[0]
    ld_launches = fit_pair(samplers.SeqSVMSampler, seqs["svm"],
                           svm.from_scalars(0.5, 1.0, 2.0),
                           (ITERS, 0, ITERS), "17 seq fit", C=1024, **ld_kw)[0]

    main_shape = ra_times["K2b"]
    k1_tpu = "sgmcmc_tpu/ops/pallas/fused_pf.py:121"

    def k1_src(body, *extra):
        """The sources of K1 on one body."""
        model = body.split("_")[0]
        return " + ".join(f"sgmcmc_tpu_torch/csrc/{f}" for f in (
            "fused_window.cuh", f"fused_window_{body}.cu",
            f"{model}_body.cuh") + extra)

    def k1_entry(name_k, body, replaces, launches, numbers, *extra):
        return {"name": f"fused_window_{name_k}", "route": "cuda",
                "source": k1_src(body, *extra),
                "replaces": k1_tpu + replaces, "launches": launches,
                **numbers, "library_ms": None}

    def body_of(name_k):
        return name_k.replace("_rng_kernel", "").replace("_seq", "")

    def body_lines(name_k):
        return {"garch": " (sgmcmc_tpu/models/garch.py:276-346)",
                "svjm": " (sgmcmc_tpu/models/svjm.py:442-503)",
                "svm": " (rng='kernel', _box_muller :109)"}[
                    name_k.split("_")[0]]

    print(json.dumps({"kernels": [
        k1_entry("svm", "svm", "", k1_launches, dict(
            max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
            bound_ms=k1_bound, bound_by=k1_by)),
        k1_entry("svm_rng_kernel", "svm", " (rng='kernel', _box_muller :109)",
                 rng_launches, dict(
                     max_abs_err=rng_err, ms=rng_ms, plain_ms=rng_plain,
                     bound_ms=rng_bound, bound_by=rng_by), "philox.cuh"),
        k1_entry("svm_ess_gate", "svm", " (ess_threshold, :190-201)",
                 ess_launches, dict(
                     max_abs_err=ess_err, ms=ess_ms, plain_ms=ess_plain,
                     bound_ms=ess_bound, bound_by=ess_by)),
        *[k1_entry(f"{body}_rng_kernel", body,
                   " (sgmcmc_tpu/models/lgssm.py:663-729)", lg_launches[body],
                   lg[body], "philox.cuh")
          for body in ("lgssm_optimal", "lgssm_prior")],
        *[k1_entry(name_k, body_of(name_k), body_lines(name_k),
                   new_launches[name_k], new_k1[name_k],
                   *(("philox.cuh",) if "rng" in name_k else ()))
          for name_k in new_launches],
        # the same variants at the Seq SGLD fits' window
        *[k1_entry(name_k, body_of(name_k), body_lines(name_k)
                   + "; Seq score, sgmcmc_tpu/inference/sgmcmc.py:272-281",
                   seq_launches[name_k], seq_k1[name_k], "philox.cuh")
          for name_k in seq_launches],
        k1_entry("svm_valid_gate_rng_kernel", "svm", " (valid_gate, :342-352)",
                 ld_launches, seq_k1["svm_valid_gate_rng_kernel"],
                 "philox.cuh"),
        {"name": "resample_apply", "route": "cuda",
         "source": "sgmcmc_tpu_torch/csrc/resample_apply.cu",
         "replaces": "sgmcmc_tpu/ops/pallas/resample.py:178 (K2a), "
                     ":232 (K2b), :31 (K3)",
         "launches": ra_launches[1024], "max_abs_err": ra_err,
         **main_shape},
        {"name": "philox_normals", "route": "cuda",
         "source": "sgmcmc_tpu_torch/csrc/philox_normals.cu",
         "replaces": "scripts/tpu_probe_kernel_rng.py:15",
         "launches": ph_launches, "max_abs_err": ph_err, "ms": ph_ms,
         "plain_ms": ph_plain, "bound_ms": ph_bound, "bound_by": ph_by,
         "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
