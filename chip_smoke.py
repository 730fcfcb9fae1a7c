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
 18. K1's frame against its plain version at C=256, bitwise (NaN equal to
     NaN), with host and in-kernel normals: at N = 1000, 100, 777, 4096 and
     the largest N the card's shared memory allows; on degenerate weights
     (every particle's log-weight -inf after an observation of 1e30), with
     and without the ESS gate; and with the valid gate on interior invalid
     runs (invalid from t=0, in the middle, at the end), also with the ESS
     gate and lambda = 0.95.
 19. the LGSSM's exact-message kinds and blocked Gibbs (plain PyTorch: no
     kernel lies on this path, and it must launch none): the float64
     windowed marginal gradient and FFBS on 8192 rows of buffered windows
     (edge and interior), on the card and on the CPU with the same inputs
     and draws (normwise relative difference at most 1e-9); the Fisher
     identity on the card, the complete-data score's mean over 8192 FFBS
     draws on an edge window (start 0, B > 0, where the pre-window
     completion matters) within |z| < 5 of the marginal gradient;
     ``LGSSMSampler.fit_scan`` with ``kind="marginal"`` and
     ``kind="complete"`` at 8192 chains, S=40, B=10, T=1000, and
     ``SeqLGSSMSampler`` with ``kind="marginal"`` on the Seq fits'
     lengths (S=16, B=4, one sequence per gradient), 20 timed iterations
     each, with 0 launches of K1 and of the resample-apply kernel;
     recovery of A from 0.5 toward 0.9 by marginal-kind SGLD (256 chains,
     200 iterations) and by 10 Gibbs sweeps of 1024 chains at T=1000,
     with the time per sweep; and a systematic SVM fit at N=8192, beyond
     K1's shared memory, which must take the unfused route (0 K1
     launches) while N=4096 still launches K1.
 20. PaRIS (plain PyTorch around the resample-apply kernel, which it
     launches once per window step on the particles alone, K = 1): the
     kernel against its plain version, bitwise, at C=8192, N=100 and at
     C=64, N=1000, then timed; ``PARIS_100`` of the JAX package's
     experiment grid (``SVMSampler.fit_scan("SGLD", pf="paris", N=100,
     S=40, B=10)`` at 8192 chains, 20 timed iterations: 20 * 60
     resample-apply launches, no K1); the exchange-rate demo's LD leg
     (N=1000, the whole series of T=1000, 64 chains, 2 iterations: 1000
     launches an iteration) and its Seq LD leg (``SeqSVMSampler``, every
     sequence of ``SEQ_LENGTHS`` whole, through the valid gate, 16 chains,
     1 iteration), with their peak memory; PaRIS's LGSSM score (1024
     chains, T=16, N=256, full window) within |z| < 5 of the Kalman
     gradient, ``paris_ar`` within |z| < 5 of ``paris`` with its mean
     accept-reject rounds, and the cost of reading whether every lane has
     accepted (every 8 rounds, every round, never); PaRIS on the card
     against the CPU on the same draws and backward indices (rtol = atol =
     1e-4; at most 2% of the chains off it, where a forward resampling
     choice flips at a CDF near-tie), and one rewiring step on the same
     carry (every entry within rtol = atol = 1e-4) and backward draw (at
     most 0.1% of lanes flipped).
 21. the steppers on K1's path (systematic, ``rng="kernel"``, 8192
     chains, N=1024, S=40, B=10, T=1000, 20 timed iterations each after a
     2-iteration warm-up): SGLD, SGRLD and SGRD on ``LGSSMSampler``, SGLD,
     SGD, ADAGRAD (a second call continuing its state) and SGLD-CV on
     ``SVMSampler``, one K1 launch per gradient (two per SGLD-CV
     iteration); ``fit_scan_chunked(num_iters=10, chunk_iters=4)`` at 256
     chains bitwise equal to one ``fit_scan(num_iters=10)`` from the same
     seed; ``fit_timed(chunk_iters=50)`` for 2 s; recovery of A from 0.5
     toward 0.9 by SGRLD on the LGSSM (256 chains, 200 iterations).
 22. the predict surface (plain PyTorch around the resample-apply kernel,
     which resamples each particle's elementwise statistic with it, rows
     of K = D + T * dim floats): the kernel against its plain version,
     bitwise, at the wide rows ``PREDICT_SHAPES`` (the SVM's smoothed
     latent at T=1000 with N=1000 and N=10000, the Seq predict's padded
     rows, GARCH's y), timed there (device time in a CUDA graph and one
     host call) beside ``searchsorted`` + ``gather`` and the bound; every
     predict call of the slice on one chain, timed, with its launches (one
     resample-apply a step, K1 never) and peak memory: ``SVMSampler``
     ``predict`` at T=1000, N=1000 smoothed, filtered (lag 0), fixed-lag
     (lag 5) and ``target="y"``, at N=10000, GARCH's ``target="y"``,
     ``predictive_loglikelihood(5)`` of the four models, ``SeqSVMSampler``
     ``predict`` / ``predictive_loglikelihood`` on ``SEQ_LENGTHS``, the
     LGSSM's exact predict (float64: moments, FFBS and marginal draws,
     ``simulate_distr``, ``simulate``); the LGSSM's particle predict
     (smoothed, filtered, fixed-lag; 32 rows of T=200, N=1000) within |z|
     < 5 of the Kalman moments at every t; the exact predict functions on
     the card against the CPU on shared normals (normwise relative
     difference at most 1e-9); and the SVM's Laplace / EP and the SVJM's
     EP / EP-avg proposals through ``fit_scan("SGLD")`` (multinomial,
     N=1000, 8192 chains, 2 iterations: one resample-apply launch a
     window step, no K1), with their steps/s.
 23. the vector LGSSM (n = m = 2, the model of tests/test_pf_vs_kalman.py;
     plain PyTorch around the resample-apply kernel, K1 being the scalar
     model's): the kernel against its plain version, bitwise, at the
     vector fit's carry (C=8192, N=1024, K = 2 + 14 = 16) and the vector
     smoothed predict's rows (C=1, N=1000, K = 2 + 10 * 1000), timed
     there beside ``searchsorted`` + ``gather`` and the bound;
     ``Sampler(get_model("lgssm", n=2, m=2)).fit_scan("SGLD")`` at 8192
     chains, N=1024, S=40, B=10, T=1000, multinomial and systematic, 20
     timed iterations each (1200 resample-apply launches, no K1), with
     steps/s and peak memory; the PF score (1024 chains, T=16, full
     window) within |z| < 5 of the Kalman gradient; the windowed marginal
     and complete gradients and a Gibbs sweep in float64 on the card
     against the CPU on shared draws (normwise relative difference at
     most 1e-9), the exact-kind fits and Gibbs sweeps finite with no
     launch; SGRLD (the general preconditioner) finite; the PF smoothed
     means (32 rows of T=200, N=1000) within |z| < 5 of the Kalman means;
     one T=1000 predict call with its 1000 launches;
 24. the evaluation layer on phase 23's model: the IMQ KSD of a recorded
     trace (exact scores) on the card against the CPU (relative
     difference at most 1e-9), by ``imq_ksd`` and by ``compute_ksd`` over
     the trace's list of parameters as the card holds them (every
     field), ``convergence_summary`` of the stacked
     trace, ``fit_evaluate`` with a ``SamplerEvaluator`` for 3 s of
     sampler time (rows kept as dicts: this script imports neither pandas
     nor matplotlib) and a checkpoint round trip (parameters and the
     generator's state).
 25. the experiments layer (plain PyTorch around the kernels): the
     resample-apply kernel against its plain version, bitwise, at the
     gradient-error figure's truth (C=4, N=100000, K=4: beyond its
     shared-memory CDF) and the driver's single-chain fits (C=1, N=1000,
     K=4), timed beside ``searchsorted`` + ``gather`` and the bound; K1 at
     the exchange-rate demo's SGLD window (C=1, N=1000, W=24), bitwise,
     timed; the experiment driver on the SVM at T=1000 (setup, every fit
     of the default grid with its seconds and launches, a ``--num_chains
     8192`` fit with exactly 20 x 60 resample-apply launches and no K1,
     eval, KSD in blocks and as a loop, process_out with pandas and
     matplotlib not loaded) and on the LGSSM (Gibbs, the Kalman score, KS
     tests); a driver fit stopped at
     its checkpoint and resumed bitwise equal to the uninterrupted one
     (SGLD and ADAGRAD, whose accumulator the resume state carries, at 1
     and 3 chains); the gradient-error
     figure at ``run``'s defaults (its bias falling from B=0 to B=20 at
     N=1000; the LGSSM's exact truth on the card against the CPU); the
     demo on synthetic segments (``--mode single`` and ``subset``,
     ``save_params``, ``calculate_ksd``) and its SGLD-against-LD KSD
     comparison (LD's phi KSD below half SGLD's).
 26. the HMM family at the experiment driver's setting (GaussHMM and
     ARPHMM, K=2, m=1, p=1, T=1000, float64; plain PyTorch, no kernel:
     every call checks 0 launches of K1 and resample-apply): the marginal
     log-likelihood, its gradient, the posterior marginals and the lagged
     marginals on the card against the CPU (64 chains, K=2, m=1, T=1000
     and K=3, m=2, T=200; normwise relative difference at most 1e-9);
     ``fit_scan("SGLD")`` at 8192 chains on the exact messages (S=16,
     B=4 and S=40, B=10) and the complete kind, ``sample_sgld_scir`` at
     8192 chains (every pi finite and positive; SCIR's noncentral
     chi-square draws at epsilon 0.1 finite and >= 0 for every chain) and
     Gibbs sweeps of 1024 chains, with their steps/s or seconds a sweep;
     Gibbs recovery of mu / D (after 20 sweeps of 1024 chains, the
     chains' median within 4 posterior standard deviations of the truth);
     FFBS marginals against the smoothed ones (chi-square over 8192
     paths, p > 1e-3); the Seq samplers on
     ``SEQ_LENGTHS``; ``predict`` at T=1000 with ``metric_compare_z``;
     the driver's HMM grid for the GaussHMM (setup at T=1000, GIBBS, SGLD
     at B=0 and 4 and SCIR for 2 iterations, eval, KSD, KS).
 27. the parallel-in-time messages and the switching LDS (float64, plain
     PyTorch, no kernel: every call checks 0 launches): the associative
     scans (``parallel_*`` of the LGSSM at n = m = 1 and 2 and of the
     GaussHMM: log-likelihood, filtered and smoothed moments, the autograd
     score, the forward messages; 64 chains, T=1000) on the card against
     the CPU (normwise relative difference at most 1e-9) and against the
     sequential functions on the card (at most 1e-8); their wall time and
     device operations beside the sequential log-likelihood's at C=1 and
     1024; the SLDS's x | z messages, x FFBS, Gibbs sweep and windowed
     complete score on the card against the CPU on shared draws (at most
     1e-9, the sweep's z paths equal); a Gibbs sweep of 1024 chains and
     complete-data SGLD at 8192 chains (S=16, B=4, the driver grid's
     latent sweeps) at T=1000; the distributional anchor of
     tests/test_slds.py chain-batched (Gibbs against full-series complete
     SGLD from the truth at T=200: A_k and LQinv_k shifts below 0.5 sd,
     sd ratios in 0.5-1.6); the driver's SLDS grid (setup at T=1000,
     GIBBS and SGLD_COMPLETE, eval, --num_chains 2 raising).
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
# The lengths of the Seq fits' 8 sequences (phase 17): 200-1000 steps, so
# that the LD fit runs K1 at W = 941 with 68% of its row-steps valid;
# scripts/time_fused_window.py times K1 at that shape too.
SEQ_LENGTHS = (508, 579, 383, 763, 807, 941, 760, 402)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def window_inputs(gen, C, ys, svm, subsequence, buffered, n=N):
    """Kernel inputs for C chains of n particles on random buffered windows
    of ``ys``."""
    dev = ys.device
    u = torch.rand((C, 3), generator=gen, device=dev)
    params = svm.SVMParams(A=(0.5 + 0.45 * u[:, 0]).reshape(C, 1, 1),
                           LQinv_vec=(0.3 + 1.2 * u[:, 1:2]) ** -0.5,
                           LRinv_vec=(0.5 + 1.5 * u[:, 2:3]) ** -0.5)
    start = subsequence.sample_start(gen, S, T, C, device=dev)
    win = subsequence.buffered_window(start, S, B, T)
    window = subsequence.slice_window(ys, win.window_start, W)[..., 0]
    step_w, _ = buffered.window_weights(win.t1, win.tL, win.weights, W)
    z0 = torch.randn((C, 1, n), generator=gen, device=dev)
    x0 = torch.sqrt(svm.stationary_variance(params))[:, None, None] * z0
    normals = torch.randn((C, W, 1, n), generator=gen, device=dev)
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


def graph_ms(fn, reps=200, rounds=5):
    """Device time per call of fn: a CUDA graph of reps calls, replayed
    and timed by CUDA events (no host launch cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[rounds // 2]


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


def exact_phase(dev, card):
    """Phase 19 on ``dev`` (which may be the CPU for a rehearsal at sizes
    set through the module's constants)."""
    from sgmcmc_tpu_torch.inference import samplers
    from sgmcmc_tpu_torch.models import lgssm, svm
    from sgmcmc_tpu_torch.models.base import params_map
    from sgmcmc_tpu_torch.ops import kalman
    from sgmcmc_tpu_torch.ops.cuda import fused_pf, resample
    from sgmcmc_tpu_torch.ops.subsequence import subsequence_weights
    cuda = dev.type == "cuda"
    f64 = torch.float64
    C, T_len, iters, n_fisher = C_BENCH, T, ITERS, C_BENCH
    rec = (C_CHECK, 200)                        # chains, iterations
    gibbs = (1024, 10)                          # chains, timed sweeps
    # (N, takes K1), chains, iterations: N=8192 is beyond every body's
    # shared memory at W=60, N=4096 within it
    route = (((8192, False), (4096, True)), C_CHECK, 2)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def launches():
        return (fused_pf.fused_window.launches,
                resample.resample_apply.launches)

    gen = torch.Generator(device=dev).manual_seed(19)
    truth = lgssm.from_scalars(0.9, 0.5, 1.0, device=dev)
    start_p = lgssm.from_scalars(0.5, 1.0, 2.0, device=dev)
    ys, _ = lgssm.generate_data(gen, truth, T_len)

    # (a) the float64 oracle paths on the card against the CPU
    R = C
    u = torch.rand((R, 3), generator=gen, dtype=f64, device=dev)
    rows = lgssm.LGSSMParams(
        A=(0.5 + 0.45 * u[:, 0])[:, None, None],
        C=torch.ones((R, 1, 1), dtype=f64, device=dev),
        LQinv_vec=((0.3 + 1.2 * u[:, 1]) ** -0.5)[:, None],
        LRinv_vec=((0.5 + 1.5 * u[:, 2]) ** -0.5)[:, None])
    start = torch.randint(0, T_len - S + 1, (R,), generator=gen, device=dev)
    start[:R // 8] = 0                              # edge windows
    start[R // 8:R // 4] = T_len - S

    def windows(start):
        idx = start[:, None] - B + torch.arange(W, device=dev)
        return (ys.double()[torch.clamp(idx, 0, T_len - 1)],
                ((idx >= 0) & (idx < T_len)).to(f64),
                subsequence_weights(start, S, T_len, dtype=f64))
    win, valid, weights = windows(start)
    z = torch.randn((R, W, 1), generator=gen, dtype=f64, device=dev)

    def oracle(p, win, valid, weights, z):
        g, ll = lgssm.windowed_marginal_gradient(p, win, valid, weights, B,
                                                 S)
        x = kalman.ffbs_sample(win, p.A, p.C, p.LQinv, p.LRinv,
                               lgssm.default_forward_message(p), valid=valid,
                               normals=z)
        return [g.A, g.C, g.LQinv_vec, g.LRinv_vec, ll, x]

    times = {}
    for where, args in (("card", (rows, win, valid, weights, z)),
                        ("cpu", (params_map(lambda x: x.cpu(), rows),
                                 win.cpu(), valid.cpu(), weights.cpu(),
                                 z.cpu()))):
        sync()
        t0 = time.perf_counter()
        out = oracle(*args)
        sync()
        times[where] = (time.perf_counter() - t0, out)
    rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
              for a, b in zip(times["card"][1], times["cpu"][1]))
    check_finite("the float64 oracle paths", *times["card"][1])
    phase("19 exact card-cpu", f"float64 windowed_marginal_gradient + "
          f"ffbs_sample on {R} rows (S={S} B={B}, 1/4 edge windows): max "
          f"normwise relative |{dev.type} - CPU| = {rel:.3e} (bound 1e-9); "
          f"{times['card'][0]:.3f} s on {dev.type}, {times['cpu'][0]:.3f} s "
          f"on the CPU")
    if not rel <= 1e-9:
        raise AssertionError(f"the card and the CPU differ: {rel}")
    del times, win, valid, weights, z, rows

    # (b) the Fisher identity on an edge window, where the completion
    # before the subsequence stands in for the missing buffer
    p1 = params_map(lambda x: x.double(), truth)
    w1, v1, wt1 = windows(torch.zeros((1,), dtype=torch.int64, device=dev))
    gm, _ = lgssm.windowed_marginal_gradient(p1, w1, v1, wt1, B, S)
    rows = params_map(lambda x: x.expand((n_fisher,) + x.shape[1:]), p1)
    gc, llc = lgssm.windowed_complete_gradient(
        rows, w1.expand(n_fisher, -1, -1), v1.expand(n_fisher, -1),
        wt1.expand(n_fisher, -1), B, S, generator=gen)
    f = torch.stack([gc.A[:, 0, 0], gc.C[:, 0, 0], gc.LQinv_vec[:, 0],
                     gc.LRinv_vec[:, 0]], 1)
    exact = torch.stack([gm.A[0, 0, 0], gm.C[0, 0, 0], gm.LQinv_vec[0, 0],
                         gm.LRinv_vec[0, 0]])
    check_finite("the complete-data scores", f, llc)
    zval = (f.mean(0) - exact) / (f.std(0) / n_fisher ** 0.5)
    phase("19 Fisher identity", f"windowed_complete_gradient over "
          f"{n_fisher} FFBS draws at start 0 (B={B}, S={S}) against "
          f"windowed_marginal_gradient: z [A, C, LQinv, LRinv] = "
          f"{[round(float(v), 3) for v in zval]}; exact "
          f"{[round(float(v), 4) for v in exact]}")
    if not bool((zval.abs() < 5).all()):
        raise AssertionError(f"the complete kind is off the marginal "
                             f"gradient: z = {zval}")

    # (c) the three fits at full width
    seq_lengths = SEQ_LENGTHS
    seqs = [lgssm.generate_data(gen, truth, T_i)[0] for T_i in seq_lengths]
    ekw = dict(subsequence_length=S, buffer_length=B)
    for label, make, fkw in (
            (f"LGSSMSampler kind='marginal' S={S} B={B} T={T_len}",
             lambda: samplers.LGSSMSampler(observations=ys, device=dev,
                                           seed=7),
             dict(ekw, kind="marginal")),
            (f"LGSSMSampler kind='complete' S={S} B={B} T={T_len}",
             lambda: samplers.LGSSMSampler(observations=ys, device=dev,
                                           seed=7),
             dict(ekw, kind="complete")),
            (f"SeqLGSSMSampler kind='marginal' S=16 B=4 on "
             f"{len(seq_lengths)} sequences of {min(seq_lengths)}-"
             f"{max(seq_lengths)} steps",
             lambda: samplers.SeqLGSSMSampler(seqs, num_sequences=1,
                                              device=dev, seed=7),
             dict(kind="marginal", subsequence_length=16, buffer_length=4))):
        smp = make()
        smp.parameters = start_p
        for n_it in (2, iters):                     # warm-up, then timed
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            fused_pf.fused_window.launches = 0
            resample.resample_apply.launches = 0
            t0 = time.perf_counter()
            _, aux = smp.fit_scan("SGLD", num_iters=n_it, epsilon=0.1,
                                  num_chains=C, record="none",
                                  return_aux=True, **fkw)
            float(aux[:, -1].sum())                 # synchronises
            dt = time.perf_counter() - t0
        p = smp.parameters
        check_finite(label, aux, *[getattr(p, f) for f in
                                   p.__dataclass_fields__])
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        phase("19 exact fit", f"{label}: fit_scan SGLD C={C}: "
              f"{iters} iterations in {dt:.3f} s, "
              f"{C * iters / dt:.1f} aggregate steps/s, (K1, "
              f"resample-apply) launches {launches()}, peak "
              f"{peak / 2 ** 30:.3f} GiB ({card})")
        if launches() != (0, 0):
            raise AssertionError(f"{label} launched a kernel: {launches()}")
        del smp

    # (d) recovery by the marginal kind and by Gibbs
    smp = samplers.LGSSMSampler(observations=ys, device=dev, seed=8)
    smp.parameters = start_p
    trace = smp.fit_scan("SGLD", num_iters=rec[1], epsilon=0.05,
                         num_chains=rec[0], record="all", kind="marginal",
                         **ekw)
    a_mean = float(trace.A[:, -50:].mean())
    phase("19 exact recovery", f"kind='marginal', {rec[0]} chains: "
          f"chain-mean A over the last 50 of {rec[1]} iterations "
          f"{a_mean:.4f} (start 0.5, truth 0.9)")
    if not abs(a_mean - 0.9) < abs(a_mean - 0.5):
        raise AssertionError(f"A did not move toward 0.9: {a_mean}")
    C_g, sweeps = gibbs
    smp = samplers.LGSSMSampler(observations=ys, device=dev, seed=9)
    smp.parameters = params_map(
        lambda x: x.expand((C_g,) + x.shape[1:]).contiguous(), start_p)
    smp.sample_gibbs()                              # warm-up
    fused_pf.fused_window.launches = 0
    resample.resample_apply.launches = 0
    sync()
    t0 = time.perf_counter()
    for _ in range(sweeps):
        p = smp.sample_gibbs()
    sync()
    per_sweep = (time.perf_counter() - t0) / sweeps
    check_finite("the Gibbs chains", p.A, p.LQinv_vec, p.LRinv_vec)
    a_mean = float(p.A.mean())
    phase("19 Gibbs", f"sample_gibbs on {C_g} chains, T={T_len}: "
          f"{per_sweep:.4f} s per sweep ({C_g / per_sweep:.1f} chain-sweeps"
          f"/s), (K1, resample-apply) launches {launches()}; chain-mean A "
          f"after {sweeps + 1} sweeps {a_mean:.4f} (start 0.5, truth 0.9) "
          f"({card})")
    if not abs(a_mean - 0.9) < abs(a_mean - 0.5) or launches() != (0, 0):
        raise AssertionError(f"Gibbs: A {a_mean}, launches {launches()}")
    del smp, trace

    # (e) a systematic fit beyond K1's shared memory takes the unfused
    # route; one below it still takes K1
    ys_s, _ = svm.generate_data(gen, svm.from_scalars(0.9, 0.5, 1.0,
                                                      device=dev), T_len)
    n_routes, C_r, it_r = route
    for n, on_k1 in n_routes:
        smp = samplers.SVMSampler(observations=ys_s, device=dev, seed=10)
        fused_pf.fused_window.launches = 0
        resample.resample_apply.launches = 0
        _, aux = smp.fit_scan("SGLD", num_iters=it_r, num_chains=C_r,
                              record="none", return_aux=True, N=n,
                              resampler="systematic", **ekw)
        check_finite(f"the systematic fit at N={n}", aux)
        got = launches()
        phase("19 route", f"SVMSampler.fit_scan systematic N={n}, {C_r} "
              f"chains, {it_r} iterations: (K1, resample-apply) launches "
              f"{got}")
        want = ((it_r, 0) if on_k1 else (0, it_r * W)) if cuda else (0, 0)
        if got != want:
            raise AssertionError(f"N={n} took the wrong route: {got}")


# Phase 20's and 21's sizes on the card; a CPU rehearsal passes smaller
# ones.  PARIS_100 is an SVM entry of the JAX package's experiment grid
# (sgmcmc_tpu/experiments/driver.py:332-334), the LD legs the exchange-rate
# demo's (demo/exchange_rate/exchange_rate_demo.py:84).
PARIS_SIZES = dict(grid=(C_BENCH, 100, ITERS), ld=(64, 1000, 2),
                   seq=(16, 1000, SEQ_LENGTHS), oracle=(1024, 16, 256),
                   cpu=(64, 256), T=T)
STEPPER_SIZES = dict(C=C_BENCH, N=N, iters=ITERS, chunked=256, timed=2.0,
                     rec=(256, 200), T=T)


# Phase 22: the predict surface.  Its resample-apply calls carry each
# particle's elementwise statistic, rows of K = D + T * dim floats: the
# SVM's smoothed latent at T=1000 with the experiments' eval_N (1000) and
# the plotting default N=10000, the Seq predict's padded rows (one a
# sequence, T_max steps) and GARCH's y (D = dim = 2).
PREDICT_SHAPES = dict(
    predict_svm=(1, 1000, 1 + 3 * T),
    predict_svm_n10000=(1, 10000, 1 + 3 * T),
    predict_seq=(len(SEQ_LENGTHS), 1000, 1 + 3 * max(SEQ_LENGTHS)),
    predict_garch_y=(1, 1000, 2 + 2 * T))
# The wide rows' timing inputs.  Log-weights of spread 0.5 give an ESS of
# exp(-0.25) = 78% of N, a particle filter's on an informative step (2.0
# would leave 2%); multinomial positions then pick 58% of the rows as
# ancestors (at most 1 - 1/e = 63% on equal weights), so the kernel reads
# only those rows of vals.  Copies of vals, used in turn, keep the rows of
# one call out of the card's 50 MB L2 at the next.
WIDE_LOG_WEIGHT_SD, L2_BYTES = 0.5, 50e6


def wide_row_inputs(gen, C, n, K, dev):
    """(pos [C, n], cdf [C, n], copies of vals [C, n, K], the bytes a call
    must move) for resample-apply at a wide row: pos and cdf read once,
    each distinct ancestor's row of vals read once (a row of K >= 64
    floats spans whole 32-byte sectors) and the output written once."""
    from sgmcmc_tpu_torch.ops.cuda import resample
    cdf = resample.weights_cdf(
        WIDE_LOG_WEIGHT_SD * torch.randn((C, n), generator=gen, device=dev))
    pos = torch.rand((C, n), generator=gen, device=dev)
    vals = torch.randn((C, n, K), generator=gen, device=dev)
    copies = max(1, -(-int(2 * L2_BYTES) // (8 * C * n * K)))
    idx = resample.ancestors(pos, cdf)
    rows = sum(int(idx[c].unique().numel()) for c in range(C))
    nbytes = 4 * (pos.numel() + cdf.numel() + rows * K + C * n * K)
    return pos, cdf, [vals] + [vals.clone() for _ in range(copies - 1)], \
        nbytes


# z: (rows, T, N) of the LGSSM's PF-against-Kalman check; fit: (chains, N,
# iterations) of the proposals' fits
PREDICT_SIZES = dict(T=T, N=1000, N_big=10000, seq=SEQ_LENGTHS,
                     z=(32, 200, 1000), fit=(C_BENCH, 1000, 2),
                     shapes=PREDICT_SHAPES)


def predict_phase(dev, card, sizes=PREDICT_SIZES):
    """Phase 22 on ``dev`` (the CPU for a rehearsal at small ``sizes``):
    resample-apply at the predict surface's wide rows, every predict call
    of the slice timed with its launches, the LGSSM's particle predict
    against the Kalman smoother, its exact predict on the card against the
    CPU, and the adaptive proposals' fits.  Returns the report's
    numbers."""
    import numpy as np
    from sgmcmc_tpu_torch.inference import samplers
    from sgmcmc_tpu_torch.models import garch, lgssm, svjm, svm
    from sgmcmc_tpu_torch.models.base import params_map
    from sgmcmc_tpu_torch.ops.cuda import fused_pf, resample
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(22)
    T_len, N_p = sizes["T"], sizes["N"]
    out = {"resample_apply": {}, "launches": {}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # (a) resample-apply at the wide rows, bitwise, then timed in both
    # launches (the tiled one is the kernel before the wide launch): host
    # calls (CUDA events) and the device time alone (a CUDA graph of calls)
    for label, (C, n_part, K) in sizes["shapes"].items():
        pos, cdf, vals_sets, nbytes = wide_row_inputs(gen, C, n_part, K, dev)
        vals = vals_sets[0]
        out_k = resample.resample_apply(pos, cdf, vals)
        out_r = resample.resample_apply_reference(pos, cdf, vals)
        sync()
        same = bool(torch.equal(out_k, out_r))
        row = dict(max_abs_err=float((out_k - out_r).abs().max()))
        msg = ""
        if cuda:
            wide = resample.wide_launch(C, n_part, K, dev)
            tiled_eq = bool(torch.equal(
                resample._launch(pos, cdf, vals, wide=not wide), out_r))
            same = same and tiled_eq

            def rotated(fn):
                """fn over every copy of vals in turn, and the copies."""
                return (lambda: [fn(pos, cdf, v) for v in vals_sets],
                        len(vals_sets))

            def per_call(timer, fn, reps):
                call, k = rotated(fn)
                return timer(call, reps) / k

            reps = max(10, min(200, int(2e8 / (8 * C * n_part * K
                                                 * len(vals_sets)))))
            plain = resample.resample_apply_reference
            bnd, by = bound_ms(nbytes, C * n_part * (n_part.bit_length() + 1))
            # the plain version is the PyTorch call (torch.searchsorted +
            # torch.gather): timed twice
            row.update(
                ms=per_call(graph_ms, resample.resample_apply, reps),
                plain_ms=per_call(graph_ms, plain, reps),
                library_ms=per_call(graph_ms, plain, reps), bound_ms=bnd,
                bound_by=by,
                tiled_ms=per_call(graph_ms, lambda *a: resample._launch(
                    *a, wide=False), reps),
                host_ms=per_call(cuda_ms, resample.resample_apply, reps),
                plain_host_ms=per_call(cuda_ms, plain, reps), wide=wide)
            msg = (f"; {'wide' if wide else 'tiled'} launch; device time per "
                   f"call (CUDA graph, {len(vals_sets)} copies of vals in "
                   f"turn) kernel {row['ms']:.4f} ms, tiled launch "
                   f"{row['tiled_ms']:.4f} ms, plain (searchsorted + gather) "
                   f"{row['plain_ms']:.4f} ms, bound {bnd:.4f} ms by {by} "
                   f"({nbytes / 1e6:.1f} MB, {bnd / row['ms']:.0%} of it); "
                   f"one host call {row['host_ms']:.4f} / "
                   f"{row['plain_host_ms']:.4f} ms ({card})")
        out["resample_apply"][label] = row
        phase("22 resample-apply", f"{label}: C={C} N={n_part} K={K}: max "
              f"|kernel - plain| = {row['max_abs_err']!r}, bitwise equal "
              f"{same}{msg}")
        if not same:
            raise AssertionError(f"resample-apply differs from its plain "
                                 f"version at {label}")
        del pos, vals, vals_sets, cdf, out_k, out_r

    # (b) every predict call of the slice, one chain, timed
    def timed(label, call, expect_ra, shape=None, key=None):
        """One call from zeroed counts, which must launch resample-apply
        ``expect_ra`` times and K1 never: (result, seconds); the launches
        go to the report under ``key``."""
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_counts(fused_pf, resample)
        t0 = time.perf_counter()
        res = call()
        sync()
        dt = time.perf_counter() - t0
        got = (fused_pf.fused_window.launches,
               resample.resample_apply.launches)
        if cuda and got != (0, expect_ra):
            raise AssertionError(f"{label}: (K1, resample-apply) launches "
                                 f"{got}, expected (0, {expect_ra})")
        arrays = [np.asarray(a) for a in (
            res.values() if isinstance(res, dict) else
            [x for r in res for x in (r if isinstance(r, tuple) else (r,))]
            if isinstance(res, (list, tuple)) else [res])]
        if not all(np.isfinite(a).all() for a in arrays):
            raise AssertionError(f"{label}: non-finite values")
        if shape is not None and arrays[0].shape != shape:
            raise AssertionError(f"{label}: shape {arrays[0].shape}, "
                                 f"expected {shape}")
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                else float("nan"))
        if key is not None:
            out["launches"][key] = got[1]
        phase("22 predict", f"{label}: {dt:.3f} s a call, (K1, "
              f"resample-apply) launches {got}, peak {peak:.3f} GiB "
              f"({card})")
        return res, dt

    data = {name: mod.generate_data(gen, p, T_len)[0] for name, mod, p in (
        ("svm", svm, svm.from_scalars(0.9, 0.5, 1.0, device=dev)),
        ("garch", garch, garch.from_alpha_beta_gamma(0.1, 0.6, 0.2, 0.5,
                                                     device=dev)),
        ("svjm", svjm, svjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0,
                                         device=dev)),
        ("lgssm", lgssm, lgssm.from_scalars(0.8, 0.5, 0.3, device=dev)))}
    truth = dict(svm=svm.from_scalars(0.9, 0.5, 1.0),
                 garch=garch.from_alpha_beta_gamma(0.1, 0.6, 0.2, 0.5),
                 svjm=svjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0),
                 lgssm=lgssm.from_scalars(0.8, 0.5, 0.3))
    cls = dict(svm=samplers.SVMSampler, garch=samplers.GARCHSampler,
               svjm=samplers.SVJMSampler, lgssm=samplers.LGSSMSampler)
    smp = {}
    for name in cls:
        smp[name] = cls[name](data[name], device=dev, seed=30)
        smp[name].parameters = truth[name]
    warm = samplers.SVMSampler(data["svm"][:20], device=dev)
    warm.predict(N=N_p)
    warm.predictive_loglikelihood(5, N=N_p)          # warm-up
    lat = (T_len, 1)
    s = smp["svm"]
    timed("SVM predict smoothed (pf='poyiadjis_N')",
          lambda: s.predict(N=N_p, pf="poyiadjis_N"), T_len, lat,
          "predict_svm")
    timed("SVM predict filtered (lag=0)", lambda: s.predict(N=N_p, lag=0),
          T_len, lat)
    timed("SVM predict fixed-lag (lag=5)", lambda: s.predict(N=N_p, lag=5),
          T_len, lat)
    timed("SVM predict target='y'", lambda: s.predict(target="y", N=N_p),
          T_len, lat)
    timed(f"SVM predict N={sizes['N_big']}",
          lambda: s.predict(N=sizes["N_big"]), T_len, lat,
          "predict_svm_n10000")
    timed("GARCH predict target='y'",
          lambda: smp["garch"].predict(target="y", N=N_p), T_len, lat,
          "predict_garch_y")
    for name in cls:
        timed(f"{cls[name].__name__}.predictive_loglikelihood(5, N={N_p})",
              lambda: smp[name].predictive_loglikelihood(5, N=N_p), T_len,
              (6,))
    seqs = [svm.generate_data(gen, svm.from_scalars(0.9, 0.5, 1.0,
                                                    device=dev), n)[0]
            for n in sizes["seq"]]
    sq = samplers.SeqSVMSampler(seqs, device=dev, seed=31)
    sq.parameters = truth["svm"]
    res, _ = timed(f"SeqSVMSampler.predict, {len(seqs)} sequences",
                   lambda: sq.predict(N=N_p), max(sizes["seq"]),
                   key="predict_seq")
    if [r[0].shape[0] for r in res] != list(sizes["seq"]):
        raise AssertionError("Seq predict lengths")
    timed("SeqSVMSampler.predictive_loglikelihood(num_steps_ahead=5)",
          lambda: sq.predictive_loglikelihood(num_steps_ahead=5, N=N_p),
          max(sizes["seq"]), (6,))
    ls = smp["lgssm"]
    for label, call, shape in (
            ("latent", lambda: ls.predict(kind="marginal"), lat),
            ("y", lambda: ls.predict(target="y", kind="marginal"), lat),
            ("latent samples (FFBS, 8)", lambda: ls.latent_var_sample(
                8, kind="marginal"), (8,) + lat),
            ("y samples (marginal, 8)", lambda: ls.y_sample(
                8, kind="marginal", distr="marginal"), (8,) + lat),
            ("simulate_distr", lambda: ls.simulate_distr(T_len), None),
            ("simulate_paths (8)", lambda: ls.simulate(T_len, num_samples=8),
             None)):
        timed(f"LGSSM exact {label}, float64", call, 0, shape)

    # (c) the LGSSM's particle predict against the Kalman smoother: R
    # independent rows of one padded program, z per t of their mean
    R, T_z, N_z = sizes["z"]
    ys_z = data["lgssm"][:T_z]
    zs = samplers.SeqLGSSMSampler([ys_z] * R, device=dev, seed=32)
    zs.parameters = truth["lgssm"]
    p64 = params_map(lambda x: x.double().to(dev), truth["lgssm"])
    for lag in (None, 0, 5):
        pf = np.stack([m_[:, 0] for m_, _ in zs.predict(N=N_z, lag=lag)])
        exact = lgssm.latent_var_distr(p64, ys_z.double()[None], lag=lag)[
            0][0, :, 0].cpu().numpy()
        z = (pf.mean(0) - exact) / (pf.std(0, ddof=1) / R ** 0.5)
        phase("22 LGSSM oracle", f"PF predict lag={lag} (N={N_z}, T={T_z}) "
              f"over {R} rows against the Kalman moments: max |z| over t "
              f"{np.abs(z).max():.3f}, mean |PF - exact| "
              f"{np.abs(pf.mean(0) - exact).mean():.4f}")
        if not np.abs(z).max() < 5:
            raise AssertionError(f"PF predict lag={lag} off the Kalman "
                                 f"moments: max |z| {np.abs(z).max()}")

    # (d) the exact predict on the card against the CPU, float64, on
    # shared normals
    cpu = torch.device("cpu")
    ys64 = data["lgssm"].double()[None]
    g64 = torch.Generator().manual_seed(33)
    z_lat = torch.randn((1, 4, T_len, 1), generator=g64, dtype=torch.float64)
    z_eps = torch.randn((1, 4, T_len, 1), generator=g64, dtype=torch.float64)
    z_path = (torch.randn((1, 4, 1), generator=g64, dtype=torch.float64),
              torch.randn((1, 4, T_len, 1), generator=g64,
                          dtype=torch.float64),
              torch.randn((1, 4, T_len + 1, 1), generator=g64,
                          dtype=torch.float64))

    def exact_outputs(d):
        p = params_map(lambda x: x.to(d), p64)
        y = ys64.to(d)
        res = [*lgssm.y_distr(p, y), *lgssm.y_distr(p, y, lag=0),
               *lgssm.y_distr(p, y, lag=5),
               lgssm.y_sample(p, None, y, num_samples=4, distr="marginal",
                              normals=z_lat.to(d), eps=z_eps.to(d)),
               *lgssm.simulate_distr(p, T_len).values(),
               *lgssm.simulate_paths(p, None, T_len, num_samples=4, normals=[
                   a.to(d) for a in z_path]).values()]
        return [r.cpu() for r in res]
    worst = max(float((a - b).norm() / b.norm())
                for a, b in zip(exact_outputs(dev), exact_outputs(cpu)))
    phase("22 exact card-cpu", f"LGSSM y_distr (lag None, 0, 5), "
          f"y_sample, simulate_distr, simulate_paths in float64, T={T_len}: "
          f"normwise relative |card - CPU| at most {worst:.3e} (bound "
          f"1e-9)")
    if not worst <= 1e-9:
        raise AssertionError(f"exact predict card vs CPU {worst}")

    # (e) the adaptive proposals through fit_scan, the default multinomial
    # path (no fused bundle): resample-apply once per window step
    C_f, N_f, it_f = sizes["fit"]
    for name, kern in (("svm", "laplace"), ("svm", "ep"), ("svjm", "ep"),
                       ("svjm", "ep_avg")):
        f = cls[name](data[name], device=dev, seed=34)
        f.parameters = truth[name]
        fkw = dict(kernel=kern, N=N_f, subsequence_length=S,
                   buffer_length=B)

        def fit(n_iters):
            _, aux = f.fit_scan("SGLD", num_iters=n_iters, epsilon=0.01,
                                num_chains=C_f, record="none",
                                return_aux=True, **fkw)
            p = f.parameters
            return [aux] + [getattr(p, k) for k in p.__dataclass_fields__]
        fit(1)                                            # warm-up
        _, dt = timed(f"{cls[name].__name__}.fit_scan SGLD kernel={kern!r} "
                      f"C={C_f} N={N_f} S={S} B={B}, {it_f} iterations",
                      lambda: [a.cpu() for a in fit(it_f)], it_f * W)
        phase("22 proposals", f"{name} {kern}: {C_f * it_f / dt:.1f} "
              f"aggregate steps/s ({card})")
    seconds = time.perf_counter() - t_phase
    phase("22 seconds", f"{seconds:.1f} s")
    return out


# Phase 23: the vector LGSSM (n = m = 2), the model of
# tests/test_pf_vs_kalman.py, at the fits' full width.  Its resample-apply
# calls carry [particles | statistics]: K = n + statistic_dim(2, 2) = 16
# at 8192 chains and N=1024 in the fits, and the smoothed predict's
# elementwise rows K = n + (n + 2 n^2) * T = 10002 at T=1000, N=1000.
VECTOR_MATRICES = ([[0.7, 0.1], [0.0, 0.5]], [[1.0, 0.0], [0.0, 1.0]],
                   [[0.5, 0.1], [0.1, 0.4]], [[0.6, 0.0], [0.0, 0.6]])
VECTOR_SHAPES = dict(vector_fit=(C_BENCH, N, 2 + 14),
                     vector_predict=(1, 1000, 2 + 10 * T))
# fit: (chains, N, timed iterations); oracle: (chains, T); z: (rows, T,
# N) of the PF smoothed moments against Kalman; exact: card-vs-CPU rows;
# gibbs: chains; trace: (chains, N, iterations) of phase 24's trace
VECTOR_SIZES = dict(T=T, fit=(C_BENCH, N, ITERS), oracle=(1024, 16),
                    z=(32, 200, 1000), exact=1024, gibbs=256,
                    trace=(64, 256, 20), predict_N=1000,
                    shapes=VECTOR_SHAPES)


def ancestor_rows(pos, cdf):
    """The number of distinct ancestors over the rows of pos / cdf [C, n]
    (a chain's distinct rows of vals that resample-apply reads)."""
    from sgmcmc_tpu_torch.ops.cuda import resample
    idx = resample.ancestors(pos, cdf).sort(1).values
    return int(idx.shape[0] + (idx[:, 1:] != idx[:, :-1]).sum())


def vector_phase(dev, card, sizes=VECTOR_SIZES):
    """Phase 23 on ``dev`` (the CPU for a rehearsal at small ``sizes``):
    resample-apply bitwise at the vector model's two new shapes, the
    multinomial and systematic fits at full width through
    ``Sampler(get_model("lgssm", n=2, m=2))`` (one resample-apply launch
    a window step, no K1), the PF score against the exact Kalman
    gradient, the exact kinds and Gibbs on the card against the CPU,
    SGRLD, and the PF smoothed moments against the Kalman moments.
    Returns the report's numbers and phase 24's trace."""
    import numpy as np
    from sgmcmc_tpu_torch import Sampler, get_model
    from sgmcmc_tpu_torch.inference import samplers, sgmcmc
    from sgmcmc_tpu_torch.models import lgssm
    from sgmcmc_tpu_torch.models.base import params_map
    from sgmcmc_tpu_torch.ops.cuda import fused_pf, resample
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(23)
    f64 = torch.float64
    T_len = sizes["T"]
    model = get_model("lgssm", n=2, m=2)
    if model.get_fused is not None:
        raise AssertionError("the vector LGSSM must not take K1")
    truth = lgssm.from_matrices(*VECTOR_MATRICES, device=dev)
    ys, _ = model.generate_data(gen, truth, T_len)
    out = {"resample_apply": {}, "launches": {}}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def launches():
        return (fused_pf.fused_window.launches,
                resample.resample_apply.launches)

    # (a) resample-apply at the two new shapes, bitwise, timed beside its
    # plain version (torch.searchsorted + torch.gather, the PyTorch call)
    for label, (C, n_part, K) in sizes["shapes"].items():
        # weights at a filter's ESS and copies of vals used in turn past
        # L2, as for phase 22's wide rows
        cdf = resample.weights_cdf(WIDE_LOG_WEIGHT_SD * torch.randn(
            (C, n_part), generator=gen, device=dev))
        pos = torch.rand((C, n_part), generator=gen, device=dev)
        vals = torch.randn((C, n_part, K), generator=gen, device=dev)
        vals_sets = [vals] + [vals.clone() for _ in range(
            -(-int(2 * L2_BYTES) // (8 * C * n_part * K)) - 1)]
        out_k = resample.resample_apply(pos, cdf, vals)
        out_r = resample.resample_apply_reference(pos, cdf, vals)
        sync()
        same = bool(torch.equal(out_k, out_r))
        row = dict(max_abs_err=float((out_k - out_r).abs().max()))
        msg = ""
        if cuda:
            # bytes: pos and cdf once, each distinct ancestor's row of vals
            # once, the output once
            nbytes = 4 * (pos.numel() + cdf.numel() + ancestor_rows(
                pos, cdf) * K + C * n_part * K)
            wide = resample.wide_launch(C, n_part, K, dev)

            def per_call(timer, fn, reps):
                return timer(lambda: [fn(pos, cdf, v) for v in vals_sets],
                             reps) / len(vals_sets)
            reps = max(10, min(200, int(2e8 / (8 * C * n_part * K
                                                 * len(vals_sets)))))
            plain = resample.resample_apply_reference
            bnd, by = bound_ms(nbytes, C * n_part * (n_part.bit_length() + 1))
            row.update(ms=per_call(graph_ms, resample.resample_apply, reps),
                       plain_ms=per_call(graph_ms, plain, reps),
                       library_ms=per_call(graph_ms, plain, reps),
                       bound_ms=bnd, bound_by=by, wide=wide)
            msg = (f"; {'wide' if wide else 'tiled'} launch; device time per "
                   f"call (CUDA graph) kernel {row['ms']:.4f} ms, plain "
                   f"(searchsorted + gather) {row['plain_ms']:.4f} / "
                   f"{row['library_ms']:.4f} ms, bound {bnd:.4f} ms by {by} "
                   f"({nbytes / 1e6:.1f} MB, {bnd / row['ms']:.0%} of it) "
                   f"({card})")
        out["resample_apply"][label] = row
        phase("23 resample-apply", f"{label}: C={C} N={n_part} K={K}: max "
              f"|kernel - plain| = {row['max_abs_err']!r}, bitwise equal "
              f"{same}{msg}")
        if not same:
            raise AssertionError(f"resample-apply differs from its plain "
                                 f"version at {label}")
        del pos, cdf, vals, vals_sets, out_k, out_r

    # (b) the fits at full width, multinomial (the default) and systematic
    # (K1 being the scalar model's, both on the unfused smoother)
    C_f, N_f, it_f = sizes["fit"]
    fkw = dict(N=N_f, subsequence_length=S, buffer_length=B, epsilon=0.01)
    for resampler in ("multinomial", "systematic"):
        smp = Sampler(model, observations=ys, device=dev, seed=23)
        smp.parameters = truth
        smp.fit_scan("SGLD", num_iters=1, num_chains=C_f, record="none",
                     resampler=resampler, **fkw)               # warm-up
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_counts(fused_pf, resample)
        t0 = time.perf_counter()
        _, aux = smp.fit_scan("SGLD", num_iters=it_f, record="none",
                              return_aux=True, resampler=resampler, **fkw)
        sync()
        dt = time.perf_counter() - t0
        got = launches()
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                else float("nan"))
        p = smp.parameters
        check_finite(f"the vector {resampler} fit", aux, p.A, p.LQinv_vec,
                     p.LRinv_vec)
        expect = (0, it_f * W)
        phase("23 vector fit", f"Sampler(get_model('lgssm', n=2, m=2))."
              f"fit_scan SGLD {resampler} C={C_f} N={N_f} S={S} B={B} on "
              f"T={T_len}: {it_f} iterations in {dt:.3f} s = "
              f"{C_f * it_f / dt:.1f} aggregate steps/s; (K1, "
              f"resample-apply) launches {got}, expected {expect}; peak "
              f"{peak:.3f} GiB; chain-mean A "
              f"{p.A.mean(0).flatten().tolist()} ({card})")
        if cuda and got != expect:
            raise AssertionError(f"vector {resampler} fit launches {got}")
        out["launches"].setdefault("vector_fit", got[1])
        out[f"steps_{resampler}"] = C_f * it_f / dt

    # (c) the PF score (multinomial, full window) against the exact
    # gradient: z of the chain mean per coordinate
    C_o, T_o = sizes["oracle"]
    ys_o = ys[:T_o]
    exact = lgssm.gradient_marginal_loglikelihood(truth, ys_o)
    flat = lambda g: torch.cat([g.A.flatten(1), g.C.flatten(1),  # noqa
                                g.LQinv_vec, g.LRinv_vec], 1).double()
    rows = params_map(lambda x: x.expand((C_o,) + x.shape[1:]).contiguous(),
                      truth)
    score = sgmcmc.make_pf_score_fn(
        model.get_kernel(), model.grad_statistic, model.grad_statistic_dim,
        model.unpack_grad, sgmcmc.PFScoreConfig(n_particles=N_f,
                                                resample_mode="auto"),
        T_o, prior_mean_var_fn=model.prior_mean_var)
    g, ll = score(gen, rows, ys_o)
    f = flat(g)
    check_finite("the vector oracle score", f, ll)
    zval = (f.mean(0) - flat(exact)[0]) / (f.std(0) / C_o ** 0.5 + 1e-9)
    phase("23 oracle", f"PF score (multinomial, N={N_f}, T={T_o}) over "
          f"{C_o} chains against the exact gradient: max |z| over the 14 "
          f"coordinates {float(zval.abs().max()):.3f}")
    if not bool((zval.abs() < 5).all()):
        raise AssertionError(f"vector PF score off the exact gradient: {zval}")

    # (d) the exact kinds and Gibbs, float64, card against CPU on shared
    # draws
    R = sizes["exact"]
    u = torch.rand((R, 4), generator=gen, dtype=f64, device=dev)
    base = params_map(lambda x: x.double(), truth)
    p_rows = lgssm.LGSSMParams(
        A=base.A * (0.6 + 0.5 * u[:, 0, None, None]),
        C=base.C.expand(R, 2, 2),
        LQinv_vec=base.LQinv_vec * (0.7 + 0.6 * u[:, 1:2]),
        LRinv_vec=base.LRinv_vec * (0.7 + 0.6 * u[:, 2:3]))
    start = torch.randint(0, T_len - S + 1, (R,), generator=gen, device=dev)
    start[:R // 8] = 0
    idx = start[:, None] - B + torch.arange(W, device=dev)
    from sgmcmc_tpu_torch.ops.subsequence import subsequence_weights
    win = ys.double()[torch.clamp(idx, 0, T_len - 1)]
    valid = ((idx >= 0) & (idx < T_len)).to(f64)
    weights = subsequence_weights(start, S, T_len, dtype=f64)
    z_ffbs = torch.randn((R, 2, W, 2), generator=gen, dtype=f64, device=dev)
    z_comp = torch.randn((R, 2, 2), generator=gen, dtype=f64, device=dev)
    C_g = sizes["gibbs"]

    def draw(shape, chi2=False):
        """Normals, or chi-square-sized values near T for the Bartlett
        diagonals."""
        if chi2:
            return T_len + 3 * torch.rand(shape, generator=gen, dtype=f64,
                                          device=dev)
        return torch.randn(shape, generator=gen, dtype=f64, device=dev)
    # FFBS normals, Q^-1's Bartlett diagonal and off-diagonal, A's
    # normals, R^-1's diagonal and off-diagonal
    gd = lgssm.GibbsDraws(draw((C_g, T_len, 2)), draw((C_g, 2), True),
                          draw((C_g, 1)), draw((C_g, 2, 2)),
                          draw((C_g, 2), True), draw((C_g, 1)))
    prior64 = lgssm.default_prior(2, 2, dtype=f64, device=dev)

    def exact_outputs(d):
        to = lambda x: x.to(d)  # noqa: E731
        p = params_map(to, p_rows)
        gm, llm = lgssm.windowed_marginal_gradient(
            p, to(win), to(valid), to(weights), B, S)
        gc, llc = lgssm.windowed_complete_gradient(
            p, to(win), to(valid), to(weights), B, S, num_samples=2,
            normals=to(z_ffbs), completion=to(z_comp))
        gp = params_map(lambda x: x[:C_g], p)
        gib = lgssm.gibbs_step(
            None, params_map(to, prior64), gp, to(ys.double()),
            draws=lgssm.GibbsDraws(*[to(x) for x in gd[:6]]))
        return [flat(gm), llm, flat(gc), llc, flat(gib)]
    t0 = time.perf_counter()
    on_card = exact_outputs(dev)
    sync()
    t_card = time.perf_counter() - t0
    worst = max(float((a.cpu() - b).norm() / b.norm())
                for a, b in zip(on_card, exact_outputs(torch.device("cpu"))))
    check_finite("the vector exact paths", *on_card)
    phase("23 exact card-cpu", f"float64 windowed marginal and complete "
          f"gradients on {R} rows, a Gibbs sweep of {C_g} chains (T="
          f"{T_len}): normwise relative |card - CPU| at most {worst:.3e} "
          f"(bound 1e-9); card {t_card:.2f} s")
    if not worst <= 1e-9:
        raise AssertionError(f"vector exact paths card vs CPU {worst}")
    for kind in ("marginal", "complete"):
        ls = samplers.LGSSMSampler(ys, n=2, m=2, device=dev, seed=24)
        reset_counts(fused_pf, resample)
        tr = ls.fit_scan("SGLD", num_iters=2, num_chains=C_g, kind=kind,
                         subsequence_length=S, buffer_length=B,
                         epsilon=0.01)
        check_finite(f"the vector {kind} fit", tr.A, tr.LQinv_vec)
        if launches() != (0, 0):
            raise AssertionError(f"{kind} fit launched {launches()}")
    ls.select_chain(0)
    sweeps = [ls.sample_gibbs() for _ in range(3)]
    check_finite("the vector Gibbs sweeps", *[p.A for p in sweeps])

    # (e) SGRLD on the vector model (the general preconditioner)
    sg = Sampler(model, observations=ys, device=dev, seed=25)
    sg.parameters = truth
    reset_counts(fused_pf, resample)
    tr = sg.fit_scan("SGRLD", num_iters=2, num_chains=C_g, epsilon=0.005,
                     N=N_f, subsequence_length=S, buffer_length=B)
    check_finite("the vector SGRLD fit", tr.A, tr.LQinv_vec, tr.LRinv_vec)
    phase("23 SGRLD", f"fit_scan SGRLD C={C_g} N={N_f}, 2 iterations: "
          f"finite; launches {launches()}; chain-mean A "
          f"{tr.A[:, -1].mean(0).flatten().tolist()}")
    if cuda and launches() != (0, 2 * W):
        raise AssertionError(f"vector SGRLD launches {launches()}")

    # (f) the PF smoothed moments against the Kalman moments (R rows of
    # one padded program), then one full-size predict call with its
    # launches (the K=10002 rows)
    R_z, T_z, N_z = sizes["z"]
    ys_z = ys[:T_z]
    zs = samplers.SeqLGSSMSampler([ys_z] * R_z, n=2, m=2, device=dev,
                                  seed=26)
    zs.parameters = truth
    pf = np.stack([m_ for m_, _ in zs.predict(N=N_z)])        # [R, T, 2]
    mean_ex = lgssm.latent_var_distr(params_map(lambda x: x.double(), truth),
                                     ys_z.double()[None])[0][0].cpu().numpy()
    zz = (pf.mean(0) - mean_ex) / (pf.std(0, ddof=1) / R_z ** 0.5)
    phase("23 smoothed moments", f"PF predict (N={N_z}, T={T_z}) over {R_z} "
          f"rows against the Kalman smoothed means: max |z| over t and the "
          f"2 coordinates {np.abs(zz).max():.3f}")
    if not np.abs(zz).max() < 5:
        raise AssertionError(f"vector PF smoothed moments: max |z| "
                             f"{np.abs(zz).max()}")
    sp = Sampler(model, observations=ys, device=dev, seed=27)
    sp.parameters = truth
    sp.predict(N=sizes["predict_N"])                            # warm-up
    sync()
    reset_counts(fused_pf, resample)
    t0 = time.perf_counter()
    mean, cov = sp.predict(N=sizes["predict_N"])
    sync()
    dt = time.perf_counter() - t0
    got = launches()
    if mean.shape != (T_len, 2) or cov.shape != (T_len, 2, 2) or not (
            np.isfinite(mean).all() and np.isfinite(cov).all()):
        raise AssertionError("the vector predict's output")
    phase("23 predict", f"Sampler(vector).predict(N={sizes['predict_N']}), "
          f"T={T_len}: {dt:.3f} s a call, (K1, resample-apply) launches "
          f"{got} ({card})")
    if cuda and got != (0, T_len):
        raise AssertionError(f"vector predict launches {got}")
    out["launches"]["vector_predict"] = got[1]

    # phase 24's trace: a recorded multinomial fit
    C_t, N_t, it_t = sizes["trace"]
    st = Sampler(model, observations=ys, device=dev, seed=28)
    st.parameters = truth
    out["trace"] = st.fit_scan("SGLD", num_iters=it_t, num_chains=C_t,
                               N=N_t, subsequence_length=S, buffer_length=B,
                               epsilon=0.01, chain_init="prior")
    out["model"], out["ys"], out["truth"] = model, ys, truth
    phase("23 seconds", f"{time.perf_counter() - t_phase:.1f} s")
    return out


def evaluation_phase(dev, card, vec):
    """Phase 24 on ``dev``: the evaluation layer on phase 23's vector
    model and trace: the IMQ KSD on the card against the CPU, the
    convergence summary, fit_evaluate with a SamplerEvaluator (rows as
    dicts: no pandas here) and a checkpoint round trip."""
    import os
    import numpy as np
    from sgmcmc_tpu_torch import Sampler
    from sgmcmc_tpu_torch.io import checkpoint
    from sgmcmc_tpu_torch.metrics import convergence, ksd
    from sgmcmc_tpu_torch.metrics import metric_functions as mf
    from sgmcmc_tpu_torch.models import lgssm
    from sgmcmc_tpu_torch.models.base import params_map
    t_phase = time.perf_counter()
    model, ys, truth, trace = vec["model"], vec["ys"], vec["truth"], \
        vec["trace"]
    C_t, I_t = trace.A.shape[:2]

    # (a) KSD of the trace's A (its last half), with exact scores
    samples = params_map(lambda x: x[:, I_t // 2:].reshape(
        (-1,) + x.shape[2:]), trace)
    grad = lgssm.gradient_marginal_loglikelihood(samples, ys)
    x = samples.A.reshape(samples.num_chains, -1).double()
    g = grad.A.reshape(samples.num_chains, -1).double()
    t0 = time.perf_counter()
    k_card = float(ksd.imq_ksd(x, g, max_block_size=256, device=dev))
    t_card = time.perf_counter() - t0
    k_cpu = float(ksd.imq_ksd(x, g, max_block_size=256, device="cpu"))
    rel = abs(k_card - k_cpu) / abs(k_cpu)
    phase("24 KSD", f"IMQ KSD of A over {x.shape[0]} samples (the last half "
          f"of {C_t} chains x {I_t} iterations) with exact scores: card "
          f"{k_card!r}, CPU {k_cpu!r}, relative difference {rel:.3e} (bound "
          f"1e-9); card {t_card:.3f} s")
    if not (np.isfinite(k_card) and rel <= 1e-9):
        raise AssertionError(f"KSD card vs CPU {k_card} {k_cpu}")
    # the trace-level entry point, on the trace as the card holds it
    plist, glist = checkpoint.unstack_trace(samples), \
        checkpoint.unstack_trace(grad)
    if plist[0].A.device != x.device:
        raise AssertionError("the KSD trace is not where the fit left it")
    names = ["A", "C", "LQinv_vec", "LRinv_vec"]
    t0 = time.perf_counter()
    per_card = ksd.compute_ksd(plist, glist, names, max_block_size=256,
                               device=dev)
    t_trace = time.perf_counter() - t0
    per_cpu = ksd.compute_ksd(plist, glist, names, max_block_size=256,
                              device="cpu")
    rels = {v: abs(per_card[v] - per_cpu[v]) / abs(per_cpu[v])
            for v in names}
    phase("24 compute_ksd", f"compute_ksd over the list of {len(plist)} "
          f"parameters on the card, per variable: " + ", ".join(
              f"{v} {per_card[v]!r}" for v in names)
          + f"; largest relative difference to the CPU "
          f"{max(rels.values()):.3e} (bound 1e-9); A against imq_ksd "
          f"{abs(per_card['A'] - k_card) / abs(k_card):.3e}; card "
          f"{t_trace:.3f} s")
    if not (all(np.isfinite(list(per_card.values())))
            and max(rels.values()) <= 1e-9
            and abs(per_card["A"] - k_card) <= 1e-9 * abs(k_card)):
        raise AssertionError(f"compute_ksd card vs CPU {per_card} "
                             f"{per_cpu}")

    # (b) convergence summary of the stacked trace
    rows = convergence.convergence_summary(trace)
    if len(rows) != 4 + 4 + 3 + 3 or not all(
            np.isfinite(r["ess"]) for r in rows):
        raise AssertionError("convergence summary rows")
    worst = max(rows, key=lambda r: r["rhat"])
    phase("24 convergence", f"convergence_summary: {len(rows)} coordinates, "
          f"largest split-R-hat {worst['rhat']:.3f} ({worst['variable']}; "
          f"chains from the prior, {I_t} iterations)")

    # (c) fit_evaluate: one chain, SGLD steps for a few seconds of sampler
    # time, metrics every second, rows kept as dicts
    smp = Sampler(model, observations=ys, device=dev, seed=29)
    smp.parameters = truth
    ev = smp.fit_evaluate(
        "SGLD", max_time=3.0, epsilon=0.01, eval_freq=1.0,
        metric_functions=[
            mf.metric_function_parameters(truth, ["A", "C"], "mse"),
            mf.noisy_logjoint_loglike_metric(N=N, subsequence_length=S,
                                             buffer_length=B)],
        sample_functions=[mf.sample_function_parameters(["A"])],
        N=N, subsequence_length=S, buffer_length=B)
    mrows = ev.metric_rows
    if ev._metrics_df is not None or not all(np.isfinite(r["value"])
                                             for r in mrows):
        raise AssertionError("fit_evaluate rows")
    last_ll = [r["value"] for r in mrows if r["metric"] == "loglikelihood"]
    phase("24 fit_evaluate", f"SGLD (N={N}) for {ev.elapsed_time:.2f} s of "
          f"sampler time: {ev.iteration} iterations, {len(mrows)} metric "
          f"rows and {len(ev.sample_rows)} sample rows (no DataFrame); last "
          f"loglikelihood row {last_ll[-1]:.2f}")

    # (d) a checkpoint round trip of the fit's state
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke", "checkpoint.pkl")
    checkpoint.save_checkpoint(path, parameters=smp.parameters,
                               generator_state=smp.generator.get_state(),
                               iteration=ev.iteration)
    ck = checkpoint.load_checkpoint(path)
    back = checkpoint.tree_to_torch(ck["parameters"], device=dev)
    same = all(torch.equal(getattr(back, f), getattr(smp.parameters, f))
               for f in ("A", "C", "LQinv_vec", "LRinv_vec"))
    phase("24 checkpoint", f"save / load of the fit's parameters and "
          f"generator state at iteration {ck['iteration']}: equal {same}")
    if not same or ck["iteration"] != ev.iteration:
        raise AssertionError("checkpoint round trip")
    phase("24 seconds", f"{time.perf_counter() - t_phase:.1f} s")


# Phase 25: the experiments layer.  Its new shapes on the kernels: the
# gradient-error figure's truth (resample-apply at C=4 reps, N=100000
# particles, K = D + H = 4: beyond the kernel's shared-memory CDF), the
# driver's single-chain fits and eval scores (C=1, N=1000, K=4; the grid
# has no resampler key, so multinomial), and the demo's SGLD leg on one
# segment (K1 at C=1, N=1000, W = 16 + 2 * 4 = 24, host normals).
EXPERIMENT_SHAPES = dict(grad_truth=(4, 100000, 4), driver=(1, 1000, 4))
# driver: (T, fit iterations, multichain (chains, iterations), eval (N,
# predictive steps, points), KSD (N, samples), loop-timed scores, LGSSM
# iterations); figs: gradient_error_figs.run's defaults; demo: segment
# lengths, N, SGLD / LD iterations, save_params / calculate_ksd settings;
# gate: the SGLD-against-LD KSD ordering of tests/test_ksd_sgld_vs_ld.py
# (its LD leg cut from 600 to 300 iterations, ~0.22 s each on the card,
# for phase 27's time: LD's phi KSD was 0.018 of SGLD's at 600, held below
# 0.5);
# resume: iterations before and after the checkpoint, particles
# The host-bound single-chain loops are cut to keep the phase's time (a
# default-grid fit iteration takes 0.4-1.3 s, an eval point ~3.7 s, a
# Gibbs or Kalman-score iteration ~0.45 s, a PaRIS score at N=10000 over
# 579 steps ~2 s on an H100: PERF.md section 5); each cut is printed.
EXPERIMENT_SIZES = dict(
    T=T, fit_iters=3, mc=(C_BENCH, 20), eval=(1000, 5, 2), ksd=(1000, 20),
    ksd_loop=2, lgssm_iters=4,
    figs=dict(T=100, L=16, truth_N=100000, truth_reps=4, N=(100, 1000),
              reps=20),
    demo=dict(lengths=SEQ_LENGTHS, N=1000, sgld=2000, ld=3, fit_time=5.0,
              save_N=10000, save_chunk=50, ksd_samples=2, ksd_N=10000),
    gate=dict(T=125, sgld=3000, ld=300, N=128, ksd_N=256, samples=60),
    resume=dict(iters=2, N=256), shapes=EXPERIMENT_SHAPES)


def experiments_phase(dev, card, sizes=EXPERIMENT_SIZES):
    """Phase 25 on ``dev`` (the CPU for a rehearsal at small ``sizes``):
    the experiment driver (SVM and LGSSM: setup, every fit, a multichain
    fit, eval, KSD, KS, process_out), the
    gradient-error figure and the exchange-rate demo on synthetic
    segments, with resample-apply and K1 held bitwise at their new shapes,
    then the demo's SGLD-against-LD KSD ordering.  Returns the report's
    numbers."""
    import os
    import tempfile
    import numpy as np
    from sgmcmc_tpu_torch.demo.exchange_rate import calculate_ksd, save_params
    from sgmcmc_tpu_torch.demo.exchange_rate import exchange_rate_demo as demo
    from sgmcmc_tpu_torch.experiments import driver
    from sgmcmc_tpu_torch.experiments import gradient_error_figs as figs
    from sgmcmc_tpu_torch.models import svm
    from sgmcmc_tpu_torch.ops.cuda import fused_pf, resample
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(25)
    out = {"resample_apply": {}, "launches": {}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_25_")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def launches():
        return (fused_pf.fused_window.launches,
                resample.resample_apply.launches)

    def timed(fn):
        """(result, seconds, (K1, resample-apply) launches) of fn()."""
        sync()
        reset_counts(fused_pf, resample)
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0, launches()

    # (a) resample-apply at its two new shapes, bitwise, timed beside its
    # plain version (torch.searchsorted + torch.gather, the PyTorch call)
    for label, (C, n_part, K) in sizes["shapes"].items():
        cdf = resample.weights_cdf(WIDE_LOG_WEIGHT_SD * torch.randn(
            (C, n_part), generator=gen, device=dev))
        # the paths' positions: systematic (the figure's truth) or
        # multinomial (the driver's grid)
        scheme = "systematic" if label == "grad_truth" else "multinomial"
        pos = resample.resample_positions(scheme, torch.rand(
            (C,) if scheme == "systematic" else (C, n_part), generator=gen,
            device=dev), n_part)
        vals = torch.randn((C, n_part, K), generator=gen, device=dev)
        out_k = resample.resample_apply(pos, cdf, vals)
        out_r = resample.resample_apply_reference(pos, cdf, vals)
        sync()
        same = bool(torch.equal(out_k, out_r))
        row = dict(max_abs_err=float((out_k - out_r).abs().max()))
        msg = ""
        if cuda:
            # bytes: pos, cdf and vals read once (rows of 16 bytes share
            # their sectors), the output written once
            nbytes = 4 * (pos.numel() + cdf.numel() + 2 * vals.numel())
            bnd, by = bound_ms(nbytes, C * n_part * (n_part.bit_length() + 1))
            reps = 200 if C * n_part < 1e5 else 50
            plain = resample.resample_apply_reference
            row.update(
                ms=graph_ms(lambda: resample.resample_apply(pos, cdf, vals),
                            reps),
                plain_ms=graph_ms(lambda: plain(pos, cdf, vals), reps),
                library_ms=graph_ms(lambda: plain(pos, cdf, vals), reps),
                bound_ms=bnd, bound_by=by,
                host_ms=cuda_ms(lambda: resample.resample_apply(
                    pos, cdf, vals), 50))
            msg = (f"; device time per call (CUDA graph) kernel "
                   f"{row['ms']:.4f} ms, plain (searchsorted + gather) "
                   f"{row['plain_ms']:.4f} / {row['library_ms']:.4f} ms, "
                   f"bound {bnd:.4f} ms by {by} ({nbytes / 1e6:.2f} MB, "
                   f"{bnd / row['ms']:.0%} of it); one host call "
                   f"{row['host_ms']:.4f} ms ({card})")
        out["resample_apply"][label] = row
        phase("25 resample-apply", f"{label}: C={C} N={n_part} K={K}"
              f"{' (beyond the shared-memory CDF)' if n_part > 57088 else ''}"
              f": max |kernel - plain| = {row['max_abs_err']!r}, bitwise "
              f"equal {same}{msg}")
        if not same:
            raise AssertionError(f"resample-apply differs from its plain "
                                 f"version at {label}")
        del pos, cdf, vals, out_k, out_r

    # (b) the driver on the SVM: setup at the reference's sizes, the
    # default grid (iterations cut), every fit timed with its launches
    dz = sizes["demo"]
    T_len = sizes["T"]
    root = os.path.join(tmp, "svm")
    args = driver.build_parser().parse_args([
        "--path", root, "--model", "svm", "--device", dev.type, "--T",
        str(T_len), "--T_test", str(T_len)])
    grid = [dict(o, max_num_iters=sizes["fit_iters"])
            for o in driver.default_sampler_grid("svm")]
    opts, secs, _ = timed(lambda: driver.do_setup(args, grid))
    names = ", ".join(sorted({o["name"] for o in opts}))
    phase("25 driver setup", f"svm T={T_len} T_test={T_len}: "
          f"{len(opts)} experiments ({names}; inits {args.init_methods}) "
          f"in {secs:.2f} s; max_num_iters cut to {sizes['fit_iters']} (10 "
          f"steps an iteration), --num_to_eval "
          f"5 to {sizes['eval'][2]}, the LGSSM's iterations to "
          f"{sizes['lgssm_iters']}, calculate_ksd's --max_samples 10 to "
          f"{sizes['demo']['ksd_samples']}")
    fit_ra = 0
    for o in opts:
        smp, secs, got = timed(lambda: driver.do_fit(args, o))
        check_finite(f"fit {o['experiment_id']}",
                     *[getattr(smp.parameters, f) for f in
                       ("A", "LQinv_vec", "LRinv_vec")])
        if got[0]:
            raise AssertionError(f"fit {o['experiment_id']} launched K1")
        if o["N"] == 1000:
            fit_ra += got[1]
        phase("25 driver fit", f"{o['name']} B={o['buffer_length']} "
              f"init={o['init_method']} (N={o['N']}, S="
              f"{o['subsequence_length']}): {sizes['fit_iters']} iterations "
              f"x {o['steps_per_iteration']} steps in {secs:.2f} s "
              f"({secs / sizes['fit_iters']:.3f} s an iteration), (K1, "
              f"resample-apply) launches {got}")
    out["launches"]["driver"] = fit_ra

    # the multichain fit of POYIADJIS_N_1000, B=10, prior init
    C_m, it_m = sizes["mc"]
    mc = next(o for o in opts if o["name"] == "POYIADJIS_N_1000"
              and o["buffer_length"] == 10 and o["init_method"] == "prior")
    mc_opts = dict(mc, max_num_iters=it_m, steps_per_iteration=1,
                   checkpoint_num_iters=it_m // 2)
    args.num_chains = C_m
    _, secs, got = timed(lambda: driver.do_fit(args, mc_opts))
    args.num_chains = 1
    W_mc = mc["subsequence_length"] + 2 * mc["buffer_length"]
    phase("25 driver multichain", f"--num_chains {C_m}, {it_m} iterations "
          f"of one step (two checkpointed chunks): {secs:.2f} s, "
          f"{C_m * it_m / secs:,.1f} steps/s, (K1, resample-apply) launches "
          f"{got} (expected (0, {it_m * W_mc})) ({card})")
    if cuda and got != (0, it_m * W_mc):
        raise AssertionError(f"multichain launches {got}")
    trace = driver.ckpt.load_trace(os.path.join(
        root, "out", "fit", f"{mc['experiment_id']}_parameters.p"))
    if trace["chain_parameters"].A.shape[:2] != (C_m, it_m):
        raise AssertionError("multichain trace shape")

    # eval, KSD (blocked, then timed as a loop), process_out
    ev = next(o for o in opts if o["name"] == "POYIADJIS_N_1000"
              and o["buffer_length"] == 10 and o["init_method"] == "truth")
    args.eval_N, args.eval_predictive, args.num_to_eval = sizes["eval"]
    _, secs, got = timed(lambda: driver.do_eval(args, ev, "half_avg_test"))
    phase("25 driver eval", f"half_avg_test of experiment "
          f"{ev['experiment_id']} (eval_N={args.eval_N}, eval_predictive="
          f"{args.eval_predictive}, num_to_eval={args.num_to_eval}): "
          f"{secs:.2f} s, launches {got}")
    args.ksd_N, args.max_ksd_samples = sizes["ksd"]
    res, secs, got = timed(lambda: driver.do_eval_ksd(args, ev))
    phase("25 driver ksd", f"ksd_N={args.ksd_N}, max_ksd_samples="
          f"{args.max_ksd_samples}, the scores as the chains of one call: "
          f"{secs:.2f} s ({secs / args.max_ksd_samples:.3f} s a score), "
          f"launches {got}; KSD {res}")
    if not all(np.isfinite(list(res.values()))):
        raise AssertionError(f"KSD {res}")
    # the same scores one call a sample, as the JAX driver's loop
    smp = driver._build_sampler(ev, driver.ckpt.load_pickle(os.path.join(
        root, "in", "data.p")), trace["parameters_list"][-1], dev)
    n_loop = sizes["ksd_loop"]
    _, secs, got = timed(lambda: [driver.score_block(
        smp, [q], N=args.ksd_N, subsequence_length=-1, is_scaled=False,
        check_finite=False) for q in trace["parameters_list"][-n_loop:]])
    phase("25 driver ksd loop", f"one call a score, {n_loop} scores: "
          f"{secs:.2f} s ({secs / n_loop:.3f} s a score), launches {got}")
    agg, secs, _ = timed(lambda: driver.do_process_out(args, opts))
    banned = [m for m in ("pandas", "matplotlib") if m in sys.modules]
    phase("25 driver process_out", f"{len(agg)} rows x {len(agg.columns)} "
          f"columns in {secs:.2f} s; modules loaded of pandas / matplotlib: "
          f"{banned}")
    if banned or not len(agg):
        raise AssertionError(f"process_out: {banned}, {len(agg)} rows")

    # (c) the driver on the LGSSM: Gibbs and the Kalman score, then KS
    lroot = os.path.join(tmp, "lgssm")
    largs = driver.build_parser().parse_args([
        "--path", lroot, "--model", "lgssm", "--device", dev.type, "--T",
        str(T_len), "--T_test", str(T_len)])
    lgrid = [dict(o, max_num_iters=sizes["lgssm_iters"])
             for o in driver.default_sampler_grid("lgssm")
             if o["name"] in ("GIBBS", "KF")]
    lopts = driver.do_setup(largs, lgrid)
    for o in lopts:
        smp, secs, got = timed(lambda: driver.do_fit(largs, o))
        check_finite(f"lgssm fit {o['experiment_id']}", smp.parameters.A)
        phase("25 driver lgssm", f"{o['name']} init={o['init_method']}: "
              f"{sizes['lgssm_iters']} iterations in {secs:.2f} s, launches "
              f"{got}")
    ks_rows = [r for o in lopts
               for r in driver.do_eval_ks_test(largs, o, lopts)]
    phase("25 driver kstest", f"{len(ks_rows)} rows against the Gibbs "
          f"trace; KS statistics " + ", ".join(
              f"{r['variable']} {r['value']:.3f}" for r in ks_rows[-3:]))
    if not ks_rows or not all(0 <= r["value"] <= 1 for r in ks_rows):
        raise AssertionError("kstest rows")

    # (d) resume: the resumed fits equal the uninterrupted ones
    driver_resume_check(dev, tmp, T_len, sizes["resume"])

    # (e) the gradient-error figure at run's defaults
    fz = sizes["figs"]
    params, ys_f = figs.make_observations("svm", fz["T"], 0, dev)
    gen_f = torch.Generator(device=dev).manual_seed(1)
    truth, secs, got = timed(lambda: figs.ground_truth(
        "svm", params, ys_f, fz["L"], fz["truth_N"], fz["truth_reps"],
        gen_f))
    out["launches"]["grad_truth"] = got[1]
    phase("25 figs truth", f"svm T={fz['T']} L={fz['L']}: Poyiadjis O(N) "
          f"at N={fz['truth_N']} x {fz['truth_reps']} reps in {secs:.2f} s, "
          f"(K1, resample-apply) launches {got}; truth {truth}")
    rows, secs, got = timed(lambda: figs.sweep(
        "svm", params, ys_f, fz["L"], truth,
        particle_counts=fz["N"], reps=fz["reps"], generator=gen_f))
    bias = {B: float(np.mean([r["abs_bias"] for r in rows
                              if r["buffer"] == B and r["N"] == fz["N"][-1]]))
            for B in figs.BUFFER_SIZES}
    phase("25 figs sweep", f"{len(figs.BUFFER_SIZES)} buffers x N in "
          f"{fz['N']} x {fz['reps']} reps in {secs:.2f} s, launches {got}; "
          f"mean |bias| at N={fz['N'][-1]} by buffer: " + ", ".join(
              f"B={B} {v:.4f}" for B, v in bias.items()))
    if not bias[figs.BUFFER_SIZES[-1]] < bias[0]:
        raise AssertionError(f"the bias does not fall with the buffer: "
                             f"{bias}")
    lp, ys_l = figs.make_observations("lgssm", fz["T"], 0, dev)
    t_card = figs.ground_truth("lgssm", lp, ys_l, fz["L"])
    t_cpu = figs.ground_truth("lgssm", lp.to("cpu"), ys_l.cpu(), fz["L"])
    rel = float(np.max(np.abs(t_card - t_cpu) / np.abs(t_cpu)))
    phase("25 figs lgssm", f"exact truth on the card {t_card} against the "
          f"CPU on the same ys: largest relative difference {rel:.3e} "
          f"(bound 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError(f"LGSSM truth card vs CPU {rel}")
    figs.plot(rows, "svm", os.path.join(tmp, "svm_grad_error.png"))

    # (f) the demo on synthetic segments
    npz = demo.write_synthetic_data(os.path.join(tmp, "synthetic.npz"),
                                    dz["lengths"], seed=25)
    segs = demo.load_segments(npz)
    smp = demo.make_sampler("svm", segs[1], device=dev)
    smp.project_parameters()
    kw = demo.leg_kwargs("sgld", dz["N"])
    score = smp._make_score(smp._score_config(**kw), None, **kw)
    if cuda and not score.uses_fused(dev):
        raise AssertionError("the demo's SGLD leg is off K1")
    draws = score.draw(gen, 1, dev)
    window, step_w, _, _ = score._layout(draws, smp.observations)
    model = svm.FUSED
    pm, pv = smp.model.prior_mean_var(smp.parameters)
    x0 = fused_pf.initial_state(model, draws.z0, pm, pv)
    k1_args = (model.pack_params(smp.parameters).contiguous(),
               x0.contiguous(), draws.normals.contiguous(),
               window[..., 0].contiguous(), step_w.contiguous(), draws.u)
    o_k = fused_pf.fused_window(model, *k1_args)
    o_r = fused_pf.fused_window_reference(model, *k1_args)
    sync()
    k1 = dict(max_abs_err=float((o_k - o_r).abs().max()))
    Wd = k1_args[3].shape[1]
    msg = ""
    if cuda:
        nbytes = 4 * (sum(a.numel() for a in k1_args) + model.n_stat + 1)
        ops = k1_ops(1, "svm", steps=Wd) * dz["N"] // N
        bnd, by = bound_ms(nbytes, ops)
        k1.update(ms=cuda_ms(lambda: fused_pf.fused_window(model, *k1_args),
                             200),
                  plain_ms=cuda_ms(lambda: fused_pf.fused_window_reference(
                      model, *k1_args), 20),
                  bound_ms=bnd, bound_by=by)
        msg = (f"; one call {k1['ms']:.4f} ms, plain {k1['plain_ms']:.3f} "
               f"ms, bound {bnd:.5f} ms by {by} ({card})")
    phase("25 demo K1", f"the SGLD leg's window on segment 1 "
          f"({segs[1].shape[0]} steps): C=1 N={dz['N']} W={Wd}: max |kernel"
          f" - plain| = {k1['max_abs_err']!r}, bitwise equal "
          f"{bool(torch.equal(o_k, o_r))}{msg}")
    if not torch.equal(o_k, o_r):
        raise AssertionError("K1 differs from its plain version at the "
                             "demo's shape")
    out["k1"] = k1
    for mode in ("single", "subset"):
        res, secs, got = timed(lambda: demo.main([
            "--data", npz, "--mode", mode, "--sgld_iters", str(dz["sgld"]),
            "--ld_iters", str(dz["ld"]), "--N", str(dz["N"]), "--out",
            os.path.join(tmp, "demo"), "--device", dev.type]))
        phase("25 demo", f"--mode {mode} --sgld_iters {dz['sgld']} "
              f"--ld_iters {dz['ld']} (cut from 20000 / 2000): "
              f"SGLD {res['sgld']['seconds_per_iteration']:.5f} s an "
              f"iteration, LD {res['ld']['seconds_per_iteration']:.4f} s an "
              f"iteration, {secs:.2f} s in all; (K1, resample-apply) "
              f"launches {got}; LD {res['ld']['summary']} ({card})")
        if (cuda and got[0] != dz["sgld"]) or not all(
                np.isfinite(r["loglikelihood"]) for r in res.values()):
            raise AssertionError(f"demo --mode {mode}: {got}, {res}")
        if mode == "single":
            out["launches"]["demo"] = got[0]
    paths, secs, got = timed(lambda: save_params.main([
        "--data", npz, "--N", str(dz["save_N"]), "--fit_time",
        str(dz["fit_time"]), "--chunk_iters", str(dz["save_chunk"]),
        "--ld_chunk_iters", "1", "--out", os.path.join(tmp, "save"),
        "--device", dev.type]))
    phase("25 demo save_params", f"--fit_time {dz['fit_time']} --N "
          f"{dz['save_N']} (chunks of {dz['save_chunk']} / 1 iterations): "
          f"{secs:.2f} s, launches {got}")
    res, secs, got = timed(lambda: calculate_ksd.main([
        "--data", npz, "--trace", paths["sgld"], paths["ld"], "--N",
        str(dz["ksd_N"]), "--max_samples", str(dz["ksd_samples"]),
        "--device", dev.type]))
    phase("25 demo calculate_ksd", f"--max_samples {dz['ksd_samples']} "
          f"--N {dz['ksd_N']}: {secs:.2f} s, launches {got}; "
          + "; ".join(f"{os.path.basename(p)} {v}" for p, v in res.items()))
    if not all(np.isfinite(list(v.values())).all() for v in res.values()):
        raise AssertionError(f"calculate_ksd {res}")

    # (g) the demo's headline comparison (tests/test_ksd_sgld_vs_ld.py's
    # protocol): LD's KSD on phi below half SGLD's.  Its other margins
    # (SGLD within 4x on sigma and tau, phi's ratio the smallest) are
    # printed, not held: the JAX package's own run of the protocol meets
    # them at 1 of 4 seeds (scripts/ksd_gate_seeds.py --package jax)
    gz = sizes["gate"]
    res, secs, got = timed(lambda: demo.sgld_against_ld_ksd(
        dev, T=gz["T"], sgld_iters=gz["sgld"], ld_iters=gz["ld"],
        N=gz["N"], ksd_N=gz["ksd_N"], samples=gz["samples"]))
    k_of = {leg: r["ksd"] for leg, r in res.items()}
    for leg, iters in (("sgld", gz["sgld"]), ("ld", gz["ld"])):
        phase("25 demo gate", f"{leg}: {iters} iterations (N={gz['N']}, "
              f"T={gz['T']}) in {res[leg]['seconds']:.2f} s "
              f"({res[leg]['seconds'] / iters:.5f} s an iteration); KSD "
              f"over {gz['samples']} PaRIS scores (N={gz['ksd_N']}) "
              f"{k_of[leg]} ({card})")
    ratios = {v: k_of["ld"][v] / k_of["sgld"][v]
              for v in ("phi", "sigma", "tau")}
    phase("25 demo gate", f"{secs:.2f} s, (K1, resample-apply) launches "
          f"{got}; LD / SGLD KSD ratios {ratios}: phi below 0.5 (held) "
          f"{ratios['phi'] < 0.5}; sigma and tau above 1/4 "
          f"{ratios['sigma'] > 0.25 and ratios['tau'] > 0.25}, phi's the "
          f"smallest {ratios['phi'] < min(ratios['sigma'], ratios['tau'])} "
          f"(printed)")
    if cuda and got[0] != gz["sgld"]:
        raise AssertionError(f"the SGLD leg launched K1 {got[0]} times")
    if not ratios["phi"] < 0.5:
        raise AssertionError(f"the SGLD-against-LD KSD ordering on phi: "
                             f"{k_of}")
    phase("25 seconds", f"{time.perf_counter() - t_phase:.1f} s")
    return out


def driver_resume_check(dev, tmp, T_len, rz):
    """Phase 25's resume check: a driver fit (the SVM's POYIADJIS_N_1000,
    B=10, prior init, ``rz['N']`` particles) stopped at its checkpoint and
    resumed equals the uninterrupted fit bitwise, SGLD and ADAGRAD (whose
    accumulator the resume state carries), at 1 and 3 chains."""
    import os
    import numpy as np
    from sgmcmc_tpu_torch.experiments import driver
    for iter_type in ("SGLD", "ADAGRAD"):
        for n_ch in (1, 3):
            traces = {}
            for label, stops in (("once", [2 * rz["iters"]]),
                                 ("resumed", [rz["iters"], 2 * rz["iters"]])):
                path = os.path.join(tmp, f"resume_{iter_type}_{n_ch}_{label}")
                rargs = driver.build_parser().parse_args([
                    "--path", path, "--model", "svm", "--device", dev.type,
                    "--T", str(T_len), "--T_test", str(T_len)])
                rargs.num_chains = n_ch
                ro = driver.do_setup(rargs, [dict(
                    o, N=rz["N"], steps_per_iteration=1,
                    checkpoint_num_iters=rz["iters"], iter_type=iter_type)
                    for o in driver.default_sampler_grid("svm")
                    if o["name"] == "POYIADJIS_N_1000"
                    and o["buffer_length"] == 10])
                for stop in stops:
                    driver.do_fit(rargs, dict(ro[0], max_num_iters=stop))
                tr = driver.ckpt.load_trace(os.path.join(
                    path, "out", "fit", "0_parameters.p"))
                traces[label] = np.stack([np.concatenate(
                    [np.ravel(getattr(q, f)) for f in
                     ("A", "LQinv_vec", "LRinv_vec")])
                    for q in tr["parameters_list"]])
            diff = float(np.abs(traces["resumed"] - traces["once"]).max())
            phase("25 driver resume", f"{iter_type}, {n_ch} chain(s), N="
                  f"{rz['N']}: {2 * rz['iters']} iterations at once against "
                  f"{rz['iters']} + {rz['iters']} resumed: max |resumed - "
                  f"uninterrupted| = {diff!r} (bitwise equal "
                  f"{diff == 0.0})")
            if diff != 0.0:
                raise AssertionError(f"the resumed {iter_type} fit at "
                                     f"{n_ch} chains differs by {diff}")


# Phase 26: the HMM family at the experiment driver's setting (GaussHMM and
# ARPHMM, K=2, m=1, p=1, T=1000, float64; no particle filter, so no kernel
# of this script runs on its path): card against CPU, the fits at full
# width, the statistical checks, the Seq samplers, predict and the driver's
# HMM grid.  The card-vs-CPU shapes: the driver's (64 chains of random
# parameters, K=2, m=1, T=1000) and K=3, m=2 (T=200).
HMM_SIZES = dict(T=T, C=C_BENCH, iters=ITERS, oracle=(64, 200),
                 gibbs=(1024, 3), recovery=(1024, 20), ffbs=(C_BENCH, 200),
                 seq=SEQ_LENGTHS, seq_iters=5, driver_iters=2,
                 driver_eval=(2, 5), ksd_samples=4)
# Gibbs recovery: the chains' median location (the last half of the
# sweeps averaged) within this many posterior standard deviations of the
# driver's true locations (mu = -1, 1; D = -0.7, 0.7), the posterior sd
# read as the chains' spread at the last sweep (each chain's draw is one
# from the posterior); the data's own posterior centre lies within about
# 2 of them of the truth
HMM_GIBBS_SDS = 4.0


def hmm_phase(dev, card, sizes=HMM_SIZES):
    """Phase 26 on ``dev`` (the CPU for a rehearsal at small ``sizes``):
    the HMM family's exact messages on the card against the CPU, SGLD
    (marginal and complete kinds), SCIR and Gibbs at full width, Gibbs
    recovery, SCIR's draws, FFBS in law, the Seq samplers, predict and the
    experiment driver's HMM grid."""
    import dataclasses
    import os
    import tempfile
    import numpy as np
    from scipy import stats
    from sgmcmc_tpu_torch.experiments import driver
    from sgmcmc_tpu_torch.inference import samplers, sgmcmc
    from sgmcmc_tpu_torch.metrics import metric_functions as mf
    from sgmcmc_tpu_torch.models import arphmm, gauss_hmm, registry
    from sgmcmc_tpu_torch.models.base import params_map
    from sgmcmc_tpu_torch.ops import hmm
    from sgmcmc_tpu_torch.ops.cuda import fused_pf, resample
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(26)
    names = ("gauss_hmm", "arphmm")
    mods = {"gauss_hmm": gauss_hmm, "arphmm": arphmm}
    T_len, C = sizes["T"], sizes["C"]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn):
        """(result, seconds, (K1, resample-apply) launches) of fn(); the
        HMM paths launch neither."""
        sync()
        reset_counts(fused_pf, resample)
        t0 = time.perf_counter()
        res = fn()
        sync()
        got = (fused_pf.fused_window.launches,
               resample.resample_apply.launches)
        if got != (0, 0):
            raise AssertionError(f"an HMM path launched {got}")
        return res, time.perf_counter() - t0

    truth = {n: driver._make_true_params(n, device=dev) for n in names}
    start = {"gauss_hmm": gauss_hmm.from_values(
        [[0.5, 0.5]] * 2, [[-0.5], [0.5]], [[1.0]], device=dev),
        "arphmm": arphmm.from_values(
            [[0.5, 0.5]] * 2, [[[0.3]], [[-0.3]]], [[1.0]], device=dev)}
    data = {n: registry.get_model(n).generate_data(gen, truth[n], T_len)
            for n in names}
    loc = {"gauss_hmm": "mu", "arphmm": "D"}

    # (a) the exact messages on the card against the CPU, float64, on the
    # same parameters and observations
    rng = np.random.default_rng(26)

    def random_chains(name, n, k, m):
        pis = rng.dirichlet(np.ones(k) * 3, size=(n, k))
        A = rng.standard_normal((n, k, m, m)) * 0.3
        R = A @ np.swapaxes(A, -1, -2) + np.eye(m) * 0.5
        Lr = np.linalg.cholesky(np.linalg.inv(R))
        rows, cols = np.tril_indices(m)
        locs = (rng.standard_normal((n, k, m)) if name == "gauss_hmm"
                else 0.4 * rng.standard_normal((n, k, m, m)))
        cls = (gauss_hmm.GaussHMMParams if name == "gauss_hmm"
               else arphmm.ARPHMMParams)
        return cls(*[torch.as_tensor(x, dtype=torch.float64) for x in (
            np.log(pis), locs, Lr[..., rows, cols])])

    def oracle(name, p, ys):
        mod = mods[name]
        logP = mod.emission_logliks(p, ys)
        fwd, bwd = (mod.default_forward_message(p),
                    mod.default_backward_message(p))
        joint, marg = hmm.posterior_marginals(logP, p.pi, fwd, bwd)
        g = mod.gradient_marginal_loglikelihood(p, ys)
        return ([mod.marginal_loglikelihood(p, ys), joint, marg]
                + [getattr(g, f.name) for f in
                   dataclasses.fields(g)]
                + [mod.latent_var_distr(p, ys, lag=lag)
                   for lag in (None, 0, -2, 3)])

    n_or, T_or = sizes["oracle"]
    worst = 0.0
    for name in names:
        for k, m, T_c in ((2, 1, T_len), (3, 2, T_or)):
            p = random_chains(name, n_or, k, m)
            lags = int(name == "arphmm")              # p = 1
            ys = registry.get_model(name, num_states=k, m=m).generate_data(
                None, params_map(lambda x: x[:1], p), T_c,
                draws=(torch.as_tensor(rng.random(T_c + lags + 1)),
                       torch.as_tensor(rng.standard_normal(
                           (T_c + lags, m)))))[0]
            (out_card, secs) = timed(lambda: oracle(
                name, p.to(dev), ys.to(dev)))
            out_cpu = oracle(name, p, ys)
            rel = max(float((a.cpu() - b).norm() / b.norm())
                      for a, b in zip(out_card, out_cpu))
            worst = max(worst, rel)
            phase("26 exact card-cpu", f"{name} K={k} m={m} T={T_c}, "
                  f"{n_or} chains: the marginal log-likelihood, its "
                  f"gradient, the posterior marginals and latent_var_distr "
                  f"(lag None, 0, -2, 3), float64: largest normwise "
                  f"relative difference {rel:.3e} (bound 1e-9); {secs:.2f} "
                  f"s on {dev.type}")
    if not worst <= 1e-9:
        raise AssertionError(f"HMM card vs CPU {worst}")

    # (b) the fits at full width: SGLD on the exact messages at the
    # driver's S=16, B=4 and at S=40, B=10, the complete kind, SCIR and
    # Gibbs, with their steps/s
    iters = sizes["iters"]
    rates = {}
    for name in names:
        ys = data[name][0]
        for label, kw in (("marginal S=16 B=4", dict(
                kind="marginal", subsequence_length=16, buffer_length=4)),
                ("marginal S=40 B=10", dict(
                    kind="marginal", subsequence_length=40,
                    buffer_length=10)),
                ("complete S=16 B=4", dict(
                    kind="complete", num_samples=1, subsequence_length=16,
                    buffer_length=4))):
            smp = samplers.sampler_for_model(name, observations=ys,
                                             device=dev, seed=1,
                                             parameters=start[name])
            smp.fit_scan("SGLD", num_iters=2, num_chains=C, record="none",
                         **kw)
            _, secs = timed(lambda: smp.fit_scan(
                "SGLD", num_iters=iters, num_chains=C, record="none", **kw))
            check_finite(f"{name} {label}", smp.parameters.logit_pi,
                         getattr(smp.parameters, loc[name]))
            rates[(name, label)] = C * iters / secs
            phase("26 fit", f"{name} SGLD {label}: {C} chains x {iters} "
                  f"iterations in {secs:.3f} s, {C * iters / secs:,.0f} "
                  f"steps/s, (K1, resample-apply) launches (0, 0) ({card})")
        smp = samplers.sampler_for_model(name, observations=ys, device=dev,
                                         seed=2, parameters=start[name])
        smp._chain_init_params(C, "replicate")
        kw = dict(subsequence_length=16, buffer_length=4)
        smp.sample_sgld_scir(0.1, **kw)
        _, secs = timed(lambda: [smp.sample_sgld_scir(0.1, **kw)
                                 for _ in range(iters)])
        pi = smp.parameters.pi
        ok = bool(torch.isfinite(pi).all() and (pi > 0).all())
        rates[(name, "SCIR")] = C * iters / secs
        # SCIR's noncentral chi-square draws at the driver's epsilon on
        # this state's Dirichlet statistics
        score = sgmcmc.make_marginal_score_fn(
            lambda q, w, v, wt, B_, S_: smp.model.windowed_marginal_gradient(
                q, w, v, wt, B_, S_, use_scir=True),
            smp._score_config(**kw), smp.T)
        a = score(gen, smp.parameters, smp.observations)[0].logit_pi \
            + smp.prior.alpha_pi
        decay = float(np.exp(-0.1))
        W = hmm.sample_noncentral_chi2(
            gen, 2.0 * a, 2.0 * torch.exp(smp.parameters.logit_pi) * decay
            / (1.0 - decay))
        w_ok = bool(torch.isfinite(W).all() and (W >= 0).all())
        ratio = rates[(name, "SCIR")] / rates[(name, "marginal S=16 B=4")]
        phase("26 SCIR", f"{name}: {C} chains x {iters} steps in {secs:.3f} "
              f"s, {C * iters / secs:,.0f} steps/s ({ratio:.2f}x SGLD's); "
              f"every pi finite and > 0 {ok} (min {float(pi.min()):.3e}); "
              f"W at eps=0.1 finite and >= 0 for every chain {w_ok} (min "
              f"{float(W.min()):.3e}, {int((W == 0).sum())} of "
              f"{W.numel()} zero) ({card})")
        if not (ok and w_ok):
            raise AssertionError(f"{name} SCIR: pi {ok}, W {w_ok}")
        Cg, sweeps = sizes["gibbs"]
        smp = samplers.sampler_for_model(name, observations=ys, device=dev,
                                         seed=3, parameters=start[name])
        smp._chain_init_params(Cg, "replicate")
        smp.sample_gibbs()
        _, secs = timed(lambda: [smp.sample_gibbs() for _ in range(sweeps)])
        check_finite(f"{name} Gibbs", smp.parameters.logit_pi)
        phase("26 Gibbs", f"{name}: {sweeps} sweeps of {Cg} chains at "
              f"T={T_len} in {secs:.3f} s, {secs / sweeps:.4f} s a sweep "
              f"({card})")

    # (c) statistical checks: Gibbs recovery of the locations, FFBS in law
    Cr, sweeps = sizes["recovery"]
    for name in names:
        smp = samplers.sampler_for_model(name, observations=data[name][0],
                                         device=dev, seed=4,
                                         parameters=start[name])
        smp._chain_init_params(Cr, "replicate")
        kept = []
        for i in range(sweeps):
            smp.sample_gibbs()
            if i >= sweeps // 2:
                kept.append(torch.sort(getattr(smp.parameters, loc[name])
                                       .reshape(Cr, -1), -1)[0])
        est = torch.stack(kept).mean(0)                # [Cr, K]
        want = torch.sort(getattr(truth[name], loc[name]).reshape(-1))[0]
        med = est.median(0).values
        sd = kept[-1].std(0)
        zs = ((med - want).abs() / sd).cpu().numpy()
        first = getattr(start[name], loc[name]).reshape(-1).tolist()
        phase("26 Gibbs recovery", f"{name}: {Cr} chains, {sweeps} sweeps "
              f"from pi uniform, {loc[name]} = {first}, R = 1, the last "
              f"{sweeps - sweeps // 2} averaged: the chains' median sorted "
              f"{loc[name]} {med.cpu().numpy().round(4)} against "
              f"{want.cpu().numpy()}, posterior sd (the chains' spread at "
              f"the last sweep) {sd.cpu().numpy().round(4)}: "
              f"{zs.round(2)} sds off (held below {HMM_GIBBS_SDS})")
        if not float(zs.max()) < HMM_GIBBS_SDS:
            raise AssertionError(f"{name} Gibbs recovery {med} vs {want}")
    Cf, T_f = sizes["ffbs"]
    ys = data["gauss_hmm"][0][:T_f]
    p1 = truth["gauss_hmm"]
    rows = params_map(lambda x: x.expand((Cf,) + x.shape[1:]), p1)
    z, secs = timed(lambda: gauss_hmm.latent_var_sample(rows, gen, ys))
    probs = gauss_hmm.latent_var_distr(p1, ys)[0].cpu().numpy()
    zc = z.cpu().numpy()
    counts = np.stack([(zc == j).sum(0) for j in range(2)], -1)
    expected = Cf * probs
    keep = expected.min(-1) >= 5
    chi2 = float(((counts - expected) ** 2 / expected)[keep].sum())
    pval = float(stats.chi2.sf(chi2, int(keep.sum())))
    phase("26 FFBS", f"gauss_hmm: {Cf} FFBS paths of T={T_f} on the card "
          f"({secs:.3f} s) against the smoothed marginals: chi-square "
          f"{chi2:.1f} on {int(keep.sum())} degrees of freedom (rows with "
          f"5 or more expected draws in each state), p = {pval:.4f} (held "
          f"above 1e-3)")
    if not pval > 1e-3:
        raise AssertionError(f"FFBS marginals p = {pval}")

    # (d) the Seq samplers on SEQ_LENGTHS, one sequence a gradient
    for name in names:
        model = registry.get_model(name)
        seqs = [model.generate_data(gen, truth[name], n)[0]
                for n in sizes["seq"]]
        cls = (samplers.SeqGaussHMMSampler if name == "gauss_hmm"
               else samplers.SeqARPHMMSampler)
        smp = cls(seqs, device=dev, seed=5, parameters=start[name])
        kw = dict(subsequence_length=16, buffer_length=4, num_sequences=1)
        smp.fit_scan("SGLD", num_iters=1, num_chains=C, record="none", **kw)
        n_it = sizes["seq_iters"]
        _, secs = timed(lambda: smp.fit_scan(
            "SGLD", num_iters=n_it, num_chains=C, record="none", **kw))
        ll = smp.exact_loglikelihood()
        check_finite(f"Seq {name}", smp.parameters.logit_pi, ll)
        phase("26 Seq", f"{cls.__name__} on {len(seqs)} sequences of "
              f"{min(sizes['seq'])}-{max(sizes['seq'])} steps, S=16, B=4, "
              f"one sequence a gradient: {C} chains x {n_it} iterations in "
              f"{secs:.3f} s, {C * n_it / secs:,.0f} steps/s; exact "
              f"log-likelihood finite for every chain ({card})")

    # (e) predict at T=1000, one chain at the truth
    for name in names:
        smp = samplers.sampler_for_model(name, observations=data[name][0],
                                         device=dev, seed=6,
                                         parameters=truth[name])
        probs, secs = timed(lambda: smp.predict())
        _, secs_s = timed(lambda: smp.predict(num_samples=100))
        _, secs_l = timed(lambda: smp.predict(lag=5))
        rows = mf.metric_compare_z(data[name][1].cpu().numpy())(smp)
        acc = rows[-1]["value"]
        phase("26 predict", f"{name} T={T_len}: smoothed state "
              f"probabilities {secs:.3f} s, 100 FFBS paths {secs_s:.3f} s, "
              f"lag 5 {secs_l:.3f} s; metric_compare_z " + ", ".join(
                  f"{r['metric']} {r['value']:.3f}" for r in rows)
              + f" ({card})")
        # the GaussHMM's states lie 2.8 emission sds apart; the ARPHMM's
        # differ in the sign of their AR coefficient alone (printed)
        if not (np.allclose(probs.sum(-1), 1.0)
                and (name == "arphmm" or acc > 0.7)):
            raise AssertionError(f"{name} predict: accuracy {acc}")

    # (f) the experiment driver's HMM grid for the GaussHMM: setup at
    # T=1000, every fit (iterations cut), eval, KSD, KS and
    # metric_compare_z on the Gibbs fit
    tmp = tempfile.mkdtemp(prefix="chip_smoke_26_")
    args = driver.build_parser().parse_args([
        "--path", os.path.join(tmp, "gauss_hmm"), "--model", "gauss_hmm",
        "--device", dev.type, "--T", str(T_len), "--T_test", str(T_len)])
    args.num_to_eval, args.eval_predictive = sizes["driver_eval"]
    args.max_ksd_samples = sizes["ksd_samples"]
    grid = [dict(o, max_num_iters=sizes["driver_iters"])
            for o in driver.default_sampler_grid("gauss_hmm")]
    opts, secs = timed(lambda: driver.do_setup(args, grid))
    phase("26 driver setup", f"gauss_hmm T={T_len}: {len(opts)} experiments "
          f"({', '.join(sorted({o['name'] for o in opts}))}) in {secs:.2f} "
          f"s; max_num_iters cut to {sizes['driver_iters']}")
    dd = driver.ckpt.load_pickle(os.path.join(tmp, "gauss_hmm", "in",
                                              "data.p"))
    for o in opts:
        smp, secs = timed(lambda: driver.do_fit(args, o))
        finite = all(bool(torch.isfinite(x).all()) for x in (
            smp.parameters.logit_pi, smp.parameters.mu,
            smp.parameters.LRinv_vec))
        # SGLD at the grid's epsilon=0.1 from a far prior draw (mu ~ N(0,
        # 100 R)) can diverge, in the JAX package's sampler as in the
        # port's: only the truth-init and Gibbs fits are held finite
        if not finite and (o["init_method"] == "truth"
                           or o["name"] == "GIBBS"):
            raise AssertionError(f"driver fit {o['experiment_id']} is not "
                                 f"finite")
        msg = f"; parameters finite {finite}"
        if o["name"] == "GIBBS":
            rows = mf.metric_compare_z(dd["latent_vars"])(smp)
            msg += "; metric_compare_z " + ", ".join(
                f"{r['metric']} {r['value']:.3f}" for r in rows)
        phase("26 driver fit", f"{o['name']} B={o.get('buffer_length')} "
              f"init={o['init_method']}: {sizes['driver_iters']} iterations "
              f"x {o.get('steps_per_iteration', 1)} steps in {secs:.2f} s"
              f"{msg}")
    ev = next(o for o in opts if o["name"] == "SCIR"
              and o["init_method"] == "truth")
    _, secs = timed(lambda: driver.do_eval(args, ev, "half_avg_test"))
    ksd, secs_k = timed(lambda: driver.do_eval_ksd(args, ev))
    ks_rows = driver.do_eval_ks_test(args, ev, opts)
    agg = driver.do_process_out(args, opts)
    phase("26 driver eval", f"SCIR (truth init): half_avg_test in "
          f"{secs:.2f} s (num_to_eval {args.num_to_eval}, the exact "
          f"{args.eval_predictive}-step predictive log-likelihood), KSD over "
          f"{args.max_ksd_samples} exact scores in {secs_k:.2f} s {ksd}, "
          f"{len(ks_rows)} KS rows, aggregated {len(agg)} rows")
    if not all(np.isfinite(list(ksd.values()))):
        raise AssertionError(f"HMM KSD {ksd}")
    phase("26 seconds", f"{time.perf_counter() - t_phase:.1f} s")
    return rates


# Phase 27: the parallel-in-time messages and the switching LDS (float64,
# plain PyTorch: no kernel of this script lies on their paths, and every
# timed call checks 0 launches).  parallel: chains of the card-vs-CPU
# check, T and the timed chain counts; slds: the card-vs-CPU chains, the
# Gibbs sweep's and the complete-data SGLD's chains and repetitions, the
# distributional anchor's sizes and the driver's iterations and eval
# points.  The anchor is tests/test_slds.py:165-216 chain-batched: its
# T=200 series (truth pi 0.95 / 0.05, A = 0.9, -0.9, Q = 0.3, R = 0.1,
# drawn on the CPU from seed 3), Gibbs and full-series complete SGLD (one
# latent draw after 8 sweeps) from the truth.  The JAX test runs one chain
# 6000 steps at epsilon 5e-3; here 1024 chains run 100 steps at epsilon
# 0.1 and the last 20 of every chain are pooled: a step costs ~44,000
# device operations (the host sets its time), and the slowest coordinate,
# LQinv_k, relaxes ~20x faster a step at 0.1 (CPU rehearsals at 64-128
# chains on the same series: shifts 0.03-0.37 sd after 90-150 steps).
PARALLEL_SIZES = dict(T=T, oracle=64, timing=(1, 1024), reps=3)
SLDS_SIZES = dict(T=T, oracle=64, gibbs=(1024, 3), sgld=(C_BENCH, 3),
                  anchor=dict(T=200, chains=1024, sweeps=50, sweep_burn=20,
                              steps=100, keep=20, eps=0.1, latent_burnin=8),
                  driver_iters=2, driver_eval=2)
ANCHOR_SHIFT, ANCHOR_RATIO = 0.5, (0.5, 1.6)


def device_ops(fn):
    """(fn(), the device operations it ran: kernels, copies and fills in
    a torch.profiler trace; None where the trace holds no device
    activity)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return res, (n or None)


def parallel_slds_phase(dev, card, psizes=PARALLEL_SIZES, sizes=SLDS_SIZES):
    """Phase 27 on ``dev`` (the CPU for a rehearsal at small sizes): the
    parallel-in-time messages (card against CPU, against the sequential
    functions on the card, their wall time and device operations beside
    the sequential ones, the autograd score against the analytic one) and
    the SLDS (card against CPU on shared draws, a Gibbs sweep at 1024
    chains, complete-data SGLD at 8192, the Gibbs-against-SGLD anchor, the
    driver's SLDS grid)."""
    import dataclasses
    import os
    import tempfile
    import numpy as np
    from sgmcmc_tpu_torch.experiments import driver
    from sgmcmc_tpu_torch.inference import samplers
    from sgmcmc_tpu_torch.models import gauss_hmm, lgssm, slds
    from sgmcmc_tpu_torch.models.base import params_map
    from sgmcmc_tpu_torch.ops import hmm, kalman
    from sgmcmc_tpu_torch.ops.cuda import fused_pf, resample
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(27)
    cpu = torch.device("cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def timed(fn):
        """(result, seconds) of fn(), which launches neither kernel."""
        sync()
        reset_counts(fused_pf, resample)
        t0 = time.perf_counter()
        res = fn()
        sync()
        got = (fused_pf.fused_window.launches,
               resample.resample_apply.launches)
        if got != (0, 0):
            raise AssertionError(f"a phase 27 path launched {got}")
        return res, time.perf_counter() - t0

    def rel(a, b):
        """Normwise relative difference of tensors (or tuples of them)."""
        if isinstance(a, (tuple, list)):
            return max(rel(x, y) for x, y in zip(a, b))
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        return float((a - b).norm() / b.norm().clamp(min=1e-300))

    def fields(p):
        return [getattr(p, f) for f in ("A", "C", "LQinv_vec", "LRinv_vec")]

    # (a) the parallel-in-time functions on the card against the CPU on the
    # same float64 inputs: the LGSSM at n = m = 1 and 2, the GaussHMM
    T_len, n_or = psizes["T"], psizes["oracle"]

    def lgssm_chains(n, count):
        """``count`` chains of the n = m LGSSM: random rotations A and
        emissions C, tests/test_kalman_parallel.py's Q and R."""
        p = lgssm.from_matrices(np.eye(n), np.eye(n), np.eye(n) * 0.5
                                + 0.1 * np.ones((n, n)), np.eye(n) * 0.8,
                                dtype=torch.float64)
        return lgssm.LGSSMParams(
            A=torch.as_tensor(np.stack([
                0.8 * np.linalg.qr(rng.normal(size=(n, n)))[0]
                for _ in range(count)])),
            C=torch.as_tensor(rng.normal(size=(count, n, n)) / np.sqrt(n)),
            LQinv_vec=p.LQinv_vec.repeat(count, 1),
            LRinv_vec=p.LRinv_vec.repeat(count, 1))

    def series(n):
        """T observations y_t = x_t + noise of an AR(1) state."""
        x, ys = np.zeros(n), []
        for _ in range(T_len):
            x = 0.8 * x + rng.normal(size=n) * 0.7
            ys.append(x + rng.normal(size=n) * 0.9)
        return torch.as_tensor(np.array(ys))

    def lgssm_parallel(p, y):
        fm = lgssm.parallel_latent_var_distr(p, y, smoothed=False)
        return (lgssm.parallel_marginal_loglikelihood(p, y), *fm,
                *lgssm.parallel_latent_var_distr(p, y),
                *fields(lgssm.parallel_gradient_marginal_loglikelihood(p, y)))

    def lgssm_sequential(p, y):
        fwd = lgssm.default_forward_message(p)
        fm = kalman.filtered_moments(y, p.A, p.C, p.LQinv, p.LRinv, fwd)
        return (lgssm.marginal_loglikelihood(p, y), *fm,
                *lgssm.latent_var_distr(p, y),
                *fields(lgssm.gradient_marginal_loglikelihood(p, y)))

    pis = rng.dirichlet(np.ones(2) * 3, size=(n_or, 2))
    hp = gauss_hmm.GaussHMMParams(
        logit_pi=torch.as_tensor(np.log(pis)),
        mu=torch.as_tensor(rng.normal(size=(n_or, 2, 1))),
        LRinv_vec=torch.as_tensor(1.0 + rng.random((n_or, 2, 1))))
    hy = torch.as_tensor(rng.normal(size=(T_len, 1)) * 1.5)

    def hmm_parallel(p, y):
        logP = gauss_hmm.emission_logliks(p, y)
        f0 = gauss_hmm.default_forward_message(p)
        msg = hmm.parallel_forward_messages(logP, p.pi, f0)
        return (gauss_hmm.parallel_marginal_loglikelihood(p, y), msg.prob,
                msg.log_constant)

    def hmm_sequential(p, y):
        logP = gauss_hmm.emission_logliks(p, y)
        f0 = gauss_hmm.default_forward_message(p)
        msg = hmm.forward_messages(logP, p.pi, f0)
        return (gauss_hmm.marginal_loglikelihood(p, y), msg.prob,
                msg.log_constant)

    cases = [("lgssm n=m=1", lgssm_chains(1, n_or), series(1),
              lgssm_parallel, lgssm_sequential),
             ("lgssm n=m=2", lgssm_chains(2, n_or), series(2),
              lgssm_parallel, lgssm_sequential),
             ("gauss_hmm K=2", hp, hy, hmm_parallel, hmm_sequential)]
    worst_cpu, worst_seq = 0.0, 0.0
    for label, p, y, par, seq in cases:
        (out_card, secs) = timed(lambda: par(p.to(dev), y.to(dev)))
        d_cpu = rel(out_card, par(p, y))
        seq_card, _ = timed(lambda: seq(p.to(dev), y.to(dev)))
        d_seq = rel(out_card, seq_card)
        worst_cpu, worst_seq = max(worst_cpu, d_cpu), max(worst_seq, d_seq)
        phase("27 parallel", f"{label}, {n_or} chains, T={T_len}, float64 "
              f"(log-likelihood, filtered and smoothed moments, score; HMM: "
              f"the forward messages): card against CPU {d_cpu:.3e} (bound "
              f"1e-9), parallel against sequential on {dev.type} "
              f"{d_seq:.3e} (bound 1e-8); {secs:.3f} s")
    if not (worst_cpu <= 1e-9 and worst_seq <= 1e-8):
        raise AssertionError(f"parallel-in-time: card vs CPU {worst_cpu}, "
                             f"parallel vs sequential {worst_seq}")

    phase("27 seconds", f"(a) {time.perf_counter() - t_phase:.1f} s")

    # (b) parallel against sequential log-likelihood: wall time and device
    # operations at T=1000, one chain and 1024
    timing = {}
    for C_t in psizes["timing"]:
        for label, p, y, par_ll, seq_ll in (
                ("lgssm n=m=1", cases[0][1], cases[0][2],
                 lgssm.parallel_marginal_loglikelihood,
                 lgssm.marginal_loglikelihood),
                ("gauss_hmm K=2", hp, hy,
                 gauss_hmm.parallel_marginal_loglikelihood,
                 gauss_hmm.marginal_loglikelihood)):
            rows = params_map(lambda v: v[:1].expand(
                (C_t,) + v.shape[1:]).to(dev), p)
            yd = y.to(dev)
            row = {}
            for kind, fn in (("parallel", par_ll), ("sequential", seq_ll)):
                fn(rows, yd)
                secs = sorted(timed(lambda: fn(rows, yd))[1]
                              for _ in range(psizes["reps"]))
                ops = device_ops(lambda: fn(rows, yd))[1] if cuda else None
                row[kind] = (secs[len(secs) // 2], ops)
            timing[(label, C_t)] = row
            (tp, op), (ts, os_) = row["parallel"], row["sequential"]
            phase("27 parallel timing", f"{label}, C={C_t}, T={T_len}: "
                  f"parallel_marginal_loglikelihood {tp * 1e3:.2f} ms, "
                  f"{op} device operations; sequential {ts * 1e3:.2f} ms, "
                  f"{os_} device operations: {ts / tp:.1f}x the wall time"
                  + (f", {os_ / op:.1f}x the operations" if op else "")
                  + f" (median of {psizes['reps']}; {card})")

    phase("27 seconds", f"(b) {time.perf_counter() - t_phase:.1f} s")

    # (c) the SLDS on the card against the CPU on shared draws: x | z
    # messages, the x FFBS, a Gibbs sweep and the windowed complete score
    T_s, n_s = sizes["T"], sizes["oracle"]
    truth = driver._make_true_params("slds")
    gen = torch.Generator().manual_seed(27)
    ys, _, _ = slds.generate_data(gen, truth, T_s)
    sp = params_map(lambda v: v.expand((n_s,) + v.shape[1:]).contiguous(),
                    truth)
    sp = dataclasses.replace(sp, A=sp.A * torch.as_tensor(
        rng.uniform(0.7, 1.1, (n_s, 2, 1, 1))).clamp(max=0.999))
    z0 = torch.as_tensor(rng.integers(0, 2, (n_s, T_s)))
    x0 = torch.as_tensor(rng.normal(size=(n_s, T_s, 1)))
    draws = slds.SLDSDraws(
        gamma=torch._standard_gamma(torch.full((n_s, 2, 2), 3.0,
                                               dtype=torch.float64)),
        q_chi2=2.0 * torch._standard_gamma(torch.full((n_s, 2, 1), 300.0,
                                                      dtype=torch.float64)),
        q_off=torch.zeros((n_s, 2, 0), dtype=torch.float64),
        a_normals=torch.randn((n_s, 2, 1, 1), dtype=torch.float64),
        r_chi2=2.0 * torch._standard_gamma(torch.full((n_s, 1), 500.0,
                                                      dtype=torch.float64)),
        r_off=torch.zeros((n_s, 0), dtype=torch.float64),
        c_normals=torch.randn((n_s, 1, 1), dtype=torch.float64),
        x_normals=torch.randn((n_s, T_s, 1), dtype=torch.float64),
        z_uniforms=torch.rand((n_s, T_s), dtype=torch.float64))
    wts = torch.as_tensor(rng.uniform(0.0, 2.0, (n_s, T_s)))

    def slds_oracle(d, p, y, x, z, dr, w):
        on = lambda v: None if v is None else v.to(d)  # noqa: E731
        p, y, x, z, w = p.to(d), y.to(d), x.to(d), z.to(d), w.to(d)
        dr = slds.SLDSDraws(*map(on, dr))
        fwd = slds.x_forward_messages(p, y, z)
        xs = slds.x_latent_var_sample(p, None, y, z, dr.x_normals)
        new, x1, z1 = slds.gibbs_step(
            None, slds.default_prior(2, 1, 1, device=d), p, y, x, z, dr)
        grad, ll = slds.windowed_complete_gradient(p, y, x1, z1, w)
        return (*fwd, xs, *[getattr(new, f) for f in vars(new)], x1,
                *[getattr(grad, f) for f in vars(grad)], ll), z1

    (out_card, z_card), secs = timed(lambda: slds_oracle(
        dev, sp, ys, x0, z0, draws, wts))
    out_cpu, z_cpu = slds_oracle(cpu, sp, ys, x0, z0, draws, wts)
    d_slds = rel(out_card, out_cpu)
    z_same = bool(torch.equal(z_card.cpu(), z_cpu))
    phase("27 slds card-cpu", f"K=2, n=m=1, T={T_s}, {n_s} chains, float64, "
          f"on shared draws: x_forward_messages, x_latent_var_sample, "
          f"gibbs_step and windowed_complete_gradient, largest normwise "
          f"relative difference {d_slds:.3e} (bound 1e-9); the sweep's z "
          f"paths equal {z_same}; {secs:.2f} s on {dev.type}")
    if not (d_slds <= 1e-9 and z_same):
        raise AssertionError(f"SLDS card vs CPU {d_slds}, z equal {z_same}")

    # (d) a Gibbs sweep of 1024 chains and complete-data SGLD at 8192
    # chains (the driver grid's S=16, B=4, one latent draw after 5 sweeps,
    # 5 sweeps of thinning), T=1000
    ys_d = ys.to(dev)
    Cg, sweeps = sizes["gibbs"]
    smp = samplers.SLDSSampler(ys_d, device=dev, seed=1,
                               parameters=params_map(
                                   lambda v: v.expand((Cg,) + v.shape[1:])
                                   .contiguous(), truth))
    smp.sample_gibbs()
    _, secs = timed(lambda: [smp.sample_gibbs() for _ in range(sweeps)])
    ops = device_ops(smp.sample_gibbs)[1] if cuda else None
    check_finite("SLDS Gibbs", smp.parameters.A, smp.parameters.LQinv_vec)
    gibbs_s = secs / sweeps
    phase("27 slds Gibbs", f"{sweeps} sweeps of {Cg} chains at T={T_s} in "
          f"{secs:.3f} s, {gibbs_s:.4f} s a sweep, {ops} device operations "
          f"a sweep ({card})")
    Cs, steps = sizes["sgld"]
    kw = dict(subsequence_length=16, buffer_length=4, latent_draws=1,
              latent_burnin=5)
    smp = samplers.SLDSSampler(ys_d, device=dev, seed=2,
                               parameters=params_map(
                                   lambda v: v.expand((Cs,) + v.shape[1:])
                                   .contiguous(), truth))
    smp.sample_sgld(0.05, **kw)
    _, secs = timed(lambda: [smp.sample_sgld(0.05, **kw)
                             for _ in range(steps)])
    ops = device_ops(lambda: smp.sample_sgld(0.05, **kw))[1] if cuda \
        else None
    check_finite("SLDS SGLD", smp.parameters.A, smp.parameters.LQinv_vec)
    sgld_rate = Cs * steps / secs
    phase("27 slds SGLD", f"complete-data SGLD, epsilon 0.05, S=16, B=4, "
          f"1 + 5 + 5 latent sweeps: {Cs} chains x {steps} steps in "
          f"{secs:.3f} s, {sgld_rate:,.0f} steps/s, {ops} device "
          f"operations a step ({card})")

    phase("27 seconds", f"(c, d) {time.perf_counter() - t_phase:.1f} s")

    # (e) the distributional anchor: Gibbs against full-series complete
    # SGLD from the truth, chain-batched
    az = sizes["anchor"]
    a_truth = slds.from_values([[0.95, 0.05], [0.05, 0.95]],
                               [[[0.9]], [[-0.9]]], [[[0.3]], [[0.3]]],
                               [[1.0]], [[0.1]])
    a_ys = slds.generate_data(torch.Generator().manual_seed(3), a_truth,
                              az["T"])[0].to(dev)
    a_truth = a_truth.to(dev)
    Ca = az["chains"]
    many = params_map(lambda v: v.expand((Ca,) + v.shape[1:]).contiguous(),
                      a_truth)

    def coords(p):
        return torch.cat([p.A.reshape(Ca, -1), p.LQinv_vec.reshape(Ca, -1)],
                         -1)

    g = samplers.SLDSSampler(a_ys, device=dev, seed=1, parameters=many)
    kept = []

    def gibbs_run():
        for i in range(az["sweeps"]):
            g.sample_gibbs()
            g.project_parameters()
            if i >= az["sweep_burn"]:
                kept.append(coords(g.parameters))
    _, secs_g = timed(gibbs_run)
    G = torch.cat(kept)
    s = samplers.SLDSSampler(a_ys, device=dev, seed=2, parameters=many)
    akw = dict(subsequence_length=-1, latent_draws=1,
               latent_burnin=az["latent_burnin"], latent_thinning=0)
    hist = []

    def sgld_run():
        for _ in range(az["steps"]):
            s.sample_sgld(az["eps"], **akw)
            hist.append(coords(s.parameters))
    _, secs_s = timed(sgld_run)
    S = torch.cat(hist[-az["keep"]:])
    check_finite("SLDS anchor", G, S)
    shift = ((G.mean(0) - S.mean(0)).abs() / G.std(0)).cpu().numpy()
    ratio = (S.std(0) / G.std(0)).cpu().numpy()
    names = ["A_0", "A_1", "LQinv_0", "LQinv_1"]
    phase("27 slds anchor", f"T={az['T']}: Gibbs {Ca} chains x "
          f"{az['sweeps']} sweeps ({secs_g:.1f} s, the last "
          f"{az['sweeps'] - az['sweep_burn']} kept) against full-series "
          f"complete SGLD (epsilon {az['eps']}, {az['latent_burnin']} latent "
          f"sweeps) {Ca} chains x {az['steps']} steps ({secs_s:.1f} s, the "
          f"last {az['keep']} kept) from the truth: shifts (sd) "
          + ", ".join(f"{k} {v:.3f}" for k, v in zip(names, shift))
          + " (held below 0.5); sd ratios "
          + ", ".join(f"{k} {v:.3f}" for k, v in zip(names, ratio))
          + f" (held in 0.5-1.6); Gibbs posterior sd "
          f"{G.std(0).cpu().numpy().round(4)}")
    if not (shift.max() < ANCHOR_SHIFT and ratio.min() > ANCHOR_RATIO[0]
            and ratio.max() < ANCHOR_RATIO[1]):
        raise AssertionError(f"SLDS anchor: shifts {shift}, ratios {ratio}")

    phase("27 seconds", f"(e) {time.perf_counter() - t_phase:.1f} s")

    # (f) the experiment driver's SLDS grid: setup at T=1000, GIBBS and
    # SGLD_COMPLETE (iterations cut), eval, --num_chains 2 raising
    tmp = tempfile.mkdtemp(prefix="chip_smoke_27_")
    args = driver.build_parser().parse_args([
        "--path", os.path.join(tmp, "slds"), "--model", "slds", "--device",
        dev.type, "--T", str(T_s), "--T_test", str(T_s)])
    args.num_to_eval = sizes["driver_eval"]
    grid = [dict(o, max_num_iters=sizes["driver_iters"])
            for o in driver.default_sampler_grid("slds")]
    opts, secs = timed(lambda: driver.do_setup(args, grid))
    phase("27 driver setup", f"slds T={T_s}: {len(opts)} experiments "
          f"({', '.join(sorted({o['name'] for o in opts}))}; inits "
          f"{args.init_methods}) in {secs:.2f} s; max_num_iters cut to "
          f"{sizes['driver_iters']}")
    for o in opts:
        smp, secs = timed(lambda: driver.do_fit(args, o))
        finite = all(bool(torch.isfinite(getattr(smp.parameters, f)).all())
                     for f in ("logit_pi", "A", "LQinv_vec", "LRinv_vec"))
        if not finite and (o["init_method"] == "truth"
                           or o["name"] == "GIBBS"):
            raise AssertionError(f"SLDS driver fit {o['experiment_id']}")
        phase("27 driver fit", f"{o['name']} init={o['init_method']}: "
              f"{sizes['driver_iters']} iterations x "
              f"{o.get('steps_per_iteration', 1)} steps in {secs:.2f} s; "
              f"parameters finite {finite}")
    ev = next(o for o in opts if o["name"] == "SGLD_COMPLETE"
              and o["init_method"] == "truth")
    _, secs = timed(lambda: driver.do_eval(args, ev, "half_avg_test"))
    rows = driver.tables.read_csv(os.path.join(
        tmp, "slds", "out", "eval",
        f"{ev['experiment_id']}_half_avg_test_metrics.csv")).rows
    lj = [r["value"] for r in rows if r["metric"] == "logjoint"]
    phase("27 driver eval", f"SGLD_COMPLETE (truth init): half_avg_test in "
          f"{secs:.2f} s ({args.num_to_eval} points, the noisy log-joint "
          f"of the full-series complete score): logjoint {lj}")
    if not (lj and np.all(np.isfinite(lj))):
        raise AssertionError(f"SLDS eval rows {rows}")
    args.num_chains = 2
    for o in opts:
        try:
            driver.do_fit(args, o)
        except ValueError as e:
            msg = str(e)
        else:
            raise AssertionError("--num_chains 2 ran for the SLDS")
    phase("27 driver multichain", f"--num_chains 2 raises for GIBBS and "
          f"SGLD_COMPLETE: {msg}")
    phase("27 seconds", f"{time.perf_counter() - t_phase:.1f} s")
    return dict(gibbs_s=gibbs_s, sgld_rate=sgld_rate, timing=timing,
                anchor=(shift, ratio))


def paris_phase(dev, card, sizes=PARIS_SIZES):
    """Phase 20 on ``dev`` (the CPU for a rehearsal at small ``sizes``):
    PaRIS through the public samplers, resample-apply at its shapes, the
    LGSSM score against the Kalman gradient, paris_ar against paris in law,
    and the card against the CPU.  Returns the report's numbers."""
    from sgmcmc_tpu_torch.inference import samplers, sgmcmc
    from sgmcmc_tpu_torch.models import lgssm, registry, svm
    from sgmcmc_tpu_torch.ops import buffered, smoothers
    from sgmcmc_tpu_torch.ops.cuda import fused_pf, resample
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(20)
    T_len = sizes["T"]
    ys, _ = svm.generate_data(gen, svm.from_scalars(0.9, 0.5, 1.0,
                                                    device=dev), T_len)
    out = {}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_reset():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return (torch.cuda.max_memory_allocated() / 2 ** 30 if cuda
                else float("nan"))

    def launches():
        return (fused_pf.fused_window.launches,
                resample.resample_apply.launches)

    def fit(smp, n_iters, C, expect_ra, **kw):
        """One timed fit_scan: (seconds, (K1, resample-apply) launches,
        peak GiB)."""
        peak_reset()
        reset_counts(fused_pf, resample)
        t0 = time.perf_counter()
        _, aux = smp.fit_scan("SGLD", num_iters=n_iters, epsilon=0.1,
                              num_chains=C, record="none", return_aux=True,
                              **kw)
        float(aux[:, -1].sum())                   # synchronises
        dt = time.perf_counter() - t0
        got = launches()
        p = smp.parameters
        check_finite(f"the PaRIS fit {kw}", aux,
                     *[getattr(p, f) for f in p.__dataclass_fields__])
        if cuda and got != (0, expect_ra):
            raise AssertionError(f"(K1, resample-apply) launches {got}, "
                                 f"expected (0, {expect_ra}), for {kw}")
        return dt, got, peak_gib()

    # (a) resample-apply at the PaRIS paths' shapes (K = D = 1: the
    # particles alone), bitwise, then timed
    C_g, N_g, it_g = sizes["grid"]
    C_l, N_l, it_l = sizes["ld"]
    ra = {}
    for label, C, n_part in (("paris_100", C_g, N_g), ("paris_ld", C_l, N_l)):
        lw = 2.0 * torch.randn((C, n_part), generator=gen, device=dev)
        pos = torch.rand((C, n_part), generator=gen, device=dev)
        vals = torch.randn((C, n_part, 1), generator=gen, device=dev)
        cdf = resample.weights_cdf(lw)
        out_k = resample.resample_apply(pos, cdf, vals)
        out_r = resample.resample_apply_reference(pos, cdf, vals)
        sync()
        same = bool(torch.equal(out_k, out_r))
        err = float((out_k - out_r).abs().max())
        row = dict(max_abs_err=err)
        msg = ""
        if cuda:
            ms = cuda_ms(lambda: resample.resample_apply(pos, cdf, vals), 200)
            plain = cuda_ms(lambda: resample.resample_apply_reference(
                pos, cdf, vals), 200)
            lib = cuda_ms(lambda: resample.resample_apply_reference(
                pos, cdf, vals), 200)
            nbytes = 4 * (pos.numel() + cdf.numel() + 2 * vals.numel())
            bnd, by = bound_ms(nbytes, C * n_part * (n_part.bit_length() + 1))
            row.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by)
            msg = (f"; kernel {ms:.4f} ms, plain {plain:.4f} ms, PyTorch call "
                   f"{lib:.4f} ms, bound {bnd:.4f} ms by {by} ({card})")
        ra[label] = row
        phase("20 resample-apply", f"{label}: C={C} N={n_part} K=1: max "
              f"|kernel - plain| = {err!r}, bitwise equal {same}{msg}")
        if not same:
            raise AssertionError(f"resample-apply differs from its plain "
                                 f"version at {label}")
    out["resample_apply"] = ra

    # (b) PARIS_100: the experiment grid's entry at full width
    smp = samplers.SVMSampler(observations=ys, device=dev, seed=21)
    smp.parameters = svm.from_scalars(0.5, 1.0, 2.0)
    gkw = dict(pf="paris", N=N_g, subsequence_length=S, buffer_length=B)
    fit(smp, 1, C_g, W, **gkw)                              # warm-up
    dt, got, peak = fit(smp, it_g, C_g, it_g * W, **gkw)
    out["grid_launches"] = got[1]
    phase("20 PARIS_100", f"SVMSampler.fit_scan SGLD pf='paris' N={N_g} "
          f"S={S} B={B} T={T_len} C={C_g}: {it_g} iterations in {dt:.3f} s, "
          f"(K1, resample-apply) launches {got}, {C_g * it_g / dt:.1f} "
          f"aggregate steps/s, peak {peak:.3f} GiB ({card})")
    del smp

    # (c) the demo's LD leg: the whole series, N=1000
    smp = samplers.SVMSampler(observations=ys, device=dev, seed=22)
    smp.parameters = svm.from_scalars(0.5, 1.0, 2.0)
    lkw = dict(pf="paris", N=N_l, subsequence_length=-1,
               resample_mode="auto")
    dt, got, peak = fit(smp, it_l, C_l, it_l * T_len, **lkw)
    out["ld_launches"] = got[1]
    phase("20 LD", f"SVMSampler.fit_scan SGLD {lkw} T={T_len} C={C_l}: "
          f"{it_l} iterations in {dt:.3f} s, (K1, resample-apply) launches "
          f"{got} ({got[1] // it_l} a iteration), {C_l * it_l / dt:.2f} "
          f"aggregate steps/s, peak {peak:.3f} GiB ({card})")
    del smp

    # (d) the Seq LD leg: every sequence, whole, through the valid gate
    C_s, N_s, lengths = sizes["seq"]
    seqs = [svm.generate_data(gen, svm.from_scalars(0.9, 0.5, 1.0,
                                                    device=dev), n)[0]
            for n in lengths]
    smp = samplers.SeqSVMSampler(seqs, device=dev, seed=23)
    smp.parameters = svm.from_scalars(0.5, 1.0, 2.0)
    skw = dict(pf="paris", N=N_s, subsequence_length=-1, num_sequences=-1)
    dt, got, peak = fit(smp, 1, C_s, max(lengths), **skw)
    phase("20 Seq LD", f"SeqSVMSampler.fit_scan SGLD {skw} on "
          f"{len(lengths)} sequences of {min(lengths)}-{max(lengths)} steps, "
          f"C={C_s} ({C_s * len(lengths)} rows, W={max(lengths)}): 1 "
          f"iteration in {dt:.3f} s, (K1, resample-apply) launches {got}, "
          f"peak {peak:.3f} GiB ({card})")
    del smp, seqs

    # (e) PaRIS's LGSSM score against the Kalman gradient, and paris_ar
    # against paris in law on the same configuration
    C_o, T_o, N_o = sizes["oracle"]
    truth = lgssm.from_scalars(0.8, 0.5, 1.0, device=dev)
    ys_o, _ = lgssm.generate_data(gen, truth, T_o)
    exact = lgssm.gradient_marginal_loglikelihood(truth, ys_o)
    exact_vec = torch.stack([exact.LRinv_vec[0, 0], exact.LQinv_vec[0, 0],
                             exact.C[0, 0, 0], exact.A[0, 0, 0]])
    rows = lgssm.LGSSMParams(*[x.expand((C_o,) + x.shape[1:]).contiguous()
                               for x in (truth.A, truth.C, truth.LQinv_vec,
                                         truth.LRinv_vec)])
    ar = smoothers.accept_reject_backward_indices
    scores = {}
    for pf in ("paris", "paris_ar"):
        cfg = sgmcmc.PFScoreConfig(n_particles=N_o, smoother=pf,
                                   resample_mode="auto")
        score = sgmcmc.make_pf_score_fn(
            lgssm.OPTIMAL_KERNEL, lgssm.grad_statistic, 4, lgssm.unpack_grad,
            cfg, T_o, prior_mean_var_fn=registry.LGSSM.prior_mean_var)
        ar.calls = ar.rounds = ar.syncs = 0
        reset_counts(fused_pf, resample)
        sync()
        t0 = time.perf_counter()
        g, ll = score(gen, rows, ys_o)
        sync()
        dt = time.perf_counter() - t0
        f = torch.stack([g.LRinv_vec[:, 0], g.LQinv_vec[:, 0], g.C[:, 0, 0],
                         g.A[:, 0, 0]], 1).double()
        check_finite(f"PaRIS's LGSSM score ({pf})", f, ll)
        scores[pf] = f
        zval = (f.mean(0) - exact_vec) / (f.std(0) / C_o ** 0.5 + 1e-9)
        msg = ""
        if pf == "paris_ar":
            msg = (f"; accept-reject rounds {ar.rounds} in {ar.calls} steps "
                   f"(mean {ar.rounds / ar.calls:.1f}, budget "
                   f"{smoothers._default_ar_budget(N_o)}), host reads "
                   f"{ar.syncs}")
        phase("20 LGSSM oracle", f"pf={pf!r} T={T_o} N={N_o} over {C_o} "
              f"chains in {dt:.3f} s, (K1, resample-apply) launches "
              f"{launches()}; z [LRinv, LQinv, C, A] = "
              f"{[round(float(v), 3) for v in zval]}; exact "
              f"{[round(float(v), 4) for v in exact_vec]}{msg}")
        if not bool((zval.abs() < 5).all()):
            raise AssertionError(f"{pf}'s score is off the exact gradient: "
                                 f"z = {zval}")
        if cuda and launches() != (0, T_o):
            raise AssertionError(f"{pf}: launches {launches()}")
    a, b = scores["paris"], scores["paris_ar"]
    z_law = (b.mean(0) - a.mean(0)) / (
        (a.var(0) / C_o + b.var(0) / C_o) ** 0.5 + 1e-9)
    phase("20 paris_ar law", f"paris_ar against paris, {C_o} chains each: z "
          f"[LRinv, LQinv, C, A] = {[round(float(v), 3) for v in z_law]}")
    if not bool((z_law.abs() < 5).all()):
        raise AssertionError(f"paris_ar differs from paris in law: {z_law}")
    # what reading whether every lane has accepted costs: the default
    # interval, every round, and never before the budget (masked rounds)
    cfg = sgmcmc.PFScoreConfig(n_particles=N_o, smoother="paris_ar",
                               resample_mode="auto")
    score = sgmcmc.make_pf_score_fn(
        lgssm.OPTIMAL_KERNEL, lgssm.grad_statistic, 4, lgssm.unpack_grad,
        cfg, T_o, prior_mean_var_fn=registry.LGSSM.prior_mean_var)
    draws = score.draw(gen, C_o, dev)
    default_every = smoothers.AR_CHECK_EVERY
    costs = {default_every: [], 1: [], 10 ** 9: []}
    reads = {}
    try:
        # in turns (a, b, c, c, b, a), the same draws and rounds each time
        for every in (default_every, 1, 10 ** 9, 10 ** 9, 1, default_every):
            smoothers.AR_CHECK_EVERY = every
            ar.calls = ar.rounds = ar.syncs = 0
            sync()
            t0 = time.perf_counter()
            score(torch.Generator(device=dev).manual_seed(5), rows, ys_o,
                  draws)
            sync()
            costs[every].append((time.perf_counter() - t0) * 1e3)
            reads[every] = (ar.rounds, ar.syncs)
    finally:
        smoothers.AR_CHECK_EVERY = default_every
    phase("20 paris_ar reads", f"one score call, T={T_o}, {C_o} chains, "
          f"reading accepted.all() " + "; ".join(
              f"every {e if e < 10 ** 9 else 'never'}: "
              f"{' / '.join(f'{t:.1f}' for t in ts)} ms, {reads[e][0]} "
              f"rounds, {reads[e][1]} host reads"
              for e, ts in costs.items()) + f" ({card})")

    # (f) the card against the CPU.  The whole window on the same draws
    # and J: the card's exp and log round differently from the CPU's, so a
    # forward resampling choice can flip at a CDF near-tie and the chain
    # then follows other particles (phase 3 allows K1 up to 1% of such
    # chains against its plain version); at most 2% of the chains may
    # leave rtol = atol = 1e-4.  One step on the same carry: the rewiring
    # by J within rtol = atol = 1e-4 everywhere, the backward draw at the
    # same v with at most 0.1% of its lanes flipped.
    if cuda:
        C_c, N_c = sizes["cpu"]
        params = svm.SVMParams(
            A=(0.5 + 0.45 * torch.rand((C_c, 1, 1), generator=gen,
                                       device=dev)),
            LQinv_vec=torch.full((C_c, 1), 1.2, device=dev),
            LRinv_vec=torch.full((C_c, 1), 0.9, device=dev))
        cpu = torch.device("cpu")
        win = ys[None, :W].expand(C_c, -1, -1).contiguous()
        args = dict(z0=torch.randn((C_c, 1, N_c), generator=gen, device=dev),
                    normals=torch.randn((C_c, W, 1, N_c), generator=gen,
                                        device=dev),
                    u=torch.rand((C_c, W, N_c), generator=gen, device=dev),
                    J=torch.randint(0, N_c, (C_c, W, N_c, 2), generator=gen,
                                    device=dev),
                    step_weights=torch.rand((C_c, W), generator=gen,
                                            device=dev) + 0.5,
                    prior_mean=torch.zeros(C_c, device=dev),
                    prior_var=svm.stationary_variance(params))
        res = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            o = buffered.run_buffered_pf(
                svm.KERNEL, svm.grad_statistic, params.to(d), win.to(d),
                statistic_dim=3, smoother="paris",
                **{k: v.to(d) for k, v in args.items()})
            res[where] = torch.cat([o.mean_statistic,
                                    o.loglikelihood[:, None]], 1).cpu()
        diff = (res["card"] - res["cpu"]).abs()
        bad = int((diff > 1e-4 + 1e-4 * res["cpu"].abs()).any(1).sum())
        check_finite("PaRIS on the card", res["card"])
        carry = smoothers.PFCarry(
            torch.randn((C_c, N_c, 1), generator=gen, device=dev),
            torch.randn((C_c, N_c), generator=gen, device=dev),
            torch.randn((C_c, N_c, 3), generator=gen, device=dev),
            torch.zeros(C_c, device=dev))
        new = torch.randn((C_c, N_c, 1), generator=gen, device=dev)
        inp = smoothers.PFStepInput(
            z=None, u=None, y=win[:, 3], weight=args["step_weights"][:, 3],
            in_window=torch.ones(C_c, device=dev), t=3)
        v = torch.rand((C_c, N_c, 2), generator=gen, device=dev)
        step = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            p_d = params.to(d)
            c_d = smoothers.PFCarry(*[x.to(d) for x in carry])
            i_d = inp._replace(y=inp.y.to(d), weight=inp.weight.to(d),
                               in_window=inp.in_window.to(d))
            step[where] = (
                smoothers._rewired_statistics(
                    svm.grad_statistic, p_d, c_d, new.to(d),
                    args["J"][:, 3].to(d), i_d).cpu(),
                smoothers._backward_indices(
                    svm.KERNEL, p_d, c_d.particles, c_d.log_weights,
                    new.to(d), v.to(d), None).cpu())
        rw_k, rw_c = step["card"][0], step["cpu"][0]
        rw_err = float((rw_k - rw_c).abs().max())
        rw_bad = int((~torch.isclose(rw_k, rw_c, rtol=1e-4, atol=1e-4)).sum())
        flips = int((step["card"][1] != step["cpu"][1]).sum())
        phase("20 card vs CPU", f"PaRIS, {C_c} chains, N={N_c}, W={W}, the "
              f"same draws and J: chains beyond rtol = atol = 1e-4: {bad} "
              f"(max |card - CPU| {float(diff.max()):.3e}); one step on the "
              f"same carry: rewiring max |card - CPU| = {rw_err:.3e}, "
              f"entries beyond rtol = atol = 1e-4: {rw_bad}; backward draw "
              f"at the same v: {flips} of {v.numel()} lanes differ")
        if bad > 0.02 * C_c or rw_bad or flips > 1e-3 * v.numel():
            raise AssertionError(f"PaRIS on the card differs from the CPU: "
                                 f"{bad} chains, {rw_bad} rewired entries, "
                                 f"{flips} backward lanes")
    phase("20 seconds", f"{time.perf_counter() - t_phase:.1f} s")
    return out


def stepper_phase(dev, card, sizes=STEPPER_SIZES):
    """Phase 21 on ``dev`` (the CPU for a rehearsal at small ``sizes``):
    the steppers through ``fit_scan`` on K1's path, ``fit_scan_chunked``
    against one ``fit_scan``, ``fit_timed`` with chunks, and recovery by
    SGRLD.  Returns K1's launches per stepper."""
    from sgmcmc_tpu_torch.inference import samplers
    from sgmcmc_tpu_torch.models import lgssm, svm
    from sgmcmc_tpu_torch.ops.cuda import fused_pf, philox, resample
    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(21)
    C, n_part, iters, T_len = (sizes["C"], sizes["N"], sizes["iters"],
                               sizes["T"])
    kw = dict(N=n_part, subsequence_length=S, buffer_length=B,
              resampler="systematic", rng="kernel")
    data = {"svm": svm.generate_data(gen, svm.from_scalars(
                0.9, 0.5, 1.0, device=dev), T_len)[0],
            "lgssm": lgssm.generate_data(gen, lgssm.from_scalars(
                0.9, 0.5, 1.0, device=dev), T_len)[0]}
    cls = {"svm": samplers.SVMSampler, "lgssm": samplers.LGSSMSampler}
    start = {"svm": svm.from_scalars(0.5, 1.0, 2.0),
             "lgssm": lgssm.from_scalars(0.5, 1.0, 2.0)}

    def run(smp, iter_type, n_iters, per_iter, **fkw):
        """One fit_scan from zeroed counts: (seconds, (K1, resample-apply,
        Philox) launches, peak GiB)."""
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counts(fused_pf, resample, philox)
        t0 = time.perf_counter()
        _, aux = smp.fit_scan(iter_type, num_iters=n_iters, epsilon=0.01,
                              num_chains=C, record="none", return_aux=True,
                              **kw, **fkw)
        float(aux[:, -1].sum())                   # synchronises
        dt = time.perf_counter() - t0
        got = (fused_pf.fused_window.launches,
               resample.resample_apply.launches,
               philox.philox_normals.launches)
        p = smp.parameters
        check_finite(f"the {iter_type} fit", aux,
                     *[getattr(p, f) for f in p.__dataclass_fields__])
        # one draw a step: SGLD-CV's two gradients share its Philox seeds
        want = (per_iter * n_iters, 0, n_iters)
        if cuda and got != want:
            raise AssertionError(f"{iter_type}: (K1, resample-apply, "
                                 f"Philox) launches {got}, expected {want}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
        return dt, got, peak

    k1 = {}
    for model, iter_type, per_iter in (
            ("lgssm", "SGLD", 1), ("lgssm", "SGRLD", 1),
            ("lgssm", "SGRD", 1), ("svm", "SGLD", 1), ("svm", "SGD", 1),
            ("svm", "ADAGRAD", 1), ("svm", "SGLD-CV", 2)):
        smp = cls[model](observations=data[model], device=dev, seed=24)
        smp.parameters = start[model]
        fkw = {}
        if iter_type == "SGLD-CV":
            smp._chain_init_params(C, "replicate")
            fkw = dict(centering_parameters=start[model],
                       centering_gradient=smp.noisy_gradient(**kw))
        run(smp, iter_type, 2, per_iter, **fkw)             # warm-up
        dt, got, peak = run(smp, iter_type, iters, per_iter, **fkw)
        msg = ""
        if iter_type == "ADAGRAD":                 # a second, continuing call
            dt2, got2, _ = run(smp, iter_type, iters, per_iter)
            t_acc = smp._adagrad_state.t
            if int(t_acc.min()) != int(t_acc.max()) or \
                    int(t_acc[0]) != 2 + 2 * iters:
                raise AssertionError(f"ADAGRAD's state did not continue: "
                                     f"t = {t_acc[:4]}")
            msg = (f"; its continuing call {dt2:.3f} s, "
                   f"{C * iters / dt2:.1f} steps/s, state t = "
                   f"{int(t_acc[0])}")
        k1[(model, iter_type)] = got[0]
        phase("21 steppers", f"{cls[model].__name__}.fit_scan "
              f"{iter_type!r} systematic rng='kernel' C={C} N={n_part} S={S} "
              f"B={B} T={T_len}: {iters} iterations in {dt:.3f} s, (K1, "
              f"resample-apply, Philox) launches {got}, {C * iters / dt:.1f} "
              f"aggregate steps/s, peak {peak:.3f} GiB{msg} ({card})")
        del smp

    # fit_scan_chunked against one fit_scan from the same seed
    C_k = sizes["chunked"]
    traces = []
    for chunked in (True, False):
        smp = samplers.SVMSampler(observations=data["svm"], device=dev,
                                  seed=25)
        smp.parameters = start["svm"]
        if chunked:
            traces.append(smp.fit_scan_chunked(
                "SGLD", num_iters=10, chunk_iters=4, num_chains=C_k,
                epsilon=0.05, **kw))
        else:
            traces.append(smp.fit_scan("SGLD", num_iters=10, num_chains=C_k,
                                       epsilon=0.05, **kw))
    same = all(torch.equal(getattr(traces[0], f), getattr(traces[1], f).cpu())
               for f in ("A", "LQinv_vec", "LRinv_vec"))
    phase("21 chunked", f"fit_scan_chunked(num_iters=10, chunk_iters=4) at "
          f"{C_k} chains bitwise equal to one fit_scan(num_iters=10): {same}")
    if not same:
        raise AssertionError("fit_scan_chunked differs from fit_scan")

    # fit_timed with chunks, for about sizes["timed"] seconds
    smp = samplers.SVMSampler(observations=data["svm"], device=dev, seed=26)
    smp.parameters = start["svm"]
    params, times = smp.fit_timed("SGLD", sizes["timed"], epsilon=0.05,
                                  chunk_iters=50, max_samples=100, **kw)
    check_finite("fit_timed's trace", torch.cat([p.A for p in params]))
    phase("21 fit_timed", f"fit_timed('SGLD', {sizes['timed']} s, "
          f"chunk_iters=50, max_samples=100), one chain: {len(params)} "
          f"recorded entries up to {times[-1]:.3f} s")

    # recovery of A from 0.5 toward 0.9 by SGRLD on the LGSSM
    C_r, it_r = sizes["rec"]
    smp = samplers.LGSSMSampler(observations=data["lgssm"], device=dev,
                                seed=27)
    smp.parameters = start["lgssm"]
    trace = smp.fit_scan("SGRLD", num_iters=it_r, epsilon=0.05,
                         num_chains=C_r, record="all", **kw)
    a_mean = float(trace.A[:, -it_r // 4:].mean())
    phase("21 SGRLD recovery", f"LGSSMSampler SGRLD, {C_r} chains: "
          f"chain-mean A over the last {it_r // 4} of {it_r} iterations: "
          f"{a_mean:.4f} (start 0.5, truth 0.9)")
    if not abs(a_mean - 0.9) < abs(a_mean - 0.5):
        raise AssertionError(f"SGRLD did not move A toward 0.9: {a_mean}")
    seconds = time.perf_counter() - t_phase
    phase("21 seconds", f"{seconds:.1f} s")
    return k1


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
            if C == 1:
                # at C=1 both sides are one host call: the device time
                # alone, from a CUDA graph of 200 launches
                g_k = graph_ms(lambda: resample.resample_apply(pos, cdf, vals))
                g_l = graph_ms(lambda: resample.resample_apply_reference(
                    pos, cdf, vals))
                ra_times[label].update(graph_ms=g_k, library_graph_ms=g_l)
                msg += (f"; device time per call in a CUDA graph of 200: "
                        f"kernel {g_k:.4f} ms, PyTorch call {g_l:.4f} ms")
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
                                   resample_mode="auto", **okw)
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
        cfg = sgmcmc.PFScoreConfig(n_particles=N, resampler="systematic",
                                   resample_mode="auto")
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
    lengths = list(SEQ_LENGTHS)
    n_seq = len(lengths)
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
                                   resample_mode="auto", **okw)
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

    # 18. K1's frame where the fits above do not take it, bitwise (NaN
    # equal to NaN): other N (partial threads, N below the block's thread
    # count, an odd N, the shared-memory layout up to the largest N the
    # card's shared memory allows), degenerate weights (the ok-false
    # branch), and the valid gate on interior invalid runs with the ESS gate
    # and lambda = 0.95, each with host and in-kernel normals
    smem_of = getattr(fused_pf._library(), "sgmcmc_fused_window_svm_smem")
    lo, hi = 1, 1 << 20                     # the largest N that fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if smem_of(W, mid, 0) <= build.SMEM_LIMIT:
            lo = mid
        else:
            hi = mid - 1
    n_max = lo

    def frame_check(what, n, seeded, degen=False, gaps=False, lam=1.0,
                    ess=None):
        args = window_inputs(gen, C_CHECK, ys, svm, subsequence, buffered, n)
        window, step_w = args[3].clone(), args[4]
        vs = None
        if gaps:
            t = torch.arange(W, device=dev)[None]
            r = torch.arange(C_CHECK, device=dev)[:, None] % 3
            vs = (~(((r == 0) & (t < 7)) | ((r == 1) & (t >= 20) & (t < 31))
                    | ((r == 2) & (t >= W - 9)))).float()
            step_w = (step_w * vs).contiguous()
        if degen:
            window[::3, W // 2] = 1e30
        args = (args[0], args[1], None if seeded else args[2], window,
                step_w, args[5])
        sd = torch.randint(-2 ** 63, 2 ** 63 - 1, (C_CHECK,), generator=gen,
                           dtype=torch.int64, device=dev) if seeded else None
        kw_f = dict(lambduh=lam, ess_threshold=ess, seeds=sd, vs=vs)
        out_k = fused_pf.fused_window(svm.FUSED, *args, **kw_f)
        out_r = fused_pf.fused_window_reference(svm.FUSED, *args, **kw_f)
        torch.cuda.synchronize()
        eq = (out_k == out_r) | (torch.isnan(out_k) & torch.isnan(out_r))
        fin = torch.isfinite(out_k) & torch.isfinite(out_r)
        err = float((out_k - out_r).abs()[fin].max())
        n_diff = int((~eq).any(1).sum())
        n_inf = int((~torch.isfinite(out_k)).any(1).sum())
        what = what + (", in-kernel" if seeded else ", host") + " normals"
        phase("18 K1 frame", f"{what}: C={C_CHECK} N={n} W={W} lambda={lam} "
              f"ess={ess}: max |kernel - plain| = {err!r} over the finite "
              f"entries, chains that differ {n_diff}, chains with "
              f"non-finite outputs {n_inf}")
        if n_diff or (degen != (n_inf > 0)):
            raise AssertionError(f"K1 ({what}) differs from its plain "
                                 f"version in {n_diff} chains")
        return err

    frame_err = 0.0
    for what, n, kw_c in (
            ("N=1000", 1000, {}), ("N=100", 100, {}), ("N=777", 777, {}),
            ("N=4096", 4096, {}), (f"N={n_max} (largest)", n_max, {}),
            ("degenerate weights at step W/2", N, dict(degen=True)),
            ("degenerate weights, ESS gate", N,
             dict(degen=True, ess=0.5)),
            ("valid gate, interior invalid runs", N, dict(gaps=True)),
            ("valid gate, interior runs, ESS gate, lambda=0.95", N,
             dict(gaps=True, ess=0.5, lam=0.95))):
        for seeded in (False, True):
            frame_err = max(frame_err, frame_check(what, n, seeded, **kw_c))
    k1_err = max(k1_err, frame_err)

    # 19. the LGSSM's exact-message kinds, Gibbs and the route beyond K1's
    # shared memory (no kernel of their own)
    exact_phase(dev, card)

    # 20. PaRIS (resample-apply once per window step) and 21. the steppers
    # and the sampler surface (K1 once per gradient)
    paris = paris_phase(dev, card)
    ra_err = max(ra_err, *(r["max_abs_err"]
                           for r in paris["resample_apply"].values()))
    steps_k1 = stepper_phase(dev, card)

    # 22. the predict surface (resample-apply at its wide rows) and the
    # adaptive proposals
    predict = predict_phase(dev, card)

    # 23. the vector LGSSM at full width (resample-apply at K=16 and
    # K=10002) and 24. the evaluation layer on its trace
    vec = vector_phase(dev, card)
    evaluation_phase(dev, card, vec)

    # 25. the experiments layer: the driver, the gradient-error figure and
    # the exchange-rate demo (resample-apply at C=4, N=100000 and at C=1,
    # N=1000; K1 at C=1, N=1000, W=24)
    exps = experiments_phase(dev, card)

    # 26. the HMM family (no kernel of its own: exact messages, SCIR, Gibbs)
    hmm_phase(dev, card)

    # 27. the parallel-in-time messages and the SLDS (no kernel of their
    # own: associative scans, message loops, Gibbs, complete-data SGLD)
    parallel_slds_phase(dev, card)

    main_shape = ra_times["K2b"]
    k1_tpu = "sgmcmc_tpu/ops/pallas/fused_pf.py:121"

    def k1_src(body, *extra):
        """The sources of K1 on one body."""
        model = body.split("_")[0]
        return " + ".join(f"sgmcmc_tpu_torch/csrc/{f}" for f in (
            "fused_window.cuh", f"fused_window_{body}.cu",
            f"{model}_body.cuh") + extra)

    def occupancy(name_k, body):
        """The variant's registers, resident blocks per SM and shared
        memory per block at N, as the CUDA runtime reports them."""
        occ = fused_pf.fused_window_occupancy(
            body, rng="rng_kernel" in name_k, ess_gate="ess_gate" in name_k,
            valid_gate="valid_gate" in name_k, N=N)
        return dict(registers=occ["registers"],
                    blocks_per_sm=occ["blocks_per_sm"],
                    smem_bytes_per_block=occ["smem_bytes"])

    def k1_entry(name_k, body, replaces, launches, numbers, *extra):
        return {"name": f"fused_window_{name_k}", "route": "cuda",
                "source": k1_src(body, *extra),
                "replaces": k1_tpu + replaces, "launches": launches,
                **numbers, "library_ms": None, **occupancy(name_k, body)}

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
        # K1 on the steppers' fits: the variants above, at the same shape
        *[k1_entry(f"{body}_rng_kernel_{it.lower().replace('-', '_')}",
                   body, " (rng='kernel'; fit_scan " + it + ")",
                   steps_k1[(model, it)], numbers, "philox.cuh")
          for model, body, numbers in (
              ("lgssm", "lgssm_optimal", lg["lgssm_optimal"]),
              ("svm", "svm", dict(max_abs_err=rng_err, ms=rng_ms,
                                  plain_ms=rng_plain, bound_ms=rng_bound,
                                  bound_by=rng_by)))
          for (m_k, it) in steps_k1 if m_k == model and it != "SGLD"],
        {"name": "resample_apply", "route": "cuda",
         "source": "sgmcmc_tpu_torch/csrc/resample_apply.cu",
         "replaces": "sgmcmc_tpu/ops/pallas/resample.py:178 (K2a), "
                     ":232 (K2b), :31 (K3)",
         "launches": ra_launches[1024], "max_abs_err": ra_err,
         **main_shape},
        # the same kernel on the PaRIS paths, at their shapes (K = 1)
        *[{"name": f"resample_apply_{label}", "route": "cuda",
           "source": "sgmcmc_tpu_torch/csrc/resample_apply.cu",
           "replaces": "sgmcmc_tpu/ops/pallas/resample.py:178 (K2a), "
                       ":232 (K2b), :31 (K3)",
           "launches": paris[key], **paris["resample_apply"][label]}
          for label, key in (("paris_100", "grid_launches"),
                             ("paris_ld", "ld_launches"))],
        # the same kernel at the predict surface's wide rows (its wide
        # launch), with the launches of the predict call that runs each
        *[{"name": f"resample_apply_{label}", "route": "cuda",
           "source": "sgmcmc_tpu_torch/csrc/resample_apply.cu",
           "replaces": "sgmcmc_tpu/ops/pallas/resample.py:178 (K2a), "
                       ":232 (K2b)",
           "launches": predict["launches"][label],
           **predict["resample_apply"][label]}
          for label in PREDICT_SHAPES],
        # the same kernel on the vector LGSSM's fit (K = 16) and smoothed
        # predict (K = 10002)
        *[{"name": f"resample_apply_{label}", "route": "cuda",
           "source": "sgmcmc_tpu_torch/csrc/resample_apply.cu",
           "replaces": "sgmcmc_tpu/ops/pallas/resample.py:178 (K2a), "
                       ":232 (K2b), :31 (K3)",
           "launches": vec["launches"][label],
           **vec["resample_apply"][label]}
          for label in VECTOR_SHAPES],
        # the same kernel on the experiments layer: the gradient-error
        # figure's truth (C=4, N=100000) and the driver's single-chain fits
        # (C=1, N=1000, K=4)
        *[{"name": f"resample_apply_{label}", "route": "cuda",
           "source": "sgmcmc_tpu_torch/csrc/resample_apply.cu",
           "replaces": "sgmcmc_tpu/ops/pallas/resample.py:178 (K2a), "
                       ":232 (K2b), :31 (K3)",
           "launches": exps["launches"][label],
           **exps["resample_apply"][label]}
          for label in EXPERIMENT_SHAPES],
        # K1 on the exchange-rate demo's SGLD leg (C=1, N=1000, W=24)
        k1_entry("svm_demo", "svm", " (the demo's SGLD leg, one segment)",
                 exps["launches"]["demo"], exps["k1"]),
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
