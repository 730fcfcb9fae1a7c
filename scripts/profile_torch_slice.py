#!/usr/bin/env python3
"""Profile the PyTorch port's main path on one CUDA device.

    python3 scripts/profile_torch_slice.py [--chains 8192] [--iters 20]
        [--runs 7] [--resampler systematic|multinomial|stratified]
        [--particles 1024] [--rng host|kernel]
        [--model svm|lgssm|lgssm2|garch|svjm|gauss_hmm|arphmm]
        [--kernel optimal|prior] [--kind pf|marginal|complete] [--gibbs]
        [--pf poyiadjis_N|paris|paris_ar|...] [--subsequence 40]
        [--buffer 10] [--T 1000]
        [--iter-type SGLD|SGRLD|SGD|SGRD|ADAGRAD|SGLD-CV|SCIR|Gibbs]
        [--predict [--target latent|y] [--lag K] | --predictive K]

Runs ``SVMSampler.fit_scan("SGLD", record="none")`` at the benchmark
configuration (SVM, T=1000, N=1024, S=40, B=10, Poyiadjis O(N), systematic
resampling: the fused-window path) or, with ``--resampler multinomial``,
the JAX package's default resampler (the unfused path, one resample-apply
launch per window step).  ``--rng kernel`` generates the fused window's
normals on the card (the JAX headline's ``rng="kernel"``); ``--model``
runs ``LGSSMSampler`` on the scalar LGSSM (true A=0.9, C=1, Q=0.5, R=1;
start A=0.5, Q=1, R=2), the vector LGSSM (``lgssm2``:
``LGSSMSampler(n=2, m=2)``, true A=[[0.7, 0.1], [0, 0.5]], C=I,
Q=[[0.5, 0.1], [0.1, 0.4]], R=0.6 I; start A=0.5 I, Q=I, R=2 I; K1 is
the scalar model's, so every resampler runs the unfused smoother),
``GARCHSampler`` (true alpha=0.1, beta=0.6,
gamma=0.2, R=0.5; start 0.2, 0.3, 0.3, 1) or ``SVJMSampler`` (true A=0.9,
Q=0.5, R=1, pJ=0.1, QJ=2; start 0.5, 1, 2, 0.05, 1) instead, ``--kernel``
selects the particle kernel, ``--pf`` the smoother (``paris`` /
``paris_ar``: PaRIS, one resample-apply launch per window step),
``--subsequence`` the subsequence length (-1: the whole series, no
buffer), ``--buffer`` its buffer, ``--T`` the series' length (the
exchange-rate demo's SGLD leg on one segment: ``--chains 1 --particles
1000 --subsequence 16 --buffer 4 --T 579``; the KSD gate's LD leg:
``--chains 1 --particles 128 --pf paris --resampler multinomial
--subsequence -1 --T 125``) and ``--iter-type`` the stepper (SGRLD and
SGRD need the LGSSM's preconditioner; SGLD-CV centres at the start
parameters, with their noisy gradient as the centering gradient); ``--kernel laplace|ep`` (SVM)
and ``ep|ep_avg`` (SVJM) run the adaptive proposals.  ``--predict`` times
one chain's ``predict`` (at the true parameters; ``--target``, ``--lag``,
``--pf`` and ``--particles`` as its arguments) in place of a fit, and
``--predictive K`` its ``predictive_loglikelihood(K)``; a step is then
one call.  With ``--model lgssm``, ``--kind marginal``
or ``complete`` runs the exact-message score kinds instead of the particle
filter's, and ``--gibbs`` times ``--iters`` blocked-Gibbs sweeps
(``LGSSMSampler.sample_gibbs`` on every chain) in place of a fit; a step
is then one chain's sweep.  ``--model gauss_hmm`` / ``arphmm`` run the
HMM family (``GaussHMMSampler`` / ``ARPHMMSampler``, K=2, m=1, p=1, at the
experiment driver's true parameters; start pi uniform, mu = -0.5, 0.5 or
D = 0.3, -0.3, R = 1; float64, no particle filter, so ``--kind`` defaults
to ``marginal``; the driver's grid is ``--subsequence 16 --buffer 4``),
where ``--iter-type SCIR`` times ``--iters`` ``sample_sgld_scir`` steps of
every chain and ``--iter-type Gibbs`` (as ``--gibbs``) Gibbs sweeps.  It
prints:
  - the card's ``nvidia-smi`` name and power limit;
  - aggregate steps/s of ``--runs`` timed fits after one warm-up (each run,
    then the median and the lower and upper quartile);
  - one fit under ``torch.profiler``: the device's busy time, as the union
    of its kernel, memcpy and memset intervals in the trace; the idle share
    of the fit's span (the ``run`` annotation, which ends after a
    synchronising read of the result); each kernel's share of the busy time;
  - the peak device memory of the fits (``max_memory_allocated``);
  - the device-memory bandwidth of a 2 GiB device-to-device copy (bytes read
    plus written per second), and the rate at which the fused-window kernel
    streams its proposal normals as a share of that copy rate.
The trace is written to ``build/profile/torch_slice_trace.json``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

S, B, T = 40, 10, 1000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def copy_bandwidth(nbytes=2 ** 31, reps=10):
    """Bytes read plus written per second by a device-to-device copy."""
    src = torch.empty(nbytes // 4, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        dst.copy_(src)
    end.record()
    torch.cuda.synchronize()
    return 2 * nbytes * reps / (start.elapsed_time(end) / 1e3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--resampler", default="systematic",
                    choices=("systematic", "multinomial", "stratified"))
    ap.add_argument("--particles", type=int, default=1024)
    ap.add_argument("--rng", default="host", choices=("host", "kernel"))
    ap.add_argument("--model", default="svm",
                    choices=("svm", "lgssm", "lgssm2", "garch", "svjm",
                             "gauss_hmm", "arphmm"))
    ap.add_argument("--kernel", default=None,
                    choices=("optimal", "prior", "laplace", "ep", "ep_avg"))
    ap.add_argument("--kind", default=None,
                    choices=("pf", "marginal", "complete"))
    ap.add_argument("--gibbs", action="store_true")
    ap.add_argument("--pf", default="poyiadjis_N")
    ap.add_argument("--subsequence", type=int, default=S)
    ap.add_argument("--buffer", type=int, default=B)
    ap.add_argument("--T", type=int, default=T)
    ap.add_argument("--iter-type", default="SGLD",
                    choices=("SGLD", "SGRLD", "SGD", "SGRD", "ADAGRAD",
                             "SGLD-CV", "SCIR", "Gibbs"))
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--target", default="latent", choices=("latent", "y"))
    ap.add_argument("--lag", type=int, default=None)
    ap.add_argument("--predictive", type=int, default=None)
    args = ap.parse_args()
    hmm = args.model in ("gauss_hmm", "arphmm")
    args.kind = args.kind or ("marginal" if hmm else "pf")
    args.gibbs = args.gibbs or args.iter_type == "Gibbs"
    scir = args.iter_type == "SCIR"
    calls = args.predict or args.predictive is not None
    N = args.particles
    if not torch.cuda.is_available():
        sys.exit("profile_torch_slice: no CUDA device is available")
    from sgmcmc_tpu_torch.inference import samplers
    from sgmcmc_tpu_torch.experiments.driver import _make_true_params
    from sgmcmc_tpu_torch.models import (arphmm, garch, gauss_hmm, lgssm,
                                         registry, svjm, svm)
    from sgmcmc_tpu_torch.models.base import params_map

    def vector_sampler(observations, **kw):
        return samplers.LGSSMSampler(observations, n=2, m=2, **kw)
    cls, truth, start = {
        "svm": (samplers.SVMSampler, svm.from_scalars(0.9, 0.5, 1.0),
                svm.from_scalars(0.5, 1.0, 2.0)),
        "lgssm": (samplers.LGSSMSampler, lgssm.from_scalars(0.9, 0.5, 1.0),
                  lgssm.from_scalars(0.5, 1.0, 2.0)),
        "lgssm2": (vector_sampler, lgssm.from_matrices(
            [[0.7, 0.1], [0.0, 0.5]], [[1.0, 0.0], [0.0, 1.0]],
            [[0.5, 0.1], [0.1, 0.4]], [[0.6, 0.0], [0.0, 0.6]]),
            lgssm.from_matrices(0.5 * torch.eye(2), torch.eye(2),
                                torch.eye(2), 2.0 * torch.eye(2))),
        "garch": (samplers.GARCHSampler,
                  garch.from_alpha_beta_gamma(0.1, 0.6, 0.2, 0.5),
                  garch.from_alpha_beta_gamma(0.2, 0.3, 0.3, 1.0)),
        "svjm": (samplers.SVJMSampler,
                 svjm.from_scalars(0.9, 0.5, 1.0, 0.1, 2.0),
                 svjm.from_scalars(0.5, 1.0, 2.0, 0.05, 1.0)),
        "gauss_hmm": (samplers.GaussHMMSampler,
                      _make_true_params("gauss_hmm"),
                      gauss_hmm.from_values([[0.5, 0.5]] * 2,
                                            [[-0.5], [0.5]], [[1.0]])),
        "arphmm": (samplers.ARPHMMSampler, _make_true_params("arphmm"),
                   arphmm.from_values([[0.5, 0.5]] * 2, [[[0.3]], [[-0.3]]],
                                      [[1.0]])),
    }[args.model]

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    api = (registry.get_model("lgssm", n=2, m=2) if args.model == "lgssm2"
           else registry.get_model(args.model))
    T_len = args.T
    ys, _ = api.generate_data(gen, truth.to(dev), T_len)
    sampler = cls(observations=ys, device="cuda", seed=2)
    sampler.parameters = start
    full = args.subsequence == -1
    kw = dict(N=N, subsequence_length=args.subsequence,
              buffer_length=0 if full else args.buffer, pf=args.pf,
              resampler=args.resampler, rng=args.rng, kernel=args.kernel,
              kind=args.kind)
    Z = 1 if hmm else sampler.model.get_kernel(args.kernel).noise_dim
    if calls:
        sampler.parameters = truth
        what = (f"predictive_loglikelihood({args.predictive})"
                if args.predictive is not None else
                f"predict(target={args.target!r}, lag={args.lag})")
        print(f"config: {args.model} (kernel {args.kernel or 'default'}) "
              f"{what}, one chain, N={N}, T={T_len}, {args.pf}")
    elif args.gibbs:
        print(f"config: {args.model} blocked Gibbs, {args.chains} chains, "
              f"{args.iters} sweeps, T={T_len}")
    elif scir:
        print(f"config: {args.model} SCIR, {args.chains} chains, S="
              f"{kw['subsequence_length']}, B={kw['buffer_length']}, "
              f"T={T_len}")
    elif args.kind != "pf":
        print(f"config: {args.iter_type}, {args.model} kind={args.kind}, "
              f"{args.chains} chains, S={kw['subsequence_length']}, "
              f"B={kw['buffer_length']}, T={T_len}")
    else:
        print(f"config: {args.iter_type}, {args.model} (kernel "
              f"{args.kernel or 'default'}), {args.chains} chains, N={N}, "
              f"S={kw['subsequence_length']}, B={kw['buffer_length']}, "
              f"T={T_len}, {args.pf}, {args.resampler} resampling, "
              f"rng={args.rng}")
    if args.iter_type == "SGLD-CV":
        kw.update(centering_parameters=start, centering_gradient=(
            sampler.noisy_gradient(**kw)))

    if args.gibbs or scir:
        sampler.parameters = params_map(lambda x: x.expand(
            (args.chains,) + x.shape[1:]).contiguous(), start)

    def fit():
        if args.predictive is not None:
            return float(sampler.predictive_loglikelihood(
                args.predictive, N=N, kernel=args.kernel).sum())
        if args.predict:
            mean, _ = sampler.predict(
                target=args.target, lag=args.lag, N=N, kernel=args.kernel,
                pf="filter" if args.lag == 0 else args.pf)
            return float(mean.sum())
        if args.gibbs or scir:
            for _ in range(args.iters):
                if scir:
                    sampler.sample_sgld_scir(
                        0.1, subsequence_length=kw["subsequence_length"],
                        buffer_length=kw["buffer_length"])
                else:
                    sampler.sample_gibbs()
            # synchronises
            return float(sampler.parameters.LRinv_vec.sum())
        _, aux = sampler.fit_scan(args.iter_type, num_iters=args.iters,
                                  epsilon=0.1, num_chains=args.chains,
                                  record="none", return_aux=True, **kw)
        return float(aux[:, -1].sum())          # synchronises

    torch.cuda.reset_peak_memory_stats()
    fit()
    rates = []
    steps = 1 if calls else args.chains * args.iters
    for _ in range(args.runs):
        t0 = time.perf_counter()
        fit()
        rates.append(steps / (time.perf_counter() - t0))
    q = statistics.quantiles(rates, n=4) if len(rates) > 1 else rates * 3
    print("steps/s runs:", " ".join(f"{r:.1f}" for r in rates))
    print(f"steps/s median {statistics.median(rates):.1f}, quartiles "
          f"{q[0]:.1f} / {q[2]:.1f} ({card})")
    if calls:
        print(f"seconds per call: " + " ".join(
            f"{1 / r:.4f}" for r in rates) + f", median "
            f"{1 / statistics.median(rates):.4f} ({card})")
    if args.gibbs:
        print(f"seconds per sweep of {args.chains} chains: median "
              f"{args.chains / statistics.median(rates):.4f} ({card})")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("run"):
            fit()
    peak = torch.cuda.max_memory_allocated()
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace_path = out_dir / "torch_slice_trace.json"
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    span = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == "run"]
    if len(span) != 1:
        raise RuntimeError(f"{len(span)} run annotations in the trace")
    t_lo = float(span[0]["ts"])
    t_hi = t_lo + float(span[0]["dur"])
    dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS
              and e.get("ph") == "X"]
    if not dev_ev:
        raise RuntimeError("no device activity in the trace")
    ivals = [(max(float(e["ts"]), t_lo),
              min(float(e["ts"]) + float(e["dur"]), t_hi)) for e in dev_ev]
    busy = union_us([iv for iv in ivals if iv[1] > iv[0]])
    wall = t_hi - t_lo
    print(f"profiled run: span {wall / 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.3f} ms (union of {len(dev_ev)} kernel/memcpy/memset "
          f"intervals), idle share {1 - busy / wall:.4f} ({card})")
    per_name = defaultdict(lambda: [0.0, 0])
    for e in dev_ev:
        per_name[e["name"]][0] += float(e["dur"])
        per_name[e["name"]][1] += 1
    print("device time by kernel (share of busy time):")
    for name, (us, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0]):
        print(f"  {us / 1e3:9.3f} ms {us / busy:7.2%} {n:5d} calls  "
              f"{name[:90]}")
    fused = [(us, n) for name, (us, n) in per_name.items()
             if "fused_window_kernel" in name]
    print(f"peak device memory {peak / 2 ** 30:.3f} GiB")
    bw = copy_bandwidth()
    print(f"device-to-device copy: {bw / 1e9:.1f} GB/s read+written ({card})")
    for us, n in fused:
        msg = f"fused window: {us / n / 1e3:.3f} ms per call"
        if args.rng == "host":
            W_k = args.subsequence + 2 * args.buffer
            stream = args.chains * W_k * Z * N * 4 / (us / n / 1e6)
            msg += (f", normals streamed at {stream / 1e9:.1f} GB/s = "
                    f"{stream / bw:.2%} of the copy rate")
        print(f"{msg} ({card})")


if __name__ == "__main__":
    main()
