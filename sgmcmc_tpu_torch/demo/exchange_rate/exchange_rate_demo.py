"""Exchange-rate SVM demo: SGLD against full-sequence Langevin dynamics.

Counterpart of ``demo/exchange_rate/exchange_rate_demo.py``: load hourly
demeaned log-returns, scale them by 1000, split them into segments at
gaps of more than 6 h, and fit the SVM (or SVJM, GARCH)

  * SGLD: eps=1e-3, S=16, B=4, Poyiadjis O(N), systematic resampling
    (the fused window kernel, one launch an iteration),
  * LD:   eps=0.1, the whole sequence, PaRIS,

on one segment (``--mode single``) or, with the multi-sequence samplers,
on the first 5 segments (``subset``) or all of them (``full``): SGLD
takes one random segment and subsequence a step, LD every whole segment.
Each leg's trace goes to ``--out``.  Runs on the card unless ``--device
cpu``.

Usage:
  python -m sgmcmc_tpu_torch.demo.exchange_rate.exchange_rate_demo
      --data PATH.npz [--model svm|svjm|garch] [--mode single|subset|full]
      [--N PARTICLES] [--segment IDX] [--sgld_iters K] [--ld_iters K]
      [--sgld_chunk_iters K] [--ld_chunk_iters K] [--out DIR]
      [--device cpu]

``PATH.npz`` holds ``hourly_log_returns`` and ``hourly_date``
(``process_exchange_data.py`` writes it from a raw price file).
"""
import argparse
import os
import time

import numpy as np

# the demo's data, when it has been prepared inside the repository
DEFAULT_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "EURUS_processed.npz")
SGLD_KWARGS = dict(epsilon=0.001, subsequence_length=16, buffer_length=4,
                   pf="poyiadjis_N", resample_mode="auto",
                   resampler="systematic")
LD_KWARGS = dict(epsilon=0.1, subsequence_length=-1, pf="paris",
                 resample_mode="auto")


def load_segments(path: str, min_len: int = 7):
    """Hourly log-returns x 1000 as ``[T_i, 1]`` segments, split at gaps
    of more than 6 h; segments of at most ``min_len`` steps are dropped."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no exchange-rate data at {path}: pass --data PATH.npz (an "
            f"npz with hourly_log_returns and hourly_date, as "
            f"process_exchange_data.py writes it)")
    data = np.load(path)
    returns = np.asarray(data["hourly_log_returns"], dtype=np.float64)
    dates = np.asarray(data["hourly_date"])
    observations = returns.reshape(-1, 1) * 1000.0
    gaps = np.where(np.diff(dates) > np.timedelta64(6, "h"))[0].tolist()
    segments = []
    for start, end in zip([0] + gaps, gaps + [observations.shape[0]]):
        if end - start > min_len:
            segments.append(observations[start:end])
    return segments


def write_synthetic_data(path: str, lengths, seed: int = 0,
                         phi: float = 0.95, sigma: float = 0.3,
                         tau: float = 1.0) -> str:
    """An npz in the demo's format in place of the real series: runs of
    hourly returns of the given ``lengths``, each simulated from the SVM
    (returns in the data's units, 1/1000 of the fitted observations), the
    runs 7 h apart."""
    rng = np.random.default_rng(seed)
    returns, dates, t = [], [], np.datetime64("2020-01-01T00", "h")
    for n in lengths:
        x = np.zeros(n)
        x[0] = rng.normal() * sigma / np.sqrt(1 - phi ** 2)
        for i in range(1, n):
            x[i] = phi * x[i - 1] + sigma * rng.normal()
        returns.append(tau * np.exp(0.5 * x) * rng.normal(size=n) / 1000.0)
        dates.append(t + np.arange(n).astype("timedelta64[h]"))
        t = dates[-1][-1] + np.timedelta64(7, "h")
    np.savez_compressed(path, hourly_log_returns=np.concatenate(returns),
                        hourly_date=np.concatenate(dates))
    return path


def leg_kwargs(method: str, N: int, seq: bool = False) -> dict:
    """The fit keywords of the ``sgld`` or ``ld`` leg."""
    kw = dict(SGLD_KWARGS if method == "sgld" else LD_KWARGS, N=N)
    if seq:
        kw["num_sequences"] = 1 if method == "sgld" else -1
    return kw


def make_sampler(model_name, observations, seed=12345, seq=False,
                 device="cuda"):
    """The demo's sampler (one sequence, or a list of them with
    ``seq``)."""
    from ...inference import samplers
    if seq:
        cls = {"svm": samplers.SeqSVMSampler, "svjm": samplers.SeqSVJMSampler,
               "garch": samplers.SeqGARCHSampler}[model_name]
        return cls(observations, seed=seed, device=device)
    cls = {"svm": samplers.SVMSampler, "svjm": samplers.SVJMSampler,
           "garch": samplers.GARCHSampler}[model_name]
    return cls(observations=observations, seed=seed, device=device)


def fit_model(model_name, observations, method, num_iters, N, seed=12345,
              seq: bool = False, chunk_iters: int = 250,
              n_particle_devices: int = 1, device="cuda", init=None):
    """One leg's fit in ``fit_scan_chunked`` chunks of ``chunk_iters``
    iterations, from a projected prior draw (or ``init``).  Returns
    ``(sampler, parameters list, times)``; the sampler holds one chain.
    ``seq=True`` fits a multi-sequence sampler over a list of segments.
    ``n_particle_devices=P > 1`` shards the one chain's particle filter
    over a 1 x P mesh (``fit_scan(mesh=..., num_chains=1)``; one process
    per device, every one calling this alike; single-segment samplers
    only, as in the JAX demo)."""
    if n_particle_devices > 1 and seq:
        raise ValueError("--n_particle_devices needs --mode single")
    sampler = make_sampler(model_name, observations, seed, seq, device)
    if init is not None:
        sampler.parameters = init
    sampler.project_parameters()
    if n_particle_devices > 1:
        from ...io.checkpoint import unstack_trace
        from ...models.base import params_map
        from ...parallel import sharding
        P = n_particle_devices
        if sharding.world_size() != P:
            raise ValueError(
                f"--n_particle_devices {P} runs one process per device: "
                f"launch the demo with torchrun --nproc_per_node {P}")
        stacked = sampler.fit_scan_chunked(
            "SGLD", num_iters=num_iters, chunk_iters=chunk_iters,
            num_chains=1, mesh=sharding.make_mesh(1, P),
            **leg_kwargs(method, N, seq))
        params_list = unstack_trace(params_map(lambda x: x[0], stacked))
    else:
        params_list = sampler.fit_scan_chunked(
            "SGLD", num_iters=num_iters, chunk_iters=chunk_iters,
            **leg_kwargs(method, N, seq))
    sampler.select_chain(0)
    return sampler, params_list, list(range(len(params_list)))


def ld_chunk_iters(total_obs: int) -> int:
    """The LD leg's default chunk: it filters every whole segment an
    iteration."""
    return 200 if total_obs <= 1000 else 50


def summary(model_name: str, params_list) -> dict:
    """Post-burn-in (the first third) means of the natural coordinates."""
    from ...io.checkpoint import stack_trace
    stacked = stack_trace(params_list[len(params_list) // 3:])

    def first(x):
        return np.asarray(x).reshape(np.shape(x)[0], -1)[:, 0]
    if model_name in ("svm", "svjm"):
        out = dict(phi=float(np.mean(first(stacked.A))),
                   sigma=float(np.mean(1.0 / np.abs(first(
                       stacked.LQinv_vec)))),
                   tau=float(np.mean(1.0 / np.abs(first(
                       stacked.LRinv_vec)))))
        if model_name == "svjm":
            out["pJ"] = float(np.mean(1.0 / (1.0 + np.exp(
                -first(stacked.logit_pJ)))))
            out["sigmaJ"] = float(np.mean(1.0 / np.abs(first(
                stacked.LQJinv_vec))))
        return out
    return dict(mu=float(np.mean(np.exp(first(stacked.log_mu)))))


def sgld_against_ld_ksd(device="cuda", seed: int = 0, T: int = 125,
                        sgld_iters: int = 3000, ld_iters: int = 600,
                        N: int = 128, ksd_N: int = 256,
                        samples: int = 60) -> dict:
    """The demo's headline comparison on a simulated SVM series of T
    steps: both legs (``fit_model``'s settings at N particles, the SGLD
    leg on the fused window where the card runs it) from (A, Q, R) =
    (0.3, 1, 2), then the KSD per natural coordinate (phi, sigma, tau)
    over ``samples`` evenly spaced samples of each leg's last half, scored
    by PaRIS at ``ksd_N`` particles over the whole series (unscaled).
    ``seed`` offsets the data's (42), the chains' (7) and the scores'
    (11) generator seeds.  Returns {leg: dict(ksd, seconds)}."""
    import torch

    from ...experiments.driver import convert_gradient, score_block
    from ...metrics.ksd import imq_ksd
    from ...models import svm
    dev = torch.device(device)
    ys, _ = svm.generate_data(
        torch.Generator(device=dev).manual_seed(42 + seed),
        svm.from_scalars(0.9, 0.5, 1.0, device=dev), T)
    scorer = make_sampler("svm", ys, seed=11 + seed, device=dev)
    out = {}
    for leg, iters in (("sgld", sgld_iters), ("ld", ld_iters)):
        t0 = time.perf_counter()
        _, plist, _ = fit_model(
            "svm", ys, leg, iters, N, seed=7 + seed, chunk_iters=iters,
            device=dev, init=svm.from_scalars(0.3, 1.0, 2.0, device=dev))
        seconds = time.perf_counter() - t0
        idx = np.linspace(iters // 2, iters - 1, samples).astype(int)
        sample = [plist[i] for i in idx]
        grads = score_block(scorer, sample, N=ksd_N, subsequence_length=-1,
                            pf="paris", resample_mode="auto",
                            is_scaled=False)
        nat = [convert_gradient("svm", q, g) for q, g in zip(sample, grads)]
        out[leg] = dict(seconds=seconds, ksd={v: float(imq_ksd(
            np.stack([getattr(a, v) for a, _ in nat]),
            np.stack([getattr(b, v) for _, b in nat]), device=dev))
            for v in ("phi", "sigma", "tau")})
    return out


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=DEFAULT_DATA)
    ap.add_argument("--model", default="svm",
                    choices=["svm", "svjm", "garch"])
    ap.add_argument("--mode", default="single",
                    choices=["single", "subset", "full"])
    ap.add_argument("--sgld_iters", type=int, default=20000)
    ap.add_argument("--ld_iters", type=int, default=2000)
    ap.add_argument("--sgld_chunk_iters", type=int, default=2000)
    ap.add_argument("--ld_chunk_iters", type=int, default=None,
                    help="default: 200, or 50 beyond 1000 observations")
    ap.add_argument("--N", type=int, default=1000)
    ap.add_argument("--n_particle_devices", type=int, default=1,
                    help="shard the particle filter over P devices "
                         "(fit_scan(mesh=...); --mode single only; one "
                         "process per device, under torchrun "
                         "--nproc_per_node P)")
    ap.add_argument("--segment", type=int, default=1)
    ap.add_argument("--out", default="./exchange_out")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> dict:
    """Run both legs; returns {leg: dict(samples, seconds,
    seconds_per_iteration, loglikelihood, summary)}."""
    from ...io import checkpoint as ckpt
    args = build_parser().parse_args(argv)
    seq = args.mode != "single"
    if args.n_particle_devices > 1:
        import torch.distributed as dist
        if seq:
            raise ValueError("--n_particle_devices needs --mode single")
        if int(os.environ.get("WORLD_SIZE", 1)) > 1 and \
                not dist.is_initialized():
            from ...parallel.sharding import initialize_multi_host
            initialize_multi_host()       # under torchrun
    writes = _rank() == 0
    # the multi-sequence modes need every segment to hold an S=16, B=4
    # window
    segments = load_segments(args.data, min_len=25 if seq else 7)
    if args.mode == "single":
        obs = segments[args.segment]
        total_obs = obs.shape[0]
        print(f"{len(segments)} segments; using segment {args.segment} "
              f"with {total_obs} observations")
    else:
        obs = segments[:5] if args.mode == "subset" else segments
        total_obs = sum(s.shape[0] for s in obs)
        print(f"{args.mode}: {len(obs)} segments, {total_obs} total "
              f"observations")

    results = {}
    for method in ["sgld", "ld"]:
        iters = args.sgld_iters if method == "sgld" else args.ld_iters
        chunk = (args.sgld_chunk_iters if method == "sgld" else
                 args.ld_chunk_iters or ld_chunk_iters(total_obs))
        t0 = time.perf_counter()
        sampler, params_list, times = fit_model(
            args.model, obs, method, iters, args.N, seq=seq,
            chunk_iters=chunk, n_particle_devices=args.n_particle_devices,
            device=args.device)
        seconds = time.perf_counter() - t0
        loglik = sampler.noisy_loglikelihood(N=args.N, pf="filter")
        print(f"{method}: {len(params_list)} samples in {seconds:.1f} s "
              f"({seconds / iters:.4f} s an iteration); final loglik "
              f"{loglik:.2f}")
        if writes:
            ckpt.save_trace(os.path.join(
                args.out, f"{args.model}_{method}_trace.p"), params_list,
                times)
        results[method] = dict(samples=len(params_list), seconds=seconds,
                               seconds_per_iteration=seconds / iters,
                               loglikelihood=loglik,
                               summary=summary(args.model, params_list))
    for method, r in results.items():
        print(f"{method}: " + " ".join(f"{k}={v:.4f}"
                                       for k, v in r["summary"].items()))
    return results


if __name__ == "__main__":
    main()
