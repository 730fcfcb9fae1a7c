"""Long-budget exchange-rate parameter runs (SGLD against LD).

Counterpart of ``demo/exchange_rate/save_params.py``: fit a
multi-sequence sampler over every segment of the exchange-rate series
with a wall-clock budget a leg,

  * SGLD: eps=1e-3, S=16, B=4, one sequence a step, Poyiadjis O(N),
    systematic resampling (beyond the fused kernel's shared memory, as
    at the default N=10000, the unfused route),
  * LD:   eps=0.1, every whole sequence, PaRIS,

and save the traces as ``calculate_ksd.py`` reads them.  Each leg runs
``fit_scan`` chunks (``--chunk_iters`` / ``--ld_chunk_iters``
iterations) between clock checks.  Runs on the card unless ``--device
cpu``.

Usage: python -m sgmcmc_tpu_torch.demo.exchange_rate.save_params
    --data PATH.npz [--model svm|garch|svjm] [--N 10000]
    [--fit_time SECONDS] [--out DIR]
"""
import argparse
import os

from .exchange_rate_demo import (DEFAULT_DATA, ld_chunk_iters, leg_kwargs,
                                 load_segments, make_sampler)


def main(argv=None) -> dict:
    """Returns {leg: trace path}."""
    from ...io import checkpoint as ckpt
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="svm",
                    choices=["svm", "garch", "svjm"])
    ap.add_argument("--data", default=DEFAULT_DATA)
    ap.add_argument("--N", type=int, default=10000)
    ap.add_argument("--fit_time", type=float, default=600.0,
                    help="wall-clock budget a leg, seconds")
    ap.add_argument("--chunk_iters", type=int, default=2000,
                    help="iterations a fit_scan chunk of the SGLD leg")
    ap.add_argument("--ld_chunk_iters", type=int, default=None,
                    help="iterations a fit_scan chunk of the LD leg "
                         "(default: 200, or 50 beyond 1000 observations)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out_dir = args.out or f"./eur_{args.model}_results"
    os.makedirs(os.path.join(out_dir, "samples"), exist_ok=True)
    segments = load_segments(args.data, min_len=25)
    total_obs = sum(s.shape[0] for s in segments)
    print(f"{len(segments)} segments, {total_obs} observations")

    sampler = make_sampler(args.model, segments, seq=True,
                           device=args.device)
    sampler.project_parameters()
    chunks = dict(sgld=args.chunk_iters,
                  ld=args.ld_chunk_iters or ld_chunk_iters(total_obs))
    paths = {}
    for name in ("sgld", "ld"):
        kw = leg_kwargs(name, args.N, seq=True)
        params_list, times = sampler.fit_timed(
            "SGLD", max_time=args.fit_time, chunk_iters=chunks[name], **kw)
        path = os.path.join(out_dir, "samples", f"{name}_trace.p")
        ckpt.save_trace(path, params_list, times)
        print(f"{name}: {len(params_list)} samples in {times[-1]:.0f} s "
              f"-> {path}")
        paths[name] = path
    print(f"KSD: python -m sgmcmc_tpu_torch.demo.exchange_rate."
          f"calculate_ksd --model {args.model} --data {args.data} --trace "
          f"{paths['sgld']} {paths['ld']}")
    return paths


if __name__ == "__main__":
    main()
