"""KSD of exchange-rate parameter traces (SGLD against LD).

Counterpart of ``demo/exchange_rate/calculate_ksd.py``: for each saved
trace, the PaRIS score (unscaled, the whole segment) at each post-burn-in
sample, then the IMQ kernel Stein discrepancy per variable.  The scores of
``BLOCK`` samples run as the chains of one call.  Runs on the card unless
``--device cpu``.

Usage: python -m sgmcmc_tpu_torch.demo.exchange_rate.calculate_ksd
    --data PATH.npz --trace PATH.p [PATH.p ...] [--model svm|svjm|garch]
"""
import argparse

import numpy as np

from .exchange_rate_demo import DEFAULT_DATA, load_segments, make_sampler

# samples scored as the chains of one PaRIS call (at N=10000 a block
# holds [10, N, N] backward weights, ~12 GB)
BLOCK = 10
# The natural KSD coordinates: SVM (phi, sigma, tau) and SVJM as the
# experiments' driver converts them; GARCH in its storage coordinates,
# LRinv_vec itself (not the driver's tau).
VARIABLES = {
    "svm": ["phi", "sigma", "tau"],
    "svjm": ["phi", "sigma", "tau", "logit_pJ", "sigmaJ"],
    "garch": ["log_mu", "logit_phi", "logit_lambduh", "LRinv_vec"],
}


def trace_ksd(sampler, model_name: str, params_list, N: int,
              max_samples: int, device) -> dict:
    """{variable: KSD} of one trace (the first third burned, at most
    ``max_samples`` samples evenly spaced)."""
    from ...experiments.driver import convert_gradient, score_block
    from ...metrics.ksd import compute_ksd
    params_list = params_list[len(params_list) // 3:]
    if len(params_list) > max_samples:
        idx = np.linspace(0, len(params_list) - 1, max_samples).astype(int)
        params_list = [params_list[i] for i in idx]
    grads = []
    for i in range(0, len(params_list), BLOCK):
        grads += score_block(sampler, params_list[i:i + BLOCK], pf="paris",
                             N=N, subsequence_length=-1, is_scaled=False,
                             resample_mode="auto")
    if model_name in ("svm", "svjm"):
        nat = [convert_gradient(model_name, q, g)
               for q, g in zip(params_list, grads)]
        return compute_ksd([v for v, _ in nat], [g for _, g in nat],
                           VARIABLES[model_name], device=device)
    return compute_ksd(params_list, grads, VARIABLES[model_name],
                       device=device)


def main(argv=None) -> dict:
    """Returns {trace path: {variable: KSD}}."""
    from ...io import checkpoint as ckpt
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", nargs="+", required=True)
    ap.add_argument("--model", default="svm",
                    choices=["svm", "svjm", "garch"])
    ap.add_argument("--data", default=DEFAULT_DATA,
                    help="npz with hourly_log_returns and hourly_date")
    ap.add_argument("--segment", type=int, default=1)
    ap.add_argument("--N", type=int, default=10000)
    ap.add_argument("--max_samples", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    obs = load_segments(args.data)[args.segment]
    sampler = make_sampler(args.model, obs, seed=0, device=args.device)
    out = {}
    for trace_path in args.trace:
        params_list = ckpt.load_trace(trace_path)["parameters_list"]
        out[trace_path] = trace_ksd(sampler, args.model, params_list, args.N,
                                    args.max_samples, args.device)
        print(trace_path, out[trace_path])
    return out


if __name__ == "__main__":
    main()
