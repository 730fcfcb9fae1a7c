"""The exchange-rate demo's SGLD-against-LD KSD comparison at several seeds.

    python scripts/ksd_gate_seeds.py --package torch [--device cpu] \\
        --seeds 0 1 2 3
    python scripts/ksd_gate_seeds.py --package jax --seeds 0 1 2 3

The protocol of tests/test_ksd_sgld_vs_ld.py: an SVM series of T=125
steps, SGLD (3000 iterations, eps=1e-3, S=16, B=4, systematic Poyiadjis
O(N)) and full-sequence LD (600 iterations, eps=0.1, PaRIS), both at
N=128 from (A, Q, R) = (0.3, 1, 2), then the IMQ KSD of phi, sigma and tau
over 60 samples of each leg's last half, scored by PaRIS at N=256 over the
whole series.  Each seed offsets the data's (42), the chains' (7) and the
scores' (11) seeds; seed 0 is the test's own for the JAX package and
chip_smoke.py's for the port.  ``--package jax`` runs the JAX package on
the CPU (its reference); ``--package torch`` the port, on the card unless
``--device cpu``.  Prints one JSON line a seed: each leg's KSD, the LD /
SGLD ratios and which of the test's margins hold (LD's phi below half
SGLD's; SGLD within 4x of LD on sigma and tau; phi's ratio the smallest).

Run from the repository's root with it on ``PYTHONPATH``.
"""
import argparse
import json
import time

import numpy as np

VARS = ("phi", "sigma", "tau")


def jax_protocol(seed: int) -> dict:
    """The JAX package's run of the test's protocol (the CPU, float64)."""
    import os
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from sgmcmc_tpu.experiments.driver import convert_gradient
    from sgmcmc_tpu.inference.samplers import SVMSampler
    from sgmcmc_tpu.metrics.ksd import imq_ksd
    from sgmcmc_tpu.models import svm

    true = svm.from_scalars(A=0.9, Q=0.5, R=1.0, dtype=jnp.float64)
    ys, _ = svm.generate_data(jax.random.PRNGKey(42 + seed), true, 125)
    legs = dict(
        sgld=(3000, dict(epsilon=1e-3, subsequence_length=16,
                         buffer_length=4, pf="poyiadjis_N",
                         resampler="systematic")),
        ld=(600, dict(epsilon=0.1, subsequence_length=-1, pf="paris")))
    out = {}
    for leg, (iters, kw) in legs.items():
        t0 = time.perf_counter()
        s = SVMSampler(observations=ys, seed=7 + seed)
        s.parameters = svm.from_scalars(A=0.3, Q=1.0, R=2.0,
                                        dtype=jnp.float64)
        trace = s.fit_scan("SGLD", num_iters=iters, N=128,
                           resample_mode="gather", **kw)
        seconds = time.perf_counter() - t0
        idx = np.linspace(iters // 2, iters - 1, 60).astype(int)
        scorer = SVMSampler(observations=ys, seed=11 + seed)
        vals, grads = [], []
        for i in idx:
            p = jax.tree_util.tree_map(lambda x: jnp.asarray(x)[i], trace)
            scorer.parameters = p
            g = scorer.noisy_gradient(N=256, subsequence_length=-1,
                                      pf="paris", resample_mode="gather",
                                      is_scaled=False)
            v, gn = convert_gradient("svm", p, g)
            vals.append(v)
            grads.append(gn)
        out[leg] = dict(seconds=seconds, ksd={var: float(imq_ksd(
            jnp.asarray(np.stack([getattr(v, var) for v in vals])),
            jnp.asarray(np.stack([getattr(g, var) for g in grads]))))
            for var in VARS})
    return out


def margins(res: dict) -> dict:
    k_s, k_l = res["sgld"]["ksd"], res["ld"]["ksd"]
    ratios = {v: k_l[v] / k_s[v] for v in VARS}
    return dict(ratios=ratios, phi_below_half=ratios["phi"] < 0.5,
                sgld_within_4x=bool(k_s["sigma"] < 4 * k_l["sigma"]
                                    and k_s["tau"] < 4 * k_l["tau"]),
                phi_smallest=ratios["phi"] < min(ratios["sigma"],
                                                 ratios["tau"]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=["torch", "jax"], default="torch")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    for seed in args.seeds:
        if args.package == "jax":
            res = jax_protocol(seed)
        else:
            from sgmcmc_tpu_torch.demo.exchange_rate import exchange_rate_demo
            res = exchange_rate_demo.sgld_against_ld_ksd(args.device, seed)
        print(json.dumps(dict(package=args.package, seed=seed, **res,
                              **margins(res))), flush=True)


if __name__ == "__main__":
    main()
