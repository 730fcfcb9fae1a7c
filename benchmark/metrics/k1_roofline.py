"""The fused window kernel's (K1's) share of its roofline: the frozen
bound of one launch at the cell's shapes (``counts/k1.py``) over the mean
trace time of a K1 launch, averaged over the ranks, in %.  Nothing to
read where no K1 launch ran."""
from benchmark.counts import k1
from benchmark.harness import spec

NAME = "fused_window_kernel"


def read(run):
    cfg, wl = run.cell.config, run.cell.workload
    ref = spec.reference_model(cfg["reference"])
    body = spec.counts(cfg["k1_body"] + "_body").BODY_OPS
    N, W = spec.particles_per_rank(cfg), spec.window_steps(cfg)
    bound = k1.bound_s(int(wl["num_chains"]), W, N, body, ref.STATE_DIM,
                       ref.NOISE_DIM, len(ref.LEAVES), ref.STAT_DIM,
                       wl["call"].get("rng", "host") == "kernel")
    shares = []
    for t in run.traces:
        launches = t.select(lambda n: NAME in n)
        if launches:
            mean_s = sum(e - s for _, s, e in launches) / len(launches) / 1e6
            shares.append(bound / mean_s)
    return 100.0 * sum(shares) / len(shares) if shares else None
