"""The resample-apply kernel's share of its roofline: the frozen bound
over the rows one launch draws (``counts/resample_apply.py``: C chains, N
positions over N particles, K = state dimensions + statistics) over the
mean trace time of a launch, in %.  Nothing to read where none ran."""
from benchmark.counts import resample_apply
from benchmark.harness import spec

NAME = "resample_apply"


def read(run):
    cfg, wl = run.cell.config, run.cell.workload
    ref = spec.reference_model(cfg["reference"])
    N = spec.particles_per_rank(cfg)
    K = ref.STATE_DIM + ref.STAT_DIM
    bound = resample_apply.bound_s(int(wl["num_chains"]), N, N, K)
    shares = []
    for t in run.traces:
        launches = t.select(lambda n: NAME in n)
        if launches:
            mean_s = sum(e - s for _, s, e in launches) / len(launches) / 1e6
            shares.append(bound / mean_s)
    return 100.0 * sum(shares) / len(shares) if shares else None
