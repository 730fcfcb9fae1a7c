"""The unfused smoother's step kernel's share of its roofline: the frozen
bound of one launch at the cell's shapes (``counts/smoother_step.py``)
over the mean trace time of a launch, averaged over the ranks, in %.
Nothing to read where none ran."""
from benchmark.counts import smoother_step
from benchmark.harness import spec

NAME = "smoother_step_kernel"


def read(run):
    cfg, wl = run.cell.config, run.cell.workload
    ref = spec.reference_model(cfg["reference"])
    body = spec.counts(cfg["k1_body"] + "_body").BODY_OPS
    bound = smoother_step.bound_s(
        int(wl["num_chains"]), spec.particles_per_rank(cfg), ref.STATE_DIM,
        ref.NOISE_DIM, ref.STAT_DIM, body)
    shares = []
    for t in run.traces:
        launches = t.select(lambda n: NAME in n)
        if launches:
            mean_s = sum(e - s for _, s, e in launches) / len(launches) / 1e6
            shares.append(bound / mean_s)
    return 100.0 * sum(shares) / len(shares) if shares else None
