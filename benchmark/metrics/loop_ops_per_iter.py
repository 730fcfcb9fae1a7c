"""Device operations per iteration other than the fused window kernel
(K1): the sampler loop's, the score's draws and layout, the prior's
score, the Langevin step and the projection.  Nothing to read where no
K1 launch ran."""

NAME = "fused_window_kernel"


def read(run):
    t = run.traces[0] if run.traces else None
    if t is None or not t.select(lambda n: NAME in n):
        return None
    iters = t.calls * int(run.cell.workload["iters_per_call"])
    return len(t.select(lambda n: NAME not in n)) / iters
