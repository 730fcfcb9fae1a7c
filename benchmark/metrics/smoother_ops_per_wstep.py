"""Device operations (kernels, memcpys, memsets) but resample-apply per
window step (traced calls x iterations x W).  Nothing to read where no
resample-apply launch ran (the fused path)."""
from benchmark.harness import spec

NAME = "resample_apply"


def read(run):
    t = run.traces[0] if run.traces else None
    if t is None or not t.select(lambda n: NAME in n):
        return None
    wsteps = (t.calls * int(run.cell.workload["iters_per_call"])
              * spec.window_steps(run.cell.config))
    return len(t.select(lambda n: NAME not in n)) / wsteps
