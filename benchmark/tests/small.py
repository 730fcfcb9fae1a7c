"""A cell cut to a size a CPU test holds, and the port's CPU routes."""
import contextlib

from benchmark.harness import spec
from sgmcmc_tpu_torch.inference import sgmcmc


def small_cell(name, chains=8, T=200, N=64, ranks=None):
    """The cell ``name`` at ``chains`` chains, a T-step series and N
    particles a filter (the launch counters expect none: the CPU routes
    launch no kernel)."""
    c = spec.load_cell(name)
    P = int(c.config.get("particle_devices", 1)) if ranks is None else ranks
    c.config = dict(c.config, T=T, N=N * P, particle_devices=P)
    c.workload = dict(c.workload, num_chains=chains, trace_calls=1,
                      launches_per_call={
                          k: 0 for k in c.workload["launches_per_call"]})
    return c


@contextlib.contextmanager
def cpu_route(cell):
    """On the CPU the port's score takes the unfused smoother; a cell that
    runs the fused window on the card gets its plain version here, with
    the draws of that route."""
    orig = sgmcmc.PFScore.uses_fused
    if cell.workload["route"] == "k1":
        sgmcmc.PFScore.uses_fused = lambda self, device: True
    try:
        yield
    finally:
        sgmcmc.PFScore.uses_fused = orig
