"""Share of the traced window in which no kernel, memcpy or memset ran on
the card while the host was inside one of the program's
``sgmcmc.fit_scan`` spans, averaged over the ranks, in %:
``device_idle_pct`` less this is the idle outside the program (the
harness's read of each call's output and its loop).  Idle is matched to
the host by overlap in time, so short gaps between dependent kernels
while the host is still enqueueing a call count as the program's.
Nothing to read where no device operation ran or the program records no
such span."""
from benchmark.harness import trace

NAME = "sgmcmc.fit_scan"


def read(run):
    shares = []
    for t in run.traces:
        calls = [(s, e) for n, s, e, _ in t.host if n == NAME]
        if not t.ops or not calls:
            continue
        gaps = trace.idle_gaps([(s, e) for _, s, e in t.ops], t.lo, t.hi)
        idle = sum(max(0.0, min(ge, ce) - max(gs, cs))
                   for gs, ge in gaps for cs, ce in calls)
        shares.append(idle / t.window_us)
    return 100.0 * sum(shares) / len(shares) if shares else None
