"""Host time of an iteration: the mean duration of the program's
``sgmcmc.iter`` spans (one a fit iteration: its score, the prior's score,
the Langevin update, the projection and the record), averaged over the
ranks, in ms.  A span also holds the time the host waits on a full launch
queue, so it reads the larger of the host's enqueue time and the card's
pace: compare it with the device time of the same work before calling a
path host-bound.  Nothing to read where the program records no such
span."""

NAME = "sgmcmc.iter"


def read(run):
    per_rank = []
    for t in run.traces:
        spans = [e - s for n, s, e, _ in t.host if n == NAME]
        if spans:
            per_rank.append(sum(spans) / len(spans) / 1e3)
    return sum(per_rank) / len(per_rank) if per_rank else None
