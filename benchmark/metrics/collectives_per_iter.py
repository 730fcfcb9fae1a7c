"""Collectives an iteration: the program's ``sgmcmc.collective`` spans
(one per all-reduce or all-gather that runs over more than one rank)
that lie inside its ``sgmcmc.iter`` spans, over the iterations, averaged
over the ranks.  Nothing to read where the program records no iteration
or no collective span (one card)."""

ITER, COLLECTIVE = "sgmcmc.iter", "sgmcmc.collective"


def read(run):
    per_rank = []
    for t in run.traces:
        iters = [(s, e) for n, s, e, _ in t.host if n == ITER]
        colls = [(s, e) for n, s, e, _ in t.host if n == COLLECTIVE]
        if not iters or not colls:
            continue
        inside = sum(any(s <= cs and ce <= e for s, e in iters)
                     for cs, ce in colls)
        per_rank.append(inside / len(iters))
    return sum(per_rank) / len(per_rank) if per_rank else None
