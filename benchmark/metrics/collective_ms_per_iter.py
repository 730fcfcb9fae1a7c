"""Device time of the NCCL kernels per iteration, the smallest over the
ranks, in ms.  A collective's kernel runs from its launch until every
rank has joined, so on the ranks that arrive first it spins for the
slowest one; the rank that arrives last waits least, and its kernel time
is nearest the exchange's own work (it still holds what waiting is left
there).  Nothing to read where no NCCL kernel ran."""


def read(run):
    per_rank = []
    for t in run.traces:
        nccl = t.select(lambda n: n.lower().startswith("nccl"))
        if nccl:
            iters = t.calls * int(run.cell.workload["iters_per_call"])
            per_rank.append(sum(e - s for _, s, e in nccl) / 1e3 / iters)
    return min(per_rank) if per_rank else None
