"""Host time of a window step of the unfused smoother: the mean duration
of the program's ``sgmcmc.smoother.step`` spans (one a window step,
resample-apply included), averaged over the ranks, in ms; read beside
``smoother_ms_per_wstep``, the device's time for the same step.  A span
also holds the time the host waits on a full launch queue, so it reads
the larger of the host's enqueue time and the card's pace.  Nothing to
read where the program records no such span (the fused window has
none)."""

NAME = "sgmcmc.smoother.step"


def read(run):
    per_rank = []
    for t in run.traces:
        spans = [e - s for n, s, e, _ in t.host if n == NAME]
        if spans:
            per_rank.append(sum(spans) / len(spans) / 1e3)
    return sum(per_rank) / len(per_rank) if per_rank else None
