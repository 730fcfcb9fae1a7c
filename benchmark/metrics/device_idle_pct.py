"""Share of the traced window in which no kernel, memcpy or memset ran
on the card: 1 - the union of their intervals over the window, averaged
over the ranks, in %.  Nothing to read where no device operation ran."""


def read(run):
    traces = [t for t in run.traces if t.ops]
    if not traces:
        return None
    shares = [1.0 - t.busy_us / t.window_us for t in traces]
    return 100.0 * sum(shares) / len(shares)
