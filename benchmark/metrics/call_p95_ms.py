"""95th percentile of the wall time of every call of the window (host
clock, each call ended by a synchronising read of its output), in ms;
statistics.quantiles' inclusive method over all calls."""
import statistics


def read(run):
    times = [1e3 * (end - start) for start, end in run.calls]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[18]
