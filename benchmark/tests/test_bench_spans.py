"""The readers of the program's spans on synthetic traces (each with its
nothing-to-read case and its island twin), then on the traces of whole
CPU runs of the harness."""
import time
from types import SimpleNamespace

import pytest

from benchmark.harness import main, spec, trace
from benchmark.tests.small import cpu_route, small_cell

SPAN_METRICS = ["host_ms_per_iter", "smoother_host_ms_per_wstep",
                "program_idle_pct", "collectives_per_iter"]
TWINS = {"host_ms_per_iter": "host_ms_per_iter.island",
         "program_idle_pct": "program_idle_pct.island"}


def _run(*traces):
    return SimpleNamespace(cell=spec.load_cell("garch_unfused"),
                           traces=list(traces))


def _trace(ops=(), host=(), lo=0.0, hi=1000.0):
    """A rank's trace: device operations ``(start, end)`` and host spans
    ``(name, start, end)``."""
    return trace.Trace([("kernel", s, e) for s, e in ops], lo, hi, 1,
                       [(n, s, e, 0) for n, s, e in host])


def _read(name, run):
    value = spec.metric_reader(name)(run)
    if name in TWINS:
        assert spec.metric_reader(TWINS[name])(run) == value
    return value


def test_host_times_are_mean_span_lengths_averaged_over_ranks():
    a = _trace(host=[("sgmcmc.iter", 0.0, 100.0),
                     ("sgmcmc.iter", 100.0, 300.0),
                     ("sgmcmc.smoother.step", 0.0, 4.0),
                     ("sgmcmc.smoother.step", 10.0, 12.0),
                     ("aten::add", 0.0, 500.0)])
    b = _trace(host=[("sgmcmc.iter", 0.0, 400.0)])
    assert _read("host_ms_per_iter", _run(a)) == pytest.approx(0.15)
    assert _read("host_ms_per_iter", _run(a, b)) == \
        pytest.approx((0.15 + 0.4) / 2)
    # a rank without the span does not pull the mean down
    assert _read("smoother_host_ms_per_wstep", _run(a, b)) == \
        pytest.approx(0.003)


def test_program_idle_is_the_idle_inside_fit_scan():
    # busy [0, 100] and [300, 400] of [0, 1000]; the program's call
    # [50, 350] holds the gap [100, 300]: 20% of the window; the rest of
    # the idle (60%) lies outside it
    t = _trace(ops=[(0.0, 100.0), (300.0, 400.0)],
               host=[("sgmcmc.fit_scan", 50.0, 350.0),
                     ("sgmcmc.iter", 60.0, 340.0)])
    assert _read("program_idle_pct", _run(t)) == pytest.approx(20.0)
    # two calls, the second over the window's idle tail [400, 1000]
    t2 = _trace(ops=[(0.0, 100.0), (300.0, 400.0)],
                host=[("sgmcmc.fit_scan", 50.0, 350.0),
                      ("sgmcmc.fit_scan", 350.0, 900.0)])
    assert _read("program_idle_pct", _run(t2)) == pytest.approx(70.0)
    assert _read("program_idle_pct", _run(t, t2)) == pytest.approx(45.0)


def test_collectives_count_inside_iterations_only():
    iters = [("sgmcmc.iter", 100.0 * i, 100.0 * i + 90.0) for i in range(3)]
    inside = [("sgmcmc.collective", 100.0 * i + s, 100.0 * i + s + 5.0)
              for i in range(3) for s in (40.0, 60.0)]
    gather = [("sgmcmc.collective", 950.0, 960.0)]     # after the fit
    t = _trace(host=iters + inside + gather)
    assert _read("collectives_per_iter", _run(t)) == 2.0
    one = _trace(host=iters + inside[:3])
    assert _read("collectives_per_iter", _run(t, one)) == \
        pytest.approx((2.0 + 1.0) / 2)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_nothing_to_read_without_the_spans(name):
    # the parent's program: device operations and the harness's own
    # spans, none of the program's
    parent = _trace(ops=[(0.0, 100.0)],
                    host=[("bench.window", 0.0, 1000.0),
                          ("bench.call", 0.0, 500.0),
                          ("aten::mul", 10.0, 20.0)])
    assert _read(name, _run(parent)) is None
    assert _read(name, _run()) is None


def test_nothing_to_read_where_no_device_op_ran():
    t = _trace(host=[("sgmcmc.fit_scan", 0.0, 500.0)])
    assert _read("program_idle_pct", _run(t)) is None


def test_no_collective_on_one_card():
    t = _trace(host=[("sgmcmc.iter", 0.0, 100.0)])
    assert _read("collectives_per_iter", _run(t)) is None


def _traced(cell):
    with cpu_route(cell):
        return main.run_cell(cell, 2 ** 31 + 91, 0.5, True, time.time(),
                             "cpu", "gloo", decide=False)


def test_traced_cpu_run_reads_the_spans():
    """The unfused cell's traced call on the CPU: the program's spans are
    in the harness's trace (no device in this process: nothing for the
    idle readers)."""
    cell = small_cell("garch_unfused")
    out, metrics, _, _, _ = _traced(cell)
    t = out.run.traces[0]
    iters = int(cell.workload["iters_per_call"])
    names = [n for n, _, _, _ in t.host]
    assert names.count("sgmcmc.fit_scan") == t.calls == 1
    assert names.count("sgmcmc.iter") == iters
    assert names.count("sgmcmc.smoother.step") == \
        iters * spec.window_steps(cell.config)
    assert metrics["host_ms_per_iter"]["value"] > \
        metrics["smoother_host_ms_per_wstep"]["value"] > 0
    assert "program_idle_pct" not in metrics
    assert "collectives_per_iter" not in metrics


def test_traced_island_run_counts_two_collectives_an_iteration():
    cell = small_cell("svm_island_4chip", chains=4, T=120, N=32, ranks=2)
    out, metrics, _, _, _ = _traced(cell)
    assert len(out.run.traces) == 2
    assert metrics["collectives_per_iter"]["value"] == 2.0
    assert metrics["host_ms_per_iter.island"]["value"] > 0
