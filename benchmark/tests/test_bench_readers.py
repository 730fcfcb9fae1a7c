"""The end-to-end metrics' readers on a synthetic window with a stall, and
the per-layer readers on a synthetic trace."""
import statistics
from types import SimpleNamespace

import pytest

from benchmark.harness import spec, trace


def _run(calls, start=0.0, traces=()):
    cell = spec.load_cell("svm_k1")
    return SimpleNamespace(cell=cell, calls=calls, window_start=start,
                           setup_s=12.5, peak_bytes=3 * 2 ** 29,
                           traces=list(traces),
                           chain_steps_per_call=8192 * 10)


def test_rate_counts_every_call_and_all_the_time():
    # 20 calls of 0.1 s and one stall of 2 s between calls 10 and 11
    calls, t = [], 0.0
    for i in range(20):
        if i == 10:
            t += 2.0
        calls.append((t, t + 0.1))
        t += 0.1
    rate = spec.metric_reader("steps_per_s")(_run(calls))
    assert rate == pytest.approx(20 * 8192 * 10 / 4.0)


def test_p95_is_the_tail_of_all_calls():
    times = [0.05] * 95 + [0.5] * 5
    calls, t = [], 0.0
    for d in times:
        calls.append((t, t + d))
        t += d
    p95 = spec.metric_reader("call_p95_ms")(_run(calls))
    assert p95 == pytest.approx(
        statistics.quantiles([1e3 * d for d in times], n=20,
                             method="inclusive")[18])
    assert 50.0 <= p95 <= 500.0
    # one more stall moves the tail, not the median
    times2 = times[:-6] + [2.0] * 6
    calls2, t = [], 0.0
    for d in times2:
        calls2.append((t, t + d))
        t += d
    assert spec.metric_reader("call_p95_ms")(_run(calls2)) > p95


def test_memory_and_setup_readers():
    run = _run([(0.0, 1.0)])
    assert spec.metric_reader("peak_mem_gib")(run) == 1.5
    assert spec.metric_reader("setup_s")(run) == 12.5


def _trace(names_durations, calls=1, window=1000.0):
    ops, t = [], 0.0
    for name, dur in names_durations:
        ops.append((name, t, t + dur))
        t += dur
    return trace.Trace(ops, 0.0, window, calls)


def test_k1_reader_reads_only_k1_launches():
    k1 = "void fused_window_kernel<SvmBody>(...)"
    t = _trace([(k1, 100.0)] * 10 + [("elementwise", 5.0)] * 30,
               window=2000.0)
    run = _run([(0.0, 1.0)], traces=[t])
    share = spec.metric_reader("k1_roofline")(run)
    from benchmark.counts import k1
    bound = k1.bound_s(8192, 60, 1000, 35, 1, 1, 3, 3, True)
    assert share == pytest.approx(100.0 * bound / 100e-6)
    assert spec.metric_reader("loop_ops_per_iter")(run) == 3.0
    idle = spec.metric_reader("device_idle_pct")(run)
    assert idle == pytest.approx(100.0 * (1 - 1150.0 / 2000.0))
    # nothing to read: no resample-apply or NCCL launch in this trace
    assert spec.metric_reader("resample_roofline")(run) is None
    assert spec.metric_reader("smoother_ops_per_wstep")(run) is None
    assert spec.metric_reader("collective_ms_per_iter")(run) is None


def test_unfused_and_collective_readers():
    ra = "void resample_apply_kernel<true>(...)"
    t = _trace([(ra, 2.0)] * 600 + [("cat", 1.0)] * 6000
               + [("ncclDevKernel_AllReduce", 3.0)] * 10)
    cell = spec.load_cell("garch_unfused")
    run = _run([(0.0, 1.0)], traces=[t])
    run.cell = cell
    assert spec.metric_reader("smoother_ops_per_wstep")(run) == \
        pytest.approx(6010 / 600)
    assert spec.metric_reader("smoother_ms_per_wstep")(run) == \
        pytest.approx((6000 + 30) / 1e3 / 600)
    assert spec.metric_reader("k1_roofline")(run) is None
    assert spec.metric_reader("collective_ms_per_iter")(run) == \
        pytest.approx(0.03 / 10)
    # a rank that spun longer for the slowest one does not set it
    spun = _trace([("ncclDevKernel_AllReduce", 9.0)] * 10)
    run.traces = [spun, t]
    assert spec.metric_reader("collective_ms_per_iter")(run) == \
        pytest.approx(0.03 / 10)


def test_step_kernel_reader_and_the_paris_count():
    s1 = "void sgmcmc_step::smoother_step_kernel<SvmBody, float>(...)"
    ra = "void resample_apply_kernel<true>(...)"
    t = _trace([(ra, 2.0), (s1, 3.0)] * 600, calls=1, window=4000.0)
    run = _run([(0.0, 1.0)], traces=[t])
    run.cell = spec.load_cell("svm_unfused")
    from benchmark.counts import paris, peaks, smoother_step, svm_body
    bound = smoother_step.bound_s(8192, 1000, 1, 1, 3, 35)
    assert spec.metric_reader("smoother_step_roofline")(run) == \
        pytest.approx(100.0 * bound / 3e-6)
    # the step kernel is not resample-apply: the smoother's own time
    assert spec.metric_reader("smoother_ms_per_wstep")(run) == \
        pytest.approx(1800.0 / 1e3 / 600)
    # PaRIS's cell counts its backward step; no step kernel there
    run.cell = spec.load_cell("svm_paris100")
    ops = paris.ops(8192 * 10, 60, 100, svm_body, 1, 2, 3)
    assert spec.metric_reader("step_mfu")(run) == pytest.approx(
        100.0 * ops / (4000e-6 * peaks.F32_OPS_S))
    run.traces = [_trace([(ra, 2.0)] * 600)]
    assert spec.metric_reader("smoother_step_roofline")(run) is None
