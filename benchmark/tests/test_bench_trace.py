"""The trace's arithmetic: the union of device intervals, the idle share
and the gaps, on synthetic events."""
from benchmark.harness import trace


def test_union_merges_overlaps_and_nesting():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (22, 25)]) == 25
    assert trace.union_us([]) == 0.0
    assert trace.union_us([(3, 4)]) == 1


def test_idle_gaps_cover_the_rest_of_the_window():
    gaps = trace.idle_gaps([(2, 4), (3, 6), (8, 9)], 0, 10)
    assert gaps == [(0, 2), (6, 8), (9, 10)]
    assert sum(e - s for s, e in gaps) + trace.union_us(
        [(2, 4), (3, 6), (8, 9)]) == 10


def _events():
    ev = [{"cat": "user_annotation", "name": "bench.window", "ph": "X",
           "ts": 100, "dur": 100},
          {"cat": "user_annotation", "name": "bench.call", "ph": "X",
           "ts": 100, "dur": 60},
          {"cat": "user_annotation", "name": "bench.sync", "ph": "X",
           "ts": 160, "dur": 40},
          {"cat": "cpu_op", "name": "aten::item", "ph": "X", "ts": 160,
           "dur": 35},
          # a kernel that starts before the window is clipped to it
          {"cat": "kernel", "name": "k_a", "ph": "X", "ts": 90, "dur": 30},
          {"cat": "kernel", "name": "k_b", "ph": "X", "ts": 130, "dur": 20},
          {"cat": "gpu_memcpy", "name": "copy", "ph": "X", "ts": 140,
           "dur": 20},
          {"cat": "kernel", "name": "k_b", "ph": "X", "ts": 190, "dur": 5},
          # the span's device-side twin is not device work
          {"cat": "gpu_user_annotation", "name": "bench.call", "ph": "X",
           "ts": 100, "dur": 60}]
    return ev


def test_parse_busy_idle_and_breakdown():
    t = trace.parse(_events(), calls=1)
    assert (t.lo, t.hi, t.window_us) == (100.0, 200.0, 100.0)
    # device intervals: [100, 120], [130, 160], [190, 195]
    assert t.busy_us == 55.0
    assert t.top_ops(2) == [["k_b", 25e-6], ["k_a", 20e-6]]
    gaps = t.top_gaps(3)
    assert gaps[0] == ["bench.sync/aten::item", 30e-6]
    assert gaps[1] == ["bench.call", 10e-6]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)


def test_parse_needs_one_window_span():
    ev = [e for e in _events() if e["name"] != "bench.window"]
    try:
        trace.parse(ev, calls=1)
    except RuntimeError as err:
        assert "bench.window" in str(err)
    else:
        raise AssertionError("a trace without its window span parsed")
