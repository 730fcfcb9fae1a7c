"""The traced window: ``torch.profiler`` over a few calls, read back.

The benchmark's own spans (``record_function`` in this file) wrap the
traced window (``bench.window``), each call into the port
(``bench.call``) and the synchronising read of its output
(``bench.sync``).  The device's activity is every kernel, memcpy and
memset of the trace inside the window; its busy time is the union of
their intervals (copied from ``scripts/profile_torch_slice.py``'s
``union_us`` and its trace parsing).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("bench.window", "bench.call", "bench.sync")


def union_us(intervals) -> float:
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The ``(start, end)`` gaps of ``[lo, hi]`` that no interval covers."""
    gaps, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


@dataclass
class Trace:
    """One rank's traced window: device operations ``(name, start_us,
    end_us)`` clipped to the window, the window's bounds, the number of
    traced calls and the host's spans and operations."""
    ops: list
    lo: float
    hi: float
    calls: int
    host: list = field(default_factory=list)    # (name, start, end, depth)

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    @property
    def busy_us(self) -> float:
        return union_us([(s, e) for _, s, e in self.ops])

    def select(self, pred):
        return [(n, s, e) for n, s, e in self.ops if pred(n)]

    def top_ops(self, k: int = 10):
        """[name, seconds] of the ``k`` device operations that took the most
        time in all."""
        per = {}
        for n, s, e in self.ops:
            per[n] = per.get(n, 0.0) + (e - s)
        top = sorted(per.items(), key=lambda kv: -kv[1])[:k]
        return [[n, us / 1e6] for n, us in top]

    def top_gaps(self, k: int = 10):
        """[what the host was doing, seconds] of the ``k`` longest idle
        gaps: the benchmark span and the deepest host operation running
        where the gap starts."""
        gaps = sorted(idle_gaps([(s, e) for _, s, e in self.ops], self.lo,
                                self.hi), key=lambda g: g[0] - g[1])[:k]
        out = []
        for s, e in gaps:
            span, op, depth = "bench.window", None, -1
            for name, hs, he, d in self.host:
                if hs <= s < he:
                    if name in SPANS:
                        if SPANS.index(name) >= SPANS.index(span):
                            span = name
                    elif d > depth:
                        op, depth = name, d
            out.append([span if op is None else f"{span}/{op}",
                        (e - s) / 1e6])
        return out


def _depths(events):
    """Nesting depth of each host event by its interval (events sorted by
    start, longer first on ties)."""
    stack, out = [], []
    for name, s, e in sorted(events, key=lambda v: (v[1], -v[2])):
        while stack and stack[-1] <= s:
            stack.pop()
        out.append((name, s, e, len(stack)))
        stack.append(e)
    return out


def parse(events: list, calls: int) -> Trace:
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "bench.window"]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} bench.window spans in the trace")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    ops = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s = max(float(e["ts"]), lo)
            t = min(float(e["ts"]) + float(e["dur"]), hi)
            if t > s:
                ops.append((e["name"], s, t))
    host = _depths([(e["name"], float(e["ts"]),
                     float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") in ("user_annotation", "cpu_op")
                    and e.get("ph") == "X"
                    and lo <= float(e["ts"]) < hi])
    return Trace(ops, lo, hi, calls, host)


def traced_window(system, n_calls: int, sync):
    """Run ``n_calls`` calls of ``system`` under the profiler; returns
    ``(Trace, [(start, end)] of the calls, calls with a non-finite output,
    the last call's starting state, its recorded trace and its
    log-likelihoods)``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    calls, failed = [], 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for _ in range(n_calls):
                state = system.state()
                t0 = time.perf_counter()
                with record_function("bench.call"):
                    rec, aux = system.call()
                with record_function("bench.sync"):
                    failed += sync(aux) > 0
                calls.append((t0, time.perf_counter()))
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, n_calls), calls, failed, state, rec, aux
