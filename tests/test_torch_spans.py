"""The port's spans (``utils/profiling.py``'s ``span``) on the CPU.

With no profiler running a span is one shared no-op context; under
``torch.profiler`` a small unfused SVM fit shows its spans nested by the
call that caused them (one ``sgmcmc.fit_scan``, an ``sgmcmc.iter`` per
iteration, the score's draw and filter, W ``sgmcmc.smoother.step`` spans
per filter), and the profiler moves no bit of the fit's outputs.
"""
import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile

from sgmcmc_tpu_torch.inference import samplers
from sgmcmc_tpu_torch.models import svm
from sgmcmc_tpu_torch.utils import profiling

torch.set_num_threads(1)

ITERS, S, B = 2, 8, 2
W = S + 2 * B           # the buffered window's steps (T = 64 holds it)


def test_span_off_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    a = profiling.span("sgmcmc.iter")
    b = profiling.span("any other name")
    assert a is b
    with a, b:          # nests in itself
        pass


def _fit():
    g = torch.Generator().manual_seed(0)
    ys, _ = svm.generate_data(g, svm.from_scalars(0.9, 0.5, 1.0), 64)
    s = samplers.SVMSampler(observations=ys, device="cpu", seed=3)
    return s.fit_scan("SGLD", num_iters=ITERS, num_chains=4, N=16,
                      subsequence_length=S, buffer_length=B,
                      resampler="multinomial", return_aux=True)


def _within(spans, child, parent):
    """The ``child`` spans that lie inside some ``parent`` span."""
    outer = [(s, e) for n, s, e in spans if n == parent]
    return [c for c in spans if c[0] == child
            and any(s <= c[1] and c[2] <= e for s, e in outer)]


def test_fit_spans_nest_by_their_caller_and_change_no_output():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _fit()
    plain = _fit()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("sgmcmc.")]
    names = [n for n, _, _ in spans]
    assert names.count("sgmcmc.fit_scan") == 1
    for child, parent, count in (
            ("sgmcmc.iter", "sgmcmc.fit_scan", ITERS),
            ("sgmcmc.score", "sgmcmc.iter", ITERS),
            ("sgmcmc.score.draw", "sgmcmc.score", ITERS),
            ("sgmcmc.score.filter", "sgmcmc.score", ITERS),
            ("sgmcmc.smoother.step", "sgmcmc.score.filter", ITERS * W)):
        assert names.count(child) == count, child
        assert len(_within(spans, child, parent)) == count, child
    assert "sgmcmc.collective" not in names
    (trace_a, aux_a), (trace_b, aux_b) = traced, plain
    assert torch.equal(aux_a, aux_b)
    for f in dataclasses.fields(trace_a):
        assert torch.equal(getattr(trace_a, f.name),
                           getattr(trace_b, f.name)), f.name
