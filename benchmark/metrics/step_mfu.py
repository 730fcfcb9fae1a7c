"""The whole SGLD step's share of the card's float32 peak: the
algorithm's operations for the chain-steps of the traced calls
(``counts/step.py``: frame, model body and one normal per particle and
window step, from shapes), over the traced window's seconds times 67
TFLOP/s; per rank (each rank's own particles), averaged over the ranks,
in %."""
from benchmark.counts import peaks, step
from benchmark.harness import spec


def read(run):
    if not run.traces:
        return None
    cfg = run.cell.config
    body = spec.counts(cfg["k1_body"] + "_body").BODY_OPS
    N, W = spec.particles_per_rank(cfg), spec.window_steps(cfg)
    shares = []
    for t in run.traces:
        ops = step.ops(t.calls * run.chain_steps_per_call, W, N, body)
        shares.append(ops / (t.window_us / 1e6 * peaks.F32_OPS_S))
    return 100.0 * sum(shares) / len(shares)
