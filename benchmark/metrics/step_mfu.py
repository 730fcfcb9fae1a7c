"""The whole SGLD step's share of the card's float32 peak: the
algorithm's operations for the chain-steps of the traced calls, counted
from shapes by the configuration's smoother (``counts/step.py`` for
Poyiadjis O(N): frame, model body and one normal a noise dimension per
particle and window step; ``counts/paris.py`` for PaRIS, with its
backward step), over the traced window's seconds times 67 TFLOP/s; per
rank (each rank's own particles), averaged over the ranks, in %.  Nothing
to read for a smoother without a count."""
from benchmark.counts import paris, peaks, step
from benchmark.harness import spec


def read(run):
    if not run.traces:
        return None
    cfg = run.cell.config
    ref = spec.reference_model(cfg["reference"])
    body = spec.counts(cfg["k1_body"] + "_body")
    N, W = spec.particles_per_rank(cfg), spec.window_steps(cfg)
    Z = ref.NOISE_DIM
    if cfg["pf"] == "poyiadjis_N":
        def count(chain_steps):
            return step.ops(chain_steps, W, N, body.BODY_OPS, Z)
    elif cfg["pf"] == "paris":
        def count(chain_steps):
            return paris.ops(chain_steps, W, N, body, Z,
                             int(cfg.get("n_tilde", 2)), ref.STAT_DIM)
    else:
        return None
    shares = []
    for t in run.traces:
        ops = count(t.calls * run.chain_steps_per_call)
        shares.append(ops / (t.window_us / 1e6 * peaks.F32_OPS_S))
    return 100.0 * sum(shares) / len(shares)
