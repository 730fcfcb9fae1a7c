"""Whether the timed path's output is correct: the port's outputs against
the plain reference's replay of the same calls.

Two calls are replayed after the window has closed.  The last call of
the window is replayed step by step from the program's own state: its
first iteration from the chains' parameters and the generator's state at
the call's start, each later iteration from the parameters that the
program recorded after the one before (the call's trace), with the draws
that the generator's stream gives that iteration.  So every compared
step starts where the program's did, and a correct program in another
summation order differs by rounding in that step alone, not by the
resampling that a rounding flips in the steps after it.  The set-up's
call is replayed for its first iteration, from the benchmark's own starts
and the freshly seeded generator: the start that the first replay skips.
Per chain:

* the log-likelihood gap ``|ll - ll_ref| / max(|ll_ref|, 1)``, the worst
  over the last call's iterations: its median over the chains
  (``loglik_p50``) and its largest (``loglik_max``);
* the parameter gap of each of the last call's steps: for each leaf the
  gap between the program's and the reference's change over the step,
  ``|d - d_ref|``, against the larger of ``|d_ref|`` and that leaf's
  median ``|d_ref|`` over the chains (a chain whose step moved every leaf
  little would otherwise read one rounding of a parameter as a large
  share of its change); the last step is compared twice, as the trace
  recorded it and as the state the call hands on; the worst leaf and
  step: median (``param_p50``) and largest (``param_max``);
* the log-likelihood gap of the set-up call's first iteration, where no
  step has yet run: its largest over the chains (``start_loglik_max``).

A cell compares the numbers it lists limits for; a NaN reads as infinite.
The route check compares the port's launch counters per call with the
cell's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference import fit as ref_fit

from . import spec

NUMBERS = ("loglik_p50", "loglik_max", "param_p50", "param_max",
           "start_loglik_max")


@dataclasses.dataclass
class CallOut:
    """One checked call of the program: the chains' parameters (leaves
    ``[C, ...]``) and the generator's state at its start, its
    per-iteration log-likelihoods ``[C, iters]``, and, for the window's
    call, its recorded trace (leaves ``[C, iters, ...]``) and the
    parameters it hands on."""
    start: dict
    gen_state: torch.Tensor
    loglik: torch.Tensor
    trace: dict | None = None
    final: dict | None = None


def plan_of(config: dict, workload: dict, iters: int | None = None):
    """The reference's plan of one call: the configuration's sizes and
    smoother (``pf``, ``n_tilde``, default 2 as the port's), the model's
    normals a particle (its reference's ``NOISE_DIM``) and the cell's
    call."""
    P = int(config.get("particle_devices", 1))
    call = workload["call"]
    ref_model = spec.reference_model(config["reference"])
    return ref_fit.CallPlan(
        T=int(config["T"]), S=int(config["S"]), B=int(config["B"]),
        N=int(config["N"]) // P,
        iters=int(workload["iters_per_call"]) if iters is None else iters,
        epsilon=float(config["epsilon"]),
        resampler=call.get("resampler", "multinomial"),
        kernel_rng=(workload["route"] == "k1"
                    and call.get("rng", "host") == "kernel"),
        route=workload["route"], islands=P, pf=config["pf"],
        n_tilde=int(config.get("n_tilde", 2)),
        noise_dim=int(ref_model.NOISE_DIM))


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x.double(), nan=math.inf)


def loglik_gaps(ll, ll_ref) -> torch.Tensor:
    """[C] worst relative gap over the iterations."""
    ll, ll_ref = _finite(ll), ll_ref.double()
    gap = (ll - ll_ref).abs() / ll_ref.abs().clamp(min=1.0)
    return _finite(gap).amax(1)


def step_gaps(names, froms, made, made_ref) -> torch.Tensor:
    """[C] worst gap, over the leaves and steps, between the program's
    change over a step (``made - froms``, leaves ``[C, K, ...]``) and the
    reference's (``made_ref - froms``)."""
    C, K = froms[names[0]].shape[:2]
    d = torch.cat([_finite(made[k] - froms[k]).reshape(C, K, -1)
                   for k in names], 2)
    d_ref = torch.cat([(made_ref[k] - froms[k]).double().reshape(C, K, -1)
                       for k in names], 2)
    # a leaf's typical change: its median over the chains at that step
    scale = torch.maximum(d_ref.abs(),
                          d_ref.abs().median(0, keepdim=True).values)
    gap = (d - d_ref).abs()
    # equal changes are no gap, even where a step moved nothing
    gap = torch.where(gap == 0, gap, gap / scale)
    return _finite(gap).flatten(1).amax(1)


def steps_of(out: CallOut):
    """(where each compared step starts, what the program made of it),
    leaves ``[C, iters + 1, ...]``: the iterations as the trace recorded
    them, then the last one again as the state handed on."""
    froms, made = {}, {}
    for k, v in out.start.items():
        tr = out.trace[k]
        fr = torch.cat([v[:, None], tr[:, :-1]], 1)
        froms[k] = torch.cat([fr, fr[:, -1:]], 1)
        made[k] = torch.cat([tr, out.final[k][:, None]], 1)
    return froms, made


def _twice_last(steps: dict) -> dict:
    """The reference's steps laid out as ``steps_of``'s: the last twice."""
    return {k: torch.cat([v, v[:, -1:]], 1) for k, v in steps.items()}


def numbers(ll_gaps, p_gaps, start_gaps) -> dict:
    return {"loglik_p50": float(ll_gaps.median()),
            "loglik_max": float(ll_gaps.max()),
            "param_p50": float(p_gaps.median()),
            "param_max": float(p_gaps.max()),
            "start_loglik_max": float(start_gaps.max())}


def replay(ref_model, config, workload, observations, start, gen_state,
           iters=None, dtype=torch.float32, fault=None, path=None):
    """The reference's ``(loglik [C, iters], leaves after each iteration
    [C, iters, ...])`` of a call (step by step on ``path``, the program's
    trace, where given)."""
    prior = ref_model.prior_hyper(config)
    plan = dataclasses.replace(plan_of(config, workload, iters), fault=fault)
    return ref_fit.replay_call(ref_model, prior, plan, start, observations,
                               gen_state, dtype, path)


def reference_outputs(ref_model, config, workload, observations,
                      first: CallOut, last: CallOut, dtype=torch.float32,
                      fault=None, follow: bool = True):
    """The reference's replays of the two checked calls: (loglik of the
    set-up call's first iteration, loglik of the last call, the leaves
    after each of its iterations); ``follow=False`` replays the last call
    from its start alone, every iteration from the reference's own last."""
    r0, _ = replay(ref_model, config, workload, observations, first.start,
                   first.gen_state, iters=1, dtype=dtype, fault=fault)
    r1, steps = replay(ref_model, config, workload, observations,
                       last.start, last.gen_state, dtype=dtype, fault=fault,
                       path=last.trace if follow else None)
    return r0, r1, steps


def compare(names, first: CallOut, last: CallOut, ref) -> dict:
    """The compared numbers of the program's outputs (the set-up's call
    ``first``, the window's last call ``last``) against
    ``reference_outputs``."""
    r0, r1, steps = ref
    froms, made = steps_of(last)
    return numbers(loglik_gaps(last.loglik, r1),
                   step_gaps(names, froms, made, _twice_last(steps)),
                   loglik_gaps(first.loglik[:, :1], r0))


def in_place(names, last: CallOut, ref, other) -> dict:
    """The compared numbers of ``other``, the reference's outputs of the
    same replays in another precision or with a planted fault (each step
    from the program's recorded start), put in the program's place."""
    r0, r1, steps = other
    froms, _ = steps_of(last)
    return numbers(loglik_gaps(r1, ref[1]),
                   step_gaps(names, froms, _twice_last(steps),
                             _twice_last(ref[2])),
                   loglik_gaps(r0, ref[0]))


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every number with a
    limit (the others are not compared); a number without a value
    fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and not math.isnan(v) and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out
