"""One run of one cell: set-up, the window, the readings, the check.

Set-up makes the inputs from the seed, builds the port's sampler and makes
one call of the cell's own shape (the warm-up, which also builds and
loads the kernel library in a fresh checkout).  The window is a closed
loop: one client calls back to back while the window is open, and it
closes when the last call started in it ends; every call records the
chains' parameters after each iteration (``fit_scan``'s default trace,
which the check follows) and ends in a synchronising read of its
log-likelihoods.  A traced run profiles the cell's ``trace_calls`` calls
instead.  After the window the port's state is freed and the reference
replays the checked calls.

With ``particle_devices`` P > 1 the cell runs one process per card (rank
0 is the process that prints); every rank runs the same calls, and rank 0
decides when the window closes and tells the others over a gloo group.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import torch

from . import check, data, spec, trace
from .system import System, leaves_of


@dataclass
class Run:
    """What the metric readers read."""
    cell: spec.Cell
    setup_s: float
    calls: list = field(default_factory=list)     # (start, end) host clock
    window_start: float = 0.0
    peak_bytes: int = 0                            # window peak, all ranks
    traces: list = field(default_factory=list)     # one Trace per rank
    phases: dict = field(default_factory=dict)     # set-up, s from start

    @property
    def chain_steps_per_call(self) -> int:
        w = self.cell.workload
        return int(w["num_chains"]) * int(w["iters_per_call"])


def _sync(aux) -> int:
    """The synchronising read of a call's output: its non-finite count."""
    return int((~torch.isfinite(aux)).sum())


@dataclass
class Outcome:
    run: Run
    attempted: int
    failed: int
    launches: dict             # per call
    memory_peak_bytes: int
    check_inputs: tuple        # (observations, first, last: check.CallOut)
    readings: dict = field(default_factory=dict)   # every compared number


def run_rank(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t0_wall: float, group=None) -> Outcome:
    """Set-up and window on this process's card."""
    cfg, wl = cell.config, cell.workload
    ref_model = spec.reference_model(cfg["reference"])
    names = ref_model.LEAVES
    phases = {"imports": time.time() - t0_wall}
    obs = data.series(ref_model, cfg, seed, device)
    leaves = data.starts(ref_model, cfg, seed, int(wl["num_chains"]), device)
    phases["inputs"] = time.time() - t0_wall
    system = System(cfg, wl, obs, data.sub_seeds(seed)["sampler"], device,
                    leaves)
    phases["sampler"] = time.time() - t0_wall
    _, g_first = system.state()
    _, aux = system.call(first=True)
    _sync(aux)
    first = check.CallOut(leaves, g_first, aux)
    phases["warm-up call"] = time.time() - t0_wall
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(cell, phases["warm-up call"], phases=phases)
    before = system.launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if traced:
        tr, run.calls, failed, state, rec, aux = trace.traced_window(
            system, int(wl["trace_calls"]), _sync)
        run.traces.append(tr)
        run.window_start = run.calls[0][0]
    else:
        failed = 0
        run.window_start = time.perf_counter()
        while True:
            state = system.state()
            t_a = time.perf_counter()
            rec, aux = system.call()
            failed += _sync(aux) > 0
            t_b = time.perf_counter()
            run.calls.append((t_a, t_b))
            stop = t_b - run.window_start >= seconds
            if group is not None:         # rank 0 decides for every rank
                flag = torch.tensor([int(stop)])
                torch.distributed.broadcast(flag, 0, group=group)
                stop = bool(flag.item())
            if stop:
                break
    run.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    after = system.launches()
    launches = {k: (after[k] - before[k]) / len(run.calls) for k in after}
    last = check.CallOut(leaves_of(state[0], names), state[1], aux,
                         leaves_of(rec, names),
                         leaves_of(system.sampler.parameters, names))
    del system, state, rec, aux
    gc.collect()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    return Outcome(run, len(run.calls), failed, launches,
                   max(setup_peak, run.peak_bytes), (obs, first, last))


def route_numbers(workload: dict, launches: dict) -> tuple[dict, dict]:
    """(values, limits) of the route check: |launches a call - expected|,
    limit 0."""
    values, limits = {}, {}
    for name, want in workload["launches_per_call"].items():
        short = "launches_" + name.rsplit(".", 2)[-2]
        values[short] = abs(launches[name] - float(want))
        limits[short] = 0.0
    return values, limits


def correctness(cell: spec.Cell, outcome: Outcome) -> tuple[bool, dict]:
    """(correct, the compared numbers beside their limits)."""
    ref_model = spec.reference_model(cell.config["reference"])
    obs, first, last = outcome.check_inputs
    ref = check.reference_outputs(ref_model, cell.config, cell.workload, obs,
                                  first, last)
    values = check.compare(ref_model.LEAVES, first, last, ref)
    outcome.readings = dict(values)
    rv, rl = route_numbers(cell.workload, outcome.launches)
    values.update(rv)
    limits = dict(cell.workload["limits"], **rl)
    return check.verdict(values, limits)
