"""Readings that set a cell's correctness limits, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 3] [--window-seeds 0 --seconds 30] \
        [--dump DIR | --load DIR] [--out readings.jsonl]

For each seed, in one process: the cell's set-up and one call of its
window (a window of ``--seconds`` on the first ``--window-seeds`` seeds,
whose end-to-end metrics are printed too), then the compared numbers of

* ``program``: the port's outputs, as a run reads them;
* ``control``: the reference computed in bfloat16 (the nearest precision
  below the configuration's float32) in the port's place;
* ``half``: the reference on half of each filter's particles (the mean
  taken over the rest) in the port's place;
* ``reorder``: the reference in another summation order (the other
  route's order of the filter's sums; on the island route the islands
  averaged from the last rank; under PaRIS the log-likelihood and the
  final weighted mean in the fused window's order, the mean in float64),
  a sound variant, in the port's place;
* ``one_backward``, ``uniform_backward`` (PaRIS cells): the reference
  with one backward draw a particle in place of ``n_tilde``, or with its
  backward indices drawn uniformly, ignoring the backward weights;
* ``own_island`` (island cells): the reference keeping rank 0's island
  only, the exchange between the cards left out;
* ``float64`` (one-card cells): the reference in float64, a sound
  variant that rounds the weights otherwise, so that the resampling
  takes other ancestors within a step: what a program that rounds its
  weights differently reads;
* ``altered``: the port's outputs with one chain's answers altered where
  they are produced (its log-likelihoods by 1e-3 relative, its first
  leaf by 1e-4 in the state the call hands on).

A variant in the port's place computes each step from the port's
recorded start, as the check's reference does.  Two readings are not
compared by the check: ``program_free``, the port's last call against
the reference run free from the call's start (every iteration from the
reference's own last, as a check without the trace would), and
``reorder_free``, the ``reorder`` variant run free against the reference
run free: what a summation order alone does to a comparison that does
not follow the program.  A step that returns its state unchanged, for
every chain or for some, reads 1 on ``param_max`` by the measure's
definition and needs no run.

The controls and faults run on the first ``--control-seeds`` seeds.
``--dump DIR`` keeps each seed's port outputs (the check's inputs) in
``DIR`` and reads nothing; ``--load DIR`` reads from those files on this
card without running the port (so a four-card cell's readings can be
taken on one card).  One JSON line per seed goes to standard output and
to ``--out``.
"""
import time

T0_WALL = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _moved(out, device):
    """A ``check.CallOut`` with its tensors on ``device`` (the generator
    state stays on the host)."""
    import torch

    def mv(v):
        if isinstance(v, dict):
            return {k: mv(x) for k, x in v.items()}
        return v.to(device) if isinstance(v, torch.Tensor) else v
    return dataclasses.replace(
        out, start=mv(out.start), loglik=mv(out.loglik),
        trace=mv(out.trace), final=mv(out.final))


def run_program(cell, seed, seconds, device) -> dict:
    """The port's run of one seed: the check's inputs, the launches a
    call and, after a window, the end-to-end metrics."""
    from benchmark.harness import cell as cell_mod, main
    if cell.islands > 1:
        out, metrics = main.run_cell(
            cell, seed, seconds, False, time.time(), device.type,
            "nccl" if device.type == "cuda" else "gloo", decide=False)[:2]
    else:
        out = cell_mod.run_rank(cell, seed, seconds, False, device,
                                time.time())
        metrics = main.metrics_of(cell, out.run, False)
    obs, first, last = out.check_inputs
    rec = {"inputs": (obs, first, last), "launches": out.launches}
    if seconds > 0:
        rec["metrics"] = {k: v["value"] for k, v in metrics.items()}
        rec["calls"] = out.attempted
    return rec


def readings(cell, inputs, device, control: bool) -> dict:
    import torch

    from benchmark.harness import check, spec
    ref_model = spec.reference_model(cell.config["reference"])
    names = ref_model.LEAVES
    obs, first, last = inputs
    args = (ref_model, cell.config, cell.workload, obs, first, last)
    t = time.perf_counter()
    ref = check.reference_outputs(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    rec = {"reference_s": time.perf_counter() - t,
           "program": check.compare(names, first, last, ref)}
    if not control:
        return rec
    free = check.reference_outputs(*args, follow=False)
    rec["program_free"] = _free(names, last, free)
    variants = {"control": dict(dtype=torch.bfloat16),
                "half": dict(fault="half"), "reorder": dict(fault="reorder")}
    if cell.islands > 1:
        variants["own_island"] = dict(fault="own_island")
    else:
        variants["float64"] = dict(dtype=torch.float64)
    if cell.config["pf"] == "paris":
        for fault in ("one_backward", "uniform_backward"):
            variants[fault] = dict(fault=fault)
    for name, kw in variants.items():
        rec[name] = check.in_place(names, last, ref,
                                   check.reference_outputs(*args, **kw))
    reorder_free = check.reference_outputs(*args, fault="reorder",
                                           follow=False)
    rec["reorder_free"] = _free(names, dataclasses.replace(
        last, loglik=reorder_free[1],
        final={k: v[:, -1] for k, v in reorder_free[2].items()}), free)
    ll0, ll1 = first.loglik.clone(), last.loglik.clone()
    ll0[0] *= 1.0 + 1e-3
    ll1[0] *= 1.0 + 1e-3
    final = {k: v.clone() for k, v in last.final.items()}
    final[names[0]].view(-1)[0] += 1e-4
    rec["altered"] = check.compare(
        names, dataclasses.replace(first, loglik=ll0),
        dataclasses.replace(last, loglik=ll1, final=final), ref)
    return rec


def _free(names, last, free) -> dict:
    """The last call against a replay run free from its start: the
    log-likelihood gaps over its iterations and the gap of the change over
    the whole call (median and largest over the chains, and the chains
    whose change differs at all)."""
    from benchmark.harness import check
    ll = check.loglik_gaps(last.loglik, free[1])
    p = check.step_gaps(names, {k: v[:, None] for k, v in last.start.items()},
                        {k: v[:, None] for k, v in last.final.items()},
                        {k: v[:, -1:] for k, v in free[2].items()})
    return {"loglik_p50": float(ll.median()), "loglik_max": float(ll.max()),
            "param_p50": float(p.median()), "param_max": float(p.max()),
            "chains_off": int((p > 0).sum())}


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import spec
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--window-seeds", type=int, default=0)
    p.add_argument("--seconds", type=float, default=30.0)
    g = p.add_mutually_exclusive_group()
    g.add_argument("--dump", default=None)
    g.add_argument("--load", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if args.load is None and torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        path = os.path.join(args.load or args.dump or ".",
                            f"{cell.name}.{seed}.pt")
        if args.load:
            prog = torch.load(path, weights_only=False)
            obs, first, last = prog["inputs"]
            prog["inputs"] = (obs.to(device), _moved(first, device),
                              _moved(last, device))
        else:
            seconds = args.seconds if i < args.window_seeds else 0.0
            prog = run_program(cell, seed, seconds, device)
        rec = {"cell": cell.name, "seed": seed}
        rec.update({k: v for k, v in prog.items() if k != "inputs"})
        if args.dump:
            obs, first, last = prog["inputs"]
            os.makedirs(args.dump, exist_ok=True)
            torch.save(dict(prog, inputs=(obs.cpu(), _moved(first, "cpu"),
                                          _moved(last, "cpu"))), path)
        else:
            rec.update(readings(cell, prog["inputs"], device,
                                i < args.control_seeds))
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
