"""``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell; the last line of standard output is
the result's JSON object, the last lines of standard error the numbers
the correctness check compared, each beside its limit."""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys

import torch

from . import cell as cell_mod
from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "sgmcmc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``sgmcmc_tpu_torch`` is not
    ``sgmcmc_tpu``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def metrics_of(cell, run, traced: bool) -> dict:
    """The cell's metrics of this kind, by their readers; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join_group(rank: int, world: int, port: int, backend: str):
    """Join the process group of the cell's ranks; returns a gloo group
    for the harness's own messages."""
    import torch.distributed as dist

    from sgmcmc_tpu_torch.parallel import sharding
    sharding.initialize_multi_host(init_method=f"tcp://localhost:{port}",
                                   world_size=world, rank=rank,
                                   backend=backend, timeout=600)
    return dist.new_group(backend="gloo")


def _device(device_type: str, rank: int):
    return torch.device(device_type, rank) if device_type == "cuda" \
        else torch.device(device_type)


def rank_main(rank, world, port, cell, seed, seconds, traced, t0_wall,
              device_type, backend):
    """A rank other than 0: the same calls; its readings go to rank 0."""
    import torch.distributed as dist
    group = _join_group(rank, world, port, backend)
    out = cell_mod.run_rank(cell, seed, seconds, traced,
                            _device(device_type, rank), t0_wall, group)
    dist.all_gather_object([None] * world, (out.run.traces,
                                            out.run.peak_bytes,
                                            out.memory_peak_bytes),
                           group=group)
    dist.barrier(group=group)
    dist.destroy_process_group()


def run_cell(cell, seed: int, seconds: float, traced: bool, t0_wall: float,
             device_type: str = "cuda", backend: str = "nccl",
             decide: bool = True):
    """Run the cell on rank 0 of ``cell.islands`` ranks (the others in
    processes of their own, stopped before it returns); returns
    ``(outcome, metrics, correct, checks, peak bytes over the ranks)``;
    without ``decide`` the correctness check is left to the caller
    (``correct`` and ``checks`` are None)."""
    world = cell.islands
    procs, group = [], None
    if world > 1:
        import torch.multiprocessing as mp
        port = _free_port()
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, port, cell, seed, seconds,
                                   traced, t0_wall, device_type, backend))
                 for r in range(1, world)]
        for p in procs:
            p.start()
    try:
        if world > 1:
            import torch.distributed as dist
            group = _join_group(0, world, port, backend)
        out = cell_mod.run_rank(cell, seed, seconds, traced,
                                _device(device_type, 0), t0_wall, group)
        mem_peak = out.memory_peak_bytes
        if world > 1:
            got = [None] * world
            dist.all_gather_object(got, (out.run.traces, out.run.peak_bytes,
                                         out.memory_peak_bytes), group=group)
            out.run.traces = [t for traces, _, _ in got for t in traces]
            out.run.peak_bytes = max(p for _, p, _ in got)
            mem_peak = max(m for _, _, m in got)
        metrics = metrics_of(cell, out.run, traced)
        correct = checks = None
        if decide:
            correct, checks = cell_mod.correctness(cell, out)
            checks["failed_calls"] = {"value": out.failed, "limit": 0}
            correct = correct and out.failed == 0
        if world > 1:
            dist.barrier(group=group)
            dist.destroy_process_group()
    finally:
        for p in procs:
            p.join(timeout=300)
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"a rank failed: exit codes "
                           f"{[p.exitcode for p in procs]}")
    return out, metrics, correct, checks, mem_peak


def main(argv, t0_wall: float) -> int:
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    traced = bool(args.trace)
    out, metrics, correct, checks, mem_peak = run_cell(
        cell, args.seed, args.seconds, traced, t0_wall)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips,
                         "memory_peak_bytes": int(mem_peak)}}
    if traced:
        traces = out.run.traces
        result["device"]["busy_s"] = sum(t.busy_us for t in traces) \
            / len(traces) / 1e6
        result["device"]["window_s"] = sum(t.window_us for t in traces) \
            / len(traces) / 1e6
        result["breakdown"] = {"device_ops": traces[0].top_ops(),
                               "idle_gaps": traces[0].top_gaps()}
    result["card"] = card_line()
    result["checks"] = checks
    print("set-up, seconds from the start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.run.phases.items()), file=sys.stderr)
    print(f"calls in the window: {out.attempted}; card: {result['card']}",
          file=sys.stderr)
    for name, value in out.readings.items():
        if name not in checks:
            print(f"reading (not compared) {name}: {value!r}",
                  file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
