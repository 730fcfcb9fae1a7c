"""The benchmark's data files, found by name.

``BENCHMARK.json`` (at the checkout's root) lists the cells and metrics;
``benchmark/workloads/<cell>.json`` holds a cell's traffic (chains,
iterations a call, the call's options, the route it takes, the traced
calls and the limits of its correctness check);
``benchmark/configs/<config>.json`` a configuration (the model, its true
parameters, sizes, prior and deployment); ``benchmark/metrics/<metric>.py``
one reader per metric; ``benchmark/counts/<name>.py`` the frozen counts;
``benchmark/reference/<model>.py`` a model's plain reference.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    end_to_end: list            # the BENCHMARK.json entries of this cell
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def islands(self) -> int:
        return int(self.config.get("particle_devices", 1))


def window_steps(config: dict) -> int:
    """W, the buffered window's steps: S + 2B within T."""
    return min(int(config["S"]) + 2 * int(config["B"]), int(config["T"]))


def particles_per_rank(config: dict) -> int:
    """The particles of one filter on one card (N / P on the island
    route)."""
    return int(config["N"]) // int(config.get("particle_devices", 1))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark_json: Path | None = None) -> Cell:
    bench = load_json(benchmark_json or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    config = load_json(BENCH_DIR / "configs" /
                       f"{cells[name]['config']}.json")
    return Cell(name, workload, config,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """The ``read(run)`` function of ``benchmark/metrics/<name>.py``
    (loaded by path: a metric's name may hold dots and dashes)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    module_name = "benchmark_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference_model(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def counts(name: str):
    return importlib.import_module(f"benchmark.counts.{name}")
