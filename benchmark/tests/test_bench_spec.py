"""BENCHMARK.json against the contract's rules, and the files the harness
finds by name."""
import json
import os
import re

import pytest

from benchmark.harness import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves",
               "workloads"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(spec.ROOT / "BENCHMARK.json") <= 64 * 1024


def test_names_units_and_keys():
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names["configs"].add(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in names["configs"]
        names["workloads"].add(w["name"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m) <= METRIC_KEYS
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names["metrics"]
        names["metrics"].add(m["name"])
        assert set(m.get("workloads", [])) <= names["workloads"]
    assert {c["config"] for c in BENCH["workloads"]} == names["configs"]


def test_end_to_end_and_per_layer_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert {"layer", "moves"} <= set(m) and "bound" not in m
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_check_fits_the_time_limit():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_files_found_by_name(cell):
    c = spec.load_cell(cell)
    assert c.workload["name"] == cell
    assert c.workload["chips"] == next(w["chips"] for w in BENCH["workloads"]
                                       if w["name"] == cell)
    from benchmark.harness import check
    assert {"loglik_p50", "param_p50", "start_loglik_max"} <= set(
        c.workload["limits"]) <= set(check.NUMBERS)
    spec.reference_model(c.config["reference"])
    spec.counts(c.config["k1_body"] + "_body")
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_config_files_hold_what_the_entry_says():
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        json.dumps(cfg)
