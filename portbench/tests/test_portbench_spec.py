"""BENCHMARK.json and the files it names: every piece found by name, every
name, unit and entry within the contract's limits."""

import json
import os
import re

import pytest

from portbench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32
    assert all(LINE.match(w) for w in BENCH["command"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert spec.NAME.match(entry["name"])
    assert LINE.match(entry["source"]) and LINE.match(entry["why"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert {"source", "assumed", "deployment", "guarantees", "data", "index"} <= set(cfg)
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_pieces_found_by_name(name):
    cell = spec.cell(BENCH, name)
    w = {x["name"]: x for x in BENCH["workloads"]}[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert spec.NAME.match(name) and spec.NAME.match(w["traffic"])
    assert w["chips"] == 1 and LINE.match(w["why"])
    assert os.path.exists(spec.traffic_path(w["traffic"]))
    for number in ("miss", "dist_err"):  # between the two readings
        r = cell.limits["readings"][number]
        assert r["program_max"] < cell.limits[number] < r["upper_min"]
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))


def test_pairs_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entry(m):
    assert spec.NAME.match(m["name"]) and spec.UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert os.path.exists(spec.metric_path(m["name"]))
    if "bound" in m:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert LINE.match(m["layer"])
        # the metric it moves is reported in every cell that lists it
        moved = {x["name"]: x for x in BENCH["end_to_end"]}[m["moves"]]
        for c in m.get("workloads", CELLS):
            assert spec.applies(moved, c, set())
    if m["name"].endswith("_roofline") or m["name"].endswith(".roofline"):
        assert m["unit"] == "%"


def test_setup_bound():
    setup = {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"]
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())
