"""Finds a cell's pieces by the names in BENCHMARK.json."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports, in order
    per_layer: list
    limits: dict


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic_path(mix: str) -> str:
    return os.path.join(PKG, "traffic", f"{mix}.json")


def limits_path(cell: str) -> str:
    return os.path.join(PKG, "limits", f"{cell}.json")


def metric_path(metric: str) -> str:
    return os.path.join(PKG, "metrics", f"{metric}.py")


def applies(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether a cell reports a metric: the metric's ``workloads`` where it
    lists them; otherwise every cell for an end-to-end metric, and every
    cell that reports the metric it ``moves`` for a per-layer one."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def cell(bench: dict, name: str) -> Cell:
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, name, names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(ROOT, cfg["file"])),
        traffic=_json(traffic_path(w["traffic"])),
        end_to_end=e2e, per_layer=per_layer, limits=_json(limits_path(name)),
    )


def reader(metric: str):
    """The ``read(ctx)`` function of portbench/metrics/<metric>.py."""
    path = metric_path(metric)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
