"""Resolving a cell of BENCHMARK.json to its files: the configuration, the
traffic mix, the driver the traffic names, the limits of its comparison
and the readers of its per-layer metrics.  Adding a cell or a metric adds
files; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    driver_path: str
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def resolve(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json; raises if it or one of its files
    is missing."""
    spec = benchmark_json()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(BENCH, "traffic",
                                      w["traffic"] + ".json"))
    limits = _load_json(os.path.join(BENCH, "limits", name + ".json"))
    driver = os.path.join(BENCH, "drivers", traffic["driver"] + ".py")
    if not os.path.exists(driver):
        raise FileNotFoundError(driver)
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    for m in per_layer:
        reader_path(m["name"])
    return Cell(name, w["chips"], config, traffic, limits, driver, e2e,
                per_layer)


def reader_path(metric: str) -> str:
    path = os.path.join(BENCH, "metrics", metric + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def load_module(path: str, name: str):
    """Import the file at `path` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
