"""Every cell of BENCHMARK.json resolves from its files, and the file keeps
to the contract's shape."""

import json
import os
import re

import pytest

from benchmark.core import cells

SPEC = cells.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_from_its_files(workload):
    cell = cells.resolve(workload)
    assert os.path.exists(cell.driver_path)
    assert cell.limits, "a cell compares at least one number"
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    for m in cell.per_layer:
        reader = cells.load_module(cells.reader_path(m["name"]), "reader")
        assert callable(reader.read)
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_configs_files_and_names():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(cells.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_names_units_and_bounds():
    names = [w["name"] for w in SPEC["workloads"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for n in names + [m["name"] for m in metrics] \
            + [c["name"] for c in SPEC["configs"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(cells.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


def test_every_metric_is_read_somewhere():
    for m in SPEC["per_layer"]:
        assert any(m in cells.resolve(w["name"]).per_layer
                   for w in SPEC["workloads"]), m["name"]
