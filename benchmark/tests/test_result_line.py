"""A run's result: the last line's keys, the metrics of the cell, the
compared numbers beside their limits last, and no result without a card."""

import io
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import run
from benchmark.core import cells
from benchmark.tests.helpers import small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device", "setup_parts",
        "checks"]


def test_cpu_run_gives_the_result_keys(one_thread):
    cell = small_cell("hill.fleet4096")
    args = run.parse(["--workload", cell.name, "--seed", "2200000001",
                      "--seconds", "0.5", "--trace", "0"])
    err = io.StringIO()
    res = run.execute(args, torch.device("cpu"), cell=cell,
                      t_start=time.perf_counter(), stderr=err)
    assert list(res) == KEYS, "the compared numbers come last"
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"] is True
    assert set(res["checks"]) == set(cell.limits)
    lines = err.getvalue().strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == \
        [f"check {k}" for k in res["checks"]]
    json.dumps(res)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hill.fleet4096",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_no_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails before any result."""
    import shutil
    shutil.copy(f"{cells.ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(cells.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "hill.fleet4096",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
