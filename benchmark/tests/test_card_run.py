"""A whole run of each cell on the card, traced, at a short window: the
result line as the check reads it.  Skipped where there is no card."""

import json
import subprocess
import sys

import pytest

from benchmark.core import cells

SPEC = cells.benchmark_json()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_traced_run_on_the_card(workload, cuda_device):
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2600000001", "--seconds", "3", "--trace", "1"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    cell = cells.resolve(workload)
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
