"""One run of one cell of BENCHMARK.json, on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the kernels' build on a first run, the cell's inputs from
the seed, a warm-up of every shape the cell uses), then the measured
window of whole units (`core/window.py`), then with `--trace 1` a profiled
stretch of a few more units, then the comparison with the plain reference
once the program's state is freed.  The last line of standard output is the
result's JSON; the numbers compared, each beside its limit, are the last
lines of standard error.  Without as many CUDA devices as the cell asks
for, or with JAX loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.core import cells, trace, window  # noqa: E402

# modules that may not be loaded in a run, compared by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "uneven_planner_tpu")


class Run:
    """What the per-layer readers read: the cell, the window, the counters
    of each phase ("window", "traced") and the reduced trace."""

    def __init__(self, cell):
        self.cell = cell
        self.window = None
        self.counters = {}
        self.trace = None


def forbidden_modules(modules=None) -> list:
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names.intersection(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def execute(args, device, cell=None, t_start: float = T_START,
            stderr=sys.stderr):
    """Set-up, window, traced stretch and comparison of one run of `cell`
    (by default the one `args` names) on `device`: the result's dict, with
    the compared numbers under "checks" last."""
    import torch
    cell = cell or cells.resolve(args.workload)
    Driver = cells.load_module(cell.driver_path, "bench_driver").Driver
    driver = Driver(cell, args.seed, device)
    t_setup = time.perf_counter()
    parts = driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    parts = dict(interpreter_torch_s=t_setup - t_start, **parts)

    run = Run(cell)
    driver.start_counting()
    run.window = window.run_window(driver.unit, args.seconds)
    run.counters["window"] = driver.counters()
    attempted, failed = driver.attempted_failed()
    values = dict(driver.end_to_end(run.window), setup_s=setup_s)

    if args.trace:
        driver.start_counting()
        from torch.profiler import record_function
        with trace.traced() as rec:
            for _ in range(cell.traffic["traced_units"]):
                with record_function(trace.SPAN_PREFIX + "unit"):
                    driver.unit()
                rec.units += 1
        run.counters["traced"] = driver.counters()
        run.trace = trace.reduce(rec)
        chosen = cell.per_layer
    else:
        chosen = cell.end_to_end
    metrics = {}
    for m in chosen:
        if args.trace:
            reader = cells.load_module(cells.reader_path(m["name"]),
                                       "bench_metric")
            value = reader.read(run)
        else:
            value = values[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = device_info(device, cell.chips)
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = driver.readings()
    checks = [(k, readings[k], lim) for k, lim in cell.limits.items()]
    correct = all(v <= lim for _, v, lim in checks) and bool(checks)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} limit {lim!r}", file=stderr)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["setup_parts"] = parts
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    chips = cells.resolve(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    result = execute(args, torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print("loaded in this process: " + ", ".join(bad), file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
