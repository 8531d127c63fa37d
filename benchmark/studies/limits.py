"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the window as a run makes it, then the numbers the
run compares for the program (the lower readings) and for the control,
the plain reference in TF32 put in the program's place on the same inputs
(the upper readings).  One process for every seed, so the set-up's build
is paid once.

    python3 benchmark/studies/limits.py --workload hill.fleet4096 \
        --seeds 11,12,13 --seconds 30 [--out chiprun_out/limits.jsonl]

Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.core import cells, window  # noqa: E402
from benchmark.reference.arith import Arith  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    cell = cells.resolve(a.workload)
    Driver = cells.load_module(cell.driver_path, "bench_driver").Driver
    dev = torch.device("cuda", 0)
    out = open(a.out, "a") if a.out else None
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        d = Driver(cell, seed, dev)
        d.setup()
        d.start_counting()
        win = window.run_window(d.unit, a.seconds)
        d.release()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        q = sorted(win.unit_s)
        line = {"workload": a.workload, "seed": seed, "units": win.units,
                "window_s": win.elapsed_s, "end_to_end": d.end_to_end(win),
                "unit_ms": {p: 1e3 * q[min(len(q) - 1, int(p * len(q)))]
                            for p in (0.0, 0.5, 0.9, 0.95, 1.0)},
                "unit_s": win.unit_s,
                "counters": {k: v for k, v in d.counters().items()
                             if not isinstance(v, dict)},
                "program": d.readings(),
                "control_tf32": d.readings(Arith(tf32=True)),
                "limits": cell.limits, "study_s": time.perf_counter() - t0,
                "reference_s": time.perf_counter() - t1,
                "card": torch.cuda.get_device_name(dev)}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
