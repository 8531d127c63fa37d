"""One run of a cell exactly as `benchmark/run.py` makes it, with each
unit's wall time of the window written out: for reading where a run's tail
comes from (the spread of the unit times, the units far from the rest).

    python3 benchmark/studies/unit_times.py --out chiprun_out/units.jsonl \
        --workload hill.fleet4096 --seed 11 --seconds 51 --trace 0

Prints what `run.py` prints, and appends to `--out` one JSON line: the
cell, the seed, the window's length and every unit's seconds in order.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.core import window  # noqa: E402


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--out")
    out = argv[i + 1]
    del argv[i:i + 2]
    args = run.parse(argv)
    seen = []
    inner = window.run_window

    def recorded(*a, **k):
        win = inner(*a, **k)
        seen.append(win)
        return win

    window.run_window = recorded
    rc = run.main(argv)
    if seen:
        with open(out, "a") as f:
            f.write(json.dumps({"workload": args.workload, "seed": args.seed,
                                "rc": rc, "window_s": seen[0].elapsed_s,
                                "unit_s": seen[0].unit_s}) + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
