#!/usr/bin/env python3
"""Launches, device time and wall time of one full-width search of the
planning path (`frontend/kino_init.py:plan`: hill map, default front-end
sizing, 256 scenarios drawn as `chip_smoke.scen_batch`), on one GPU, with
the port as it is in a given checkout.

    python3 chip_studies/search_launches.py [--root DIR]

`--root` names the checkout whose `uneven_planner_tpu_torch` runs (default:
this one); to compare two versions, run it for each in one call, in turns
(old, new, new, old).  After two warm-up searches it times three searches
on the host clock (each ended by a synchronize) and profiles a fourth:
device operations (kernels, copies and fills) per round run, the device's
busy share, the K4 launches by the package's own counters, and the top
kernels by device time.  Prints one JSON line with the card.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=ROOT)
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    import uneven_planner_tpu_torch as pkg
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.frontend import kino_init
    from uneven_planner_tpu_torch.kernels import gather
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    cfg, grid = headline.scene_setup(device="cuda")
    starts, goals = cs.scen_batch(cs.PLAN_BATCH, np.random.default_rng(1))
    to = lambda a: torch.as_tensor(a, device="cuda")
    search = lambda: kino_init.plan(grid, cfg.frontend, to(starts),
                                    to(goals))
    for _ in range(2):
        search()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = search()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    gather.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = search()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    try:        # older checkouts keep the summary in chip_smoke.py
        from uneven_planner_tpu_torch.utils.profiling import \
            device_time_by_kernel
    except ImportError:
        device_time_by_kernel = cs.device_time_by_kernel
    total, rows = device_time_by_kernel(prof)
    rounds = int(res.rounds.max())
    poll = kino_init.POLL_EVERY
    rounds_run = min(cfg.frontend.max_rounds, -(-rounds // poll) * poll)
    ops = sum(c for _, _, c in rows)
    print(json.dumps(dict(
        card=cs.nvidia_smi_line(),
        package=os.path.relpath(os.path.dirname(pkg.__file__), ROOT),
        rounds=rounds, rounds_run=rounds_run,
        success_share=float(res.success.float().mean()),
        wall_s=sorted(walls), wall_s_profiled=wall,
        device_ms=total / 1e3, device_busy_share=total / 1e6 / wall,
        device_ops=ops, device_ops_per_round=ops / max(rounds_run, 1),
        gather_launches=dict(gather.launches),
        top=[dict(kernel=k[:70], device_ms=u / 1e3, calls=c)
             for u, k, c in rows[:6]])), flush=True)


if __name__ == "__main__":
    main()
