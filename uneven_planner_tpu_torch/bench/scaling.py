"""Scaling of the batched flat solve over devices and processes (port of
`uneven_planner_tpu/bench/scaling.py`).

`run_mesh` solves one batch over meshes of 1, 2, 4, ... devices
(`parallel/mesh.py`) and `run_multiprocess` over 1..N processes on this
machine (`parallel/distributed.py:launch_local`: gloo between CPU
processes, or NCCL with one card a process), and both report solves/s and
the scaling efficiency rate(n) / (n rate(1)).  Rates of CPU shards are only
comparable with each other; a machine with one card runs one NCCL rank and
measures no scaling across cards.

    python -m uneven_planner_tpu_torch.bench.scaling [--devices 8 --batch 64]
    python -m uneven_planner_tpu_torch.bench.scaling --multiprocess 2
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from uneven_planner_tpu_torch import headline
from uneven_planner_tpu_torch.config import scene_config
from uneven_planner_tpu_torch.parallel import distributed as dist
from uneven_planner_tpu_torch.parallel import mesh as pmesh
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

_MP_BENCH_WORKER = """
import numpy as np
from uneven_planner_tpu_torch import headline
from uneven_planner_tpu_torch.bench import scaling
from uneven_planner_tpu_torch.config import MapConfig, scene_config
from uneven_planner_tpu_torch.parallel import distributed as dist
from uneven_planner_tpu_torch.solver import alm
from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid

cfg = scene_config("hill")
mesh = dist.hierarchical_mesh()
grid = make_synthetic_grid(MapConfig(xy_resolution={res!r},
                                     yaw_resolution={yres!r}),
                           dtype=np.float32, device=mesh.local[0])
shape = alm.ProblemShape(*{shape!r})
x0s, bounds, _ = headline.make_batch({b_local}, cfg, shape,
                                     np.random.default_rng(1000 + pid),
                                     sort=False, device=mesh.local[0])
scen = dist.shard_scenarios(mesh, x0s, bounds)
run = dist.plan_batch_global(mesh, shape, grid, cfg.alm,
                             lbfgs_overrides={overrides!r})
rate, n_conv = scaling.timed(run, scen)
if pid == 0:
    B = {b_local} * nprocs
    print(f"MPBENCH procs={{nprocs}} batch={{B}} solves/s={{B * rate:.3f}} "
          f"converged={{n_conv}} backend={{torch.distributed.get_backend()}}",
          flush=True)
"""


def timed(run, *args):
    """(calls a second, converged count) of the second of two calls of
    `run(*args) -> (result, (n_converged, n_inner))`, ending in a host
    read of the count."""
    run(*args)
    t0 = time.perf_counter()
    _, (n_conv, _) = run(*args)
    n_conv = int(n_conv)
    return 1.0 / (time.perf_counter() - t0), n_conv


def run_multiprocess(nprocs: int, local_devices: int, b_local: int,
                     out_path: str | None = None, device: str | None = None,
                     shape=(10, 20, 16), map_res=(0.05, 0.1),
                     overrides=None, timeout: float = 1800.0) -> list:
    """For n = 1..nprocs, n processes (`launch_local`), each solving
    `b_local` scenarios of its own over its devices (`device` None or
    "cuda": a card each, raising without CUDA; "cpu": `local_devices` CPU
    shards each) with the counts summed across processes; returns and
    prints each n's solves/s and efficiency, and with `out_path` writes
    the sweep as JSON."""
    body = _MP_BENCH_WORKER.format(
        res=map_res[0], yres=map_res[1], shape=tuple(shape),
        b_local=b_local,
        overrides=overrides or {"mem_size": 8, "max_iterations": 150})
    rates, fields = {}, {}
    for n in range(1, nprocs + 1):
        out = dist.launch_local(body, num_processes=n,
                                local_devices=local_devices,
                                timeout=timeout, device=device)
        for rc, stdout in out:
            if rc != 0:
                raise RuntimeError(f"worker failed (procs={n}): "
                                   f"{stdout[-1500:]}")
        for line in out[0][1].splitlines():
            if line.startswith("MPBENCH"):
                print(line, flush=True)
                fields[n] = dict(f.split("=", 1) for f in line.split()[1:])
                rates[n] = float(fields[n]["solves/s"])
    points = []
    for n, r in sorted(rates.items()):
        eff = r / (rates[1] * n)
        print(f"procs={n} efficiency={eff * 100:.1f}%", flush=True)
        points.append({"procs": n, "local_devices": local_devices,
                       "batch": b_local * n, "solves_per_sec": r,
                       "efficiency": eff,
                       "converged": int(fields[n]["converged"]),
                       "backend": fields[n]["backend"]})
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"kind": "multiprocess_scaling_sweep",
                       "points": points}, f, indent=1)
    return points


def run_mesh(devices, batch: int = 64, shape=(10, 20, 16), map_cfg=None,
             overrides=None, seed: int = 0) -> list:
    """Meshes of 1, 2, 4, ... of `devices`: solves/s of one batch of
    `batch` hill scenarios and the efficiency against one device."""
    cfg = scene_config("hill")
    shape = alm.ProblemShape(*shape)
    xs, bs, _ = headline.make_batch(batch, cfg, shape,
                                    np.random.default_rng(seed), sort=False,
                                    device=devices[0])
    grid = make_synthetic_grid(map_cfg or cfg.map, dtype=np.float32,
                               device=devices[0])
    points, n = [], 1
    while n <= len(devices):
        run = pmesh.plan_batch_shard_map(
            devices[:n], shape, grid, cfg.alm,
            lbfgs_overrides=overrides or {"mem_size": 8,
                                          "max_iterations": 250})
        rate, n_conv = timed(run, xs, bs)
        eff = rate / (points[0]["rate"] * n) if points else 1.0
        print(f"devices={n} solves/s={batch * rate:.1f} "
              f"efficiency={eff * 100:.1f}% converged={n_conv}/{batch}",
              flush=True)
        points.append({"devices": n, "rate": rate,
                       "solves_per_sec": batch * rate, "efficiency": eff,
                       "converged": n_conv})
        n *= 2
    return points


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="most devices (0: every CUDA device)")
    ap.add_argument("--batch", type=int, default=64,
                    help="scenarios (divisible by the device counts)")
    ap.add_argument("--multiprocess", type=int, default=0,
                    help="run the 1..N process sweep instead")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="processes on CPU shards (gloo) or cards (NCCL)")
    ap.add_argument("--local-devices", type=int, default=4,
                    help="CPU shards a process in --multiprocess")
    ap.add_argument("--local-batch", type=int, default=16,
                    help="scenarios a process in --multiprocess")
    ap.add_argument("--out", default=None,
                    help="write the sweep as JSON")
    args = ap.parse_args(argv)
    if args.multiprocess:
        run_multiprocess(args.multiprocess, args.local_devices,
                         args.local_batch, out_path=args.out,
                         device=args.device)
        return
    devices = pmesh.make_mesh(None if args.device == "cuda"
                              else ["cpu"] * (args.devices or 1))
    run_mesh(devices[:args.devices or len(devices)], args.batch)


if __name__ == "__main__":
    main()
