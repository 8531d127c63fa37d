#!/usr/bin/env python3
"""ADMM iterations per QP pass of the figure-eight MPC under several
implementations of K6 `admm_iterations`, on one GPU.

    python3 chip_studies/k6_iterations.py

Runs `chip_smoke.py`'s MPC-alone workload (256 lanes x 256 ticks, the same
seeds) once per implementation and prints one JSON line each: the kernel as
built from `uneven_planner_tpu_torch/csrc/admm_qp.cu`, the same source with
every fused multiply-add written as a multiply and an add, the kernel of
an earlier version (`--before`: a commit, default 16bc5bb, the
thread-per-output design, or the path of its admm_qp.cu where the checkout
has no git history), and the plain PyTorch twin on the card (slow: about 6 minutes).
The termination test at the path's 1e-6 tolerance sits at the fp32
rounding floor, so the count follows the order in which the sums are taken;
the tracking error shows whether that matters to the controller.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def unfused(src: str) -> str:
    return re.sub(r"fmaf\(([^,]+), ([^,]+), ([^)]+\]?)\)", r"(\3 + \1 * \2)",
                  src)


class _Present:
    """A loaded library seen by a `declare` function: a C function that its
    source lacks (an older version) takes the declaration harmlessly."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return types.SimpleNamespace()


def build_variants(sources: dict, out_dir: str, declare=None,
                   logs=None) -> dict:
    """Compile each named CUDA source with the package's flags, all at once,
    and load it with `declare` (K6's argument types by default; functions a
    source lacks stay undeclared); the compilers' output goes into `logs`
    by name where one is given."""
    from uneven_planner_tpu_torch.kernels import admm, build
    declare = declare or admm._declare
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = f"{out_dir}/{name}.cu", f"{out_dir}/lib{name}.so"
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        if logs is not None:
            logs[name] = log
        lib = ctypes.CDLL(so)
        declare(_Present(lib))
        libs[name] = lib
    return libs


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--before", default="16bc5bb")
    p.add_argument("--no-twin", action="store_true")
    args = p.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from uneven_planner_tpu_torch.config import scene_config
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.mpc import traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    src_path = os.path.join(ROOT, "uneven_planner_tpu_torch/csrc/admm_qp.cu")
    current = open(src_path).read()
    sources = {"unfused": unfused(current)}
    if os.path.isfile(args.before):
        sources["before"] = open(args.before).read()
    else:
        r = subprocess.run(["git", "show", f"{args.before}:uneven_planner_"
                            "tpu_torch/csrc/admm_qp.cu"], cwd=ROOT,
                           capture_output=True, text=True)
        if r.returncode != 0:
            sys.exit(f"--before {args.before}: no such commit or file")
        sources["before"] = r.stdout
    libs = {"current": admm.LIBRARY.load(),
            **build_variants(sources, os.path.join(
                os.path.dirname(src_path), "..", "_build", "studies"))}
    print(cs.nvidia_smi_line(), flush=True)
    scfg = scene_config("hill")
    f8 = traj_msg.figure_eight(scfg.alm.max_vel, dtype=torch.float32,
                               device="cuda")
    kernel = admm.admm_iterations
    names = list(libs) + ([] if args.no_twin else ["twin"])
    try:
        for name in names:
            rng = np.random.default_rng(2)
            cs._f8_starts(cs.MPC_LANES, rng)     # the warm-up's draw
            s0 = cs._f8_starts(cs.MPC_LANES, rng)
            if name == "twin":
                admm.admm_iterations = admm.admm_iterations_twin
            else:
                admm.admm_iterations = kernel
                admm.LIBRARY._lib = libs[name]
            t0 = time.perf_counter()
            tres = rollout.track_trajectory_batched(f8, s0, scfg.mpc,
                                                    cs.MPC_TICKS,
                                                    max_sqp_iter=3)
            err = float(tres.mean_err.mean())
            print(json.dumps(dict(
                k6=name, lanes=cs.MPC_LANES, ticks=cs.MPC_TICKS,
                wall_s=time.perf_counter() - t0, mean_track_err=err,
                **cs.qp_statistics(tres))), flush=True)
    finally:
        admm.admm_iterations = kernel
        admm.LIBRARY._lib = libs["current"]


if __name__ == "__main__":
    main()
