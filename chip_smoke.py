#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (uneven_planner_tpu_torch) on one GPU.

    python3 chip_smoke.py                       # every phase: the run of record
    python3 chip_smoke.py --phases gather,admm  # device, build, these only

Phases, each of which must pass (exit code 1 otherwise):
  1. device   CUDA present, full-fp32 matmul settings, card name and power
              limit from nvidia-smi;
  2. build    the terrain-lookup, gather, elementwise, ADMM and Ruiz kernels,
              compiled with nvcc from uneven_planner_tpu_torch/csrc, and
              K2, K4 and K3's word path as they were before their
              redesigns (chip_studies/k2_before.cu, k4_before.cu,
              k3_before.cu, for the same-call comparison), all compilers
              at once;
  3. kernels  each kernel against its plain PyTorch twin, timed beside the
              twin, its bound and (where one exists) the PyTorch library
              call: the terrain lookups on the full hill grid (200 x 200 x
              64) at the headline's lookup count (4096 lanes x 90 samples)
              and at the planning path's and the pipeline's shapes and
              modes, the gathers at the TPU probes' shapes, the planning
              path's, the pipeline's and the tracking path's (K4 also on
              several arrays at one index, on the walk back through the
              search's arena, and on the inputs of one real hill search;
              K3 also at probe B's own shape, on 24-byte rows and on views
              off 16-byte alignment, with the sector floor of its rows),
              K2, K4 and K3's word path beside their kernels before the
              redesign, tanh_affine
              at the TPU probe's shape and at a large one, the ADMM loop on
              the QPs of a real tracking tick (256 lanes, warm-started) and
              on random box QPs, with a split run held bit for bit, and its
              sparse and global-memory variants side by side on the full QP
              of a real tick (n = 150, m = 208; 256 lanes in fp32, 64 in
              fp64), then the global one on its own path (solve_qp on dense
              QPs of that shape); the Ruiz equilibration (K7) on the first
              QP of a real tick (256 lanes) of both forms in fp32 and fp64,
              the full QP's fp64 lane in place in device memory, one
              iteration bit for bit before the cost scale; K1 and K2 in
              float64 on the hill grid in
              float64 at the headline's and the nested path's lookup
              counts, bit for bit with their float64 twins in every
              instantiation;
  4. small    8 lanes solved on the card (fp32, kernels) against the same
              lanes on the CPU (fp64, plain twins);
  5. headline the main path at full width: hill grid with its f16 table,
              warm duals from a 512-lane pilot, one warm-up batch of 4096
              lanes, then one fresh timed batch whose kernel launches are
              counted; converged share, eval counts and an exact-table
              recheck of the residuals;
  6. profile  device busy share and kernel time by name over a few solver
              steps;
  7. plan-ref 8 scenarios planned on a coarse grid on the card (fp32,
              kernels; then fp64, the kernels' float64 instantiations)
              against the CPU (fp64, plain twins), held by outcome;
  8. plan     the planning path at full width: api.plan_batch (kinodynamic
              search -> on-device init guess -> flat solve) on the full hill
              map with the default front-end sizing, 256 scenarios: one
              warm-up batch, one fresh batch for the search alone, one fresh
              timed batch whose kernel launches are counted (K4's three
              entries summed); path checks, post-solve metrics, and a
              profile of one search (device operations and K4 launches per
              round, device busy share);
  9. track-ref 4 lanes of figure-eight tracking, 40 ticks, on the card
              (fp32, ADMM kernel) against the CPU (fp32, plain twin);
 10. track-full-ref  4 lanes x 40 ticks with the full QP
              (qp_condense=False) on the card in fp32 and in fp64 (K3/K4
              on 8-byte elements; K6's sparse variant) against the CPU
              (fp64, plain twins), fp32 held by outcome, fp64 to 1e-6;
 11. mpc      the tracking MPC alone at full width: 256 lanes x 256 ticks
              on the figure-eight; ticks/s, tracking error, QP iteration
              statistics, launch counts, and a profile of a few ticks;
 12. mpc-full the MPC with the full QP at full width: 256 lanes x 64 ticks
              (depth cut), tracking error beside the condensed QP's over
              the same ticks, QP iteration statistics, launch counts;
 13. pipeline the plan -> track path at full width: plan_track_batch on 64
              scenarios x 500 ticks; scenarios/s, planned-and-converged
              share, tracking error; then search, solve and the first 100
              ticks of the tracking once more, each alone, for the split
              of the time;
 14. nested-reference  the reference's nested solve on 8 lanes of a
              coarse grid: alm.solve, solve_compacted and debug_iterates
              on the card (kernels) against the port on the CPU (plain
              twins), per lane, in fp32 on both sides and (solve and
              solve_compacted) in fp64 on both sides;
 15. nested   the nested path at full width: the search, the on-device
              init guess and alm.solve (PHR-ALM around L-BFGS with the
              Lewis-Overton line search, every evaluation through K2) on
              256 hill scenarios with examples/plan_demo.py's settings,
              launches counted; solve_compacted on the same inputs; the
              post-solve report, and a profile of the first outer round;
 16. packed   the split-bf16 table: its lookup (K3 and tensor operations)
              at the headline's 368,640 lookups against its CPU twin and
              the exact lookup, timed beside K1 and K2; K3 at its items;
              a headline batch on that table with the headline's gates;
 17. build    the map builder at full width: a hill cloud (the surface
              triangulated at 1 cm, 300,000 samples, 40 trunks) written as
              a PCD, read back through io.load_scene_cloud, built once with
              build.construct_map on the hill map (200 x 200 x 64 cells, 2
              iterations) with K3's launches counted, and a 4 x 4 m crop of
              it under the profiler; the map against the
              surface, the fits against a brute-force oracle, the three modes
              on a 4 x 4 m crop, the card against the CPU on a 1.6 x 1.6 m
              crop, K3 at the build's two reads, 256 plans on the built
              map and its npz cache;
 18. dist     parallel.distributed with one NCCL rank (one card):
              plan_batch_global on the full-width headline batch (4096
              lanes, ProblemShape(10, 20, 8), memory 8, 30 iterations),
              every lane bit for bit with the unsharded solve_flat, the
              all-reduced counts equal to the local sums, solves/s of both;
 19. bench-track  the reference's bk_mode: the six episodes of
              data/bench_proposed_hill.txt through
              bench.tracking_benchmark (ctrl_dt 0.02, 2 relinearisations),
              each within 5% of data/err_bench_proposed_hill.txt;
 20. precision  bench.precision_study at 64 lanes: fp32 on the card and
              fp64 on the card against fp64 on the CPU;
 21. scene-eval  bench.scene_eval.run_scene on the hill at a cut batch,
              with the C++ A* oracle's feasibility of its scenarios: the
              search must succeed on every feasible one;
 22. oracle   the port held to the reference's float64 oracles: K6 on
              QP_DUMP_r05.json's condensed QP and 255 perturbed copies
              (256 lanes) within 1e-3 of the port's certified active-set
              optimum of each (utils/qp_ref.py, which re-certifies the
              dump); the float64 inner cost on the card (K2's float64
              instantiation) against the C++ forward (utils/native.py,
              built with g++ from native/src) to 1e-9 on 6 seeds, its
              gradient against the C++'s central differences; the C++ A*
              on the hill against the search on 64 sampled scenarios;
 23. demo     the user entry points: examples.plan_demo on the hill with
              --track and --out, examples.debug_stepper, and
              examples.build_maps on a hill cloud written as a PCD, its
              CSV cache read back by the C++.
Prints the kernels' JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Without CUDA, or without the package beside
it, it exits 2 and prints no result.  `--phases` names phases 3-23 by their
short names (PHASES below; 6 runs with 5, the plan's profile with 8 and
the nested path's with 15): it runs the device and build steps and those
phases, prints their lines and `# total`, and ends with {"partial": [...]}
instead of the kernels' line and the ok line, so a partial run never
passes for the whole.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): DRAM bytes/s, fp32 FLOP/s outside the
# tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# fp64 FLOP/s, the card's peak for the type: through the tensor cores (NVIDIA
# data sheet, H100 SXM; 34e12 outside them)
PEAK_F64 = 67e12
# Lookups per solver evaluation at the headline: 4096 lanes x 10 pieces x 9.
M_HEADLINE = 4096 * 90
# fp32 arithmetic per lookup, counted from the kernel source (index math,
# unpack, blends, derivatives, 7-tuple tail and its Jacobian; one
# transcendental counted as one operation).  Bytes bound both kernels by
# an order of magnitude, so the estimate does not move bound_ms.
OPS = {"terrain_tv_packed16": 320, "terrain_tv_pair": 360}
TOL = {"tv": (1e-5, 1e-5), "jac": (1e-4, 1e-4)}   # (atol, rtol), fp32
# The gathers move values unchanged: they must equal their twins exactly.
TOL_GATHER = 0.0
PLAN_BATCH = 256
# K4's entries: the one-array read, several arrays at one index, the walk
K4_FAMILY = ("gather_along", "gather_along_many", "walk_parents")
# K5: tanhf against torch.tanh in units of the last place, and the affine
# result absolutely (it cancels near tanh(x) = -1/2).
TOL_TANH_ULP = 2
TOL_TANH_ABS = 5e-7
# K6 against its twin on the same tensors.  The two sum in different orders,
# so: over a fixed count of iterations (no termination test) x and y within
# TOL_ADMM_REL of the twin, relative to the lane's largest entry; with the
# termination test at a tolerance well above fp32 rounding (1e-4) equal
# iteration counts on MIN_EQUAL_ITERS_SHARE of the lanes and no lane further
# than MAX_ITERS_DIFF from its twin; at the path's own
# tolerance (1e-6, at the fp32 noise floor, where the iteration at which a
# residual first dips under its limit depends on the last bits) the
# solutions within TOL_ADMM_REL_STOPPED and the counts only printed.
TOL_ADMM_REL = 5e-5
# the sparse and global variants against their twin at a fixed count on
# the full QP of a real tick.  float64: rounding of two summation orders
# over 400 iterations.  float32: on that QP each float32 order of summation
# strays up to 1.2e-4 from the float64 iterate in y, so TOL_ADMM_REL cannot
# hold.  The limit was set as twice the largest of 16 readings of the
# global kernel against the twin (1.22e-4: 4 seeds x 4 ticks,
# `chip_studies/k6_global_tolerance.py`, on an H100 80GB HBM3, 700 W); the
# sparse kernel's 16 readings reach 1.69e-4 (twice that would be 3.4e-4),
# so the limit stays where every reading of both lies under it, 186 times
# below the nearest lower-precision control (P, A and the inverse rounded
# to TF32: 0.046), which `admm_full_qp_rows` checks on every run.
TOL_ADMM_REL_F64 = 1e-10
TOL_ADMM_REL_GLOBAL_F32 = 2.5e-4
TOL_ADMM_REL_STOPPED = 1e-3
ADMM_LOOSE_EPS = 1e-4
MIN_EQUAL_ITERS_SHARE = 0.7
MAX_ITERS_DIFF = 1
# fp32 arithmetic of one tanh_affine element (tanhf counted as 20 operations)
OPS_TANH = 22
MPC_LANES, MPC_TICKS = 256, 256
# the full tracking QP (n = 150, m = 208): the MPC alone at full width, its
# depth cut to 64 ticks to keep the script's time; f64 rows of K6 at 64 lanes
MPC_FULL_TICKS = 64
ADMM_F64_LANES = 64
PIPE_LANES, PIPE_TICKS = 64, 500
# the ticks the pipeline phase tracks again alone, for the split of the time
PIPE_SPLIT_TICKS = 100
MAX_TRACK_ERR = 0.05      # metres, mean over a lane's pre-goal ticks
# the full and the condensed QP share one optimum: their tracking errors
# over the same ticks may differ by at most this (metres)
MAX_FULL_VS_CONDENSED_ERR = 0.002
# full-QP tracking in float64, card against CPU over 4 lanes x 40 ticks:
# states (m, rad) and commands; the two sum in different orders, so a QP
# may stop an iteration apart at its 1e-6 test
TRACK_F64_STATE_TOL = 1e-6
TRACK_F64_CMD_TOL = 1e-5
# the map builder's phase: the hill surface (lifted BUILD_LIFT m so the
# reference's crop box, z >= -0.01, keeps every point) triangulated at 1 cm
# and sampled BUILD_SAMPLES times, as the reference's to_pcl.py samples a
# mesh, plus BUILD_TRUNKS trunks of 600 points in TRUNK_BOX ((x0, x1),
# (y0, y1)), where no planning scenario goes
BUILD_MESH_STEP = 0.01
BUILD_LIFT = 0.1
BUILD_SAMPLES = 300_000
BUILD_TRUNKS = 40
TRUNK_BOX = ((2.5, 4.5), (-4.5, -2.5))
# the map the build phase profiles: a 4 x 4 m crop at the hill's resolution
PROFILE_CROP_SIZE = (4.0, 4.0)
# built z against the surface at each cell's probe point (metres)
MAX_Z_ERR_MEDIAN = 0.002
MAX_Z_ERR_P99 = 0.03
# sigma = 3 lambda_min / trace is ~0 on a noise-free surface, and exactly 0
# where an ellipsoid holds two points (a rank-1 covariance), where the
# float32 closed form of both packages (build.py:351-370) puts the two zero
# eigenvalues up to ~sqrt(eps_f32) lambda_max to either side of 0: sigma
# down to ~-3 sqrt(eps_f32) = -7.3e-4 (the JAX package's f32 eigensolver
# gives -1.5e-7 against a trace of 1.6e-3 on such a two-point covariance,
# sigma -2.8e-4)
SIGMA_ROUNDING = 1e-3
# fits against the brute-force oracle (atol and rtol, tests/test_build.py);
# the modes against each other (tests/test_build.py:158, :164); the card
# against the CPU, every cell and the median (float32, summation orders)
TOL_BUILD_ORACLE = 5e-3
TOL_BUILD_MODES = 2e-3
TOL_BUILD_CARD_CPU = 2e-3
TOL_BUILD_CARD_CPU_MEDIAN = 1e-6
# plan-reference: the search's path costs, card against the CPU's float64,
# relative; float32 flips discrete choices (0.0015 measured on the H100),
# float64 does not (0.0 measured)
TOL_PLAN_REF_COST_F32 = 0.1
TOL_PLAN_REF_COST_F64 = 1e-9
# the nested path's settings (examples/plan_demo.py:86-91)
NESTED_SHAPE = (10, 20, 16)
NESTED_OVERRIDES = {"mem_size": 8, "max_iterations": 250}
NESTED_BUCKETS = (1, 4, 16)
# card (float32) against the port on the CPU (float32, plain twins), 8
# lanes.  The two sum in other orders, so a lane whose CPU counts move when
# its x0 moves by 1-2 float32 ulps (ULP_EPS) cannot be held count for
# count; such a lane is held to one outer round and the ALM band, the
# others exactly (as the CPU tests hold the port to the JAX package)
ULP_EPS = (2.0 ** -23, -2.0 ** -23, 2.0 ** -22, -2.0 ** -22)
# the same check in float64 on both sides (the card's K1 and K2 in float64
# against their twins on the CPU): 1-2 float64 ulps
ULP_EPS_F64 = (2.0 ** -52, -2.0 ** -52, 2.0 ** -51, -2.0 ** -51)
# x of a lane held to one outer round (the ALM band)
TOL_NESTED_X = 2e-2
# float64 x of the lanes held count for count: 2.4e-8 measured on the H100
TOL_NESTED_X_F64 = 1e-6
# the one stated exception of the float64 check: lane 1 of the 8-lane draw
# takes one outer round fewer on the card than on the CPU although no 1-2
# ulp change of x0 moves its CPU counts; a relative change of
# NESTED_F64_EXCEPTION_EPS does.  The phase probes that change on the CPU
# in every run and holds the lane to one round and the ALM band only while
# the probe still moves its counts
NESTED_F64_EXCEPTION_LANES = (1,)
NESTED_F64_EXCEPTION_EPS = (1e-14, -1e-14)
# debug_iterates rows of the card against the CPU's, on the lanes whose
# rows no ULP_EPS change of x0 moves
TOL_NESTED_ROWS = 2e-2
# the split-bf16 lookup against the exact one: relative to max(|exact|,
# 1), as tests/test_terrain.py::test_packed_lookup_matches_exact_within_bf16
TOL_PACKED_EXACT = 5e-5
# phase names for --phases, in the order a full run takes them
PHASES = ("terrain", "gather", "tanh", "admm", "small-reference",
          "headline", "plan-reference", "plan", "track-reference",
          "track-full-ref", "mpc", "mpc-full", "pipeline",
          "nested-reference", "nested", "packed", "build", "dist",
          "bench-track", "precision", "scene-eval", "oracle", "demo")


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

# the device time (ms) one `device_ms` reading may spend on the function
TIMING_BUDGET_MS = 400.0


def device_ms(fn, reps=25, inner=10):
    """Median device time of one fn() call: `inner` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events, so host launch cost is
    not counted.  A function whose one call would make the reading cost
    more than TIMING_BUDGET_MS (the plain twins, mostly) is captured once a
    graph and replayed fewer times, at least 5."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    one = a.elapsed_time(b)
    if one * inner * (reps + 1) > TIMING_BUDGET_MS:
        inner = 1
        reps = max(5, min(reps, int(TIMING_BUDGET_MS / max(one, 1e-6))))
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
        with torch.cuda.graph(g, stream=s):
            for _ in range(inner):
                fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


_flush_scratch = None


def device_ms_cold(fn, reps=25, inner=10):
    """`device_ms` of fn() with the 50 MB L2 emptied before every call: a
    256 MB buffer is read through (clean lines, so nothing but fn's own
    output is written back) ahead of each call, and the time of the reads
    alone is taken off.  A difference of two medians, so it is reported
    beside the direct `device_ms` reading and never in its place."""
    import torch
    global _flush_scratch
    if _flush_scratch is None:
        _flush_scratch = torch.ones(64 * 2 ** 20, dtype=torch.float32,
                                    device="cuda")
    flush = lambda: _flush_scratch.sum()
    both = device_ms(lambda: (flush(), fn()), reps, inner)
    return max(both - device_ms(flush, reps, inner), 0.0)


def device_profile():
    """A torch.profiler run that records the card's activity alone: every
    profile here reads device time by kernel, and recording each host
    operation too made the map build's profiled build (~90,000 operations)
    take over a minute of the profiler's own processing."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    from uneven_planner_tpu_torch import resolve_device
    dev = resolve_device(None)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("fp32 matmuls are not pinned to full precision")
    smi = nvidia_smi_line()
    log(f"# device: {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    return dev, smi


# K2, K4 and K3's word path as they were before their redesign (the
# sources of the commit before each redesign, copied under chip_studies/),
# built beside the package's kernels and timed in the same call as the
# redesigned ones; on no path
BEFORE_SOURCES = {"k2_before": "chip_studies/k2_before.cu",
                  "k4_before": "chip_studies/k4_before.cu",
                  "k3_before": "chip_studies/k3_before.cu"}
_before = {}


def before_library(name):
    """The loaded library of BEFORE_SOURCES[name], with the C interface
    its source had: K2's terrain_tv_pair without index width or layout,
    K4's gather_along on one array, K3's gather_rows with the word alone."""
    import ctypes
    from uneven_planner_tpu_torch.kernels import build
    if name not in _before:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)

        def declare(lib):
            if name == "k2_before":
                lib.terrain_tv_pair.argtypes = [p] * 6 + [i] + [i] * 3 \
                    + [f] * 11 + [i, p]
                lib.terrain_tv_pair.restype = i
            elif name == "k3_before":
                lib.gather_rows.argtypes = [p, p, p, ll, ll, i, i, i, p]
                lib.gather_rows.restype = i
            else:
                lib.gather_along.argtypes = [p, p, p, ll, i, ll, ll, ll, ll,
                                             i, i, p]
                lib.gather_along.restype = i
        _before[name] = build.CudaLibrary(
            name, declare, os.path.join(HERE, BEFORE_SOURCES[name]))
    return _before[name]


def phase_build():
    from uneven_planner_tpu_torch.kernels import (admm, build, elementwise,
                                                  gather, ruiz,
                                                  terrain_lookup)
    libs = [terrain_lookup.LIBRARY, gather.LIBRARY, elementwise.LIBRARY,
            admm.LIBRARY, ruiz.LIBRARY] \
        + [before_library(n) for n in BEFORE_SOURCES]
    t0 = time.perf_counter()
    paths = build.build_all(libs)
    for lib in libs:
        lib.load()
    dt = time.perf_counter() - t0
    for lib, path in zip(libs, paths):
        log(f"# build: {lib.name} -> {os.path.relpath(path, HERE)}")
        for ln in lib.build_log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log("#   " + ln.strip())
    log(f"# build: {dt:.1f} s for {len(libs)} libraries (the last "
        f"{len(BEFORE_SOURCES)} K2, K4 and K3's word path before their "
        "redesigns, for comparison), compiled side by side")
    return dt


def smoke_poses(grid, M, seed):
    """M poses over the map with edge, yaw-wrap and out-of-map samples."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ox, oy, _ = grid.origin
    sx, sy, _ = grid.map_size
    px = rng.uniform(ox - 0.05, ox + sx + 0.05, M)
    py = rng.uniform(oy - 0.05, oy + sy + 0.05, M)
    yaw = rng.uniform(-np.pi, np.pi, M)
    k = M // 64
    py[:k] = oy + rng.uniform(0.0, grid.xy_resolution, k)   # iyf < 0 strip
    px[k:2 * k] = ox + sx - rng.uniform(0.0, grid.xy_resolution, k)
    yaw[2 * k:3 * k] = -np.pi                               # yaw wrap
    yaw[3 * k:4 * k] = np.nextafter(np.pi, 0.0)
    return [torch.tensor(a, dtype=torch.float32, device=grid.device)
            for a in (px, py, yaw)]


def _err(got, want, atol, rtol):
    import torch
    d = (got - want).abs()
    bad = d > atol + rtol * want.abs()
    return float(d.max()), int(bad.sum()), bool(torch.isfinite(got).all())


def terrain_cases():
    """(path, M, kernel, exact, want_jac) for every shape and mode at which
    a main path launches K1 or K2.  Headline: 4096 lanes x 90 samples, each
    mode.  Planning path (256 scenarios, ProblemShape(10, 20, int_K=16))
    and pipeline (64 scenarios, int_K=8), B scenarios each: K1 hi-only
    without J on the search's [B, 10240] candidates, K1 hi-only with J on
    the solver's [B, S] samples, K2 with J in init_scaling on [B, S] (cost
    gradient) and on [B x num_vars, S] (the forward-mode constraint
    Jacobian).  Nested path (256 scenarios, ProblemShape(10, 20, 16)): K1
    on the search, K2 with J at every line-search evaluation on [B, S]
    (and in init_scaling, as on the planning path), K2 without J on the
    constraints that end each outer round."""
    from uneven_planner_tpu_torch.solver import alm
    cases = [("headline", M_HEADLINE, name, exact, jac)
             for name, exact in [("terrain_tv_packed16", False),
                                 ("terrain_tv_packed16", True),
                                 ("terrain_tv_pair", True)]
             for jac in (True, False)]
    # the pipeline runs the same four calls at 64 scenarios and int_K=8
    for path, B, int_K in (("planning", PLAN_BATCH, 16),
                           ("pipeline", PIPE_LANES, 8)):
        shape = alm.ProblemShape(piece_xy=10, piece_yaw=20, int_K=int_K)
        S, n = shape.equal_num, shape.num_vars
        cases += [
            (f"{path}: search sigma", B * 10240, "terrain_tv_packed16",
             False, False),
            (f"{path}: solver step", B * S, "terrain_tv_packed16", False,
             True),
            (f"{path}: init_scaling cost", B * S, "terrain_tv_pair", True,
             True),
            (f"{path}: init_scaling jacobian", B * n * S, "terrain_tv_pair",
             True, True)]
    S = alm.ProblemShape(*NESTED_SHAPE).equal_num
    n = alm.ProblemShape(*NESTED_SHAPE).num_vars
    cases += [
        ("nested: search sigma", PLAN_BATCH * 10240, "terrain_tv_packed16",
         False, False),
        ("nested: line-search evaluation", PLAN_BATCH * S, "terrain_tv_pair",
         True, True),
        ("nested: round constraints", PLAN_BATCH * S, "terrain_tv_pair",
         True, False),
        ("nested: init_scaling jacobian", PLAN_BATCH * n * S,
         "terrain_tv_pair", True, True)]
    return cases


def _k2_before(lib, table, geom, px, py, yaw, want_jac):
    """The parent's K2 on its own table order (cells x, y, w)."""
    import torch
    M = px.numel()
    tv = torch.empty((7, M), device=px.device)
    jac = torch.empty((7, 3, M), device=px.device) if want_jac else None
    err = lib.terrain_tv_pair(
        px.data_ptr(), py.data_ptr(), yaw.data_ptr(), table.data_ptr(),
        tv.data_ptr(), jac.data_ptr() if want_jac else None, M, *geom,
        int(want_jac), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's K2 failed to launch ({err})")
    return tv, jac


def phase_kernels(grid):
    """K1 and K2 against their twins on the same CUDA tensors, at every
    shape and mode of `terrain_cases`; times, and the parent's K2 timed
    beside the redesigned one."""
    from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    import torch
    geom = tgrid.kernel_geometry(grid)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k2_before = before_library("k2_before").load()
    nx, ny, nyaw = grid.voxel_num
    pair_xyw = grid.data_pair.reshape(ny, nyaw, nx, 8).permute(2, 0, 1, 3) \
        .contiguous().reshape(-1, 8)
    variants = []
    for path, M, name, exact, want_jac in terrain_cases():
        px, py, yaw = smoke_poses(grid, M, seed=1)
        parent = None
        if name == "terrain_tv_pair":
            kern = lambda: kernels.terrain_tv_pair(
                grid.data_pair, geom, px, py, yaw, want_jac)
            twin = lambda: tgrid.pair_tv_jac(grid, px, py, yaw, want_jac)
            parent = lambda: _k2_before(k2_before, pair_xyw, geom, px, py,
                                        yaw, want_jac)
            rows = 4
        else:
            kern = lambda: kernels.terrain_tv_packed16(
                grid.data_packed16, geom, px, py, yaw, exact, want_jac)
            twin = lambda: tgrid.packed16_tv_jac(grid, px, py, yaw, exact,
                                                 want_jac)
            rows = 4 if exact else 2
        got, want = kern(), twin()
        e_tv = _err(got[0], want[0], *TOL["tv"])
        e_j = _err(got[1], want[1], *TOL["jac"]) if want_jac else (0.0, 0,
                                                                     True)
        equal = torch.equal(got[0], want[0]) and (
            not want_jac or torch.equal(got[1], want[1]))
        parent_equal = None
        if parent is not None:
            old = parent()
            parent_equal = torch.equal(old[0], want[0]) and (
                not want_jac or torch.equal(old[1], want[1]))
            del old
        del got, want
        ms = device_ms(kern)
        plain_ms = device_ms(twin)
        ms_parent = device_ms(parent) if parent is not None else None
        nbytes = M * (12 + 32 * rows + 28 + (84 if want_jac else 0))
        bound_s = max(nbytes / PEAK_BYTES, M * OPS[name] / PEAK_F32)
        v = dict(name=name, path=path, exact=exact, want_jac=want_jac, M=M,
                 layout=(kernels.packed16_layout(M, sms)
                         if name == "terrain_tv_packed16"
                         else kernels.pair_layout(M, sms)),
                 equal=equal, max_abs_err_tv=e_tv[0], max_abs_err_jac=e_j[0],
                 n_out_of_tol=e_tv[1] + e_j[1], finite=e_tv[2] and e_j[2],
                 ms=ms, plain_ms=plain_ms, ms_parent=ms_parent,
                 parent_equal=parent_equal, bound_ms=bound_s * 1e3,
                 bound_by=("bytes" if nbytes / PEAK_BYTES
                           >= M * OPS[name] / PEAK_F32 else "operations"),
                 bytes=nbytes)
        log("# kernel " + json.dumps(v))
        variants.append(v)
    # K1 and K2 are held bit for bit (their redesigns keep every operation
    # of every sample)
    bad = [v for v in variants if v["n_out_of_tol"] or not v["finite"]
           or not v["equal"]]
    if bad:
        raise RuntimeError(f"kernel disagrees with its twin: {bad}")
    return variants


def terrain_cases_f64():
    """(path, M, kernel, exact, want_jac) of the float64 readings: K1 and
    K2 at the headline's M with J (K1 hi-only and exact), and at the nested
    path's M = 43,520 (K2 with J at every line-search evaluation and
    without J on the round constraints; K1 hi-only with J, the planning
    step's lookup, at the same M)."""
    from uneven_planner_tpu_torch.solver import alm
    M_nested = PLAN_BATCH * alm.ProblemShape(*NESTED_SHAPE).equal_num
    return [("headline", M_HEADLINE, "terrain_tv_packed16", False, True),
            ("headline", M_HEADLINE, "terrain_tv_packed16", True, True),
            ("headline", M_HEADLINE, "terrain_tv_pair", True, True),
            ("nested: line-search evaluation", M_nested, "terrain_tv_pair",
             True, True),
            ("nested: round constraints", M_nested, "terrain_tv_pair", True,
             False),
            ("planning: solver step", M_nested, "terrain_tv_packed16", False,
             True)]


def phase_kernels_f64(device):
    """K1 (float64 poses over the f16 table) and K2 (the float64 pair
    table) on the full hill grid in float64, against their twins in
    float64 on the same CUDA tensors: bit for bit in the instantiation the
    wrapper picks and in every other one (both layouts, both index widths),
    timed beside the twin and the bound (8-byte poses, outputs and J; K2's
    64-byte rows)."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    grid = headline.scene_setup(device=device, dtype=np.float64)[1]
    geom = tgrid.kernel_geometry(grid)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = []
    for path, M, name, exact, want_jac in terrain_cases_f64():
        px, py, yaw = (t.double() for t in smoke_poses(grid, M, seed=2))
        if name == "terrain_tv_pair":
            kern = lambda: kernels.terrain_tv_pair(
                grid.data_pair, geom, px, py, yaw, want_jac)
            launch = lambda **kw: kernels._launch_pair(
                grid.data_pair, geom, px, py, yaw, want_jac, **kw)
            twin = lambda: tgrid.pair_tv_jac(grid, px, py, yaw, want_jac)
            row_bytes = 4 * 64
            layout = kernels.pair_layout(M, sms)
        else:
            kern = lambda: kernels.terrain_tv_packed16(
                grid.data_packed16, geom, px, py, yaw, exact, want_jac)
            launch = lambda **kw: kernels._launch_packed16(
                grid.data_packed16, geom, px, py, yaw, exact, want_jac, **kw)
            twin = lambda: tgrid.packed16_tv_jac(grid, px, py, yaw, exact,
                                                 want_jac)
            row_bytes = (4 if exact else 2) * 32
            layout = kernels.packed16_layout(M, sms)
        want = twin()
        runs = [kern] + [lambda lo=lo, i32=i32: launch(layout=lo, idx32=i32)
                         for lo in kernels.LAYOUTS for i32 in (True, False)]
        equal, err = True, 0.0
        for run in runs:
            got = run()
            equal &= bool(torch.equal(got[0], want[0])) and (
                not want_jac or bool(torch.equal(got[1], want[1])))
            err = max(err, float((got[0] - want[0]).abs().max()),
                      float((got[1] - want[1]).abs().max())
                      if want_jac else 0.0)
            del got
        del want
        ms, plain_ms = device_ms(kern), device_ms(twin)
        nbytes = M * (24 + row_bytes + 56 + (168 if want_jac else 0))
        ops_s = M * OPS[name] / PEAK_F64
        v = dict(name=name + "_f64", path=path, exact=exact,
                 want_jac=want_jac, M=M, layout=layout, dtype="float64",
                 equal=equal, instantiations_equal=len(runs),
                 max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=max(nbytes / PEAK_BYTES, ops_s) * 1e3,
                 bound_by="bytes" if nbytes / PEAK_BYTES >= ops_s
                 else "operations", bytes=nbytes)
        log("# kernel " + json.dumps(v))
        variants.append(v)
    bad = [v for v in variants if not v["equal"]]
    if bad:
        raise RuntimeError(f"a float64 kernel differs from its twin: {bad}")
    return variants


def phase_small_reference(device):
    """8 lanes: card (fp32, kernels) against CPU (fp64, plain twins)."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.solver import alm
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    from uneven_planner_tpu_torch.terrain.synthetic import \
        make_synthetic_grid
    hc = headline.HeadlineConfig()
    cfg, grid = headline.scene_setup(device=device)
    cpu_grid = tgrid.with_packed_f16(tgrid.with_pair_table(
        make_synthetic_grid(cfg.map, device="cpu")))
    x0, bnd, _ = headline.make_batch(8, cfg, hc.shape,
                                     np.random.default_rng(7), device=device)
    card = alm.solve_flat(x0, bnd, hc.shape, grid, cfg.alm,
                          lbfgs_overrides=hc.overrides)
    ref = alm.solve_flat(
        x0.double().cpu(), alm.tree_map(lambda a: a.double().cpu(), bnd),
        hc.shape, cpu_grid, cfg.alm, lbfgs_overrides=hc.overrides)
    c_card, c_ref = card.converged.cpu(), ref.converged
    both = c_card & c_ref
    dx = (card.x.double().cpu() - ref.x).abs().amax(1)
    out = dict(lanes=8, converged_card=int(c_card.sum()),
               converged_ref=int(c_ref.sum()),
               max_dx_both=float(dx[both].max()) if both.any() else None,
               evals_card=card.evals.tolist(), evals_ref=ref.evals.tolist())
    log("# small " + json.dumps(out))
    if not torch.isfinite(card.x).all() or int(both.sum()) < 7 \
            or float(dx[both].max()) > 2e-2:
        raise RuntimeError(f"card solve disagrees with the reference: {out}")
    return out


# the kernel of each fast table's lookup in a solver step
FAST_LOOKUP_KERNEL = {"f16": "terrain_tv_packed16", "packed": "gather_rows"}


def phase_headline(device, smi, table="f16"):
    """The headline at full width on the fast table `table` (the solver
    iterates on it; `init_scaling` and the recheck read the exact one)."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.solver import alm
    hc = headline.HeadlineConfig()
    cfg, grid = headline.scene_setup(device=device, table=table)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    warm_for = headline.harvest_warm(cfg, grid, hc, rng, device=device)
    pilot_s = time.perf_counter() - t0
    if warm_for is None:
        raise RuntimeError("pilot: fewer than 90% of the pilot lanes converged")
    batches = [headline.make_batch(hc.batch, cfg, hc.shape, rng,
                                   device=device) for _ in range(2)]

    def run(batch):
        warm = warm_for(batch[2])
        res = headline.solve(batch[0], batch[1], cfg, grid, hc,
                             warm_duals=warm)
        return res, res.converged.cpu().numpy()

    t0 = time.perf_counter()
    _, conv0 = run(batches[0])                       # warm-up batch
    warm_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    res, conv = run(batches[1])                      # fresh, timed, counted
    dt = time.perf_counter() - t0
    launches = all_launches()

    x0, bnd, _ = batches[1]
    scal = alm._make_scaling(x0, bnd, hc.shape, grid, cfg.alm)
    B = hc.batch
    zero = alm.DualState(
        lam=torch.zeros((B, hc.shape.equal_num), device=device),
        mu=torch.zeros((B, hc.shape.non_equal_num), device=device),
        rho=torch.full((B,), cfg.alm.rho, device=device))
    rh, rg = alm.exact_residuals(res.x, zero, bnd, hc.shape, grid, cfg.alm,
                                 scal)
    recheck = torch.maximum(rh, rg).cpu().numpy()
    viol = recheck[conv] > cfg.alm.epsilon_con
    evals = res.evals.cpu().numpy()
    out = dict(
        table=table, solves_per_s=B / dt, batch=B, wall_s=dt, card=smi,
        converged_share=float(conv.mean()),
        warmup_converged_share=float(conv0.mean()),
        evals_mean=float(evals.mean()), evals_max=int(evals.max()),
        steps=res.steps, ms_per_step=dt / max(res.steps, 1) * 1e3,
        launches=launches, recheck_violations=int(viol.sum()),
        recheck_max=float(recheck[conv].max()) if conv.any() else None,
        pilot_s=pilot_s, warmup_s=warm_s,
        finite=bool(torch.isfinite(res.x).all()
                    and torch.isfinite(res.traj.c_xy).all()),
        x_shape=list(res.x.shape),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(("# headline " if table == "f16" else f"# headline-{table} ")
        + json.dumps(out))
    fails = []
    fast = FAST_LOOKUP_KERNEL[table]
    if launches[fast] != res.steps:
        fails.append(f"{fast} launches != solver steps")
    if launches["terrain_tv_pair"] == 0:
        fails.append("K2 never launched")
    if out["converged_share"] < 0.95:
        fails.append("fewer than 95% of lanes converged")
    if viol.sum() > 0.01 * max(conv.sum(), 1):
        fails.append("more than 1% of converged lanes fail the recheck")
    if not out["finite"] or out["x_shape"] != [B, hc.shape.num_vars]:
        fails.append("non-finite or misshapen output")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out, (cfg, grid, hc, batches[1], warm_for)


def phase_profile(ctx, steps=16):
    """Kernel time by name and device busy share over `steps` solver steps
    at full width (state after one chunk of the timed batch)."""
    import torch
    from uneven_planner_tpu_torch.solver import alm
    from uneven_planner_tpu_torch.utils import profiling
    cfg, grid, hc, batch, warm_for = ctx
    x0, bnd, feats = batch
    p = alm._params(cfg.alm, hc.overrides)
    scal = alm._make_scaling(x0, bnd, hc.shape, grid, cfg.alm)
    st = alm.flat_init(x0, hc.shape, cfg.alm, p, warm_for(feats))
    st, _ = alm.flat_run(st, bnd, scal, hc.shape, grid, cfg.alm, p, 8)
    torch.cuda.synchronize()
    with device_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            st = alm.flat_step(st, bnd, scal, hc.shape, grid, cfg.alm, p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, rows = profiling.device_time_by_kernel(prof)
    out = dict(steps=steps, wall_ms_per_step=wall / steps * 1e3,
               device_ms_per_step=total / steps / 1e3,
               device_busy_share=total / 1e6 / wall,
               top=[dict(kernel=k[:80], device_ms_per_step=u / steps / 1e3,
                         calls_per_step=c / steps) for u, k, c in rows[:8]])
    log("# profile " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# gather kernels K3 / K4
# ---------------------------------------------------------------------------

def _edge_indices(n, shape, seed, dtype, device):
    """Random indices into [0, n) with both ends, out-of-range and negative
    ones mixed in."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randint(0, n, shape, generator=g, dtype=torch.int64)
    flat = idx.reshape(-1)
    flat[::7] = torch.randint(n, 3 * n, flat[::7].shape, generator=g)
    flat[3::11] = -torch.randint(1, 2 * n, flat[3::11].shape, generator=g)
    flat[:4] = torch.tensor([0, n - 1, n, -1])
    return idx.to(dtype).to(device)


def _exact_err(got, want):
    import torch
    if isinstance(got, (list, tuple)):
        return max(_exact_err(g, w) for g, w in zip(got, want))
    if got.dtype == torch.bool:
        got, want = got.to(torch.uint8), want.to(torch.uint8)
    return float((got.double() - want.double()).abs().max())


def _all_equal(got, want):
    import torch
    if isinstance(got, (list, tuple)):
        return len(got) == len(want) and all(
            _all_equal(g, w) for g, w in zip(got, want))
    return bool(torch.equal(got, want))


def _k4_before(lib, x, idx, axis=1):
    """The parent's K4 on one array."""
    import torch
    rows, cols = idx.shape
    out = torch.empty((rows, cols), dtype=x.dtype, device=x.device)
    strides = (x.shape[1], 0, 1) if axis == 1 else (0, 1, x.shape[1])
    err = lib.gather_along(x.data_ptr(), idx.data_ptr(), out.data_ptr(),
                           rows, cols, x.shape[axis], *strides,
                           x.element_size(), int(idx.dtype == torch.int64),
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the parent's K4 failed to launch ({err})")
    return out


def _k3_before(lib, table, idx):
    """K3's word path before its redesign (one thread per output word), on
    any table, with the word rule it had: 16 bytes where the row is a
    multiple of 16 and table and output are 16-byte aligned, else the
    element's width."""
    import torch
    out = torch.empty((idx.shape[0],) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=table.device)
    elem = table.element_size()
    row = elem * (table.shape[1] if table.dim() == 2 else 1)
    word = 16 if row % 16 == 0 and table.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0 else elem
    err = lib.gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          idx.shape[0], table.shape[0], row, word,
                          int(idx.dtype == torch.int64),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the earlier K3 failed to launch ({err})")
    return out


def k3_sector_floor_ms(clipped, row_bytes, idx_bytes):
    """The least time of K3 on rows that scatter: the indices in and the
    rows out once each, and every distinct 32-byte sector of the table that
    the (clipped) rows touch read once.  Also the count of those sectors."""
    import torch
    rows = torch.unique(clipped)
    first = rows * row_bytes // 32
    last = (rows * row_bytes + row_bytes - 1) // 32
    k = torch.arange((row_bytes + 31) // 32 + 1, device=rows.device)
    span = first[:, None] + k
    sectors = int(torch.unique(span[span <= last[:, None]]).numel())
    nbytes = clipped.numel() * (idx_bytes + row_bytes) + sectors * 32
    return nbytes / PEAK_BYTES * 1e3, sectors


def host_ms(fn, reps=15):
    """Median wall time of one fn() call ended by a synchronize: what the
    host pays to launch it as well as the device's time."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


# the search round whose dedup reads `phase_gather_kernels` takes from a real
# hill search (rounds count from 0; the planning path's searches run 12)
REAL_CELLS_ROUND = 6


def capture_search(device, round_no=REAL_CELLS_ROUND):
    """One search of the planning path at full width (hill map, default
    front-end sizing, 256 scenarios drawn as `scen_batch`), recording the
    inputs K4 is given: the two dedup tables and `cells` of round
    `round_no`, and the arena and start of the walk back."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.frontend import kino_init
    cfg, grid = headline.scene_setup(device=device)
    starts, goals = scen_batch(PLAN_BATCH, np.random.default_rng(1))
    seen, calls = {}, [0]
    many, walk = kino_init.gather_along_many, kino_init.walk_parents

    def record_many(xs, idx, axis=1):
        if len(xs) == 2:              # round_best and best_g at `cells`
            if calls[0] == round_no:
                seen["cells"] = ([x.clone() for x in xs], idx.clone())
            calls[0] += 1
        return many(xs, idx, axis)

    def record_walk(parent, start, steps):
        seen["walk"] = (parent.clone(), start.clone(), steps)
        return walk(parent, start, steps)

    kino_init.gather_along_many, kino_init.walk_parents = record_many, \
        record_walk
    try:
        res = kino_init.plan(grid, cfg.frontend, torch.as_tensor(
            starts, device=device), torch.as_tensor(goals, device=device))
    finally:
        kino_init.gather_along_many, kino_init.walk_parents = many, walk
    if "cells" not in seen or "walk" not in seen:
        raise RuntimeError(f"the search ran {calls[0]} rounds, fewer than "
                           f"{round_no + 1}")
    seen["rounds"] = int(res.rounds.max())
    return seen


def _forest(B, F, rounds, seed, device):
    """A parent arena [B, 1 + F * rounds] as the search leaves it when every
    scenario runs all its rounds: node 0 is the root (-1), a node of round r
    has a parent among round r - 1's F nodes (round 0's: node 0); and a
    start in the last round, so that the walk runs the whole depth."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    A = 1 + F * rounds
    lane = torch.randint(0, F, (B, A), generator=g, dtype=torch.int32)
    rnd = (torch.arange(A, dtype=torch.int32) - 1).div(
        F, rounding_mode="floor")
    parent = torch.where(rnd > 0, 1 + (rnd - 1) * F + lane, 0)
    parent[:, 0] = -1
    start = 1 + (rounds - 1) * F + torch.randint(0, F, (B,), generator=g,
                                                 dtype=torch.int32)
    return parent.to(device), start.to(device)


def phase_gather_kernels(device):
    """K3 and K4 (`gather_along`, `gather_along_many`, `walk_parents`)
    against their twins (must be equal bit for bit) at the TPU probes'
    shapes, the planning path's, the pipeline's and the tracking path's
    (MPC alone and pipeline), and K4 on the inputs of one real search,
    timed beside the twin, the parent's K4 (`ms_parent`) and the PyTorch
    library call on the same inputs (the library calls do not clip, so
    they get the indices clipped beforehand).  `ms`, `plain_ms` and
    `library_ms` are `device_ms` readings, calls back to back, as for K1 and
    K2; `ms` is the one held against the bound.  Where the table is too
    large to stay in the 50 MB L2 between two rounds of the search,
    `ms_cold` is the kernel's time with the L2 emptied before each call.
    The bound counts the indices read once, the output written once and each
    table row read at most once (a table smaller than the output is read
    once, not once per lookup)."""
    import torch
    from uneven_planner_tpu_torch.config import FrontendConfig
    from uneven_planner_tpu_torch.kernels import gather
    gen = torch.Generator(device="cpu").manual_seed(5)
    rand = lambda shape: torch.randn(shape, generator=gen).to(device)
    n_occ = 200 * 200
    m_occ = PLAN_BATCH * (10240 * 3 + 1024 * 64)
    variants = []

    def run(name, shape, kern, twin, lib, nbytes, cold, parent=None,
            **extra):
        got, want = kern(), twin()
        torch.cuda.synchronize()
        v = dict(name=name, shape=shape, equal=_all_equal(got, want),
                 max_abs_err=_exact_err(got, want), ms=device_ms(kern),
                 plain_ms=device_ms(twin),
                 library_ms=device_ms(lib) if lib is not None else None,
                 bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                 bytes=nbytes,
                 ms_cold=device_ms_cold(kern) if cold else None, **extra)
        if parent is not None:
            v["ms_parent"] = device_ms(parent)
            v["ms_cold_parent"] = device_ms_cold(parent) if cold else None
        log("# kernel " + json.dumps(v))
        variants.append(v)
        del got, want

    # K3 gather_rows: table [N, W] (or [N]), idx [M].  The tracking rows are
    # the piece coefficients `eval_traj` reads, [B * pieces, 6 * Dim] f32 by
    # int64: 30 reference samples per lane on every tick (figure-eight: 256
    # lanes x 16 pieces; pipeline: 64 lanes x 10 xy and 20 yaw pieces) and
    # the pipeline's 1024 samples per lane of `non_hol_error`; and the
    # figure-eight's in f64 (a float64 rollout).
    f32, f64 = torch.float32, torch.float64
    track_rows = [
        (f"{path}: [{B * n_p}, {6 * dim}] {name}, int64", (B * n_p, 6 * dim),
         B * T, dtype)
        for path, B, T, pieces, dtype, name in [
            ("mpc reference", MPC_LANES, 30, ((16, 2), (16, 1)), f32, "f32"),
            ("mpc reference", MPC_LANES, 30, ((16, 2), (16, 1)), f64, "f64"),
            ("pipeline reference", PIPE_LANES, 30, ((10, 2), (20, 1)), f32,
             "f32"),
            ("pipeline non_hol_error", PIPE_LANES, 1024, ((10, 2), (20, 1)),
             f32, "f32")]
        for n_p, dim in pieces]
    m_occ_pipe = PIPE_LANES * (10240 * 3 + 1024 * 64)
    # Beside the main paths' shapes: probe B's own ([1024, 128] by 256), a
    # 24-byte row at e1 C2's index count (8-byte words), and two views one
    # element off 16-byte alignment (`offsets`: index, output), for indices
    # off their vector alignment and an output that takes 4-byte words.
    # Word-path rows are timed beside K3 before its redesign (`ms_parent`)
    # and against the sector floor of the rows they touch.
    k3_before = before_library("k3_before").load()
    for label, table, M, idt, offsets in [
            ("e1_gather C: [32768, 8] f32", rand((32768, 8)), 2785280,
             torch.int32, None),
            ("e1_gather C2: [131072] f32", rand((131072,)), 2785280,
             torch.int32, None),
            ("e31 B/C: [1024, 128] f32", rand((1024, 128)), 184320,
             torch.int32, None),
            ("e31 B: [1024, 128] f32 by 256", rand((1024, 128)), 256,
             torch.int32, None),
            ("24-byte rows: [131072, 6] f32", rand((131072, 6)), 2785280,
             torch.int32, None),
            ("e1_gather C2, index and output one element in: [131072] f32",
             rand((131072,)), 2785280, torch.int32, (1, 1)),
            ("e1_gather C2, output one element in: [131072] f32",
             rand((131072,)), 2785280, torch.int32, (0, 1)),
            ("path occupancy: [40000] bool",
             torch.rand(n_occ, generator=gen).to(device) < 0.1, m_occ,
             torch.int32, None),
            ("pipeline occupancy: [40000] bool",
             torch.rand(n_occ, generator=gen).to(device) < 0.1, m_occ_pipe,
             torch.int32, None),
            ("path RXS2 rows: [2560000, 4] f32", rand((200 * 200 * 64, 4)),
             PLAN_BATCH * 4096 * 8, torch.int32, None),
            ("pipeline RXS2 rows: [2560000, 4] f32",
             rand((200 * 200 * 64, 4)), PIPE_LANES * 4096 * 8,
             torch.int32, None)] + [
            (label, rand(shape).to(dtype), M, torch.int64, None)
            for label, shape, M, dtype in track_rows]:
        N = table.shape[0]
        io, oo = offsets or (0, 0)
        idx = _edge_indices(N, (M + io,), 11, idt, device)[io:]
        out = torch.empty((M + oo,) + tuple(table.shape[1:]),
                          dtype=table.dtype, device=device)[oo:]
        clipped = idx.long().clamp(0, N - 1)
        row = table.element_size() * (table.shape[1] if table.dim() == 2
                                      else 1)
        kern = (lambda: gather.gather_rows(table, idx)) if offsets is None \
            else (lambda: gather._launch_rows(table, idx, out))
        word = {}
        if not gather.uses_shared_table(table):
            floor, sectors = k3_sector_floor_ms(clipped, row,
                                                idx.element_size())
            word = dict(parent=lambda: _k3_before(k3_before, table, idx),
                        sector_floor_ms=floor, sectors=sectors,
                        route=dict(word=gather.rows_word(
                            row, table.element_size(), table.data_ptr(),
                            kern().data_ptr())))
        run("gather_rows", label, kern,
            lambda: gather.gather_rows_twin(table, idx),
            lambda: torch.index_select(table, 0, clipped),
            M * (idx.element_size() + row) + min(N, M) * row,
            cold=N * row > 25e6, **word)
        del table, idx, clipped, out

    # K4 gather_along: x [B, N], idx [B, K] (axis 1) or x [N, C], idx [K, C].
    # The tracking rows are `locate_piece`'s reads of the cumulative piece
    # times, [B, pieces] by [B, samples] int64, beside K3's above (the
    # figure-eight's in f64 too).
    track_along = [
        (f"{path} locate_piece: [{B}, {n_p}] {name} by [{B}, {T}]",
         (B, n_p), (B, T), 1, torch.int64, dtype)
        for path, B, T, pieces, dtype, name in [
            ("mpc reference", MPC_LANES, 30, (16,), f32, "f32"),
            ("mpc reference", MPC_LANES, 30, (16,), f64, "f64"),
            ("pipeline reference", PIPE_LANES, 30, (10, 20), f32, "f32"),
            ("pipeline non_hol_error", PIPE_LANES, 1024, (10, 20), f32,
             "f32")]
        for n_p in pieces]
    k4_before = before_library("k4_before").load()
    for label, xs, ishape, axis, idt, xdt in [
            ("e5_dyngather lane: [4096, 128] axis 1", (4096, 128),
             (4096, 128), 1, torch.int32, f32),
            ("e5_dyngather sub: [4096, 128] axis 0", (4096, 128),
             (4096, 128), 0, torch.int32, f32),
            ("path pool[sel]: [256, 8192] by [256, 1024]",
             (PLAN_BATCH, 8192), (PLAN_BATCH, 1024), 1, torch.int64, f32),
            ("path best_g[cells]: [256, 440000] by [256, 10240]",
             (PLAN_BATCH, 440000), (PLAN_BATCH, 10240), 1, torch.int32,
             f32),
            ("pipeline pool[sel]: [64, 8192] by [64, 1024]",
             (PIPE_LANES, 8192), (PIPE_LANES, 1024), 1, torch.int64, f32),
            ("pipeline best_g[cells]: [64, 440000] by [64, 10240]",
             (PIPE_LANES, 440000), (PIPE_LANES, 10240), 1, torch.int32,
             f32)] + track_along:
        x = rand(xs).to(xdt)
        N = xs[axis]
        idx = _edge_indices(N, ishape, 13, idt, device)
        clipped = idx.long().clamp(0, N - 1)
        wide = x.numel() * x.element_size() > 25e6
        streams = idx.numel() * (idx.element_size() + x.element_size())
        run("gather_along", label,
            lambda: gather.gather_along(x, idx, axis),
            lambda: gather.gather_along_twin(x, idx, axis),
            lambda: torch.gather(x, axis, clipped),
            streams + min(idx.numel(), x.numel()) * x.element_size(),
            cold=wide, parent=lambda: _k4_before(k4_before, x, idx, axis),
            # where the table is beyond the L2, every scattered read costs
            # a 32-byte sector
            sector_floor_ms=(streams + idx.numel() * 32) / PEAK_BYTES * 1e3
            if wide else None)
        del x, idx, clipped

    # K4 on several arrays read at one index: the search's pool by `sel`
    # (int64) and by `keep` (int64), float32 fields and the int32 parent
    # mixed, and its two dedup tables at `cells` (int32), on the planning
    # path's 256 scenarios and the pipeline's 64.  The library column is
    # one torch.gather per array, the parent column one launch per array.
    i32 = torch.int32
    pool_types = [f32] * 7 + [i32]
    for path, B in (("path", PLAN_BATCH), ("pipeline", PIPE_LANES)):
        for label, dts, xs, ishape, idt in [
                (f"{path} pool[sel]: 8 x [{B}, 8192] by [{B}, 1024] int64",
                 pool_types, (B, 8192), (B, 1024), torch.int64),
                (f"{path} new_pool[keep]: 8 x [{B}, 18432] by [{B}, 8192] "
                 "int64", pool_types, (B, 18432), (B, 8192), torch.int64),
                (f"{path} round_best, best_g [cells]: 2 x [{B}, 440000] by "
                 f"[{B}, 10240] int32", [f32, f32], (B, 440000), (B, 10240),
                 i32)]:
            arrays = [(rand(xs) * 1e3).to(dt) for dt in dts]
            idx = _edge_indices(xs[1], ishape, 17, idt, device)
            clipped = idx.long().clamp(0, xs[1] - 1)
            elem = 4
            run("gather_along_many", label,
                lambda: gather.gather_along_many(arrays, idx),
                lambda: gather.gather_along_many_twin(arrays, idx),
                lambda: [torch.gather(a, 1, clipped) for a in arrays],
                idx.numel() * idx.element_size() + len(arrays) * elem * (
                    idx.numel() + min(idx.numel(), xs[0] * xs[1])),
                cold=xs[0] * xs[1] * elem > 25e6,
                parent=lambda: [_k4_before(k4_before, a, idx)
                                for a in arrays], arrays=len(arrays))
            del arrays, idx, clipped
    torch.cuda.empty_cache()

    # K4 on what a real hill search gives it: the dedup tables and `cells`
    # of one round (cells repeat and cluster, unlike the uniform indices
    # above; the bound counts each distinct cell once, the sector floor
    # each distinct 32-byte sector), and the walk back through its arena
    seen = capture_search(device)
    (round_best, best_g), cells = seen["cells"]
    B, n_cells = best_g.shape
    flat = (torch.arange(B, device=device)[:, None] * n_cells
            + cells.long().clamp(0, n_cells - 1))
    distinct = int(torch.unique(flat).numel())
    sectors = int(torch.unique(flat // 8).numel())
    streams = cells.numel() * 8
    real = f"search round {REAL_CELLS_ROUND} (real cells)"
    run("gather_along", f"{real} best_g[cells]: [{B}, {n_cells}] by "
        f"[{B}, {cells.shape[1]}] int32",
        lambda: gather.gather_along(best_g, cells),
        lambda: gather.gather_along_twin(best_g, cells),
        lambda: torch.gather(best_g, 1, cells.long()),
        streams + distinct * 4, cold=True,
        parent=lambda: _k4_before(k4_before, best_g, cells),
        sector_floor_ms=(streams + sectors * 32) / PEAK_BYTES * 1e3,
        distinct_cells=distinct, distinct_sectors=sectors,
        search_rounds=seen["rounds"])
    run("gather_along_many", f"{real} round_best, best_g [cells]: 2 x "
        f"[{B}, {n_cells}] by [{B}, {cells.shape[1]}] int32",
        lambda: gather.gather_along_many([round_best, best_g], cells),
        lambda: gather.gather_along_many_twin([round_best, best_g], cells),
        lambda: [torch.gather(a, 1, cells.long())
                 for a in (round_best, best_g)],
        cells.numel() * 4 + 2 * (cells.numel() * 4 + distinct * 4),
        cold=True, parent=lambda: [_k4_before(k4_before, a, cells)
                                   for a in (round_best, best_g)],
        arrays=2, distinct_cells=distinct)
    del round_best, best_g, cells, flat
    torch.cuda.empty_cache()

    # the walk: the real search's arena and shot nodes, and a synthetic
    # arena of the planning path's full size whose every walk runs all
    # R + 1 = 161 steps.  The bound counts the parent reads this data needs
    # (one per step taken, the last step's excepted), the starts and the
    # outputs.  The parent column is the loop the walk replaces, with the
    # parent's K4; `wall_ms` is host time, launches included.
    fe = FrontendConfig()
    walks = [("real search arena", *seen["walk"])]
    walks.append(("full depth", *_forest(PLAN_BATCH, fe.frontier_size,
                                         fe.max_rounds, 19, device),
                  fe.max_rounds + 1))
    for kind, parent_ids, start, steps in walks:
        Bw, A = parent_ids.shape

        def loop_before(parent_ids=parent_ids, start=start, steps=steps):
            node, chain, valid = start, [], []
            for _ in range(steps):
                nid = node.clamp(min=0)
                ok = node >= 0
                chain.append(nid)
                valid.append(ok)
                node = torch.where(
                    ok, _k4_before(k4_before, parent_ids, nid[:, None])[:, 0],
                    -1)
            return torch.stack(chain, dim=1), torch.stack(valid, dim=1)

        kern = lambda: gather.walk_parents(parent_ids, start, steps)
        taken = gather.walk_parents_twin(parent_ids, start, steps)[1] \
            .sum(dim=1).clamp(max=steps - 1)
        run("walk_parents", f"path arena walk ({kind}): [{Bw}, {A}], "
            f"{steps} steps", kern,
            lambda: gather.walk_parents_twin(parent_ids, start, steps), None,
            int(taken.sum()) * 4 + Bw * 4 + Bw * steps * 5, cold=False,
            parent=loop_before, wall_ms=host_ms(kern),
            wall_ms_parent=host_ms(loop_before),
            steps_taken_mean=float(taken.float().mean()))
    del seen, walks
    torch.cuda.empty_cache()
    bad = [v for v in variants if not v["equal"]
           or v["max_abs_err"] > TOL_GATHER]
    if bad:
        raise RuntimeError(f"gather kernel disagrees with its twin: {bad}")
    return variants


# ---------------------------------------------------------------------------
# the planning path
# ---------------------------------------------------------------------------

def scen_batch(n, rng):
    """n hill scenarios (start, goal poses [n, 3] float32), drawn as the JAX
    package's front-end benchmark draws them."""
    import numpy as np
    starts, goals = [], []
    for _ in range(n):
        ang = rng.uniform(-np.pi, np.pi)
        s = rng.uniform(-3.5, -1.5, size=2)
        g = np.clip(s + 2.5 * np.array([np.cos(ang), np.sin(ang)]),
                    -4.0, 4.0)
        yaw = np.arctan2(g[1] - s[1], g[0] - s[0])
        starts.append([s[0], s[1], yaw])
        goals.append([g[0], g[1], yaw])
    return (np.asarray(starts, np.float32), np.asarray(goals, np.float32))


def check_paths(grid, kres, starts, goals, max_step):
    """Host-side check of every successful lane: the path starts at the
    start, ends at the goal, takes bounded steps and touches no occupied or
    out-of-map cell.  Returns the list of faults."""
    import numpy as np
    occ = grid.occ_xy.cpu().numpy()
    path = kres.path.double().cpu().numpy()
    mask = kres.path_mask.cpu().numpy()
    success = kres.success.cpu().numpy()
    ox, oy, _ = grid.origin
    faults = []
    for b in np.nonzero(success)[0]:
        p = path[b][mask[b]]
        if len(p) < 2:
            faults.append(f"lane {b}: empty path")
            continue
        ix = np.floor((p[:, 0] - ox) / grid.xy_resolution).astype(int)
        iy = np.floor((p[:, 1] - oy) / grid.xy_resolution).astype(int)
        inside = (ix >= 0) & (ix < occ.shape[0]) & (iy >= 0) \
            & (iy < occ.shape[1])
        hit = ~inside | occ[ix.clip(0, occ.shape[0] - 1),
                            iy.clip(0, occ.shape[1] - 1)]
        if hit.any():
            faults.append(f"lane {b}: path in collision")
        if np.abs(p[0, :2] - starts[b, :2]).max() > 1e-4:
            faults.append(f"lane {b}: path does not start at the start")
        if np.abs(p[-1] - goals[b]).max() > 1e-4:
            faults.append(f"lane {b}: path does not end at the goal")
        step = np.linalg.norm(np.diff(p[:, :2], axis=0), axis=1).max()
        if step > max_step + 1e-4:
            faults.append(f"lane {b}: step of {step:.3f} m")
    if not mask[~success].sum() == 0:
        faults.append("a failed lane has a non-empty path mask")
    return faults


def phase_plan_reference(device):
    """8 scenarios on the coarse grid with both tables: the card (kernels)
    against the CPU (float64, plain twins), once with a float32 grid on the
    card and once with a float64 grid (the float64 instantiations of K1 and
    K2).  float32 flips discrete choices of the search, so it is held by
    outcome: success counts within one lane, every card path valid, costs
    within TOL_PLAN_REF_COST_F32, converged counts within one lane.  The
    float64 card makes the CPU's choices: success, search rounds and
    converged flags equal on every lane, costs within
    TOL_PLAN_REF_COST_F64, every card path valid."""
    import dataclasses
    import numpy as np
    from uneven_planner_tpu_torch.config import MapConfig, scene_config
    cfg = scene_config("hill")
    cfg = dataclasses.replace(
        cfg, map=MapConfig(xy_resolution=0.2, yaw_resolution=0.45),
        frontend=dataclasses.replace(cfg.frontend, frontier_size=128,
                                     max_rounds=60))
    starts, goals = scen_batch(8, np.random.default_rng(21))
    cpu = plan_reference_run(cfg, "cpu", np.float64, starts, goals)
    out = {}
    for dtype in ("float32", "float64"):
        card = plan_reference_run(cfg, device, getattr(np, dtype), starts,
                                  goals)
        out[dtype] = plan_reference_compare(cfg, card, cpu, starts, goals)
        log(f"# plan-ref {dtype} " + json.dumps(out[dtype]))
    for dtype, o in out.items():
        cost_tol = {"float32": TOL_PLAN_REF_COST_F32,
                    "float64": TOL_PLAN_REF_COST_F64}[dtype]
        slack = 1 if dtype == "float32" else 0
        if abs(o["success_card"] - o["success_cpu"]) > slack \
                or o["path_faults"] or o["success_card"] < 7 \
                or not o["finite"] \
                or (o["max_rel_cost_diff"] is not None
                    and o["max_rel_cost_diff"] > cost_tol) \
                or abs(o["converged_card"] - o["converged_cpu"]) > slack \
                or (dtype == "float64"
                    and (o["converged_equal_lanes"] != o["lanes"]
                         or o["rounds_card"] != o["rounds_cpu"])):
            raise RuntimeError(f"card planning ({dtype}) disagrees with the "
                               f"CPU: {o}")
    f64 = out["float64"]["launches_card"]
    for name in ("terrain_tv_packed16_f64", "terrain_tv_pair_f64"):
        if f64[name] == 0:
            raise RuntimeError(f"{name} was never launched on the float64 "
                               "plan")
    return out


def plan_reference_run(cfg, device, dtype, starts, goals):
    """(grid, KinoResult, ALMResult, launches) of `api.plan_batch` on the
    coarse hill grid in `dtype` with the pair and f16 tables, on `device`;
    the launch counters are set to 0 just before."""
    from uneven_planner_tpu_torch import api
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    from uneven_planner_tpu_torch.terrain.synthetic import \
        make_synthetic_grid
    grid = tgrid.with_packed_f16(tgrid.with_pair_table(
        make_synthetic_grid(cfg.map, dtype=dtype, device=device)))
    reset_all_launches()
    kres, ares = api.plan_batch(grid, cfg, starts, goals, device=device)
    return grid, kres, ares, all_launches()


def plan_reference_compare(cfg, card, cpu, starts, goals):
    import torch
    card_grid, k_card, a_card, launches = card
    _, k_cpu, a_cpu, _ = cpu
    s_card, s_cpu = k_card.success.cpu(), k_cpu.success
    both = s_card & s_cpu
    rel = ((k_card.cost.cpu().double() - k_cpu.cost).abs()
           / k_cpu.cost)[both]
    dx = (a_card.x.cpu().double() - a_cpu.x).abs().amax(1)[both]
    faults = check_paths(card_grid, k_card, starts, goals,
                         cfg.frontend.max_vel * cfg.frontend.time_interval)
    return dict(lanes=8, dtype=str(card_grid.data.dtype),
                success_card=int(s_card.sum()),
                success_cpu=int(s_cpu.sum()),
                rounds_card=k_card.rounds.tolist(),
                rounds_cpu=k_cpu.rounds.tolist(),
                max_rel_cost_diff=float(rel.max()) if both.any() else None,
                converged_card=int(a_card.converged.sum()),
                converged_cpu=int(a_cpu.converged.sum()),
                converged_equal_lanes=int((a_card.converged.cpu()
                                           == a_cpu.converged).sum()),
                evals_equal_lanes=int((a_card.evals.cpu()
                                       == a_cpu.evals).sum()),
                max_dx_both_planned=float(dx.max()) if both.any() else None,
                path_faults=faults,
                finite=bool(torch.isfinite(a_card.x[s_card.to(
                    a_card.x.device)]).all()),
                launches_card={k: launches[k] for k in (
                    "terrain_tv_packed16", "terrain_tv_pair",
                    "terrain_tv_packed16_f64", "terrain_tv_pair_f64")})


def phase_plan(device, smi):
    """The planning path at full width: hill full map with both tables,
    FrontendConfig() defaults, 256 scenarios, ProblemShape(10, 20, 16)."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import api, headline
    from uneven_planner_tpu_torch.frontend import kino_init
    from uneven_planner_tpu_torch.kernels import gather, terrain_lookup
    from uneven_planner_tpu_torch.minco import traj
    cfg, grid = headline.scene_setup(device=device)
    fe = cfg.frontend
    rng = np.random.default_rng(1)
    B = PLAN_BATCH
    warm, alone, timed = (scen_batch(B, rng) for _ in range(3))
    to = lambda a: torch.as_tensor(a, device=device)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    k0, a0 = api.plan_batch(grid, cfg, *warm)            # warm-up batch
    warm_ok = (k0.success.cpu().numpy(), a0.converged.cpu().numpy())
    warm_s = time.perf_counter() - t0
    del k0, a0

    t0 = time.perf_counter()                             # the search alone
    k1 = kino_init.plan(grid, fe, to(alone[0]), to(alone[1]))
    alone_success = k1.success.cpu().numpy()
    search_s = time.perf_counter() - t0
    alone_rounds = int(k1.rounds.max())
    del k1

    torch.cuda.synchronize()
    gather.reset_launches()
    terrain_lookup.reset_launches()
    t0 = time.perf_counter()                             # timed, counted
    kres, ares = api.plan_batch(grid, cfg, *timed)
    success = kres.success.cpu().numpy()
    conv = ares.converged.cpu().numpy()
    dt = time.perf_counter() - t0
    launches = {**terrain_lookup.launches, **gather.launches}
    k4_family = {k: launches[k] for k in K4_FAMILY}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    faults = check_paths(grid, kres, *timed, fe.max_vel * fe.time_interval)
    nh = traj.non_hol_error(ares.traj).cpu().numpy()
    mm = {k: v.cpu().numpy() for k, v in
          traj.max_metrics(ares.traj, grid).items()}
    good = success & conv
    worst = lambda k, f: float(f(mm[k][good])) if good.any() else None
    out = dict(
        batch=B, card=smi, frontend=dict(
            frontier_size=fe.frontier_size, max_rounds=fe.max_rounds),
        plans_per_s=B / dt, wall_s=dt,
        search_plans_per_s=B / search_s, search_wall_s=search_s,
        search_rounds=alone_rounds,
        search_ms_per_round=search_s / max(alone_rounds, 1) * 1e3,
        search_success_share_alone=float(alone_success.mean()),
        rounds_max=int(kres.rounds.max()),
        rounds_mean=float(kres.rounds.float().mean()),
        success_share=float(success.mean()),
        converged_share=float(conv.mean()),
        planned_and_converged_share=float(good.mean()),
        warmup_success_share=float(warm_ok[0].mean()),
        warmup_converged_share=float(warm_ok[1].mean()), warmup_s=warm_s,
        solver_steps=ares.steps,
        evals_mean=float(ares.evals.float().mean()),
        evals_max=int(ares.evals.max()),
        non_hol_error_mean=float(nh[good].mean()) if good.any() else None,
        non_hol_error_max=float(nh[good].max()) if good.any() else None,
        max_vx=worst("max_vx", np.max), max_ax=worst("max_ax", np.max),
        max_ay=worst("max_ay", np.max), max_cur=worst("max_cur", np.max),
        min_cxi=worst("min_cxi", np.min), max_sig=worst("max_sig", np.max),
        launches=launches,
        k4_family_launches=dict(k4_family, total=sum(k4_family.values())),
        path_faults=faults[:8], n_path_faults=len(faults),
        finite=bool(torch.isfinite(ares.x[kres.success]).all()),
        x_shape=list(ares.x.shape), peak_mem_gb=peak)
    log("# plan " + json.dumps(out))
    fails = []
    if out["success_share"] < 0.95:
        fails.append("search success under 95%")
    if out["planned_and_converged_share"] < 0.95:
        fails.append("fewer than 95% of scenarios planned and converged")
    if faults:
        fails.append(f"{len(faults)} path faults: {faults[:4]}")
    for name in ("terrain_tv_packed16", "terrain_tv_pair", "gather_rows",
                 *K4_FAMILY):
        if launches[name] == 0:
            fails.append(f"{name} was never launched on the planning path")
    if not out["finite"] or out["x_shape"] != [B, 38]:
        fails.append("non-finite or misshapen solver output")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out, (cfg, grid, timed)


def phase_plan_profile(ctx):
    """Kernel time by name, the device's busy share and the launches per
    round over one full-width search."""
    import torch
    from uneven_planner_tpu_torch.frontend import kino_init
    from uneven_planner_tpu_torch.kernels import gather
    from uneven_planner_tpu_torch.utils import profiling
    cfg, grid, (starts, goals) = ctx
    to = lambda a: torch.as_tensor(a, device=grid.device)
    torch.cuda.synchronize()
    gather.reset_launches()
    with device_profile() as prof:
        t0 = time.perf_counter()
        k = kino_init.plan(grid, cfg.frontend, to(starts), to(goals))
        rounds = int(k.rounds.max())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, rows = profiling.device_time_by_kernel(prof)
    # the loop runs to the first poll of the `done` flags after the last
    # live round
    poll = kino_init.POLL_EVERY
    rounds_run = min(cfg.frontend.max_rounds, -(-rounds // poll) * poll)
    device_calls = sum(c for _, _, c in rows)
    k4 = {name: gather.launches[name] for name in K4_FAMILY}
    out = dict(rounds=rounds, rounds_run=rounds_run, wall_s=wall,
               device_ms=total / 1e3,
               device_busy_share=total / 1e6 / wall,
               device_calls=device_calls,
               device_calls_per_round=device_calls / max(rounds_run, 1),
               k4_family_launches=dict(k4, total=sum(k4.values())),
               k4_family_launches_per_round=(
                   k4["gather_along"] + k4["gather_along_many"])
               / max(rounds_run, 1),
               port_kernels={
                   name: dict(device_ms=sum(u for u, k, _ in rows
                                            if name in k) / 1e3,
                              calls=sum(c for _, k, c in rows if name in k))
                   for name in ("tv_packed16_", "gather_rows_words_kernel",
                                "gather_bytes_smem_kernel",
                                "gather_along_kernel",
                                "walk_parents_kernel")},
               top=[dict(kernel=k[:80], device_ms=u / 1e3, calls=c)
                    for u, k, c in rows[:10]])
    log("# plan-profile " + json.dumps(out))
    return out

# ---------------------------------------------------------------------------
# K5 tanh_affine and K6 admm_iterations
# ---------------------------------------------------------------------------

def phase_elementwise_kernel(device):
    """K5 against its twin at the TPU probe's shape and at a large one.  The
    twin is two PyTorch calls (tanh, then a fused multiply-add kernel at
    best); no single PyTorch call computes the function, so its time stands
    in the library column and is marked as such."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.kernels import elementwise
    gen = torch.Generator(device="cpu").manual_seed(9)
    variants = []
    for label, shape in [("e31 probe A: [256, 512] f32", (256, 512)),
                         ("large: [4096, 8192] f32", (4096, 8192))]:
        x = (torch.randn(shape, generator=gen) * 3.0).to(device)
        x.view(-1)[0] = 1.0                      # the probe's own input
        before = elementwise.launches["tanh_affine"]
        got = elementwise.tanh_affine(x, 2.0, 1.0)
        pure = elementwise.tanh_affine(x, 1.0, 0.0)
        torch.cuda.synchronize()
        want = elementwise.tanh_affine_twin(x, 2.0, 1.0)
        bits = lambda a: a.view(torch.int32).long()
        key = lambda i: torch.where(i < 0, -(i & 0x7fffffff), i)
        ulp = int((key(bits(pure)) - key(bits(torch.tanh(x)))).abs().max())
        ref = np.tanh(x.cpu().numpy().astype(np.float64)) * 2.0 + 1.0
        n = x.numel()
        nbytes = 2 * 4 * n
        plain = device_ms(lambda: elementwise.tanh_affine_twin(x, 2.0, 1.0))
        v = dict(name="tanh_affine", shape=label,
                 max_abs_err=float((got - want).abs().max()),
                 max_ulp_tanh=ulp,
                 max_abs_err_numpy=float(np.abs(got.cpu().numpy() - ref)
                                         .max()),
                 launched=elementwise.launches["tanh_affine"] - before,
                 ms=device_ms(lambda: elementwise.tanh_affine(x, 2.0, 1.0)),
                 plain_ms=plain, library_ms=plain,
                 library="the twin (two PyTorch calls)",
                 bound_ms=max(nbytes / PEAK_BYTES,
                              n * OPS_TANH / PEAK_F32) * 1e3,
                 bound_by=("bytes" if nbytes / PEAK_BYTES
                           >= n * OPS_TANH / PEAK_F32 else "operations"),
                 bytes=nbytes)
        log("# kernel " + json.dumps(v))
        variants.append(v)
        del x, got, pure, want
    bad = [v for v in variants if v["max_ulp_tanh"] > TOL_TANH_ULP
           or v["max_abs_err"] > TOL_TANH_ABS
           or v["max_abs_err_numpy"] > 2 * TOL_TANH_ABS or v["launched"] != 2]
    if bad:
        raise RuntimeError(f"tanh_affine disagrees with its twin: {bad}")

    # The probe's own program (experiments/e31_pallas.py probe A), the only
    # "path" this kernel has: ones [256, 512] through the kernel, held
    # against numpy as the probe holds it, with the launches counted.
    elementwise.reset_launches()
    y = elementwise.tanh_affine(torch.ones((256, 512), device=device), 2.0,
                                1.0).cpu().numpy()
    probe = dict(launches=elementwise.launches["tanh_affine"],
                 max_abs_err_numpy=float(np.abs(y - (np.tanh(1.0) * 2 + 1))
                                         .max()))
    log("# probe-a " + json.dumps(probe))
    if probe["launches"] != 1 or not np.allclose(y, np.tanh(1.0) * 2 + 1):
        raise RuntimeError(f"probe A's program failed: {probe}")
    return variants, probe


def _f8_starts(n, rng):
    """Perturbed start states on the figure-eight, drawn as the JAX
    package's MPC benchmark draws them."""
    import numpy as np
    s0 = np.zeros((n, 3), np.float32)
    s0[:, 0] = rng.uniform(-0.05, 0.05, size=n)
    s0[:, 1] = rng.uniform(-0.05, 0.05, size=n)
    s0[:, 2] = np.pi / 4 + rng.uniform(-0.1, 0.1, size=n)
    return s0


def _tick_qps(device, lanes=MPC_LANES, warm_ticks=12):
    """The two first QPs of a real tracking tick: `lanes` controllers on the
    figure-eight are run for `warm_ticks` ticks, then the next tick's
    reference is sampled and its first relinearisation pass (primal warm
    start, zero duals) and second pass (primal and dual warm start) are
    assembled as `mpc_step` assembles them.  Returns [(label, unscaled QP,
    x0, y0)]."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.config import MPCConfig
    from uneven_planner_tpu_torch.minco.traj import expand_traj
    from uneven_planner_tpu_torch.mpc import tracker, traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    from uneven_planner_tpu_torch.solver import admm_qp
    cfg = MPCConfig()
    f8 = expand_traj(traj_msg.figure_eight(0.5, dtype=torch.float32,
                                           device=device), lanes)
    s0 = torch.as_tensor(_f8_starts(lanes, np.random.default_rng(31)),
                         device=device)
    s = rollout.roll_init(s0, cfg)
    for _ in range(warm_ticks):
        s, _, _ = rollout.tick(f8, s, cfg, 0.01, 3, None)
    refs, _ = tracker.get_ref_points(f8, s.t, cfg)
    refs = tracker.smooth_yaw(refs, s.state[:, 2])
    dref = torch.zeros_like(refs[:, :2])
    kw = dict(rho=cfg.qp_rho, sigma=cfg.qp_sigma, alpha=cfg.qp_alpha,
              eps_abs=cfg.qp_abs_tol, eps_rel=cfg.qp_rel_tol,
              max_iter=cfg.qp_max_iter, polish=False, adaptive_rho=False,
              fixed_iters=cfg.qp_scan_iters)
    out, cases = s.output, []
    y = s0.new_zeros((lanes, 4 * cfg.predict_steps - 2))
    for label in ("tick pass 1 (x warm, y = 0)", "tick pass 2 (x, y warm)"):
        xbar = tracker.predict_motion(s.state, out, cfg)
        qp = tracker.assemble_qp_condensed(xbar, out, refs, dref, cfg)
        x0 = out.transpose(1, 2).reshape(lanes, -1)
        cases.append((label, tuple(a.contiguous() for a in qp), x0, y))
        sol = admm_qp.solve_qp(*qp, x0=x0, y0=y, **kw)
        out = sol.x.reshape(lanes, cfg.predict_steps, 2).transpose(1, 2)
        y = sol.y
    return cases, cfg


def tick_qp(condense, lanes, dtype, device, seed=0, warm_ticks=2):
    """The first QP of a tracking tick as `mpc_step` assembles it, unscaled
    (P, q, A, l, u, with the tracker's broadcast views): `lanes` controllers
    on the figure-eight, `warm_ticks` ticks after their start states (at
    rest some entries of A are zero), the condensed (n = 60, m = 118) or the
    full QP (n = 150, m = 208); returns the QP and the config."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.config import MPCConfig
    from uneven_planner_tpu_torch.minco.traj import expand_traj
    from uneven_planner_tpu_torch.mpc import tracker, traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    cfg = MPCConfig(qp_condense=condense)
    f8 = expand_traj(traj_msg.figure_eight(0.5, dtype=dtype, device=device),
                     lanes)
    rng = np.random.default_rng(seed)
    s0 = np.zeros((lanes, 3))
    s0[:, :2] = rng.uniform(-0.05, 0.05, (lanes, 2))
    s0[:, 2] = np.pi / 4 + rng.uniform(-0.1, 0.1, lanes)
    s = rollout.roll_init(torch.tensor(s0, dtype=dtype, device=device), cfg)
    for _ in range(warm_ticks):
        s, _, _ = rollout.tick(f8, s, cfg, 0.01, 3, None)
    refs, _ = tracker.get_ref_points(f8, s.t, cfg)
    refs = tracker.smooth_yaw(refs, s.state[:, 2])
    xbar = tracker.predict_motion(s.state, s.output, cfg)
    assemble = tracker.assemble_qp_condensed if condense \
        else tracker.assemble_qp
    return assemble(xbar, s.output, refs, torch.zeros_like(refs[:, :2]),
                    cfg), cfg


def _random_box_qps(device, lanes=MPC_LANES, n=60, m=118, seed=17):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(lanes, n, n))
    P = L @ L.transpose(0, 2, 1) + n * np.eye(n)
    to = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return tuple(map(to, (P, rng.normal(size=(lanes, n)) * 3,
                          rng.normal(size=(lanes, m, n)),
                          -np.abs(rng.normal(size=(lanes, m))) - 0.1,
                          np.abs(rng.normal(size=(lanes, m))) + 0.1)))


def _tick_qps_full(device, lanes=MPC_LANES, warm_ticks=12, seed=31):
    """The first QP pass of a real tracking tick with the full QP (n = 150,
    m = 208): `lanes` controllers on the figure-eight from start states
    drawn with `seed`, run for `warm_ticks` ticks with
    `MPCConfig(qp_condense=False)`, then the next tick's first
    relinearisation pass assembled as `mpc_step` assembles it (primal warm
    start from the nonlinear rollout and the inputs, zero duals), float32.
    Returns (unscaled QP, x0, y0, cfg)."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.config import MPCConfig
    from uneven_planner_tpu_torch.minco.traj import expand_traj
    from uneven_planner_tpu_torch.mpc import tracker, traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    cfg = MPCConfig(qp_condense=False)
    f8 = expand_traj(traj_msg.figure_eight(0.5, dtype=torch.float32,
                                           device=device), lanes)
    s0 = torch.as_tensor(_f8_starts(lanes, np.random.default_rng(seed)),
                         device=device)
    s = rollout.roll_init(s0, cfg)
    for _ in range(warm_ticks):
        s, _, _ = rollout.tick(f8, s, cfg, 0.01, 3, None)
    refs, _ = tracker.get_ref_points(f8, s.t, cfg)
    refs = tracker.smooth_yaw(refs, s.state[:, 2])
    d = cfg.delay_num
    xbar = tracker.predict_motion(s.state, s.output, cfg)
    qp = tracker.assemble_qp(xbar, s.output, refs, torch.zeros_like(
        refs[:, :2]), cfg)
    x0 = torch.cat([xbar[:, d + 1:].reshape(lanes, -1),
                    s.output[:, :, d:].transpose(1, 2).reshape(lanes, -1)],
                   dim=1)
    y0 = torch.zeros_like(qp[3])
    return tuple(a.contiguous() for a in qp), x0, y0, cfg


def _rel(a, b):
    """Largest |a - b| of a lane relative to the lane's largest |b|."""
    scale = b.abs().amax(-1, keepdim=True).clamp(min=1e-3)
    return float(((a - b).abs() / scale).max())


def _round_mantissa(t, bits):
    """float32 `t` rounded to `bits` explicit mantissa bits (10: TF32,
    7: bfloat16), kept in float32."""
    import torch
    drop = 23 - bits
    i = t.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def k6_f32_readings(d, st, n_iters, kw, which, nnz=None):
    """The named instantiation of K6 ("sparse" or "global") in float32
    against the twin over `n_iters` iterations with the termination test
    off (`kw`), and the readings its gate was set from: kernel and twin
    each against the twin run in float64 on the same data, and two
    controls in lower precision, the twin with P, A and the inverse rounded
    to TF32's and to bfloat16's mantissa, each against the twin.  Distances
    relative to the lane's largest entry; a control's is the larger of x's
    and y's."""
    import torch
    from uneven_planner_tpu_torch.kernels import admm
    got = admm.launch_variant(which, d, st, n_iters=n_iters, nnz=nnz, **kw)
    want = admm.admm_iterations_twin(d, st, n_iters=n_iters, **kw)
    cast = lambda t, f: f(t) if t.is_floating_point() else t
    ref = admm.admm_iterations_twin(
        type(d)(*[cast(a, torch.Tensor.double) for a in d]),
        type(st)(*[cast(a, torch.Tensor.double) for a in st]),
        n_iters=n_iters, **kw)
    out = dict(max_rel_err_x=_rel(got.x, want.x),
               max_rel_err_y=_rel(got.y, want.y),
               iters_differ=int((got.it != want.it).sum()),
               max_abs_err=float(max((got.x - want.x).abs().max(),
                                     (got.y - want.y).abs().max())))
    for who, r in (("kernel", got), ("twin", want)):
        out[f"{who}_vs_f64_rel_x"] = _rel(r.x.double(), ref.x)
        out[f"{who}_vs_f64_rel_y"] = _rel(r.y.double(), ref.y)
    for name, bits in (("tf32", 10), ("bf16", 7)):
        low = admm.admm_iterations_twin(
            d._replace(P=_round_mantissa(d.P, bits),
                       A=_round_mantissa(d.A, bits),
                       minv=_round_mantissa(d.minv, bits)),
            st, n_iters=n_iters, **kw)
        out[f"{name}_control_rel"] = max(_rel(low.x, want.x),
                                         _rel(low.y, want.y))
    return out


def admm_full_qp_rows(device):
    """K6's sparse and global instantiations against the twin on the full
    QP of a real tick: 256 lanes in float32 and the first 64 of them in
    float64, over a fixed count of iterations (no termination test), every
    lane at that count, and 25 + 375 iterations equal to 400 bit for bit.
    x and y within TOL_ADMM_REL_GLOBAL_F32 (float32) or TOL_ADMM_REL_F64
    (float64) of the twin; in float32 the two lower-precision controls of
    `k6_f32_readings` must lie beyond that limit, or the gate could not
    tell a kernel that lost precision.  `variant` must pick "sparse" for
    this QP.  Times, both instantiations in the same call on the same data
    (each named through `launch_variant`): the kernel and the twin (one
    captured graph) on the path's run, beside two bounds for the iterations
    this data needs: `bound_ms` from the nonzeros (2 (n^2 + 4 nnz(A) +
    nnz(P)) flops an iteration; Minv, the compressed P and A and the
    vectors moved once) and `dense_bound_ms` from the dense products
    (2 (4 m n + 2 n^2) flops; the dense matrices moved once), and the time
    the dense P and A take to stream from device memory once an iteration.
    Then the global instantiation's own path: `solve_qp` on dense QPs of
    the full QP's shape, which no compressed lane fits, with its launches
    counted."""
    import torch
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.solver import admm_qp
    qp, x0, y0, cfg = _tick_qps_full(device)
    n64 = ADMM_F64_LANES
    cases = [(torch.float32, TOL_ADMM_REL_GLOBAL_F32, qp, x0, y0),
             (torch.float64, TOL_ADMM_REL_F64,
              tuple(a[:n64].double() for a in qp), x0[:n64].double(),
              y0[:n64].double())]
    path_kw = dict(sigma=cfg.qp_sigma, alpha=cfg.qp_alpha,
                   eps_abs=cfg.qp_abs_tol, eps_rel=cfg.qp_rel_tol,
                   max_iter=cfg.qp_max_iter)
    budget = cfg.qp_scan_iters

    rows = []
    for dtype, tol, q, xw, yw in cases:
        setup = admm_qp.setup_qp(*q, rho=cfg.qp_rho, sigma=cfg.qp_sigma,
                                 x0=xw, y0=yw)
        d, st = setup.data, setup.state
        B, n, m = d.P.shape[0], d.P.shape[1], d.A.shape[1]
        nnz = admm.nonzero_counts(d)
        fixed_kw = dict(path_kw, eps_abs=0.0, eps_rel=0.0)
        elt = d.P.element_size()
        peak = PEAK_F32 if dtype == torch.float32 else PEAK_F64
        io_words = 2 * n + 4 * m + 1 + 2 * (n + 2 * m + 6)
        twin = lambda: admm.admm_iterations_twin(d, st, n_iters=budget,
                                                 **path_kw)
        plain_ms = device_ms(twin, reps=3, inner=1)
        for which in ("sparse", "global"):
            run_kw = dict(nnz=nnz) if which == "sparse" else {}
            launch = lambda n_iters, state=st: admm.launch_variant(
                which, d, state, n_iters=n_iters, **run_kw, **path_kw)
            if dtype == torch.float32:
                fixed = k6_f32_readings(d, st, budget, fixed_kw, which,
                                        **run_kw)
            else:
                got = admm.launch_variant(which, d, st, n_iters=budget,
                                          **run_kw, **fixed_kw)
                want = admm.admm_iterations_twin(d, st, n_iters=budget,
                                                 **fixed_kw)
                fixed = dict(
                    max_rel_err_x=_rel(got.x, want.x),
                    max_rel_err_y=_rel(got.y, want.y),
                    iters_differ=int((got.it != want.it).sum()),
                    max_abs_err=float(max((got.x - want.x).abs().max(),
                                          (got.y - want.y).abs().max())))
            torch.cuda.synchronize()
            run = launch(budget)
            part = launch(budget - 25, launch(25))
            torch.cuda.synchronize()
            split_equal = all(torch.equal(a, b) for a, b in zip(run, part))
            its = float(run.it.long().sum())
            flops = its * 2 * (n * n + 4 * nnz[0] + nnz[1])
            nbytes = B * (elt * (n * n + io_words)
                          + (elt + 2) * (nnz[0] + nnz[1]))
            dense_flops = its * 2 * (4 * m * n + 2 * n * n)
            dense_bytes = elt * B * (2 * n * n + m * n + io_words)
            streamed = elt * its * (2 * m * n + n * n)
            v = dict(
                name=f"admm_iterations_{which}",
                variant_picked=admm.variant(n, m, dtype, nnz),
                dtype=str(dtype).replace("torch.", ""),
                shape=f"full-QP tick pass 1 (x warm, y = 0): {B} lanes, "
                f"n = {n}, m = {m}, {str(dtype).replace('torch.', '')}, "
                f"budget {budget}",
                nonzeros_a=nnz[0], nonzeros_p=nnz[1],
                max_abs_err=fixed["max_abs_err"], fixed_count=fixed,
                tolerance_rel=tol, split_equal=split_equal,
                iters_mean=float(run.it.float().mean()),
                iters_max=int(run.it.max()),
                at_budget_share=float((run.it >= budget).float().mean()),
                finite=bool(torch.isfinite(run.x).all()),
                ms=device_ms(lambda: launch(budget), reps=5, inner=2),
                plain_ms=plain_ms, library_ms=None,
                bound_ms=max(flops / peak, nbytes / PEAK_BYTES) * 1e3,
                bound_by=("operations" if flops / peak >= nbytes / PEAK_BYTES
                          else "bytes"),
                dense_bound_ms=max(dense_flops / peak,
                                   dense_bytes / PEAK_BYTES) * 1e3,
                streamed_bytes_ms=streamed / PEAK_BYTES * 1e3,
                flops=flops, bytes=nbytes, dense_flops=dense_flops,
                dense_bytes=dense_bytes, streamed_bytes=streamed,
                shared_bytes_per_lane=(
                    admm.sparse_shared_bytes(n, m, *nnz, dtype)
                    if which == "sparse"
                    else admm.global_shared_bytes(n, m, dtype)[0]))
            log("# kernel " + json.dumps(v))
            rows.append(v)

    def strays(v):
        f, tol = v["fixed_count"], v["tolerance_rel"]
        # NaN fails the gate; a NaN control lies beyond it
        return (not max(f["max_rel_err_x"], f["max_rel_err_y"]) <= tol
                or any(f.get(f"{c}_control_rel", tol + 1) <= tol
                       for c in ("tf32", "bf16")))

    bad = [v for v in rows
           if v["variant_picked"] != "sparse" or strays(v)
           or v["fixed_count"]["iters_differ"] or not v["split_equal"]
           or not v["finite"]]
    if bad:
        raise RuntimeError(f"admm_iterations (sparse or global) disagrees "
                           f"with its twin, or its gate cannot tell a lower "
                           f"precision: {bad}")

    # the global instantiation's own path: solve_qp on dense QPs of the
    # full QP's shape (no compressed lane fits), counted
    dense = _random_box_qps(device, lanes=ADMM_F64_LANES, n=150, m=208)
    reset_all_launches()
    sol = admm_qp.solve_qp(*dense, rho=cfg.qp_rho, sigma=cfg.qp_sigma,
                           alpha=cfg.qp_alpha, eps_abs=cfg.qp_abs_tol,
                           eps_rel=cfg.qp_rel_tol, max_iter=cfg.qp_max_iter,
                           polish=False, adaptive_rho=False,
                           fixed_iters=budget)
    launches = all_launches()
    own = dict(path="solve_qp on dense box QPs of the full QP's shape: "
               f"{ADMM_F64_LANES} lanes, n = 150, m = 208, float32",
               launches=launches["admm_iterations_global"],
               launches_sparse=launches["admm_iterations_sparse"],
               finite=bool(torch.isfinite(sol.x).all()))
    log("# admm-global-path " + json.dumps(own))
    if own["launches"] != 1 or own["launches_sparse"] or not own["finite"]:
        raise RuntimeError(f"the dense full-shape QP did not go through "
                           f"K6's global instantiation once: {own}")
    for v in rows:
        if v["name"] == "admm_iterations_global":
            v["own_path"] = own
    return rows


def k6_bound(its, B, n, m):
    """(bound_ms, bound_by, flops, bytes) of one float32 launch of K6's
    shared-memory instantiations on B (n, m) QPs whose lanes run `its`
    [B] iterations: each lane's P, A, bounds and state read once and its
    solution written once, 2 (4 m n + 2 n^2) operations an iteration."""
    flops = float(its.sum()) * 2 * (4 * m * n + 2 * n * n)
    nbytes = 4 * B * (2 * n * n + m * n + 2 * n + 4 * m + 1
                      + 2 * (n + 2 * m + 6))
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_admm_kernel(device):
    """K6 against its twin on the same CUDA tensors: the QPs of a real
    tracking tick (256 lanes) and random SPD box QPs of the same shape,
    three runs each (see the tolerances at the top): a fixed count of
    iterations, a loose termination test, and the path's own test.  For the
    last, both solutions are also held against the f64 solution of the same
    QP computed on the CPU, by distance and by KKT residuals evaluated in
    f64; a run split 25 + 375 must equal one of 400 bit for bit.  Times: the
    kernel and the twin for the path's run (the twin as one captured graph
    of its ~17,000 kernels, so host launch cost is not counted), beside the
    bound for the iterations this data needs."""
    import torch
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.solver import admm_qp
    cases, cfg = _tick_qps(device)
    cases.append(("random box QPs, cold", _random_box_qps(device), None,
                  None))
    # the pipeline's batch width
    cases.append(_tick_qps(device, lanes=PIPE_LANES)[0][0])
    path_kw = dict(sigma=cfg.qp_sigma, alpha=cfg.qp_alpha,
                   eps_abs=cfg.qp_abs_tol, eps_rel=cfg.qp_rel_tol,
                   max_iter=cfg.qp_max_iter)
    budget = cfg.qp_scan_iters

    variants = []
    for label, qp, x0, y0 in cases:
        setup = admm_qp.setup_qp(*qp, rho=cfg.qp_rho, sigma=cfg.qp_sigma,
                                 x0=x0, y0=y0)
        d, s = setup.data, setup.state
        B, n, m = d.P.shape[0], d.P.shape[1], d.A.shape[1]

        def both(**over):
            kw = dict(path_kw, **over)
            got = admm.admm_iterations(d, s, n_iters=budget, **kw)
            want = admm.admm_iterations_twin(d, s, n_iters=budget, **kw)
            torch.cuda.synchronize()
            return got, want, dict(
                max_rel_err_x=_rel(got.x, want.x),
                max_rel_err_y=_rel(got.y, want.y),
                iters_equal_share=float((got.it == want.it).float().mean()),
                iters_differ=int((got.it != want.it).sum()),
                iters_max_diff=int((got.it - want.it).abs().max()),
                iters_mean=float(got.it.float().mean()),
                iters_max=int(got.it.max()))

        _, _, fixed = both(eps_abs=0.0, eps_rel=0.0)
        _, _, loose = both(eps_abs=ADMM_LOOSE_EPS, eps_rel=ADMM_LOOSE_EPS)
        got, want, stopped = both()

        # both against the f64 solution of the same QP, on the CPU
        cpu64 = lambda a: None if a is None else a.double().cpu()
        qp64 = [cpu64(a) for a in qp]
        star = admm_qp.solve_qp(
            *qp64, rho=cfg.qp_rho, sigma=cfg.qp_sigma, alpha=cfg.qp_alpha,
            eps_abs=1e-10, eps_rel=1e-10, max_iter=3000, x0=cpu64(x0),
            y0=cpu64(y0), polish=False, adaptive_rho=False)
        kkt = {}
        for who, st in (("kernel", got), ("twin", want)):
            xu = cpu64(setup.D * st.x)
            yu = cpu64(d.cinv[:, None] * setup.E * st.y)
            stat, prim, comp = admm_qp.kkt_residuals(*qp64, xu, yu)
            kkt[who] = dict(dx_f64=float((xu - star.x).abs().max()),
                            stat=float(stat.max()), prim=float(prim.max()),
                            comp=float(comp.max()))
        # split run: 25 + 375 against 400
        part = admm.admm_iterations(d, s, n_iters=25, **path_kw)
        part = admm.admm_iterations(d, part, n_iters=budget - 25, **path_kw)
        torch.cuda.synchronize()
        split_equal = all(torch.equal(a, b) for a, b in zip(got, part))

        its = got.it.long()
        bound_ms, bound_by, flops, nbytes = k6_bound(its, B, n, m)
        per_sm = -(-B // 132)      # lanes the busiest SM must run in turn
        kern = lambda: admm.admm_iterations(d, s, n_iters=budget, **path_kw)
        twin = lambda: admm.admm_iterations_twin(d, s, n_iters=budget,
                                                 **path_kw)
        v = dict(
            name="admm_iterations", shape=f"{label}: {B} lanes, n = {n}, "
            f"m = {m}, budget {budget}",
            max_abs_err=float(max((got.x - want.x).abs().max(),
                                  (got.y - want.y).abs().max())),
            fixed_count=fixed, loose_test=loose, path_test=stopped,
            at_budget_share=float((its >= budget).float().mean()),
            f64_iters_max=int(star.iters.max()), kkt=kkt,
            split_equal=split_equal,
            finite=bool(torch.isfinite(got.x).all()),
            ms=device_ms(kern, reps=15, inner=4),
            plain_ms=device_ms(twin, reps=3, inner=1), library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by,
            bound_ms_at_occupancy=float(its.max()) * per_sm * 2
            * (4 * m * n + 2 * n * n) / (PEAK_F32 / 132) * 1e3,
            flops=flops, bytes=nbytes,
            shared_bytes_per_lane=admm.shared_bytes(n, m))
        log("# kernel " + json.dumps(v))
        variants.append(v)
    bad = [v for v in variants
           if v["fixed_count"]["max_rel_err_x"] > TOL_ADMM_REL
           or v["fixed_count"]["max_rel_err_y"] > TOL_ADMM_REL
           or v["fixed_count"]["iters_differ"]
           or v["loose_test"]["iters_equal_share"] < MIN_EQUAL_ITERS_SHARE
           or v["loose_test"]["iters_max_diff"] > MAX_ITERS_DIFF
           or v["loose_test"]["max_rel_err_x"] > TOL_ADMM_REL_STOPPED
           or v["path_test"]["max_rel_err_x"] > TOL_ADMM_REL_STOPPED
           or not v["finite"] or not v["split_equal"]
           or v["kkt"]["kernel"]["dx_f64"]
           > 2 * v["kkt"]["twin"]["dx_f64"] + 1e-5
           or v["kkt"]["kernel"]["stat"] > 2 * v["kkt"]["twin"]["stat"] + 1e-4
           or v["kkt"]["kernel"]["prim"] > 2 * v["kkt"]["twin"]["prim"] + 1e-5]
    if bad:
        raise RuntimeError(f"admm_iterations disagrees with its twin: {bad}")
    return variants + admm_full_qp_rows(device)


RUIZ_ITERS = 10   # `ruiz_equilibrate`'s default, OSQP's


def ruiz_rtol(n, dtype):
    """K7 against its twin, relative, on every output: the one place they
    round differently is the mean of P's n column maxima in each cost
    scale g, summed in another order on each side; a sum of n terms >= 0 is
    within (n - 1) u of the exact sum whatever the order (u the unit
    roundoff), so two orders differ by at most 2 n u, and the ten g's, each
    carried into c, P and q and through the column maxima into the next
    iteration's scales, by at most twice that together."""
    import torch
    return 2 * RUIZ_ITERS * n * torch.finfo(dtype).eps


def _ruiz_gap(got, want):
    """The largest relative gap of got from want over want's finite entries
    that are not zero; inf where a NaN, an infinity or a zero of one side
    is not the other's."""
    import torch
    inf = want.isinf()
    if not (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.isinf(), inf)
            and torch.equal(got[inf], want[inf])
            and torch.equal(got == 0, want == 0)):
        return float("inf")
    nz = (want != 0) & want.isfinite()
    if not bool(nz.any()):
        return 0.0
    return float(((got[nz] - want[nz]).abs() / want[nz].abs()).max())


def ruiz_bytes(qp, out):
    """Bytes K7 must move: every input's storage read once (one lane's for
    an input broadcast over the lanes, lane stride 0) and every output
    written once."""
    stored = lambda t: (1 if t.stride(0) == 0 else t.shape[0]) \
        * t[0].numel() * t.element_size()
    return sum(map(stored, qp)) \
        + sum(t.numel() * t.element_size() for t in out)


def phase_ruiz_kernel(device):
    """K7 against its twin on the same CUDA tensors, on the first QP of a
    real tick at MPC_LANES lanes (`tick_qp`, as the tracker hands it to
    `setup_qp`) in both forms and both dtypes: the condensed QP in shared
    memory in float32 (the MPC phase's) and float64, the full QP in shared
    memory in float32 (the full-QP MPC's) and in place in device memory in
    float64 (the float64 full-QP reference's).  One iteration: D, E, Ab, lb
    and ub bit for bit (they come before any cost scale g), Pb, qb and c
    within `ruiz_rtol`; ten: every output within it.  Each call is one
    launch of the instantiation its shape and dtype name.  Times: K7 and its
    twin at ten iterations, beside the bound of `ruiz_bytes`."""
    import torch
    from uneven_planner_tpu_torch.kernels import ruiz
    from uneven_planner_tpu_torch.solver import admm_qp
    names = ("Pb", "qb", "Ab", "lb", "ub", "D", "E", "c")
    before_g = ("D", "E", "Ab", "lb", "ub")
    want_place = {(True, torch.float32): "shared",
                  (True, torch.float64): "shared",
                  (False, torch.float32): "shared",
                  (False, torch.float64): "global"}
    rows, bad = [], []
    for (condense, dtype), place in want_place.items():
        qp, _ = tick_qp(condense, MPC_LANES, dtype, device)
        B, n = qp[1].shape
        m = qp[3].shape[1]
        which = ruiz.instantiation(n, m, dtype)
        tol = ruiz_rtol(n, dtype)
        exact, gaps, launch_ok = {}, {}, True
        for iters in (1, RUIZ_ITERS):
            before = dict(ruiz.launches)
            got = ruiz.ruiz_equilibrate(*qp, iters=iters)
            grew = {k: ruiz.launches[k] - before[k] for k in before}
            launch_ok &= grew == {k: int(k in ("ruiz_equilibrate",
                                               f"ruiz_equilibrate_{which}"))
                                  for k in before}
            want = admm_qp.ruiz_equilibrate_twin(*qp, iters=iters)
            torch.cuda.synchronize()
            for name, a, b in zip(names, got, want):
                if iters == 1 and name in before_g:
                    exact[name] = torch.equal(a, b)
                else:
                    gaps[f"{name}_{iters}"] = _ruiz_gap(a, b)
        nbytes = ruiz_bytes(qp, got)
        v = dict(
            name="ruiz_equilibrate",
            qp="condensed" if condense else "full",
            dtype=str(dtype).replace("torch.", ""), instantiation=which,
            shape=f"first QP of a real tick: {B} lanes, n = {n}, m = {m}, "
            f"{str(dtype).replace('torch.', '')}, {which}",
            bit_for_bit_before_g=exact, max_rel_gap=max(gaps.values()),
            rel_gaps=gaps, tolerance_rel=tol, one_launch_a_call=launch_ok,
            ms=device_ms(lambda: ruiz.ruiz_equilibrate(*qp), reps=15,
                         inner=4),
            plain_ms=device_ms(lambda: admm_qp.ruiz_equilibrate_twin(*qp),
                               reps=3, inner=1),
            bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
            bytes=nbytes)
        log("# kernel " + json.dumps(v))
        rows.append(v)
        if which != place or not launch_ok or not all(exact.values()) \
                or not v["max_rel_gap"] <= tol:
            bad.append(v)
    if bad:
        raise RuntimeError(f"ruiz_equilibrate disagrees with its twin or "
                           f"was not launched as its shape says: {bad}")
    return rows


# ---------------------------------------------------------------------------
# the tracking path
# ---------------------------------------------------------------------------

def all_launches():
    from uneven_planner_tpu_torch.kernels import (admm, elementwise, gather,
                                                  ruiz, terrain_lookup)
    return {**terrain_lookup.launches, **gather.launches,
            **elementwise.launches, **admm.launches, **ruiz.launches}


def reset_all_launches():
    from uneven_planner_tpu_torch.kernels import (admm, elementwise, gather,
                                                  ruiz, terrain_lookup)
    for mod in (admm, elementwise, gather, ruiz, terrain_lookup):
        mod.reset_launches()


def qp_statistics(tres):
    """QP statistics of a TrackResult: iterations per pass, share of passes
    at the iteration budget, non-finite solutions."""
    passes = int(tres.sqp_iters.sum())
    return dict(
        qp_passes=passes,
        passes_per_tick_mean=float(tres.sqp_iters.float().mean()),
        qp_iters_per_pass_mean=float(tres.qp_iters.sum()) / max(passes, 1),
        qp_iters_per_pass_max=int(tres.qp_iters_max.max()),
        qp_at_budget_share=float(tres.qp_capped.sum()) / max(passes, 1),
        qp_nonfinite=int(tres.qp_failed.sum()))


def phase_track_reference(device):
    """4 lanes of figure-eight tracking, 40 ticks: card (fp32, K6) against
    CPU (fp32, plain twin).  The closed loop contracts, so the two stay
    together; they differ by the QP tolerance (1e-6 on residuals of size
    ~1) and by summation order.  Held: states within 2e-3 (m, rad),
    commands within 2e-2."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.config import MPCConfig
    from uneven_planner_tpu_torch.mpc import traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    cfg = MPCConfig()
    s0 = _f8_starts(4, np.random.default_rng(41))
    run = lambda dev: rollout.track_trajectory_batched(
        traj_msg.figure_eight(0.5, dtype=torch.float32, device=dev), s0, cfg,
        40, device=dev)
    card = run(device)
    # the CPU side is thousands of tiny tensor operations, which a thread
    # pool only slows down
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = run("cpu")
    finally:
        torch.set_num_threads(threads)
    out = dict(lanes=4, ticks=40,
               max_state_diff=float((card.states.cpu() - cpu.states).abs()
                                    .max()),
               max_cmd_diff=float((card.cmds.cpu() - cpu.cmds).abs().max()),
               mean_err_card=card.mean_err.tolist(),
               mean_err_cpu=cpu.mean_err.tolist(),
               qp_iters_card=int(card.qp_iters.sum()),
               qp_iters_cpu=int(cpu.qp_iters.sum()))
    log("# track-ref " + json.dumps(out))
    if not torch.isfinite(card.states).all() \
            or out["max_state_diff"] > 2e-3 or out["max_cmd_diff"] > 2e-2:
        raise RuntimeError(f"card tracking disagrees with the CPU: {out}")
    return out


def phase_track_full_reference(device):
    """4 lanes of figure-eight tracking with the full QP
    (`MPCConfig(qp_condense=False)`), 40 ticks: the CPU in float64 (plain
    twins) against the card in float32 (K6's sparse variant), held by
    outcome as the condensed run is: states within 2e-3 (m, rad), commands
    within 2e-2; and against the card in float64 (K3 and K4 on 8-byte
    elements, K6's sparse variant), which must agree within
    TRACK_F64_STATE_TOL and TRACK_F64_CMD_TOL.  Prints the QP iteration
    counts of the three runs and the launches of each card run."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.config import MPCConfig
    from uneven_planner_tpu_torch.mpc import traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    cfg = MPCConfig(qp_condense=False)
    s0 = _f8_starts(4, np.random.default_rng(41))
    run = lambda dev, dtype: rollout.track_trajectory_batched(
        traj_msg.figure_eight(0.5, dtype=dtype, device=dev), s0, cfg, 40,
        device=dev)
    reset_all_launches()
    card = run(device, torch.float32)
    launches = all_launches()
    reset_all_launches()
    card64 = run(device, torch.float64)
    launches64 = all_launches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = run("cpu", torch.float64)
    finally:
        torch.set_num_threads(threads)
    diff = lambda a, b: float((a.cpu().double() - b).abs().max())
    k6 = lambda la: {k: la[k] for k in ("admm_iterations",
                                        "admm_iterations_sparse",
                                        "admm_iterations_global")}
    k7 = lambda la: {k: la[k] for k in ("ruiz_equilibrate",
                                        "ruiz_equilibrate_shared",
                                        "ruiz_equilibrate_global")}
    out = dict(lanes=4, ticks=40, qp="full (n = 150, m = 208)",
               max_state_diff=diff(card.states, cpu.states),
               max_cmd_diff=diff(card.cmds, cpu.cmds),
               mean_err_card=card.mean_err.tolist(),
               mean_err_cpu=cpu.mean_err.tolist(),
               qp_iters_card=int(card.qp_iters.sum()),
               qp_iters_cpu=int(cpu.qp_iters.sum()),
               launches_card=dict(k6(launches), **k7(launches)),
               float64=dict(
                   max_state_diff=diff(card64.states, cpu.states),
                   max_cmd_diff=diff(card64.cmds, cpu.cmds),
                   tolerance=dict(state=TRACK_F64_STATE_TOL,
                                  cmd=TRACK_F64_CMD_TOL),
                   mean_err_card=card64.mean_err.tolist(),
                   qp_iters_card=int(card64.qp_iters.sum()),
                   qp_iters_cpu=int(cpu.qp_iters.sum()),
                   qp_iters_per_pass_card=qp_statistics(card64)[
                       "qp_iters_per_pass_mean"],
                   qp_iters_per_pass_cpu=qp_statistics(cpu)[
                       "qp_iters_per_pass_mean"],
                   passes_card=int(card64.sqp_iters.sum()),
                   passes_cpu=int(cpu.sqp_iters.sum()),
                   launches_card=dict(
                       k6(launches64), gather_rows=launches64["gather_rows"],
                       gather_along=launches64["gather_along"],
                       **k7(launches64))))
    log("# track-full-ref " + json.dumps(out))
    f64 = out["float64"]
    fails = []
    if not torch.isfinite(card.states).all() \
            or out["max_state_diff"] > 2e-3 or out["max_cmd_diff"] > 2e-2:
        fails.append("card fp32 full-QP tracking disagrees with the CPU")
    if not torch.isfinite(card64.states).all() \
            or not f64["max_state_diff"] <= TRACK_F64_STATE_TOL \
            or not f64["max_cmd_diff"] <= TRACK_F64_CMD_TOL:
        fails.append("card fp64 full-QP tracking disagrees with the CPU's")
    for who, la in (("fp32", launches), ("fp64", launches64)):
        if la["admm_iterations_sparse"] == 0 \
                or la["admm_iterations_sparse"] != la["admm_iterations"]:
            fails.append(f"not every K6 launch of the {who} run is sparse")
    for name in ("gather_rows", "gather_along"):
        if launches64[name] == 0:
            fails.append(f"{name} was never launched in the fp64 run")
    # K7: the float32 full QP in shared memory, the float64 one in place
    for who, la, place in (("fp32", launches, "shared"),
                           ("fp64", launches64, "global")):
        if la["ruiz_equilibrate"] == 0 or la["ruiz_equilibrate"] \
                != la[f"ruiz_equilibrate_{place}"]:
            fails.append(f"not every K7 launch of the {who} run is {place}")
    if fails:
        raise RuntimeError(f"{'; '.join(fails)}: {out}")
    return out


def phase_mpc(device, smi):
    """The tracking MPC alone at full width: figure_eight(max_vel) shared by
    256 lanes with perturbed start states, 256 ticks, 3 relinearisations,
    fp32.  One short warm-up, then the timed and counted run, then a
    profile of a few ticks."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.config import scene_config
    from uneven_planner_tpu_torch.minco.traj import expand_traj
    from uneven_planner_tpu_torch.mpc import traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    from uneven_planner_tpu_torch.utils import profiling
    scfg = scene_config("hill")
    cfg = scfg.mpc
    rng = np.random.default_rng(2)
    f8 = traj_msg.figure_eight(scfg.alm.max_vel, dtype=torch.float32,
                               device=device)
    rollout.track_trajectory_batched(f8, _f8_starts(MPC_LANES, rng), cfg, 4)
    s0 = _f8_starts(MPC_LANES, rng)

    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    tres = rollout.track_trajectory_batched(f8, s0, cfg, MPC_TICKS,
                                            max_sqp_iter=3)
    mean_err = tres.mean_err.cpu().numpy()
    dt = time.perf_counter() - t0
    launches = all_launches()

    # a profiled stretch of ticks from a warm controller state
    lanes = expand_traj(f8, MPC_LANES)
    s = rollout.roll_init(torch.as_tensor(s0, device=device), cfg)
    for _ in range(8):
        s, _, _ = rollout.tick(lanes, s, cfg, 0.01, 3, None)
    n_prof = 4
    torch.cuda.synchronize()
    with device_profile() as prof:
        t1 = time.perf_counter()
        for _ in range(n_prof):
            s, _, _ = rollout.tick(lanes, s, cfg, 0.01, 3, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    total, rows = profiling.device_time_by_kernel(prof)
    admm_us = sum(u for u, k, _ in rows if "admm_kernel" in k)
    prof_out = dict(
        ticks=n_prof, wall_ms_per_tick=wall / n_prof * 1e3,
        device_ms_per_tick=total / n_prof / 1e3,
        device_busy_share=total / 1e6 / wall,
        kernels_per_tick=sum(c for _, _, c in rows) / n_prof,
        admm_kernel_ms_per_tick=admm_us / n_prof / 1e3,
        admm_kernel_calls_per_tick=sum(
            c for _, k, c in rows if "admm_kernel" in k) / n_prof,
        top=[dict(kernel=k[:80], device_ms_per_tick=u / n_prof / 1e3,
                  calls_per_tick=c / n_prof) for u, k, c in rows[:8]])

    out = dict(
        lanes=MPC_LANES, ticks=MPC_TICKS, card=smi,
        ticks_per_s=MPC_LANES * MPC_TICKS / dt, wall_s=dt,
        ms_per_tick=dt / MPC_TICKS * 1e3,
        mean_track_err=float(mean_err.mean()),
        max_lane_track_err=float(mean_err.max()),
        final_err_mean=float(tres.errs[:, -1].mean()),
        **qp_statistics(tres), launches=launches,
        admm_launches_per_tick=launches["admm_iterations"] / MPC_TICKS,
        finite=bool(torch.isfinite(tres.states).all()
                    and torch.isfinite(tres.cmds).all()),
        states_shape=list(tres.states.shape), profile=prof_out)
    log("# mpc " + json.dumps(out))
    fails = []
    if not out["finite"] or out["states_shape"] != [MPC_LANES, MPC_TICKS, 3]:
        fails.append("non-finite or misshapen states")
    if not out["mean_track_err"] <= MAX_TRACK_ERR:
        fails.append(f"mean tracking error {out['mean_track_err']:.4f} m "
                     f"exceeds {MAX_TRACK_ERR}")
    if launches["admm_iterations"] == 0:
        fails.append("admm_iterations was never launched")
    if launches["admm_iterations"] != int(tres.sqp_iters.max(0).values.sum()):
        fails.append("K6 launches != relinearisation passes run")
    if not launches["ruiz_equilibrate_shared"] \
            == launches["ruiz_equilibrate"] == launches["admm_iterations"]:
        fails.append("K7 launches != K6 launches, or not all in shared "
                     "memory")
    for name in ("gather_rows", "gather_along"):
        if launches[name] == 0:
            fails.append(f"{name} was never launched on the tracking path")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


def phase_mpc_full(device, smi):
    """The tracking MPC with the full QP at full width: figure_eight shared
    by 256 lanes with the MPC phase's start states, 64 ticks (depth cut
    from 256), 3 relinearisations, `MPCConfig(qp_condense=False)`, fp32:
    every QP goes through K6's sparse variant.  The condensed QP runs the
    same ticks from the same states beside it: the two QPs share one
    optimum, so the tracking errors must agree within
    MAX_FULL_VS_CONDENSED_ERR."""
    import dataclasses
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.config import scene_config
    from uneven_planner_tpu_torch.mpc import traj_msg
    from uneven_planner_tpu_torch.sim import rollout
    scfg = scene_config("hill")
    cfg = dataclasses.replace(scfg.mpc, qp_condense=False)
    rng = np.random.default_rng(2)
    f8 = traj_msg.figure_eight(scfg.alm.max_vel, dtype=torch.float32,
                               device=device)
    rollout.track_trajectory_batched(f8, _f8_starts(MPC_LANES, rng), cfg, 2)
    s0 = _f8_starts(MPC_LANES, rng)

    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    tres = rollout.track_trajectory_batched(f8, s0, cfg, MPC_FULL_TICKS,
                                            max_sqp_iter=3)
    mean_err = tres.mean_err.cpu().numpy()
    dt = time.perf_counter() - t0
    launches = all_launches()
    cond = rollout.track_trajectory_batched(f8, s0, scfg.mpc, MPC_FULL_TICKS,
                                            max_sqp_iter=3)
    cond_err = float(cond.mean_err.mean())
    out = dict(
        lanes=MPC_LANES, ticks=MPC_FULL_TICKS, card=smi,
        qp="full (n = 150, m = 208)",
        ticks_per_s=MPC_LANES * MPC_FULL_TICKS / dt, wall_s=dt,
        ms_per_tick=dt / MPC_FULL_TICKS * 1e3,
        mean_track_err=float(mean_err.mean()),
        max_lane_track_err=float(mean_err.max()),
        condensed_mean_track_err_same_ticks=cond_err,
        full_minus_condensed_err=float(mean_err.mean()) - cond_err,
        **qp_statistics(tres), launches=launches,
        finite=bool(torch.isfinite(tres.states).all()
                    and torch.isfinite(tres.cmds).all()),
        states_shape=list(tres.states.shape))
    log("# mpc-full " + json.dumps(out))
    fails = []
    if not out["finite"] \
            or out["states_shape"] != [MPC_LANES, MPC_FULL_TICKS, 3]:
        fails.append("non-finite or misshapen states")
    if not out["mean_track_err"] <= MAX_TRACK_ERR:
        fails.append(f"mean tracking error {out['mean_track_err']:.4f} m "
                     f"exceeds {MAX_TRACK_ERR}")
    if not abs(out["full_minus_condensed_err"]) <= MAX_FULL_VS_CONDENSED_ERR:
        fails.append("full and condensed QP track apart by "
                     f"{out['full_minus_condensed_err']:.4f} m")
    if launches["admm_iterations_sparse"] \
            != int(tres.sqp_iters.max(0).values.sum()):
        fails.append("K6 sparse launches != relinearisation passes run")
    if launches["admm_iterations"] != launches["admm_iterations_sparse"]:
        fails.append("a K6 launch on the full QP was not the sparse one")
    if not launches["ruiz_equilibrate_shared"] \
            == launches["ruiz_equilibrate"] == launches["admm_iterations"]:
        fails.append("K7 launches != K6 launches on the full QP, or not all "
                     "in shared memory")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


def phase_pipeline(device, smi):
    """The plan -> track path at full width: hill map with both tables, 64
    scenarios, ProblemShape(10, 20, int_K=8), L-BFGS memory 16 and 250
    iterations, 500 control ticks, 3 relinearisations, MPCConfig()
    defaults, fp32.  One fresh batch, timed and counted; then its three
    stages once more, each alone, for the split of the time: the search and
    the solve whole, the tracking over its first PIPE_SPLIT_TICKS ticks,
    each tick's error held to the whole run's (the ticks of one closed loop
    repeat in order, so a prefix checks the stage as the whole does)."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import headline, manager
    from uneven_planner_tpu_torch.frontend import kino_init
    from uneven_planner_tpu_torch.parallel import pipeline
    from uneven_planner_tpu_torch.sim import rollout
    from uneven_planner_tpu_torch.solver import alm
    cfg, grid = headline.scene_setup(device=device)
    starts, goals = scen_batch(PIPE_LANES, np.random.default_rng(3))
    shape = alm.ProblemShape(10, 20, int_K=8)
    overrides = {"mem_size": 16, "max_iterations": 250}
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    res = pipeline.plan_track_batch(
        grid, cfg, starts, goals, shape, n_track_steps=PIPE_TICKS,
        lbfgs_overrides=overrides, max_sqp_iter=3)
    ok = (res.plan_success & res.alm_converged).cpu().numpy()
    err = res.mean_track_err.cpu().numpy()
    dt = time.perf_counter() - t0
    launches = all_launches()
    final = res.final_track_err.cpu().numpy()

    # the split: the pipeline's three stages once more, each alone on the
    # same scenarios through its public function, each ended by a host read
    to = lambda a: torch.as_tensor(a, device=device)
    t0 = time.perf_counter()
    kres = kino_init.plan(grid, cfg.frontend, to(starts), to(goals))
    same = bool(torch.equal(kres.success, res.plan_success))
    t1 = time.perf_counter()
    x0, bound = manager.init_guess_fixed_device(
        kres.path, kres.path_mask, cfg.manager, shape.piece_xy,
        shape.piece_yaw)
    ares = alm.solve_flat(x0, bound, shape, grid, cfg.alm,
                          lbfgs_overrides=overrides)
    same = same and bool(torch.equal(ares.converged, res.alm_converged))
    t2 = time.perf_counter()
    tres = rollout.track_trajectory_batched(
        res.traj, starts, cfg.mpc, PIPE_SPLIT_TICKS, max_sqp_iter=3,
        traj_batched=True)
    drift = float((tres.errs - res.track.errs[:, :PIPE_SPLIT_TICKS]).abs()
                  .max())
    t3 = time.perf_counter()
    secs = dict(search=t1 - t0, solve=t2 - t1, track=t3 - t2,
                track_ticks=PIPE_SPLIT_TICKS, solver_steps=ares.steps,
                same_flags_as_the_whole_run=same,
                max_tick_err_diff_to_the_whole_run=drift)
    out = dict(
        scenarios=PIPE_LANES, ticks=PIPE_TICKS, card=smi,
        scenarios_per_s=PIPE_LANES / dt, wall_s=dt, stage_seconds=secs,
        track_ms_per_tick_first100=secs["track"] / PIPE_SPLIT_TICKS * 1e3,
        plan_success_share=float(res.plan_success.float().mean()),
        alm_converged_share=float(res.alm_converged.float().mean()),
        planned_and_converged_share=float(ok.mean()),
        mean_track_err=float(err[ok].mean()) if ok.any() else None,
        max_track_err=float(err[ok].max()) if ok.any() else None,
        final_track_err_mean=float(final[ok].mean()) if ok.any() else None,
        non_hol_mean=float(res.non_hol.cpu().numpy()[ok].mean())
        if ok.any() else None,
        at_goal_share_last_tick=float(res.track.at_goal[:, -1].float()
                                      .mean()),
        **qp_statistics(res.track), launches=launches,
        finite=bool(np.isfinite(err).all() and np.isfinite(final).all()),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("# pipeline " + json.dumps(out))
    fails = []
    if out["planned_and_converged_share"] < 0.95:
        fails.append("fewer than 95% of scenarios planned and converged")
    if not same or not drift <= 1e-3:
        fails.append("the stages run alone do not repeat the whole run")
    if not out["finite"]:
        fails.append("non-finite tracking error")
    if out["mean_track_err"] is None \
            or not out["mean_track_err"] <= MAX_TRACK_ERR:
        fails.append(f"mean tracking error of the good lanes "
                     f"{out['mean_track_err']} exceeds {MAX_TRACK_ERR} m")
    for name in ("terrain_tv_packed16", "terrain_tv_pair", "gather_rows",
                 *K4_FAMILY, "admm_iterations"):
        if launches[name] == 0:
            fails.append(f"{name} was never launched on the pipeline")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


# ---------------------------------------------------------------------------
# the reference's nested solve, and the split-bf16 table
# ---------------------------------------------------------------------------

def nested_reference_setup(device, dtype="float32"):
    """(cfg, card grid, CPU grid, shape, x0, bound) of the 8-lane
    card-vs-CPU check: the coarse hill grid with the pair and f16 tables,
    ProblemShape(6, 12, 8), straight-line scenarios as the headline draws
    them, all in `dtype` on both sides."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.config import MapConfig
    from uneven_planner_tpu_torch.solver import alm
    coarse = MapConfig(xy_resolution=0.2, yaw_resolution=0.45)
    np_dtype = getattr(np, dtype)
    cfg, grid = headline.scene_setup(coarse, device=device, dtype=np_dtype)
    _, cpu_grid = headline.scene_setup(coarse, device="cpu", dtype=np_dtype)
    shape = alm.ProblemShape(6, 12, 8)
    x0, bnd, _ = headline.make_batch(8, cfg, shape,
                                     np.random.default_rng(13),
                                     device=device,
                                     dtype=getattr(torch, dtype))
    return cfg, grid, cpu_grid, shape, x0, bnd


def ulp_unstable(run, x0, counts, eps=ULP_EPS):
    """[B] bool: the lanes whose `counts(run(x))` (a [k, B, ...] tensor)
    change when x0 moves by each of `eps`."""
    import torch
    ref = counts(run(x0))
    moved = torch.zeros(ref.shape[1], dtype=torch.bool)
    for e in eps:
        c = counts(run(x0 * (1.0 + e)))
        moved |= (c != ref).reshape(c.shape[0], c.shape[1], -1).any(2) \
            .any(0)
    return moved


def phase_nested_reference(device):
    """The nested path on 8 lanes of the coarse grid, card against CPU, in
    float32 on both sides (with `debug_iterates`) and in float64 on both
    sides (the float64 instantiations of K1 and K2 on the card); see
    `nested_reference`."""
    f32 = nested_reference(device, "float32", ULP_EPS, iterates=True)
    f64 = nested_reference(device, "float64", ULP_EPS_F64, iterates=False,
                           tol_x=TOL_NESTED_X_F64,
                           exception=(NESTED_F64_EXCEPTION_LANES,
                                      NESTED_F64_EXCEPTION_EPS))
    return {"float32": f32, "float64": f64}


def nested_reference(device, dtype, eps, iterates, tol_x=TOL_NESTED_X,
                     exception=((), ())):
    """`alm.solve`, `solve_compacted` (buckets (1, 2, 4)) and, with
    `iterates`, `debug_iterates` (4 lanes x 64 evaluations) on 8 lanes of
    the coarse grid on the card (kernels) against the same calls of the
    port on the CPU (plain twins), both in `dtype`.  Per lane, converged
    and L-BFGS status must be equal; outer rounds equal and x within
    `tol_x` on the lanes whose CPU counts (converged, outer rounds,
    status) no `eps` change of x0 moves (1-2 ulps of the dtype); the
    others, which are named, within one round and TOL_NESTED_X.
    `exception` = (lanes, probe): lanes held like the ulp-unstable ones as
    long as a `probe` change of x0 moves their CPU counts, and failed when
    it no longer does.  debug_iterates: the (round, iteration, valid) rows
    equal and the iterates within TOL_NESTED_ROWS on the lanes whose CPU
    rows no `eps` change moves."""
    import torch
    from uneven_planner_tpu_torch.solver import alm
    cfg, grid, cpu_grid, shape, x0, bnd = nested_reference_setup(device,
                                                                 dtype)
    cpu = lambda t: alm.tree_map(lambda a: a.cpu(), t)
    ovr = {"mem_size": 8, "max_iterations": 40}
    solve = lambda x, b, g: alm.solve(x, b, shape, g, cfg.alm,
                                      lbfgs_overrides=ovr)
    counts = lambda r: torch.stack([r.converged.long(), r.outer_iters,
                                    r.lbfgs_status])
    cpu_solve = lambda x: solve(x, cpu(bnd), cpu_grid)
    unstable = ulp_unstable(cpu_solve, x0.cpu(), counts, eps)
    fails = []
    except_lanes, probe = exception
    excepted = torch.zeros_like(unstable)
    excepted[list(except_lanes)] = True
    probed = ulp_unstable(cpu_solve, x0.cpu(), counts, probe) \
        if except_lanes else excepted
    if not bool(probed[excepted].all()):
        fails.append(f"excepted lanes {list(except_lanes)}: a change of "
                     f"{list(probe)} no longer moves their counts")
    loose = unstable | excepted
    out = dict(dtype=dtype, lanes=8, ulp_eps=list(eps),
               ulp_unstable_lanes=unstable.tolist(),
               excepted_lanes=list(except_lanes), exception_eps=list(probe),
               exception_probe_moves=probed[excepted].tolist(),
               tol_x_held_lanes=tol_x)
    for name, run in [
            ("solve", solve),
            ("solve_compacted", lambda x, b, g: alm.solve_compacted(
                x, b, shape, g, cfg.alm, lbfgs_overrides=ovr,
                buckets=(1, 2, 4)))]:
        reset_all_launches()
        card = run(x0, bnd, grid)
        launches = all_launches()
        ref = run(x0.cpu(), cpu(bnd), cpu_grid)
        d_outer = (card.outer_iters.cpu() - ref.outer_iters).abs()
        dx = (card.x.cpu() - ref.x).abs().amax(1)
        out[name] = dict(
            converged_card=int(card.converged.sum()),
            converged_cpu=int(ref.converged.sum()),
            outer_iters_card=card.outer_iters.tolist(),
            outer_iters_cpu=ref.outer_iters.tolist(),
            inner_iters_card=card.inner_iters.tolist(),
            inner_iters_cpu=ref.inner_iters.tolist(),
            lbfgs_status_card=card.lbfgs_status.tolist(),
            lbfgs_status_cpu=ref.lbfgs_status.tolist(),
            max_dx=dx.tolist(), steps_card=card.steps,
            polls_card=card.polls, launches_card=launches,
            outer_iters_differ_on_lanes=torch.nonzero(
                d_outer > 0).flatten().tolist())
        if launches["terrain_tv_pair"] == 0 or (
                dtype == "float64" and launches["terrain_tv_pair_f64"] == 0):
            fails.append(f"{name}: K2 was never launched on the card")
        bad = {"converged": card.converged.cpu() != ref.converged,
               "lbfgs_status": card.lbfgs_status.cpu() != ref.lbfgs_status,
               "outer_iters": (d_outer > 0) & ~loose | (d_outer > 1),
               "x": (dx > tol_x) & ~loose | (dx > TOL_NESTED_X)}
        out[name]["max_dx_held_lanes"] = float(dx[~loose].max()) \
            if (~loose).any() else None
        for k, v in bad.items():
            if v.any():
                fails.append(f"{name}: {k} differs on lanes "
                             f"{torch.nonzero(v).flatten().tolist()}")
        if not torch.isfinite(card.x).all():
            fails.append(f"{name}: x is not finite")
    if not iterates:
        log(f"# nested-reference {dtype} " + json.dumps(out))
        if fails:
            raise RuntimeError(f"{dtype}: " + "; ".join(fails))
        return out
    n, evals = 4, 64
    stepper = lambda x, b, g: alm.debug_iterates(
        x[:n], alm.tree_map(lambda a: a[:n], b), shape, g, cfg.alm,
        max_evals=evals, lbfgs_overrides=ovr)
    rows = lambda r: torch.stack([r["outer"], r["inner"],
                                  r["valid"].long()])
    rows_unstable = ulp_unstable(lambda x: stepper(x, cpu(bnd), cpu_grid),
                                 x0.cpu(), rows, eps)
    card = {k: v.cpu() for k, v in stepper(x0, bnd, grid).items()}
    ref = stepper(x0.cpu(), cpu(bnd), cpu_grid)
    held = ~rows_unstable
    same_rows = (rows(card) == rows(ref)).all(0)             # [n, evals]
    dx = (card["x"] - ref["x"]).abs().amax(-1)               # [n, evals]
    out["debug_iterates"] = dict(
        lanes=n, rows=evals, ulp_unstable_lanes=rows_unstable.tolist(),
        valid_card=card["valid"].sum(1).tolist(),
        valid_cpu=ref["valid"].sum(1).tolist(),
        share_rows_same=float(same_rows.float().mean()),
        max_dx_held_lanes=float(dx[held].max()) if held.any() else None,
        max_dx_same_rows=float(dx[same_rows].max())
        if same_rows.any() else None)
    if not torch.isfinite(card["x"]).all() \
            or not bool(same_rows[held].all()) \
            or (held.any() and not float(dx[held].max()) <= TOL_NESTED_ROWS):
        fails.append("debug_iterates rows differ on a held lane")
    log(f"# nested-reference {dtype} " + json.dumps(out))
    if fails:
        raise RuntimeError(f"{dtype}: " + "; ".join(fails))
    return out


def _lane_stats(a):
    a = a.float()
    return dict(mean=float(a.mean()), max=int(a.max()))


def post_solve_report(res, good, grid, cfg):
    """The post-solve report of examples/plan_demo.py:100-113 over the good
    lanes: the largest (smallest for cos xi) value of each quantity, and
    the share of good lanes within each limit, and within it widened by
    the 5% that tests/test_alm.py:54 allows for the scaled-constraint
    tolerance."""
    from uneven_planner_tpu_torch.minco import traj
    m = {k: v.cpu() for k, v in
         traj.max_metrics(res.traj, grid, 2048).items()}
    nh = traj.non_hol_error(res.traj, 2048).cpu()
    a = cfg.alm
    limits = dict(max_vx=a.max_vel, max_ax=a.max_acc_lon,
                  max_ay=a.max_acc_lat, max_cur=a.max_kap,
                  min_cxi=a.min_cxi, max_sig=a.max_sig)
    out = {}
    for k, lim in limits.items():
        v = m[k][good]
        if not v.numel():
            out[k] = None
            continue
        low = k == "min_cxi"
        share = lambda f: float((v >= lim / f if low else v <= lim * f)
                                .float().mean())
        out[k] = dict(limit=lim, worst=float(v.min() if low else v.max()),
                      share_within=share(1.0), share_within_5pct=share(1.05))
    v = nh[good]
    out["non_hol_error"] = dict(mean=float(v.mean()), max=float(v.max())) \
        if v.numel() else None
    return out


def phase_nested(device, smi):
    """The nested path at full width: the hill full map with the pair and
    f16 tables, 256 scenarios drawn as the `plan` phase draws them; the
    search, `init_guess_fixed_device`, then `alm.solve` with
    examples/plan_demo.py's settings (ProblemShape(10, 20, int_K=16),
    L-BFGS memory 8 and 250 iterations, cold duals, ALMConfig()), the
    kernels' launches counted over the whole flow; then `solve_compacted`
    (buckets (1, 4, 16)) on the same inputs, its lanes against solve's."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import headline, manager
    from uneven_planner_tpu_torch.frontend import kino_init
    from uneven_planner_tpu_torch.solver import alm
    cfg, grid = headline.scene_setup(device=device)
    fe = cfg.frontend
    B = PLAN_BATCH
    starts, goals = scen_batch(B, np.random.default_rng(5))
    to = lambda a: torch.as_tensor(a, device=device)
    shape = alm.ProblemShape(*NESTED_SHAPE)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    kres = kino_init.plan(grid, fe, to(starts), to(goals))
    x0, bound = manager.init_guess_fixed_device(
        kres.path, kres.path_mask, cfg.manager, shape.piece_xy,
        shape.piece_yaw)
    success = kres.success.cpu()
    t1 = time.perf_counter()
    res = alm.solve(x0, bound, shape, grid, cfg.alm,
                    lbfgs_overrides=NESTED_OVERRIDES)
    conv = res.converged.cpu()
    t2 = time.perf_counter()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    t3 = time.perf_counter()
    com = alm.solve_compacted(x0, bound, shape, grid, cfg.alm,
                              lbfgs_overrides=NESTED_OVERRIDES,
                              buckets=NESTED_BUCKETS)
    com_conv = com.converged.cpu()
    t4 = time.perf_counter()
    launches_com = all_launches()
    launches_com = {k: launches_com[k] - launches[k] for k in launches}

    faults = check_paths(grid, kres, starts, goals,
                         fe.max_vel * fe.time_interval)
    good = success & conv
    rounds = int(res.outer_iters.max())
    differ = {k: int((getattr(com, k).cpu() != getattr(res, k).cpu()).sum())
              for k in ("converged", "outer_iters", "inner_iters",
                        "lbfgs_status")}
    dx = (com.x - res.x).abs().amax(1).cpu()
    out = dict(
        batch=B, card=smi, shape=list(NESTED_SHAPE),
        lbfgs_overrides=NESTED_OVERRIDES, search_s=t1 - t0,
        search_success_share=float(success.float().mean()),
        solve=dict(
            solves_per_s=B / (t2 - t1), wall_s=t2 - t1,
            converged_share=float(conv.float().mean()),
            planned_and_converged_share=float(good.float().mean()),
            outer_rounds=_lane_stats(res.outer_iters),
            inner_iters=_lane_stats(res.inner_iters),
            lockstep_rounds=rounds, lockstep_evaluations=res.steps,
            host_syncs=res.polls,
            host_syncs_per_outer_round=res.polls / max(rounds, 1),
            lbfgs_status=dict(zip(*map(lambda a: a.tolist(), torch.unique(
                res.lbfgs_status.cpu(), return_counts=True)))),
            k2_launches=launches["terrain_tv_pair"]),
        solve_compacted=dict(
            solves_per_s=B / (t4 - t3), wall_s=t4 - t3,
            buckets=list(NESTED_BUCKETS),
            converged_share=float(com_conv.float().mean()),
            planned_and_converged_share=float(
                (success & com_conv).float().mean()),
            lockstep_evaluations=com.steps, host_syncs=com.polls,
            k2_launches=launches_com["terrain_tv_pair"],
            lanes_differing_from_solve=differ,
            lanes_with_other_x=int((dx > 0).sum()),
            max_dx_to_solve=float(dx.max())),
        report=post_solve_report(res, good, grid, cfg),
        launches=launches, path_faults=faults[:8],
        n_path_faults=len(faults),
        finite=bool(torch.isfinite(res.x[kres.success]).all()),
        x_shape=list(res.x.shape), peak_mem_gb=peak)
    log("# nested " + json.dumps(out))
    fails = []
    if out["solve"]["planned_and_converged_share"] < 0.95:
        fails.append("fewer than 95% of scenarios planned and converged")
    if out["solve_compacted"]["planned_and_converged_share"] < 0.95:
        fails.append("solve_compacted: fewer than 95% planned and "
                     "converged")
    if faults:
        fails.append(f"{len(faults)} path faults: {faults[:4]}")
    for name in ("terrain_tv_packed16", "terrain_tv_pair", "gather_rows",
                 *K4_FAMILY):
        if launches[name] == 0:
            fails.append(f"{name} was never launched on the nested path")
    if launches["terrain_tv_pair"] < res.steps:
        fails.append("fewer K2 launches than lockstep evaluations")
    if not out["finite"] or out["x_shape"] != [B, shape.num_vars]:
        fails.append("non-finite or misshapen solver output")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out, (cfg, grid, shape, x0, bound)


def phase_nested_profile(ctx, iterations=8):
    """Device time by kernel and the device's busy share over the first
    outer round of the full-width nested solve, its L-BFGS capped at
    `iterations` (30 lockstep evaluations on the hill at 8)."""
    import torch
    from uneven_planner_tpu_torch.solver import alm
    from uneven_planner_tpu_torch.utils import profiling
    cfg, grid, shape, x0, bound = ctx
    p = alm._params(cfg.alm, dict(NESTED_OVERRIDES,
                                  max_iterations=iterations))
    scal = alm._make_scaling(x0, bound, shape, grid, cfg.alm)
    st = alm.init_state(x0, shape, cfg.alm)
    torch.cuda.synchronize()
    with device_profile() as prof:
        t0 = time.perf_counter()
        st, res = alm.outer_round(st, bound, scal, shape, grid, cfg.alm, p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, rows = profiling.device_time_by_kernel(prof)
    out = dict(lockstep_evaluations=res.steps, host_syncs=res.polls,
               wall_ms_per_evaluation=wall / res.steps * 1e3,
               device_ms_per_evaluation=total / res.steps / 1e3,
               device_busy_share=total / 1e6 / wall,
               device_calls_per_evaluation=sum(c for _, _, c in rows)
               / res.steps,
               top=[dict(kernel=k[:80], device_ms=u / 1e3, calls=c)
                    for u, k, c in rows[:8]])
    log("# nested-profile " + json.dumps(out))
    return out


def phase_packed(device, smi):
    """The split-bf16 table at the headline's shape (M = 4096 x 90 =
    368,640): its lookup (two 48-byte rows through K3, then tensor
    operations) against its CPU twin and the exact lookup, timed beside K1
    (f16) and K2 (exact) with K3's share; K3 alone at the table's items
    against its twin and `index_select`; then one headline batch of 4096
    on `scene_setup(table="packed")` with the headline's gates."""
    import torch
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.kernels import gather
    from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    _, grid = headline.scene_setup(device=device, table="packed")
    _, cpu_grid = headline.scene_setup(device="cpu", table="packed")
    f16 = tgrid.with_packed_f16(grid)
    M = M_HEADLINE
    px, py, yaw = smoke_poses(grid, M, seed=3)
    geom = tgrid.kernel_geometry(grid)
    lookup = lambda: tgrid.get_terrain_variables_cm_packed(grid, px, py,
                                                           yaw)
    got = lookup()
    twin = tgrid.get_terrain_variables_cm_packed(
        cpu_grid, px.cpu(), py.cpu(), yaw.cpu())
    exact = tgrid.get_terrain_variables_cm(grid, px, py, yaw)
    e_twin = _err(got.cpu(), twin, *TOL["tv"])
    rel = ((got - exact).abs() / exact.abs().clamp(min=1.0)).max()
    # K3 at the table's items: the two x-corner rows of every lookup
    k = tgrid._cell(grid, px, py, yaw, low_y_rule=True,
                    to_index=tgrid._to_index32)
    rows = torch.stack([tgrid.cell_row(k[x], k["iy0"], k["iw"],
                                       grid.voxel_num)
                        for x in ("ix0", "ix1")]).reshape(-1)
    table = grid.data_packed
    k3 = lambda: gather.gather_rows(table, rows)
    k3_twin = lambda: gather.gather_rows_twin(table, rows)
    clipped = rows.long().clamp(0, table.shape[0] - 1)
    k3_lib = lambda: torch.index_select(table, 0, clipped)
    k3_equal = torch.equal(k3(), k3_twin())
    n_idx = rows.numel()
    k3_bytes = n_idx * (4 + 2 * 48)
    times = dict(
        packed_lookup=device_ms(lookup),
        k1_f16=device_ms(lambda: kernels.terrain_tv_packed16(
            f16.data_packed16, geom, px, py, yaw, False, False)),
        k2_exact=device_ms(lambda: kernels.terrain_tv_pair(
            grid.data_pair, geom, px, py, yaw, False)),
        k3=device_ms(k3))
    floor, sectors = k3_sector_floor_ms(clipped, 48, 4)
    k3_before = before_library("k3_before").load()
    k3_row = dict(
        name="gather_rows", shape=f"packed: bf16 items [{table.shape[0]}, "
        f"12] int32 by {n_idx} int32", equal=k3_equal,
        max_abs_err=0.0 if k3_equal else float("inf"), ms=times["k3"],
        plain_ms=device_ms(k3_twin), library_ms=device_ms(k3_lib),
        bound_ms=k3_bytes / PEAK_BYTES * 1e3, bound_by="bytes",
        bytes=k3_bytes, sector_floor_ms=floor, sectors=sectors,
        ms_parent=device_ms(lambda: _k3_before(k3_before, table, rows)))
    log("# kernel " + json.dumps(k3_row))
    out = dict(
        M=M, card=smi, max_abs_err_twin=e_twin[0],
        n_out_of_tol_twin=e_twin[1], finite=e_twin[2],
        max_rel_err_exact=float(rel), tolerance_exact=TOL_PACKED_EXACT,
        tolerance_twin=TOL["tv"], ms=times,
        k3_share=times["k3"] / times["packed_lookup"])
    log("# packed-lookup " + json.dumps(out))
    fails = []
    if e_twin[1] or not e_twin[2]:
        fails.append("the split-bf16 lookup disagrees with its CPU twin")
    if not float(rel) < TOL_PACKED_EXACT:
        fails.append(f"the split-bf16 lookup is {float(rel):.3g} from the "
                     "exact one")
    if not k3_equal:
        fails.append("K3 disagrees with its twin on the bf16 items")
    if fails:
        raise RuntimeError("; ".join(fails))
    head, _ = phase_headline(device, smi, table="packed")
    return dict(lookup=out, k3=k3_row, headline=head)


# ---------------------------------------------------------------------------
# the map builder: point cloud -> SE(2) terrain field -> plans
# ---------------------------------------------------------------------------

def hill_cloud_mesh(step=BUILD_MESH_STEP, half=5.6, lift=BUILD_LIFT):
    """The hill surface (`hill_height` + lift) triangulated on a square
    grid of `step` spacing over [-half, half]^2: (verts, faces)."""
    import numpy as np
    from uneven_planner_tpu_torch.terrain.synthetic import hill_height
    xs = np.arange(-half, half + 1e-9, step)
    n = len(xs)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([X, Y, hill_height(X, Y) + lift], -1).reshape(-1, 3)
    i = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).ravel()
    faces = np.concatenate([np.stack([i, i + n, i + 1], 1),
                            np.stack([i + 1, i + n, i + n + 1], 1)])
    return verts, faces


def build_cloud(seed=0):
    """The reference's to_pcl flow on the hill: BUILD_SAMPLES surface
    samples of the triangulated hill plus BUILD_TRUNKS vertical trunks of
    600 points (tests/test_build.py:117-120) standing in TRUNK_BOX.
    Returns (points [N, 3], trunk centres [T, 2])."""
    import numpy as np
    from uneven_planner_tpu_torch.terrain import mesh
    from uneven_planner_tpu_torch.terrain.synthetic import hill_height
    pts = mesh.sample_surface(*hill_cloud_mesh(), BUILD_SAMPLES, seed=seed)
    rng = np.random.default_rng(seed + 1)
    (x0, x1), (y0, y1) = TRUNK_BOX
    centres = np.stack([rng.uniform(x0, x1, BUILD_TRUNKS),
                        rng.uniform(y0, y1, BUILD_TRUNKS)], 1)
    trunks = [np.stack([cx + rng.normal(0, 0.03, 600),
                        cy + rng.normal(0, 0.03, 600),
                        hill_height(cx, cy) + BUILD_LIFT
                        + rng.uniform(0.0, 3.0, 600)], 1)
              for cx, cy in centres]
    return np.concatenate([pts] + trunks), centres


def _reference_fit(cell_pos, prev, points, cfg):
    """Direct numpy port of the reference per-cell fit semantics
    (uneven_map.cpp:317-398 + filter :5-43), brute force over the full
    cloud: the oracle of the bucketed fits (tests/test_build.py:33-63)."""
    import numpy as np
    zb = prev[2:4]
    c = np.sqrt(max(1.0 - zb @ zb, 1e-12))
    yaw = cell_pos[2]
    xyaw = np.array([np.cos(yaw), np.sin(yaw), 0.0])
    zb3 = np.array([zb[0], zb[1], c])
    yb = np.cross(zb3, xyaw)
    yb /= np.linalg.norm(yb)
    xb = np.cross(yb, zb3)
    RT = np.stack([xb, yb, zb3])
    world_xy = cell_pos[:2] + xb[:2] * cfg.probe_offset
    d2 = np.sum((points[:, :2] - world_xy) ** 2, axis=1)
    z0 = points[np.argmin(d2), 2]
    world_pos = np.array([world_xy[0], world_xy[1], z0])
    rel = (points - world_pos) @ RT.T
    inv_ell = np.array([1 / cfg.ellipsoid_x, 1 / cfg.ellipsoid_y,
                        1 / cfg.ellipsoid_z])
    member = np.sum((rel * inv_ell) ** 2, axis=1) < 1.0
    sel = points[member]
    if len(sel) == 0:
        return np.array([world_pos[2], 0.0, 0.0, 0.0])
    mean = sel.mean(axis=0)
    cov = (sel - mean).T @ (sel - mean) / len(sel)
    w, V = np.linalg.eigh(cov)
    n = V[:, 0]
    if n[2] < 0:
        n = -n
    sigma = 3 * w[0] / w.sum()
    return np.array([mean[2], sigma, n[0], n[1]])


def _build_k3_reads(points, cfg, device):
    """The two K3 reads of the first dispatch of a full build, captured by
    running the build until its second read: [(table, idx), ...] for the
    bucket rows and the cloud rows."""
    from uneven_planner_tpu_torch.kernels import gather
    from uneven_planner_tpu_torch.terrain import build

    class Enough(Exception):
        pass

    seen = []

    def record(table, idx):
        seen.append((table, idx.clone()))
        if len(seen) == 2:
            raise Enough
        return gather.gather_rows(table, idx)

    build.gather_rows = record
    try:
        build.construct_map(points, cfg, device=device)
    except Enough:
        pass
    finally:
        build.gather_rows = gather.gather_rows
    return seen


def phase_map_build(device, smi):
    """The map builder at full width on a hill cloud, its checks, K3 at the
    build's two shapes, planning on the built map and the npz cache."""
    import tempfile
    import numpy as np
    import torch
    from scipy.spatial import cKDTree
    from uneven_planner_tpu_torch import api
    from uneven_planner_tpu_torch.config import MapConfig, scene_config
    from uneven_planner_tpu_torch.kernels import gather
    from uneven_planner_tpu_torch.terrain import build, io, mesh
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    from uneven_planner_tpu_torch.terrain.synthetic import hill_height
    from uneven_planner_tpu_torch.utils import profiling
    PROFILE_CROP = MapConfig(map_size_x=PROFILE_CROP_SIZE[0],
                             map_size_y=PROFILE_CROP_SIZE[1])
    fails = []
    t0 = time.perf_counter()
    # seconds of each step of the phase, for the split of its time
    split, t_lap = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        split[name], t_lap[0] = round(now - t_lap[0], 2), now

    raw, centres = build_cloud()
    with tempfile.TemporaryDirectory() as tmp:
        maps = os.path.join(tmp, "maps")
        os.makedirs(maps)
        mesh.save_pcd(os.path.join(maps, "hillcloud.pcd"), raw)
        points = io.load_scene_cloud("hillcloud", maps)
        cloud_s = time.perf_counter() - t0
        lap("cloud")

        cfg = scene_config("hill").map
        b3 = build.build_buckets3d(points, cfg, device="cpu")
        nx, ny, nyaw = cfg.voxel_num
        fits = nx * ny * nyaw * cfg.iter_num
        # one timed build; the profiled build below repeats its dispatches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gather.reset_launches()
        t = {}
        t1 = time.perf_counter()
        grid = build.construct_map(points, cfg, device=device, timings=t)
        occ_share = float(grid.occ.float().mean())      # a host read
        wall = time.perf_counter() - t1
        builds = [dict(
            wall_s=wall, host_s=t["host_s"], device_s=t["device_s"],
            fits_per_s=fits / wall,
            k3_launches=gather.launches["gather_rows"],
            k3_word_launches=gather.launches["gather_rows_words"],
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)]
        data = grid.data

        lap("timed_build")
        # one more build under the profiler: device time of the sweep by
        # kernel, and the device's busy share of the sweep, on PROFILE_CROP
        # at full resolution (the same dispatches, a sixth of them: the
        # profiler's processing of the whole build's ~90,000 kernels took
        # 24 s)
        t = {}
        with device_profile() as prof:
            build.construct_map(points, PROFILE_CROP, device=device,
                                timings=t)
        total, rows = profiling.device_time_by_kernel(prof)
        k3 = [(u, c) for u, k, c in rows if "gather_rows_" in k]
        sweep_profile_crop = dict(
            map=[PROFILE_CROP.map_size_x, PROFILE_CROP.map_size_y],
            device_s_profiled=t["device_s"], device_ms=total / 1e3,
            device_busy_share=total / 1e6 / t["device_s"],
            device_calls=sum(c for _, _, c in rows),
            k3_ms=sum(u for u, _ in k3) / 1e3, k3_calls=sum(c for _, c in k3),
            top=[dict(kernel=k[:80], device_ms=u / 1e3, calls=c)
                 for u, k, c in rows[:8]])
        del prof

        lap("profiled_build")
        # z against the surface at each cell's probe point, away from the
        # trunks
        ox, oy, oyaw = cfg.map_origin
        cx = (np.arange(nx) + 0.5) * cfg.xy_resolution + ox
        cy = (np.arange(ny) + 0.5) * cfg.xy_resolution + oy
        cw = (np.arange(nyaw) + 0.5) * cfg.yaw_resolution + oyaw
        X, Y, W = np.meshgrid(cx, cy, cw, indexing="ij")
        PX = X + cfg.probe_offset * np.cos(W)
        PY = Y + cfg.probe_offset * np.sin(W)
        (x0, x1), (y0, y1) = TRUNK_BOX
        away = ~((PX > x0 - 0.5) & (PX < x1 + 0.5) & (PY > y0 - 0.5)
                 & (PY < y1 + 0.5))
        host = data.cpu().numpy()
        dz = np.abs(host[..., 0] - (hill_height(PX, PY) + BUILD_LIFT))[away]
        sig = host[..., 1]
        out = dict(
            card=smi, points=len(points), raw_points=len(raw),
            trunks=BUILD_TRUNKS, bucket_capacity_K=int(b3.table.shape[1]),
            buckets=list(b3.nb), cells=[nx, ny, nyaw],
            iterations=cfg.iter_num, fits=fits, cloud_s=cloud_s,
            builds=builds, sweep_profile_crop=sweep_profile_crop,
            finite=bool(np.isfinite(host).all()),
            sigma_min=float(sig.min()), sigma_max=float(sig.max()),
            sigma_below_minus_1e6_cells=int((sig < -1e-6).sum()),
            z_err_median_m=float(np.median(dz)),
            z_err_p99_m=float(np.percentile(dz, 99)),
            z_err_max_m=float(dz.max()), occupancy_share=occ_share)
        if not out["finite"]:
            fails.append("non-finite map values")
        if not (-SIGMA_ROUNDING <= out["sigma_min"]
                and out["sigma_max"] <= 1 + 1e-6):
            fails.append("sigma outside [0, 1]")
        if out["z_err_median_m"] > MAX_Z_ERR_MEDIAN \
                or out["z_err_p99_m"] > MAX_Z_ERR_P99:
            fails.append("built z strays from the surface")
        if not 0.0 < occ_share < 0.9:
            fails.append(f"occupancy share {occ_share}")
        if builds[0]["k3_launches"] == 0:
            fails.append("gather_rows was never launched by the build")

        lap("surface_check")
        # the 3D fit at iteration 0 against the brute-force oracle, half the
        # cells near a trunk
        rng = np.random.default_rng(3)
        cells = np.stack([rng.uniform(-4.5, 4.5, 256),
                          rng.uniform(-4.5, 4.5, 256),
                          rng.uniform(-np.pi, np.pi, 256)], 1)
        pick = centres[rng.integers(0, len(centres), 128)]
        ang, rad = rng.uniform(-np.pi, np.pi, 128), rng.uniform(0, 0.3, 128)
        cells[::2, :2] = pick + rad[:, None] * np.stack(
            [np.cos(ang), np.sin(ang)], 1)
        probe = cells[:, :2] + cfg.probe_offset * np.stack(
            [np.cos(cells[:, 2]), np.sin(cells[:, 2])], 1)
        _, nn = cKDTree(points[:, :2]).query(probe)
        to = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        b3d = build.build_buckets3d(points, cfg, device=device)
        got = build._fit_cell3d(to(cells), to(np.zeros((256, 4))),
                                to(points[nn, 2]), b3d, cfg, True) \
            .cpu().numpy()
        want = np.stack([_reference_fit(c, np.zeros(4), points, cfg)
                         for c in cells])
        oracle_err = np.abs(got - want) - TOL_BUILD_ORACLE * np.abs(want)
        out["oracle_max_abs_err"] = float(np.abs(got - want).max())
        if (oracle_err > TOL_BUILD_ORACLE).any():
            fails.append("3D fits disagree with the brute-force oracle")
        del b3d

        lap("oracle")
        # the three modes on a 4 x 4 m crop at full resolution
        crop = MapConfig(map_size_x=4.0, map_size_y=4.0)
        modes = {m: build.construct_map(points, crop, mode=m,
                                        device=device).data
                 for m in ("yawshare", "xyz", "xy")}
        out["modes_max_diff"] = {m: float((modes[m] - modes["yawshare"])
                                          .abs().max())
                                 for m in ("xyz", "xy")}
        if max(out["modes_max_diff"].values()) > TOL_BUILD_MODES:
            fails.append("the modes disagree")
        del modes

        lap("modes")
        # the card against the port's own CPU build on a 1.6 x 1.6 m crop
        small = MapConfig(map_size_x=1.6, map_size_y=1.6)
        t1 = time.perf_counter()
        card = build.construct_map(points, small, device=device).data.cpu()
        cpu = build.construct_map(points, small, device="cpu").data
        d = (card - cpu).abs()
        out.update(card_vs_cpu_max=float(d.max()),
                   card_vs_cpu_median=float(d.median()),
                   card_vs_cpu_s=time.perf_counter() - t1)
        if out["card_vs_cpu_max"] > TOL_BUILD_CARD_CPU \
                or out["card_vs_cpu_median"] > TOL_BUILD_CARD_CPU_MEDIAN:
            fails.append("the card's build disagrees with the CPU's")

        lap("card_vs_cpu")
        # K3 at the build's two reads, against its twin and index_select
        reads = []
        for label, (table, idx) in zip(
                ("build bucket rows", "build cloud rows"),
                _build_k3_reads(points, cfg, device)):
            kern = lambda: gather.gather_rows(table, idx)
            twin = lambda: gather.gather_rows_twin(table, idx)
            lib = lambda: torch.index_select(table, 0, idx)
            g, w = kern(), twin()
            row = table.element_size() * table.shape[1]
            distinct = int(torch.unique(idx).numel())
            nbytes = idx.numel() * (idx.element_size() + row) \
                + distinct * row
            floor, sectors = k3_sector_floor_ms(
                idx.long().clamp(0, table.shape[0] - 1), row,
                idx.element_size())
            k3_before = before_library("k3_before").load()
            v = dict(name="gather_rows",
                     shape=f"{label}: [{table.shape[0]}, {table.shape[1]}] "
                     f"{str(table.dtype)[6:]} by [{idx.numel()}] "
                     f"{str(idx.dtype)[6:]}",
                     equal=_all_equal(g, w), max_abs_err=_exact_err(g, w),
                     ms=device_ms(kern), plain_ms=device_ms(twin),
                     library_ms=device_ms(lib),
                     bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                     bytes=nbytes, distinct_rows=distinct,
                     sector_floor_ms=floor, sectors=sectors,
                     ms_parent=device_ms(
                         lambda: _k3_before(k3_before, table, idx)),
                     launches_per_build=builds[0]["k3_launches"] // 2)
            log("# kernel " + json.dumps(v))
            reads.append(v)
            if not v["equal"]:
                fails.append(f"K3 differs from its twin on the {label}")
        out["k3_reads"] = reads

        lap("k3_reads")
        # plan on the built map, with both tables
        scfg = scene_config("hill")
        pgrid = tgrid.with_packed_f16(tgrid.with_pair_table(grid))
        starts, goals = scen_batch(PLAN_BATCH, np.random.default_rng(9))
        t1 = time.perf_counter()
        kres, ares = api.plan_batch(pgrid, scfg, starts, goals,
                                    device=device)
        success = kres.success.cpu().numpy()
        conv = ares.converged.cpu().numpy()
        plan_s = time.perf_counter() - t1
        faults = check_paths(pgrid, kres, starts, goals,
                             scfg.frontend.max_vel
                             * scfg.frontend.time_interval)
        out.update(plan=dict(
            batch=PLAN_BATCH, plans_per_s=PLAN_BATCH / plan_s,
            wall_s=plan_s, success_share=float(success.mean()),
            planned_and_converged_share=float((success & conv).mean()),
            n_path_faults=len(faults), path_faults=faults[:4]))
        if out["plan"]["success_share"] < 0.95 \
                or out["plan"]["planned_and_converged_share"] < 0.95:
            fails.append("planning on the built map under 95%")
        if faults:
            fails.append(f"{len(faults)} path faults on the built map")
        del pgrid, kres, ares

        lap("plan")
        # the npz cache under a point-cloud scene's name
        cache = os.path.join(tmp, "cache")
        os.makedirs(cache)
        io.save_map_npz(os.path.join(cache, "desert.npz"), host)
        _, loaded = api.load_or_build_scene("desert", cache_dir=cache,
                                            device=device)
        out["cache_round_trip_equal"] = bool(torch.equal(loaded.data, data))
        if not out["cache_round_trip_equal"]:
            fails.append("the npz cache does not give the map back")
        lap("cache")
        out["split_s"] = split
    log("# build " + json.dumps(out))
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


# ---------------------------------------------------------------------------
# multi-process batching, and the bench harnesses
# ---------------------------------------------------------------------------

# the headline batch of the `dist` phase: bench.py's width and settings
DIST_BATCH = 4096
DIST_SHAPE = (10, 20, 8)
DIST_OVERRIDES = {"mem_size": 8, "max_iterations": 30}
# scenarios of the one-process `launch_local` run of the `dist` phase
DIST_LAUNCH_BATCH = 256


def phase_dist(device, smi):
    """`parallel.distributed` on the card: one NCCL rank (the machine has
    one card; NCCL takes one rank a card) joins a process group over
    tcp://127.0.0.1, and `plan_batch_global` solves the full-width headline
    batch (4096 lanes, `headline.scene_setup()`, ProblemShape(10, 20, 8),
    memory 8, 30 iterations, `solve_flat`) beside the unsharded
    `alm.solve_flat` on the same inputs, unsharded first, then sharded
    (the kernels are warm from the headline phase, so one call each
    times both).  Every lane of the sharded call must equal the
    unsharded call's bit for bit, and the counts all-reduced over the group
    must equal the local sums.  Solves/s of each call, each ended by a
    host read.  The group is left at the end, pass or fail.  Then
    `bench.scaling.run_multiprocess` forks one process through
    `distributed.launch_local(device="cuda")`, which joins its own
    one-rank NCCL group and solves DIST_LAUNCH_BATCH scenarios."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.bench import scaling
    from uneven_planner_tpu_torch.parallel import distributed
    from uneven_planner_tpu_torch.solver import alm
    t_setup = time.perf_counter()
    cfg, grid = headline.scene_setup(device=device)
    shape = alm.ProblemShape(*DIST_SHAPE)
    x0, bnd, _ = headline.make_batch(DIST_BATCH, cfg, shape,
                                     np.random.default_rng(5), sort=False,
                                     device=device)
    setup_s = time.perf_counter() - t_setup

    def unsharded():
        res = alm.solve_flat(x0, bnd, shape, grid, cfg.alm,
                             lbfgs_overrides=DIST_OVERRIDES)
        return res, (int(res.converged.sum()), int(res.inner_iters.sum()))

    def timed(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, counts = call()
        return res, counts, time.perf_counter() - t0

    ref, local_counts, flat_s = timed(unsharded)
    port = distributed.free_port()
    try:
        t0 = time.perf_counter()
        distributed.initialize(f"127.0.0.1:{port}", 1, 0, timeout_s=120.0)
        init_s = time.perf_counter() - t0
        backend = torch.distributed.get_backend()
        mesh = distributed.hierarchical_mesh()
        scen = distributed.shard_scenarios(mesh, x0, bnd)
        run = distributed.plan_batch_global(mesh, shape, grid, cfg.alm,
                                            DIST_OVERRIDES)

        def sharded():
            res, (n_conv, n_inner) = run(scen)
            return res, (int(n_conv), int(n_inner))
        reset_all_launches()
        res1, counts1, dist_s = timed(sharded)
        launches = all_launches()
    finally:
        distributed.shutdown()
    fields = ("x", "converged", "outer_iters", "inner_iters", "res_h",
              "res_g", "lbfgs_status", "evals")
    differ = {k: lanes_differ(getattr(res1, k), getattr(ref, k))
              for k in fields}
    t_mp = time.perf_counter()
    mp = scaling.run_multiprocess(
        1, 1, DIST_LAUNCH_BATCH, device="cuda", shape=DIST_SHAPE,
        overrides=DIST_OVERRIDES, timeout=300.0)
    launch_local_s = time.perf_counter() - t_mp
    rate = lambda s: DIST_BATCH / s
    out = dict(card=smi, backend=backend, mesh_shape=list(mesh.shape),
               batch=DIST_BATCH, init_s=init_s,
               call_order=["unsharded", "sharded"],
               solves_per_s_unsharded=rate(flat_s),
               solves_per_s_dist=rate(dist_s),
               wall_s=[flat_s, dist_s],
               steps=[ref.steps, res1.steps],
               n_converged_allreduced=counts1[0],
               n_converged_local=local_counts[0],
               n_inner_allreduced=counts1[1],
               n_inner_local=local_counts[1],
               converged_share=local_counts[0] / DIST_BATCH,
               lanes_differing=differ,
               launches={k: launches[k] for k in (
                   "terrain_tv_packed16", "terrain_tv_pair")},
               launch_local=mp, setup_s=setup_s,
               launch_local_s=launch_local_s,
               scaling="not measured: one card, one rank")
    log("# dist " + json.dumps(out))
    fails = []
    if backend != "nccl" or out["mesh_shape"] != [1, 1]:
        fails.append(f"not one NCCL rank: {backend}, {out['mesh_shape']}")
    if any(differ.values()) or len(set(out["steps"])) != 1:
        fails.append(f"lanes differ from the unsharded solve: {differ}")
    if counts1 != local_counts:
        fails.append("the all-reduced counts are not the local sums")
    if local_counts[0] < 0.95 * DIST_BATCH:
        fails.append("fewer than 95% converged")
    if launches["terrain_tv_packed16"] == 0 or \
            launches["terrain_tv_pair"] == 0:
        fails.append("K1 or K2 was never launched on the distributed path")
    if [p["backend"] for p in mp] != ["nccl"] \
            or mp[0]["converged"] < 0.95 * DIST_LAUNCH_BATCH:
        fails.append(f"launch_local on the card: {mp}")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


def lanes_differ(a, b) -> int:
    """Lanes (first dimension) of two tensors that are not equal bit for
    bit (NaN equal to NaN)."""
    import torch
    same = (a == b)
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return int((~same).reshape(a.shape[0], -1).any(1).sum())


# TRACKING_r05.json's settings and episodes (data/err_bench_proposed_hill.txt)
BENCH_TRACK_FILE = "data/bench_proposed_hill.txt"
BENCH_TRACK_ERR = "data/err_bench_proposed_hill.txt"
BENCH_TRACK_CTRL_DT = 0.02
BENCH_TRACK_SQP = 2
# each episode's mean error against the recorded one, relative
TOL_BENCH_TRACK = 0.05


def phase_bench_track(device, smi):
    """The reference's bk_mode on the card: every trajectory of the tracked
    `data/bench_proposed_hill.txt` as one episode (teleport, track to the
    goal) through `bench.tracking_benchmark.run_benchmark` (float32,
    MPCConfig(), ctrl_dt 0.02, 2 relinearisations: TRACKING_r05.json's
    settings), its err file written to a temporary directory; each
    episode's mean error within TOL_BENCH_TRACK of the recorded one, with
    K3, K4 and K6 launched in the run."""
    import tempfile
    from uneven_planner_tpu_torch.bench import tracking_benchmark as tb
    from uneven_planner_tpu_torch.config import MPCConfig
    recorded = [float(ln) for ln in open(os.path.join(HERE, BENCH_TRACK_ERR))
                if not ln.startswith("all_mean")]
    with tempfile.TemporaryDirectory() as tmp:
        err_path = os.path.join(tmp, "err_bench_proposed_hill.txt")
        reset_all_launches()
        t0 = time.perf_counter()
        res, total = tb.run_benchmark(
            os.path.join(HERE, BENCH_TRACK_FILE), MPCConfig(),
            out_path=err_path, ctrl_dt=BENCH_TRACK_CTRL_DT,
            max_sqp_iter=BENCH_TRACK_SQP, device=device)
        wall = time.perf_counter() - t0
        launches = all_launches()
        written = open(err_path).read().strip().splitlines()
    ticks = sum(r.steps for r in res)
    rel = [abs(r.mean_err - w) / w for r, w in zip(res, recorded)]
    out = dict(card=smi, episodes=len(res), ticks=ticks, wall_s=wall,
               ms_per_tick=wall / ticks * 1e3,
               mean_err=[r.mean_err for r in res], recorded=recorded,
               rel_diff=rel, all_mean_track_err=total,
               recorded_all_mean_track_err=sum(recorded),
               err_file_lines=len(written),
               launches={k: launches[k] for k in (
                   "gather_rows", "gather_along", "admm_iterations")})
    log("# bench-track " + json.dumps(out))
    fails = []
    if len(res) != len(recorded) or len(written) != len(res) + 1:
        fails.append("episode count or err file differs from the record")
    if not all(r <= TOL_BENCH_TRACK for r in rel):
        fails.append(f"an episode's error is off the record by more than "
                     f"{TOL_BENCH_TRACK:.0%}: {rel}")
    for name, n in out["launches"].items():
        if n == 0:
            fails.append(f"{name} was never launched in the episodes")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


PRECISION_BATCH = 64


def phase_precision(device, smi):
    """`bench.precision_study.run_study` at B = 64 (ProblemShape(10, 20,
    16), memory 16, 30 iterations, the full hill map with its pair table):
    float32 on the card against float64 on the CPU, as the JAX study, and
    float64 on the card against the same CPU run.  Gates: every float64
    lane converged on both sides and the card's float64 lanes within the
    ALM band of the CPU's."""
    from uneven_planner_tpu_torch.bench import precision_study
    t0 = time.perf_counter()
    out = precision_study.run_study(PRECISION_BATCH, device=device)
    out.update(card=smi, wall_s=time.perf_counter() - t0)
    log("# precision " + json.dumps(out))
    f64 = out["f64_card"]
    if out["conv_f64"] < 0.95 or f64["conv_card"] < 0.95 \
            or f64["conv_agree"] < 1.0 or not f64["x_gap_max"] <= 2e-2:
        raise RuntimeError(f"float64 on the card disagrees with the CPU: "
                           f"{f64}")
    return out


# the hill scene's evaluation at a cut batch (the JAX harness: 64)
SCENE_BATCH = 8


def phase_scene_eval(device, smi):
    """`bench.scene_eval.run_scene` on the hill at a cut batch
    (SCENE_BATCH scenarios sampled in free space, 500 ticks, with its one
    retry of failed lanes): the whole pipeline on the card, its report,
    with the C++ A* oracle's three keys, which must be set, and the
    search's success on the oracle's feasible scenarios, which must be
    1.0."""
    from uneven_planner_tpu_torch.bench import scene_eval
    reset_all_launches()
    rep = scene_eval.run_scene("hill", B=SCENE_BATCH, device=device)
    launches = all_launches()
    rep.update(card=smi, launches={k: launches[k] for k in (
        "terrain_tv_packed16", "terrain_tv_pair", "gather_rows",
        "gather_along", "admm_iterations")})
    log("# scene-eval " + json.dumps(rep))
    if rep["pipeline_success_rate"] < 0.75 \
            or rep["mean_track_err_m"] is None \
            or not rep["mean_track_err_m"] <= MAX_TRACK_ERR:
        raise RuntimeError(f"scene_eval on the hill: {rep}")
    # the C++ A* oracle's keys: set, and the search succeeds on every
    # scenario the oracle finds feasible (the JAX harness's record on every
    # reference scene, SCENES_r05.json)
    oracle = {k: rep[k] for k in ("oracle_feasible_rate",
                                  "frontend_success_on_feasible",
                                  "pipeline_success_on_feasible")}
    if any(v is None for v in oracle.values()) \
            or oracle["frontend_success_on_feasible"] != 1.0:
        raise RuntimeError(f"scene_eval's oracle keys: {oracle}")
    return rep


# ---------------------------------------------------------------------------
# the reference's float64 oracles, and the user entry points
# ---------------------------------------------------------------------------

# the certified QP (QP_DUMP_r05.json: one real tick's condensed QP, n = 60,
# m = 118, with its f64 active-set optimum): the dump's lane and the lanes
# whose q entries are scaled by 1 + QP_ORACLE_NOISE x N(0, 1), seeded
QP_ORACLE_LANES = 256
QP_ORACLE_NOISE = 1e-2
# BASELINE's control-sequence gate: |x - x_f64| on every lane
TOL_QP_ORACLE = 1e-3
# the port's qp_ref re-certifies the dump: KKT residuals
TOL_QP_KKT = 1e-9
# the inner cost against the C++ forward (tests/test_native.py:152, :172):
# (rtol, atol) of the value on each seed, of the gradient against central
# differences (h = 1e-6) of the C++ on seed 1
TOL_INNER_COST = (1e-9, 1e-10)
TOL_INNER_GRAD = (5e-4, 5e-6)
INNER_COST_SEEDS = 6
# scenarios of the C++ A* against the port's search: bench.scene_eval's
# sampler at the JAX harness's batch
ORACLE_SEARCH_BATCH = 64


def inner_cost_fixture(seed, device):
    """tests/test_native.py:115's fixture in the port, on `device`: the
    coarse float64 hill (0.2 m, 0.45 rad) with its pair table,
    ProblemShape(6, 12, 8), an off-init iterate of a random straight
    path, random duals, the default constraint scaling; one lane.
    Returns (grid, cfg, shape, x, bound, duals, scaling)."""
    import dataclasses
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import manager
    from uneven_planner_tpu_torch.config import MapConfig, scene_config
    from uneven_planner_tpu_torch.solver import alm
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(scene_config("hill"), map=MapConfig(
        xy_resolution=0.2, yaw_resolution=0.45))
    grid = tgrid.with_pair_table(make_synthetic_grid(cfg.map, device=device))
    shape = alm.ProblemShape(piece_xy=6, piece_yaw=12, int_K=8)
    ang = rng.uniform(-np.pi, np.pi)
    start = rng.uniform(-3.0, -1.5, size=2)
    goal = np.clip(start + 2.0 * np.array([np.cos(ang), np.sin(ang)]),
                   -3.5, 3.5)
    yaw = np.arctan2(goal[1] - start[1], goal[0] - start[0])
    t = np.linspace(0, 1, 16)[:, None]
    path = np.concatenate([(1 - t) * start + t * goal,
                           np.full((16, 1), yaw)], axis=1)
    x0, bound = manager.init_guess_fixed(path, cfg.manager,
                                         piece_xy=shape.piece_xy,
                                         piece_yaw=shape.piece_yaw)
    x = x0 + rng.normal(size=x0.shape) * 0.02
    E, I = shape.equal_num, shape.non_equal_num
    lane = lambda a: torch.as_tensor(np.asarray(a, np.float64))[None] \
        .to(device)
    duals = alm.DualState(lam=lane(rng.normal(size=E) * 0.1),
                          mu=lane(np.abs(rng.normal(size=I)) * 0.1),
                          rho=lane(rng.uniform(1.0, 3.0)))
    scaling = alm.Scaling(
        scale_fx=lane(1.0),
        scale_cx=alm.default_scale_cx(shape, cfg.alm, 1, torch.float64,
                                      device))
    return (grid, cfg, shape, lane(x), alm.Boundary(*map(lane, bound)),
            duals, scaling)


def cpp_inner_cost(grid, cfg, shape, x, bound, duals, scaling):
    """`native.inner_cost` of one lane of `inner_cost_fixture`."""
    from uneven_planner_tpu_torch.utils import native
    return native.inner_cost(grid, cfg.alm, shape, x, bound, duals.lam,
                             duals.mu, float(duals.rho[0]),
                             scaling.scale_cx, float(scaling.scale_fx[0]))


def oracle_qp(device):
    """(a) of the `oracle` phase: K6 (through `solve_qp`, the controller's
    settings: one launch of the fixed shared-memory instantiation) on the
    dumped QP and its perturbed lanes against the port's certified f64
    optimum of each lane, and the dump re-certified.  Also a reading, not
    a gate: lanes whose q takes absolute N(0, 1e-2) noise, which puts
    weight on P's weakest direction (eigenvalue 0.02 of up to 798).
    Returns (readings, faults, the K6 launch at the perturbed lanes' data
    with the bound of its iterations, for timing)."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.config import MPCConfig
    from uneven_planner_tpu_torch.kernels import admm
    from uneven_planner_tpu_torch.solver import admm_qp
    from uneven_planner_tpu_torch.utils import qp_ref
    with open(os.path.join(HERE, "QP_DUMP_r05.json")) as f:
        dump = json.load(f)
    P, q, A, l, u = [np.asarray(dump[k], np.float64) for k in "PqAlu"]
    B, n, m = QP_ORACLE_LANES, q.shape[0], l.shape[0]
    z, y = qp_ref.solve_qp_f64(P, q, A, l, u)
    kkt = [float(v) for v in qp_ref.kkt_residuals_f64(P, q, A, l, u, z, y)]
    rng = np.random.default_rng(11)
    noise = rng.normal(size=(B - 1, n))
    qs = np.concatenate([q[None], q * (1.0 + QP_ORACLE_NOISE * noise)])
    q_abs = np.concatenate([q[None], q + QP_ORACLE_NOISE * noise])
    cfg = MPCConfig()
    kw = dict(rho=cfg.qp_rho, sigma=cfg.qp_sigma, alpha=cfg.qp_alpha,
              eps_abs=cfg.qp_abs_tol, eps_rel=cfg.qp_rel_tol,
              max_iter=cfg.qp_max_iter, polish=cfg.qp_polish,
              adaptive_rho=cfg.qp_adaptive_rho,
              fixed_iters=cfg.qp_scan_iters)
    lanes = lambda a: torch.as_tensor(
        np.ascontiguousarray(np.broadcast_to(a, (B,) + a.shape)),
        dtype=torch.float32, device=device)
    card = lambda qq: admm_qp.solve_qp(lanes(P), torch.as_tensor(
        qq, dtype=torch.float32, device=device), lanes(A), lanes(l),
        lanes(u), **kw)

    out, its_of = {}, {}
    for name, qq in (("relative", qs), ("absolute", q_abs)):
        t0 = time.perf_counter()
        want = np.stack([qp_ref.solve_qp_f64(P, v, A, l, u)[0] for v in qq])
        certify_s = time.perf_counter() - t0
        sol = card(qq)
        gap = np.abs(sol.x.double().cpu().numpy() - want).max(1)
        its = its_of[name] = sol.iters.cpu().long()
        out[name] = dict(max_gap=float(gap.max()), gap_dump=float(gap[0]),
                         lanes_over_tol=int((gap > TOL_QP_ORACLE).sum()),
                         iters_mean=float(its.float().mean()),
                         at_budget=int((its >= cfg.qp_scan_iters).sum()),
                         certify_s=certify_s,
                         finite=bool(torch.isfinite(sol.x).all()))
    # the launch alone, at the relative lanes' data (the iterations of
    # their solve above: the same setup and launch), as `admm` times K6
    setup = admm_qp.setup_qp(lanes(P), torch.as_tensor(
        qs, dtype=torch.float32, device=device), lanes(A), lanes(l),
        lanes(u), rho=cfg.qp_rho, sigma=cfg.qp_sigma)
    kern = lambda: admm.admm_iterations(
        setup.data, setup.state, n_iters=cfg.qp_scan_iters,
        sigma=cfg.qp_sigma, alpha=cfg.qp_alpha, eps_abs=cfg.qp_abs_tol,
        eps_rel=cfg.qp_rel_tol, max_iter=cfg.qp_max_iter)
    bound_ms, bound_by, _, _ = k6_bound(its_of["relative"], B, n, m)
    out.update(lanes=B, n=n, m=m, noise=QP_ORACLE_NOISE,
               variant=admm.variant(n, m, torch.float32),
               dump_kkt=dict(zip(("stat", "prim", "comp"), kkt)),
               dump_vs_recorded=float(np.abs(
                   z - np.asarray(dump["x_activeset_f64"])).max()),
               k6_bound_ms=bound_ms, k6_bound_by=bound_by)
    fails = []
    if max(kkt) > TOL_QP_KKT:
        fails.append(f"qp_ref does not re-certify the dump: {kkt}")
    rel = out["relative"]
    if rel["lanes_over_tol"] or not rel["finite"]:
        fails.append(f"K6 off the certified optimum: {rel}")
    return out, fails, kern


def oracle_inner_cost(device):
    """(b) of the `oracle` phase: the card's float64 inner cost (K2's
    float64 instantiation over the pair table) against the C++ forward
    over the bare field on INNER_COST_SEEDS seeds, and its autograd
    gradient (K2 with J) against central differences of the C++."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.solver import alm
    rows, fails = [], []
    for seed in range(INNER_COST_SEEDS):
        grid, cfg, shape, x, bound, duals, scaling = inner_cost_fixture(
            seed, device)
        xg = x.clone().requires_grad_(seed == 1)
        f = alm.inner_cost(xg, bound, shape, grid, cfg.alm, duals, scaling)
        f_cpp = cpp_inner_cost(grid, cfg, shape, x, bound, duals, scaling)
        f_card = float(f[0].detach())
        row = dict(seed=seed, f_card=f_card, f_cpp=f_cpp,
                   rel_err=abs(f_card - f_cpp) / abs(f_cpp))
        if not np.isclose(f_card, f_cpp, rtol=TOL_INNER_COST[0],
                          atol=TOL_INNER_COST[1]):
            fails.append(f"inner cost, seed {seed}: {row}")
        if seed == 1:
            g, = torch.autograd.grad(f.sum(), xg)
            g = g[0].cpu().numpy()
            xn = x[0].cpu().numpy()
            fd = np.zeros_like(xn)
            for i in range(xn.shape[0]):
                e = np.zeros_like(xn)
                e[i] = 1e-6
                fd[i] = (cpp_inner_cost(grid, cfg, shape, xn + e, bound,
                                        duals, scaling)
                         - cpp_inner_cost(grid, cfg, shape, xn - e, bound,
                                          duals, scaling)) / 2e-6
            row["grad_max_abs_err"] = float(np.abs(g - fd).max())
            if not np.allclose(g, fd, rtol=TOL_INNER_GRAD[0],
                               atol=TOL_INNER_GRAD[1]):
                fails.append(f"inner cost gradient, seed 1: {row}")
        rows.append(row)
    return rows, fails


def oracle_search(device):
    """(c) of the `oracle` phase: the C++ A* on the full hill grid (float32,
    the pair table, as `scene-eval` plans on it) from (-3, -3, 0) to
    (0.5, -3, 0) with tests/test_native.py:56's path checks, then on
    ORACLE_SEARCH_BATCH scenarios of `scene_eval.sample_free_scenarios`
    beside the port's search on the card over the same grid."""
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.bench import scene_eval
    from uneven_planner_tpu_torch.config import scene_config
    from uneven_planner_tpu_torch.frontend import kino_init
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    from uneven_planner_tpu_torch.terrain.synthetic import make_synthetic_grid
    from uneven_planner_tpu_torch.utils import native
    cfg = scene_config("hill")
    fe = cfg.frontend
    grid = tgrid.with_pair_table(make_synthetic_grid(
        cfg.map, dtype=np.float32, device=device))
    fails = []
    start, goal = np.array([-3.0, -3.0, 0.0]), np.array([0.5, -3.0, 0.0])
    path = native.kino_astar_plan(grid, fe, start, goal)
    if path is None or len(path) < 3:
        fails.append("the C++ A* found no path on the hill")
    else:
        occ = grid.occ_xy.cpu().numpy()
        ix = ((path[:, 0] - grid.origin[0]) / grid.xy_resolution).astype(int)
        iy = ((path[:, 1] - grid.origin[1]) / grid.xy_resolution).astype(int)
        steps = np.linalg.norm(np.diff(path[:, :2], axis=0), axis=1)
        if (np.abs(path[0] - start).max() > 1e-9
                or np.abs(path[-1] - goal).max() > 1e-9 or occ[ix, iy].any()
                or steps.max() >= fe.max_vel * fe.time_interval + 1e-6):
            fails.append("the C++ A* path fails its checks")
    starts, goals = scene_eval.sample_free_scenarios(
        grid.occ_xy.cpu().numpy(), cfg.map, ORACLE_SEARCH_BATCH,
        np.random.default_rng(0))
    t0 = time.perf_counter()
    feasible = np.array([native.kino_astar_plan(grid, fe, a, b) is not None
                         for a, b in zip(starts, goals)])
    astar_s = time.perf_counter() - t0
    to = lambda a: torch.as_tensor(a, device=device)
    kres = kino_init.plan(grid, fe, to(starts), to(goals))
    success = kres.success.cpu().numpy()
    faults = check_paths(grid, kres, starts, goals,
                         fe.max_vel * fe.time_interval)
    out = dict(astar_path_len=None if path is None else len(path),
               scenarios=len(starts), oracle_feasible=int(feasible.sum()),
               card_success=int(success.sum()),
               card_success_on_feasible=float(success[feasible].mean())
               if feasible.any() else None,
               card_success_on_infeasible=int(success[~feasible].sum()),
               astar_s=astar_s, n_path_faults=len(faults))
    if not feasible.any() or not success[feasible].all():
        fails.append(f"the card's search fails where the C++ A* finds a "
                     f"path: {out}")
    if faults:
        fails.append(f"{len(faults)} path faults: {faults[:4]}")
    return out, fails


def phase_oracle(device, smi):
    """The port held to the reference's float64 oracles on the card: (a)
    the certified QP, (b) the inner cost and its gradient against the C++
    forward, (c) the C++ A* against the search.  The kernels' launches of
    the three are counted together, before K6's launch is timed."""
    reset_all_launches()
    t0 = time.perf_counter()
    qp, fails_a, k6 = oracle_qp(device)
    cost, fails_b = oracle_inner_cost(device)
    search, fails_c = oracle_search(device)
    launches = all_launches()
    qp["k6_ms"] = device_ms(k6, reps=15, inner=4)
    out = dict(card=smi, qp=qp, inner_cost=cost, search=search,
               launches=launches, wall_s=time.perf_counter() - t0)
    log("# oracle " + json.dumps(out))
    fails = fails_a + fails_b + fails_c
    for name in ("admm_iterations", "terrain_tv_pair_f64", "gather_rows",
                 *K4_FAMILY):
        if launches[name] == 0:
            fails.append(f"{name} was never launched by the oracles' runs")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


def _csv_rows(path, header):
    """The data rows of a CSV whose first line is `header`, as floats;
    raises on another header, a row of another width or a value that is
    not finite."""
    import numpy as np
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines or lines[0] != header:
        raise RuntimeError(f"{path}: header {lines[:1]} is not {header!r}")
    width = len(header.split(","))
    rows = np.asarray([ln.split(",") for ln in lines[1:]], np.float64)
    if rows.ndim != 2 or rows.shape[1] != width \
            or not np.isfinite(rows).all():
        raise RuntimeError(f"{path}: malformed rows {rows.shape}")
    return rows


def phase_demo(device, smi):
    """The user entry points on the card, each with its launches counted:
    `examples.plan_demo` on the hill (the JAX script's defaults, --track
    and --out), `examples.debug_stepper`, and `examples.build_maps` on a
    hill cloud made as the `build` phase makes one, written to
    maps/hill.pcd and read by the C++ reader, with its CSV cache read back
    by the C++."""
    import tempfile
    import numpy as np
    import torch
    from uneven_planner_tpu_torch.config import scene_config
    from uneven_planner_tpu_torch.examples import (build_maps, debug_stepper,
                                                   plan_demo)
    from uneven_planner_tpu_torch.terrain import io, mesh
    from uneven_planner_tpu_torch.utils import native
    fails, launches, out = [], {}, dict(card=smi)
    printed = lambda s: log("#   " + s)
    with tempfile.TemporaryDirectory() as tmp:
        reset_all_launches()
        t0 = time.perf_counter()
        traj_csv = os.path.join(tmp, "traj.csv")
        r = plan_demo.run(track=True, out=traj_csv, cache_dir=tmp,
                          device=device, log=printed)
        launches["plan_demo"] = all_launches()
        ok = r.res is not None
        out["plan_demo"] = dict(
            wall_s=time.perf_counter() - t0,
            search_success=bool(r.kres.success[0]),
            search_rounds=int(r.kres.rounds[0]),
            converged=ok and bool(r.res.converged[0]),
            outer_iters=int(r.res.outer_iters[0]) if ok else None,
            inner_iters=int(r.res.inner_iters[0]) if ok else None,
            lockstep_evaluations=r.res.steps if ok else None,
            report=r.report, report_lines=r.lines,
            mean_track_err_m=float(r.track.mean_err[0]) if ok else None,
            exported_rows=len(_csv_rows(traj_csv, "x,y,z,yaw"))
            if ok else 0)
        d = out["plan_demo"]
        if not d["search_success"] or not d["converged"]:
            fails.append(f"plan_demo: search or nested solve failed: {d}")
        elif not d["mean_track_err_m"] <= MAX_TRACK_ERR:
            fails.append(f"plan_demo: tracking error {d['mean_track_err_m']}")
        elif d["exported_rows"] != len(r.poses) or not d["exported_rows"]:
            fails.append("plan_demo: the SE(3) CSV misses rows")

        reset_all_launches()
        t0 = time.perf_counter()
        step_csv = os.path.join(tmp, "debug_iterates.csv")
        s = debug_stepper.run(out=step_csv, device=device, log=printed)
        launches["debug_stepper"] = all_launches()
        rows = _csv_rows(step_csv, debug_stepper.COLUMNS)
        out["debug_stepper"] = dict(
            wall_s=time.perf_counter() - t0,
            evaluations=int(s.rec["valid"].sum()),
            outer_rounds=int(s.rec["outer"][s.rec["valid"]].max()) + 1,
            csv_rows=len(rows))
        if out["debug_stepper"]["evaluations"] < 1 \
                or len(rows) != len(s.rows) or not len(rows):
            fails.append(f"debug_stepper: {out['debug_stepper']}")

        maps = os.path.join(tmp, "maps")
        os.makedirs(maps)
        raw, _ = build_cloud()
        pcd = os.path.join(maps, "hill.pcd")
        mesh.save_pcd(pcd, raw)
        reset_all_launches()
        t0 = time.perf_counter()
        b = build_maps.build_scene("hill", scene_config("hill").map,
                                   out=tmp, csv=True, maps_dir=maps,
                                   device=device, log=printed)
        launches["build_maps"] = all_launches()
        wall = time.perf_counter() - t0
        data = b.grid.data.cpu()
        back = native.map_csv_read(b.csv, b.grid.voxel_num)
        out["build_maps"] = dict(
            wall_s=wall, load_s=b.load_s, build_s=b.build_s,
            cloud_points=b.n_points,
            cpp_reader_points=len(native.pcd_load(pcd)),
            npz_equal=bool(np.array_equal(io.load_map_npz(b.npz),
                                          data.numpy())),
            csv_max_abs_err=float(np.abs(back - data.double().numpy()).max()),
            csv_mb=os.path.getsize(b.csv) / 2 ** 20,
            finite=bool(torch.isfinite(data).all()))
        d = out["build_maps"]
        if not d["npz_equal"] or not d["finite"]:
            fails.append(f"build_maps: the npz cache is not the map: {d}")
        if not d["csv_max_abs_err"] <= 1e-12:
            fails.append(f"build_maps: CSV round trip {d['csv_max_abs_err']}")
        if d["cloud_points"] != d["cpp_reader_points"]:
            fails.append("build_maps did not read the cloud with the C++")
    out["launches"] = launches
    log("# demo " + json.dumps(out))
    for name in ("terrain_tv_packed16", "terrain_tv_pair", "gather_rows",
                 *K4_FAMILY, "admm_iterations"):
        if launches["plan_demo"][name] == 0:
            fails.append(f"{name} was never launched by plan_demo")
    if launches["debug_stepper"]["terrain_tv_pair"] == 0:
        fails.append("terrain_tv_pair was never launched by debug_stepper")
    if launches["build_maps"]["gather_rows"] == 0:
        fails.append("gather_rows was never launched by build_maps")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out


def kernel_entries(r):
    """The kernels' JSON entries from the results of a full run, `r` keyed
    by phase name."""
    variants, gathers, admms = r["terrain"], r["gather"], r["admm"]
    tanhs, probe_a = r["tanh"]
    head, plan, mpc, pipe, mpc_full, track_full, nested, packed = (
        r[k] for k in ("headline", "plan", "mpc", "pipeline", "mpc-full",
                       "track-full-ref", "nested", "packed"))
    # each kernel at the shape and mode its main path gives it: K1 hi-only
    # with J (every solver evaluation) and K2 with J (init_scaling) on the
    # headline path, with their variants on the planning path and the
    # pipeline beside them; K3 on the occupancy table and K4 on the dedup
    # cells of the planning path, with the shapes of the tracking path (MPC
    # alone and pipeline) beside them; K5 at the TPU probe's own shape, with the launches of the probe's
    # own program (it is on no path of the planner in either package); K6 on
    # the first QP pass of a real tracking tick,
    # with its launches on the MPC-alone and the pipeline runs (the other
    # shapes are in the "# kernel" lines above)
    terrain_src = "uneven_planner_tpu_torch/csrc/terrain_lookup.cu"
    gather_src = "uneven_planner_tpu_torch/csrc/gather.cu"
    pick = lambda name, **kw: next(
        v for v in variants + gathers + tanhs + admms if v["name"] == name
        and all(v[k] == val for k, val in kw.items()))
    terrain_err = lambda v: max(v["max_abs_err_tv"], v["max_abs_err_jac"])
    entries = []
    for name, replaces, v in [
            ("terrain_tv_packed16", "uneven_planner_tpu/terrain/grid.py:557",
             pick("terrain_tv_packed16", path="headline", exact=False,
                  want_jac=True)),
            ("terrain_tv_pair", "uneven_planner_tpu/terrain/grid.py:771",
             pick("terrain_tv_pair", path="headline", want_jac=True))]:
        parent = {} if v["ms_parent"] is None else dict(
            ms_parent=v["ms_parent"], layout=v["layout"])
        entries.append(dict(
            name=name, route="cuda", source=terrain_src, replaces=replaces,
            launches=head["launches"][name],
            launches_planning_path=plan["launches"][name],
            launches_nested_path=nested["launches"][name],
            max_abs_err=terrain_err(v),
            tolerance=TOL, ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"], library_ms=None,
            M=v["M"], exact=v["exact"], want_jac=v["want_jac"], **parent,
            **{f"{path}_path": [dict(
                path=w["path"], M=w["M"], exact=w["exact"],
                want_jac=w["want_jac"], max_abs_err=terrain_err(w),
                ms=w["ms"], plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by=w["bound_by"], ms_parent=w["ms_parent"],
                layout=w["layout"]) for w in variants
                if w["name"] == name and w["path"].startswith(path)]
               for path in ("planning", "pipeline", "nested")}))
    for name, replaces, shape in [
            ("gather_rows", "experiments/e1_gather.py:94",
             "path occupancy: [40000] bool"),
            ("gather_along", "experiments/e5_dyngather.py:37",
             "path best_g[cells]: [256, 440000] by [256, 10240]")]:
        v = pick(name, shape=shape)
        entries.append(dict(
            name=name, route="cuda", source=gather_src, replaces=replaces,
            launches=plan["launches"][name],
            launches_nested_path=nested["launches"][name],
            max_abs_err=v["max_abs_err"],
            tolerance=TOL_GATHER, ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"],
            library_ms=v["library_ms"], shape=shape, ms_cold=v["ms_cold"],
            launches_mpc=mpc["launches"][name],
            tracking_and_pipeline_paths=[dict(
                shape=w["shape"], equal=w["equal"],
                max_abs_err=w["max_abs_err"], ms=w["ms"],
                plain_ms=w["plain_ms"], library_ms=w["library_ms"],
                bound_ms=w["bound_ms"], bound_by=w["bound_by"])
                for w in gathers if w["name"] == name
                and w["shape"].startswith(("mpc", "pipeline"))]))
    v, big = tanhs
    entries.append(dict(
        name="tanh_affine", route="cuda",
        source="uneven_planner_tpu_torch/csrc/elementwise.cu",
        replaces="experiments/e31_pallas.py:39",
        launches=probe_a["launches"],
        path="the probe's own program (ones [256, 512] -> kernel -> numpy "
        "check); the kernel is on no path of the planner",
        max_abs_err=v["max_abs_err"],
        max_ulp_tanh=v["max_ulp_tanh"],
        tolerance=dict(ulp_tanh=TOL_TANH_ULP, abs=TOL_TANH_ABS), ms=v["ms"],
        plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
        bound_by=v["bound_by"], library_ms=v["library_ms"],
        library=v["library"], shape=v["shape"],
        large=dict(shape=big["shape"], max_abs_err=big["max_abs_err"],
                   ms=big["ms"], plain_ms=big["plain_ms"],
                   bound_ms=big["bound_ms"], bound_by=big["bound_by"])))
    shared_rows = [w for w in admms if w["name"] == "admm_iterations"]
    v = shared_rows[0]
    entries.append(dict(
        name="admm_iterations", route="cuda",
        source="uneven_planner_tpu_torch/csrc/admm_qp.cu",
        replaces="uneven_planner_tpu/solver/admm_qp.py:295",
        launches=mpc["launches"]["admm_iterations"],
        launches_pipeline=pipe["launches"]["admm_iterations"],
        max_abs_err=v["max_abs_err"], fixed_count=v["fixed_count"],
        loose_test=v["loose_test"], path_test=v["path_test"],
        tolerance=dict(rel_fixed_count=TOL_ADMM_REL,
                       rel_stopped=TOL_ADMM_REL_STOPPED,
                       loose_eps=ADMM_LOOSE_EPS,
                       iters_equal_share_loose=MIN_EQUAL_ITERS_SHARE,
                       iters_max_diff_loose=MAX_ITERS_DIFF),
        ms=v["ms"], plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
        bound_by=v["bound_by"],
        bound_ms_at_occupancy=v["bound_ms_at_occupancy"], library_ms=None,
        shape=v["shape"],
        other_shapes=[dict(shape=w["shape"], ms=w["ms"],
                           plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                           fixed_count=w["fixed_count"],
                           loose_test=w["loose_test"])
                      for w in shared_rows[1:]]))
    # K6's sparse and global instantiations on the full QP of a real tick:
    # float32 at 256 lanes, float64 at 64 beside it.  The sparse one serves
    # the full-QP MPC and its reference; the global one takes the QPs whose
    # compressed lane does not fit, and its launches are those of its own
    # path, `solve_qp` on dense QPs of the full QP's shape
    for which in ("sparse", "global"):
        name = f"admm_iterations_{which}"
        v, f64 = [w for w in admms if w["name"] == name]
        launches = (dict(launches=mpc_full["launches"][name],
                         launches_track_full_ref=track_full["launches_card"][
                             name],
                         launches_track_full_ref_float64=track_full[
                             "float64"]["launches_card"][name])
                    if which == "sparse" else
                    dict(launches=v["own_path"]["launches"],
                         path=v["own_path"]["path"],
                         launches_mpc_full=mpc_full["launches"][name]))
        entries.append(dict(
            name=name, route="cuda",
            source="uneven_planner_tpu_torch/csrc/admm_qp.cu",
            replaces="uneven_planner_tpu/solver/admm_qp.py:295",
            **launches, max_abs_err=v["max_abs_err"],
            fixed_count=v["fixed_count"],
            tolerance=dict(rel=v["tolerance_rel"],
                           rel_float64=f64["tolerance_rel"]),
            split_equal=v["split_equal"], ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"],
            dense_bound_ms=v["dense_bound_ms"],
            streamed_bytes_ms=v["streamed_bytes_ms"], library_ms=None,
            shape=v["shape"], nonzeros_a=v["nonzeros_a"],
            nonzeros_p=v["nonzeros_p"], iters_mean=v["iters_mean"],
            float64=dict(shape=f64["shape"], max_abs_err=f64["max_abs_err"],
                         fixed_count=f64["fixed_count"],
                         tolerance_rel=f64["tolerance_rel"],
                         split_equal=f64["split_equal"], ms=f64["ms"],
                         plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"],
                         bound_by=f64["bound_by"],
                         dense_bound_ms=f64["dense_bound_ms"],
                         streamed_bytes_ms=f64["streamed_bytes_ms"],
                         iters_mean=f64["iters_mean"])))
    # K7 on the first QP of a real tick: float32 condensed, the MPC's, with
    # the other forms and dtypes beside it; its launches on the MPC-alone,
    # the full-QP MPC and the pipeline runs (all in shared memory) and on
    # the float64 full-QP reference (all in place)
    ruizs = [w for w in admms if w["name"] == "ruiz_equilibrate"]
    v = ruizs[0]
    keys = ("shape", "instantiation", "bit_for_bit_before_g", "max_rel_gap",
            "tolerance_rel", "ms", "plain_ms", "bound_ms", "bound_by")
    entries.append(dict(
        name="ruiz_equilibrate", route="cuda",
        source="uneven_planner_tpu_torch/csrc/ruiz.cu",
        replaces="no TPU kernel: jnp code at "
        "uneven_planner_tpu/solver/admm_qp.py:133",
        launches=mpc["launches"]["ruiz_equilibrate"],
        launches_shared=mpc["launches"]["ruiz_equilibrate_shared"],
        launches_mpc_full=mpc_full["launches"]["ruiz_equilibrate"],
        launches_mpc_full_shared=mpc_full["launches"][
            "ruiz_equilibrate_shared"],
        launches_pipeline=pipe["launches"]["ruiz_equilibrate"],
        launches_track_full_ref_float64_global=track_full["float64"][
            "launches_card"]["ruiz_equilibrate_global"],
        **{k: v[k] for k in keys}, library_ms=None,
        other_shapes=[{k: w[k] for k in keys} for w in ruizs[1:]]))
    for e in entries[:4]:
        e["launches_pipeline"] = pipe["launches"][e["name"]]
    # K3 on the map builder's path: its launches in one full-width build
    # and its two reads there (bucket rows, cloud rows)
    mb = r["build"]
    k3 = packed["k3"]
    word_keys = ("shape", "equal", "max_abs_err", "ms", "ms_parent",
                 "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "sector_floor_ms")
    word = lambda d: d["gather_rows_words"]
    entries[2].update(
        launches_packed_headline=packed["headline"]["launches"][
            "gather_rows"],
        packed_path={k: k3[k] for k in word_keys},
        launches_build=mb["builds"][0]["k3_launches"],
        build_path=[{k: w[k] for k in word_keys + ("launches_per_build",)}
                    for w in mb["k3_reads"]],
        # the word path (every table but a shared-memory byte table): its
        # launches on each main path, and its readings beside K3 before
        # the redesign and the sector floor
        launches_word_path=dict(
            planning=word(plan["launches"]),
            pipeline=word(pipe["launches"]),
            mpc=word(mpc["launches"]), nested=word(nested["launches"]),
            packed_headline=word(packed["headline"]["launches"]),
            build=mb["builds"][0]["k3_word_launches"],
            **{f"demo_{k}": word(v) for k, v in r["demo"]["launches"]
               .items()}),
        word_path=[{k: w.get(k) for k in word_keys + ("route", "ms_cold",
                                                      "ms_cold_parent")}
                   for w in gathers if w["name"] == "gather_rows"
                   and "route" in w])
    # K4 gather_along at `best_g[cells]` beside the parent's, with the
    # sector floor and the real cells of one search round
    k4 = entries[3]
    v = pick("gather_along",
             shape="path best_g[cells]: [256, 440000] by [256, 10240]")
    real = next(w for w in gathers if w["name"] == "gather_along"
                and "real cells" in w["shape"])
    k4.update(ms_parent=v["ms_parent"], ms_cold_parent=v["ms_cold_parent"],
              sector_floor_ms=v["sector_floor_ms"],
              real_cells={k: real[k] for k in (
                  "shape", "equal", "ms", "ms_parent", "ms_cold",
                  "plain_ms", "library_ms", "bound_ms", "sector_floor_ms",
                  "distinct_cells")})
    # K4's new entries: several arrays at one index (the paired read of
    # the dedup tables, its other shapes beside it) and the walk (on the
    # real search's arena, full depth beside it)
    for name, main in [
            ("gather_along_many", "path round_best, best_g [cells]: 2 x "
             "[256, 440000] by [256, 10240] int32"),
            ("walk_parents", "path arena walk (real search arena)")]:
        rows = [w for w in gathers if w["name"] == name]
        v = next(w for w in rows if w["shape"].startswith(main))
        keys = ("shape", "equal", "max_abs_err", "ms", "ms_parent",
                "plain_ms", "library_ms", "bound_ms", "bound_by")
        entries.append(dict(
            name=name, route="cuda", source=gather_src,
            replaces="experiments/e5_dyngather.py:37",
            launches=plan["launches"][name],
            launches_pipeline=pipe["launches"][name],
            launches_nested_path=nested["launches"][name],
            launches_mpc=mpc["launches"][name],
            max_abs_err=v["max_abs_err"], tolerance=TOL_GATHER, ms=v["ms"],
            plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
            bound_by=v["bound_by"], library_ms=v["library_ms"],
            shape=v["shape"], ms_parent=v["ms_parent"],
            ms_cold=v["ms_cold"],
            **({} if "wall_ms" not in v else dict(
                wall_ms=v["wall_ms"], wall_ms_parent=v["wall_ms_parent"])),
            other_shapes=[{k: w.get(k) for k in keys}
                          for w in rows if w is not v]))
    # K1 and K2 in float64 (a float64 grid): the readings at the headline's
    # and the nested path's M, with their launches on the float64 runs of
    # the card-vs-CPU checks (K1: the float64 plan of `plan-reference`; K2:
    # the float64 `alm.solve` of `nested-reference`)
    f64_plan = r["plan-reference"]["float64"]["launches_card"]
    f64_nested = r["nested-reference"]["float64"]["solve"]["launches_card"]
    for name, replaces, launches, path_name in [
            ("terrain_tv_packed16", "uneven_planner_tpu/terrain/grid.py:557",
             f64_plan["terrain_tv_packed16_f64"], "float64 plan-reference"),
            ("terrain_tv_pair", "uneven_planner_tpu/terrain/grid.py:771",
             f64_nested["terrain_tv_pair_f64"],
             "float64 nested-reference solve")]:
        rows = [w for w in variants if w["name"] == name + "_f64"]
        v = next(w for w in rows if w["path"] == "headline"
                 and not (name == "terrain_tv_packed16" and w["exact"]))
        keys = ("path", "M", "exact", "want_jac", "layout", "equal",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
        entries.append(dict(
            name=name + "_f64", route="cuda", source=terrain_src,
            replaces=replaces, launches=launches, launches_path=path_name,
            launches_nested_path_f64=f64_nested[name + "_f64"],
            launches_plan_reference_f64=f64_plan[name + "_f64"],
            max_abs_err=max(w["max_abs_err"] for w in rows),
            tolerance="bit for bit", ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"],
            library_ms=None, M=v["M"], exact=v["exact"],
            want_jac=v["want_jac"], dtype="float64",
            other_shapes=[{k: w[k] for k in keys} for w in rows
                          if w is not v]))
    # every kernel's launches on the user entry points (`demo`: plan_demo,
    # debug_stepper, build_maps, each counted alone) and in the oracles'
    # runs (`oracle`)
    demo, oracle = r["demo"]["launches"], r["oracle"]["launches"]
    for e in entries:
        e["launches_demo"] = {k: v[e["name"]] for k, v in demo.items()}
        e["launches_oracle"] = oracle[e["name"]]
    return entries


def parse_phases(argv=None) -> list:
    """The phases to run, in the script's order: every phase without
    `--phases`; an unknown or empty list raises ValueError."""
    p = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port on one GPU.")
    p.add_argument("--phases", default=None,
                   help="comma-separated phases to run after the device and "
                   f"build steps, of: {','.join(PHASES)} (a development "
                   "aid: a partial run prints no ok line)")
    args = p.parse_args(argv)
    if args.phases is None:
        return list(PHASES)
    names = [s.strip() for s in args.phases.split(",") if s.strip()]
    unknown = [s for s in names if s not in PHASES]
    if unknown or not names:
        raise ValueError(f"--phases: unknown or no phase in {args.phases!r}; "
                         f"phases are {', '.join(PHASES)}")
    return [s for s in PHASES if s in names]


def main(argv=None) -> int:
    phases = parse_phases(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import uneven_planner_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}",
              file=sys.stderr)
        return 2

    from uneven_planner_tpu_torch import headline
    t_start = time.perf_counter()
    laps, t_lap = {}, t_start

    def lap(name):
        nonlocal t_lap
        now = time.perf_counter()
        laps[name], t_lap = round(now - t_lap, 1), now

    dev, smi = phase_device()
    phase_build()
    lap("device+build")

    def headline_and_profile():
        head, ctx = phase_headline(dev, smi)
        phase_profile(ctx)
        return head

    def plan_and_profile():
        plan, ctx = phase_plan(dev, smi)
        phase_plan_profile(ctx)
        return plan

    def nested_and_profile():
        nested, ctx = phase_nested(dev, smi)
        nested["profile"] = phase_nested_profile(ctx)
        return nested

    run = {
        "terrain": lambda: phase_kernels(
            headline.scene_setup(device=dev)[1]) + phase_kernels_f64(dev),
        "gather": lambda: phase_gather_kernels(dev),
        "tanh": lambda: phase_elementwise_kernel(dev),
        "admm": lambda: phase_admm_kernel(dev) + phase_ruiz_kernel(dev),
        "small-reference": lambda: phase_small_reference(dev),
        "headline": headline_and_profile,
        "plan-reference": lambda: phase_plan_reference(dev),
        "plan": plan_and_profile,
        "track-reference": lambda: phase_track_reference(dev),
        "track-full-ref": lambda: phase_track_full_reference(dev),
        "mpc": lambda: phase_mpc(dev, smi),
        "mpc-full": lambda: phase_mpc_full(dev, smi),
        "pipeline": lambda: phase_pipeline(dev, smi),
        "nested-reference": lambda: phase_nested_reference(dev),
        "nested": nested_and_profile,
        "packed": lambda: phase_packed(dev, smi),
        "build": lambda: phase_map_build(dev, smi),
        "dist": lambda: phase_dist(dev, smi),
        "bench-track": lambda: phase_bench_track(dev, smi),
        "precision": lambda: phase_precision(dev, smi),
        "scene-eval": lambda: phase_scene_eval(dev, smi),
        "oracle": lambda: phase_oracle(dev, smi),
        "demo": lambda: phase_demo(dev, smi),
    }
    r = {}
    for name in phases:
        r[name] = run[name]()
        lap(name)
    log(f"# total {time.perf_counter() - t_start:.1f} s, by phase (the "
        f"profiles count with their phase): {json.dumps(laps)}")
    if phases != list(PHASES):
        print(json.dumps({"partial": phases}), flush=True)
        return 0
    print(json.dumps({"kernels": kernel_entries(r)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # any failed phase: no result line
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
