#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (uneven_planner_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (exit code 1 otherwise):
  1. device   CUDA present, full-fp32 matmul settings, card name and power
              limit from nvidia-smi;
  2. build    the terrain-lookup and gather kernels, compiled with nvcc
              from uneven_planner_tpu_torch/csrc, both compilers at once;
  3. kernels  each kernel against its plain PyTorch twin, timed beside the
              twin, its bound and (for the gathers) the PyTorch library call:
              the terrain lookups on the full hill grid (200 x 200 x 64) at
              the headline's lookup count (4096 lanes x 90 samples) and at
              the planning path's shapes and modes, the gathers at the TPU
              probes' shapes and at the planning path's;
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
              kernels) against the CPU (fp64, plain twins), held by outcome;
  8. plan     the planning path at full width: api.plan_batch (kinodynamic
              search -> on-device init guess -> flat solve) on the full hill
              map with the default front-end sizing, 256 scenarios: one
              warm-up batch, one fresh batch for the search alone, one fresh
              timed batch whose kernel launches are counted; path checks,
              post-solve metrics, and a profile of one search.
Prints the kernels' JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Without CUDA, or without the package beside
it, it exits 2 and prints no result.
"""

from __future__ import annotations

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

def device_ms(fn, reps=25, inner=10):
    """Median device time of one fn() call: `inner` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events, so host launch cost is
    not counted."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
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


def phase_build():
    from uneven_planner_tpu_torch.kernels import build, gather, terrain_lookup
    libs = [terrain_lookup.LIBRARY, gather.LIBRARY]
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
    log(f"# build: {dt:.1f} s for {len(libs)} libraries, compiled side by "
        "side")
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
    mode.  Planning path (256 scenarios, ProblemShape(10, 20, int_K=16)):
    K1 hi-only without J on the search's [256, 10240] candidates, K1 hi-only
    with J on the solver's [256, S] samples, K2 with J in init_scaling on
    [256, S] (cost gradient) and on [256 x num_vars, S] (the forward-mode
    constraint Jacobian)."""
    from uneven_planner_tpu_torch.solver import alm
    shape = alm.ProblemShape(piece_xy=10, piece_yaw=20, int_K=16)
    S, n = shape.equal_num, shape.num_vars
    cases = [("headline", M_HEADLINE, name, exact, jac)
             for name, exact in [("terrain_tv_packed16", False),
                                 ("terrain_tv_packed16", True),
                                 ("terrain_tv_pair", True)]
             for jac in (True, False)]
    cases += [
        ("planning: search sigma", PLAN_BATCH * 10240, "terrain_tv_packed16",
         False, False),
        ("planning: solver step", PLAN_BATCH * S, "terrain_tv_packed16",
         False, True),
        ("planning: init_scaling cost", PLAN_BATCH * S, "terrain_tv_pair",
         True, True),
        ("planning: init_scaling jacobian", PLAN_BATCH * n * S,
         "terrain_tv_pair", True, True)]
    return cases


def phase_kernels(grid):
    """K1 and K2 against their twins on the same CUDA tensors, at every
    shape and mode of `terrain_cases`; times."""
    from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    geom = tgrid.kernel_geometry(grid)
    variants = []
    for path, M, name, exact, want_jac in terrain_cases():
        px, py, yaw = smoke_poses(grid, M, seed=1)
        if name == "terrain_tv_pair":
            kern = lambda: kernels.terrain_tv_pair(
                grid.data_pair, geom, px, py, yaw, want_jac)
            twin = lambda: tgrid.pair_tv_jac(grid, px, py, yaw, want_jac)
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
        del got, want
        ms = device_ms(kern)
        plain_ms = device_ms(twin)
        nbytes = M * (12 + 32 * rows + 28 + (84 if want_jac else 0))
        bound_s = max(nbytes / PEAK_BYTES, M * OPS[name] / PEAK_F32)
        v = dict(name=name, path=path, exact=exact, want_jac=want_jac, M=M,
                 max_abs_err_tv=e_tv[0], max_abs_err_jac=e_j[0],
                 n_out_of_tol=e_tv[1] + e_j[1], finite=e_tv[2] and e_j[2],
                 ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                 bound_by=("bytes" if nbytes / PEAK_BYTES
                           >= M * OPS[name] / PEAK_F32 else "operations"),
                 bytes=nbytes)
        log("# kernel " + json.dumps(v))
        variants.append(v)
    bad = [v for v in variants if v["n_out_of_tol"] or not v["finite"]]
    if bad:
        raise RuntimeError(f"kernel disagrees with its twin: {bad}")
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


def phase_headline(device, smi):
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import headline
    from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
    from uneven_planner_tpu_torch.solver import alm
    hc = headline.HeadlineConfig()
    cfg, grid = headline.scene_setup(device=device)
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
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, conv = run(batches[1])                      # fresh, timed, counted
    dt = time.perf_counter() - t0
    launches = dict(kernels.launches)

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
        solves_per_s=B / dt, batch=B, wall_s=dt, card=smi,
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
    log("# headline " + json.dumps(out))
    fails = []
    if launches["terrain_tv_packed16"] != res.steps:
        fails.append("K1 launches != solver steps")
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


def device_time_by_kernel(prof):
    """(total device microseconds, [(microseconds, kernel name, calls)]
    sorted by time) from a torch.profiler run."""
    import torch
    rows, total = [], 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, e.key, e.count))
            total += dev_us
    rows.sort(reverse=True)
    return total, rows


def phase_profile(ctx, steps=16):
    """Kernel time by name and device busy share over `steps` solver steps
    at full width (state after one chunk of the timed batch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from uneven_planner_tpu_torch.solver import alm
    cfg, grid, hc, batch, warm_for = ctx
    x0, bnd, feats = batch
    p = alm._params(cfg.alm, hc.overrides)
    scal = alm._make_scaling(x0, bnd, hc.shape, grid, cfg.alm)
    st = alm.flat_init(x0, hc.shape, cfg.alm, p, warm_for(feats))
    st, _ = alm.flat_run(st, bnd, scal, hc.shape, grid, cfg.alm, p, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            st = alm.flat_step(st, bnd, scal, hc.shape, grid, cfg.alm, p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, rows = device_time_by_kernel(prof)
    out = dict(steps=steps, wall_ms_per_step=wall / steps * 1e3,
               device_ms_per_step=total / steps / 1e3 if total else None,
               device_busy_share=(total / 1e6 / wall) if total else None,
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
    if got.dtype == torch.bool:
        got, want = got.to(torch.uint8), want.to(torch.uint8)
    return float((got.double() - want.double()).abs().max())


def phase_gather_kernels(device):
    """K3 and K4 against their twins (must be equal bit for bit) at the TPU
    probes' shapes and the planning path's, timed beside the twin and the
    PyTorch library call on the same inputs (the library calls do not clip,
    so they get the indices clipped beforehand).  `ms`, `plain_ms` and
    `library_ms` are `device_ms` readings, calls back to back, as for K1 and
    K2; `ms` is the one held against the bound.  Where the table is too
    large to stay in the 50 MB L2 between two rounds of the search,
    `ms_cold` is the kernel's time with the L2 emptied before each call.
    The bound counts the indices read once, the output written once and each
    table row read at most once (a table smaller than the output is read
    once, not once per lookup)."""
    import torch
    from uneven_planner_tpu_torch.kernels import gather
    gen = torch.Generator(device="cpu").manual_seed(5)
    rand = lambda shape: torch.randn(shape, generator=gen).to(device)
    n_occ = 200 * 200
    m_occ = PLAN_BATCH * (10240 * 3 + 1024 * 64)
    variants = []

    def run(name, shape, kern, twin, lib, nbytes, cold):
        got, want = kern(), twin()
        torch.cuda.synchronize()
        v = dict(name=name, shape=shape, equal=bool(torch.equal(got, want)),
                 max_abs_err=_exact_err(got, want), ms=device_ms(kern),
                 plain_ms=device_ms(twin), library_ms=device_ms(lib),
                 bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                 bytes=nbytes,
                 ms_cold=device_ms_cold(kern) if cold else None)
        log("# kernel " + json.dumps(v))
        variants.append(v)
        del got, want

    # K3 gather_rows: table [N, W] (or [N]), idx [M]
    for label, table, M, idt in [
            ("e1_gather C: [32768, 8] f32", rand((32768, 8)), 2785280,
             torch.int32),
            ("e1_gather C2: [131072] f32", rand((131072,)), 2785280,
             torch.int32),
            ("e31 B/C: [1024, 128] f32", rand((1024, 128)), 184320,
             torch.int32),
            ("path occupancy: [40000] bool",
             torch.rand(n_occ, generator=gen).to(device) < 0.1, m_occ,
             torch.int32),
            ("path RXS2 rows: [2560000, 4] f32", rand((200 * 200 * 64, 4)),
             PLAN_BATCH * 4096 * 8, torch.int32)]:
        N = table.shape[0]
        idx = _edge_indices(N, (M,), 11, idt, device)
        clipped = idx.long().clamp(0, N - 1)
        row = table.element_size() * (table.shape[1] if table.dim() == 2
                                      else 1)
        run("gather_rows", label,
            lambda: gather.gather_rows(table, idx),
            lambda: gather.gather_rows_twin(table, idx),
            lambda: torch.index_select(table, 0, clipped),
            M * (idx.element_size() + row) + min(N, M) * row,
            cold=N * row > 25e6)
        del table, idx, clipped

    # K4 gather_along: x [B, N], idx [B, K] (axis 1) or x [N, C], idx [K, C]
    for label, xs, ishape, axis, idt in [
            ("e5_dyngather lane: [4096, 128] axis 1", (4096, 128),
             (4096, 128), 1, torch.int32),
            ("e5_dyngather sub: [4096, 128] axis 0", (4096, 128),
             (4096, 128), 0, torch.int32),
            ("path pool[sel]: [256, 8192] by [256, 1024]",
             (PLAN_BATCH, 8192), (PLAN_BATCH, 1024), 1, torch.int64),
            ("path best_g[cells]: [256, 440000] by [256, 10240]",
             (PLAN_BATCH, 440000), (PLAN_BATCH, 10240), 1, torch.int32)]:
        x = rand(xs)
        N = xs[axis]
        idx = _edge_indices(N, ishape, 13, idt, device)
        clipped = idx.long().clamp(0, N - 1)
        run("gather_along", label,
            lambda: gather.gather_along(x, idx, axis),
            lambda: gather.gather_along_twin(x, idx, axis),
            lambda: torch.gather(x, axis, clipped),
            idx.numel() * (idx.element_size() + x.element_size())
            + min(idx.numel(), x.numel()) * x.element_size(),
            cold=x.numel() * x.element_size() > 25e6)
        del x, idx, clipped
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
    """8 scenarios on the coarse grid: card (fp32, kernels) against CPU
    (fp64, plain twins).  fp32 flips discrete choices of the search, so the
    two are held by outcome: success counts within one lane, every card
    path valid, costs in one band."""
    import dataclasses
    import numpy as np
    import torch
    from uneven_planner_tpu_torch import api
    from uneven_planner_tpu_torch.config import MapConfig, scene_config
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    from uneven_planner_tpu_torch.terrain.synthetic import \
        make_synthetic_grid
    cfg = scene_config("hill")
    cfg = dataclasses.replace(
        cfg, map=MapConfig(xy_resolution=0.2, yaw_resolution=0.45),
        frontend=dataclasses.replace(cfg.frontend, frontier_size=128,
                                     max_rounds=60))
    tables = lambda g: tgrid.with_packed_f16(tgrid.with_pair_table(g))
    card_grid = tables(make_synthetic_grid(cfg.map, dtype=np.float32,
                                           device=device))
    cpu_grid = tables(make_synthetic_grid(cfg.map, dtype=np.float64,
                                          device="cpu"))
    starts, goals = scen_batch(8, np.random.default_rng(21))
    k_card, a_card = api.plan_batch(card_grid, cfg, starts, goals)
    k_cpu, a_cpu = api.plan_batch(cpu_grid, cfg, starts, goals, device="cpu")
    s_card, s_cpu = k_card.success.cpu(), k_cpu.success
    both = s_card & s_cpu
    rel = ((k_card.cost.cpu().double() - k_cpu.cost).abs()
           / k_cpu.cost)[both]
    faults = check_paths(card_grid, k_card, starts, goals,
                         cfg.frontend.max_vel * cfg.frontend.time_interval)
    out = dict(lanes=8, success_card=int(s_card.sum()),
               success_cpu=int(s_cpu.sum()),
               rounds_card=k_card.rounds.tolist(),
               rounds_cpu=k_cpu.rounds.tolist(),
               max_rel_cost_diff=float(rel.max()) if both.any() else None,
               converged_card=int(a_card.converged.sum()),
               converged_cpu=int(a_cpu.converged.sum()),
               path_faults=faults)
    log("# plan-ref " + json.dumps(out))
    if abs(out["success_card"] - out["success_cpu"]) > 1 or faults \
            or out["success_card"] < 7 \
            or (both.any() and float(rel.max()) > 0.1) \
            or not torch.isfinite(a_card.x[s_card.to(device)]).all() \
            or abs(out["converged_card"] - out["converged_cpu"]) > 1:
        raise RuntimeError(f"card planning disagrees with the CPU: {out}")
    return out


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
        launches=launches, path_faults=faults[:8],
        n_path_faults=len(faults),
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
                 "gather_along"):
        if launches[name] == 0:
            fails.append(f"{name} was never launched on the planning path")
    if not out["finite"] or out["x_shape"] != [B, 38]:
        fails.append("non-finite or misshapen solver output")
    if fails:
        raise RuntimeError("; ".join(fails))
    return out, (cfg, grid, timed)


def phase_plan_profile(ctx):
    """Kernel time by name and the device's busy share over one full-width
    search (a measurement: its absence fails nothing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from uneven_planner_tpu_torch.frontend import kino_init
    cfg, grid, (starts, goals) = ctx
    to = lambda a: torch.as_tensor(a, device=grid.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        k = kino_init.plan(grid, cfg.frontend, to(starts), to(goals))
        rounds = int(k.rounds.max())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total, rows = device_time_by_kernel(prof)
    out = dict(rounds=rounds, wall_s=wall,
               device_ms=total / 1e3 if total else None,
               device_busy_share=(total / 1e6 / wall) if total else None,
               port_kernels={
                   name: dict(device_ms=sum(u for u, k, _ in rows
                                            if name in k) / 1e3,
                              calls=sum(c for _, k, c in rows if name in k))
                   for name in ("tv_packed16_kernel", "gather_rows_kernel",
                                "gather_along_kernel")},
               top=[dict(kernel=k[:80], device_ms=u / 1e3, calls=c)
                    for u, k, c in rows[:10]])
    log("# plan-profile " + json.dumps(out))
    return out


def main() -> int:
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
    dev, smi = phase_device()
    phase_build()
    _, grid = headline.scene_setup(device=dev)
    variants = phase_kernels(grid)
    del grid
    gathers = phase_gather_kernels(dev)
    phase_small_reference(dev)
    head, ctx = phase_headline(dev, smi)
    try:    # a measurement, not a check: its absence fails nothing
        phase_profile(ctx)
    except Exception as e:
        log(f"# profile not measured: {e!r}")
    del ctx
    phase_plan_reference(dev)
    plan, plan_ctx = phase_plan(dev, smi)
    try:
        phase_plan_profile(plan_ctx)
    except Exception as e:
        log(f"# plan-profile not measured: {e!r}")

    # each kernel at the shape and mode its main path gives it: K1 hi-only
    # with J (every solver evaluation) and K2 with J (init_scaling) on the
    # headline path, with their variants on the planning path beside them;
    # K3 on the occupancy table and K4 on the dedup cells of the planning
    # path (the other shapes are in the "# kernel" lines above)
    terrain_src = "uneven_planner_tpu_torch/csrc/terrain_lookup.cu"
    gather_src = "uneven_planner_tpu_torch/csrc/gather.cu"
    pick = lambda name, **kw: next(
        v for v in variants + gathers if v["name"] == name
        and all(v[k] == val for k, val in kw.items()))
    terrain_err = lambda v: max(v["max_abs_err_tv"], v["max_abs_err_jac"])
    entries = []
    for name, replaces, v in [
            ("terrain_tv_packed16", "uneven_planner_tpu/terrain/grid.py:557",
             pick("terrain_tv_packed16", path="headline", exact=False,
                  want_jac=True)),
            ("terrain_tv_pair", "uneven_planner_tpu/terrain/grid.py:771",
             pick("terrain_tv_pair", path="headline", want_jac=True))]:
        entries.append(dict(
            name=name, route="cuda", source=terrain_src, replaces=replaces,
            launches=head["launches"][name],
            launches_planning_path=plan["launches"][name],
            max_abs_err=terrain_err(v),
            tolerance=TOL, ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"], library_ms=None,
            M=v["M"], exact=v["exact"], want_jac=v["want_jac"],
            planning_path=[dict(
                path=w["path"], M=w["M"], exact=w["exact"],
                want_jac=w["want_jac"], max_abs_err=terrain_err(w),
                ms=w["ms"], plain_ms=w["plain_ms"], bound_ms=w["bound_ms"],
                bound_by=w["bound_by"]) for w in variants
                if w["name"] == name and w["path"].startswith("planning")]))
    for name, replaces, shape in [
            ("gather_rows", "experiments/e1_gather.py:94",
             "path occupancy: [40000] bool"),
            ("gather_along", "experiments/e5_dyngather.py:37",
             "path best_g[cells]: [256, 440000] by [256, 10240]")]:
        v = pick(name, shape=shape)
        entries.append(dict(
            name=name, route="cuda", source=gather_src, replaces=replaces,
            launches=plan["launches"][name], max_abs_err=v["max_abs_err"],
            tolerance=TOL_GATHER, ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"],
            library_ms=v["library_ms"], shape=shape, ms_cold=v["ms_cold"]))
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
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
