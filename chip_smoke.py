#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (uneven_planner_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (exit code 1 otherwise):
  1. device   CUDA present, full-fp32 matmul settings, card name and power
              limit from nvidia-smi;
  2. build    the terrain-lookup kernels, compiled with nvcc from
              uneven_planner_tpu_torch/csrc;
  3. kernels  each kernel against its plain PyTorch twin on the full hill
              grid (200 x 200 x 64) at the solver's lookup count (4096 lanes
              x 90 samples), timed beside the twin and its bound;
  4. small    8 lanes solved on the card (fp32, kernels) against the same
              lanes on the CPU (fp64, plain twins);
  5. headline the main path at full width: hill grid with its f16 table,
              warm duals from a 512-lane pilot, one warm-up batch of 4096
              lanes, then one fresh timed batch whose kernel launches are
              counted; converged share, eval counts and an exact-table
              recheck of the residuals;
  6. profile  device busy share and kernel time by name over a few solver
              steps.
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
    from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
    t0 = time.perf_counter()
    path = kernels.build()
    kernels._library()
    dt = time.perf_counter() - t0
    log(f"# build: {dt:.1f} s -> {os.path.relpath(path, HERE)}")
    for ln in kernels.build_log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            log("#   " + ln.strip())
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


def phase_kernels(grid, M=M_HEADLINE):
    """Each kernel mode against its twin on the same CUDA tensors; times."""
    from uneven_planner_tpu_torch.kernels import terrain_lookup as kernels
    from uneven_planner_tpu_torch.terrain import grid as tgrid
    px, py, yaw = smoke_poses(grid, M, seed=1)
    geom = tgrid.kernel_geometry(grid)
    variants = []
    for name, exact, want_jac in [
            ("terrain_tv_packed16", False, True),
            ("terrain_tv_packed16", False, False),
            ("terrain_tv_packed16", True, True),
            ("terrain_tv_packed16", True, False),
            ("terrain_tv_pair", True, True),
            ("terrain_tv_pair", True, False)]:
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
        ms = device_ms(kern)
        plain_ms = device_ms(twin)
        nbytes = M * (12 + 32 * rows + 28 + (84 if want_jac else 0))
        bound_s = max(nbytes / PEAK_BYTES, M * OPS[name] / PEAK_F32)
        v = dict(name=name, exact=exact, want_jac=want_jac, M=M,
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
    rows = []
    total = 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, e.key, e.count))
            total += dev_us
    rows.sort(reverse=True)
    out = dict(steps=steps, wall_ms_per_step=wall / steps * 1e3,
               device_ms_per_step=total / steps / 1e3 if total else None,
               device_busy_share=(total / 1e6 / wall) if total else None,
               top=[dict(kernel=k[:80], device_ms_per_step=u / steps / 1e3,
                         calls_per_step=c / steps) for u, k, c in rows[:8]])
    log("# profile " + json.dumps(out))
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
    phase_small_reference(dev)
    head, ctx = phase_headline(dev, smi)
    try:    # a measurement, not a check: its absence fails nothing
        phase_profile(ctx)
    except Exception as e:
        log(f"# profile not measured: {e!r}")

    srcs = {"terrain_tv_packed16": (
                "uneven_planner_tpu_torch/csrc/terrain_lookup.cu",
                "uneven_planner_tpu/terrain/grid.py:557"),
            "terrain_tv_pair": (
                "uneven_planner_tpu_torch/csrc/terrain_lookup.cu",
                "uneven_planner_tpu/terrain/grid.py:771")}
    # the mode each kernel runs in on the main path: K1 hi-only with J
    # (every solver evaluation), K2 with J (init_scaling)
    main_mode = {"terrain_tv_packed16": (False, True),
                 "terrain_tv_pair": (True, True)}
    entries = []
    for name, (src, replaces) in srcs.items():
        v = next(v for v in variants if v["name"] == name
                 and (v["exact"], v["want_jac"]) == main_mode[name])
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=head["launches"][name],
            max_abs_err=max(v["max_abs_err_tv"], v["max_abs_err_jac"]),
            tolerance=TOL, ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"], library_ms=None,
            M=v["M"], exact=v["exact"], want_jac=v["want_jac"]))
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
